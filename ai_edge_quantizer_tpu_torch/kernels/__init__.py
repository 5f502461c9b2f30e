"""The port's kernels: CUDA C++ for Hopper (csrc/, built by _build.py)
behind Python wrappers, each with a plain PyTorch version used for CPU
tensors and as the reference on the card."""
