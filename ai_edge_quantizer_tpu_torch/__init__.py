"""PyTorch/CUDA port of ai_edge_quantizer_tpu (Hopper, sm_90a).

A second package beside the JAX one: it imports torch and numpy, never
jax or ai_edge_quantizer_tpu. It covers the greedy int4 Gemma decode
step and its continuous-batching server: graph IR, op semantics, the
executor with its attention / MLP / head fusions, `parallel.batching`
(DecodeServer), and six hand-written CUDA kernels (kernels/csrc) with
plain PyTorch versions beside them.
"""
