"""PyTorch/CUDA port of ai_edge_quantizer_tpu (Hopper, sm_90a).

A second package beside the JAX one: it imports torch and numpy, never
jax or ai_edge_quantizer_tpu. It covers the quantizer's dynamic-range
path (`Quantizer`: recipe -> params -> rewrite -> `.aeqg`, min-max
algorithm), the greedy Gemma decode step and its continuous-batching
server: graph IR and serializer, op semantics, the executor with its
attention / MLP / head fusions, `parallel.batching` (DecodeServer), and
ten hand-written CUDA kernels (kernels/csrc) with plain PyTorch versions
beside them.
"""

from ai_edge_quantizer_tpu_torch.quantizer import QuantizationResult
from ai_edge_quantizer_tpu_torch.quantizer import Quantizer
