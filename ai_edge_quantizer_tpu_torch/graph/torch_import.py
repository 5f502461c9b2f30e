"""PyTorch -> Graph IR converter (the torch migration path).

Parity: the reference's `colabs/torch_convert_and_quantize.ipynb` flow
(PyTorch -> ai-edge-torch -> .tflite -> quantize). Here the conversion is
direct: trace a `torch.nn` module structurally (no FX/ONNX dependency) into
the Graph IR, then quantize with any recipe.

A copy of `ai_edge_quantizer_tpu/graph/torch_import.py`: the same IR from
the same module (the weights come off the module's device to numpy).

Supported modules: Sequential, Linear, Conv2d (incl. depthwise),
Embedding, ReLU/ReLU6/GELU/SiLU/Tanh/Sigmoid/Softmax, Flatten, Dropout
(identity), AvgPool2d/MaxPool2d, LayerNorm-free nets (use RMS_NORM via the
builder for custom nets). Arbitrary graphs need the JAX package's
`graph/jax_import.py`, which traces a JAX function and has no port.

NOTE on layouts: torch Conv2d weights are [O, I, kH, kW] / NCHW
activations; the IR uses OHWI weights / NHWC activations (TPU-friendly).
The converter transposes weights and inserts the NCHW->NHWC input
convention: converted models take NHWC inputs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ai_edge_quantizer_tpu_torch.graph import builder as builder_lib
from ai_edge_quantizer_tpu_torch.graph import ir


def _to_np(t) -> np.ndarray:
  return t.detach().cpu().numpy()


def convert_torch_module(
    module,
    input_shape: Sequence[int],
    signature_key: str = 'serving_default',
) -> ir.Graph:
  """Convert a torch.nn module (Sequential-style) to a Graph IR model.

  input_shape: NHWC for conv nets / [batch, features] for MLPs — the
  converted model's input layout (torch NCHW inputs must be transposed by
  the caller when running comparisons).
  """
  import torch.nn as nn

  b = builder_lib.GraphBuilder('main')
  x = b.input('x', tuple(input_shape))
  layer_idx = 0

  def emit(mod, x):
    nonlocal layer_idx
    name = f'{type(mod).__name__.lower()}_{layer_idx}'
    layer_idx += 1
    if isinstance(mod, nn.Sequential):
      for child in mod:
        x = emit(child, x)
      return x
    if isinstance(mod, nn.Linear):
      w = _to_np(mod.weight)  # torch Linear is already [out, in]
      bias = _to_np(mod.bias) if mod.bias is not None else None
      return b.fully_connected(x, w, bias, name=name)
    if isinstance(mod, nn.Conv2d):
      w = _to_np(mod.weight)  # [O, I, kH, kW]
      bias = _to_np(mod.bias) if mod.bias is not None else None
      stride = mod.stride[0] if isinstance(mod.stride, tuple) else mod.stride
      pad = mod.padding[0] if isinstance(mod.padding, tuple) else mod.padding
      if pad > 0:
        # torch pads SYMMETRICALLY; TFLite-style 'SAME' pads asymmetrically
        # for even strides. Emit an explicit PAD + VALID conv — always
        # torch-exact.
        shape = tuple(b.subgraph.tensors[x].shape)
        padded = (shape[0], shape[1] + 2 * pad, shape[2] + 2 * pad,
                  shape[3])
        pads = np.asarray([[0, 0], [pad, pad], [pad, pad], [0, 0]],
                          np.int32)
        x = b.op('PAD', [x, b.constant(f'{name}/pad', pads)], [padded],
                 output_names=[f'{name}/padded'])
      if mod.groups == 1:
        w_ohwi = np.transpose(w, (0, 2, 3, 1))
        return b.conv2d(x, w_ohwi, bias, name=name, stride=stride,
                        padding='VALID')
      if mod.groups == mod.in_channels and w.shape[1] == 1:
        # Depthwise: torch [C, 1, kH, kW] -> IR [1, kH, kW, C].
        w_dw = np.transpose(w, (1, 2, 3, 0))
        return b.depthwise_conv2d(x, w_dw, bias, name=name, stride=stride,
                                  padding='VALID')
      raise NotImplementedError('Grouped (non-depthwise) Conv2d.')
    if isinstance(mod, nn.Embedding):
      return b.op('EMBEDDING_LOOKUP',
                  [x, b.constant(f'{name}/table', _to_np(mod.weight))],
                  [tuple(b.subgraph.tensors[x].shape)
                   + (mod.embedding_dim,)],
                  output_names=[f'{name}/out'])
    simple = {
        nn.ReLU: 'RELU', nn.Tanh: 'TANH', nn.Sigmoid: 'LOGISTIC',
        nn.GELU: 'GELU', nn.Softmax: 'SOFTMAX',
    }
    for cls, opcode in simple.items():
      if isinstance(mod, cls):
        shape = tuple(b.subgraph.tensors[x].shape)
        return b.op(opcode, [x], [shape], output_names=[f'{name}/out'])
    if isinstance(mod, nn.SiLU):
      shape = tuple(b.subgraph.tensors[x].shape)
      s = b.op('LOGISTIC', [x], [shape], output_names=[f'{name}/sig'])
      return b.op('MUL', [x, s], [shape], output_names=[f'{name}/out'])
    if isinstance(mod, nn.ReLU6):
      shape = tuple(b.subgraph.tensors[x].shape)
      y = b.op('RELU', [x], [shape], output_names=[f'{name}/relu'])
      six = b.constant(f'{name}/six', np.asarray(6.0, np.float32))
      return b.op('MINIMUM', [y, six], [shape],
                  output_names=[f'{name}/out'])
    if isinstance(mod, nn.Flatten):
      shape = tuple(b.subgraph.tensors[x].shape)
      if len(shape) == 4:
        # torch flattens NCHW -> [C*H*W]; our activations are NHWC, so
        # transpose back to NCHW first to keep the downstream Linear
        # weights' feature order.
        nchw = (shape[0], shape[3], shape[1], shape[2])
        x = b.op(
            'TRANSPOSE',
            [x, b.constant(f'{name}/perm',
                           np.asarray([0, 3, 1, 2], np.int32))],
            [nchw], output_names=[f'{name}/nchw'])
        shape = nchw
      flat = (shape[0], int(np.prod(shape[1:])))
      return b.op(
          'RESHAPE',
          [x, b.constant(f'{name}/shape', np.asarray(flat, np.int32))],
          [flat], output_names=[f'{name}/out'])
    if isinstance(mod, (nn.AvgPool2d, nn.MaxPool2d)):
      k = mod.kernel_size if isinstance(mod.kernel_size, int) \
          else mod.kernel_size[0]
      stride = mod.stride or k
      stride = stride if isinstance(stride, int) else stride[0]
      shape = tuple(b.subgraph.tensors[x].shape)
      out_shape = (shape[0], shape[1] // stride, shape[2] // stride,
                   shape[3])
      opcode = ('AVERAGE_POOL_2D' if isinstance(mod, nn.AvgPool2d)
                else 'MAX_POOL_2D')
      return b.op(opcode, [x], [out_shape], output_names=[f'{name}/out'],
                  attrs={'filter_size': k, 'stride': stride,
                         'padding': 'VALID'})
    if isinstance(mod, (nn.Dropout, nn.Identity)):
      return x
    raise NotImplementedError(
        f'Unsupported torch module {type(mod).__name__}; extend '
        'torch_import.convert_torch_module.')

  y = emit(module, x)
  b.output(y)
  return b.finalize(signature_key)
