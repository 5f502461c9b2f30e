"""MobileNetV2 as Graph IR (the int8 static-quantization benchmark model).

Standard inverted-residual architecture (1x1 expand -> 3x3 depthwise ->
1x1 project, ReLU6, residual adds), NHWC. Random-initialized weights; the
point is the op mix (conv/dwconv/add/mean/fc/softmax) for calibration,
SRQ quantization, and the imgs/s serving benchmark.

A copy of `ai_edge_quantizer_tpu/models/mobilenet.py` (numpy, the port's
IR): the same `np.random.default_rng(seed)` draws in the same order, so
`build_mobilenet_v2` gives the JAX package's weights bit for bit. The
input shape draws nothing: a build at another batch or image size has
the same weights.
"""

from __future__ import annotations

import numpy as np

from ai_edge_quantizer_tpu_torch.graph import builder as builder_lib
from ai_edge_quantizer_tpu_torch.graph import ir

# (expansion t, out channels c, repeats n, stride s)
_INVERTED_RESIDUAL_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def build_mobilenet_v2(
    batch: int = 1,
    image_size: int = 224,
    num_classes: int = 1000,
    width_mult: float = 1.0,
    seed: int = 0,
) -> ir.Graph:
  rng = np.random.default_rng(seed)
  b = builder_lib.GraphBuilder('main')

  def _c(ch):
    return max(8, int(ch * width_mult) // 8 * 8)

  def conv_bn(x, out_c, k, stride, name, act='RELU6', in_c=None):
    in_c = in_c or b.subgraph.tensors[x].shape[-1]
    w = (rng.standard_normal((out_c, k, k, in_c), dtype=np.float32)
         * np.sqrt(2.0 / (k * k * in_c)))
    bias = rng.standard_normal(out_c).astype(np.float32) * 0.01
    return b.conv2d(x, w, bias, stride=stride, padding='SAME', name=name,
                    activation=act)

  def dwconv_bn(x, stride, name, act='RELU6'):
    ch = b.subgraph.tensors[x].shape[-1]
    w = (rng.standard_normal((1, 3, 3, ch), dtype=np.float32)
         * np.sqrt(2.0 / (9 * ch)))
    bias = rng.standard_normal(ch).astype(np.float32) * 0.01
    return b.depthwise_conv2d(x, w, bias, stride=stride, padding='SAME',
                              name=name, activation=act)

  x = b.input('image', (batch, image_size, image_size, 3))
  h = conv_bn(x, _c(32), 3, 2, 'stem')
  block_id = 0
  for t, c, n, s in _INVERTED_RESIDUAL_CFG:
    out_c = _c(c)
    for i in range(n):
      stride = s if i == 0 else 1
      in_c = b.subgraph.tensors[h].shape[-1]
      name = f'block_{block_id}'
      inp = h
      if t != 1:
        h = conv_bn(h, in_c * t, 1, 1, f'{name}/expand')
      h = dwconv_bn(h, stride, f'{name}/depthwise')
      h = conv_bn(h, out_c, 1, 1, f'{name}/project', act='NONE')
      if stride == 1 and in_c == out_c:
        h = b.op('ADD', [inp, h], [b.subgraph.tensors[h].shape],
                 output_names=[f'{name}/residual'])
      block_id += 1
  h = conv_bn(h, _c(1280), 1, 1, 'head')
  pooled = b.op('MEAN', [h], [(batch, _c(1280))],
                output_names=['head/pooled'],
                attrs={'axis': [1, 2], 'keep_dims': False})
  logits_w = (rng.standard_normal((num_classes, _c(1280)),
                                  dtype=np.float32) * 0.02)
  logits = b.fully_connected(pooled, logits_w,
                             rng.standard_normal(num_classes).astype(
                                 np.float32) * 0.01,
                             name='classifier')
  probs = b.unary('SOFTMAX', logits, name='probs')
  b.output(probs)
  return b.finalize()
