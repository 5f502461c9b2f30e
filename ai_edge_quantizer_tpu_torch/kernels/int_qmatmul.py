"""Integer-weight matmuls over unpacked int8 containers (PyTorch + CUDA).

Port of two Pallas kernels of `ai_edge_quantizer_tpu/kernels/
pallas_qmatmul.py`, which the executor reaches through the dispatchers
`kernels.qmatmul.drq_matmul` and `kernels.qmatmul.qmatmul`:

  * `qmatmul_pallas_int8_drq` (`_int8_drq_kernel`) as `qmatmul_int8_drq`,
    CUDA kernel `csrc/qmatmul_int8_drq.cu`: x quantized per row in the
    kernel, int8 x int8 in exact int32, (acc * xs) * s (+ b). It equals its
    plain version bit for bit: codes, sums and outputs.
  * `qmatmul_pallas` (`_channelwise_kernel`, `_blockwise_kernel`) as
    `qmatmul_int_weights`, CUDA kernel `csrc/qmatmul_int_weights.cu`: f32
    operands, each block's partial dot scaled and summed in block order in
    f32, the bias after the last block. Only the f32 order of the sum
    within a block differs between the kernel, its plain version and the
    TPU's MXU, so they agree to `int_weights_tolerance`.

Each wrapper has two cases: a CUDA tensor launches the kernel (or raises),
a CPU tensor runs the plain version. Each counts its launches and its
plain runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import qmatmul as qmm

_F32_EPS = 2.0**-24  # unit roundoff of f32


def qmatmul_int8_drq_plain(x, w_q, scale, bias=None):
  """The int8 DRQ kernel's arithmetic in plain PyTorch (any device)."""
  n, k = w_q.shape
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k).to(torch.float32)
  xq, xs = packed_qmatmul.quantize_rows_drq(x2)
  acc = qmm.int_matmul_exact(xq, w_q)
  y = acc.to(torch.float32) * xs * scale.to(torch.float32).reshape(1, n)
  if bias is not None:
    y = y + bias.to(torch.float32).reshape(1, n)
  return y.to(packed_qmatmul.compute_dtype(x)).to(x.dtype).reshape(
      lead + (n,))


def qmatmul_int8_drq(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """DRQ x [..., K] float . int8 w_q [N, K] -> [..., N] in x.dtype.

  x is quantized per row to int8 (xs = max(absmax, 1e-9) * (1/127), codes
  rint(x * (1/xs))), contracted against w_q in int32 and scaled as
  (acc * xs) * scale[N] (+ bias[N]).
  """
  if _build.device_kind(x) == 'cpu':
    qmatmul_int8_drq.plain_calls += 1
    return qmatmul_int8_drq_plain(x, w_q, scale, bias)
  name = 'qmatmul_int8_drq'
  n, k = w_q.shape
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k).to(packed_qmatmul.compute_dtype(x)).contiguous()
  m = x2.shape[0]
  _build.require_cuda_tensor(w_q, name, 'w_q', (torch.int8,), 16)
  _build.require_cuda_tensor(scale, name, 'scale', (torch.float32,))
  _build.require(scale.numel() == n, name, 'scale must have N entries')
  if bias is not None:
    bias = bias.to(torch.float32).contiguous()
    _build.require_cuda_tensor(bias, name, 'bias', (torch.float32,))
    _build.require(bias.numel() == n, name, 'bias must have N entries')
  out = torch.empty((m, n), dtype=packed_qmatmul.compute_dtype(x),
                    device=x2.device)
  fn = _build.entry('qmatmul_int8_drq', 'aeqt_qmatmul_int8_drq',
                    [_build.P, _build.I, _build.P, _build.P, _build.P,
                     _build.P, _build.I, _build.I, _build.I, _build.P])
  status = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16), w_q.data_ptr(),
              scale.data_ptr(), None if bias is None else bias.data_ptr(),
              out.data_ptr(), m, n, k, _build.stream_ptr(x2.device))
  _build.check(status, name, f'M={m} N={n} K={k}')
  qmatmul_int8_drq.launches += 1
  return out.to(x.dtype).reshape(lead + (n,))


qmatmul_int8_drq.launches = 0
qmatmul_int8_drq.plain_calls = 0


def qmatmul_int_weights_plain(x, w_q, scale, bias=None, block_size=0):
  """The weight-only kernel's arithmetic in plain PyTorch (any device):
  f32 operands, y = y + (x_b . w_b^T) * s[:, b] in block order, then the
  bias; out in x.dtype."""
  n, k = w_q.shape
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k).to(torch.float32)
  wf = w_q.to(torch.float32)
  if block_size > 0:
    s = scale.to(torch.float32).reshape(n, k // block_size)
    y = torch.zeros((x2.shape[0], n), dtype=torch.float32, device=x.device)
    for b in range(k // block_size):
      sl = slice(b * block_size, (b + 1) * block_size)
      y = y + torch.matmul(x2[:, sl], wf[:, sl].T) * s[:, b]
  else:
    y = torch.matmul(x2, wf.T) * scale.to(torch.float32).reshape(1, n)
  if bias is not None:
    y = y + bias.to(torch.float32).reshape(1, n)
  return y.to(x.dtype).reshape(lead + (n,))


def int_weights_tolerance(k: int, block_size: int, y_max: float) -> float:
  """Largest |difference| allowed between two f32 evaluations of
  qmatmul_int_weights that differ only in the order of the sum within a
  block (kernel, plain version, the TPU's MXU): one unit roundoff per
  sequential addition an output takes, bs within its block and K/bs across
  blocks, times the largest |y|. Rounding errors of random-signed terms
  grow like the square root of that count, so the bound holds with a wide
  margin; a wrong product, block or scale moves y by far more."""
  bs = block_size or k
  return (bs + k // bs) * _F32_EPS * y_max


def qmatmul_int_weights(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    block_size: int = 0,
) -> torch.Tensor:
  """Weight-only x [..., K] . integer w_q [N, K] (int8 container) ->
  [..., N] in x.dtype, f32 compute. scale [N] (block_size 0) or
  [N, K // block_size]; symmetric weights only."""
  if _build.device_kind(x) == 'cpu':
    qmatmul_int_weights.plain_calls += 1
    return qmatmul_int_weights_plain(x, w_q, scale, bias, block_size)
  name = 'qmatmul_int_weights'
  n, k = w_q.shape
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k).to(torch.float32).contiguous()
  m = x2.shape[0]
  bs = block_size or k
  _build.require_cuda_tensor(w_q, name, 'w_q', (torch.int8,), 16)
  _build.require_cuda_tensor(scale, name, 'scale', (torch.float32,))
  _build.require(scale.numel() == n * (k // bs), name,
                 f'scale must have N * K / {bs} entries')
  if bias is not None:
    bias = bias.to(torch.float32).contiguous()
    _build.require_cuda_tensor(bias, name, 'bias', (torch.float32,))
    _build.require(bias.numel() == n, name, 'bias must have N entries')
  out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
  fn = _build.entry('qmatmul_int_weights', 'aeqt_qmatmul_int_weights',
                    [_build.P, _build.P, _build.P, _build.P, _build.P,
                     _build.I, _build.I, _build.I, _build.I, _build.P])
  status = fn(x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
              None if bias is None else bias.data_ptr(), out.data_ptr(),
              m, n, k, bs, _build.stream_ptr(x2.device))
  _build.check(status, name, f'M={m} N={n} K={k} block {bs}')
  qmatmul_int_weights.launches += 1
  return out.to(x.dtype).reshape(lead + (n,))


qmatmul_int_weights.launches = 0
qmatmul_int_weights.plain_calls = 0
