"""Integer-weight matmuls over unpacked int8 containers (PyTorch + CUDA).

Port of two Pallas kernels of `ai_edge_quantizer_tpu/kernels/
pallas_qmatmul.py`, which the executor reaches through the dispatchers
`kernels.qmatmul.drq_matmul` and `kernels.qmatmul.qmatmul`:

  * `qmatmul_pallas_int8_drq` (`_int8_drq_kernel`) as `qmatmul_int8_drq`,
    CUDA kernel `csrc/qmatmul_int8_drq.cu` on the int8 tensor-core core
    `csrc/int8_tc_gemm.cuh`: x quantized per row into int8 scratch, int8 x
    int8 in exact int32 (wgmma), (acc * xs) * s (+ b). It equals its plain
    version bit for bit: codes, sums and outputs.
  * `qmatmul_pallas` (`_channelwise_kernel`, `_blockwise_kernel`) as
    `qmatmul_int_weights`, CUDA kernel `csrc/qmatmul_int_weights.cu` on the
    bf16 tensor cores (wgmma): the int8 weight widened to bf16 exactly, x
    as one bf16 operand (bf16 x) or three bf16 parts whose sum is x to all
    24 bits (f32 x, and any other dtype after a cast to f32), so every
    product is exact in f32; each block's partial dot is summed from zero
    by the tensor cores (the smallest part first), then y = y + p * s in
    block order in f32, the bias after the last block. At decode K splits
    across a cluster in whole blocks (channelwise: whole steps, scaled
    after the splits' sum) and the splits add in split order. Only the
    order of the f32 sums differs from the plain version and the TPU's
    MXU, so they agree to `int_weights_tolerance`. Output in x's dtype:
    bf16 for bf16 x (the f32 result rounded once), else f32.

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
  xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
  xs = torch.empty((m,), dtype=torch.float32, device=x2.device)
  fn = _build.entry('qmatmul_int8_drq', 'aeqt_qmatmul_int8_drq',
                    [_build.P, _build.I, _build.P, _build.P, _build.P,
                     _build.P, _build.P, _build.P, _build.I, _build.I,
                     _build.I, _build.P])
  status = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16), w_q.data_ptr(),
              scale.data_ptr(), None if bias is None else bias.data_ptr(),
              out.data_ptr(), xq.data_ptr(), xs.data_ptr(),
              m, n, k, _build.stream_ptr(x2.device))
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
  qmatmul_int_weights that differ only in the order of their f32 sums
  (kernel, plain version, the TPU's MXU): one unit roundoff per
  sequential addition an output takes, bs within its block (the kernel:
  the tensor cores' sums over its k16 windows and x parts) and K/bs
  across blocks (the kernel: y + p * s in block order within a split of
  K, the splits' partial y added in split order), times the largest |y|.
  Rounding errors of random-signed terms grow like the square root of
  that count, so the bound holds with a wide margin; a wrong product,
  block or scale moves y by far more."""
  bs = block_size or k
  return (bs + k // bs) * _F32_EPS * y_max


# Fields of aeqt_qmatmul_int_weights_plan (csrc/qmatmul_int_weights.cu):
# the grid, split-K, threads, shared memory and ring stages as
# _build.PLAN_FIELDS, tokens a tile, bf16 parts of x, the scale policy
# (0 channelwise; 1 bs 32: two block sums a stage at decode rows; 2 another
# bs: one block sum a half stage) and the blocks an SM it plans for.
INT_WEIGHTS_PLAN_FIELDS = _build.PLAN_FIELDS + ('tile_tokens', 'x_parts',
                                                'policy', 'blocks_an_sm')


def int_weights_plan(m: int, n: int, k: int, block_size: int,
                     x_bf16: bool) -> dict:
  """The launch the weight-only kernel gives a shape (card only)."""
  return _build.plan('qmatmul_int_weights', 'aeqt_qmatmul_int_weights_plan',
                     'qmatmul_int_weights', m, n, k, block_size, int(x_bf16),
                     fields=INT_WEIGHTS_PLAN_FIELDS)


def qmatmul_int_weights(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    block_size: int = 0,
) -> torch.Tensor:
  """Weight-only x [..., K] . integer w_q [N, K] (int8 container) ->
  [..., N] in x.dtype, f32 sums of exact products. scale [N] (block_size
  0) or [N, K // block_size]; symmetric weights only."""
  if _build.device_kind(x) == 'cpu':
    qmatmul_int_weights.plain_calls += 1
    return qmatmul_int_weights_plain(x, w_q, scale, bias, block_size)
  name = 'qmatmul_int_weights'
  n, k = w_q.shape
  lead = x.shape[:-1]
  x2 = x.reshape(-1, k)
  x_bf16 = x2.dtype == torch.bfloat16
  x2 = x2.to(torch.bfloat16 if x_bf16 else torch.float32).contiguous()
  if x2.data_ptr() % 16:  # TMA and the parts' loads read 16-byte units
    x2 = x2.clone()
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
  out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
  # The three bf16 parts of an f32 x (csrc/qmatmul_int_weights.cu).
  parts = None if x_bf16 else torch.empty((3, m, k), dtype=torch.bfloat16,
                                          device=x2.device)
  fn = _build.entry('qmatmul_int_weights', 'aeqt_qmatmul_int_weights',
                    [_build.P, _build.I, _build.P, _build.P, _build.P,
                     _build.P, _build.P, _build.I, _build.I, _build.I,
                     _build.I, _build.P])
  status = fn(x2.data_ptr(), int(x_bf16),
              None if parts is None else parts.data_ptr(), w_q.data_ptr(),
              scale.data_ptr(), None if bias is None else bias.data_ptr(),
              out.data_ptr(), m, n, k, block_size,
              _build.stream_ptr(x2.device))
  _build.check(status, name, f'M={m} N={n} K={k} block {block_size}')
  qmatmul_int_weights.launches += 1
  return out.to(x.dtype).reshape(lead + (n,))


qmatmul_int_weights.launches = 0
qmatmul_int_weights.plain_calls = 0
