"""The GeGLU MLP with packed int4 weights (PyTorch + CUDA).

Port of `ai_edge_quantizer_tpu/kernels/pallas_mlp.py`: the group-split
int4 layout of the down weight (`pack_int4_split_grouped`,
`unpack_int4_split_grouped`) and `mlp_pallas_int4_packed`, whose DRQ
branch runs the CUDA kernels of `csrc/mlp_int4_drq.cu` on a CUDA tensor.
The non-DRQ (bf16 weight-only) branch has a plain version only; on a CUDA
tensor it raises until its kernel is ported.

Numerics of the DRQ branch: x quantized per row; gate/up as (acc * xs) *
s; h = act(gate) * up; h quantized per (row, bf-column group) with
hs = max(absmax, 1e-9) * (1/127); the down partial of each group in
int32, summed over groups in order as float(part) * hs; then * s_d.
"""

from __future__ import annotations

import torch

from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels.packed_qmatmul import (
    compute_dtype,
    quantize_rows_drq,
    unpack_int4_split,
)
from ai_edge_quantizer_tpu_torch.kernels.qmatmul import int_matmul_exact


def pack_int4_split_grouped(w_q: torch.Tensor, group: int) -> torch.Tensor:
  """Per-group split-half int4 packing: [N, K] int8 -> [N, K//2] uint8.

  Byte (g, j) holds (w[:, g*group + j] & 0xF) |
  (w[:, g*group + group//2 + j] << 4).
  """
  n, k = w_q.shape
  if k % group or group % 2:
    raise ValueError(f'group {group} must be even and divide K={k}.')
  wg = w_q.reshape(n, k // group, group)
  lo = wg[:, :, : group // 2].to(torch.uint8) & 0xF
  hi = wg[:, :, group // 2:].to(torch.uint8) & 0xF
  return (lo | (hi << 4)).reshape(n, k // 2).contiguous()


def unpack_int4_split_grouped(packed: torch.Tensor,
                              group: int) -> torch.Tensor:
  """Inverse of pack_int4_split_grouped."""
  n, k2 = packed.shape
  g2 = group // 2
  p = packed.reshape(n, k2 // g2, g2)
  lo = (p & 0xF).to(torch.int8)
  hi = (p >> 4).to(torch.int8)
  lo = torch.where(lo >= 8, lo - 16, lo)
  hi = torch.where(hi >= 8, hi - 16, hi)
  return torch.cat([lo, hi], dim=2).reshape(n, 2 * k2)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
  """pallas_mlp._gelu_tanh, term by term in the same order."""
  c = 0.7978845608028654  # sqrt(2/pi)
  return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _act(kind: str):
  if kind == 'gelu':
    return gelu_tanh
  if kind == 'silu':
    return lambda x: x * torch.sigmoid(x)
  raise ValueError(f'unsupported mlp activation {kind!r}')


def mlp_int4_packed_plain(x, wgu_packed, s_gu, wd_grouped, s_d, act='gelu',
                          drq=True, bf=512):
  """`_mlp_drq_kernel` / `_mlp_bf16_kernel` in plain PyTorch (any device)."""
  two_f, d2 = wgu_packed.shape
  d, f = 2 * d2, two_f // 2
  if f % bf:
    raise ValueError(f'bf={bf} must divide F={f}.')
  act_f = _act(act)
  lead = x.shape[:-1]
  compute = compute_dtype(x)
  x2 = x.reshape(-1, d).to(compute)
  wgu = unpack_int4_split(wgu_packed)
  wd = unpack_int4_split_grouped(wd_grouped, bf)
  sg = s_gu.to(torch.float32).reshape(1, two_f)
  sd = s_d.to(torch.float32).reshape(1, d)
  acc = torch.zeros((x2.shape[0], d), dtype=torch.float32, device=x.device)
  if drq:
    xq, xs = quantize_rows_drq(x2.to(torch.float32))
    gate = int_matmul_exact(xq, wgu[:f]).to(torch.float32) * xs * sg[:, :f]
    up = int_matmul_exact(xq, wgu[f:]).to(torch.float32) * xs * sg[:, f:]
    h = act_f(gate) * up
    for t in range(f // bf):
      cols = slice(t * bf, (t + 1) * bf)
      hq, hs = quantize_rows_drq(h[:, cols])
      part = int_matmul_exact(hq, wd[:, cols])
      acc = acc + part.to(torch.float32) * hs
  else:
    def rnd(t):  # values in the compute dtype, products and sums in f32
      return t.to(compute).to(torch.float32)
    xf = rnd(x2)
    wguf = rnd(wgu.to(torch.float32))
    gate = torch.matmul(xf, wguf[:f].T) * sg[:, :f]
    up = torch.matmul(xf, wguf[f:].T) * sg[:, f:]
    h = rnd(act_f(gate) * up)
    wdf = rnd(wd.to(torch.float32))
    for t in range(f // bf):
      cols = slice(t * bf, (t + 1) * bf)
      acc = acc + torch.matmul(h[:, cols], wdf[:, cols].T)
  y = acc * sd
  return y.to(compute).to(x.dtype).reshape(lead + (d,))


def mlp_int4_packed(
    x: torch.Tensor,
    wgu_packed: torch.Tensor,
    s_gu: torch.Tensor,
    wd_grouped: torch.Tensor,
    s_d: torch.Tensor,
    act: str = 'gelu',
    drq: bool = True,
    bf: int = 512,
) -> torch.Tensor:
  """down(act(gate) * up) for packed int4 weights.

  x [..., D]; wgu_packed [2F, D//2] (pack_int4_split; gate rows then up
  rows); s_gu [2F]; wd_grouped [D, F//2] (pack_int4_split_grouped with
  group=bf); s_d [D]. Returns [..., D] in x.dtype.
  """
  if _build.device_kind(x) == 'cpu':
    mlp_int4_packed.plain_calls += 1
    return mlp_int4_packed_plain(x, wgu_packed, s_gu, wd_grouped, s_d, act,
                                 drq, bf)
  name = 'mlp_int4_packed'
  if not drq:
    raise NotImplementedError(
        f'{name}: drq=False (pallas_mlp._mlp_bf16_kernel) has no CUDA kernel '
        'yet.')
  if act not in ('gelu', 'silu'):
    raise ValueError(f'unsupported mlp activation {act!r}')
  two_f, d2 = wgu_packed.shape
  d, f = 2 * d2, two_f // 2
  lead = x.shape[:-1]
  x2 = x.reshape(-1, d).to(compute_dtype(x)).contiguous()
  m = x2.shape[0]
  _build.require(d % 32 == 0, name, f'D={d} must be a multiple of 32')
  _build.require(bf % 32 == 0 and f % bf == 0, name,
                 f'bf={bf} must be a multiple of 32 dividing F={f}')
  _build.require(16 * d + 64 <= _build.MAX_SMEM, name, f'D={d} is too wide')
  _build.require(8 * f <= _build.MAX_SMEM, name, f'F={f} is too wide')
  _build.require(tuple(wd_grouped.shape) == (d, f // 2), name,
                 f'wd_grouped shape {tuple(wd_grouped.shape)}')
  for t, nm in ((wgu_packed, 'wgu_packed'), (wd_grouped, 'wd_grouped')):
    _build.require_cuda_tensor(t, name, nm, (torch.uint8,), 16)
  for t, nm, n in ((s_gu, 's_gu', two_f), (s_d, 's_d', d)):
    _build.require_cuda_tensor(t, name, nm, (torch.float32,))
    _build.require(t.numel() == n, name, f'{nm} must have {n} entries')
  dev = x2.device
  gu = torch.empty((m, two_f), dtype=torch.float32, device=dev)
  hq = torch.empty((m, f), dtype=torch.int8, device=dev)
  hs = torch.empty((m, f // bf), dtype=torch.float32, device=dev)
  out = torch.empty((m, d), dtype=x2.dtype, device=dev)
  fn = _build.entry('mlp_int4_drq', 'aeqt_mlp_int4_drq',
                    [_build.P, _build.I] + [_build.P] * 8 + [_build.I] * 5
                    + [_build.P])
  status = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16),
              wgu_packed.data_ptr(), s_gu.data_ptr(), wd_grouped.data_ptr(),
              s_d.data_ptr(), gu.data_ptr(), hq.data_ptr(), hs.data_ptr(),
              out.data_ptr(), m, d, f, bf, int(act == 'silu'),
              _build.stream_ptr(dev))
  _build.check(status, name)
  mlp_int4_packed.launches += 1
  return out.to(x.dtype).reshape(lead + (d,))


mlp_int4_packed.launches = 0
mlp_int4_packed.plain_calls = 0
