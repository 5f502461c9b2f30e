"""The GeGLU MLP with packed int4 weights (PyTorch + CUDA).

Port of `ai_edge_quantizer_tpu/kernels/pallas_mlp.py`: the group-split
int4 layout of the down weight (`pack_int4_split_grouped`,
`unpack_int4_split_grouped`) and `mlp_pallas_int4_packed`. On a CUDA
tensor its DRQ branch runs the CUDA kernels of `csrc/mlp_int4_drq.cu`, and
its non-DRQ (weight-only, `_mlp_bf16_kernel`) branch those of
`csrc/mlp_int4_bf16.cu` (tensor cores for bf16 x).
`mlp_int4_packed` dispatches on `drq`; the weight-only branch is also
`mlp_int4_packed_bf16`, which keeps its own launch and plain-run counts.
Both CUDA routes run on the tensor-core cores (`int8_tc_gemm.cuh` for the
DRQ branch, `int4_bf16_tc_gemm.cuh` for bf16 x in the weight-only branch;
f32 x keeps SIMT tiles); `drq_plan` and `bf16_plan` give their launches.

Numerics of the DRQ branch: x quantized per row; gate/up as (acc * xs) *
s; h = act(gate) * up; h quantized per (row, bf-column group) with
hs = max(absmax, 1e-9) * (1/127); the down partial of each group in
int32, summed over groups in order as float(part) * hs; then * s_d.
Numerics of the weight-only branch: x in its compute dtype; gate/up as
acc * s with f32 sums; h = act(gate) * up rounded to the compute dtype;
the down partial of each bf-column group in f32, summed over groups in
order; then * s_d.
"""

from __future__ import annotations

import ctypes

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


def activation(kind: str):
  if kind == 'gelu':
    return gelu_tanh
  if kind == 'silu':
    return lambda x: x * torch.sigmoid(x)
  raise ValueError(f'unsupported mlp activation {kind!r}')


# The launches of the DRQ branch's two contractions (csrc/mlp_int4_drq.cu
# aeqt_mlp_int4_drq_plan) and of the bf16 branch's (csrc/mlp_int4_bf16.cu,
# int4_bf16_tc_gemm.cuh plan_fields of each).
DRQ_PLAN_FIELDS = tuple(
    f'{part}_{name}' for part in ('gate_up', 'down')
    for name in ('grid_x', 'grid_y', 'chain', 'threads', 'stages',
                 'smem_bytes'))
BF16_PLAN_FIELDS = tuple(
    f'{part}_{name}' for part in ('gate_up', 'down')
    for name in _build.PLAN_FIELDS + ('tile_tokens',))


def drq_plan(m: int, d: int, f: int, bf: int) -> dict:
  """The launches mlp_int4_packed's DRQ kernel gives a shape (card only)."""
  return _build.plan('mlp_int4_drq', 'aeqt_mlp_int4_drq_plan',
                     'mlp_int4_packed', m, d, f, bf, fields=DRQ_PLAN_FIELDS)


def bf16_plan(m: int, d: int, f: int, bf: int) -> dict:
  """The launches mlp_int4_packed_bf16 gives a shape for bf16 x (card
  only)."""
  return _build.plan('mlp_int4_bf16', 'aeqt_mlp_int4_bf16_plan',
                     'mlp_int4_packed_bf16', m, d, f, bf,
                     fields=BF16_PLAN_FIELDS)


def mlp_int4_packed_plain(x, wgu_packed, s_gu, wd_grouped, s_d, act='gelu',
                          drq=True, bf=512):
  """`_mlp_drq_kernel` / `_mlp_bf16_kernel` in plain PyTorch (any device)."""
  two_f, d2 = wgu_packed.shape
  d, f = 2 * d2, two_f // 2
  if f % bf:
    raise ValueError(f'bf={bf} must divide F={f}.')
  act_f = activation(act)
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


def _check_weights(name, wgu_packed, s_gu, wd_grouped, s_d, bf):
  two_f, d2 = wgu_packed.shape
  d, f = 2 * d2, two_f // 2
  _build.require(f % bf == 0, name, f'bf={bf} must divide F={f}')
  _build.require(tuple(wd_grouped.shape) == (d, f // 2), name,
                 f'wd_grouped shape {tuple(wd_grouped.shape)}')
  for t, nm in ((wgu_packed, 'wgu_packed'), (wd_grouped, 'wd_grouped')):
    _build.require_cuda_tensor(t, name, nm, (torch.uint8,), 16)
  for t, nm, n in ((s_gu, 's_gu', two_f), (s_d, 's_d', d)):
    _build.require_cuda_tensor(t, name, nm, (torch.float32,))
    _build.require(t.numel() == n, name, f'{nm} must have {n} entries')


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
  group=bf); s_d [D]. Returns [..., D] in x.dtype. drq=False runs the
  weight-only branch, `mlp_int4_packed_bf16`.
  """
  if not drq:
    return mlp_int4_packed_bf16(x, wgu_packed, s_gu, wd_grouped, s_d, act,
                                bf)
  if _build.device_kind(x) == 'cpu':
    mlp_int4_packed.plain_calls += 1
    return mlp_int4_packed_plain(x, wgu_packed, s_gu, wd_grouped, s_d, act,
                                 drq, bf)
  name = 'mlp_int4_packed'
  if act not in ('gelu', 'silu'):
    raise ValueError(f'unsupported mlp activation {act!r}')
  two_f, d2 = wgu_packed.shape
  d, f = 2 * d2, two_f // 2
  lead = x.shape[:-1]
  x2 = x.reshape(-1, d).to(compute_dtype(x)).contiguous()
  m = x2.shape[0]
  # The shape rule (D % 32, bf % 256, bf <= 8192) is the kernel's own:
  # it refuses any other shape with kShapeRefused before any launch.
  _check_weights(name, wgu_packed, s_gu, wd_grouped, s_d, bf)
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
  _build.check(status, name, f'M={m}, D={d}, F={f}, bf={bf}')
  mlp_int4_packed.launches += 1
  return out.to(x.dtype).reshape(lead + (d,))


mlp_int4_packed.launches = 0
mlp_int4_packed.plain_calls = 0


def mlp_int4_packed_bf16(
    x: torch.Tensor,
    wgu_packed: torch.Tensor,
    s_gu: torch.Tensor,
    wd_grouped: torch.Tensor,
    s_d: torch.Tensor,
    act: str = 'gelu',
    bf: int = 512,
) -> torch.Tensor:
  """The weight-only branch of mlp_int4_packed (drq=False,
  pallas_mlp._mlp_bf16_kernel), same arguments; no activation is
  quantized."""
  if _build.device_kind(x) == 'cpu':
    mlp_int4_packed_bf16.plain_calls += 1
    return mlp_int4_packed_plain(x, wgu_packed, s_gu, wd_grouped, s_d, act,
                                 False, bf)
  name = 'mlp_int4_packed_bf16'
  if act not in ('gelu', 'silu'):
    raise ValueError(f'unsupported mlp activation {act!r}')
  two_f, d2 = wgu_packed.shape
  d, f = 2 * d2, two_f // 2
  lead = x.shape[:-1]
  x2 = x.reshape(-1, d).to(compute_dtype(x)).contiguous()
  m = x2.shape[0]
  _check_weights(name, wgu_packed, s_gu, wd_grouped, s_d, bf)
  dev = x2.device
  is_bf16 = int(x2.dtype == torch.bfloat16)
  scratch = _build.entry('mlp_int4_bf16', 'aeqt_mlp_int4_bf16_scratch',
                         [_build.I] * 5, ctypes.c_longlong)
  gu = torch.empty((scratch(m, d, f, bf, is_bf16),), dtype=torch.float32,
                   device=dev)
  h = torch.empty((m, f), dtype=x2.dtype, device=dev)
  out = torch.empty((m, d), dtype=x2.dtype, device=dev)
  fn = _build.entry('mlp_int4_bf16', 'aeqt_mlp_int4_bf16',
                    [_build.P, _build.I] + [_build.P] * 7 + [_build.I] * 5
                    + [_build.P])
  status = fn(x2.data_ptr(), is_bf16,
              wgu_packed.data_ptr(), s_gu.data_ptr(), wd_grouped.data_ptr(),
              s_d.data_ptr(), gu.data_ptr(), h.data_ptr(), out.data_ptr(),
              m, d, f, bf, int(act == 'silu'), _build.stream_ptr(dev))
  _build.check(status, name, f'M={m}, D={d}, F={f}, bf={bf}')
  mlp_int4_packed_bf16.launches += 1
  return out.to(x.dtype).reshape(lead + (d,))


mlp_int4_packed_bf16.launches = 0
mlp_int4_packed_bf16.plain_calls = 0
