"""The fused decode block (PyTorch + CUDA).

Port of `ai_edge_quantizer_tpu/kernels/pallas_block.py`
(`fused_mlp_qkv_attention`, body `_kernel_impl`): one call per layer unit
of the decode step computes MLP(l-1), both RMS norms, the packed QKV
projection of layer l, RoPE, the int8 quantization of the new K/V row and
the stale-cache attention of layer l, and writes the new row into the
cache pools. On a CUDA tensor it launches the cooperative kernel of
`csrc/fused_block.cu` (or raises); on a CPU tensor it runs
`fused_mlp_qkv_attention_plain`, which repeats the kernel's arithmetic.

Numerics (exactly `_kernel_impl`, f32 attention compute):
  xq, xs  = DRQ of rmsnorm(x_res) * g1 (sum of squares in f64, see
            ops/impl.py `rms_inverse`)
  per F-tile of bf columns: gate, up = (acc * xs) * s; h = act(gate) * up;
            hq, hs = DRQ of the tile; acc += float(hq . wd) * hs in order
  x_ffn   = x_res + acc * s_d, kept in f32 through the second norm and QKV
  q, k    = half-split RoPE; k_new = clip(rint(k * f32(1/kq)), -127, 127)
            (the TPU kernel's host-side f32 inverse, not k / kq), v_new
            likewise
  ctx     = `decode_attention_int8_lengths_stale` over the rows
            < lengths - 1 of the pre-write pools plus the inline new row.
Row clamp(pos, 0, S-1) of every batch row of the pools it is handed
becomes (k_new, v_new): the TPU kernel's aliased outputs, written in
place. The TPU kernel's `bb`, `ring` and `writeback` are VMEM and DMA
choices with no counterpart here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels.attention import (
    decode_attention_int8_lengths_stale_plain,
    score_scale,
)
from ai_edge_quantizer_tpu_torch.kernels.mlp import (
    activation,
    unpack_int4_split_grouped,
)
from ai_edge_quantizer_tpu_torch.kernels.packed_qmatmul import (
    quantize_rows_drq,
    unpack_int4_split,
)
from ai_edge_quantizer_tpu_torch.kernels.qmatmul import int_matmul_exact
from ai_edge_quantizer_tpu_torch.ops.impl import rms_inverse

_NAME = 'fused_mlp_qkv_attention'


def rmsnorm_quant(xf: torch.Tensor, gamma: torch.Tensor, eps: float):
  """`pallas_block._rmsnorm_quant`: (x * (1/sqrt(var + eps))) * gamma on
  f32 rows, then per-row DRQ. Returns (xq int8, xs f32 [B, 1])."""
  xn = xf * rms_inverse(xf, eps) * gamma.to(torch.float32).reshape(1, -1)
  return quantize_rows_drq(xn)


def rope_rotate(x, cos, sin):
  """Half-split RoPE over the last dim (`pallas_block._rope_rotate`)."""
  half = x.shape[-1] // 2
  x1, x2 = x[..., :half], x[..., half:]
  return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _new_row_codes(x, scale: float):
  """Narrow-range int8 codes of the new K or V row: rint(x * f32(1/scale))
  clipped to [-127, 127]."""
  inv = float(np.float32(1.0 / scale))
  return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)


def _check_shapes(x_res, wgu_packed, wd_grouped, wqkv_packed, rope_cos,
                  rope_sin, k_pool, v_pool, lengths, num_q_heads, bf):
  """(B, D, F, H, S) of a call; ValueError for inconsistent shapes."""
  b, d = x_res.shape
  two_f, d2 = wgu_packed.shape
  f = two_f // 2
  h = wqkv_packed.shape[0] // (num_q_heads + 2)
  s = k_pool.shape[1]
  if f % bf:
    raise ValueError(f'{_NAME}: bf={bf} must divide F={f}.')
  for ok, what in (
      (2 * d2 == d, f'wgu_packed shape {tuple(wgu_packed.shape)}'),
      (tuple(wd_grouped.shape) == (d, f // 2),
       f'wd_grouped shape {tuple(wd_grouped.shape)}'),
      (tuple(wqkv_packed.shape) == ((num_q_heads + 2) * h, d2),
       f'wqkv_packed shape {tuple(wqkv_packed.shape)}'),
      (tuple(k_pool.shape) == (b, s, h) == tuple(v_pool.shape),
       f'pool shapes {tuple(k_pool.shape)}, {tuple(v_pool.shape)}'),
      (tuple(rope_cos.shape) == (b, h // 2) == tuple(rope_sin.shape),
       f'rope shapes {tuple(rope_cos.shape)}, {tuple(rope_sin.shape)}'),
      (lengths.numel() == b, 'lengths must have B entries')):
    _build.require(ok, _NAME, what)
  return b, d, f, h, s


def _write_rows(k_pool, v_pool, pos, k_new, v_new):
  """Row clamp(pos, 0, S-1) of every batch row of the pools <- the new
  rows (on the pools' device; no host sync)."""
  s = k_pool.shape[1]
  p = torch.clamp(torch.as_tensor(pos, device=k_pool.device).reshape(1).to(
      torch.int64), 0, s - 1)
  k_pool.index_copy_(1, p, k_new[:, None])
  v_pool.index_copy_(1, p, v_new[:, None])


def fused_mlp_qkv_attention_plain(
    x_res, gamma_ffn, wgu_packed, s_gu, wd_grouped, s_d, gamma_attn,
    wqkv_packed, s_qkv, rope_cos, rope_sin, k_pool, v_pool, lengths, pos,
    k_scale_eff, v_scale, kq_scale, vq_scale, num_q_heads, k_zero_point=0.0,
    v_zero_point=0.0, act='gelu', eps=1e-6, bf=2048):
  """`_kernel_impl` in plain PyTorch (any device)."""
  b, d, f, h, _ = _check_shapes(x_res, wgu_packed, wd_grouped, wqkv_packed,
                                rope_cos, rope_sin, k_pool, v_pool, lengths,
                                num_q_heads, bf)
  nq = num_q_heads
  act_f = activation(act)
  f32 = torch.float32
  x = x_res.to(f32)
  xq, xs = rmsnorm_quant(x, gamma_ffn, eps)
  wgu = unpack_int4_split(wgu_packed)
  sg = s_gu.to(f32).reshape(1, 2 * f)
  gate = int_matmul_exact(xq, wgu[:f]).to(f32) * xs * sg[:, :f]
  up = int_matmul_exact(xq, wgu[f:]).to(f32) * xs * sg[:, f:]
  hid = act_f(gate) * up
  wd = unpack_int4_split_grouped(wd_grouped, bf)
  acc = torch.zeros((b, d), dtype=f32, device=x.device)
  for t in range(f // bf):
    cols = slice(t * bf, (t + 1) * bf)
    hq, hs = quantize_rows_drq(hid[:, cols])
    acc = acc + int_matmul_exact(hq, wd[:, cols]).to(f32) * hs
  x_ffn = x + acc * s_d.to(f32).reshape(1, d)
  xq2, xs2 = rmsnorm_quant(x_ffn, gamma_attn, eps)
  qkv = (int_matmul_exact(xq2, unpack_int4_split(wqkv_packed)).to(f32) * xs2
         * s_qkv.to(f32).reshape(1, -1))
  cos, sin = rope_cos.to(f32), rope_sin.to(f32)
  q = rope_rotate(qkv[:, :nq * h].reshape(b, nq, h), cos[:, None], sin[:, None])
  k_new = _new_row_codes(rope_rotate(qkv[:, nq * h:(nq + 1) * h], cos, sin),
                         kq_scale)
  v_new = _new_row_codes(qkv[:, (nq + 1) * h:], vq_scale)
  ctx = decode_attention_int8_lengths_stale_plain(
      q[:, None], k_pool[:, None], v_pool[:, None], k_scale_eff, v_scale,
      lengths, k_new[:, None, None], v_new[:, None, None],
      k_zero_point=k_zero_point, v_zero_point=v_zero_point, compute='f32')
  _write_rows(k_pool, v_pool, pos, k_new, v_new)
  return ctx.reshape(b, nq, h), x_ffn.to(x_res.dtype), k_new, v_new


_PTRS = ('x', 'g1', 'wgu', 'sgu', 'wd', 'sd', 'g2', 'wqkv', 'sqkv', 'cos',
         'sin', 'lengths', 'pos', 'k_pool', 'v_pool', 'ctx', 'x_ffn', 'k_new',
         'v_new', 'xq1', 'xs1', 'hid', 'hq', 'hs', 'xf', 'xq2', 'xs2', 'qkv')
_INTS = ('x_bf16', 'B', 'D', 'F', 'bf', 'NQ', 'H', 'S', 'act_silu')
_FLOATS = ('eps', 'k_scale_eff', 'v_scale', 'zp_k', 'zp_v', 'kq_inv',
           'vq_inv')


class _Args(ctypes.Structure):
  """`FusedBlockArgs` of csrc/fused_block.cu, field by field."""
  _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
              + [(n, ctypes.c_int) for n in _INTS]
              + [(n, ctypes.c_float) for n in _FLOATS])


def _launch(x_res, gamma_ffn, wgu_packed, s_gu, wd_grouped, s_d, gamma_attn,
            wqkv_packed, s_qkv, rope_cos, rope_sin, k_pool, v_pool, lengths,
            pos, k_scale_eff, v_scale, kq_scale, vq_scale, num_q_heads,
            k_zero_point=0.0, v_zero_point=0.0, act='gelu', eps=1e-6,
            bf=2048):
  """The CUDA kernel's path: checks every tensor, launches, raises."""
  b, d, f, h, s = _check_shapes(x_res, wgu_packed, wd_grouped, wqkv_packed,
                                rope_cos, rope_sin, k_pool, v_pool, lengths,
                                num_q_heads, bf)
  nq = num_q_heads
  _build.require(act in ('gelu', 'silu'), _NAME, f'activation {act!r}')
  f32 = torch.float32
  x = x_res.contiguous()
  _build.require_cuda_tensor(x, _NAME, 'x_res', (f32, torch.bfloat16), 16)
  dev = x.device
  vecs = {}
  for t, nm, n in ((gamma_ffn, 'gamma_ffn', d), (s_gu, 's_gu', 2 * f),
                   (s_d, 's_d', d), (gamma_attn, 'gamma_attn', d),
                   (s_qkv, 's_qkv', (nq + 2) * h),
                   (rope_cos, 'rope_cos', b * h // 2),
                   (rope_sin, 'rope_sin', b * h // 2)):
    v = t.to(f32).contiguous()
    _build.require_cuda_tensor(v, _NAME, nm, (f32,))
    _build.require(v.numel() == n, _NAME, f'{nm} must have {n} entries')
    vecs[nm] = v
  for t, nm in ((wgu_packed, 'wgu_packed'), (wd_grouped, 'wd_grouped'),
                (wqkv_packed, 'wqkv_packed')):
    _build.require_cuda_tensor(t, _NAME, nm, (torch.uint8,), 16)
  for t, nm in ((k_pool, 'k_pool'), (v_pool, 'v_pool')):
    _build.require_cuda_tensor(t, _NAME, nm, (torch.int8,), 16)
  lens = lengths.to(torch.int32).contiguous()
  _build.require_cuda_tensor(lens, _NAME, 'lengths', (torch.int32,))
  pos_t = torch.as_tensor(pos, device=dev).to(torch.int32).reshape(1)
  _build.require_cuda_tensor(pos_t, _NAME, 'pos', (torch.int32,))

  def empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=dev)

  out = dict(ctx=empty((b, nq, h), f32), x_ffn=empty((b, d), x.dtype),
             k_new=empty((b, h), torch.int8), v_new=empty((b, h), torch.int8))
  scratch = dict(xq1=empty((b, d), torch.int8), xs1=empty((b,), f32),
                 hid=empty((b, f), f32), hq=empty((b, f), torch.int8),
                 hs=empty((b, f // bf), f32), xf=empty((b, d), f32),
                 xq2=empty((b, d), torch.int8), xs2=empty((b,), f32),
                 qkv=empty((b, (nq + 2) * h), f32))
  tensors = dict(x=x, g1=vecs['gamma_ffn'], wgu=wgu_packed, sgu=vecs['s_gu'],
                 wd=wd_grouped, sd=vecs['s_d'], g2=vecs['gamma_attn'],
                 wqkv=wqkv_packed, sqkv=vecs['s_qkv'], cos=vecs['rope_cos'],
                 sin=vecs['rope_sin'], lengths=lens, pos=pos_t,
                 k_pool=k_pool, v_pool=v_pool, **out, **scratch)
  args = _Args(
      **{n: tensors[n].data_ptr() for n in _PTRS},
      x_bf16=int(x.dtype == torch.bfloat16), B=b, D=d, F=f, bf=bf, NQ=nq,
      H=h, S=s, act_silu=int(act == 'silu'), eps=eps,
      k_scale_eff=score_scale(k_scale_eff, h), v_scale=v_scale,
      zp_k=k_zero_point, zp_v=v_zero_point,
      kq_inv=float(np.float32(1.0 / kq_scale)),
      vq_inv=float(np.float32(1.0 / vq_scale)))
  fn = _build.entry('fused_block', 'aeqt_fused_block',
                    [ctypes.POINTER(_Args), _build.P])
  status = fn(ctypes.byref(args), _build.stream_ptr(dev))
  _build.check(status, _NAME, f'D={d}, F={f}, bf={bf}, NQ={nq}, H={h}, S={s}')
  return out['ctx'], out['x_ffn'], out['k_new'], out['v_new']


def fused_mlp_qkv_attention(
    x_res: torch.Tensor,
    gamma_ffn: torch.Tensor,
    wgu_packed: torch.Tensor,
    s_gu: torch.Tensor,
    wd_grouped: torch.Tensor,
    s_d: torch.Tensor,
    gamma_attn: torch.Tensor,
    wqkv_packed: torch.Tensor,
    s_qkv: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    lengths: torch.Tensor,
    pos,
    k_scale_eff: float,
    v_scale: float,
    kq_scale: float,
    vq_scale: float,
    num_q_heads: int,
    k_zero_point: float = 0.0,
    v_zero_point: float = 0.0,
    act: str = 'gelu',
    eps: float = 1e-6,
    bf: int = 2048,
):
  """One decode-block unit; returns (ctx [B, NQ, H] f32, x_ffn [B, D] in
  x_res.dtype, k_new [B, H] int8, v_new [B, H] int8).

  x_res [B, D] f32 or bf16, the residual entering the FFN of layer l-1;
  gamma_ffn, gamma_attn [D]; wgu_packed [2F, D//2] (pack_int4_split, gate
  rows then up rows) with s_gu [2F]; wd_grouped [D, F//2]
  (pack_int4_split_grouped, group bf) with s_d [D]; wqkv_packed
  [(NQ+2)*H, D//2] with s_qkv; rope_cos, rope_sin [B, H//2] f32 (cos and
  sin of pos * freqs per row); k_pool, v_pool int8 [B, S, H], pre-write
  (one KV head); lengths int32 [B] counting the new token; pos the shared
  write position (int or int32 tensor, clamped to [0, S-1]);
  k_scale_eff the score-side K scale (k_scale times the graph's score
  factor times sqrt(H)), kq_scale and vq_scale the new row's scales.
  Row pos of every batch row of k_pool and v_pool is written in place.
  """
  args = (x_res, gamma_ffn, wgu_packed, s_gu, wd_grouped, s_d, gamma_attn,
          wqkv_packed, s_qkv, rope_cos, rope_sin, k_pool, v_pool, lengths,
          pos, k_scale_eff, v_scale, kq_scale, vq_scale, num_q_heads,
          k_zero_point, v_zero_point, act, eps, bf)
  if _build.device_kind(x_res) == 'cpu':
    fused_mlp_qkv_attention.plain_calls += 1
    return fused_mlp_qkv_attention_plain(*args)
  out = _launch(*args)
  fused_mlp_qkv_attention.launches += 1
  return out


fused_mlp_qkv_attention.launches = 0
fused_mlp_qkv_attention.plain_calls = 0
