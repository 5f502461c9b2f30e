"""Stale-cache int8 decode attention (PyTorch + CUDA).

Port of `decode_attention_int8_lengths_stale` in
`ai_edge_quantizer_tpu/kernels/pallas_attention.py` (body
`_ctx_prefix_len_cur`): attention of the G grouped query rows of each
(batch, kv-head) over the pre-write int8 cache rows [0, lengths-1) plus
the new token's quantized k/v row as one inline softmax column. The
executor writes the new row into the cache outside this function.

The CUDA kernel (`csrc/attention_stale.cu`) computes in f32
(`compute='f32'`, the executor's default). The plain version also covers
the `bf16` and `int8` compute modes; on a CUDA tensor those raise, as
their kernels are not ported yet. The other Pallas attention kernels of
that file are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ai_edge_quantizer_tpu_torch.kernels import _build

_NEG = -1e30


def score_scale(k_scale: float, h: int) -> float:
  """k_scale / sqrt(h) rounded in f32, as the TPU kernel forms it."""
  return float(np.float32(k_scale) / np.float32(h ** 0.5))


def _qdot(a, b_t):
  """f32 a [..., G, H] . b_t [..., S, H]^T -> [..., G, S]."""
  return torch.matmul(a, b_t.transpose(-1, -2))


def decode_attention_int8_lengths_stale_plain(
    q, k_cache_stale, v_cache_stale, k_scale, v_scale, lengths, k_new_q,
    v_new_q, k_zero_point=0.0, v_zero_point=0.0, compute='f32',
    out_dtype=torch.float32):
  """`_ctx_prefix_len_cur` in plain PyTorch (any device)."""
  b, nk, g, h = q.shape
  s = k_cache_stale.shape[2]
  qf = q.to(torch.float32)
  ks = score_scale(k_scale, h)
  zp_k, zp_v = float(k_zero_point), float(v_zero_point)
  v_scale = float(np.float32(v_scale))
  length_stale = (lengths.to(torch.int32) - 1).reshape(b, 1, 1, 1)
  pos = torch.arange(s, device=q.device, dtype=torch.int32)
  live = pos.reshape(1, 1, 1, s) < length_stale
  if compute == 'int8':
    q_absmax = torch.amax(torch.abs(qf), dim=-1, keepdim=True)
    q_scale = torch.clamp_min(q_absmax, 1e-9) * (1.0 / 127.0)
    q_q = torch.round(qf / q_scale).to(torch.int8)
    qf_sum = torch.sum(q_q.to(torch.float32) * q_scale, dim=-1, keepdim=True)
    qqf = q_q.to(torch.float32)
    scores = _qdot(qqf, k_cache_stale.to(torch.float32)) * q_scale
    scores = (scores - zp_k * qf_sum) * ks
    scores = torch.where(live, scores, _NEG)
    s_cur = _qdot(qqf, k_new_q.to(torch.float32)) * q_scale
    s_cur = (s_cur - zp_k * qf_sum) * ks
    m = torch.maximum(torch.amax(scores, dim=-1, keepdim=True), s_cur)
    p = torch.exp(scores - m)
    p_cur = torch.exp(s_cur - m)
    denom = torch.sum(p, dim=-1, keepdim=True) + p_cur
    p_q = torch.round(p / denom * 127.0).to(torch.int8)
    p_cur_q = torch.round(p_cur / denom * 127.0).to(torch.int8)
    ctx_acc = torch.matmul(p_q.to(torch.float32),
                           v_cache_stale.to(torch.float32))
    ctx_acc = ctx_acc + (p_cur_q.to(torch.float32)
                         * v_new_q.to(torch.float32))
    p_sum = torch.clamp_min(
        torch.sum(p_q.to(torch.float32), dim=-1, keepdim=True)
        + p_cur_q.to(torch.float32), 1.0)
    ctx = ctx_acc / p_sum
    return ((ctx - zp_v) * v_scale).to(out_dtype)
  if compute == 'bf16':
    def rnd(t):
      return t.to(torch.bfloat16).to(torch.float32)
  elif compute == 'f32':
    def rnd(t):
      return t
  else:
    raise ValueError(f'unknown attention compute mode {compute!r}')
  kd = rnd(k_cache_stale.to(torch.float32))
  kcd = rnd(k_new_q.to(torch.float32))
  qd = rnd(qf)
  q_sum = torch.sum(qf, dim=-1, keepdim=True)
  scores = (_qdot(qd, kd) - zp_k * q_sum) * ks
  scores = torch.where(live, scores, _NEG)
  s_cur = (_qdot(qd, kcd) - zp_k * q_sum) * ks  # [B, NK, G, 1]
  m = torch.maximum(torch.amax(scores, dim=-1, keepdim=True), s_cur)
  p = torch.exp(scores - m)
  p_cur = torch.exp(s_cur - m)
  denom = torch.sum(p, dim=-1, keepdim=True) + p_cur
  probs = p / denom
  probs_cur = p_cur / denom
  pv = torch.matmul(rnd(probs), rnd(v_cache_stale.to(torch.float32)))
  pv_cur = rnd(probs_cur) * v_new_q.to(torch.float32)
  ctx = pv + pv_cur
  return ((ctx - zp_v) * v_scale).to(out_dtype)


def decode_attention_int8_lengths_stale(
    q: torch.Tensor,
    k_cache_stale: torch.Tensor,
    v_cache_stale: torch.Tensor,
    k_scale: float,
    v_scale: float,
    lengths: torch.Tensor,
    k_new_q: torch.Tensor,
    v_new_q: torch.Tensor,
    k_zero_point: float = 0.0,
    v_zero_point: float = 0.0,
    compute: str = 'f32',
    out_dtype=torch.float32,
) -> torch.Tensor:
  """Decode attention over the pre-write cache + the inline new token.

  q [B, NK, G, H] float; caches int8 [B, NK, S, H]; k/v new int8
  [B, NK, 1, H]; lengths int32 [B] counting the new token; per-tensor
  scales and zero points as Python floats. Returns [B, NK, G, H] in
  out_dtype.
  """
  args = (q, k_cache_stale, v_cache_stale, k_scale, v_scale, lengths,
          k_new_q, v_new_q, k_zero_point, v_zero_point, compute, out_dtype)
  if _build.device_kind(q) == 'cpu':
    decode_attention_int8_lengths_stale.plain_calls += 1
    return decode_attention_int8_lengths_stale_plain(*args)
  name = 'decode_attention_int8_lengths_stale'
  if compute != 'f32':
    raise NotImplementedError(
        f'{name}: compute={compute!r} has no CUDA kernel yet (f32 only).')
  b, nk, g, h = q.shape
  s = k_cache_stale.shape[2]
  r = b * nk
  q2 = q.to(torch.float32).reshape(r, g, h).contiguous()
  _build.require(h % 16 == 0 and 1024 % h == 0, name,
                 f'H={h} must be a multiple of 16 dividing 1024')
  _build.require(out_dtype in (torch.float32, torch.bfloat16), name,
                 f'out_dtype {out_dtype} must be f32 or bf16')
  smem = 4 * (g * h + g * s + 2 * g + 4 * 256 * 8)  # attention_stale.cu
  _build.require(smem <= _build.MAX_SMEM, name,
                 f'G={g}, S={s}, H={h} exceed the shared-memory budget')
  for t, nm, shape in ((k_cache_stale, 'k_cache', (b, nk, s, h)),
                       (v_cache_stale, 'v_cache', (b, nk, s, h)),
                       (k_new_q, 'k_new', (b, nk, 1, h)),
                       (v_new_q, 'v_new', (b, nk, 1, h))):
    _build.require(tuple(t.shape) == shape, name, f'{nm} shape {t.shape}')
    _build.require_cuda_tensor(t, name, nm, (torch.int8,), 16)
  lens = lengths.to(torch.int32).contiguous()
  _build.require_cuda_tensor(lens, name, 'lengths', (torch.int32,))
  _build.require(lens.numel() == b, name, 'lengths must have B entries')
  out = torch.empty((r, g, h), dtype=out_dtype, device=q.device)
  fn = _build.entry(
      'attention_stale', 'aeqt_attention_stale',
      [_build.P] * 7 + [_build.I] * 6 + [_build.F] * 4 + [_build.P])
  status = fn(q2.data_ptr(), k_cache_stale.data_ptr(),
              v_cache_stale.data_ptr(), k_new_q.data_ptr(),
              v_new_q.data_ptr(), lens.data_ptr(), out.data_ptr(),
              int(out_dtype == torch.bfloat16), r, nk, g, s, h,
              score_scale(k_scale, h), float(v_scale), float(k_zero_point),
              float(v_zero_point), _build.stream_ptr(q.device))
  _build.check(status, name)
  decode_attention_int8_lengths_stale.launches += 1
  return out.reshape(b, nk, g, h)


decode_attention_int8_lengths_stale.launches = 0
decode_attention_int8_lengths_stale.plain_calls = 0
