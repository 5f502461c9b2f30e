"""Quantized-cache attention kernels (PyTorch + CUDA).

Ports of eight Pallas kernels of
`ai_edge_quantizer_tpu/kernels/pallas_attention.py`, each with a plain
PyTorch version beside its CUDA kernel (`csrc/`):

  * `decode_attention_int8_lengths_stale` (body `_ctx_prefix_len_cur`):
    attention of the G grouped query rows of each (batch, kv-head) over the
    pre-write int8 cache rows [0, lengths-1) plus the new token's quantized
    k/v row as one inline softmax column; the executor writes the new row
    into the cache outside this function (`csrc/attention_stale.cu`).
  * `decode_attention_int8_lengths` (body `_ctx_prefix_len`): decode
    attention over the cache rows [0, lengths) (`csrc/attention_lengths.cu`).
  * `flash_attention_int8_masked` (`_flash_attn_kernel`): prefill-shaped
    attention of R = G * T query rows with an additive mask, as an online
    softmax over S blocks (`csrc/flash_attention_int8.cu`).
  * `decode_attention_int8_masked` (`_decode_attn_mask_kernel`, f32):
    decode attention over all S int8 cache rows with an additive mask
    that broadcasts to [B, NK, G, S], the JAX executor's default decode
    attention (`csrc/attention_masked.cu`).
  * `decode_attention_int4_group_lengths` (body
    `_ctx_prefix_len_int4_group`): decode attention over int4 K/V pools
    with per-group scales in a bf16 sidecar (asymmetric K, symmetric V),
    masked by lengths (`csrc/attention_int4_group.cu`). Its row
    quantizers and sidecar builder are plain PyTorch here as they are
    plain jnp in the reference, bit for bit the same.

  * `decode_attention_int8_lengths_writeback`: the lengths attention over
    the cache with row `pos` replaced by the new token's K/V rows, which
    it also writes into the caches, in place: the caches it is given are
    the ones it returns (the TPU kernel aliases them;
    `csrc/attention_writeback.cu`).
  * `decode_attention_int8_dynlen`: decode attention that reads only the
    live prefix, in chunks with an online softmax, f32
    (`csrc/attention_dynlen.cu`).
  * `decode_attention_oproj_pallas` as `decode_attention_oproj`: the
    lengths attention of one KV head followed by the packed int4 out
    projection and the residual add, the JAX executor's AEQT_ATTN_BLOCK
    epilogue (`csrc/attention_oproj.cu`).

The int8 CUDA decode kernels compute in f32 (`compute='f32'`, the
executor's default). The plain versions of the lengths kernels also cover
the `bf16` and `int8` compute modes; on a CUDA tensor those raise, as
their kernels are not ported yet. The masked kernel and the out-projection
epilogue have the f32 mode only, on both devices. The other Pallas attention kernels of that file
are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul

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
  _build.require(out_dtype in (torch.float32, torch.bfloat16), name,
                 f'out_dtype {out_dtype} must be f32 or bf16')
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
  _build.check(status, name, f'G={g}, S={s}, H={h}')
  decode_attention_int8_lengths_stale.launches += 1
  return out.reshape(b, nk, g, h)


decode_attention_int8_lengths_stale.launches = 0
decode_attention_int8_lengths_stale.plain_calls = 0


# -- lengths-masked decode attention ----------------------------------------


def decode_attention_int8_lengths_plain(
    q, k_cache, v_cache, k_scale, v_scale, lengths, k_zero_point=0.0,
    v_zero_point=0.0, compute='f32', out_dtype=torch.float32):
  """`_ctx_prefix_len` in plain PyTorch (any device)."""
  b, nk, g, h = q.shape
  s = k_cache.shape[2]
  qf = q.to(torch.float32)
  ks = score_scale(k_scale, h)
  zp_k, zp_v = float(k_zero_point), float(v_zero_point)
  v_scale = float(np.float32(v_scale))
  pos = torch.arange(s, device=q.device, dtype=torch.int32)
  live = pos.reshape(1, 1, 1, s) < lengths.to(torch.int32).reshape(b, 1, 1, 1)
  kf = k_cache.to(torch.float32)
  vf = v_cache.to(torch.float32)
  if compute == 'int8':
    q_absmax = torch.amax(torch.abs(qf), dim=-1, keepdim=True)
    q_scale = torch.clamp_min(q_absmax, 1e-9) * (1.0 / 127.0)
    q_q = torch.round(qf / q_scale).to(torch.int8)
    qqf = q_q.to(torch.float32)
    scores = _qdot(qqf, kf) * q_scale
    scores = scores - zp_k * torch.sum(qqf * q_scale, dim=-1, keepdim=True)
  elif compute in ('f32', 'bf16'):
    if compute == 'bf16':
      qd = qf.to(torch.bfloat16).to(torch.float32)
      kd = kf.to(torch.bfloat16).to(torch.float32)
    else:
      qd, kd = qf, kf
    scores = _qdot(qd, kd) - zp_k * torch.sum(qf, dim=-1, keepdim=True)
  else:
    raise ValueError(f'unknown attention compute mode {compute!r}')
  scores = torch.where(live, scores * ks, _NEG)
  scores = scores - torch.amax(scores, dim=-1, keepdim=True)
  probs = torch.exp(scores)
  probs = probs / torch.sum(probs, dim=-1, keepdim=True)
  if compute == 'int8':
    p_q = torch.round(probs * 127.0).to(torch.int8).to(torch.float32)
    p_sum = torch.clamp_min(torch.sum(p_q, dim=-1, keepdim=True), 1.0)
    ctx = torch.matmul(p_q, vf) / p_sum
  elif compute == 'bf16':
    ctx = torch.matmul(probs.to(torch.bfloat16).to(torch.float32),
                       vf.to(torch.bfloat16).to(torch.float32))
  else:
    ctx = torch.matmul(probs, vf)
  return ((ctx - zp_v) * v_scale).to(out_dtype)


def decode_attention_int8_lengths(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: float,
    v_scale: float,
    lengths: torch.Tensor,
    k_zero_point: float = 0.0,
    v_zero_point: float = 0.0,
    compute: str = 'f32',
    out_dtype=torch.float32,
) -> torch.Tensor:
  """Decode attention over the int8 cache rows [0, lengths).

  q [B, NK, G, H] float; caches int8 [B, NK, S, H]; lengths int32 [B];
  per-tensor scales and zero points as Python floats. A length of 0 gives
  every one of the S rows the weight 1/S, as the TPU kernel does. Returns
  [B, NK, G, H] in out_dtype.
  """
  args = (q, k_cache, v_cache, k_scale, v_scale, lengths, k_zero_point,
          v_zero_point, compute, out_dtype)
  if _build.device_kind(q) == 'cpu':
    decode_attention_int8_lengths.plain_calls += 1
    return decode_attention_int8_lengths_plain(*args)
  name = 'decode_attention_int8_lengths'
  if compute != 'f32':
    raise NotImplementedError(
        f'{name}: compute={compute!r} has no CUDA kernel yet (f32 only).')
  b, nk, g, h = q.shape
  s = k_cache.shape[2]
  r = b * nk
  _build.require(out_dtype in (torch.float32, torch.bfloat16), name,
                 f'out_dtype {out_dtype} must be f32 or bf16')
  q2 = q.to(torch.float32).reshape(r, g, h).contiguous()
  for t, nm in ((k_cache, 'k_cache'), (v_cache, 'v_cache')):
    _build.require(tuple(t.shape) == (b, nk, s, h), name,
                   f'{nm} shape {t.shape}')
    _build.require_cuda_tensor(t, name, nm, (torch.int8,), 16)
  lens = lengths.to(torch.int32).contiguous()
  _build.require_cuda_tensor(lens, name, 'lengths', (torch.int32,))
  _build.require(lens.numel() == b, name, 'lengths must have B entries')
  out = torch.empty((r, g, h), dtype=out_dtype, device=q.device)
  fn = _build.entry(
      'attention_lengths', 'aeqt_attention_lengths',
      [_build.P] * 5 + [_build.I] * 6 + [_build.F] * 4 + [_build.P])
  status = fn(q2.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
              lens.data_ptr(), out.data_ptr(),
              int(out_dtype == torch.bfloat16), r, nk, g, s, h,
              score_scale(k_scale, h), float(v_scale), float(k_zero_point),
              float(v_zero_point), _build.stream_ptr(q.device))
  _build.check(status, name, f'G={g}, S={s}, H={h}')
  decode_attention_int8_lengths.launches += 1
  return out.reshape(b, nk, g, h)


decode_attention_int8_lengths.launches = 0
decode_attention_int8_lengths.plain_calls = 0


# -- lengths attention + out projection + residual (the attention epilogue) --


def _oproj_check(q, compute):
  """(B, G, H) of an epilogue call: MQA only and an even head count (the
  TPU wrapper's ValueErrors), f32 compute only."""
  name = 'decode_attention_oproj'
  if compute != 'f32':
    raise NotImplementedError(
        f'{name}: compute={compute!r} is not ported (f32 only).')
  b, nk, g, h = q.shape
  if nk != 1:
    raise ValueError('out-proj epilogue supports MQA (NK == 1) only.')
  if g % 2:
    raise ValueError('even head count required (nibble pairing).')
  return b, g, h


def decode_attention_oproj_plain(
    q, k_cache_q, v_cache_q, k_scale, v_scale, lengths, x_res, wo_packed, so,
    k_zero_point=0.0, v_zero_point=0.0, compute='f32', drq=True):
  """`_attn_oproj_kernel` in plain PyTorch (any device): q rounded to the
  activation dtype (bf16 for bf16 x_res, else f32), the lengths attention
  (`_ctx_prefix_len`, f32) staged at that dtype, the packed out projection
  (DRQ: xs over the whole G*H row, int32 sums, (acc * xs) * so; weight-only:
  f32 sums, pair p's low nibbles against head p and its high nibbles
  against head p + G/2, pairs in order, then * so), cast, and added to
  x_res at that dtype. Returns [B, D] in x_res.dtype."""
  b, g, h = _oproj_check(q, compute)
  cast = torch.bfloat16 if x_res.dtype == torch.bfloat16 else torch.float32
  d = wo_packed.shape[0]
  qf = q.to(cast).to(torch.float32)
  ctx = decode_attention_int8_lengths_plain(
      qf, k_cache_q, v_cache_q, k_scale, v_scale, lengths, k_zero_point,
      v_zero_point, 'f32', cast).reshape(b, g * h)
  so32 = so.to(torch.float32).reshape(-1)
  if drq:
    o = packed_qmatmul.qmatmul_int4_packed_drq_plain(ctx, wo_packed, so32)
  else:
    w = packed_qmatmul.unpack_int4_split(wo_packed).to(torch.float32)
    cf = ctx.to(torch.float32)
    pairs = g // 2
    acc = torch.zeros((b, d), dtype=torch.float32, device=q.device)
    for p in range(pairs):
      for head in (p, p + pairs):
        cols = slice(head * h, (head + 1) * h)
        acc = acc + torch.matmul(cf[:, cols], w[:, cols].T)
    o = (acc * so32.reshape(1, d)).to(cast)
  y = x_res.reshape(b, d).to(cast) + o
  return y.to(x_res.dtype).reshape(x_res.shape)


def decode_attention_oproj(
    q: torch.Tensor,
    k_cache_q: torch.Tensor,
    v_cache_q: torch.Tensor,
    k_scale: float,
    v_scale: float,
    lengths: torch.Tensor,
    x_res: torch.Tensor,
    wo_packed: torch.Tensor,
    so: torch.Tensor,
    k_zero_point: float = 0.0,
    v_zero_point: float = 0.0,
    compute: str = 'f32',
    drq: bool = True,
) -> torch.Tensor:
  """Prefix-length attention + packed int4 out projection + residual
  (pallas_attention.decode_attention_oproj_pallas).

  q [B, 1, G, H] (MQA) float, G even; caches int8 [B, 1, S, H] with
  per-tensor scales and zero points as Python floats; lengths int32 [B];
  x_res [B, D], the residual stream; wo_packed [D, G*H/2] uint8
  split-half packed int4; so [D] f32. Returns x_res + W_o . attn(q, cache)
  [B, D] in x_res.dtype (decode_attention_oproj_plain has the arithmetic).
  Only compute='f32' is ported; 'bf16' and 'int8' raise on both devices.
  The TPU wrapper's batch_block (its VMEM blocking) has no counterpart.
  """
  args = (q, k_cache_q, v_cache_q, k_scale, v_scale, lengths, x_res,
          wo_packed, so, k_zero_point, v_zero_point, compute, drq)
  b, g, h = _oproj_check(q, compute)
  if _build.device_kind(q) == 'cpu':
    decode_attention_oproj.plain_calls += 1
    return decode_attention_oproj_plain(*args)
  name = 'decode_attention_oproj'
  s = k_cache_q.shape[2]
  d = wo_packed.shape[0]
  cast = torch.bfloat16 if x_res.dtype == torch.bfloat16 else torch.float32
  q2 = q.to(cast).to(torch.float32).reshape(b, g, h).contiguous()
  for t, nm in ((k_cache_q, 'k_cache'), (v_cache_q, 'v_cache')):
    _build.require(tuple(t.shape) == (b, 1, s, h), name,
                   f'{nm} shape {tuple(t.shape)}')
    _build.require_cuda_tensor(t, name, nm, (torch.int8,), 16)
  lens = lengths.to(torch.int32).reshape(-1).contiguous()
  _build.require_cuda_tensor(lens, name, 'lengths', (torch.int32,))
  _build.require(lens.numel() == b, name, 'lengths must have B entries')
  _build.require(x_res.numel() == b * d, name,
                 f'x_res shape {tuple(x_res.shape)} must hold [B, D]')
  x2 = x_res.reshape(b, d).to(cast).contiguous()
  _build.require(wo_packed.shape[1] * 2 == g * h, name,
                 f'wo_packed shape {tuple(wo_packed.shape)} must be '
                 f'[D, G*H/2]')
  _build.require_cuda_tensor(wo_packed, name, 'wo_packed', (torch.uint8,),
                             16)
  so32 = so.to(torch.float32).reshape(-1).contiguous()
  _build.require_cuda_tensor(so32, name, 'so', (torch.float32,))
  _build.require(so32.numel() == d, name, 'so must have D entries')
  ctx = torch.empty((b, g * h), dtype=cast, device=q.device)
  o = torch.empty((b, d), dtype=cast, device=q.device)
  out = torch.empty((b, d), dtype=cast, device=q.device)
  fn = _build.entry(
      'attention_oproj', 'aeqt_attention_oproj',
      [_build.P] * 10 + [_build.I] * 7 + [_build.F] * 4 + [_build.P])
  status = fn(q2.data_ptr(), k_cache_q.data_ptr(), v_cache_q.data_ptr(),
              lens.data_ptr(), x2.data_ptr(), wo_packed.data_ptr(),
              so32.data_ptr(), ctx.data_ptr(), o.data_ptr(), out.data_ptr(),
              int(cast == torch.bfloat16), int(drq), b, g, s, h, d,
              score_scale(k_scale, h), float(v_scale), float(k_zero_point),
              float(v_zero_point), _build.stream_ptr(q.device))
  _build.check(status, name, f'G={g}, S={s}, H={h}, D={d}, drq={drq}')
  decode_attention_oproj.launches += 1
  return out.to(x_res.dtype).reshape(x_res.shape)


decode_attention_oproj.launches = 0
decode_attention_oproj.plain_calls = 0


# -- lengths attention with the new row written in (splice) -----------------

# The TPU kernel writes back whole 32-row tiles of the int8 caches, so it
# takes S % 32 == 0 only; the port keeps the rule so that the routes agree.
WRITEBACK_TILE = 32


def _clipped_pos(pos, s: int, device) -> torch.Tensor:
  """pos as an int64 [1] tensor on `device`, clipped to [0, S - 1] as the
  TPU wrapper clips it (on the device: no host sync)."""
  p = torch.as_tensor(pos, device=device).reshape(1).to(torch.int64)
  return torch.clamp(p, 0, s - 1)


def decode_attention_int8_lengths_writeback_plain(
    q, k_cache_q, v_cache_q, k_scale, v_scale, lengths, k_new_q, v_new_q,
    pos, k_zero_point=0.0, v_zero_point=0.0, compute='f32',
    out_dtype=torch.float32):
  """The TPU kernel in plain PyTorch (any device): the new rows written
  into the caches in place at clip(pos, 0, S - 1), then `_ctx_prefix_len`
  over them. Returns (ctx, k_cache_q, v_cache_q)."""
  s = k_cache_q.shape[2]
  if s % WRITEBACK_TILE:
    raise ValueError(f'cache length {s} must be a multiple of '
                     f'{WRITEBACK_TILE}.')
  p = _clipped_pos(pos, s, k_cache_q.device)
  k_cache_q.index_copy_(2, p, k_new_q.to(k_cache_q.dtype))
  v_cache_q.index_copy_(2, p, v_new_q.to(v_cache_q.dtype))
  ctx = decode_attention_int8_lengths_plain(
      q, k_cache_q, v_cache_q, k_scale, v_scale, lengths, k_zero_point,
      v_zero_point, compute, out_dtype)
  return ctx, k_cache_q, v_cache_q


def decode_attention_int8_lengths_writeback(
    q: torch.Tensor,
    k_cache_q: torch.Tensor,
    v_cache_q: torch.Tensor,
    k_scale: float,
    v_scale: float,
    lengths: torch.Tensor,
    k_new_q: torch.Tensor,
    v_new_q: torch.Tensor,
    pos,
    k_zero_point: float = 0.0,
    v_zero_point: float = 0.0,
    compute: str = 'f32',
    out_dtype=torch.float32,
):
  """Lengths attention over the caches with row pos replaced by the new
  token's rows, which are written into the caches in place.

  q [B, NK, G, H] float; caches int8 [B, NK, S, H] with S % 32 == 0;
  k/v new int8 [B, NK, 1, H] (quantized at the cache scale); lengths int32
  [B] counting the new row; pos one int (a Python int or a one-element
  tensor on q's device; the same row for every batch row), clipped to
  [0, S - 1]. The caches' own storage is written: the JAX executor donates
  them to this call, and the caches returned are the tensors given.
  Returns (ctx [B, NK, G, H] in out_dtype, k_cache_q, v_cache_q).
  """
  args = (q, k_cache_q, v_cache_q, k_scale, v_scale, lengths, k_new_q,
          v_new_q, pos, k_zero_point, v_zero_point, compute, out_dtype)
  if _build.device_kind(q) == 'cpu':
    decode_attention_int8_lengths_writeback.plain_calls += 1
    return decode_attention_int8_lengths_writeback_plain(*args)
  name = 'decode_attention_int8_lengths_writeback'
  if compute != 'f32':
    raise NotImplementedError(
        f'{name}: compute={compute!r} has no CUDA kernel yet (f32 only).')
  b, nk, g, h = q.shape
  s = k_cache_q.shape[2]
  r = b * nk
  _build.require(s % WRITEBACK_TILE == 0, name,
                 f'cache length {s} must be a multiple of {WRITEBACK_TILE}')
  _build.require(out_dtype in (torch.float32, torch.bfloat16), name,
                 f'out_dtype {out_dtype} must be f32 or bf16')
  q2 = q.to(torch.float32).reshape(r, g, h).contiguous()
  for t, nm, shape in ((k_cache_q, 'k_cache', (b, nk, s, h)),
                       (v_cache_q, 'v_cache', (b, nk, s, h)),
                       (k_new_q, 'k_new', (b, nk, 1, h)),
                       (v_new_q, 'v_new', (b, nk, 1, h))):
    _build.require(tuple(t.shape) == shape, name, f'{nm} shape {t.shape}')
    _build.require_cuda_tensor(t, name, nm, (torch.int8,), 16)
  lens = lengths.to(torch.int32).contiguous()
  _build.require_cuda_tensor(lens, name, 'lengths', (torch.int32,))
  _build.require(lens.numel() == b, name, 'lengths must have B entries')
  pos_t = torch.as_tensor(pos, device=q.device).to(torch.int32).reshape(
      1).contiguous()
  out = torch.empty((r, g, h), dtype=out_dtype, device=q.device)
  fn = _build.entry(
      'attention_writeback', 'aeqt_attention_writeback',
      [_build.P] * 8 + [_build.I] * 6 + [_build.F] * 4 + [_build.P])
  status = fn(q2.data_ptr(), k_cache_q.data_ptr(), v_cache_q.data_ptr(),
              k_new_q.data_ptr(), v_new_q.data_ptr(), lens.data_ptr(),
              pos_t.data_ptr(), out.data_ptr(),
              int(out_dtype == torch.bfloat16), r, nk, g, s, h,
              score_scale(k_scale, h), float(v_scale), float(k_zero_point),
              float(v_zero_point), _build.stream_ptr(q.device))
  _build.check(status, name, f'G={g}, S={s}, H={h}')
  decode_attention_int8_lengths_writeback.launches += 1
  return out.reshape(b, nk, g, h), k_cache_q, v_cache_q


decode_attention_int8_lengths_writeback.launches = 0
decode_attention_int8_lengths_writeback.plain_calls = 0


# -- live-prefix decode attention (dynlen) -----------------------------------


def dynlen_blocking(n_rows: int, s: int, h: int, chunk: int = 256,
                    row_block: int = 8) -> tuple:
  """(c, rb) as the TPU wrapper forms them: c = min(chunk, S) halved until
  it divides S; rb = min(row_block, rows) halved until it divides the
  rows, then while its VMEM scratch (4 * rb * c * H bytes) passes 8 MiB.
  rb sets how many rows share one chunk count, so it is part of the
  function: a zero-length row's context depends on it."""
  c = min(chunk, s)
  while s % c:
    c //= 2
  rb = max(1, min(row_block, n_rows))
  while n_rows % rb:
    rb //= 2
  while rb > 1 and 4 * rb * c * h > 8 * 2**20:
    rb //= 2
  return c, rb


def decode_attention_int8_dynlen_plain(
    q, k_cache_q, v_cache_q, k_scale, v_scale, lengths, k_zero_point=0.0,
    v_zero_point=0.0, chunk=256, row_block=8):
  """The TPU kernel in plain PyTorch (any device), chunk by chunk in its
  order: per row block, n_chunks = clip(ceil(longest length / c), 1,
  S / c); per chunk the scores minus zp_k * sum(q), times k_scale /
  sqrt(H), -1e30 at or past the row's length, then m, l and acc updated
  online; last (acc / max(l, 1e-30) - zp_v) * v_scale. A row's state stops
  changing after its block's n_chunks. Returns [B, NK, G, H] f32."""
  b, nk, g, h = q.shape
  s = k_cache_q.shape[2]
  r = b * nk
  c, rb = dynlen_blocking(r, s, h, chunk, row_block)
  q2 = q.to(torch.float32).reshape(r, g, h)
  k2 = k_cache_q.reshape(r, s, h)
  v2 = v_cache_q.reshape(r, s, h)
  lens = torch.repeat_interleave(lengths.to(torch.int32), nk)
  blk_len = torch.amax(lens.reshape(r // rb, rb), dim=1)
  n_chunks = torch.clamp(torch.div(blk_len + (c - 1), c,
                                   rounding_mode='floor'), 1, s // c)
  n_chunks = torch.repeat_interleave(n_chunks, rb).reshape(r, 1, 1)
  ks = score_scale(k_scale, h)
  zp_k, zp_v = float(k_zero_point), float(v_zero_point)
  v_scale = float(np.float32(v_scale))
  q_sum = torch.sum(q2, dim=-1, keepdim=True)
  m = torch.full((r, g, 1), _NEG, device=q.device)
  l = torch.zeros((r, g, 1), device=q.device)
  acc = torch.zeros((r, g, h), device=q.device)
  iota = torch.arange(c, device=q.device, dtype=torch.int32)
  for ci in range(s // c):
    kc = k2[:, ci * c:(ci + 1) * c].to(torch.float32)
    vc = v2[:, ci * c:(ci + 1) * c].to(torch.float32)
    scores = (_qdot(q2, kc) - zp_k * q_sum) * ks
    live = (ci * c + iota).reshape(1, 1, c) < lens.reshape(r, 1, 1)
    scores = torch.where(live, scores, _NEG)
    m_new = torch.maximum(m, torch.amax(scores, dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new)
    l_new = alpha * l + torch.sum(p, dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.matmul(p, vc)
    on = ci < n_chunks
    m = torch.where(on, m_new, m)
    l = torch.where(on, l_new, l)
    acc = torch.where(on, acc_new, acc)
  out = (acc / torch.clamp_min(l, 1e-30) - zp_v) * v_scale
  return out.reshape(b, nk, g, h)


def decode_attention_int8_dynlen(
    q: torch.Tensor,
    k_cache_q: torch.Tensor,
    v_cache_q: torch.Tensor,
    k_scale: float,
    v_scale: float,
    lengths: torch.Tensor,
    k_zero_point: float = 0.0,
    v_zero_point: float = 0.0,
    chunk: int = 256,
    row_block: int = 8,
) -> torch.Tensor:
  """Decode attention reading only each row's live prefix, chunk by
  chunk with an online softmax.

  q [B, NK, G, H] float; caches int8 [B, NK, S, H]; lengths int32 [B];
  per-tensor scales and zero points as Python floats; chunk and row_block
  the TPU kernel's (dynlen_blocking). A row of length 0 gets the mean of
  its block's n_chunks * c V rows, as on the TPU. Returns [B, NK, G, H]
  f32.
  """
  args = (q, k_cache_q, v_cache_q, k_scale, v_scale, lengths, k_zero_point,
          v_zero_point, chunk, row_block)
  if _build.device_kind(q) == 'cpu':
    decode_attention_int8_dynlen.plain_calls += 1
    return decode_attention_int8_dynlen_plain(*args)
  name = 'decode_attention_int8_dynlen'
  b, nk, g, h = q.shape
  s = k_cache_q.shape[2]
  r = b * nk
  c, rb = dynlen_blocking(r, s, h, chunk, row_block)
  q2 = q.to(torch.float32).reshape(r, g, h).contiguous()
  for t, nm in ((k_cache_q, 'k_cache'), (v_cache_q, 'v_cache')):
    _build.require(tuple(t.shape) == (b, nk, s, h), name,
                   f'{nm} shape {tuple(t.shape)}')
    _build.require_cuda_tensor(t, name, nm, (torch.int8,), 16)
  lens = lengths.to(torch.int32).contiguous()
  _build.require_cuda_tensor(lens, name, 'lengths', (torch.int32,))
  _build.require(lens.numel() == b, name, 'lengths must have B entries')
  out = torch.empty((r, g, h), dtype=torch.float32, device=q.device)
  fn = _build.entry(
      'attention_dynlen', 'aeqt_attention_dynlen',
      [_build.P] * 5 + [_build.I] * 7 + [_build.F] * 4 + [_build.P])
  status = fn(q2.data_ptr(), k_cache_q.data_ptr(), v_cache_q.data_ptr(),
              lens.data_ptr(), out.data_ptr(), r, nk, g, s, h, c, rb,
              score_scale(k_scale, h), float(v_scale), float(k_zero_point),
              float(v_zero_point), _build.stream_ptr(q.device))
  _build.check(status, name, f'G={g}, S={s}, H={h}, chunk {c}')
  decode_attention_int8_dynlen.launches += 1
  return out.reshape(b, nk, g, h)


decode_attention_int8_dynlen.launches = 0
decode_attention_int8_dynlen.plain_calls = 0


# -- additive-mask decode attention -------------------------------------------


def decode_attention_int8_masked_plain(
    q, k_cache_q, v_cache_q, k_scale, v_scale, mask, k_zero_point=0.0,
    v_zero_point=0.0):
  """`_decode_attn_mask_kernel` in plain PyTorch (any device), step by step
  in its order: the scores in f32, minus zp_k * sum(q), times
  k_scale / sqrt(H), plus the mask; the row max subtracted, exp, divided
  by the row sum before the PV product; then (ctx - zp_v) * v_scale.
  Returns [B, NK, G, H] f32."""
  b, nk, g, h = q.shape
  s = k_cache_q.shape[2]
  qf = q.to(torch.float32)
  ks = score_scale(k_scale, h)
  zp_k, zp_v = float(k_zero_point), float(v_zero_point)
  v_scale = float(np.float32(v_scale))
  maskf = torch.broadcast_to(mask.to(torch.float32), (b, nk, g, s))
  scores = _qdot(qf, k_cache_q.to(torch.float32))
  scores = scores - zp_k * torch.sum(qf, dim=-1, keepdim=True)
  scores = scores * ks
  scores = scores + maskf
  scores = scores - torch.amax(scores, dim=-1, keepdim=True)
  probs = torch.exp(scores)
  probs = probs / torch.sum(probs, dim=-1, keepdim=True)
  ctx = torch.matmul(probs, v_cache_q.to(torch.float32))
  return (ctx - zp_v) * v_scale


def decode_attention_int8_masked(
    q: torch.Tensor,
    k_cache_q: torch.Tensor,
    v_cache_q: torch.Tensor,
    k_scale: float,
    v_scale: float,
    mask: torch.Tensor,
    k_zero_point: float = 0.0,
    v_zero_point: float = 0.0,
    compute: str = 'f32',
) -> torch.Tensor:
  """Decode attention over an int8 cache with an additive mask.

  q [B, NK, G, H] float; caches int8 [B, NK, S, H] with per-tensor scales
  and zero points as Python floats; mask additive (0 visible), any float
  dtype (read as f32), of a shape that broadcasts to [B, NK, G, S], as
  the TPU wrapper broadcasts it. Only compute='f32' is ported (the
  executor's default); the TPU kernel's 'bf16' and 'int8' modes raise on
  both devices. The TPU kernel's batch_block (its grid blocking) has no
  counterpart here. Returns [B, NK, G, H] f32.
  """
  name = 'decode_attention_int8_masked'
  if compute != 'f32':
    raise NotImplementedError(
        f'{name}: compute={compute!r} is not ported (f32 only).')
  args = (q, k_cache_q, v_cache_q, k_scale, v_scale, mask, k_zero_point,
          v_zero_point)
  if _build.device_kind(q) == 'cpu':
    decode_attention_int8_masked.plain_calls += 1
    return decode_attention_int8_masked_plain(*args)
  b, nk, g, h = q.shape
  s = k_cache_q.shape[2]
  r = b * nk
  q2 = q.to(torch.float32).reshape(r, g, h).contiguous()
  for t, nm in ((k_cache_q, 'k_cache'), (v_cache_q, 'v_cache')):
    _build.require(tuple(t.shape) == (b, nk, s, h), name,
                   f'{nm} shape {tuple(t.shape)}')
    _build.require_cuda_tensor(t, name, nm, (torch.int8,), 16)
  # The broadcast view: stride 0 on every axis the mask does not carry.
  m4 = torch.broadcast_to(mask.to(torch.float32), (b, nk, g, s))
  if m4.stride(-1) != 1:
    m4 = m4.contiguous()
  _build.require(m4.is_cuda, name, 'mask must be a CUDA tensor')
  out = torch.empty((r, g, h), dtype=torch.float32, device=q.device)
  fn = _build.entry(
      'attention_masked', 'aeqt_attention_masked',
      [_build.P] * 5 + [_build.I] * 5 + [ctypes.c_longlong] * 3
      + [_build.F] * 4 + [_build.P])
  status = fn(q2.data_ptr(), k_cache_q.data_ptr(), v_cache_q.data_ptr(),
              m4.data_ptr(), out.data_ptr(), r, nk, g, s, h, m4.stride(0),
              m4.stride(1), m4.stride(2), score_scale(k_scale, h),
              float(v_scale), float(k_zero_point), float(v_zero_point),
              _build.stream_ptr(q.device))
  _build.check(status, name, f'G={g}, S={s}, H={h}')
  decode_attention_int8_masked.launches += 1
  return out.reshape(b, nk, g, h)


decode_attention_int8_masked.launches = 0
decode_attention_int8_masked.plain_calls = 0


# -- flash attention (prefill) ----------------------------------------------


def flash_block_s(s: int, block_s: int = 512) -> int:
  """The TPU kernel's S block: min(block_s, S), halved until it divides S."""
  bs = min(block_s, s)
  while s % bs:
    bs //= 2
  return bs


def flash_attention_int8_masked_plain(
    q, k_cache, v_cache, k_scale, v_scale, mask, k_zero_point=0.0,
    v_zero_point=0.0, block_s=512):
  """`_flash_attn_kernel` in plain PyTorch (any device), over the same S
  blocks as the TPU kernel. Returns [B, NK, R, H] f32."""
  b, nk, r, h = q.shape
  s = k_cache.shape[2]
  bs = flash_block_s(s, block_s)
  qf = q.to(torch.float32)
  ks = score_scale(k_scale, h)
  zp_k, zp_v = float(k_zero_point), float(v_zero_point)
  v_scale = float(np.float32(v_scale))
  q_sum = torch.sum(qf, dim=-1, keepdim=True)
  maskf = mask.to(torch.float32)
  m = torch.full((b, nk, r, 1), _NEG, device=q.device)
  l = torch.zeros((b, nk, r, 1), device=q.device)
  acc = torch.zeros((b, nk, r, h), device=q.device)
  for s0 in range(0, s, bs):
    kb = k_cache[:, :, s0:s0 + bs].to(torch.float32)
    vb = v_cache[:, :, s0:s0 + bs].to(torch.float32)
    scores = (_qdot(qf, kb) - zp_k * q_sum) * ks + maskf[..., s0:s0 + bs]
    m_new = torch.maximum(m, torch.amax(scores, dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new)
    l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
    m = m_new
    acc = acc * alpha + torch.matmul(p, vb)
  return (acc / torch.clamp_min(l, 1e-30) - zp_v) * v_scale


def flash_attention_int8_masked(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: float,
    v_scale: float,
    mask: torch.Tensor,
    k_zero_point: float = 0.0,
    v_zero_point: float = 0.0,
) -> torch.Tensor:
  """Prefill-shaped attention over an int8 cache with an additive mask.

  q [B, NK, R, H] float with R = G * T grouped query rows; caches int8
  [B, NK, S, H]; mask [B, 1, R, S] (broadcast over the kv heads) or
  [B, NK, R, S], any float dtype (read as f32). Returns [B, NK, R, H] f32.
  """
  args = (q, k_cache, v_cache, k_scale, v_scale, mask, k_zero_point,
          v_zero_point)
  if _build.device_kind(q) == 'cpu':
    flash_attention_int8_masked.plain_calls += 1
    return flash_attention_int8_masked_plain(*args)
  name = 'flash_attention_int8_masked'
  b, nk, r, h = q.shape
  s = k_cache.shape[2]
  for t, nm in ((k_cache, 'k_cache'), (v_cache, 'v_cache')):
    _build.require(tuple(t.shape) == (b, nk, s, h), name,
                   f'{nm} shape {t.shape}')
    _build.require_cuda_tensor(t, name, nm, (torch.int8,), 16)
  _build.require(mask.dim() == 4 and mask.shape[0] == b
                 and mask.shape[1] in (1, nk)
                 and tuple(mask.shape[2:]) == (r, s), name,
                 f'mask shape {tuple(mask.shape)}')
  q2 = q.to(torch.float32).contiguous()
  m2 = mask.to(torch.float32).contiguous()
  _build.require_cuda_tensor(q2, name, 'q', (torch.float32,), 16)
  _build.require_cuda_tensor(m2, name, 'mask', (torch.float32,))
  out = torch.empty((b, nk, r, h), dtype=torch.float32, device=q.device)
  fn = _build.entry(
      'flash_attention_int8', 'aeqt_flash_attention_int8',
      [_build.P] * 5 + [_build.I] * 6 + [_build.F] * 4 + [_build.P])
  status = fn(q2.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
              m2.data_ptr(), out.data_ptr(), b * nk, nk, r, s, h,
              int(m2.shape[1]), score_scale(k_scale, h), float(v_scale),
              float(k_zero_point), float(v_zero_point),
              _build.stream_ptr(q.device))
  _build.check(status, name, f'H={h}')
  flash_attention_int8_masked.launches += 1
  return out


flash_attention_int8_masked.launches = 0
flash_attention_int8_masked.plain_calls = 0


# -- int4-per-group KV cache ------------------------------------------------
#
# Pools [B, NK, S, H/2] uint8, split-half along H: byte i holds column i in
# its low nibble and column H/2 + i in its high nibble. K codes are
# unsigned in [0, 15] (asymmetric: K = code * scale + min), V codes signed
# in [-8, 7] (symmetric: V = code * scale). Per-group statistics of each
# row sit in the sidecar [B, NK, 3 * NG, S] bf16, NG = H / group, S minor:
# rows [0, NG) K scales, [NG, 2 NG) K mins, [2 NG, 3 NG) V scales.


def _f32(value: float, device) -> torch.Tensor:
  """value rounded to an f32 device scalar, as jnp rounds a Python
  constant before it multiplies an f32 array."""
  return torch.full((), value, dtype=torch.float32, device=device)


def pack_int4_rows(x_q: torch.Tensor) -> torch.Tensor:
  """int4-valued integers [..., H] -> uint8 [..., H/2] (split-half on H)."""
  h = x_q.shape[-1]
  x = x_q.to(torch.int32)
  lo = x[..., :h // 2] & 0xF
  hi = x[..., h // 2:] & 0xF
  return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
  """Inverse of pack_int4_rows: uint8 [..., H/2] -> int8 [..., H]."""
  w = packed.to(torch.int32)
  lo = ((w & 0xF) ^ 8) - 8
  hi = ((w >> 4) ^ 8) - 8
  return torch.cat([lo, hi], dim=-1).to(torch.int8)


def quantize_k_rows_int4_asym(x: torch.Tensor, group: int = 16):
  """Per-group asymmetric int4 quantization of K rows.

  x [..., H] float -> (packed uint8 [..., H/2] of codes in [0, 15],
  scale f32 [..., H/group], min f32 [..., H/group]). The scale is
  max(max - min, 1e-9) times f32(1/15) (a multiply), the codes
  round((x - min) / scale) (a divide), half to even.
  """
  h = x.shape[-1]
  xg = x.to(torch.float32).reshape(*x.shape[:-1], h // group, group)
  mn = torch.amin(xg, dim=-1)
  mx = torch.amax(xg, dim=-1)
  scale = torch.clamp_min(mx - mn, 1e-9) * _f32(1.0 / 15.0, x.device)
  codes = torch.clamp(torch.round((xg - mn[..., None]) / scale[..., None]),
                      0, 15).to(torch.int32).reshape(x.shape)
  return pack_int4_rows(codes), scale, mn


def quantize_v_rows_int4_group(x: torch.Tensor, group: int = 16):
  """Per-group symmetric int4 quantization of V rows.

  x [..., H] float -> (packed uint8 [..., H/2] of codes in [-8, 7],
  scale f32 [..., H/group]): max(absmax, 1e-9) times f32(1/7), codes
  round(x / scale).
  """
  h = x.shape[-1]
  xg = x.to(torch.float32).reshape(*x.shape[:-1], h // group, group)
  absmax = torch.amax(torch.abs(xg), dim=-1)
  scale = torch.clamp_min(absmax, 1e-9) * _f32(1.0 / 7.0, x.device)
  codes = torch.clamp(torch.round(xg / scale[..., None]), -8, 7).to(
      torch.int32).reshape(x.shape)
  return pack_int4_rows(codes), scale


def build_kv_sidecar_group(k_scale, k_min, v_scale) -> torch.Tensor:
  """Stack per-group statistics [..., S, NG] f32 into the sidecar
  [..., 3 * NG, S] bf16 (rounded to nearest even)."""
  stats = torch.cat([k_scale, k_min, v_scale], dim=-1)
  return stats.transpose(-1, -2).to(torch.bfloat16).contiguous()


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
  return t.to(torch.bfloat16).to(torch.float32)


def decode_attention_int4_group_lengths_plain(
    q, k_packed, v_packed, sidecar, lengths, group=16,
    out_dtype=torch.float32):
  """`_ctx_prefix_len_int4_group` in plain PyTorch (any device).

  q is rounded to bf16; the K operand is bf16(kcode * kscale) and the V
  operand bf16(vcode * vscale), each product rounded once; scores are
  q . K in f32 plus the f32 dot of the per-group sums of q with the K
  mins, times f32(1 / sqrt(H)); rows at or past a row's length score
  -1e30; probs are rounded to bf16 before the f32 context sum.
  """
  b, nk, g, h = q.shape
  s = k_packed.shape[2]
  ng = h // group
  qb = _bf16_round(q.to(torch.float32))
  grp = torch.arange(h, device=q.device) // group   # column -> group
  sc = sidecar.to(torch.float32)
  k32 = k_packed.to(torch.int32)
  kcodes = torch.cat([k32 & 0xF, k32 >> 4], dim=-1).to(torch.float32)
  kscale_cols = sc[:, :, :ng, :].transpose(-1, -2)[..., grp]  # [B,NK,S,H]
  kd = _bf16_round(kcodes * kscale_cols)
  scores = _qdot(qb, kd)                                       # [B,NK,G,S]
  qsums = torch.sum(qb.reshape(b, nk, g, ng, group), dim=-1)   # [B,NK,G,NG]
  scores = scores + torch.matmul(qsums, sc[:, :, ng:2 * ng, :])
  scores = scores * _f32(1.0 / (h ** 0.5), q.device)
  pos = torch.arange(s, device=q.device, dtype=torch.int32)
  live = pos.reshape(1, 1, 1, s) < lengths.to(torch.int32).reshape(b, 1, 1, 1)
  scores = torch.where(live, scores, _NEG)
  scores = scores - torch.amax(scores, dim=-1, keepdim=True)
  probs = torch.exp(scores)
  probs = probs / torch.sum(probs, dim=-1, keepdim=True)
  vcodes = unpack_int4_rows(v_packed).to(torch.float32)
  vscale_cols = sc[:, :, 2 * ng:, :].transpose(-1, -2)[..., grp]
  vd = _bf16_round(vcodes * vscale_cols)
  return torch.matmul(_bf16_round(probs), vd).to(out_dtype)


def decode_attention_int4_group_lengths(
    q: torch.Tensor,
    k_packed: torch.Tensor,
    v_packed: torch.Tensor,
    sidecar: torch.Tensor,
    lengths: torch.Tensor,
    group: int = 16,
    out_dtype=torch.float32,
) -> torch.Tensor:
  """Decode attention over per-group asym-K / sym-V int4 KV pools.

  q [B, NK, G, H] float; k_packed / v_packed [B, NK, S, H/2] uint8;
  sidecar [B, NK, 3 * (H / group), S] bf16 (build_kv_sidecar_group);
  lengths int32 [B]. A length of 0 gives every one of the S rows the
  weight 1/S, as the TPU kernel does. The TPU kernel's batch_block (its
  grid blocking) has no counterpart here. Returns [B, NK, G, H] in
  out_dtype.
  """
  args = (q, k_packed, v_packed, sidecar, lengths, group, out_dtype)
  if _build.device_kind(q) == 'cpu':
    decode_attention_int4_group_lengths.plain_calls += 1
    return decode_attention_int4_group_lengths_plain(*args)
  name = 'decode_attention_int4_group_lengths'
  b, nk, g, h = q.shape
  s = k_packed.shape[2]
  r = b * nk
  _build.require(out_dtype in (torch.float32, torch.bfloat16), name,
                 f'out_dtype {out_dtype} must be f32 or bf16')
  q2 = q.to(torch.float32).reshape(r, g, h).contiguous()
  for t, nm in ((k_packed, 'k_packed'), (v_packed, 'v_packed')):
    _build.require(tuple(t.shape) == (b, nk, s, h // 2), name,
                   f'{nm} shape {tuple(t.shape)}')
    _build.require_cuda_tensor(t, name, nm, (torch.uint8,), 16)
  _build.require(tuple(sidecar.shape) == (b, nk, 3 * (h // group), s), name,
                 f'sidecar shape {tuple(sidecar.shape)}')
  _build.require_cuda_tensor(sidecar, name, 'sidecar', (torch.bfloat16,))
  lens = lengths.to(torch.int32).contiguous()
  _build.require_cuda_tensor(lens, name, 'lengths', (torch.int32,))
  _build.require(lens.numel() == b, name, 'lengths must have B entries')
  out = torch.empty((r, g, h), dtype=out_dtype, device=q.device)
  fn = _build.entry(
      'attention_int4_group', 'aeqt_attention_int4_group',
      [_build.P] * 6 + [_build.I] * 7 + [_build.F, _build.P])
  status = fn(q2.data_ptr(), k_packed.data_ptr(), v_packed.data_ptr(),
              sidecar.data_ptr(), lens.data_ptr(), out.data_ptr(),
              int(out_dtype == torch.bfloat16), r, nk, g, s, h, group,
              float(np.float32(1.0 / (h ** 0.5))),
              _build.stream_ptr(q.device))
  _build.check(status, name, f'G={g}, S={s}, H={h}, group={group}')
  decode_attention_int4_group_lengths.launches += 1
  return out.reshape(b, nk, g, h)


decode_attention_int4_group_lengths.launches = 0
decode_attention_int4_group_lengths.plain_calls = 0
