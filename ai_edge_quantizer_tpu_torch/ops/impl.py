"""PyTorch implementations of the graph ops on the Gemma decode path.

Port of `ai_edge_quantizer_tpu/ops/impl.py`, same `register` pattern. Only
the opcodes that the Gemma decode and serving graphs use are here (with
the int4-group KV cache's INT4G_ATTENTION and INT4G_ATTENTION_SCATTER,
and the HADAMARD_ROTATION op that the `*_hadamard` recipes insert); the
executor raises NotImplementedError for any other opcode.

Type promotion follows JAX, not torch: a binary op over two tensors
promotes both to their common dtype even when one of them is 0-d (torch
would keep the dtype of the n-d operand).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ai_edge_quantizer_tpu_torch.execution import quant_arith
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.kernels import attention


@dataclasses.dataclass
class OpContext:
  """What an op impl can see."""

  op: ir.Op
  subgraph: ir.Subgraph
  graph: ir.Graph

  @property
  def attrs(self) -> dict:
    return self.op.attrs

  def in_tensor(self, i: int) -> Optional[ir.Tensor]:
    tid = self.op.inputs[i]
    return self.subgraph.tensors[tid] if tid >= 0 else None

  def out_tensor(self, i: int) -> ir.Tensor:
    return self.subgraph.tensors[self.op.outputs[i]]


OPS: dict = {}


def register(name: str) -> Callable:
  def deco(fn):
    OPS[name] = fn
    return fn
  return deco


def _promote(a: torch.Tensor, b: torch.Tensor):
  dt = torch.promote_types(a.dtype, b.dtype)
  return a.to(dt), b.to(dt)


def fused_activation(x, kind: str):
  if kind in (None, 'NONE'):
    return x
  if kind == 'RELU':
    return torch.relu(x)
  if kind == 'RELU6':
    return torch.clamp(x, 0.0, 6.0)
  if kind == 'TANH':
    return torch.tanh(x)
  raise ValueError(f'Unsupported fused activation: {kind}')


def _axes(ctx: OpContext, axis) -> Optional[tuple]:
  ax = ctx.attrs.get('axis', axis)
  if ax is None:
    return None
  if isinstance(ax, torch.Tensor):
    ax = ax.cpu().numpy()
  return tuple(int(a) for a in np.asarray(ax).reshape(-1))


# -- matmul family ----------------------------------------------------------


@register('FULLY_CONNECTED')
def fully_connected(ctx: OpContext, x, w, b=None):
  """x [..., in] @ w[out, in]^T + b, f32 accumulation, out in x.dtype."""
  xp, wp = _promote(x, w)
  y = torch.matmul(xp.to(torch.float32), wp.to(torch.float32).T).to(x.dtype)
  if b is not None:
    y = torch.add(*_promote(y, b))
  return fused_activation(y, ctx.attrs.get('fused_activation', 'NONE'))


@register('BATCH_MATMUL')
def batch_matmul(ctx: OpContext, a, b):
  if ctx.attrs.get('adj_x', False):
    a = a.transpose(-1, -2)
  if ctx.attrs.get('adj_y', False):
    b = b.transpose(-1, -2)
  ap, bp = _promote(a, b)
  return torch.matmul(ap.to(torch.float32), bp.to(torch.float32)).to(a.dtype)


@register('EMBEDDING_LOOKUP')
def embedding_lookup(ctx: OpContext, ids, table):
  return table[ids.to(torch.int64)]


# -- shape ops --------------------------------------------------------------


@register('RESHAPE')
def reshape(ctx: OpContext, x, shape=None):
  return x.reshape(ctx.out_tensor(0).shape)


@register('TRANSPOSE')
def transpose(ctx: OpContext, x, perm=None):
  p = ctx.attrs.get('perm')
  if p is None and perm is not None:
    p = np.asarray(perm).tolist()
  return x.permute(*p)


@register('SLICE')
def slice_op(ctx: OpContext, x, begin=None, size=None):
  begin = ctx.attrs.get('begin', begin)
  if isinstance(begin, torch.Tensor):
    raise NotImplementedError('SLICE with a runtime begin is not ported.')
  out_shape = ctx.out_tensor(0).shape
  # lax.dynamic_slice clamps each start so the slice fits.
  idx = tuple(
      slice(s, s + n) for s, n in (
          (min(max(int(b), 0), dim - n), n)
          for b, n, dim in zip(np.asarray(begin), out_shape, x.shape)))
  return x[idx]


@register('BROADCAST_TO')
def broadcast_to(ctx: OpContext, x, shape=None):
  return x.expand(ctx.out_tensor(0).shape)


def dynamic_update_slice(operand: torch.Tensor, update: torch.Tensor,
                         starts: torch.Tensor) -> torch.Tensor:
  """lax.dynamic_update_slice: each start is clamped on the device to
  [0, operand_dim - update_dim], so the update always fits (index_put_
  alone would not clamp). Functional: the operand is not written."""
  out = operand.clone()
  idx = []
  for i in range(operand.ndim):
    hi = operand.shape[i] - update.shape[i]
    s = starts[i].to(torch.int64).clamp(0, hi)
    view = [1] * operand.ndim
    view[i] = update.shape[i]
    idx.append((torch.arange(update.shape[i], device=operand.device) + s)
               .view(view))
  out[tuple(idx)] = update.to(operand.dtype)
  return out


@register('DYNAMIC_UPDATE_SLICE')
def dynamic_update_slice_op(ctx: OpContext, operand, update, start_indices):
  return dynamic_update_slice(operand, update, start_indices)


# -- elementwise ------------------------------------------------------------


def _register_binary(name: str, fn):
  @register(name)
  def _impl(ctx: OpContext, a, b, _fn=fn):
    return _fn(*_promote(a, b))


_register_binary('ADD', torch.add)
_register_binary('SUB', torch.sub)
_register_binary('MUL', torch.mul)
_register_binary('EQUAL', torch.eq)
_register_binary('LESS_EQUAL', torch.le)
_register_binary('GREATER_EQUAL', torch.ge)


@register('CAST')
def cast(ctx: OpContext, x):
  return x.to(quant_arith.STORAGE_TORCH_DTYPES[ctx.out_tensor(0).dtype])


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
  """jax.nn.gelu(approximate=True), term by term in the same order."""
  c = 0.7978845608028654  # sqrt(2/pi)
  cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x))))
  return x * cdf


@register('GELU')
def gelu(ctx: OpContext, x):
  if bool(ctx.attrs.get('approximate', True)):
    return gelu_tanh(x)
  return torch.nn.functional.gelu(x)


@register('SOFTMAX')
def softmax(ctx: OpContext, x):
  beta = float(ctx.attrs.get('beta', 1.0))
  return torch.softmax(beta * x, dim=-1)


@register('ARG_MAX')
def arg_max(ctx: OpContext, x, axis=None):
  ax = int(ctx.attrs.get('axis', -1 if axis is None else axis))
  # torch.argmax returns the first maximal index, like jnp.argmax.
  return torch.argmax(x, dim=ax).to(torch.int32)


@register('SUM')
def sum_op(ctx: OpContext, x, axis=None):
  return torch.sum(x, dim=_axes(ctx, axis),
                   keepdim=bool(ctx.attrs.get('keep_dims', False)))


@register('REDUCE_MIN')
def reduce_min(ctx: OpContext, x, axis=None):
  return torch.amin(x, dim=_axes(ctx, axis),
                    keepdim=bool(ctx.attrs.get('keep_dims', False)))


# -- transformer ops --------------------------------------------------------


def rms_inverse(xf: torch.Tensor, eps: float) -> torch.Tensor:
  """1 / sqrt(mean(x^2) + eps) over the last dim of f32 x, [..., 1] f32.

  The sum of squares is taken in f64 (each square is exact there) and
  rounded to f32 once, which makes a difference between orders of the sum
  very unlikely, though not impossible: the CUDA kernels that fuse the
  norm (kernels/csrc/drq_common.cuh `rmsnorm_quant_row`) sum in another
  order and, in every check so far, get the same f32. 1 / sqrt is two IEEE
  roundings on every device, which `torch.rsqrt` does not promise. The JAX
  op takes an f32 mean and rsqrt; at D 2048 its var differs from this one
  by an ulp in about half the rows, as an f32 mean in PyTorch does, and a
  few DRQ codes in a million flip by one
  (tests/test_torch_port_block.py, `test_norm_codes_match_jax_at_gemma_width`).
  """
  d = xf.shape[-1]
  var = (torch.sum(torch.square(xf.to(torch.float64)), dim=-1, keepdim=True)
         / d).to(torch.float32)
  return torch.reciprocal(torch.sqrt(var + eps))


@register('RMS_NORM')
def rms_norm(ctx: OpContext, x, gamma=None):
  eps = float(ctx.attrs.get('epsilon', 1e-6))
  y = x * rms_inverse(x.to(torch.float32), eps).to(x.dtype)
  if gamma is not None:
    y = torch.mul(*_promote(y, gamma))
  return y


@functools.lru_cache(maxsize=32)
def rope_freqs(base: float, half: int, device: torch.device) -> torch.Tensor:
  # Computed in numpy exactly as the JAX op does, copied once per device.
  freqs = base ** (-np.arange(0, half, dtype=np.float32) / half)
  return torch.as_tensor(freqs, device=device)


@register('ROPE')
def rope(ctx: OpContext, x, positions):
  """Rotary position embedding over the last dim (half-split convention)."""
  base = float(ctx.attrs.get('rope_base', 10000.0))
  half = x.shape[-1] // 2
  freqs = rope_freqs(base, half, x.device)
  angles = positions[..., None].to(torch.float32) * freqs  # [..., half]
  sin = torch.sin(angles)[..., None, :]
  cos = torch.cos(angles)[..., None, :]
  x1, x2 = x[..., :half], x[..., half:]
  return torch.cat(
      [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=32)
def normalized_hadamard(size: int, device: torch.device) -> torch.Tensor:
  # Built in numpy exactly as the JAX op does, copied once per device.
  h = np.array([[1.0]], dtype=np.float32)
  while h.shape[0] < size:
    h = np.block([[h, h], [h, -h]])
  return torch.as_tensor((h / np.sqrt(size)).astype(np.float32),
                         device=device)


@register('HADAMARD_ROTATION')
def hadamard_rotation(ctx: OpContext, x):
  """Block-diagonal normalized Hadamard rotation of the last dimension: a
  plain product (no Pallas kernel in the JAX package either), f32 sums,
  cast back to x's dtype."""
  hsize = int(ctx.attrs['hadamard_size'])
  h = normalized_hadamard(hsize, x.device)
  shape = x.shape
  xr = x.reshape(shape[:-1] + (shape[-1] // hsize, hsize))
  return torch.matmul(xr.to(torch.float32), h).to(x.dtype).reshape(shape)


# -- int4-per-group KV cache (serving custom ops) ---------------------------


def _int4g_new_rows(k_rows, v_rows, group: int):
  """This step's K/V rows [B, NK, 1, H] quantized: packed K and V rows and
  the bf16 sidecar column [B, NK, 3 * NG, 1]."""
  kp_new, ks, km = attention.quantize_k_rows_int4_asym(k_rows, group)
  vp_new, vs = attention.quantize_v_rows_int4_group(v_rows, group)
  return kp_new, vp_new, attention.build_kv_sidecar_group(ks, km, vs)


@register('INT4G_ATTENTION')
def int4g_attention(ctx: OpContext, q, k_rows, v_rows, k_cache, v_cache,
                    sidecar, cache_pos):
  """Quantize this step's K/V rows, write them at the shared position
  cache_pos[2] (the packed rows into both pools, the statistics as a
  sidecar column: S is the sidecar's last axis), then attend over
  lengths = pos + 1 with `attention.decode_attention_int4_group_lengths`.

  q [B, NK, G, H]; k_rows, v_rows [B, NK, 1, H]; pools [B, NK, S, H/2]
  uint8; sidecar [B, NK, 3 * H / group, S] bf16; cache_pos [4] int32.
  Returns (ctx in q's dtype, k_cache', v_cache', sidecar'): new tensors,
  the inputs are not written (the executor's functional contract).
  """
  group = int(ctx.attrs.get('group', 16))
  b = q.shape[0]
  if k_rows.shape[2] != 1:
    raise ValueError('INT4G_ATTENTION is decode-shaped (T = 1).')
  kp_new, vp_new, col = _int4g_new_rows(k_rows, v_rows, group)
  pos = cache_pos[2].to(torch.int32)
  zero = torch.zeros_like(pos)
  rows_at = torch.stack([zero, zero, pos, zero])
  k_cache2 = dynamic_update_slice(k_cache, kp_new, rows_at)
  v_cache2 = dynamic_update_slice(v_cache, vp_new, rows_at)
  sidecar2 = dynamic_update_slice(sidecar, col,
                                  torch.stack([zero, zero, zero, pos]))
  lengths = (pos + 1).expand(b)
  out = attention.decode_attention_int4_group_lengths(
      q.to(torch.float32), k_cache2, v_cache2, sidecar2, lengths,
      group=group, out_dtype=q.dtype)
  return out, k_cache2, v_cache2, sidecar2


@register('INT4G_ATTENTION_SCATTER')
def int4g_attention_scatter(ctx: OpContext, q, k_rows, v_rows, k_cache,
                            v_cache, sidecar, positions):
  """INT4G_ATTENTION with a position per row (continuous batching): row b
  writes its new K/V row and sidecar column at positions[b] (no write for
  a position outside [0, S), as the reference's one-hot select) and
  attends over lengths = positions + 1."""
  group = int(ctx.attrs.get('group', 16))
  b = q.shape[0]
  s = k_cache.shape[2]
  if k_rows.shape[2] != 1:
    raise ValueError('INT4G_ATTENTION_SCATTER is decode-shaped (T = 1).')
  kp_new, vp_new, col = _int4g_new_rows(k_rows, v_rows, group)
  pos = positions.reshape(b).to(torch.int32)
  iota = torch.arange(s, device=pos.device, dtype=torch.int32)
  hit = iota[None, :] == pos[:, None]                            # [B, S]
  hit_rows = hit[:, None, :, None]
  k_cache2 = torch.where(hit_rows, kp_new.to(k_cache.dtype), k_cache)
  v_cache2 = torch.where(hit_rows, vp_new.to(v_cache.dtype), v_cache)
  sidecar2 = torch.where(hit[:, None, None, :], col, sidecar)
  out = attention.decode_attention_int4_group_lengths(
      q.to(torch.float32), k_cache2, v_cache2, sidecar2, pos + 1,
      group=group, out_dtype=q.dtype)
  return out, k_cache2, v_cache2, sidecar2
