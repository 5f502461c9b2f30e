"""PyTorch implementations of every graph op.

Port of `ai_edge_quantizer_tpu/ops/impl.py`, same `register` pattern: the
JAX package's whole op vocabulary, with the int4-group KV cache's
INT4G_ATTENTION and INT4G_ATTENTION_SCATTER; the executor raises
NotImplementedError for any other opcode. STABLEHLO_COMPOSITE is
registered as there, with an impl that only raises: the executor runs a
composite through its body subgraph (as it runs WHILE and IF through
theirs).

Type promotion follows JAX, not torch: a binary op over two tensors
promotes both to their common dtype even when one of them is 0-d (torch
would keep the dtype of the n-d operand).

Where torch's own op is defined otherwise than the JAX one, the JAX
definition is written out: SAME padding is `lax.padtype_to_pads`' (the
lower pad gets the smaller half, so a stride-2 convolution of an even
size pads (0, 1)), applied with `F.pad` before a VALID convolution; the
transposed convolution is `lax.conv_transpose` without a kernel flip (the
input dilated by the stride and padded by `_conv_transpose_padding`, then
correlated); the pools reduce shifted slices of the padded input in the
window's order; the resizes build `jax.image.resize`'s sampling (nearest:
floor((i + 0.5) * in / out); bilinear: the antialiased triangle-kernel
weight matrices); MIRROR_PAD gathers `np.pad`'s indices; GATHER_ND clamps
its indices as JAX's gather does; INTEGER_POW multiplies by squaring as
`lax.integer_pow` does; HARD_SWISH multiplies by 1/6 where the JAX op
divides by 6, as XLA compiles that division. SQRT and RSQRT take the
square root in float64 and round it once (the correctly rounded float32
root, as XLA's is: the CPU's vectorized float32 `torch.sqrt` is not
correctly rounded on every host, see `rms_inverse`; RSQRT then divides
once), and MEAN sums in float64 and rounds the sum once, so that these
results do not depend on a vector path or on the order of a sum: the
card and the CPU agree on them exactly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

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


# -- convolutions (NHWC activations; weight layouts per graph/builder.py) ---


def _pad_str(p) -> str:
  return p if isinstance(p, str) else 'SAME'


def window_pads(padding: str, in_hw, k_hw, strides) -> list:
  """[(lo, hi)] a spatial dim: `lax.padtype_to_pads` for 'SAME' (the total
  pad that makes the output ceil(n / s), its smaller half low) and
  'VALID'."""
  if padding == 'VALID':
    return [(0, 0)] * len(in_hw)
  if padding != 'SAME':
    raise ValueError(f'Unknown padding {padding!r}.')
  pads = []
  for n, k, s in zip(in_hw, k_hw, strides):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    pads.append((total // 2, total - total // 2))
  return pads


def pad_hw(x: torch.Tensor, pads, value=0.0) -> torch.Tensor:
  """NHWC x padded on H and W by pads [(lo, hi), (lo, hi)] with value."""
  (hl, hh), (wl, wh) = pads
  if not (hl or hh or wl or wh):
    return x
  return F.pad(x, (0, 0, wl, wh, hl, hh), value=value)


def _conv_valid(x, w_oihw, stride: int, groups: int, out_dtype):
  """VALID cross-correlation of NHWC x with an OIHW float32 weight, f32
  sums (the JAX op's preferred_element_type), NHWC out in out_dtype."""
  y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), w_oihw,
               stride=stride, groups=groups)
  return y.permute(0, 2, 3, 1).to(out_dtype)


@register('CONV_2D')
def conv2d(ctx: OpContext, x, w, b=None):
  """x [N, H, W, C] (*) w [O, kh, kw, C], SAME or VALID."""
  s = int(ctx.attrs.get('stride', 1))
  xp, wp = _promote(x, w)
  pads = window_pads(_pad_str(ctx.attrs.get('padding', 'SAME')),
                     x.shape[1:3], w.shape[1:3], (s, s))
  y = _conv_valid(pad_hw(xp, pads), wp.to(torch.float32).permute(0, 3, 1, 2),
                  s, 1, x.dtype)
  if b is not None:
    y = torch.add(*_promote(y, b))
  return fused_activation(y, ctx.attrs.get('fused_activation', 'NONE'))


@register('DEPTHWISE_CONV_2D')
def depthwise_conv2d(ctx: OpContext, x, w, b=None):
  """x [N, H, W, ch] (*) w [1, kh, kw, ch], one group a channel."""
  s = int(ctx.attrs.get('stride', 1))
  ch = w.shape[-1]
  xp, wp = _promote(x, w)
  pads = window_pads(_pad_str(ctx.attrs.get('padding', 'SAME')),
                     x.shape[1:3], w.shape[1:3], (s, s))
  # The JAX op's [ch, kh, kw, 1] OHWI weight as OIHW: [ch, 1, kh, kw].
  y = _conv_valid(pad_hw(xp, pads), wp.to(torch.float32).permute(3, 0, 1, 2),
                  s, ch, x.dtype)
  if b is not None:
    y = torch.add(*_promote(y, b))
  return fused_activation(y, ctx.attrs.get('fused_activation', 'NONE'))


def conv_transpose_pads(k: int, s: int, padding: str) -> tuple:
  """`lax._conv_transpose_padding`: the pads of the stride-dilated input."""
  if padding == 'SAME':
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
  elif padding == 'VALID':
    pad_len = k + s - 2 + max(k - s, 0)
    pad_a = k - 1
  else:
    raise ValueError(f'Unknown padding {padding!r}.')
  return pad_a, pad_len - pad_a


@register('CONV_2D_TRANSPOSE')
def conv2d_transpose(ctx: OpContext, output_shape, w, x, b=None):
  """`lax.conv_transpose(x, w as HWIO, transpose_kernel=False)`: x dilated
  by the stride, padded, then correlated with the unflipped kernel. The
  output_shape operand is not read (the JAX op's is not either)."""
  s = int(ctx.attrs.get('stride', 1))
  padding = _pad_str(ctx.attrs.get('padding', 'SAME'))
  xp, wp = _promote(x, w)
  n, h, wd, c = x.shape
  kh, kw = w.shape[1:3]
  dilated = xp.new_zeros((n, (h - 1) * s + 1, (wd - 1) * s + 1, c))
  dilated[:, ::s, ::s, :] = xp
  pads = [conv_transpose_pads(k, s, padding) for k in (kh, kw)]
  # w [O, kh, kw, I] is OIHW after one permute.
  y = _conv_valid(pad_hw(dilated, pads),
                  wp.to(torch.float32).permute(0, 3, 1, 2), 1, 1, x.dtype)
  if b is not None:
    y = torch.add(*_promote(y, b))
  return fused_activation(y, ctx.attrs.get('fused_activation', 'NONE'))


# -- pooling / resize -------------------------------------------------------


def windows(xp: torch.Tensor, kh: int, kw: int, stride: int) -> list:
  """The kh * kw shifted strided views of padded NHWC xp, in the window's
  row-major order: element (n, i, j, c) of the (a, b)-th is
  xp[n, i * stride + a, j * stride + b, c]."""
  ho = (xp.shape[1] - kh) // stride + 1
  wo = (xp.shape[2] - kw) // stride + 1
  return [xp[:, a:a + (ho - 1) * stride + 1:stride,
             b:b + (wo - 1) * stride + 1:stride, :]
          for a in range(kh) for b in range(kw)]


def _window_sum(xp: torch.Tensor, size: int, stride: int) -> torch.Tensor:
  parts = windows(xp, size, size, stride)
  acc = parts[0].clone()
  for part in parts[1:]:
    acc += part
  return acc


@register('AVERAGE_POOL_2D')
def average_pool_2d(ctx: OpContext, x):
  """Window sums over window counts: padded pixels are not counted."""
  size = int(ctx.attrs.get('filter_size', 2))
  s = int(ctx.attrs.get('stride', 2))
  pads = window_pads(_pad_str(ctx.attrs.get('padding', 'VALID')),
                     x.shape[1:3], (size, size), (s, s))
  sums = _window_sum(pad_hw(x, pads), size, s)
  ones = torch.ones((1,) + tuple(x.shape[1:3]) + (1,), dtype=x.dtype,
                    device=x.device)
  counts = _window_sum(pad_hw(ones, pads), size, s)
  return sums / counts


@register('MAX_POOL_2D')
def max_pool_2d(ctx: OpContext, x):
  size = int(ctx.attrs.get('filter_size', 2))
  s = int(ctx.attrs.get('stride', 2))
  pads = window_pads(_pad_str(ctx.attrs.get('padding', 'VALID')),
                     x.shape[1:3], (size, size), (s, s))
  return functools.reduce(torch.maximum, windows(
      pad_hw(x, pads, value=-float('inf')), size, size, s))


@functools.lru_cache(maxsize=64)
def _bilinear_weights(m: int, n: int) -> np.ndarray:
  """`jax.image.scale.compute_weight_mat` for the triangle kernel with
  antialiasing, float32 [m, n]: output sample j of n weighs input i of m."""
  f32 = np.float32
  inv_scale = f32(1.0 / (n / m))
  kernel_scale = max(inv_scale, f32(1.0))
  sample_f = ((np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0)
              - f32(0.5))
  x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
      / kernel_scale
  weights = np.maximum(f32(0), f32(1) - np.abs(x))
  total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
  weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                     weights / np.where(total != 0, total, f32(1)), f32(0))
  inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
  return np.where(inside[None, :], weights, f32(0)).astype(f32)


@register('RESIZE_BILINEAR')
def resize_bilinear(ctx: OpContext, x, size=None):
  """jax.image.resize(x, out shape, 'bilinear'): one weight matrix a
  resized dim, contracted in float32."""
  out_shape = ctx.out_tensor(0).shape
  y = x if x.is_floating_point() else x.to(torch.float32)
  for d in range(y.dim()):
    m, n = y.shape[d], out_shape[d]
    if m == n:
      continue
    w = torch.as_tensor(_bilinear_weights(m, n), device=y.device).to(y.dtype)
    y = torch.movedim(torch.tensordot(y, w, dims=([d], [0])), -1, d)
  return y


@register('RESIZE_NEAREST_NEIGHBOR')
def resize_nearest(ctx: OpContext, x, size=None):
  """jax.image.resize(x, out shape, 'nearest'): output i of n reads input
  floor((i + 0.5) * m / n) of m, computed in float32."""
  out_shape = ctx.out_tensor(0).shape
  for d in range(x.dim()):
    m, n = x.shape[d], out_shape[d]
    if m == n:
      continue
    idx = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                   * np.float32(m) / np.float32(n)).astype(np.int64)
    x = torch.index_select(x, d, torch.as_tensor(idx, device=x.device))
  return x


@register('SPACE_TO_DEPTH')
def space_to_depth(ctx: OpContext, x):
  bs = int(ctx.attrs.get('block_size', 2))
  n, h, w, c = x.shape
  x = x.reshape(n, h // bs, bs, w // bs, bs, c).permute(0, 1, 3, 2, 4, 5)
  return x.reshape(n, h // bs, w // bs, bs * bs * c)


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


@register('CONCATENATION')
def concatenation(ctx: OpContext, *xs):
  dt = functools.reduce(torch.promote_types, [x.dtype for x in xs])
  return torch.cat([x.to(dt) for x in xs], dim=int(ctx.attrs.get('axis', -1)))


@register('STRIDED_SLICE')
def strided_slice(ctx: OpContext, x, begin=None, end=None, strides=None):
  """x[begin:end:strides] a dim, numpy's slice semantics (negative strides
  too, which torch's slicing refuses: such a dim gathers its indices)."""
  begin = np.asarray(ctx.attrs.get('begin', begin)).astype(int)
  end = np.asarray(ctx.attrs.get('end', end)).astype(int)
  strides = np.asarray(ctx.attrs.get('strides', strides)).astype(int)
  for d, (b, e, st) in enumerate(zip(begin, end, strides)):
    sl = slice(int(b), int(e), int(st))
    if st > 0:
      x = x[(slice(None),) * d + (sl,)]
    else:
      idx = np.ascontiguousarray(np.arange(x.shape[d])[sl])
      x = torch.index_select(x, d, torch.as_tensor(idx, device=x.device))
  return x


@register('SPLIT')
def split(ctx: OpContext, axis, x):
  n = int(ctx.attrs.get('num_splits', len(ctx.op.outputs)))
  ax = int(np.asarray(axis)) if not isinstance(axis, int) else axis
  if x.shape[ax] % n:
    raise ValueError(f'SPLIT: {x.shape[ax]} does not split in {n}.')
  return tuple(torch.split(x, x.shape[ax] // n, dim=ax))


def _pad_pairs(ctx: OpContext, paddings) -> list:
  p = np.asarray(ctx.attrs.get('paddings', paddings)).astype(int)
  return [(int(a), int(b)) for a, b in p]


def _pad_constant(x: torch.Tensor, pairs: list, value) -> torch.Tensor:
  """jnp.pad(x, pairs, constant_values=value); value a number or a 0-d
  tensor (read on the device: no copy to the host)."""
  out_shape = [n + a + b for n, (a, b) in zip(x.shape, pairs)]
  if isinstance(value, torch.Tensor):
    out = value.reshape(()).to(x.dtype).expand(out_shape).clone()
  else:
    out = torch.full(out_shape, value, dtype=x.dtype, device=x.device)
  out[tuple(slice(a, a + n) for n, (a, _) in zip(x.shape, pairs))] = x
  return out


@register('PAD')
def pad(ctx: OpContext, x, paddings=None):
  return _pad_constant(x, _pad_pairs(ctx, paddings), 0)


@register('PADV2')
def padv2(ctx: OpContext, x, paddings=None, constant=None):
  cval = constant if constant is not None else ctx.attrs.get('constant', 0.0)
  return _pad_constant(x, _pad_pairs(ctx, paddings), cval)


@register('MIRROR_PAD')
def mirror_pad(ctx: OpContext, x, paddings=None):
  """jnp.pad(mode='reflect' | 'symmetric'): each padded dim gathers the
  indices np.pad gives an arange of its length."""
  mode = ctx.attrs.get('mode', 'REFLECT').lower()
  for d, (a, b) in enumerate(_pad_pairs(ctx, paddings)):
    if a or b:
      idx = np.pad(np.arange(x.shape[d]), (a, b), mode=mode)
      x = torch.index_select(x, d, torch.as_tensor(idx, device=x.device))
  return x


@register('GATHER_ND')
def gather_nd(ctx: OpContext, x, indices):
  """x[tuple(moveaxis(indices, -1, 0))] as JAX gathers: a negative index
  counts from the end, then every index is clamped into its dim."""
  idx = indices.to(torch.int64)
  parts = []
  for d in range(idx.shape[-1]):
    i = idx[..., d]
    n = x.shape[d]
    parts.append(torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1))
  return x[tuple(parts)]


@register('PACK')
def pack(ctx: OpContext, *xs):
  dt = functools.reduce(torch.promote_types, [x.dtype for x in xs])
  return torch.stack([x.to(dt) for x in xs], dim=int(ctx.attrs.get('axis', 0)))


@register('UNPACK')
def unpack(ctx: OpContext, x):
  return tuple(torch.unbind(x, dim=int(ctx.attrs.get('axis', 0))))


@register('GATHER')
def gather(ctx: OpContext, x, indices):
  """jnp.take(x, indices, axis): out shape x[:axis] + indices + x[axis+1:]."""
  ax = int(ctx.attrs.get('axis', 0)) % x.dim()
  rows = torch.movedim(x, ax, 0)[indices.to(torch.int64)]
  return torch.movedim(rows, tuple(range(indices.dim())),
                       tuple(range(ax, ax + indices.dim())))


@register('BROADCAST_TO')
def broadcast_to(ctx: OpContext, x, shape=None):
  return x.expand(ctx.out_tensor(0).shape)


@register('BROADCAST_IN_DIM')
def broadcast_in_dim(ctx: OpContext, x):
  """lax.broadcast_in_dim: operand dim i becomes output dim
  broadcast_dimensions[i]; the other output dims broadcast."""
  shape = tuple(int(n) for n in ctx.attrs['shape'])
  view = [1] * len(shape)
  for i, d in enumerate(ctx.attrs['broadcast_dimensions']):
    view[int(d)] = x.shape[i]
  return x.reshape(view).expand(shape)


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


def _squared_difference(a, b):
  d = a - b
  return d * d


_register_binary('ADD', torch.add)
_register_binary('SUB', torch.sub)
_register_binary('MUL', torch.mul)
_register_binary('DIV', torch.div)
_register_binary('MAXIMUM', torch.maximum)
_register_binary('SQUARED_DIFFERENCE', _squared_difference)
_register_binary('EQUAL', torch.eq)
_register_binary('NOT_EQUAL', torch.ne)
_register_binary('MINIMUM', torch.minimum)
_register_binary('LESS', torch.lt)
_register_binary('LESS_EQUAL', torch.le)
_register_binary('GREATER', torch.gt)
_register_binary('GREATER_EQUAL', torch.ge)
_register_binary('LOGICAL_AND', torch.logical_and)
_register_binary('LOGICAL_OR', torch.logical_or)
_register_binary('POW', torch.pow)
# jnp.floor_divide and jnp.mod: the quotient rounded down, the remainder
# with the divisor's sign (torch.remainder, not torch.fmod).
_register_binary('FLOOR_DIV',
                 functools.partial(torch.div, rounding_mode='floor'))
_register_binary('FLOOR_MOD', torch.remainder)


@register('CAST')
def cast(ctx: OpContext, x):
  return x.to(quant_arith.STORAGE_TORCH_DTYPES[ctx.out_tensor(0).dtype])


def _register_unary(name: str, fn):
  @register(name)
  def _impl(ctx: OpContext, x, _fn=fn):
    return _fn(x)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
  """The correctly rounded float32 square root (see `rms_inverse`)."""
  return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _sign(x: torch.Tensor) -> torch.Tensor:
  # jnp.sign keeps a NaN; torch.sign gives 0 for it.
  s = torch.sign(x)
  return torch.where(torch.isnan(x), x, s) if x.is_floating_point() else s


def _hard_swish(x: torch.Tensor) -> torch.Tensor:
  """x * clip(x + 3, 0, 6) / 6, the division by the constant 6 taken as
  XLA compiles the JAX op's: a product by its float32 reciprocal."""
  return x * torch.clamp(x + 3.0, 0, 6.0) * float(np.float32(1.0 / 6.0))


_register_unary('RELU', torch.relu)
_register_unary('TANH', torch.tanh)
_register_unary('LOGISTIC', torch.sigmoid)
_register_unary('RSQRT', lambda x: torch.reciprocal(sqrt_f32(x)))
_register_unary('SQRT', sqrt_f32)
_register_unary('SIN', torch.sin)
_register_unary('COS', torch.cos)
_register_unary('HARD_SWISH', _hard_swish)
_register_unary('EXP', torch.exp)
_register_unary('LOG', torch.log)
_register_unary('NEG', torch.neg)
_register_unary('ABS', torch.abs)
_register_unary('SIGN', _sign)
_register_unary('FLOOR', torch.floor)
_register_unary('ERF', torch.erf)
_register_unary('IDENTITY', lambda x: x)


@register('INTEGER_POW')
def integer_pow(ctx: OpContext, x):
  """lax.integer_pow: x to a constant integer power by repeated squaring,
  the products in its order; a negative power is 1 over the positive
  one."""
  y = int(ctx.attrs['exponent'])
  if y == 0:
    return torch.ones_like(x)
  reciprocal = y < 0
  y = abs(y)
  acc = None
  while y > 0:
    if y & 1:
      acc = x if acc is None else acc * x
    y >>= 1
    if y > 0:
      x = x * x
  return torch.ones_like(acc) / acc if reciprocal else acc


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


def _keep_dims(ctx: OpContext) -> bool:
  return bool(ctx.attrs.get('keep_dims', False))


@register('MEAN')
def mean(ctx: OpContext, x, axis=None):
  """jnp.mean: the sum over the axes divided by their element count. The
  sum is taken in float64 and rounded to x's dtype once (see the module
  docstring), then divided in x's dtype."""
  ax = _axes(ctx, axis)
  ax = tuple(range(x.dim())) if ax is None else ax
  count = 1
  for a in ax:
    count *= x.shape[a]
  total = torch.sum(x.to(torch.float64), dim=ax, keepdim=_keep_dims(ctx))
  return total.to(x.dtype) / count


@register('REDUCE_MAX')
def reduce_max(ctx: OpContext, x, axis=None):
  ax = _axes(ctx, axis)
  return torch.amax(x, dim=() if ax is None else ax, keepdim=_keep_dims(ctx))


@register('SUM')
def sum_op(ctx: OpContext, x, axis=None):
  return torch.sum(x, dim=_axes(ctx, axis),
                   keepdim=bool(ctx.attrs.get('keep_dims', False)))


@register('REDUCE_MIN')
def reduce_min(ctx: OpContext, x, axis=None):
  return torch.amin(x, dim=_axes(ctx, axis),
                    keepdim=bool(ctx.attrs.get('keep_dims', False)))


@register('SELECT')
def select(ctx: OpContext, cond, a, b):
  return torch.where(cond.to(torch.bool), *_promote(a, b))


@register('SELECT_V2')
def select_v2(ctx: OpContext, cond, a, b):
  return torch.where(cond.to(torch.bool), *_promote(a, b))


@register('SELECT_N')
def select_n(ctx: OpContext, which, *cases):
  dt = functools.reduce(torch.promote_types, [c.dtype for c in cases])
  cases = [c.to(dt) for c in cases]
  if len(cases) == 2:
    return torch.where(which.to(torch.bool), cases[1], cases[0])
  idx = which.to(torch.int32)
  out = cases[0]
  for i, c in enumerate(cases[1:], start=1):
    out = torch.where(idx == i, c, out)
  return out


# -- transformer ops --------------------------------------------------------


def rms_inverse(xf: torch.Tensor, eps: float) -> torch.Tensor:
  """1 / sqrt(mean(x^2) + eps) over the last dim of f32 x, [..., 1] f32.

  The sum of squares is taken in f64 (each square is exact there) and
  rounded to f32 once, which makes a difference between orders of the sum
  very unlikely, though not impossible: the CUDA kernels that fuse the
  norm (kernels/csrc/fused_block.cu `norm_quant_kernel`) sum in another
  order and, in every check so far, get the same f32. 1 / sqrt is two IEEE
  roundings, as `sqrtf` and the division are on the card: the square root
  is taken in f64 and rounded once to f32 (the correctly rounded f32 root,
  since 53 >= 2 * 24 + 2), because the CPU's vectorized f32 `torch.sqrt`
  is not correctly rounded on every host (on an AVX-512 one it was an ulp
  off in about a fifth of random values), and `torch.rsqrt` promises
  neither rounding. The JAX op takes an f32 mean and rsqrt; at D 2048 its
  var differs from this one by an ulp in about half the rows, as an f32
  mean in PyTorch does, and a few DRQ codes in a million flip by one
  (tests/test_torch_port_block.py, `test_norm_codes_match_jax_at_gemma_width`).
  """
  d = xf.shape[-1]
  var = (torch.sum(torch.square(xf.to(torch.float64)), dim=-1, keepdim=True)
         / d).to(torch.float32)
  root = torch.sqrt((var + eps).to(torch.float64)).to(torch.float32)
  return torch.reciprocal(root)


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


@register('STABLEHLO_COMPOSITE')
def stablehlo_composite(ctx: OpContext, *xs):
  raise NotImplementedError(
      'Composite ops are executed via their side-effect subgraphs by the '
      'executor, not via a direct impl.')


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
