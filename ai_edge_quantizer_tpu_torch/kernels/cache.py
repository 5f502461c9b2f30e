"""In-place KV-cache row writes (PyTorch + CUDA).

Port of `ai_edge_quantizer_tpu/kernels/pallas_cache.py`: one-row
DYNAMIC_UPDATE_SLICE into the operand's own storage, the JAX executor's
AEQT_CACHE_WRITE_PALLAS route for the int8 cache writes of a decode step.
The TPU kernel aliases its output to the cache input (the caller donates
the cache); here the wrapper writes into `operand` and returns it, so the
caller's input tensor is the output. CUDA kernel: `csrc/cache_row_write.cu`.

Each wrapper has two cases: a CUDA tensor launches the kernel (or raises),
a CPU tensor runs the `..._plain` function. Each counts its launches and
its plain runs.
"""

from __future__ import annotations

import ctypes

import torch

from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.ops import impl as ops_impl


def _row_tile(dtype: torch.dtype) -> int:
  """The TPU's sublane tile on the row axis for this dtype's item size
  (pallas_cache._row_tile): 32 rows of 1 byte, 16 of 2, 8 otherwise."""
  itemsize = torch.empty((), dtype=dtype).element_size()
  return {1: 32, 2: 16}.get(itemsize, 8)


def supports(operand_shape, update_shape, dtype: torch.dtype) -> bool:
  """The JAX gate (pallas_cache.supports) without its 8 MiB VMEM budget:
  the update spans every dim but dim -2, where it is one row; the row axis
  is a whole number (at least one) of the TPU's row tiles, kept so that
  the port and the JAX executor take the same route; the last dim is a
  multiple of 128. The CUDA kernel itself needs only rows of a multiple of
  16 bytes, which the last rule gives; it moves one row per prefix row,
  so no size bounds it."""
  ndim = len(operand_shape)
  if ndim < 2 or len(update_shape) != ndim:
    return False
  if update_shape[-2] != 1:
    return False
  if any(update_shape[i] != operand_shape[i]
         for i in range(ndim) if i != ndim - 2):
    return False
  tile_rows = _row_tile(dtype)
  if operand_shape[-2] % tile_rows or operand_shape[-2] < tile_rows:
    return False
  return operand_shape[-1] % 128 == 0


def dus_row_inplace_plain(operand, update, starts):
  """lax.dynamic_update_slice (starts clipped) copied into operand's own
  storage; returns operand."""
  operand.copy_(ops_impl.dynamic_update_slice(operand, update, starts))
  return operand


def dus_row_inplace(operand: torch.Tensor, update: torch.Tensor,
                    starts: torch.Tensor) -> torch.Tensor:
  """Write the one row `update` into `operand` in place and return
  `operand` (the same tensor): `lax.dynamic_update_slice(operand, update,
  starts)` for shapes that `supports` takes, every start clipped as lax
  clips it (only starts[-2] can be other than 0). starts: int [ndim] on
  the operand's device; it is read there, so the write needs no host
  sync."""
  name = 'dus_row_inplace'
  _build.require(supports(tuple(operand.shape), tuple(update.shape),
                          operand.dtype), name,
                 f'unsupported row write {tuple(operand.shape)} <- '
                 f'{tuple(update.shape)} ({operand.dtype})')
  if _build.device_kind(operand) == 'cpu':
    dus_row_inplace.plain_calls += 1
    return dus_row_inplace_plain(operand, update, starts)
  update = update.to(operand.dtype).contiguous()
  st = starts.to(torch.int32).reshape(-1).contiguous()
  _build.require_cuda_tensor(operand, name, 'operand', (operand.dtype,), 16)
  _build.require_cuda_tensor(update, name, 'update', (operand.dtype,), 16)
  _build.require_cuda_tensor(st, name, 'starts', (torch.int32,))
  _build.require(st.numel() == operand.dim(), name,
                 f'starts must have {operand.dim()} entries')
  s = operand.shape[-2]
  row_bytes = operand.shape[-1] * operand.element_size()
  prefix = operand.numel() // (s * operand.shape[-1])
  fn = _build.entry('cache_row_write', 'aeqt_cache_row_write',
                    [_build.P, _build.P, _build.P, _build.I,
                     ctypes.c_longlong, _build.I, _build.I, _build.P])
  status = fn(operand.data_ptr(), update.data_ptr(), st.data_ptr(),
              operand.dim(), prefix, s, row_bytes,
              _build.stream_ptr(operand.device))
  _build.check(status, name, f'{tuple(operand.shape)}')
  dus_row_inplace.launches += 1
  return operand


dus_row_inplace.launches = 0
dus_row_inplace.plain_calls = 0

# aeqt_cache_row_write_plan's fields: the row write's grid and block.
PLAN_FIELDS = ('blocks', 'threads')


def plan(prefix: int, row_bytes: int) -> dict:
  """The launch `dus_row_inplace` makes for `prefix` rows of `row_bytes`."""
  return _build.plan('cache_row_write', 'aeqt_cache_row_write_plan',
                     'dus_row_inplace', prefix, row_bytes,
                     fields=PLAN_FIELDS)


def launch_floor(operand: torch.Tensor) -> None:
  """An empty kernel launched as `dus_row_inplace` launches its kernel for
  `operand` (same grid, block and programmatic dependent launch): the
  launch floor a study times beside it. Counts nothing."""
  s = operand.shape[-2]
  prefix = operand.numel() // (s * operand.shape[-1])
  fn = _build.entry('cache_row_write', 'aeqt_cache_row_write_floor',
                    [ctypes.c_longlong, _build.I, _build.P])
  _build.check(fn(prefix, operand.shape[-1] * operand.element_size(),
                  _build.stream_ptr(operand.device)),
               'dus_row_inplace floor', f'{tuple(operand.shape)}')
