"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` compiles, at first use, into its own shared library
under `kernels/_build/` (git-ignored), with a plain C interface: every
entry point takes raw device pointers, sizes and the CUDA stream, and
returns `cudaGetLastError()` so the Python wrapper can raise on a refused
launch. No PyTorch headers are included, so a build takes seconds; all
sources build in parallel, one nvcc each.

Flags: `-gencode arch=compute_90a,code=sm_90a -O3`, and `--fmad=false`
so that `a * b + c` is never contracted into one FMA: the kernels then
round every product and sum as the plain PyTorch versions do. The build
never uses `--use_fast_math`: bit-exact DRQ needs IEEE `1.0f / xs` and
round-half-even `__float2int_rn`.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parent / '_build'
SOURCES = ('qmatmul_int4_drq', 'attention_stale', 'mlp_int4_drq',
           'head_argmax', 'attention_lengths', 'flash_attention_int8',
           'fused_block', 'attention_int4_group', 'qmatmul_int8_drq',
           'qmatmul_int_weights', 'qmatmul_int4_drq_kblock',
           'qmatmul_int4_weight_only', 'mlp_int4_bf16', 'attention_masked',
           'qmatmul_int4_blockwise', 'cache_row_write', 'attention_writeback',
           'attention_dynlen', 'qmatmul_int4_rmsnorm', 'qkv_rope',
           'attention_oproj', 'attention_int8_basic', 'attention_int4_row')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')
# Largest dynamic shared memory a block may ask for on Hopper (bytes).
MAX_SMEM = 232448

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def nvcc_path() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  default = '/usr/local/cuda/bin/nvcc'
  if os.path.exists(default):
    return default
  raise RuntimeError('nvcc not found: the CUDA kernels cannot be built.')


def _lib_path(name: str) -> pathlib.Path:
  return BUILD_DIR / f'lib{name}.so'


def _stale(name: str) -> bool:
  lib = _lib_path(name)
  if not lib.exists():
    return True
  newest_src = max(p.stat().st_mtime for p in CSRC.iterdir())
  return lib.stat().st_mtime < newest_src


def build(names=SOURCES) -> float:
  """Compiles the stale sources among `names`, one nvcc each, all started
  together. Returns the wall seconds; raises with nvcc's log on failure.
  ptxas' register and shared-memory report lands in `_build/<name>.log`."""
  todo = [n for n in names if _stale(n)]
  t0 = time.monotonic()
  if not todo:
    return 0.0
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = nvcc_path()
  procs = {}
  for name in todo:
    tmp = BUILD_DIR / f'lib{name}.{os.getpid()}.tmp.so'
    with open(BUILD_DIR / f'{name}.log', 'w') as log:
      procs[name] = (subprocess.Popen(
          [nvcc, *NVCC_FLAGS, '-I', str(CSRC), '-o', str(tmp),
           str(CSRC / f'{name}.cu')],
          stdout=log, stderr=subprocess.STDOUT), tmp)
  failed = []
  for name, (proc, tmp) in procs.items():
    if proc.wait() != 0:
      failed.append(name)
    else:
      os.replace(tmp, _lib_path(name))
  if failed:
    logs = '\n'.join((BUILD_DIR / f'{n}.log').read_text() for n in failed)
    raise RuntimeError(f'nvcc failed for {failed}:\n{logs}')
  return time.monotonic() - t0


@functools.cache
def library(name: str) -> ctypes.CDLL:
  """The loaded kernel library `name`, built first if it is missing."""
  build(SOURCES)  # all stale sources in parallel on the first call
  return ctypes.CDLL(str(_lib_path(name)))


def entry(lib: str, fn: str, argtypes, restype=ctypes.c_int):
  """A C entry point with its argument and result types declared."""
  f = getattr(library(lib), fn)
  f.argtypes = argtypes
  f.restype = restype
  return f


# A C entry point's status for a shape its kernel does not take
# (`aeqt::kShapeRefused` in csrc/drq_common.cuh); it launched nothing.
SHAPE_REFUSED = -1


def check(status: int, kernel: str, shape: str = '') -> None:
  """Raise if a C entry point refused the shape (ValueError; the limits
  stand beside the entry point in its source) or reported a CUDA error."""
  if status == SHAPE_REFUSED:
    raise ValueError(f'{kernel}: the CUDA kernel does not take {shape} '
                     f'(see csrc/ for its limits)')
  if status != 0:
    raise RuntimeError(f'{kernel}: CUDA error {status} at launch')


PLAN_FIELDS = ('grid_x', 'grid_y', 'split', 'threads', 'smem_bytes',
               'stages')


def plan(lib: str, fn: str, kernel: str, *dims: int,
         fields=PLAN_FIELDS) -> dict:
  """The launch a tensor-core kernel's C plan function gives a shape: for
  the matmuls (csrc/int8_tc_gemm.cuh `plan_fields`, dims M, N, K) grid,
  split-K factor (blocks of a cluster), threads, shared memory and ring
  stages; another kernel names its own `fields`. Raises ValueError for a
  shape the kernel does not take, before anything is allocated."""
  out = (ctypes.c_longlong * len(fields))()
  f = entry(lib, fn, [I] * len(dims) + [P])
  check(f(*dims, out), kernel, ' '.join(str(d) for d in dims))
  return dict(zip(fields, out))


def stream_ptr(device) -> int:
  import torch
  return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, kernel: str, what: str) -> None:
  """Raise ValueError for an argument the CUDA kernel does not take."""
  if not cond:
    raise ValueError(f'{kernel}: {what}')


def require_cuda_tensor(t, kernel: str, name: str, dtypes,
                        align: int = 1) -> None:
  require(t.is_cuda, kernel, f'{name} must be a CUDA tensor')
  require(t.dtype in dtypes, kernel, f'{name} dtype {t.dtype} not in {dtypes}')
  require(t.is_contiguous(), kernel, f'{name} must be contiguous')
  require(t.data_ptr() % align == 0, kernel,
          f'{name} must be {align}-byte aligned')


def device_kind(t) -> str:
  """'cuda' or 'cpu'; any other device is refused."""
  kind = t.device.type
  if kind not in ('cuda', 'cpu'):
    raise ValueError(f'tensors on {t.device} are not supported')
  return kind
