"""ctypes binding for the native (C++) sub-byte packing kernels.

Port of `ai_edge_quantizer_tpu/utils/native_packing.py`: the same C entry
points (`native/src/packing.cc`) and the same bytes as
`quant_numerics.pack_subbyte` / `unpack_subbyte`. The library is built at
first use, never at import, with the host's C++ compiler (`CXX`, else
`g++`) into the port's git-ignored build directory (`kernels/_build/`,
beside the CUDA kernels) and without `-march=native`, so that it runs on
whatever host builds it; the committed `native/libaeqt_native.so` is never
loaded. `load()` raises ImportError where the library cannot be built, and
`graph/serialize.py` then packs with numpy; `packer()` names the packer
that ran, and the first choice is logged.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import pathlib
import shutil
import subprocess

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / 'native' / 'src' / 'packing.cc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / 'kernels' / '_build'
LIB_PATH = BUILD_DIR / 'libaeqt_packing.so'
CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-Wall', '-shared')

_log = logging.getLogger(__name__)

_i8p = np.ctypeslib.ndpointer(np.int8, flags='C_CONTIGUOUS')
_u8p = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
_ENTRIES = (
    ('aeqt_pack_int4', [_i8p, _u8p, ctypes.c_int64]),
    ('aeqt_unpack_int4', [_u8p, _i8p, ctypes.c_int64]),
    ('aeqt_pack_int2', [_i8p, _u8p, ctypes.c_int64]),
    ('aeqt_unpack_int2', [_u8p, _i8p, ctypes.c_int64]),
)


def _build() -> None:
  if not SOURCE.exists():
    raise ImportError(f'native sources not found ({SOURCE})')
  cxx = os.environ.get('CXX') or shutil.which('g++') or shutil.which('c++')
  if not cxx:
    raise ImportError('no C++ compiler to build the native packer')
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = BUILD_DIR / f'libaeqt_packing.{os.getpid()}.tmp.so'
  try:
    subprocess.run([cxx, *CXX_FLAGS, '-o', str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=120)
  except Exception as e:
    raise ImportError(f'failed to build the native packer: {e}') from e
  os.replace(tmp, LIB_PATH)


@functools.cache
def load() -> ctypes.CDLL:
  """The packing library, built first if it is missing or older than its
  source; ImportError where it cannot be built or loaded."""
  if (not LIB_PATH.exists()
      or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime):
    _build()
  try:
    lib = ctypes.CDLL(str(LIB_PATH))
  except OSError as e:
    raise ImportError(f'cannot load the native packer: {e}') from e
  for name, argtypes in _ENTRIES:
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = None
  return lib


@functools.cache
def packer() -> str:
  """'native' where the C++ library builds and loads, else 'numpy'; the
  choice is logged once."""
  try:
    load()
  except ImportError as e:
    _log.warning('sub-byte packing: numpy (%s)', e)
    return 'numpy'
  _log.info('sub-byte packing: native (%s)', LIB_PATH)
  return 'native'


def pack_subbyte(data: np.ndarray, num_bits: int) -> np.ndarray:
  """int4/int2 (int8 container) -> dense uint8, layout-compatible with
  quant_numerics.pack_subbyte."""
  lib = load()
  flat = np.ascontiguousarray(data, dtype=np.int8).reshape(-1)
  per_byte = 8 // num_bits
  out = np.zeros((flat.size + per_byte - 1) // per_byte, np.uint8)
  if num_bits == 4:
    lib.aeqt_pack_int4(flat, out, flat.size)
  elif num_bits == 2:
    lib.aeqt_pack_int2(flat, out, flat.size)
  else:
    raise ValueError(f'Unsupported sub-byte width: {num_bits}')
  return out


def unpack_subbyte(packed: np.ndarray, num_bits: int,
                   num_elements: int) -> np.ndarray:
  lib = load()
  packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
  out = np.empty(num_elements, np.int8)
  if num_bits == 4:
    lib.aeqt_unpack_int4(packed, out, num_elements)
  elif num_bits == 2:
    lib.aeqt_unpack_int2(packed, out, num_elements)
  else:
    raise ValueError(f'Unsupported sub-byte width: {num_bits}')
  return out
