"""Hadamard-rotation quantization: rotate weights into a flatter
distribution before low-bit quantization (QuaRot-style).

W' = W·H with H a block-diagonal normalized Sylvester-Hadamard matrix
(symmetric + involutory, so the matching activation rotation is the same
H). The rotated weight quantizes with OCTAV; the activation side gets an
inserted rotation op — either the fused kernel (INSERT_HADAMARD_ROTATION,
Pallas at runtime) or a reshape/matmul/reshape expansion
(INSERT_DECOMPOSED_HADAMARD_ROTATION) that runs on any backend.

FULLY_CONNECTED: input activations rotate. EMBEDDING_LOOKUP: the output
rotates back (H·H = I).

Parity: reference `algorithms/uniform_quantize/hadamard_rotation.py`.

A copy of `ai_edge_quantizer_tpu/algorithms/uniform/hadamard.py`: the port
keeps its own so that it never imports the JAX package. No Pallas kernel
runs the rotation in either package: the HADAMARD_ROTATION op is a plain
product (`ops/impl.py`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.uniform import engine
from ai_edge_quantizer_tpu_torch.algorithms.uniform import octav

CUSTOM_OP_ALGORITHM_KEY = 'HADAMARD_ROTATION'
DECOMPOSED_ALGORITHM_KEY = 'DECOMPOSED_HADAMARD_ROTATION'

_DEFAULT_MAX_HADAMARD_SIZE = 512

_QT = qtyping.QuantTransformation

_hadamard_cache: dict = {}


def normalized_hadamard(size: int) -> np.ndarray:
  """Sylvester-construction orthonormal Hadamard matrix (cached)."""
  if size not in _hadamard_cache:
    if size & (size - 1) != 0 or size < 1:
      raise ValueError(f'Hadamard size must be a power of 2, got {size}.')
    h = np.array([[1.0]], dtype=np.float64)
    while h.shape[0] < size:
      h = np.block([[h, h], [h, -h]])
    _hadamard_cache[size] = (h / np.sqrt(size)).astype(np.float32)
  return _hadamard_cache[size]


def pick_hadamard_size(dim: int, max_size: int) -> int:
  """Largest power-of-2 divisor of `dim`, capped at max_size."""
  size = dim & (-dim)  # largest power of 2 dividing dim
  return min(size, max_size)


def rotate_last_dim(data: np.ndarray, hadamard_size: int) -> np.ndarray:
  """Apply the block-diagonal rotation along the last dimension."""
  h = normalized_hadamard(hadamard_size)
  shape = data.shape
  blocks = shape[-1] // hadamard_size
  view = data.reshape(shape[:-1] + (blocks, hadamard_size))
  return (view @ h).reshape(shape).astype(data.dtype)


def _rotated_weight_params(
    op_info: qtyping.OpInfo,
    w_cfg: qtyping.TensorQuantizationConfig,
    data: np.ndarray,
) -> qtyping.UniformQuantParams:
  algo_params = op_info.op_quant_config.algorithm_params or {}
  max_size = int(
      (algo_params.get('hadamard') or {}).get(
          'max_size', _DEFAULT_MAX_HADAMARD_SIZE)
      if isinstance(algo_params.get('hadamard'), dict)
      else algo_params.get('max_hadamard_size', _DEFAULT_MAX_HADAMARD_SIZE))
  hsize = pick_hadamard_size(data.shape[-1], max_size)
  rotated = rotate_last_dim(np.asarray(data, np.float32), hsize)
  params = octav.get_tensor_quant_params(op_info, w_cfg, rotated, None)
  return dataclasses.replace(
      params,
      hadamard=qtyping.HadamardRotationParams(
          random_binary_vector=np.ones(1, np.float32),
          hadamard_size=hsize,
      ),
  )


def _materialize_fc(
    insert_transformation: qtyping.QuantTransformation,
    op_info: qtyping.OpInfo,
    graph_info: qtyping.GraphInfo,
    qsvs: dict,
    cache: Optional[engine.ParamsCache] = None,
) -> list:
  """FULLY_CONNECTED: rotated-quantized weight + input-side rotation."""
  cfg = op_info.op_quant_config
  w_cfg = cfg.weight_tensor_config
  if w_cfg is None:
    raise ValueError('Hadamard rotation requires a weight config.')
  tensors = graph_info.subgraph.tensors
  x_t = tensors[op_info.op.inputs[0]]
  w_t = tensors[op_info.op.inputs[1]]
  w_data = engine.tensor_data_of(graph_info, w_t)
  if w_data is None:
    raise ValueError('Hadamard rotation requires a constant weight.')
  cache = cache if cache is not None else engine.ParamsCache()
  w_params = cache.lookup(w_t.buffer, w_cfg)
  if w_params is None:
    w_params = _rotated_weight_params(op_info, w_cfg, w_data)
    cache.insert(w_t.buffer, w_cfg, w_params)

  results = [
      # Input activation: rotation inserted before this consumer.
      engine.make_tensor_params(
          x_t.name, op_info, is_inbounding_tensor=True,
          quant_params=w_params,  # carries the hadamard spec
          transformations=[insert_transformation],
      ),
      # Weight: quantize in place (rotated data inside params).
      engine.make_tensor_params(
          w_t.name, op_info, is_inbounding_tensor=True,
          quant_params=w_params,
          transformations=[_QT.QUANTIZE_TENSOR],
      ),
  ]
  # Optional bias: untouched (rotation acts on the contraction dim).
  if len(op_info.op.inputs) > 2 and op_info.op.inputs[2] >= 0:
    b_t = tensors[op_info.op.inputs[2]]
    results.append(engine.make_tensor_params(
        b_t.name, op_info, is_inbounding_tensor=True,
        transformations=[_QT.NO_QUANTIZE]))
  for tid in op_info.op.outputs:
    results.append(engine.make_tensor_params(
        tensors[tid].name, op_info, is_inbounding_tensor=False,
        transformations=[_QT.NO_QUANTIZE]))
  return results


def _materialize_embedding(
    insert_transformation: qtyping.QuantTransformation,
    op_info: qtyping.OpInfo,
    graph_info: qtyping.GraphInfo,
    qsvs: dict,
    cache: Optional[engine.ParamsCache] = None,
) -> list:
  """EMBEDDING_LOOKUP: rotated-quantized table + output-side rotation."""
  cfg = op_info.op_quant_config
  w_cfg = cfg.weight_tensor_config
  tensors = graph_info.subgraph.tensors
  ids_t = tensors[op_info.op.inputs[0]]
  w_t = tensors[op_info.op.inputs[1]]
  w_data = engine.tensor_data_of(graph_info, w_t)
  if w_data is None:
    raise ValueError('Hadamard rotation requires a constant table.')
  cache = cache if cache is not None else engine.ParamsCache()
  w_params = cache.lookup(w_t.buffer, w_cfg)
  if w_params is None:
    w_params = _rotated_weight_params(op_info, w_cfg, w_data)
    cache.insert(w_t.buffer, w_cfg, w_params)
  results = [
      engine.make_tensor_params(
          ids_t.name, op_info, True, transformations=[_QT.NO_QUANTIZE]),
      engine.make_tensor_params(
          w_t.name, op_info, True, quant_params=w_params,
          transformations=[_QT.QUANTIZE_TENSOR]),
  ]
  out_t = tensors[op_info.op.outputs[0]]
  # Rotate the looked-up (rotated) rows back: H is involutory.
  results.append(engine.make_tensor_params(
      out_t.name, op_info, False, quant_params=w_params,
      transformations=[insert_transformation]))
  return results


def make_materialize_fns(decomposed: bool) -> dict:
  t = (
      _QT.INSERT_DECOMPOSED_HADAMARD_ROTATION
      if decomposed else _QT.INSERT_HADAMARD_ROTATION
  )
  return {
      qtyping.OpName.FULLY_CONNECTED: functools.partial(_materialize_fc, t),
      qtyping.OpName.EMBEDDING_LOOKUP: functools.partial(
          _materialize_embedding, t),
  }


def check_config(op_name, op_quant_config, policy=None) -> None:
  del policy
  op_name = qtyping.OpName(op_name)
  if op_name not in (qtyping.OpName.FULLY_CONNECTED,
                     qtyping.OpName.EMBEDDING_LOOKUP):
    raise ValueError(f'Hadamard rotation does not support op {op_name}.')
  w = op_quant_config.weight_tensor_config
  if w is None or w.dtype != qtyping.TensorDataType.INT:
    raise ValueError('Hadamard rotation requires an integer weight config.')
  if not w.symmetric:
    raise ValueError('Hadamard rotation requires symmetric weights.')
  if op_quant_config.activation_tensor_config is not None:
    raise ValueError(
        'Hadamard rotation supports weight-only/DRQ modes (no activation '
        'config).')
