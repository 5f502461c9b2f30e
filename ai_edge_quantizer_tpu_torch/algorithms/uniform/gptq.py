"""GPTQ: Hessian-weighted optimal brain surgeon weight quantization
(arXiv:2210.17323).

Calibration accumulates the input-activation Hessian 2/n * XᵀX per FC
input; materialization quantizes weight columns one at a time, propagating
the quantization error through the inverse-Hessian (lazy block updates,
block size 64). FULLY_CONNECTED only; Hessians merge across calibration
batches sample-weighted (utils/qsv_utils.gptq_and_moving_average_update).

Parity: reference `algorithms/uniform_quantize/gptq.py`.

A copy of `ai_edge_quantizer_tpu/algorithms/uniform/gptq.py` (numpy, and
the same scipy LAPACK inverse on the host, so the weights are the JAX
package's bit for bit given the same Hessian), but for the Newton-Schulz
solve that large Hessians take (`_device_solve_threshold`): it runs in
torch on `SOLVE_DEVICE` (the card; 'cpu' to solve on the host), its
float32 matmuls in full float32, never TF32, as the JAX solve runs at
Precision.HIGHEST.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import scipy.linalg
import torch

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.uniform import engine
from ai_edge_quantizer_tpu_torch.algorithms.uniform import min_max
from ai_edge_quantizer_tpu_torch.algorithms.uniform import quant_numerics as qn

ALGORITHM_KEY = 'GPTQ'

_DAMP_FACTOR = 0.01
# The torch device of the Newton-Schulz solve (the JAX package solves on
# its default backend).
SOLVE_DEVICE = 'cuda'
_OBS_BLOCK = 64
_CALIBRATION_VALID_RANGE = (-3e38, 3e38)


def calibrate(
    op,
    graph_info: qtyping.GraphInfo,
    tensor_content_map: Mapping[str, np.ndarray],
    inputs_to_ignore=None,
    outputs_to_ignore=None,
) -> dict:
  """Min/max + input Hessian 2/n * XᵀX for the op's activations."""
  op_qsvs: dict = {}
  lo, hi = _CALIBRATION_VALID_RANGE
  tensors = graph_info.subgraph.tensors

  def collect(tid: int) -> None:
    t = tensors[tid]
    if engine.tensor_data_of(graph_info, t) is not None:
      return
    content = np.asarray(tensor_content_map[t.name], np.float32)
    x = content.reshape(-1, content.shape[-1])
    num_samples = content.shape[0]
    qsv_shape = (1,) * content.ndim
    mask = (content > lo) & (content < hi)
    vals = content[mask] if np.any(mask) else content
    op_qsvs[t.name] = {
        'min': np.min(vals).reshape(qsv_shape),
        'max': np.max(vals).reshape(qsv_shape),
        'hessian': (2.0 / num_samples) * (x.T @ x),
        'num_samples': num_samples,
    }

  inputs_to_ignore = set(inputs_to_ignore or [])
  for pos, tid in enumerate(op.inputs):
    if tid >= 0 and engine.is_quantized_tensor(tensors[tid]):
      inputs_to_ignore.add(pos)
  outputs_to_ignore = set(outputs_to_ignore or [])
  for pos, tid in enumerate(op.inputs):
    if tid >= 0 and pos not in inputs_to_ignore:
      collect(tid)
  for pos, tid in enumerate(op.outputs):
    if tid >= 0 and pos not in outputs_to_ignore:
      collect(tid)
  return op_qsvs


# Hessians at or above this dimension solve ON DEVICE (Newton-Schulz in
# f32) instead of host f64 LAPACK: Gemma-7B-class FFN dims (>16k) hit the
# host-numpy memory/time ceiling. Override via AEQT_GPTQ_DEVICE_SOLVE_DIM,
# the JAX package's variable.
def _device_solve_threshold() -> int:
  import os
  return int(os.environ.get('AEQT_GPTQ_DEVICE_SOLVE_DIM', '8192'))


def _inverse_via_cholesky_host(hessian: np.ndarray,
                               damp_factor: float) -> np.ndarray:
  """H⁻¹ in f64 on host: Cholesky + LAPACK triangular inversion."""
  h = np.array(hessian, dtype=np.float64)
  diag = np.diag(h).copy()
  diag = np.where(diag != 0, diag, 1.0)
  np.fill_diagonal(h, diag + damp_factor * np.mean(diag))
  l = np.linalg.cholesky(h)
  l_inv, err = scipy.linalg.lapack.dtrtri(l, lower=True)
  if err != 0:
    raise RuntimeError(f'Triangular inversion failed (info={err}).')
  return (l_inv.T @ l_inv).astype(np.float32)


def _inverse_via_cholesky_device(hessian: np.ndarray,
                                 damp_factor: float,
                                 device=None) -> np.ndarray:
  """H⁻¹ on device via Newton–Schulz: matmuls only, no factorization.

  For SPD H (which a damped 2/n·XᵀX Hessian is), X₀ = I/‖H‖∞ gives
  spectral radius ρ(I − X₀H) < 1, and X ← 2X − X(HX) then squares the
  residual per step — ~log₂(cond) + 6 iterations to f32 convergence,
  each just two d×d matmuls, in about four d×d f32 buffers. The damping
  floor (damp_factor · mean diag) bounds the condition number so the
  iteration count stays small. device: SOLVE_DEVICE if None.
  """
  x, err, it = _newton_schulz_inverse(
      torch.as_tensor(np.asarray(hessian), device=(
          SOLVE_DEVICE if device is None else device)), float(damp_factor))
  x = x.cpu().numpy()
  if not np.isfinite(x).all():
    raise RuntimeError(
        f'device Hessian inverse diverged (residual {err:.2e} after '
        f'{it} Newton-Schulz steps).')
  return x


def _newton_schulz_inverse(h: torch.Tensor, damp_factor: float) -> tuple:
  """(X, residual, steps): the JAX solver's iteration, step for step (its
  loop test runs on the host here, one read of the residual a step)."""
  from ai_edge_quantizer_tpu_torch.execution import executor

  with executor.full_f32_matmul():
    h = h.to(torch.float32)
    diag = torch.diagonal(h)
    diag = torch.where(diag != 0, diag, torch.ones_like(diag))
    damped = diag + damp_factor * torch.mean(diag)
    h = h.clone()
    h.diagonal().copy_(damped)
    h = 0.5 * (h + h.T)
    # Jacobi preconditioning: iterate on Hn = D^-1/2 H D^-1/2 (unit
    # diagonal). Calibration Hessians have wildly varying diagonals
    # (2/n sum x_i^2 per input channel); normalizing slashes the
    # condition number NS has to fight in f32. X = D^-1/2 Xn D^-1/2.
    dsqrt_inv = torch.rsqrt(damped)
    h = h * dsqrt_inv[:, None] * dsqrt_inv[None, :]
    inf_norm = torch.amax(torch.sum(torch.abs(h), dim=1))
    d = h.shape[0]
    x = torch.diag(torch.full((d,), 1.0, dtype=torch.float32,
                              device=h.device) / inf_norm)
    err, prev_err, it = 1.0, 2.0, 0
    while True:
      converged = err <= 1e-5
      # Plateau: once err is already small, an iteration that fails to
      # halve it means the f32 floor — more steps only burn matmuls. The
      # small-err gate matters: early iterations of a large-d solve shrink
      # err slowly (err ~ rho^(2^k) with rho = 1 - lambda_min/||H||inf,
      # and ||H||inf grows ~sqrt(d) after Jacobi normalization), so a
      # bare progress test would fire long before the squaring regime.
      plateaued = err < 1e-3 and err > 0.5 * prev_err
      if not (it < 120 and not (converged or plateaued)):
        break
      hx = h @ x
      # max|HX - I| without materializing an identity: off-diagonal max
      # vs diagonal deviation.
      derr = torch.amax(torch.abs(torch.diagonal(hx) - 1.0))
      off = hx.clone()
      off.diagonal().zero_()
      oerr = torch.amax(torch.abs(off))
      x = 2.0 * x - x @ hx
      prev_err, err = err, float(torch.maximum(derr, oerr))
      it += 1
    x = x * dsqrt_inv[:, None] * dsqrt_inv[None, :]
    return 0.5 * (x + x.T), err, it


def _inverse_via_cholesky(hessian: np.ndarray,
                          damp_factor: float = _DAMP_FACTOR) -> np.ndarray:
  """H⁻¹ with diagonal damping (host f64 LAPACK below the device
  threshold; the Newton-Schulz solve on SOLVE_DEVICE at Gemma-7B-scale
  dims)."""
  if hessian.shape[0] >= _device_solve_threshold():
    return _inverse_via_cholesky_device(hessian, damp_factor)
  return _inverse_via_cholesky_host(hessian, damp_factor)


def apply_gptq(
    weights: np.ndarray,
    quant_params: qtyping.UniformQuantParams,
    hessian: np.ndarray,
    block_size: int = _OBS_BLOCK,
) -> qtyping.UniformQuantParams:
  """Column-by-column OBS quantization with lazy error propagation.

  weights: [out, in]; hessian over the `in` dimension.
  """
  w = weights.astype(np.float32).copy()
  h_inv = _inverse_via_cholesky(hessian)
  n_cols = h_inv.shape[0]
  storage = qn.storage_dtype(quant_params.num_bits)
  q_out = np.zeros_like(w, dtype=storage)
  is_blockwise = quant_params.block_size > 0

  def column_params(col_idx: int) -> qtyping.UniformQuantParams:
    if not is_blockwise:
      return quant_params
    b = col_idx // quant_params.block_size
    return dataclasses.replace(
        quant_params,
        scale=np.asarray(quant_params.scale)[:, b],
        zero_point=np.asarray(quant_params.zero_point)[:, b],
        quantized_dimension=0,
        block_size=0,
    )

  for start in range(0, n_cols, block_size):
    end = min(start + block_size, n_cols)
    wb = w[:, start:end]
    err = np.zeros_like(wb)
    for i in range(end - start):
      col = start + i
      p = column_params(col)
      q = qn.quantize_array(wb[:, i:i + 1], p)
      dq = qn.dequantize_array(q, p).reshape(-1)
      q_out[:, col] = q.reshape(-1)
      err[:, i] = (wb[:, i] - dq) / h_inv[col, col]
      if i < end - start - 1:
        wb[:, i + 1:] -= np.outer(err[:, i], h_inv[col, col + 1:end])
    w[:, end:] -= err @ h_inv[start:end, end:]
  return dataclasses.replace(quant_params, quantized_data=q_out)


def get_tensor_quant_params(
    op_info: qtyping.OpInfo,
    tensor_quant_config: qtyping.TensorQuantizationConfig,
    tensor_content: Optional[np.ndarray] = None,
    tensor_qsv: Optional[dict[str, Any]] = None,
) -> qtyping.UniformQuantParams:
  act_qsv = tensor_qsv.get('activation_tensor_qsv') if tensor_qsv else None
  # Scale choice is orthogonal to GPTQ's Hessian-aware rounding, and the
  # weight-quality study (WEIGHT_QUALITY_r04.json) showed it dominates end
  # NLL: algorithm_params {"gptq": {"scale_algorithm": "octav"}} computes
  # the grid with OCTAV's optimal clipping before the OBS column sweep.
  # Default stays min-max (reference gptq.py parity).
  ap = op_info.op_quant_config.algorithm_params or {}
  scale_alg = (ap.get('gptq') or {}).get('scale_algorithm', 'min_max')
  if scale_alg == 'octav' and tensor_content is not None:
    from ai_edge_quantizer_tpu_torch.algorithms.uniform import octav
    base = octav.get_tensor_quant_params(
        op_info, tensor_quant_config, tensor_content, tensor_qsv)
  else:
    base = min_max.get_tensor_quant_params(
        op_info, tensor_quant_config, tensor_content, tensor_qsv)
  if tensor_content is None:
    return base
  if act_qsv is None or 'hessian' not in act_qsv:
    return base  # no Hessian collected (e.g. activation not calibrated)
  base = dataclasses.replace(base, quantized_data=None)
  return apply_gptq(tensor_content, base, act_qsv['hessian'])
