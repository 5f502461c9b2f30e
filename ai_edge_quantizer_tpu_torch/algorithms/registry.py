"""Algorithm registry: algorithm key -> op -> pipeline functions.

Each quantization algorithm registers, per supported op, up to four
functions:

  * init_qsv(op_info, graph_info, inputs_to_ignore, outputs_to_ignore)
      -> initial quantization statistic values (weight min/max etc.);
  * calibrate(op_output_samples, op_info, graph_info, qsvs) -> updated QSVs;
  * materialize(op_info, graph_info, qsvs) -> [TensorTransformationParams];
  * update_qsv(old_qsv, new_qsv) -> merged QSV (EMA, running min/max, ...).

plus an algorithm-level config-check function and config-check policy used by
the recipe layer to validate (op, config) pairs at recipe-build time.

Capability parity: reference `algorithm_manager_api.py` registry +
`algorithm_manager.py` registration. Registration of concrete algorithms
lives in `algorithms/manager.py`.

A copy of `ai_edge_quantizer_tpu/algorithms/registry.py`: the port keeps its
own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

from ai_edge_quantizer_tpu_torch import qtyping


class AlgorithmName(str, enum.Enum):
  """Registered algorithm keys (shared vocabulary with reference recipes)."""

  NO_QUANTIZE = 'no_quantize'
  MIN_MAX_UNIFORM_QUANT = 'min_max_uniform_quantize'
  FLOAT_CASTING = 'float_casting'
  DEQUANTIZED_WEIGHT_RECOVERY = 'dequantized_weight_recovery'
  OCTAV = 'OCTAV'
  HADAMARD_ROTATION = 'HADAMARD_ROTATION'
  DECOMPOSED_HADAMARD_ROTATION = 'DECOMPOSED_HADAMARD_ROTATION'
  MSE = 'MSE'
  GPTQ = 'GPTQ'


@dataclasses.dataclass
class QuantizedOperationInfo:
  """The function bundle registered for one (algorithm, op) pair."""

  algorithm_key: str
  op_name: qtyping.OpName
  init_qsv_fn: Optional[Callable[..., Any]] = None
  calibration_fn: Optional[Callable[..., Any]] = None
  materialize_fn: Optional[Callable[..., Any]] = None
  update_qsv_fn: Optional[Callable[..., Any]] = None


# op -> list of exactly-allowed OpQuantizationConfig (after normalization).
ConfigCheckPolicyDict = dict


class AlgorithmRegistry:
  """Holds every registered algorithm; dispatched by the pipeline passes."""

  def __init__(self):
    self._ops: dict = {}            # key -> {op_name -> QuantizedOperationInfo}
    self._config_checks: dict = {}  # key -> check fn(op, config, policy)
    self._policies: dict = {}       # key -> ConfigCheckPolicyDict

  # -- registration ---------------------------------------------------------

  def register_op(
      self,
      algorithm_key: str,
      op_name: qtyping.OpName,
      *,
      init_qsv_fn=None,
      calibration_fn=None,
      materialize_fn=None,
      update_qsv_fn=None,
  ) -> None:
    self._ops.setdefault(algorithm_key, {})[op_name] = QuantizedOperationInfo(
        algorithm_key=algorithm_key,
        op_name=op_name,
        init_qsv_fn=init_qsv_fn,
        calibration_fn=calibration_fn,
        materialize_fn=materialize_fn,
        update_qsv_fn=update_qsv_fn,
    )

  def register_config_check(self, algorithm_key: str, check_fn) -> None:
    self._config_checks[algorithm_key] = check_fn

  def register_config_check_policy(
      self, algorithm_key: str, policy: ConfigCheckPolicyDict
  ) -> None:
    self._policies[algorithm_key] = policy

  # -- queries --------------------------------------------------------------

  def is_algorithm_registered(self, algorithm_key: str) -> bool:
    return algorithm_key in self._ops or algorithm_key == \
        AlgorithmName.NO_QUANTIZE

  def is_op_registered(self, algorithm_key: str,
                       op_name: qtyping.OpName) -> bool:
    return op_name in self._ops.get(algorithm_key, {})

  def get_supported_ops(self, algorithm_key: str) -> list:
    return list(self._ops.get(algorithm_key, {}).keys())

  def get_config_check_policy(
      self, algorithm_key: str
  ) -> Optional[ConfigCheckPolicyDict]:
    return self._policies.get(algorithm_key)

  def update_config_check_policy(
      self, algorithm_key: str, policy: ConfigCheckPolicyDict
  ) -> None:
    """Replace the policy (user override via Quantizer.load_config_policy)."""
    self._policies[algorithm_key] = policy

  def _op_info(self, algorithm_key, op_name) -> QuantizedOperationInfo:
    ops = self._ops.get(algorithm_key)
    if ops is None:
      raise ValueError(f'Unregistered algorithm: {algorithm_key!r}.')
    info = ops.get(op_name)
    if info is None:
      raise ValueError(
          f'Op {op_name} is not supported by algorithm {algorithm_key!r}. '
          f'Supported ops: {sorted(str(o) for o in ops)}.'
      )
    return info

  def get_quantization_func(
      self,
      algorithm_key: str,
      op_name: qtyping.OpName,
      mode: qtyping.QuantizeMode,
  ):
    info = self._op_info(algorithm_key, op_name)
    fn = (
        info.calibration_fn
        if mode == qtyping.QuantizeMode.CALIBRATE
        else info.materialize_fn
    )
    if fn is None:
      raise ValueError(
          f'Algorithm {algorithm_key!r} has no {mode} function for {op_name}.'
      )
    return fn

  def get_init_qsv_fn(self, algorithm_key: str, op_name: qtyping.OpName):
    return self._op_info(algorithm_key, op_name).init_qsv_fn

  def get_update_qsv_fn(self, algorithm_key: str, op_name: qtyping.OpName):
    return self._op_info(algorithm_key, op_name).update_qsv_fn

  # -- config validation ----------------------------------------------------

  def check_op_quantization_config(
      self,
      algorithm_key: str,
      op_name: qtyping.OpName,
      op_quant_config: qtyping.OpQuantizationConfig,
  ) -> None:
    """Raises ValueError when (op, config) is illegal under `algorithm_key`."""
    if op_quant_config.skip_checks:
      return
    if algorithm_key == AlgorithmName.NO_QUANTIZE:
      return
    check_fn = self._config_checks.get(algorithm_key)
    if check_fn is None:
      raise ValueError(
          f'No config check registered for algorithm {algorithm_key!r}.'
      )
    check_fn(op_name, op_quant_config, self._policies.get(algorithm_key))


def normalized_for_policy(
    config: qtyping.OpQuantizationConfig,
) -> qtyping.OpQuantizationConfig:
  """Strip fields with unbounded domains before policy membership testing.

  min_weight_elements (any non-negative int) and algorithm_params (free-form)
  cannot be enumerated by a policy; skip_checks is an escape hatch, not a
  config property.
  """
  return dataclasses.replace(
      config,
      min_weight_elements=0,
      skip_checks=False,
      _algorithm_params_items=None,
  )


def policy_membership_check(
    op_name: qtyping.OpName,
    op_quant_config: qtyping.OpQuantizationConfig,
    policy: Optional[ConfigCheckPolicyDict],
) -> None:
  """The standard policy check: exact membership after normalization."""
  if policy is None:
    raise ValueError(
        f'Unsupported op {op_name} (no config-check policy specified).'
    )
  op_name = qtyping.OpName(op_name)
  if op_name not in policy:
    raise ValueError(
        f'Unsupported op for '
        f'{op_quant_config.compute_precision}: {op_name}. No policy entry.'
    )
  if normalized_for_policy(op_quant_config) not in policy[op_name]:
    raise ValueError(
        f'Quantization config for op: {op_name} with config:'
        f' {op_quant_config!r} was not found in the policy.'
    )


# The process-wide registry instance. `algorithms.manager` populates it at
# import time.
REGISTRY = AlgorithmRegistry()
