"""Registration of all quantization algorithms into the process registry.

Importing this module populates `algorithms.registry.REGISTRY` with every
algorithm x op binding, config-check functions and policies; module-level
functions re-export the registry API for the recipe/pipeline layers.

Parity: reference `algorithm_manager.py` (import-time registration of the 8
algorithm keys over their op sets).

A copy of `ai_edge_quantizer_tpu/algorithms/manager.py`: every algorithm is
registered. UNPORTED_ALGORITHMS (now empty) names an algorithm whose
module the port lacks: a recipe entry that names one raises
NotImplementedError naming the module, at the config check or at
materialization, and is never quantized with another algorithm.
"""

from __future__ import annotations

import functools

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms import registry as _registry
from ai_edge_quantizer_tpu_torch.algorithms.uniform import engine
from ai_edge_quantizer_tpu_torch.algorithms.uniform import min_max
from ai_edge_quantizer_tpu_torch.algorithms.uniform import op_library
from ai_edge_quantizer_tpu_torch.recipe import default_policy
from ai_edge_quantizer_tpu_torch.utils import qsv_utils

AlgorithmName = _registry.AlgorithmName
REGISTRY = _registry.REGISTRY

_Op = qtyping.OpName


def _min_max_family_config_check(op_name, op_quant_config, policy) -> None:
  """Shared config check for integer-weight algorithms (min-max family)."""
  if op_quant_config.weight_tensor_config is None:
    raise ValueError(
        'Weight tensor quantization is required for uniform quantization.')
  if op_quant_config.weight_tensor_config.dtype != qtyping.TensorDataType.INT:
    raise ValueError(
        'Weights must have integer type for uniform quantization. For fp16 '
        "weights use the 'float_casting' algorithm.")
  w_cfg = op_quant_config.weight_tensor_config
  if qtyping.is_blockwise_granularity(w_cfg.granularity):
    if qtyping.OpName(op_name) not in engine.BLOCKWISE_CAPABLE_OPS:
      raise ValueError(
          f'Blockwise quantization is not supported for op {op_name}.')
    if not w_cfg.symmetric:
      raise ValueError('Blockwise quantization must be symmetric.')
  _registry.policy_membership_check(op_name, op_quant_config, policy)


def _register_min_max_style_algorithm(
    algorithm_key: str,
    get_tensor_quant_params_fn,
    op_names=None,
) -> None:
  """Register an algorithm that reuses the standard materialize engine."""
  ops = op_names if op_names is not None else list(op_library.OP_SPECS)
  for op_name in ops:
    spec = op_library.OP_SPECS[op_name]
    REGISTRY.register_op(
        algorithm_key,
        op_name,
        init_qsv_fn=functools.partial(
            min_max.init_qsvs,
            inputs_to_ignore=list(spec.inputs_to_ignore),
            outputs_to_ignore=list(spec.outputs_to_ignore),
        ),
        calibration_fn=functools.partial(
            min_max.min_max_calibrate,
            inputs_to_ignore=list(spec.inputs_to_ignore),
            outputs_to_ignore=list(spec.outputs_to_ignore),
        ),
        materialize_fn=functools.partial(
            op_library.materialize_with_spec, spec, get_tensor_quant_params_fn
        ),
        update_qsv_fn=qsv_utils.moving_average_update,
    )


# --- MIN_MAX_UNIFORM_QUANT (default) ---------------------------------------
_register_min_max_style_algorithm(
    AlgorithmName.MIN_MAX_UNIFORM_QUANT, min_max.get_tensor_quant_params
)
REGISTRY.register_config_check(
    AlgorithmName.MIN_MAX_UNIFORM_QUANT, _min_max_family_config_check
)
REGISTRY.register_config_check_policy(
    AlgorithmName.MIN_MAX_UNIFORM_QUANT,
    default_policy.DEFAULT_CONFIG_CHECK_POLICY,
)

# --- OCTAV: same op coverage + policy as min-max ---------------------------
from ai_edge_quantizer_tpu_torch.algorithms.uniform import octav  # noqa: E402

_register_min_max_style_algorithm(
    AlgorithmName.OCTAV, octav.get_tensor_quant_params
)
REGISTRY.register_config_check(
    AlgorithmName.OCTAV, _min_max_family_config_check
)
REGISTRY.register_config_check_policy(
    AlgorithmName.OCTAV, default_policy.DEFAULT_CONFIG_CHECK_POLICY
)

# --- MSE: weight ops only, symmetric, no blockwise -------------------------
from ai_edge_quantizer_tpu_torch.algorithms.uniform import mse  # noqa: E402

_MSE_OPS = [
    qtyping.OpName.FULLY_CONNECTED, qtyping.OpName.CONV_2D,
    qtyping.OpName.DEPTHWISE_CONV_2D, qtyping.OpName.CONV_2D_TRANSPOSE,
    qtyping.OpName.EMBEDDING_LOOKUP,
]
_register_min_max_style_algorithm(
    AlgorithmName.MSE, mse.get_tensor_quant_params, _MSE_OPS
)


def _mse_config_check(op_name, op_quant_config, policy) -> None:
  w = op_quant_config.weight_tensor_config
  if w is not None and qtyping.is_blockwise_granularity(w.granularity):
    raise ValueError('Blockwise quantization is not supported for MSE.')
  if w is not None and not w.symmetric:
    raise ValueError('MSE supports symmetric weights only.')
  _min_max_family_config_check(op_name, op_quant_config, policy)


REGISTRY.register_config_check(AlgorithmName.MSE, _mse_config_check)
REGISTRY.register_config_check_policy(
    AlgorithmName.MSE, default_policy.DEFAULT_CONFIG_CHECK_POLICY
)

# --- DEQUANTIZED_WEIGHT_RECOVERY: QAT-exported float models ----------------
from ai_edge_quantizer_tpu_torch.algorithms.uniform import dequant_recovery  # noqa: E402

_RECOVERY_OPS = [
    qtyping.OpName.FULLY_CONNECTED, qtyping.OpName.CONV_2D,
    qtyping.OpName.EMBEDDING_LOOKUP,
]
_register_min_max_style_algorithm(
    AlgorithmName.DEQUANTIZED_WEIGHT_RECOVERY,
    dequant_recovery.get_tensor_quant_params, _RECOVERY_OPS
)
REGISTRY.register_config_check(
    AlgorithmName.DEQUANTIZED_WEIGHT_RECOVERY, _min_max_family_config_check
)
REGISTRY.register_config_check_policy(
    AlgorithmName.DEQUANTIZED_WEIGHT_RECOVERY,
    default_policy.DEFAULT_CONFIG_CHECK_POLICY,
)

# --- GPTQ: FULLY_CONNECTED only, Hessian calibration -----------------------
from ai_edge_quantizer_tpu_torch.algorithms.uniform import gptq  # noqa: E402

_fc_spec = op_library.OP_SPECS[qtyping.OpName.FULLY_CONNECTED]
REGISTRY.register_op(
    AlgorithmName.GPTQ,
    qtyping.OpName.FULLY_CONNECTED,
    init_qsv_fn=min_max.init_qsvs,
    calibration_fn=gptq.calibrate,
    materialize_fn=functools.partial(
        op_library.materialize_with_spec, _fc_spec,
        gptq.get_tensor_quant_params),
    update_qsv_fn=qsv_utils.gptq_and_moving_average_update,
)
REGISTRY.register_config_check(
    AlgorithmName.GPTQ, _min_max_family_config_check
)
REGISTRY.register_config_check_policy(
    AlgorithmName.GPTQ, default_policy.DEFAULT_CONFIG_CHECK_POLICY
)

# --- HADAMARD_ROTATION (fused kernel) & DECOMPOSED variant -----------------
from ai_edge_quantizer_tpu_torch.algorithms.uniform import hadamard  # noqa: E402

for _key, _decomposed in (
    (AlgorithmName.HADAMARD_ROTATION, False),
    (AlgorithmName.DECOMPOSED_HADAMARD_ROTATION, True),
):
  for _op, _mat_fn in hadamard.make_materialize_fns(_decomposed).items():
    REGISTRY.register_op(
        _key, _op,
        init_qsv_fn=min_max.init_qsvs,
        calibration_fn=functools.partial(min_max.min_max_calibrate),
        materialize_fn=_mat_fn,
        update_qsv_fn=qsv_utils.moving_average_update,
    )
  REGISTRY.register_config_check(_key, hadamard.check_config)

# --- FLOAT_CASTING (fp16) --------------------------------------------------
from ai_edge_quantizer_tpu_torch.algorithms.nonlinear import float_casting  # noqa: E402

_register_min_max_style_algorithm(
    AlgorithmName.FLOAT_CASTING,
    float_casting.get_tensor_quant_params,
    list(float_casting.SUPPORTED_OPS),
)
REGISTRY.register_config_check(
    AlgorithmName.FLOAT_CASTING, float_casting.check_config
)


# --- Algorithms whose modules are not ported yet ---------------------------
UNPORTED_ALGORITHMS: dict = {}


def _refuse_unported(algorithm_key) -> None:
  module = UNPORTED_ALGORITHMS.get(algorithm_key)
  if module is not None:
    name = getattr(algorithm_key, 'value', algorithm_key)
    raise NotImplementedError(
        f'Algorithm {name!r} is not ported yet: it needs '
        f'ai_edge_quantizer_tpu/{module}.')


# ---------------------------------------------------------------------------
# Module-level API (used by recipe manager and pipeline passes).
# ---------------------------------------------------------------------------


def check_op_quantization_config(algorithm_key, op_name, op_quant_config):
  _refuse_unported(algorithm_key)
  REGISTRY.check_op_quantization_config(
      algorithm_key, op_name, op_quant_config)


def get_quantization_func(algorithm_key, op_name, mode):
  _refuse_unported(algorithm_key)
  return REGISTRY.get_quantization_func(algorithm_key, op_name, mode)


def get_init_qsv_fn(algorithm_key, op_name):
  _refuse_unported(algorithm_key)
  return REGISTRY.get_init_qsv_fn(algorithm_key, op_name)


def get_update_qsv_fn(algorithm_key, op_name):
  return REGISTRY.get_update_qsv_fn(algorithm_key, op_name)


def is_op_registered(algorithm_key, op_name):
  return REGISTRY.is_op_registered(algorithm_key, op_name)


def get_config_check_policy(algorithm_key):
  return REGISTRY.get_config_check_policy(algorithm_key)


def update_config_check_policy(algorithm_key, policy):
  REGISTRY.update_config_check_policy(algorithm_key, policy)
