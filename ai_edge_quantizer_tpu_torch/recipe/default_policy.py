"""Default config-check policy: which (op, config) pairs are legal.

The policy is expressed as named config *families* (a config template with
option lists for symmetric/granularity) crossed with op lists, then unrolled
into {op -> [exact OpQuantizationConfig, ...]} for membership checking. User
policies in the same JSON schema ("configs" / "ops_per_config") can replace
or extend it (`Quantizer.load_config_policy`).

Capability parity: reference `default_policy.py` (same families and op sets,
expressed generatively instead of as one embedded JSON string).

A copy of `ai_edge_quantizer_tpu/recipe/default_policy.py`: the port keeps
its own so that it never imports the JAX package.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Optional

from ai_edge_quantizer_tpu_torch import qtyping

_Op = qtyping.OpName
_G = qtyping.QuantGranularity

# Ops that support full static-range quantization (SRQ).
_SRQ_COMMON_OPS = [
    _Op.ADD, _Op.AVERAGE_POOL_2D, _Op.BATCH_MATMUL, _Op.CONCATENATION,
    _Op.CONV_2D, _Op.CONV_2D_TRANSPOSE, _Op.DEPTHWISE_CONV_2D,
    _Op.FULLY_CONNECTED, _Op.GELU, _Op.LOGISTIC, _Op.MEAN, _Op.MUL,
    _Op.RESHAPE, _Op.RSQRT, _Op.SOFTMAX, _Op.SPLIT, _Op.STRIDED_SLICE,
    _Op.SUB, _Op.TANH, _Op.TRANSPOSE, _Op.INPUT, _Op.OUTPUT, _Op.SLICE,
    _Op.SUM, _Op.SELECT, _Op.SELECT_V2, _Op.DYNAMIC_UPDATE_SLICE,
    _Op.STABLEHLO_COMPOSITE, _Op.PAD, _Op.MAX_POOL_2D, _Op.RESIZE_BILINEAR,
    _Op.RESIZE_NEAREST_NEIGHBOR, _Op.GATHER_ND, _Op.PACK, _Op.UNPACK,
    _Op.DIV, _Op.BROADCAST_TO, _Op.SQRT, _Op.GATHER, _Op.MAXIMUM, _Op.PADV2,
    _Op.REDUCE_MIN, _Op.EQUAL, _Op.NOT_EQUAL, _Op.MIRROR_PAD, _Op.RELU,
    # TPU-side additions.
    _Op.RMS_NORM,
]

# int8-activation SRQ additionally supports these.
_SRQ_A8_EXTRA_OPS = [_Op.SQUARED_DIFFERENCE, _Op.HARD_SWISH,
                     _Op.SPACE_TO_DEPTH]

# Ops with quantizable weights (dynamic / weight-only families).
_WEIGHT_OPS = [
    _Op.BATCH_MATMUL, _Op.CONV_2D, _Op.CONV_2D_TRANSPOSE,
    _Op.DEPTHWISE_CONV_2D, _Op.EMBEDDING_LOOKUP, _Op.FULLY_CONNECTED,
]

_BLOCKWISE_GRANULARITIES = [
    _G.BLOCKWISE_32, _G.BLOCKWISE_64, _G.BLOCKWISE_128, _G.BLOCKWISE_256,
]

# Composite op names that ARE quantizable (others are opaque barriers).
QUANTIZABLE_COMPOSITES = ('odml.npu_call', 'odml.rms_norm', 'odml.l2_norm')


def is_non_quantizable_composite_op(op) -> bool:
  """True for STABLEHLO_COMPOSITE ops whose name is not whitelisted."""
  if op.opcode != _Op.STABLEHLO_COMPOSITE.value:
    return False
  name = op.attrs.get('composite_name', '')
  return name not in QUANTIZABLE_COMPOSITES


def _expand_family(
    *,
    weight_bits: Optional[int] = None,
    weight_symmetric=(True,),
    weight_granularities=(_G.CHANNELWISE, _G.TENSORWISE),
    act_bits: Optional[int] = None,
    act_symmetric=(True,),
    compute_precision=qtyping.ComputePrecision.INTEGER,
    explicit_dequantize=False,
) -> list:
  """Unroll a config family into exact OpQuantizationConfigs."""
  configs = []
  for w_sym, w_gran in itertools.product(weight_symmetric,
                                         weight_granularities):
    w_cfg = qtyping.TensorQuantizationConfig(
        num_bits=weight_bits, symmetric=w_sym, granularity=w_gran,
    ) if weight_bits else None
    if act_bits is None:
      configs.append(
          qtyping.OpQuantizationConfig(
              weight_tensor_config=w_cfg,
              compute_precision=compute_precision,
              explicit_dequantize=explicit_dequantize,
          )
      )
    else:
      for a_sym in act_symmetric:
        configs.append(
            qtyping.OpQuantizationConfig(
                activation_tensor_config=qtyping.TensorQuantizationConfig(
                    num_bits=act_bits, symmetric=a_sym,
                    granularity=_G.TENSORWISE,
                ),
                weight_tensor_config=w_cfg,
                compute_precision=compute_precision,
                explicit_dequantize=explicit_dequantize,
            )
        )
  return configs


def _build_default_policy() -> dict:
  """op -> list of allowed (normalized) OpQuantizationConfig."""
  families = {
      # Dynamic-range: int weights, runtime activation quant.
      'dynamic_wi8_afp32': (
          _expand_family(weight_bits=8), _WEIGHT_OPS),
      'dynamic_wi4_afp32': (
          _expand_family(weight_bits=4),
          [_Op.FULLY_CONNECTED, _Op.EMBEDDING_LOOKUP, _Op.CONV_2D]),
      'dynamic_wi4_afp32_blockwise': (
          _expand_family(weight_bits=4,
                         weight_granularities=_BLOCKWISE_GRANULARITIES),
          [_Op.EMBEDDING_LOOKUP, _Op.FULLY_CONNECTED]),
      'dynamic_wi2_afp32': (
          _expand_family(weight_bits=2),
          [_Op.FULLY_CONNECTED, _Op.EMBEDDING_LOOKUP, _Op.CONV_2D]),
      'dynamic_wi2_afp32_blockwise': (
          _expand_family(weight_bits=2,
                         weight_granularities=_BLOCKWISE_GRANULARITIES),
          [_Op.FULLY_CONNECTED]),
      # Static-range.
      'static_wi8_ai16': (
          _expand_family(weight_bits=8, act_bits=16), _SRQ_COMMON_OPS),
      'static_wi4_ai16': (
          _expand_family(weight_bits=4, act_bits=16),
          [_Op.FULLY_CONNECTED, _Op.CONV_2D, _Op.INPUT, _Op.OUTPUT]),
      'static_wi8_ai8': (
          _expand_family(weight_bits=8, act_bits=8,
                         act_symmetric=(True, False)),
          _SRQ_COMMON_OPS + _SRQ_A8_EXTRA_OPS),
      'static_wi4_ai8': (
          _expand_family(weight_bits=4, act_bits=8,
                         act_symmetric=(True, False)),
          [_Op.FULLY_CONNECTED, _Op.CONV_2D, _Op.INPUT, _Op.OUTPUT]),
      # Weight-only: int weights + explicit dequantize, float compute.
      'weightonly_wi8_afp32': (
          _expand_family(weight_bits=8, weight_symmetric=(True, False),
                         compute_precision=qtyping.ComputePrecision.FLOAT,
                         explicit_dequantize=True),
          _WEIGHT_OPS),
      'weightonly_wi4_afp32': (
          _expand_family(weight_bits=4, weight_symmetric=(True, False),
                         compute_precision=qtyping.ComputePrecision.FLOAT,
                         explicit_dequantize=True),
          [_Op.BATCH_MATMUL, _Op.FULLY_CONNECTED, _Op.EMBEDDING_LOOKUP,
           _Op.CONV_2D]),
  }
  policy: dict = {}
  for configs, ops in families.values():
    for op in ops:
      policy.setdefault(_Op(op), []).extend(configs)
  # Ops with no weights in SRQ mode also accept configs where the weight
  # config is present but irrelevant — the reference policy includes the
  # weight config in all entries, so membership needs no special casing.
  return policy


DEFAULT_CONFIG_CHECK_POLICY = _build_default_policy()


def policy_from_json(json_text_or_dict: Any) -> dict:
  """Unroll a user policy JSON ('configs' / 'ops_per_config' schema)."""
  if isinstance(json_text_or_dict, str):
    spec = json.loads(json_text_or_dict)
  else:
    spec = json_text_or_dict
  policy: dict = {}
  for name, cfg in spec.get('configs', {}).items():
    ops = spec.get('ops_per_config', {}).get(name, [])
    w = cfg.get('weight_tensor_config')
    a = cfg.get('activation_tensor_config')
    w_syms = (w or {}).get('symmetric', [True])
    w_grans = [(_G(g)) for g in (w or {}).get('granularity', ['TENSORWISE'])]
    a_syms = (a or {}).get('symmetric', [True])
    configs = _expand_family(
        weight_bits=(w or {}).get('num_bits'),
        weight_symmetric=tuple(w_syms) if isinstance(w_syms, list)
        else (w_syms,),
        weight_granularities=tuple(w_grans),
        act_bits=(a or {}).get('num_bits'),
        act_symmetric=tuple(a_syms) if isinstance(a_syms, list)
        else (a_syms,),
        compute_precision=qtyping.ComputePrecision(
            cfg.get('compute_precision', 'INTEGER')),
        explicit_dequantize=bool(cfg.get('explicit_dequantize', False)),
    )
    for op in ops:
      policy.setdefault(_Op(op), []).extend(configs)
  return policy


def update_default_config_policy(policy_json: Any) -> dict:
  """Default policy merged with (overridden by) a user policy."""
  user = policy_from_json(policy_json)
  merged = {op: list(cfgs) for op, cfgs in DEFAULT_CONFIG_CHECK_POLICY.items()}
  for op, cfgs in user.items():
    merged.setdefault(op, []).extend(cfgs)
  return merged
