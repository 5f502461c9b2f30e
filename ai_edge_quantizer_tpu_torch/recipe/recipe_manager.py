"""Recipe manager: ordered scope-regex -> op quantization configs.

Semantics (parity with reference `recipe_manager.py`):
  * configs are kept in insertion order per scope regex; adding the same op
    under the same regex overwrites; an ALL_SUPPORTED ('*') entry clears the
    scope's other entries;
  * lookup scans every scope with `re.search` against the op's scope string;
    the LAST matching valid entry wins; entries whose (op, config) fails the
    algorithm's config check are silently skipped; fallback is NO_QUANTIZE;
  * `need_calibration` iff any SRQ entry (INTEGER precision with an
    activation config) or any GPTQ entry exists.

A copy of `ai_edge_quantizer_tpu/recipe/recipe_manager.py`: the port keeps
its own so that it never imports the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import re
from typing import Any, Optional

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms import manager as algorithm_manager
from ai_edge_quantizer_tpu_torch.algorithms.registry import AlgorithmName

_Op = qtyping.OpName


@dataclasses.dataclass
class OpQuantizationRecipe:
  """One recipe entry: apply `algorithm_key` on `operation` under `regex`."""

  regex: str
  operation: qtyping.OpName
  algorithm_key: str
  op_config: qtyping.OpQuantizationConfig = dataclasses.field(
      default_factory=qtyping.OpQuantizationConfig
  )

  def to_dict(self) -> dict[str, Any]:
    return {
        'regex': self.regex,
        'operation': self.operation.value,
        'algorithm_key': self.algorithm_key,
        'op_config': self.op_config.to_dict(),
    }


class RecipeManager:
  """Compiles user recipe entries and answers per-op config queries."""

  def __init__(self):
    # scope regex -> ordered list of OpQuantizationRecipe.
    self._scope_configs: 'collections.OrderedDict[str, list]' = (
        collections.OrderedDict()
    )

  def add_quantization_config(
      self,
      regex: str,
      operation_name: qtyping.OpName,
      op_config: Optional[qtyping.OpQuantizationConfig] = None,
      algorithm_key: str = AlgorithmName.MIN_MAX_UNIFORM_QUANT,
  ) -> None:
    """Adds one entry; validates (op, config) against the algorithm policy."""
    try:
      AlgorithmName(algorithm_key)
    except ValueError as e:
      raise ValueError(f'Unsupported algorithm key: {algorithm_key}.') from e
    operation_name = _Op(operation_name)
    if op_config is None:
      op_config = qtyping.OpQuantizationConfig()

    entry = OpQuantizationRecipe(
        regex=regex,
        operation=operation_name,
        algorithm_key=algorithm_key,
        op_config=op_config,
    )
    if operation_name == _Op.ALL_SUPPORTED:
      # A wildcard overrides everything previously set for this scope.
      self._scope_configs[regex] = [entry]
      return

    if algorithm_key != AlgorithmName.NO_QUANTIZE:
      algorithm_manager.check_op_quantization_config(
          algorithm_key, operation_name, op_config
      )

    existing = self._scope_configs.get(regex)
    if existing is None:
      self._scope_configs[regex] = [entry]
      return
    replaced = False
    for i, prev in enumerate(existing):
      if prev.operation == operation_name:
        logging.warning(
            'Overwriting op %s config under scope regex %r.',
            operation_name, regex,
        )
        existing[i] = entry
        replaced = True
    if not replaced:
      existing.append(entry)

  def get_quantization_configs(
      self,
      target_op_name: qtyping.OpName,
      scope_name: str,
  ) -> tuple:
    """(algorithm_key, config) for an op instance; last valid match wins."""
    result_key = AlgorithmName.NO_QUANTIZE
    result_config = qtyping.OpQuantizationConfig()
    for scope_regex, entries in self._scope_configs.items():
      if not re.search(scope_regex, scope_name):
        continue
      for entry in entries:
        if entry.operation not in (_Op.ALL_SUPPORTED, target_op_name):
          continue
        if entry.algorithm_key != AlgorithmName.NO_QUANTIZE:
          try:
            algorithm_manager.check_op_quantization_config(
                entry.algorithm_key, target_op_name, entry.op_config
            )
          except ValueError:
            continue  # Silently skip entries invalid for this op.
        result_key = entry.algorithm_key
        result_config = entry.op_config
    return result_key, result_config

  def get_quantization_recipe(self) -> list:
    """The full recipe as a JSON-serializable list of dicts."""
    return [
        entry.to_dict()
        for entries in self._scope_configs.values()
        for entry in entries
    ]

  def load_quantization_recipe(self, recipe: list) -> None:
    """Replace all entries with `recipe` (list of dicts, JSON schema)."""
    self._scope_configs = collections.OrderedDict()
    for entry in recipe:
      algorithm_key = entry['algorithm_key']
      op_config = None
      if algorithm_key != AlgorithmName.NO_QUANTIZE:
        op_config = qtyping.OpQuantizationConfig.from_dict(entry['op_config'])
      self.add_quantization_config(
          entry['regex'],
          _Op(entry['operation']),
          op_config,
          algorithm_key,
      )

  # -- convenience builders (kernel-constraint-enforcing) -------------------

  def add_dynamic_config(
      self,
      regex: str,
      operation_name: qtyping.OpName,
      num_bits: int,
      granularity=qtyping.QuantGranularity.CHANNELWISE,
      algorithm_key: str = AlgorithmName.MIN_MAX_UNIFORM_QUANT,
  ) -> None:
    """Integer weights, runtime activation quantization. Weights symmetric
    always (integer-kernel constraint)."""
    self.add_quantization_config(
        regex, operation_name,
        qtyping.OpQuantizationConfig(
            weight_tensor_config=qtyping.TensorQuantizationConfig(
                num_bits=num_bits, symmetric=True,
                granularity=qtyping.QuantGranularity(granularity)),
            compute_precision=qtyping.ComputePrecision.INTEGER,
            explicit_dequantize=False,
        ),
        algorithm_key,
    )

  def add_weight_only_config(
      self,
      regex: str,
      operation_name: qtyping.OpName,
      num_bits: int,
      granularity=qtyping.QuantGranularity.CHANNELWISE,
      algorithm_key: str = AlgorithmName.MIN_MAX_UNIFORM_QUANT,
  ) -> None:
    """Integer weight storage + explicit dequantize; float compute."""
    self.add_quantization_config(
        regex, operation_name,
        qtyping.OpQuantizationConfig(
            weight_tensor_config=qtyping.TensorQuantizationConfig(
                num_bits=num_bits, symmetric=True,
                granularity=qtyping.QuantGranularity(granularity)),
            compute_precision=qtyping.ComputePrecision.FLOAT,
            explicit_dequantize=True,
        ),
        algorithm_key,
    )

  def add_static_config(
      self,
      regex: str,
      operation_name: qtyping.OpName,
      activation_num_bits: int,
      weight_num_bits: int,
      weight_granularity=qtyping.QuantGranularity.CHANNELWISE,
      algorithm_key: str = AlgorithmName.MIN_MAX_UNIFORM_QUANT,
  ) -> None:
    """Full static-range quantization. int16 activations must be symmetric,
    int8 asymmetric (integer-kernel constraints)."""
    if activation_num_bits not in (8, 16):
      raise ValueError(
          f'Static activation bits must be 8 or 16, got {activation_num_bits}.')
    self.add_quantization_config(
        regex, operation_name,
        qtyping.OpQuantizationConfig(
            activation_tensor_config=qtyping.TensorQuantizationConfig(
                num_bits=activation_num_bits,
                symmetric=(activation_num_bits == 16),
                granularity=qtyping.QuantGranularity.TENSORWISE),
            weight_tensor_config=qtyping.TensorQuantizationConfig(
                num_bits=weight_num_bits, symmetric=True,
                granularity=qtyping.QuantGranularity(weight_granularity)),
            compute_precision=qtyping.ComputePrecision.INTEGER,
            explicit_dequantize=False,
        ),
        algorithm_key,
    )

  def need_calibration(self) -> bool:
    for entries in self._scope_configs.values():
      for entry in entries:
        if entry.algorithm_key == AlgorithmName.GPTQ:
          return True
        cfg = entry.op_config
        if (
            cfg.compute_precision == qtyping.ComputePrecision.INTEGER
            and cfg.activation_tensor_config is not None
        ):
          return True
    return False
