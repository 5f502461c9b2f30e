"""Public API facade: the Quantizer.

Orchestrates recipe -> (calibrate) -> params -> rewrite -> validate over a
Graph IR model. The sole class a typical user touches.

Parity: reference `quantizer.py` (`Quantizer` / `QuantizationResult`).

A copy of `ai_edge_quantizer_tpu/quantizer.py`, numpy only like the
pipeline it drives, but for `calibrate` and `validate`, which run the
models in the port's executor: on the card unless the caller passes
`device='cpu'`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms import manager as algorithm_manager
from ai_edge_quantizer_tpu_torch.algorithms.registry import AlgorithmName
from ai_edge_quantizer_tpu_torch.execution import model_validator
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.graph import serialize as graph_serialize
from ai_edge_quantizer_tpu_torch.pipeline import calibrator as calibrator_lib
from ai_edge_quantizer_tpu_torch.pipeline import model_modifier
from ai_edge_quantizer_tpu_torch.pipeline import params_generator
from ai_edge_quantizer_tpu_torch.recipe import default_policy
from ai_edge_quantizer_tpu_torch.recipe import recipe_manager as rm
from ai_edge_quantizer_tpu_torch.recipe import recipe_utils
from ai_edge_quantizer_tpu_torch.utils import progress_utils

_CalibrationResult = dict


@dataclasses.dataclass(frozen=True)
class QuantizationResult:
  """Output of `Quantizer.quantize`: recipe + quantized model."""

  recipe: list
  quantized_model: Optional[ir.Graph]

  def save(self, save_folder: str, model_name: str,
           overwrite: bool = False) -> None:
    """Write model (`.aeqg`) + recipe JSON side by side."""
    if self.quantized_model is None:
      raise RuntimeError('No quantized model to save.')
    model_path = os.path.join(save_folder, f'{model_name}.aeqg')
    if os.path.exists(model_path) and not overwrite:
      raise FileExistsError(
          f'{model_path} exists; pass overwrite=True to replace it.')
    os.makedirs(save_folder, exist_ok=True)
    graph_serialize.save_graph(self.quantized_model, model_path)
    with open(
        os.path.join(save_folder, f'{model_name}_recipe.json'), 'w') as f:
      json.dump(self.recipe, f, indent=2)

  def export_model(self, filepath: str) -> None:
    if self.quantized_model is None:
      raise RuntimeError('No quantized model to export.')
    graph_serialize.save_graph(self.quantized_model, filepath)


class Quantizer:
  """Declarative post-training quantization over Graph IR models."""

  def __init__(
      self,
      float_model: Union[str, ir.Graph],
      quantization_recipe: Optional[Union[str, list]] = None,
      previous_quantized_model: Optional[Union[str, ir.Graph]] = None,
  ):
    self.float_model: ir.Graph = (
        graph_serialize.load_model(float_model)
        if isinstance(float_model, (str, bytes, bytearray)) else float_model
    )
    self._previous_quantized_model: Optional[ir.Graph] = (
        graph_serialize.load_model(previous_quantized_model)
        if isinstance(previous_quantized_model, (str, bytes, bytearray))
        else previous_quantized_model
    )
    self._recipe_manager = rm.RecipeManager()
    self._result = QuantizationResult(recipe=[], quantized_model=None)
    if quantization_recipe is not None:
      self.load_quantization_recipe(quantization_recipe)

  # -- recipe management ----------------------------------------------------

  def load_quantization_recipe(self, recipe: Union[str, list]) -> 'Quantizer':
    self._recipe_manager.load_quantization_recipe(
        recipe_utils.resolve_recipe(recipe))
    return self

  def get_quantization_recipe(self) -> list:
    return self._recipe_manager.get_quantization_recipe()

  def update_quantization_recipe(
      self,
      regex: str,
      operation_name: qtyping.OpName,
      op_config: Optional[qtyping.OpQuantizationConfig] = None,
      algorithm_key: str = AlgorithmName.MIN_MAX_UNIFORM_QUANT,
  ) -> None:
    self._recipe_manager.add_quantization_config(
        regex, operation_name, op_config, algorithm_key)

  def add_dynamic_config(self, *args, **kwargs) -> None:
    self._recipe_manager.add_dynamic_config(*args, **kwargs)

  def add_weight_only_config(self, *args, **kwargs) -> None:
    self._recipe_manager.add_weight_only_config(*args, **kwargs)

  def add_static_config(self, *args, **kwargs) -> None:
    self._recipe_manager.add_static_config(*args, **kwargs)

  def load_config_policy(self, policy: Union[str, dict]) -> 'Quantizer':
    """Override the config-check policy (JSON path, JSON text, or dict)."""
    if isinstance(policy, str) and os.path.exists(policy):
      with open(policy) as f:
        policy = f.read()
    merged = default_policy.update_default_config_policy(policy)
    algorithm_manager.update_config_check_policy(
        AlgorithmName.MIN_MAX_UNIFORM_QUANT, merged)
    return self

  # -- calibration ----------------------------------------------------------

  @property
  def need_calibration(self) -> bool:
    return self._recipe_manager.need_calibration()

  def calibrate(
      self,
      calibration_data: dict,
      previous_calibration_result: Optional[_CalibrationResult] = None,
      calibration_mode: str = 'capture',
      device='cuda',
  ) -> _CalibrationResult:
    """calibration_data: {signature_key: iterable of {input_name: array}}.

    calibration_mode='device_stats' reduces min/max (and GPTQ Hessians) on
    device in the forward pass — the profiler-based calibrator analog
    (ref calibrator.py:590-686); use it for large calibration batches
    where transferring every intermediate tensor is the bottleneck.
    device: the torch device the float model runs on.
    """
    if not self.need_calibration:
      return {}
    calib = calibrator_lib.Calibrator(self.float_model, mode=calibration_mode,
                                      device=device)
    if previous_calibration_result is not None:
      calib.load_model_qsvs(previous_calibration_result)
    calib.calibrate(calibration_data, self._recipe_manager)
    return calib.get_model_qsvs()

  def _check_qsv_sufficient(self, calibration_result: _CalibrationResult):
    empty = {k for k, v in calibration_result.items() if not v}
    for sig in self.float_model.signatures:
      sg = self.float_model.subgraphs[sig.subgraph_index]
      for t in sg.tensors:
        # Only value-carrying (float) tensors need ranges; int32 structure
        # operands (axes/indices) legitimately have empty QSVs.
        if t.name in empty and t.dtype == 'float32':
          raise ValueError(
              f'Missing QSVs (min/max) for tensor {t.name!r} in signature '
              f'{sig.signature_key!r}; was this signature calibrated?')

  # -- quantization ---------------------------------------------------------

  def quantize(
      self,
      calibration_result: Optional[_CalibrationResult] = None,
  ) -> QuantizationResult:
    if not self.get_quantization_recipe():
      raise RuntimeError('Can not quantize without a quantization recipe.')
    if self.need_calibration:
      if not calibration_result:
        raise RuntimeError(
            'Model quantization statistics values (QSVs) are required for '
            'the requested recipe (static-range or GPTQ entries need '
            'calibration).')
      self._check_qsv_sufficient(calibration_result)
    report = progress_utils.ProgressReport()
    report.start(self.float_model)
    params = params_generator.ParamsGenerator(
        self.float_model).generate_quantization_parameters(
            self._recipe_manager, calibration_result)
    quantized = model_modifier.ModelModifier(
        self.float_model).modify_model(params)
    self._result = QuantizationResult(
        recipe=self.get_quantization_recipe(), quantized_model=quantized)
    report.finish(quantized)
    return self._result

  # -- validation -----------------------------------------------------------

  def validate(
      self,
      test_data: Optional[dict] = None,
      error_metrics: str = 'mse',
      compare_outputs_only: bool = False,
      num_samples: int = 4,
      target_executor=None,
      use_serving_paths: bool = False,
      device='cuda',
  ) -> model_validator.ComparisonResult:
    """target_executor/use_serving_paths: validate a pre-configured
    serving executor (packed weights, fused kernels) per tensor instead
    of a fresh plain executor. device: where the models run."""
    target = self._target_model_for_validation()
    if test_data is None:
      from ai_edge_quantizer_tpu_torch.utils import test_data as test_data_lib
      test_data = test_data_lib.create_random_dataset(
          self.float_model, num_samples=num_samples)
    return model_validator.compare_model(
        self.float_model,
        target,
        test_data,
        error_metric=error_metrics,
        compare_outputs_only=compare_outputs_only,
        target_executor=target_executor,
        use_serving_paths=use_serving_paths,
        device=device,
    )

  def _target_model_for_validation(self) -> ir.Graph:
    if self._result.quantized_model is not None:
      return self._result.quantized_model
    if self._previous_quantized_model is not None:
      return self._previous_quantized_model
    raise ValueError(
        'No quantized model available: run quantize() or construct with '
        'previous_quantized_model.')
