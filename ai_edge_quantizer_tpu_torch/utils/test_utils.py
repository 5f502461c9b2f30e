"""Shared test harness: full-pipeline quantize-and-validate helper with
accuracy/size assertions.

Parity: reference `utils/test_utils.py` BaseOpTestCase — used by the per-op
end-to-end test tier and available to downstream users for their own op
coverage tests.

A copy of `ai_edge_quantizer_tpu/utils/test_utils.py` over the port's
`Quantizer`. Calibration and validation run on `device`, the card unless
the caller asks for the CPU (`device='cpu'`), as the `Quantizer`'s own.
"""

from __future__ import annotations

from typing import Union


from ai_edge_quantizer_tpu_torch import quantizer as quantizer_lib
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.utils import test_data as test_data_lib


class BaseOpTestCase:
  """Mixin with the quantize -> validate -> assert helpers."""

  @staticmethod
  def quantize_and_validate(
      model: Union[str, ir.Graph],
      recipe: Union[str, list],
      num_calibration_samples: int = 16,
      num_validation_samples: int = 4,
      error_metric: str = 'mse',
      device: str = 'cuda',
  ):
    """Run the full pipeline; returns (quantizer, comparison_result)."""
    qt = quantizer_lib.Quantizer(model, recipe)
    calibration_result = None
    if qt.need_calibration:
      data = test_data_lib.create_random_dataset(
          qt.float_model, num_samples=num_calibration_samples)
      calibration_result = qt.calibrate(data, device=device)
    qt.quantize(calibration_result)
    comparison = qt.validate(num_samples=num_validation_samples,
                             error_metrics=error_metric, device=device)
    return qt, comparison

  @staticmethod
  def assert_model_size_reduction_above_min(
      comparison, min_fraction: float) -> None:
    _, frac = comparison.get_model_size_reduction()
    assert frac >= min_fraction, (
        f'Model size reduced by {frac:.1%}, expected >= {min_fraction:.1%}.')

  @staticmethod
  def assert_weights_errors_below_tolerance(
      comparison, tolerance: float,
      signature_key: str = 'serving_default') -> None:
    res = comparison.get_signature_comparison_result(signature_key)
    for name, err in res.constant_tensors.items():
      assert err <= tolerance, (
          f'Weight {name!r} error {err} exceeds tolerance {tolerance}.')

  @staticmethod
  def assert_output_errors_below_tolerance(
      comparison, tolerance: float,
      signature_key: str = 'serving_default') -> None:
    res = comparison.get_signature_comparison_result(signature_key)
    for name, err in res.output_tensors.items():
      assert err <= tolerance, (
          f'Output {name!r} error {err} exceeds tolerance {tolerance}.')

  @staticmethod
  def assert_quantization_accuracy_and_size(
      model: Union[str, ir.Graph],
      recipe: Union[str, list],
      min_size_reduction: float,
      weight_tolerance: float = 1e-2,
      output_tolerance: float = 1e-2,
      device: str = 'cuda',
  ) -> None:
    """One-call variant used by the per-op e2e tests."""
    _, comparison = BaseOpTestCase.quantize_and_validate(model, recipe,
                                                         device=device)
    BaseOpTestCase.assert_model_size_reduction_above_min(
        comparison, min_size_reduction)
    sig_key = comparison.available_signature_keys()[0]
    BaseOpTestCase.assert_weights_errors_below_tolerance(
        comparison, weight_tolerance, sig_key)
    BaseOpTestCase.assert_output_errors_below_tolerance(
        comparison, output_tolerance, sig_key)
