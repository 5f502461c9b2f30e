"""Command-line interface of the port: `aeqt-torch`.

  python -m ai_edge_quantizer_tpu_torch.cli --model_file model.aeqg \
       --recipe dynamic_wi8_afp32 [--output_dir out] [--validate] \
       [--calibration_samples N] [--device cuda|cpu]

Handles single models (.aeqg, or .tflite where tensorflow is installed),
multi-program GenAI bundles (.aeqb), and reference LiteRT-LM bundles
(.litertlm, quantized per model_type recipe mapping). Parity: reference
`aeq.py` CLI over .tflite/.litertlm.

Port of `ai_edge_quantizer_tpu/cli.py`: the same flags and outputs, over
the port's `Quantizer` and `models/bundles.py`, with one flag more:
`--device` (default `cuda`), where calibration and validation run the
models; `--device cpu` runs them on the host. Quantizing itself is host
numpy either way.
"""

from __future__ import annotations

import argparse
import os
import sys

DEFAULT_DEVICE = 'cuda'


def build_arg_parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(
      prog='aeqt-torch',
      description='Post-training quantizer (PyTorch port).')
  p.add_argument('--model_file', required=True,
                 help='Input model: .aeqg graph, .aeqb bundle, or '
                      '.litertlm bundle.')
  p.add_argument('--recipe', required=True,
                 help='Recipe: preset name, JSON path, or (for bundles) a '
                      'recipe-mapping name/JSON path.')
  p.add_argument('--output_dir', default=None,
                 help='Output directory (default: alongside the input).')
  p.add_argument('--validate', action='store_true',
                 help='Run the dual-model validator after quantization.')
  p.add_argument('--error_metric', default='mse',
                 choices=['mse', 'median_diff_ratio', 'cosine_similarity',
                          'kl_divergence', 'snr'])
  p.add_argument('--calibration_mode', default='capture',
                 choices=('capture', 'device_stats'),
                 help='device_stats reduces min/max + GPTQ Hessians on '
                      'the device in the forward pass (fastest for large '
                      'calibration sets).')
  p.add_argument('--calibration_samples', type=int, default=32,
                 help='Random calibration samples when the recipe needs '
                      'calibration (replace with real data via the API).')
  p.add_argument('--device', default=DEFAULT_DEVICE,
                 help="torch device that calibration and validation run "
                      "on: 'cuda' (default) or 'cpu'.")
  return p


def quantize_graph_file(model_file: str, recipe, output_dir: str,
                        validate: bool, error_metric: str,
                        calibration_samples: int,
                        calibration_mode: str = 'capture',
                        device=DEFAULT_DEVICE) -> str:
  from ai_edge_quantizer_tpu_torch import quantizer as quantizer_lib
  from ai_edge_quantizer_tpu_torch.utils import test_data as test_data_lib

  qt = quantizer_lib.Quantizer(model_file, recipe)
  calibration_result = None
  if qt.need_calibration:
    print(f'Recipe requires calibration; using {calibration_samples} '
          'random samples (supply real data via the Python API for '
          'production accuracy).', file=sys.stderr)
    data = test_data_lib.create_random_dataset(
        qt.float_model, num_samples=calibration_samples)
    calibration_result = qt.calibrate(
        data, calibration_mode=calibration_mode, device=device)
  result = qt.quantize(calibration_result)
  stem = os.path.splitext(os.path.basename(model_file))[0]
  result.save(output_dir, stem, overwrite=True)
  out_path = os.path.join(output_dir, f'{stem}.aeqg')
  print(f'Quantized model written to {out_path}')
  if validate:
    cmp = qt.validate(error_metrics=error_metric, device=device)
    cmp.save(output_dir, stem)
    _, frac = cmp.get_model_size_reduction()
    print(f'Size reduction: {frac * 100:.1f}%; per-tensor comparison in '
          f'{output_dir}/{stem}_comparison_result.json')
  return out_path


def quantize_bundle_file(model_file: str, recipe: str, output_dir: str,
                         device=DEFAULT_DEVICE) -> str:
  from ai_edge_quantizer_tpu_torch.models import bundles
  from ai_edge_quantizer_tpu_torch.recipe import recipe_utils

  bundle = bundles.Bundle.load(model_file)
  mapping = recipe_utils.resolve_recipe_mapping(recipe)
  quantized = bundles.quantize_bundle(bundle, mapping, device=device)
  stem = os.path.splitext(os.path.basename(model_file))[0]
  out_path = os.path.join(output_dir, f'{stem}.aeqb')
  quantized.save(out_path)
  print(f'Quantized bundle written to {out_path}')
  return out_path


def quantize_litertlm_file(model_file: str, recipe: str,
                           output_dir: str, device=DEFAULT_DEVICE) -> str:
  """Quantize a reference `.litertlm` bundle per model_type mapping
  (parity: reference aeq.py:61-181)."""
  from ai_edge_quantizer_tpu_torch.models import bundles
  from ai_edge_quantizer_tpu_torch.recipe import recipe_utils

  mapping = recipe_utils.resolve_recipe_mapping(recipe)
  stem = os.path.splitext(os.path.basename(model_file))[0]
  out_path = os.path.join(output_dir, f'{stem}.litertlm')
  if os.path.abspath(out_path) == os.path.abspath(model_file):
    out_path = os.path.join(output_dir, f'{stem}_quantized.litertlm')
  report = bundles.quantize_litertlm(model_file, out_path, mapping,
                                     device=device)
  for sid, model_type, applied in report:
    state = 'quantized' if applied else 'left float (no recipe)'
    print(f'  section {sid} ({model_type}): {state}', file=sys.stderr)
  print(f'Quantized bundle written to {out_path}')
  return out_path


def main(argv=None) -> int:
  args = build_arg_parser().parse_args(argv)
  output_dir = args.output_dir or os.path.dirname(
      os.path.abspath(args.model_file))
  os.makedirs(output_dir, exist_ok=True)
  if args.model_file.endswith('.aeqb'):
    quantize_bundle_file(args.model_file, args.recipe, output_dir,
                         args.device)
  elif args.model_file.endswith('.litertlm'):
    quantize_litertlm_file(args.model_file, args.recipe, output_dir,
                           args.device)
  else:
    quantize_graph_file(
        args.model_file, args.recipe, output_dir, args.validate,
        args.error_metric, args.calibration_samples,
        args.calibration_mode, args.device)
  return 0


if __name__ == '__main__':
  sys.exit(main())
