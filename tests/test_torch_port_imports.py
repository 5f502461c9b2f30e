"""The port stands alone: no jax, no ml_dtypes, no JAX package; entry
points default to the card and refuse to fall back to the CPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / 'ai_edge_quantizer_tpu_torch'


def _port_modules():
  names = []
  for path in sorted(PORT.rglob('*.py')):
    rel = path.relative_to(ROOT).with_suffix('')
    parts = list(rel.parts)
    if parts[-1] == '__init__':
      parts = parts[:-1]
    names.append('.'.join(parts))
  return names


def _clean_env():
  env = dict(os.environ)
  env.pop('PYTHONPATH', None)
  return env


def test_port_imports_no_jax():
  modules = _port_modules()
  for name in ('execution.executor', 'parallel.batching', 'models.gemma',
               'kernels.attention', 'kernels.block', 'kernels._build',
               'kernels.int_qmatmul', 'kernels.cache', 'kernels.qkv',
               'quantizer', 'qtyping', 'graph.serialize', 'algorithms.manager',
               'algorithms.uniform.quant_numerics',
               'algorithms.uniform.octav', 'algorithms.uniform.hadamard',
               'algorithms.nonlinear.float_casting', 'recipe.recipe_utils',
               'pipeline.params_generator', 'pipeline.model_modifier',
               'utils.progress_utils'):
    assert f'ai_edge_quantizer_tpu_torch.{name}' in modules
  code = (
      'import importlib, sys\n'
      f'for m in {modules!r}:\n'
      '  importlib.import_module(m)\n'
      'bad = sorted(m for m in sys.modules if m in ("jax", "ml_dtypes", '
      '"ai_edge_quantizer_tpu") or m.startswith(("jax.", "ml_dtypes.", '
      '"ai_edge_quantizer_tpu.")))\n'
      'print(bad)\n'
      'assert not bad, bad\n')
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=300)
  assert out.returncode == 0, out.stderr + out.stdout


def test_port_sources_never_name_the_jax_package():
  for path in PORT.rglob('*.py'):
    for line in path.read_text().splitlines():
      stripped = line.strip()
      if stripped.startswith(('import ', 'from ')):
        assert 'jax' not in stripped and 'ml_dtypes' not in stripped, (
            path, line)
        assert not stripped.startswith(
            ('import ai_edge_quantizer_tpu ', 'from ai_edge_quantizer_tpu ',
             'from ai_edge_quantizer_tpu.', 'import ai_edge_quantizer_tpu.')
        ), (path, line)


def test_executor_defaults_to_cuda():
  from ai_edge_quantizer_tpu_torch.execution import executor
  from ai_edge_quantizer_tpu_torch.models import gemma
  graph = gemma.build_decoder(gemma.TOY_DECODER, signatures=('decode',))
  if torch.cuda.is_available():
    assert executor.GraphExecutor(graph).device.type == 'cuda'
    return
  with pytest.raises(RuntimeError, match='cuda'):
    executor.GraphExecutor(graph)
  assert executor.GraphExecutor(graph, device='cpu').device.type == 'cpu'


def test_kernel_wrappers_count_plain_runs_on_cpu():
  from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul
  fn = packed_qmatmul.qmatmul_int4_packed_drq
  before = (fn.launches, fn.plain_calls)
  x = torch.ones((2, 64))
  w = torch.zeros((128, 32), dtype=torch.uint8)
  y = fn(x, w, torch.ones(128))
  assert y.shape == (2, 128) and y.dtype == torch.float32
  assert (fn.launches, fn.plain_calls) == (before[0], before[1] + 1)
  with pytest.raises(ValueError, match='meta'):
    fn(x.to('meta'), w.to('meta'), torch.ones(128, device='meta'))


def test_chip_smoke_refuses_without_a_card(tmp_path):
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present: chip_smoke.py would run')
  out = subprocess.run([sys.executable, str(ROOT / 'chip_smoke.py')],
                       cwd=ROOT, env=_clean_env(), capture_output=True,
                       text=True, timeout=300)
  assert out.returncode != 0
  assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
  shutil.copy(ROOT / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
  out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=300)
  assert out.returncode != 0
  assert '"ok"' not in out.stdout
