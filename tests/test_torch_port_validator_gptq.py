"""The port's model validator (validation_utils, compare_model,
ComparisonResult, save, the Model Explorer JSON, Quantizer.validate) and
GPTQ (calibrate, the host and Newton-Schulz inverses, apply_gptq,
get_tensor_quant_params, the gptq recipe through the Quantizer) against
the JAX package's, on the CPU.

The metrics are the same numpy functions on both sides, so given the same
arrays they are equal; over a model they compare each executor's own
captured tensors, whose float sums run in other orders, so they are held
to METRIC_RTOL (a mean over a tensor of squared differences that are
themselves a few ulps apart). GPTQ's weights are the JAX package's bit for
bit given the same Hessian (the same numpy loop and scipy LAPACK inverse).
"""

import json
import os

import numpy as np
import pytest
import torch

import fixtures
from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu import qtyping as jax_qtyping
from ai_edge_quantizer_tpu.algorithms.uniform import gptq as jax_gptq
from ai_edge_quantizer_tpu.execution import model_validator as jax_mv
from ai_edge_quantizer_tpu.execution import validation_utils as jax_vu
from ai_edge_quantizer_tpu.models import encoder as jax_encoder
from ai_edge_quantizer_tpu.utils import test_data as jax_test_data
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms import manager
from ai_edge_quantizer_tpu_torch.algorithms.uniform import gptq
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.execution import model_validator
from ai_edge_quantizer_tpu_torch.execution import validation_utils
from ai_edge_quantizer_tpu_torch.graph import builder

from test_torch_port_calibration import SMALL_ENCODER
from test_torch_port_quantizer import graph_record, to_port_graph

# Relative agreement of a per-tensor metric between the two packages'
# runs of one model (their float sums' orders; the largest seen is 2e-3,
# on an mse of 5e-9 that the order moves).
METRIC_RTOL = 1e-2
METRICS = ('mse', 'median_diff_ratio', 'cosine_similarity', 'kl_divergence',
           'snr')


def _pairs(seed=0):
  rng = np.random.default_rng(seed)
  a = rng.normal(size=(4, 33)).astype(np.float32)
  b = (a + rng.normal(size=a.shape) * 0.01).astype(np.float32)
  c = a.copy()
  c[0, :3] = (np.nan, np.inf, -np.inf)
  return [(a, b), (b, a), (c, a), (a, c), (np.zeros(5), np.zeros(5)),
          (np.zeros(5), np.ones(5)), (np.array([]), np.array([])),
          (np.abs(a), np.abs(b))]


@pytest.mark.parametrize('metric', METRICS)
def test_validation_utils_match_jax(metric):
  want_fn = jax_vu.get_validation_func(metric)
  got_fn = validation_utils.get_validation_func(metric)
  for a, b in _pairs():
    want, got = want_fn(a, b), got_fn(a, b)
    assert type(got) is float
    assert got == want or (np.isnan(got) and np.isnan(want)), (metric, a, b)
  with pytest.raises(ValueError, match='same number'):
    got_fn(np.zeros(3), np.zeros(4))


def test_unknown_metric_raises():
  with pytest.raises(ValueError, match='not supported'):
    validation_utils.get_validation_func('bogus')


def _quantized_pair(model, recipe):
  """(JAX quantizer with its result, port quantizer with its result) of
  one float model; the port quantizes with the JAX package's QSVs where
  the recipe needs them."""
  if model == 'encoder':
    jgraph = jax_encoder.build_encoder(
        jax_encoder.EncoderConfig(**SMALL_ENCODER), batch=2)
  else:
    jgraph = getattr(fixtures, model)()
  jq, tq = JaxQuantizer(jgraph, recipe), Quantizer(to_port_graph(jgraph),
                                                   recipe)
  qsvs = None
  if jq.need_calibration:
    qsvs = jq.calibrate(jax_test_data.create_random_dataset(jgraph,
                                                            num_samples=2))
  jq.quantize(qsvs)
  tq.quantize(qsvs)
  assert graph_record(tq._result.quantized_model) == graph_record(
      to_port_graph(jq._result.quantized_model))
  return jq, tq


def _assert_results_close(got, want):
  assert got.available_signature_keys() == want.available_signature_keys()
  for key in want.available_signature_keys():
    g = got.get_signature_comparison_result(key)
    w = want.get_signature_comparison_result(key)
    assert g.error_metric == w.error_metric
    for bucket in ('input_tensors', 'output_tensors', 'constant_tensors',
                   'intermediate_tensors'):
      gb, wb = getattr(g, bucket), getattr(w, bucket)
      assert set(gb) == set(wb), bucket
      for name, v in wb.items():
        assert np.isclose(gb[name], v, rtol=METRIC_RTOL, atol=1e-12), (
            bucket, name, gb[name], v)
  assert got.get_model_size_reduction() == want.get_model_size_reduction()


@pytest.mark.parametrize('metric', ['mse', 'cosine_similarity'])
@pytest.mark.parametrize('model,recipe', [
    ('two_layer_mlp', 'dynamic_wi8_afp32'), ('single_fc', 'default_a8w8'),
    ('encoder', 'default_a8w8'), ('encoder', 'dynamic_wi4_afp32')])
def test_validate_matches_jax(model, recipe, metric):
  """Quantizer.validate (compare_model over every captured tensor, each
  tensor in its bucket) gives the JAX package's results."""
  jq, tq = _quantized_pair(model, recipe)
  data = jax_test_data.create_random_dataset(jq.float_model, num_samples=2)
  want = jq.validate(test_data=data, error_metrics=metric)
  got = tq.validate(test_data=data, error_metrics=metric, device='cpu')
  assert isinstance(got, model_validator.ComparisonResult)
  _assert_results_close(got, want)
  res = got.get_signature_comparison_result('serving_default')
  assert res.output_tensors and res.constant_tensors and res.input_tensors
  assert bool(res.intermediate_tensors) == (model != 'single_fc')


def test_outputs_only_and_default_data_match_jax():
  jq, tq = _quantized_pair('two_layer_mlp', 'dynamic_wi8_afp32')
  want = jq.validate(compare_outputs_only=True)
  got = tq.validate(compare_outputs_only=True, device='cpu')
  _assert_results_close(got, want)
  assert set(got.get_all_tensor_results()) == {'dense2/out'}
  want = jq.validate(num_samples=3)
  got = tq.validate(num_samples=3, device='cpu')
  _assert_results_close(got, want)


def test_save_and_model_explorer_json_match_jax(tmp_path):
  jq, tq = _quantized_pair('encoder', 'default_a8w8')
  data = jax_test_data.create_random_dataset(jq.float_model, num_samples=1)
  want = jq.validate(test_data=data)
  got = tq.validate(test_data=data, device='cpu')
  for result, sub in ((want, 'jax'), (got, 'port')):
    os.makedirs(tmp_path / sub)
    result.save(str(tmp_path / sub), 'enc')
  for suffix in ('_comparison_result.json',
                 '_comparison_result_me_input.json'):
    with open(tmp_path / 'jax' / f'enc{suffix}') as f:
      w = json.load(f)
    with open(tmp_path / 'port' / f'enc{suffix}') as f:
      g = json.load(f)
    assert _keys(g) == _keys(w)
    for (path, gv), (_, wv) in zip(_leaves(g), _leaves(w)):
      if isinstance(wv, float) and 'threshold' not in str(path):
        assert np.isclose(gv, wv, rtol=METRIC_RTOL, atol=1e-12), path
      elif not isinstance(wv, float):
        assert gv == wv, path
  thresholds = [0.0, 0.5, 2.0]
  me = json.loads(model_validator.create_json_for_model_explorer(
      got, thresholds))
  assert me == json.loads(jax_mv.create_json_for_model_explorer(
      got, thresholds))
  with pytest.raises(ValueError, match='already has results'):
    got.add_new_signature_results('mse', {}, 'serving_default')


def _keys(tree, prefix=()):
  if isinstance(tree, dict):
    return {k: _keys(v) for k, v in tree.items()}
  if isinstance(tree, list):
    return [_keys(v) for v in tree]
  return None


def _leaves(tree, path=()):
  if isinstance(tree, dict):
    for k in sorted(tree):
      yield from _leaves(tree[k], path + (k,))
  elif isinstance(tree, list):
    for i, v in enumerate(tree):
      yield from _leaves(v, path + (i,))
  else:
    yield path, tree


def test_serving_paths_capture_packed_weights_and_skip_fused_tensors():
  """compare_model with a packed serving executor (target_executor) and
  use_serving_paths: the norm-fused packed FC runs its kernel's plain
  version under capture, so the norm's output is absent and the packed
  weight comes back as its unpacked int4 view; without the serving paths
  the norm's output is captured, the FC's output the same."""
  rng = np.random.default_rng(0)
  b = builder.GraphBuilder('main')
  x = b.input('x', (4, 256))
  g = b.constant('norm/gamma', (rng.normal(size=256) * 0.1 + 1).astype(
      np.float32))
  n = b.op('RMS_NORM', [x, g], [(4, 256)], output_names=['norm/out'],
           attrs={'epsilon': 1e-6})
  y = b.fully_connected(n, (rng.normal(size=(256, 256)) * 0.05).astype(
      np.float32), None, name='fc')
  b.output(y)
  graph = b.finalize()
  qt = Quantizer(graph, 'dynamic_wi4_afp32')
  qmodel = qt.quantize().quantized_model
  ex = executor.GraphExecutor(qmodel, device='cpu',
                              activation_dtype='float32', norm_fusion=True)
  ex.prepare_serving_weights(min_weight_params=0)
  assert ex._norm_fusions and ex._packed_int4_keys
  inp = {'x': rng.standard_normal((4, 256)).astype(np.float32)}
  fast = ex.signature_runner(capture_all=True, serving_fastpaths=True)(inp)
  slow = ex.signature_runner(capture_all=True)(inp)
  assert 'norm/out' not in fast and 'norm/out' in slow
  np.testing.assert_allclose(fast['fc/out'], slow['fc/out'], rtol=1e-5,
                             atol=1e-5)
  w = qmodel.main_subgraph().tensor_by_name('fc/w')
  want_w = np.asarray(qmodel.buffers[w.buffer].data).reshape(w.shape)
  np.testing.assert_array_equal(fast['fc/w'], want_w)
  cmp = qt.validate(test_data={'serving_default': [inp]},
                    target_executor=ex, use_serving_paths=True, device='cpu')
  res = cmp.get_signature_comparison_result('serving_default')
  assert 'norm/out' not in res.intermediate_tensors
  assert res.constant_tensors['fc/w'] < 1e-3
  assert res.output_tensors['fc/out'] < 1e-1


def test_no_algorithm_is_unported():
  assert manager.UNPORTED_ALGORITHMS == {}
  assert manager.is_op_registered(manager.AlgorithmName.GPTQ,
                                  qtyping.OpName.FULLY_CONNECTED)


def _gptq_params(mod, qt_mod, w, bits, block):
  """Min-max params of `w` (per channel, or in blocks) as `mod` makes
  them, with the package's own qtyping."""
  if block:
    wb = w.reshape(w.shape[0], -1, block)
    scale = (np.max(np.abs(wb), axis=2) / (2 ** (bits - 1) - 1)).astype(
        np.float32)
  else:
    scale = (np.max(np.abs(w), axis=1, keepdims=True)
             / (2 ** (bits - 1) - 1)).astype(np.float32)
  return qt_mod.UniformQuantParams(
      num_bits=bits, quantized_dimension=0 if not block else 1,
      scale=scale, zero_point=np.zeros_like(scale, np.int32),
      symmetric=True, block_size=block)


@pytest.mark.parametrize('bits,block', [(4, 0), (8, 0), (4, 32)])
def test_apply_gptq_matches_jax_bit_for_bit(bits, block):
  """From one Hessian the port's GPTQ gives the JAX package's integer
  weights (and the host inverse its float64 LAPACK result)."""
  rng = np.random.default_rng(bits + block)
  w = (rng.normal(size=(48, 160)) * 0.1).astype(np.float32)
  x = rng.normal(size=(300, 160)).astype(np.float32)
  h = (2.0 / 300) * (x.T @ x)
  np.testing.assert_array_equal(gptq._inverse_via_cholesky_host(h, 0.01),
                                jax_gptq._inverse_via_cholesky_host(h, 0.01))
  want = jax_gptq.apply_gptq(w, _gptq_params(jax_gptq, jax_qtyping, w, bits,
                                             block), h)
  got = gptq.apply_gptq(w, _gptq_params(gptq, qtyping, w, bits, block), h)
  assert got.quantized_data.dtype == want.quantized_data.dtype
  np.testing.assert_array_equal(got.quantized_data, want.quantized_data)
  np.testing.assert_array_equal(got.scale, want.scale)


@pytest.mark.parametrize('dim', [64, 192])
def test_newton_schulz_inverse_matches_host_and_jax(dim, monkeypatch):
  """The device solve (here on the CPU) against the host's LAPACK inverse
  and the JAX package's solve, and the dispatch by the JAX package's
  AEQT_GPTQ_DEVICE_SOLVE_DIM."""
  rng = np.random.default_rng(dim)
  x = (rng.normal(size=(4 * dim, dim))
       * rng.uniform(0.05, 3.0, size=(1, dim))).astype(np.float32)
  h = (2.0 / x.shape[0]) * (x.T @ x)
  host = gptq._inverse_via_cholesky_host(h, 0.01)
  got = gptq._inverse_via_cholesky_device(h, 0.01, device='cpu')
  want = jax_gptq._inverse_via_cholesky_device(h, 0.01)
  assert got.dtype == np.float32 and got.shape == host.shape
  scale = np.max(np.abs(host))
  assert np.max(np.abs(got - host)) <= 1e-4 * scale
  assert np.max(np.abs(got - want)) <= 1e-4 * scale
  _, err, steps = gptq._newton_schulz_inverse(torch.as_tensor(h), 0.01)
  assert err <= 1e-5 and 0 < steps < 120
  monkeypatch.setenv('AEQT_GPTQ_DEVICE_SOLVE_DIM', str(dim))
  monkeypatch.setattr(gptq, 'SOLVE_DEVICE', 'cpu')
  np.testing.assert_array_equal(gptq._inverse_via_cholesky(h), got)


@pytest.mark.parametrize('mode', ['capture', 'device_stats'])
def test_gptq_recipe_through_quantizer_matches_jax(mode):
  """dynamic_wi4_afp32_gptq_octav: calibration (min, max, the FC inputs'
  Hessians) and quantization through both Quantizers. single_fc's
  Hessians are of the graph input, so each side's own calibration gives
  the JAX package's graph bit for bit; two_layer_mlp's second FC sees a
  computed activation, so the port quantizes from the JAX package's QSVs
  and then equals it too. The port's executor then runs the model."""
  recipe = 'dynamic_wi4_afp32_gptq_octav'
  for model in ('single_fc', 'two_layer_mlp'):
    jgraph = getattr(fixtures, model)()
    data = jax_test_data.create_random_dataset(jgraph, num_samples=3)
    jq, tq = JaxQuantizer(jgraph, recipe), Quantizer(to_port_graph(jgraph),
                                                     recipe)
    with pytest.raises(RuntimeError, match='QSVs'):
      tq.quantize()
    jqsv = jq.calibrate(data, calibration_mode=mode)
    tqsv = tq.calibrate(data, calibration_mode=mode, device='cpu')
    hessians = [n for n, v in jqsv.items() if 'hessian' in v]
    assert hessians and sorted(hessians) == sorted(
        n for n, v in tqsv.items() if 'hessian' in v)
    want = jq.quantize(jqsv).quantized_model
    got = tq.quantize(tqsv if model == 'single_fc' else jqsv).quantized_model
    assert graph_record(got) == graph_record(to_port_graph(want)), model
  out = executor.GraphExecutor(got, device='cpu', activation_dtype='float32',
                               **executor.JAX_DEFAULT_OPTIONS)(
                                   data['serving_default'][0])
  assert all(bool(torch.isfinite(v).all()) for v in out.values())
