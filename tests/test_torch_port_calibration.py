"""The port's calibration (runners, Calibrator, Quantizer.calibrate, the
QSV JSON and alignment utilities, static recipes) against the JAX
package's, on the CPU.

The graphs are tests/fixtures.py's (carried to the port's IR field by
field) and a small encoder (models/encoder.py at narrow widths, which
both packages build from one seed). Float inputs and every tensor that
both executors compute with the same arithmetic give the same min and
max; a float FULLY_CONNECTED or BATCH_MATMUL output (and what depends on
it) is summed in another order by XLA's CPU dot than by PyTorch's CPU
matmul (at K 32 a batched dot runs four interleaved FMA chains added as a
tree), so its min and max are held to QSV_RTOL of the tensor's largest
magnitude.
Given the same captured tensors, the port's calibration gives the JAX
package's QSVs exactly; given the same QSVs, the static recipes give the
same quantized graph.
"""

import json
import os

import numpy as np
import pytest

import fixtures
from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu.execution import executor as jax_executor
from ai_edge_quantizer_tpu.models import encoder as jax_encoder
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.pipeline import calibrator as jax_calibrator
from ai_edge_quantizer_tpu.utils import calibration_utils as jax_cu
from ai_edge_quantizer_tpu.utils import test_data as jax_test_data
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.models import encoder
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.pipeline import calibrator
from ai_edge_quantizer_tpu_torch.utils import calibration_utils
from ai_edge_quantizer_tpu_torch.utils import test_data

from test_torch_port_quantizer import graph_record, to_port_graph

FC_FIXTURES = ('single_fc', 'two_layer_mlp', 'shared_weight_two_fc',
               'shared_buffer_two_tensors')
MODES = ('capture', 'device_stats')
# A narrow BERT-class encoder: 2 layers, D 64, 2 heads of 32, FFN 128.
SMALL_ENCODER = dict(vocab_size=512, seq_len=16, embed_dim=64, num_layers=2,
                     num_heads=2, ffn_dim=128, num_classes=8)
# How far the two packages' min or max of a tensor that a float matmul
# computed may be apart (the sums' orders above), as a share of the
# tensor's largest magnitude; and of any float tensor they compute.
QSV_RTOL = 1e-5
JAX_OPTS = dict(activation_dtype='float32', **executor.JAX_DEFAULT_OPTIONS)


def _pair(model):
  """(JAX graph, port graph) of one float model."""
  if model == 'encoder':
    return (jax_encoder.build_encoder(
        jax_encoder.EncoderConfig(**SMALL_ENCODER), batch=2),
            encoder.build_encoder(encoder.EncoderConfig(**SMALL_ENCODER),
                                  batch=2))
  jgraph = getattr(fixtures, model)()
  return jgraph, to_port_graph(jgraph)


def _close(got, want, rtol=QSV_RTOL) -> bool:
  """|got - want| within rtol of want's largest magnitude."""
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return bool(np.max(np.abs(got - want), initial=0) <= rtol * max(
      np.max(np.abs(want), initial=0), 1e-30))


def _assert_qsvs_close(jqsv, tqsv, exact=()):
  """Same tensors and fields; min and max within QSV_RTOL of the tensor's
  largest magnitude (equal for the names in `exact`), Hessians to 1e-5,
  other fields equal."""
  assert set(jqsv) == set(tqsv)
  for name, jv in jqsv.items():
    tv = tqsv[name]
    assert set(jv) == set(tv), name
    scale = max((np.max(np.abs(np.asarray(jv[f]))) for f in ('min', 'max')
                 if f in jv), default=0.0)
    for field, a in jv.items():
      b = tv[field]
      a, b = np.asarray(a), np.asarray(b)
      assert a.shape == b.shape and a.dtype == b.dtype, (name, field)
      if field in ('min', 'max') and name in exact:
        np.testing.assert_array_equal(b, a, err_msg=f'{name} {field}')
      elif field in ('min', 'max'):
        assert np.abs(float(a.reshape(-1)[0]) - float(b.reshape(-1)[0])) \
            <= QSV_RTOL * scale, (name, field, a, b)
      elif field == 'hessian':
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
      else:
        np.testing.assert_array_equal(b, a, err_msg=name)


def _inputs_of(graph):
  sig = graph.signatures[0]
  sg = graph.subgraphs[sig.subgraph_index]
  return {sg.tensors[t].name for t in sig.inputs.values()}


@pytest.fixture(scope='module')
def encoder_pair():
  return _pair('encoder')


@pytest.fixture(scope='module')
def encoder_jax_qsvs(encoder_pair):
  """The JAX package's a8w8 QSVs of the small encoder in each mode, and
  the data they came from."""
  jgraph, _ = encoder_pair
  data = jax_test_data.create_random_dataset(jgraph, num_samples=3)
  return data, {mode: JaxQuantizer(jgraph, 'default_a8w8').calibrate(
      data, calibration_mode=mode) for mode in MODES}


@pytest.mark.parametrize('method', ['normal', 'uniform'])
@pytest.mark.parametrize('model', FC_FIXTURES + ('encoder',))
def test_random_dataset_matches_jax(model, method):
  jgraph, tgraph = _pair(model)
  want = jax_test_data.create_random_dataset(jgraph, num_samples=3, seed=7,
                                             method=method)
  got = test_data.create_random_dataset(tgraph, num_samples=3, seed=7,
                                        method=method)
  assert set(got) == set(want)
  for key in want:
    for w, g in zip(want[key], got[key], strict=True):
      assert set(w) == set(g)
      for name in w:
        assert g[name].dtype == w[name].dtype
        np.testing.assert_array_equal(g[name], w[name])


def test_encoder_graph_and_inputs_match_jax(encoder_pair):
  """Both builders draw the encoder's weights and inputs from one seed."""
  jgraph, tgraph = encoder_pair
  assert graph_record(tgraph) == graph_record(to_port_graph(jgraph))
  cfg = encoder.EncoderConfig(**SMALL_ENCODER)
  want = jax_encoder.make_inputs(jax_encoder.EncoderConfig(**SMALL_ENCODER),
                                 3, seed=5)
  got = encoder.make_inputs(cfg, 3, seed=5)
  for name in want:
    np.testing.assert_array_equal(got[name], want[name])
  assert encoder.BERT_BASE_LITE == encoder.EncoderConfig(
      **vars(jax_encoder.BERT_BASE_LITE))


@pytest.mark.parametrize('model', FC_FIXTURES + ('encoder',))
def test_runners_match_jax(model):
  """signature_runner (outputs, and every tensor under capture_all) and
  stats_runner (min, max, Hessians of the chosen names) against the JAX
  executor's; numpy arrays on the host in both."""
  jgraph, tgraph = _pair(model)
  sample = jax_test_data.create_random_dataset(
      jgraph, num_samples=1, seed=3)['serving_default'][0]
  jex = jax_executor.GraphExecutor(jgraph)
  tex = executor.GraphExecutor(tgraph, device='cpu', **JAX_OPTS)
  for capture in (False, True):
    want = jex.signature_runner(capture_all=capture)(sample)
    got = tex.signature_runner(capture_all=capture)(sample)
    assert set(got) == set(want)
    for name, w in want.items():
      w = np.asarray(w)
      assert isinstance(got[name], np.ndarray)
      assert got[name].dtype == w.dtype and got[name].shape == w.shape
      if w.dtype == np.float32:
        assert _close(got[name], w), name
      else:
        np.testing.assert_array_equal(got[name], w, err_msg=name)
  consts = {t.name for t in jgraph.subgraphs[0].tensors if t.buffer >= 0
            and jgraph.buffers[t.buffer].data is not None}
  names = sorted(n for n, v in want.items()
                 if np.asarray(v).dtype == np.float32
                 and np.asarray(v).ndim >= 2 and n not in consts)[:3]
  jstats = jex.stats_runner(hessian_tensor_names=names)(sample)
  tstats = tex.stats_runner(hessian_tensor_names=names)(sample)
  _assert_qsvs_close(
      {k: {f: np.asarray(x) for f, x in v.items()} for k, v in
       jstats.items()}, tstats, exact=_inputs_of(jgraph))
  for name in names:
    assert tstats[name]['num_samples'].dtype == np.int32


@pytest.mark.parametrize('model', FC_FIXTURES + ('encoder',))
def test_stats_equal_capture(model):
  """On one device the two modes see the same tensors: device_stats' min
  and max equal the capture's exactly, its Hessians numpy's 2/n X^T X."""
  _, tgraph = _pair(model)
  sample = test_data.create_random_dataset(tgraph, num_samples=1)[
      'serving_default'][0]
  tex = executor.GraphExecutor(tgraph, device='cpu', **JAX_OPTS)
  cap = tex.signature_runner(capture_all=True)(sample)
  floats = sorted(n for n, v in cap.items() if v.dtype == np.float32
                  and n not in {t.name for t in tgraph.subgraphs[0].tensors
                                if t.buffer >= 0})
  stats = tex.stats_runner(hessian_tensor_names=floats)(sample)
  assert sorted(stats) == floats
  for name in floats:
    v = cap[name]
    np.testing.assert_array_equal(stats[name]['min'],
                                  np.min(v).reshape((1,) * v.ndim))
    np.testing.assert_array_equal(stats[name]['max'],
                                  np.max(v).reshape((1,) * v.ndim))
    x = v.reshape(-1, v.shape[-1]).astype(np.float64)
    np.testing.assert_allclose(stats[name]['hessian'],
                               (2.0 / v.shape[0]) * (x.T @ x), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('model', FC_FIXTURES)
def test_calibrate_matches_jax(model, mode):
  jgraph, tgraph = _pair(model)
  data = jax_test_data.create_random_dataset(jgraph, num_samples=3)
  want = JaxQuantizer(jgraph, 'default_a8w8').calibrate(
      data, calibration_mode=mode)
  got = Quantizer(tgraph, 'default_a8w8').calibrate(
      data, calibration_mode=mode, device='cpu')
  _assert_qsvs_close(want, got, exact=_inputs_of(jgraph))


@pytest.mark.parametrize('mode', MODES)
def test_encoder_calibrate_matches_jax(mode, encoder_pair, encoder_jax_qsvs):
  _, tgraph = encoder_pair
  data, want = encoder_jax_qsvs
  got = Quantizer(tgraph, 'default_a8w8').calibrate(
      data, calibration_mode=mode, device='cpu')
  _assert_qsvs_close(want[mode], got, exact=_inputs_of(tgraph))


@pytest.mark.parametrize('model', ('two_layer_mlp', 'encoder'))
def test_calibration_is_exact_given_jax_tensors(model, monkeypatch):
  """The port's Calibrator fed the JAX executor's captured tensors gives
  the JAX package's QSVs bit for bit: the calibration arithmetic is the
  same; only the executors' float sums differ."""
  jgraph, tgraph = _pair(model)
  data = jax_test_data.create_random_dataset(jgraph, num_samples=3)
  want = JaxQuantizer(jgraph, 'default_a8w8').calibrate(data)
  jex = jax_executor.GraphExecutor(jgraph)

  def jax_runner(self, signature_key='serving_default', capture_all=False,
                 serving_fastpaths=False):
    run = jex.signature_runner(signature_key, capture_all=capture_all)
    return lambda inputs: {k: np.asarray(v) for k, v in run(inputs).items()}

  monkeypatch.setattr(executor.GraphExecutor, 'signature_runner', jax_runner)
  got = Quantizer(tgraph, 'default_a8w8').calibrate(data, device='cpu')
  _assert_qsvs_close(want, got, exact=set(want))


def test_json_round_trip_matches_jax(tmp_path, encoder_pair,
                                     encoder_jax_qsvs):
  """The port's QSV JSON is the JAX package's, text for text; each loads
  the other's; a saved calibration resumes with its sample count."""
  _, tgraph = encoder_pair
  data, want = encoder_jax_qsvs
  qsvs = want['capture']
  text = calibration_utils.qsvs_to_json(qsvs, num_samples=3,
                                        extra_metadata={'run': 'a'})
  assert text == jax_cu.qsvs_to_json(qsvs, num_samples=3,
                                     extra_metadata={'run': 'a'})
  for loader in (calibration_utils.qsvs_from_json, jax_cu.qsvs_from_json):
    back, meta = loader(text)
    assert meta == {'num_samples_calibrated': 3, 'run': 'a'}
    _assert_qsvs_close(qsvs, back, exact=set(qsvs))
    assert all(v.dtype == qsvs[n][f].dtype for n, d in back.items()
               for f, v in d.items() if isinstance(v, np.ndarray))
  # Calibrate, save, resume from the file: the count keeps growing, and
  # the resumed QSVs are the JAX package's resumed ones.
  rm = Quantizer(tgraph, 'default_a8w8')._recipe_manager
  calib = calibrator.Calibrator(tgraph, device='cpu')
  calib.calibrate({'serving_default': data['serving_default'][:2]}, rm)
  path = os.path.join(tmp_path, 'qsvs.json')
  calib.save_calibration_result(path)
  with open(path) as f:
    assert json.load(f)['__calibration_metadata__'] == {
        'num_samples_calibrated': 2}
  resumed = calibrator.Calibrator(tgraph, device='cpu')
  resumed.load_model_qsvs(path)
  assert resumed.get_num_samples_calibrated() == 2
  resumed.calibrate({'serving_default': data['serving_default'][2:]}, rm)
  assert resumed.get_num_samples_calibrated() == 3
  jgraph = encoder_pair[0]
  jcalib = jax_calibrator.Calibrator(jgraph)
  jcalib.load_model_qsvs(path)
  jcalib.calibrate({'serving_default': data['serving_default'][2:]},
                   JaxQuantizer(jgraph, 'default_a8w8')._recipe_manager)
  _assert_qsvs_close(jcalib.get_model_qsvs(), resumed.get_model_qsvs(),
                     exact=_inputs_of(jgraph))
  resumed.reset_model_qsvs()
  assert resumed.get_model_qsvs() == {}
  assert resumed.get_num_samples_calibrated() == 0


def test_calibrating_runner_matches_jax():
  """Calibrator.signature_runner returns the signature's outputs and
  accumulates QSVs as it runs (the JAX package's calibrate-while-running
  wrapper), call for call."""
  jgraph, tgraph = _pair('two_layer_mlp')
  jq, tq = JaxQuantizer(jgraph, 'default_a8w8'), Quantizer(tgraph,
                                                           'default_a8w8')
  jcal = jax_calibrator.Calibrator(jgraph)
  tcal = calibrator.Calibrator(tgraph, device='cpu')
  jrun = jcal.signature_runner('serving_default', jq._recipe_manager)
  trun = tcal.signature_runner('serving_default', tq._recipe_manager)
  rng = np.random.default_rng(0)
  for _ in range(4):
    x = {'x': rng.standard_normal((2, 64)).astype(np.float32)}
    want, got = jrun(x), trun(x)
    assert set(got) == {'out'} == set(want)
    assert _close(got['out'], want['out'])
  assert tcal.get_num_samples_calibrated() == 4
  _assert_qsvs_close(jcal.get_model_qsvs(), tcal.get_model_qsvs(),
                     exact=_inputs_of(jgraph))
  res = tq.quantize(tcal.get_model_qsvs())
  assert all(t.dtype.startswith('int')
             for t in res.quantized_model.main_subgraph().tensors)


def test_inference_only_and_unknown_modes():
  _, tgraph = _pair('two_layer_mlp')
  calib = calibrator.Calibrator(tgraph, mode='inference_only', device='cpu')
  with pytest.raises(NotImplementedError):
    calib.calibrate({'serving_default': []}, None)
  with pytest.raises(ValueError):
    calibrator.Calibrator(tgraph, mode='bogus', device='cpu')


def test_alignment_matches_jax():
  """CalibrationQsvAlignmentUtils unifies the KV cache ranges across the
  prefill and decode signatures as the JAX package does (given the same
  QSVs: every tensor of the toy decoder with its own random range)."""
  jgraph = jax_gemma.build_decoder(jax_gemma.TOY_DECODER)
  tgraph = gemma.build_decoder(gemma.TOY_DECODER)
  assert graph_record(tgraph) == graph_record(to_port_graph(jgraph))
  rng = np.random.default_rng(0)
  qsvs = {t.name: {'min': rng.uniform(-2, 0, (1, 1)).astype(np.float32),
                   'max': rng.uniform(0, 2, (1, 1)).astype(np.float32)}
          for sg in jgraph.subgraphs for t in sg.tensors}
  want = {k: dict(v) for k, v in qsvs.items()}
  got = {k: dict(v) for k, v in qsvs.items()}
  jalign = jax_cu.CalibrationQsvAlignmentUtils(jgraph)
  talign = calibration_utils.CalibrationQsvAlignmentUtils(tgraph)
  for li in range(gemma.TOY_DECODER.num_layers):
    for kind in ('k', 'v'):
      pairs = [('prefill', f'layer_{li}_{kind}_cache'),
               ('decode', f'layer_{li}_{kind}_cache'),
               ('decode', f'layer_{li}_{kind}_cache_in')]
      jalign.align_quant_stats(want, pairs)
      talign.align_quant_stats(got, pairs)
  assert got.keys() == want.keys()
  assert all(np.array_equal(got[k][f], want[k][f]) for k in want
             for f in want[k])
  assert got != qsvs
  with pytest.raises(ValueError, match='not an input or output'):
    talign.align_quant_stats(got, [('decode', 'nope')])


@pytest.mark.parametrize('recipe', ['default_a8w8', 'default_a16w8'])
@pytest.mark.parametrize('model', ('single_fc', 'two_layer_mlp', 'encoder'))
def test_static_recipes_match_jax_given_qsvs(model, recipe):
  """Given the JAX package's QSVs, the static recipes give the JAX
  package's quantized graph in every op, tensor, buffer byte and
  quantization parameter."""
  jgraph, tgraph = _pair(model)
  jq = JaxQuantizer(jgraph, recipe)
  qsvs = jq.calibrate(jax_test_data.create_random_dataset(jgraph,
                                                          num_samples=2))
  want = jq.quantize(qsvs).quantized_model
  got = Quantizer(tgraph, recipe).quantize(qsvs).quantized_model
  assert graph_record(got) == graph_record(to_port_graph(want))
