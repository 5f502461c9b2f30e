"""Control flow in the port's executor (STABLEHLO_COMPOSITE, WHILE, IF) and
the calibrator's composite fallback, against the JAX package on the CPU.

The graphs are the JAX package's composite model (tests/test_composites.py)
and chip_smoke.control_flow_graphs built with the JAX package's IR builder
at D 256, 8 rows, 3 loop steps: each body holds a float FC (a signed
permutation, exact in any order of its sums) and an FC that
`dynamic_wi8_afp32`'s entry quantizes (int8 DRQ). Both packages quantize
them to equal graphs; both executors (the port's with float32 activations
and the JAX executor's default options) capture the same tensor names,
integers equal and floats within QSV_RTOL of the tensor's largest
magnitude (RMS_NORM's mean is an f64 sum in the port, an f32 one in the
JAX op). The DRQ FC inside a body takes the port's int8 DRQ path on every
iteration, as outside.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import test_composites
from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu import qtyping as jax_qtyping
from ai_edge_quantizer_tpu.execution.executor import GraphExecutor as JaxExecutor
from ai_edge_quantizer_tpu.graph import builder as jax_builder
from ai_edge_quantizer_tpu.graph import ir as jax_ir
from ai_edge_quantizer_tpu.ops import impl as jax_impl
from ai_edge_quantizer_tpu.pipeline import calibrator as jax_calibrator
from ai_edge_quantizer_tpu.recipe import recipe_manager as jax_rm
from ai_edge_quantizer_tpu.recipe import recipe_utils as jax_recipe_utils
from ai_edge_quantizer_tpu_torch import Quantizer, qtyping
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
from ai_edge_quantizer_tpu_torch.ops import impl
from ai_edge_quantizer_tpu_torch.pipeline import calibrator
from ai_edge_quantizer_tpu_torch.recipe import recipe_manager as rm
from ai_edge_quantizer_tpu_torch.utils import test_data

from test_torch_port_calibration import _assert_qsvs_close, _close
from test_torch_port_quantizer import graph_record, to_port_graph

D, ROWS, STEPS = 256, 8, 3
JAX_OPTS = dict(activation_dtype='float32', **executor.JAX_DEFAULT_OPTIONS)
DRQ = int_qmatmul.qmatmul_int8_drq


def _q_fc_recipe():
  """`dynamic_wi8_afp32` for the FCs whose scope names 'q_fc' only."""
  return [dict(entry, regex='.*q_fc.*')
          for entry in jax_recipe_utils.resolve_recipe('dynamic_wi8_afp32')]


@pytest.fixture(scope='module')
def flows():
  return chip_smoke.control_flow_graphs(jax_ir, jax_builder, D, ROWS, STEPS,
                                        float_fc=True)


def _quantized_pair(jgraph, recipe):
  """(JAX quantized graph, the port's) of one float graph; equal field by
  field."""
  jq = JaxQuantizer(jgraph, recipe).quantize().quantized_model
  tq = Quantizer(to_port_graph(jgraph), recipe).quantize().quantized_model
  assert graph_record(tq) == graph_record(to_port_graph(jq))
  return jq, tq


def _assert_captures_match(jgraph, tgraph, feed):
  """Both executors' capture of one call: the same tensor names (the outer
  subgraph's: a body's tensors stay inside its run in both), dtypes and
  shapes; integers equal, floats within QSV_RTOL."""
  want = JaxExecutor(jgraph).signature_runner(capture_all=True)(feed)
  got = executor.GraphExecutor(tgraph, device='cpu', **JAX_OPTS) \
      .signature_runner(capture_all=True)(feed)
  assert set(got) == set(want)
  for name, w in want.items():
    w, g = np.asarray(w), got[name]
    assert (g.dtype, g.shape) == (w.dtype, w.shape), name
    if np.issubdtype(w.dtype, np.floating):
      assert _close(g, w), name
    else:
      np.testing.assert_array_equal(g, w, err_msg=name)
  return got


def test_composite_impl_only_raises():
  """STABLEHLO_COMPOSITE is registered as in the JAX package, with an impl
  that only raises: the executor runs the body."""
  assert 'STABLEHLO_COMPOSITE' in impl.OPS and 'STABLEHLO_COMPOSITE' in \
      jax_impl.OPS
  with pytest.raises(NotImplementedError, match='side-effect subgraphs'):
    impl.OPS['STABLEHLO_COMPOSITE'](None)


@pytest.mark.parametrize('recipe', [None, 'dynamic_wi8_afp32'])
def test_composite_model_matches_jax(recipe):
  """tests/test_composites.py's model (FC, then an odml.rms_norm composite
  whose body is an RMS_NORM), float and quantized: the same capture."""
  jgraph = test_composites._composite_model()
  if recipe is None:
    jq, tq = jgraph, to_port_graph(jgraph)
  else:
    jq, tq = _quantized_pair(jgraph, recipe)
  x = np.random.default_rng(1).standard_normal((2, 16)).astype(np.float32)
  got = _assert_captures_match(jq, tq, {'x': x})
  assert 'composite/out' in got and 'body/out' not in got


def test_non_quantizable_composite_keeps_its_body_float():
  """A composite that is not whitelisted is an opaque barrier: its body
  stays float, the FC outside quantizes (test_composites.py:58); the two
  packages' graphs are equal, and so are their captures."""
  jgraph = test_composites._composite_model('vendor.custom_thing')
  jq, tq = _quantized_pair(jgraph, 'dynamic_wi8_afp32')
  main = tq.subgraphs[tq.signatures[0].subgraph_index]
  assert main.tensor_by_name('fc/w').dtype == 'int8'
  assert all(t.dtype == 'float32' for t in tq.subgraphs[0].tensors)
  x = np.random.default_rng(2).standard_normal((2, 16)).astype(np.float32)
  _assert_captures_match(jq, tq, {'x': x})


@pytest.mark.parametrize('name', ['composite', 'while', 'if'])
def test_control_flow_graph_matches_jax(flows, name):
  """chip_smoke's control-flow graphs with `dynamic_wi8_afp32` on the
  'q_fc' FCs: equal quantized graphs, the same capture (the IF with the
  predicate true and false), every q_fc through the int8 DRQ plain version
  once a call of its body (the WHILE's on each of its STEPS iterations);
  the 'f_fc' FCs stay float."""
  jq, tq = _quantized_pair(flows[name], _q_fc_recipe())
  weights = {t.name: t.dtype for sg in tq.subgraphs for t in sg.tensors
             if t.name.endswith('_fc/w')}
  assert weights and all(
      dtype == ('int8' if '/q_fc/' in n else 'float32')
      for n, dtype in weights.items()), weights
  per_call = {'composite': 2, 'while': STEPS, 'if': 1}[name]
  for feed in chip_smoke.control_flow_feeds(name, ROWS, D):
    before = (DRQ.plain_calls, DRQ.launches)
    _assert_captures_match(jq, tq, feed)
    assert (DRQ.plain_calls - before[0], DRQ.launches) == (
        per_call, before[1])


def test_while_carry_keeps_its_dtypes(flows):
  """The WHILE's outputs after its last iteration in the JAX executor's
  dtypes: the int32 counter at STEPS, the float carry in the activation
  dtype; a loop that never runs returns its inputs."""
  graph = to_port_graph(flows['while'])
  x = chip_smoke.control_flow_feeds('while', ROWS, D)[0]['x']
  for act, dtype in (('float32', torch.float32),
                     ('bfloat16', torch.bfloat16)):
    out = executor.GraphExecutor(graph, device='cpu', activation_dtype=act)(
        {'x': x})
    assert out['count'].dtype == torch.int32 and int(out['count']) == STEPS
    assert out['y'].dtype == dtype
  cond = graph.subgraphs[0]
  n_tid = next(t for t in cond.tensors if t.name == 'cond/n')
  graph.buffers[n_tid.buffer].data = np.asarray(0, np.int32)
  out = executor.GraphExecutor(graph, device='cpu', **JAX_OPTS)({'x': x})
  assert int(out['count']) == 0
  np.testing.assert_array_equal(out['y'].numpy(), x)


def _recipes():
  """The JAX test's a8w8 min-max recipe (test_device_stats_calibration.py
  `_recipe`) in each package's recipe manager."""
  def make(rm_mod, qt):
    mgr = rm_mod.RecipeManager()
    mgr.add_quantization_config(
        '.*', qt.OpName.ALL_SUPPORTED,
        qt.OpQuantizationConfig(
            activation_tensor_config=qt.TensorQuantizationConfig(
                num_bits=8, symmetric=False),
            weight_tensor_config=qt.TensorQuantizationConfig(
                num_bits=8, symmetric=True),
            compute_precision=qt.ComputePrecision.INTEGER),
        algorithm_key='min_max_uniform_quantize')
    return mgr
  return make(jax_rm, jax_qtyping), make(rm, qtyping)


def test_device_stats_composite_falls_back_to_capture(monkeypatch):
  """tests/test_device_stats_calibration.py:125 in the port: a composite
  model's plan reaches the body subgraph, so device_stats calibrates by
  capture (no statistics runner is made); its QSVs equal capture's and
  the JAX package's."""
  jgraph = test_composites._composite_model()
  tgraph = to_port_graph(jgraph)
  jmgr, tmgr = _recipes()
  data = test_data.create_random_dataset(tgraph, num_samples=2)
  jcal = jax_calibrator.Calibrator(jgraph, mode='device_stats')
  jcal.calibrate(data, jmgr)

  def no_stats(*args, **kwargs):
    raise AssertionError('device_stats did not fall back to capture')

  qsvs = {}
  for mode in ('capture', 'device_stats'):
    cal = calibrator.Calibrator(tgraph, mode=mode, device='cpu')
    monkeypatch.setattr(cal._executor, 'stats_runner', no_stats)
    cal.calibrate(data, tmgr)
    qsvs[mode] = cal.get_model_qsvs()
  assert qsvs['capture'] and set(qsvs['capture']) == set(
      qsvs['device_stats'])
  for name, entry in qsvs['capture'].items():
    for field, value in entry.items():
      np.testing.assert_array_equal(qsvs['device_stats'][name][field], value)
  _assert_qsvs_close(jcal.get_model_qsvs(), qsvs['device_stats'])
