"""The port's static-range (SRQ) execution against the JAX package's, on
the CPU: `qmatmul.srq_matmul` (int32 accumulators bit for bit), the FC's
SRQ branch and `_try_srq_int_bmm` with the adjoint flags (as the JAX
package's tests/test_srq_integer_paths.py holds them), the GATHER and TANH
ops, and a small encoder calibrated and run a8w8 and a16w8.

The graphs and their QSVs are the JAX package's (the QSVs from its
calibration; test_torch_port_calibration.py holds the port's own), so both
executors run the same quantized graph. Integer products are exact on
both sides; what follows one (y = acc * (s_x * s_w) + bias, then the
output's quantize) is float32 arithmetic, which XLA on the CPU may
contract into an FMA where the port rounds the product first, so an int8
code may round the other way at a tie: codes are held to one step, and
to at most FLIP_SHARE of a tensor's elements.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fixtures
from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu.execution import executor as jax_executor
from ai_edge_quantizer_tpu.graph.builder import GraphBuilder
from ai_edge_quantizer_tpu.kernels import qmatmul as jax_qmm
from ai_edge_quantizer_tpu.models import encoder as jax_encoder
from ai_edge_quantizer_tpu.utils import test_data as jax_test_data
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.kernels import qmatmul
from ai_edge_quantizer_tpu_torch.models import encoder

from test_torch_port_calibration import SMALL_ENCODER
from test_torch_port_quantizer import graph_record, to_port_graph

RNG = np.random.default_rng(0)
# Share of a quantized tensor's codes that may differ by one step between
# the two executors (an FMA-contracted float multiply-add at a tie).
FLIP_SHARE = 1e-3
JAX_OPTS = dict(activation_dtype='float32', **executor.JAX_DEFAULT_OPTIONS)


def _quantize_both(jgraph, recipe='default_a8w8', samples=16):
  """(JAX quantized graph, the port's from the same QSVs)."""
  jq = JaxQuantizer(jgraph, recipe)
  qsvs = jq.calibrate(jax_test_data.create_random_dataset(
      jgraph, num_samples=samples))
  want = jq.quantize(qsvs).quantized_model
  got = Quantizer(to_port_graph(jgraph), recipe).quantize(
      qsvs).quantized_model
  assert graph_record(got) == graph_record(to_port_graph(want))
  return want, got


def _run_both(jgraph, tgraph, inputs, monkeypatch, srq_int=True,
              capture_all=False):
  monkeypatch.setenv('AEQT_SRQ_INT', '1' if srq_int else '0')
  want = jax_executor.GraphExecutor(jgraph).signature_runner(
      capture_all=capture_all)(inputs)
  got = executor.GraphExecutor(tgraph, device='cpu', srq_int=srq_int,
                               **JAX_OPTS).signature_runner(
                                   capture_all=capture_all)(inputs)
  return {k: np.asarray(v) for k, v in want.items()}, got


def _codes_agree(got, want, steps=1, share=FLIP_SHARE, name=''):
  assert got.dtype == want.dtype and got.shape == want.shape, name
  diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
  assert diff.max(initial=0) <= steps, (name, diff.max())
  assert np.mean(diff > 0) <= share, (name, np.mean(diff > 0))


@pytest.mark.parametrize('case', [
    ((5, 64), 16, 3, False), ((2, 7, 256), 128, -128, False),
    ((33, 2048), 96, 127, False), ((4, 3, 1100), 40, 0, True)])
def test_srq_matmul_accumulators_match_jax(case):
  """The int32 accumulator x_q . w_q^T - zp * rowsum(w_q) equals XLA's
  int32 dot bit for bit (K above one exact chunk too), and the scaled
  output equals the JAX function's up to the FMA contraction."""
  x_shape, n, zp, scalar_scale = case
  rng = np.random.default_rng(sum(x_shape) + n)
  k = x_shape[-1]
  x_q = rng.integers(-128, 128, x_shape).astype(np.int8)
  w_q = rng.integers(-127, 128, (n, k)).astype(np.int8)
  ws = (rng.random(1 if scalar_scale else n) * 0.02 + 0.01).astype(
      np.float32)
  bias = rng.normal(size=n).astype(np.float32)
  xs = np.float32(0.05)
  want_acc = np.asarray(jax.lax.dot_general(
      jnp.asarray(x_q), jnp.asarray(w_q),
      dimension_numbers=(((x_q.ndim - 1,), (1,)), ((), ())),
      preferred_element_type=jnp.int32)) - zp * w_q.astype(np.int32).sum(1)
  acc = qmatmul.int_matmul_exact(torch.from_numpy(x_q), torch.from_numpy(w_q))
  got_acc = (acc - zp * torch.sum(torch.from_numpy(w_q).to(torch.int32),
                                  dim=1, dtype=torch.int32)).numpy()
  assert got_acc.dtype == np.int32
  np.testing.assert_array_equal(got_acc, want_acc)
  want = np.asarray(jax_qmm.srq_matmul(
      jnp.asarray(x_q), xs, zp, jnp.asarray(w_q), jnp.asarray(ws),
      bias=jnp.asarray(bias)))
  got = qmatmul.srq_matmul(torch.from_numpy(x_q), xs, zp,
                           torch.from_numpy(w_q), torch.from_numpy(ws),
                           bias=torch.from_numpy(bias)).numpy()
  assert got.dtype == np.float32 and got.shape == want.shape
  # One rounding of acc * s apart at most (XLA may fuse the bias add).
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=2e-7 * np.max(np.abs(want)))
  exact = ((x_q.astype(np.float64) - zp) * xs) @ (
      w_q.astype(np.float64) * ws.reshape(-1)[:, None] * np.ones((n, 1))).T
  np.testing.assert_allclose(got, exact + bias, rtol=1e-5, atol=1e-5)


def test_int_bmm_exact_is_the_integer_product():
  rng = np.random.default_rng(3)
  a = rng.integers(-128, 128, (2, 3, 5, 1500)).astype(np.int8)
  b = rng.integers(-128, 128, (2, 1, 1500, 7)).astype(np.int8)
  got = qmatmul.int_bmm_exact(torch.from_numpy(a), torch.from_numpy(b))
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(
      got.numpy(), np.matmul(a.astype(np.int64), b.astype(np.int64)))


def test_integer_fc_matches_jax_and_engages(monkeypatch):
  """A static-range int8 FC runs srq_matmul (counted) and gives the JAX
  executor's codes; with srq_int off (AEQT_SRQ_INT=0) the
  dequantize-first fallback gives the JAX fallback's, and the two paths
  one quantization step apart at most (the JAX package's rule)."""
  jgraph = fixtures.two_layer_mlp(in_dim=256, hidden=128, out_dim=32,
                                  batch=4)
  want_g, got_g = _quantize_both(jgraph)
  inputs = {'x': RNG.normal(size=(4, 256)).astype(np.float32)}
  calls = []
  orig = qmatmul.srq_matmul
  monkeypatch.setattr(qmatmul, 'srq_matmul',
                      lambda *a, **k: calls.append(1) or orig(*a, **k))
  outs = {}
  for srq in (True, False):
    want, got = _run_both(want_g, got_g, inputs, monkeypatch, srq,
                          capture_all=True)
    assert set(got) == set(want)
    for name, w in want.items():
      if w.dtype == np.int8:
        _codes_agree(got[name], w, name=name)
      elif w.dtype == np.float32:
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-6)
      else:
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    outs[srq] = got
    assert len(calls) == 2, calls  # the two FCs, in the srq_int run only
  for name, v in outs[True].items():
    if v.dtype == np.int8:
      assert np.max(np.abs(v.astype(int) - outs[False][name])) <= 1, name


def _bmm_graph(adj_x=False, adj_y=False):
  b = GraphBuilder('main')
  p = b.input('p', (2, 4, 32, 8) if adj_x else (2, 4, 8, 32))
  q = b.input('q', (2, 4, 8, 32) if adj_y else (2, 4, 32, 8))
  attrs = {'adj_x': adj_x, 'adj_y': adj_y}
  z = b.op('BATCH_MATMUL', [p, q], [(2, 4, 8, 8)], output_names=['z'],
           attrs=attrs)
  y = b.unary('SOFTMAX', z, name='probs')
  b.output(z, user_name='z')
  b.output(y, user_name='probs')
  return b.finalize()


@pytest.mark.parametrize('adj', [(False, False), (True, False),
                                 (False, True)])
def test_integer_bmm_matches_jax(adj, monkeypatch):
  """The SRQ BATCH_MATMUL's closed-form zero points through the integer
  product (the score / context matmuls of attention), the adjoint flags
  applied before it: the JAX executor's codes, counted through
  int_bmm_exact; and within one step of the dequantize-first path."""
  jgraph = _bmm_graph(*adj)
  want_g, got_g = _quantize_both(jgraph)
  sig = want_g.signatures[0]
  sg = want_g.subgraphs[0]
  inputs = {name: RNG.normal(size=sg.tensors[tid].shape).astype(np.float32)
            for name, tid in sig.inputs.items()}
  calls = []
  orig = qmatmul.int_bmm_exact
  monkeypatch.setattr(qmatmul, 'int_bmm_exact',
                      lambda *a: calls.append(1) or orig(*a))
  want, got = _run_both(want_g, got_g, inputs, monkeypatch, True)
  assert calls == [1]
  for name in want:
    _codes_agree(got[name], want[name], name=name)
  _, fallback = _run_both(want_g, got_g, inputs, monkeypatch, False)
  assert calls == [1]
  for name in want:
    assert np.max(np.abs(got[name].astype(int) - fallback[name])) <= 1


@pytest.mark.parametrize('axis', [0, 1, -1])
def test_gather_and_tanh_match_jax(axis):
  """GATHER (jnp.take over an axis, any index shape) and TANH through both
  executors, float and on a constant table."""
  rng = np.random.default_rng(1)
  b = GraphBuilder('main')
  table = rng.normal(size=(6, 5, 4)).astype(np.float32)
  t = b.constant('table', table)
  idx_shape = (2, 3)
  dim = table.shape[axis]
  out_shape = list(table.shape)
  out_shape[axis % 3:axis % 3 + 1] = idx_shape
  idx = b.input('idx', idx_shape, 'int32')
  g = b.op('GATHER', [t, idx], [tuple(out_shape)], output_names=['g'],
           attrs={'axis': axis})
  y = b.unary('TANH', g, name='y')
  b.output(y, user_name='y')
  jgraph = b.finalize()
  inputs = {'idx': rng.integers(0, dim, idx_shape).astype(np.int32)}
  want = jax_executor.GraphExecutor(jgraph).signature_runner(
      capture_all=True)(inputs)
  got = executor.GraphExecutor(to_port_graph(jgraph), device='cpu',
                               **JAX_OPTS).signature_runner(
                                   capture_all=True)(inputs)
  np.testing.assert_array_equal(got['g'], np.asarray(want['g']))
  np.testing.assert_array_equal(got['g'], np.take(table, inputs['idx'],
                                                  axis=axis))
  # tanh: an ulp apart at most between XLA's and PyTorch's CPU tanh.
  np.testing.assert_allclose(got['y'], np.asarray(want['y']), rtol=3e-7,
                             atol=0)


@pytest.fixture(scope='module')
def encoder_runs():
  """The small encoder quantized a8w8 and a16w8 from the JAX package's
  QSVs (calibrated over 4 random samples), run by both executors with
  every tensor captured on one input; also the JAX float model's
  outputs."""
  cfg = jax_encoder.EncoderConfig(**SMALL_ENCODER)
  jgraph = jax_encoder.build_encoder(cfg, batch=2)
  tgraph = encoder.build_encoder(encoder.EncoderConfig(**SMALL_ENCODER),
                                 batch=2)
  assert graph_record(tgraph) == graph_record(to_port_graph(jgraph))
  inputs = jax_encoder.make_inputs(cfg, 2, seed=3)
  runs = {}
  for recipe in ('default_a8w8', 'default_a16w8'):
    jq = JaxQuantizer(jgraph, recipe)
    qsvs = jq.calibrate(jax_test_data.create_random_dataset(jgraph,
                                                            num_samples=4))
    jq_graph = jq.quantize(qsvs).quantized_model
    tq_graph = Quantizer(tgraph, recipe).quantize(qsvs).quantized_model
    want = jax_executor.GraphExecutor(jq_graph).signature_runner(
        capture_all=True)(inputs)
    got = executor.GraphExecutor(tq_graph, device='cpu',
                                 **JAX_OPTS).signature_runner(
                                     capture_all=True)(inputs)
    runs[recipe] = (jq_graph, {k: np.asarray(v) for k, v in want.items()},
                    got)
  float_out = jax_executor.GraphExecutor(jgraph).signature_runner()(inputs)
  return runs, {k: np.asarray(v) for k, v in float_out.items()}


def _dequant(graph, name, v):
  t = graph.subgraphs[0].tensor_by_name(name)
  q = t.quantization
  if q is None:
    return v.astype(np.float32)
  return ((v.astype(np.float32) - np.asarray(q.zero_point, np.float32))
          * np.asarray(q.scale, np.float32))


# (largest step, largest share of a tensor's codes off) between the
# executors' captured tensors: a8w8's integer products are exact, and a
# code moves only where a float reduction rounds at a tie (none in these
# runs); a16w8's int16 activations go through the float fallback (a
# dequantized FC and BATCH_MATMUL summed in another order on each side):
# an ulp of a sum moves an int16 code, a moved code moves what follows
# (GELU's slope up to 2 steps), and the moves add up over the 2 layers.
ENCODER_CODES = {'default_a8w8': (1, FLIP_SHARE),
                 'default_a16w8': (2, 0.08)}
# The outputs' dequantized values: a8w8 within one code of the output
# (probs 1/256, pooled its scale), a16w8 within 1e-3 absolute.
ENCODER_OUT_ATOL = {'default_a16w8': 1e-3}


@pytest.mark.parametrize('recipe', ['default_a8w8', 'default_a16w8'])
def test_encoder_runs_match_jax(recipe, encoder_runs):
  runs, float_out = encoder_runs
  qgraph, want, got = runs[recipe]
  assert set(got) == set(want)
  steps, share = ENCODER_CODES[recipe]
  for name, w in want.items():
    if w.dtype in (np.int8, np.int16):
      _codes_agree(got[name], w, steps, share, name)
    elif w.dtype == np.float32:
      np.testing.assert_allclose(got[name], w, rtol=1e-5,
                                 atol=1e-6 * np.max(np.abs(w), initial=1),
                                 err_msg=name)
    else:
      np.testing.assert_array_equal(got[name], w, err_msg=name)
  for name in ('probs', 'pooled'):
    a, b = _dequant(qgraph, name, got[name]), _dequant(qgraph, name,
                                                       want[name])
    q = qgraph.subgraphs[0].tensor_by_name(name).quantization
    atol = ENCODER_OUT_ATOL.get(recipe, float(np.max(q.scale)) * 1.0001)
    np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)
    # And the quantized model tracks the float one.
    assert np.max(np.abs(a - float_out[name])) < 0.05, name
