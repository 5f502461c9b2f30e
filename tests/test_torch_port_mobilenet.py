"""MobileNetV2's static-range path in the port against the JAX package's,
on the CPU: the builder (the same weights), the float forward, the integer
SRQ convolution (`executor._try_srq_int_conv`: output codes equal to the
JAX executor's given the same quantized graph), its exact int32 product
(`qmatmul.int_conv_exact` against numpy's int64), the whole pipeline as
tests/test_mobilenet.py runs it, and the FLOP count.

The integer convolution's codes are equal, not one step apart: its
product is exact on both sides and the epilogue (acc - zp * wsum, times
f32(s_x) * s_w, plus the bias, clip, quantize) is the same float32
arithmetic in the same order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu.execution import executor as jax_executor
from ai_edge_quantizer_tpu.graph.builder import GraphBuilder
from ai_edge_quantizer_tpu.models import encoder as jax_encoder
from ai_edge_quantizer_tpu.models import mobilenet as jax_mobilenet
from ai_edge_quantizer_tpu.utils import flops as jax_flops
from ai_edge_quantizer_tpu.utils import test_data as jax_test_data
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.kernels import qmatmul
from ai_edge_quantizer_tpu_torch.models import encoder
from ai_edge_quantizer_tpu_torch.models import mobilenet
from ai_edge_quantizer_tpu_torch.ops import impl as ops_impl
from ai_edge_quantizer_tpu_torch.utils import flops
from ai_edge_quantizer_tpu_torch.utils import test_data

from test_torch_port_calibration import SMALL_ENCODER
from test_torch_port_quantizer import graph_record, to_port_graph

JAX_OPTS = dict(activation_dtype='float32', **executor.JAX_DEFAULT_OPTIONS)
# The float forward: every tensor within this share of its largest
# magnitude (f32 convolution sums in another order, through 53 of them).
FLOAT_RTOL = 1e-5
# Codes one step apart in at most this share of a tensor's elements, for
# the ops that are not integer products (ADD, MEAN, SOFTMAX).
CODE_FLIP_SHARE = 1e-3
IMAGE = 96  # tests/test_mobilenet.py's


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  """One torch thread for this file: under parallel test workers, torch's
  default of a thread a core oversubscribes the cores, and its CPU
  convolutions then run several times slower than on one thread."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def test_builder_matches_jax_and_ignores_the_input_shape():
  want = jax_mobilenet.build_mobilenet_v2(batch=2, image_size=32)
  got = mobilenet.build_mobilenet_v2(batch=2, image_size=32)
  assert graph_record(got) == graph_record(to_port_graph(want))
  other = mobilenet.build_mobilenet_v2(batch=64, image_size=224)
  assert len(other.buffers) == len(got.buffers)
  for a, b in zip(other.buffers, got.buffers):
    assert (a.data is None) == (b.data is None)
    if a.data is not None:
      np.testing.assert_array_equal(a.data, b.data)
  ops = [op.opcode for op in got.subgraphs[0].ops]
  assert {op: ops.count(op) for op in set(ops)} == {
      'CONV_2D': 35, 'DEPTHWISE_CONV_2D': 17, 'ADD': 10, 'MEAN': 1,
      'FULLY_CONNECTED': 1, 'SOFTMAX': 1}


def test_float_forward_matches_jax():
  jgraph = jax_mobilenet.build_mobilenet_v2(batch=2, image_size=48)
  feed = {'image': np.random.default_rng(1).standard_normal(
      (2, 48, 48, 3)).astype(np.float32)}
  want = jax_executor.GraphExecutor(jgraph).signature_runner(
      capture_all=True)(feed)
  got = executor.GraphExecutor(
      mobilenet.build_mobilenet_v2(batch=2, image_size=48), device='cpu',
      **JAX_OPTS).signature_runner(capture_all=True)(feed)
  assert set(got) == set(want)
  for name, w in want.items():
    w = np.asarray(w)
    err = np.max(np.abs(got[name] - w))
    assert err <= FLOAT_RTOL * max(np.max(np.abs(w)), 1e-30), (name, err)


# (opcode, x shape, weight shape, stride, padding, input zero point 0?)
CONV_CASES = {
    # Stride 2 on an even size: SAME pads (0, 1), the zero point's padding
    # on the bottom and right only.
    'stride2_same': ('CONV_2D', (2, 8, 8, 3), (6, 3, 3, 3), 2, 'SAME', False),
    'stride2_same_zp0': ('CONV_2D', (2, 8, 8, 3), (6, 3, 3, 3), 2, 'SAME',
                         True),
    'stride1_same': ('CONV_2D', (1, 7, 6, 5), (4, 3, 3, 5), 1, 'SAME', False),
    'valid': ('CONV_2D', (1, 9, 8, 4), (5, 3, 3, 4), 2, 'VALID', False),
    '1x1': ('CONV_2D', (2, 5, 5, 40), (24, 1, 1, 40), 1, 'SAME', False),
    '1x1_zp0': ('CONV_2D', (2, 5, 5, 40), (24, 1, 1, 40), 1, 'SAME', True),
    'depthwise_s1': ('DEPTHWISE_CONV_2D', (2, 6, 7, 8), (1, 3, 3, 8), 1,
                     'SAME', False),
    'depthwise_s2': ('DEPTHWISE_CONV_2D', (2, 8, 8, 8), (1, 3, 3, 8), 2,
                     'SAME', False),
    'depthwise_s2_zp0': ('DEPTHWISE_CONV_2D', (2, 8, 8, 8), (1, 3, 3, 8), 2,
                         'SAME', True),
}


def _conv_graph(case):
  opcode, x_shape, w_shape, stride, padding, _ = case
  rng = np.random.default_rng(sum(x_shape) + sum(w_shape) + stride)
  b = GraphBuilder('main')
  x = b.input('x', x_shape)
  w = (rng.standard_normal(w_shape) * 0.3).astype(np.float32)
  bias = (rng.standard_normal(w_shape[-1] if opcode == 'DEPTHWISE_CONV_2D'
                              else w_shape[0]) * 0.1).astype(np.float32)
  conv = b.conv2d if opcode == 'CONV_2D' else b.depthwise_conv2d
  y = conv(x, w, bias, stride=stride, padding=padding, name='conv',
           activation='RELU6')
  b.output(y)
  return b.finalize()


def _quantize_both(jgraph, recipe, qsvs):
  want = JaxQuantizer(jgraph, recipe).quantize(qsvs).quantized_model
  got = Quantizer(to_port_graph(jgraph), recipe).quantize(qsvs).quantized_model
  assert graph_record(got) == graph_record(to_port_graph(want))
  return want, got


def _run_both(want_g, got_g, feed, srq_int=True):
  want = jax_executor.GraphExecutor(want_g).signature_runner(
      capture_all=True)(feed)
  got = executor.GraphExecutor(got_g, device='cpu', srq_int=srq_int,
                               **JAX_OPTS).signature_runner(
                                   capture_all=True)(feed)
  return {k: np.asarray(v) for k, v in want.items()}, got


def _counting(monkeypatch):
  calls = []
  orig = qmatmul.int_conv_exact
  monkeypatch.setattr(qmatmul, 'int_conv_exact',
                      lambda *a: calls.append(a[-1]) or orig(*a))
  return calls


@pytest.mark.parametrize('key', sorted(CONV_CASES))
def test_integer_conv_codes_equal_jax(key, monkeypatch):
  """The same quantized single-conv graph through both executors, the
  input's zero point 0 (QSVs symmetric about 0) or not: the integer
  path engages (counted) and the conv's codes equal the JAX executor's;
  with srq_int off the port's dequantize-first path is one step away at
  most."""
  case = CONV_CASES[key]
  jgraph = _conv_graph(case)
  x_shape = case[1]
  qsvs = JaxQuantizer(jgraph, 'default_a8w8').calibrate(
      jax_test_data.create_random_dataset(jgraph, num_samples=4))
  a = float(np.max(np.abs(qsvs['x']['max'])))
  lo = -a if case[-1] else -0.5 * a
  qsvs['x'] = {**qsvs['x'], 'min': np.full_like(qsvs['x']['min'], lo),
               'max': np.full_like(qsvs['x']['max'], a)}
  want_g, got_g = _quantize_both(jgraph, 'default_a8w8', qsvs)
  sg = got_g.subgraphs[0]
  zp = int(np.asarray(
      sg.tensor_by_name('x').quantization.zero_point).reshape(()))
  assert (zp == 0) == case[-1], zp
  feed = {'x': np.random.default_rng(5).standard_normal(x_shape).astype(
      np.float32) * a * 0.6}
  calls = _counting(monkeypatch)
  want, got = _run_both(want_g, got_g, feed)
  assert calls == [case[0] == 'DEPTHWISE_CONV_2D']
  for name, w in want.items():
    assert got[name].dtype == w.dtype, name
    np.testing.assert_array_equal(got[name], w, err_msg=name)
  out = sg.tensors[sg.ops[-1].outputs[0]].name
  _, generic = _run_both(want_g, got_g, feed, srq_int=False)
  assert len(calls) == 1
  assert np.max(np.abs(generic[out].astype(int) - got[out])) <= 1


def test_a16w8_conv_takes_the_generic_path(monkeypatch):
  """int16 activations (a16w8) dequantize first, as in the JAX executor:
  no integer product, codes within one step of JAX's."""
  jgraph = _conv_graph(CONV_CASES['stride2_same'])
  qsvs = JaxQuantizer(jgraph, 'default_a16w8').calibrate(
      jax_test_data.create_random_dataset(jgraph, num_samples=4))
  want_g, got_g = _quantize_both(jgraph, 'default_a16w8', qsvs)
  feed = {'x': np.random.default_rng(6).standard_normal(
      (2, 8, 8, 3)).astype(np.float32)}
  calls = _counting(monkeypatch)
  want, got = _run_both(want_g, got_g, feed)
  assert calls == []
  for name, w in want.items():
    assert got[name].dtype == w.dtype, name
    assert np.max(np.abs(got[name].astype(np.int64) - w)) <= 1, name


def _conv_ref(x, w, stride, pads, zp, depthwise):
  xp = np.pad(x.astype(np.int64), ((0, 0), pads[0], pads[1], (0, 0)),
              constant_values=zp)
  kh, kw = w.shape[1:3]
  ho = (xp.shape[1] - kh) // stride + 1
  wo = (xp.shape[2] - kw) // stride + 1
  out = 0
  for a in range(kh):
    for b in range(kw):
      tap = xp[:, a:a + (ho - 1) * stride + 1:stride,
               b:b + (wo - 1) * stride + 1:stride, :]
      out = out + (tap * w[0, a, b].astype(np.int64) if depthwise
                   else tap @ w[:, a, b, :].astype(np.int64).T)
  return out


@pytest.mark.parametrize('case', [
    ((2, 9, 8, 5), (7, 3, 3, 5), 2, ((1, 1), (0, 1)), -3, False),
    ((2, 7, 7, 3), (4, 3, 3, 3), 2, ((1, 1), (1, 1)), -128, False),
    ((1, 8, 8, 6), (1, 3, 3, 6), 1, ((1, 1), (1, 1)), 5, True),
    ((1, 8, 8, 6), (1, 3, 3, 6), 2, ((0, 1), (0, 1)), 0, True),
    # K 1100 crosses the 1024-wide exact chunk; 'extreme' fills x with
    # -128 and w with -127, whose sum over K is past 2**24.
    ((1, 4, 4, 1100), (3, 1, 1, 1100), 1, ((0, 0), (0, 0)), 7, False),
    ((1, 3, 3, 1100), (2, 1, 1, 1100), 1, ((0, 0), (0, 0)), 0, 'extreme'),
], ids=['dense_s2_asym', 'stem_like', 'depthwise_s1', 'depthwise_s2',
        '1x1_k1100', '1x1_k1100_extreme'])
def test_int_conv_exact_is_the_integer_product(case):
  x_shape, w_shape, stride, pads, zp, depthwise = case
  rng = np.random.default_rng(len(x_shape) + sum(w_shape))
  if depthwise == 'extreme':
    x = np.full(x_shape, -128, np.int8)
    w = np.full(w_shape, -127, np.int8)
    depthwise = False
  else:
    x = rng.integers(-128, 128, x_shape).astype(np.int8)
    w = rng.integers(-127, 128, w_shape).astype(np.int8)
  taps = ops_impl.windows(
      ops_impl.pad_hw(torch.from_numpy(x), pads, value=zp),
      w_shape[1], w_shape[2], stride)
  got = qmatmul.int_conv_exact(taps, torch.from_numpy(w), depthwise)
  assert got.dtype == torch.int32
  want = _conv_ref(x, w, stride, pads, zp, depthwise)
  assert np.max(np.abs(want)) < 2**31
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope='module')
def jax_pipeline():
  """JAX's MobileNet at tests/test_mobilenet.py's size: its QSVs and its
  quantized graph."""
  jgraph = jax_mobilenet.build_mobilenet_v2(batch=1, image_size=IMAGE)
  jq = JaxQuantizer(jgraph, 'default_a8w8')
  qsvs = jq.calibrate(jax_test_data.create_random_dataset(jgraph,
                                                          num_samples=4))
  return qsvs, jq.quantize(qsvs).quantized_model


def test_pipeline_validates_and_matches_jax(jax_pipeline, monkeypatch):
  """The port's calibrate -> quantize -> validate (tests/test_mobilenet.py's
  bars), then the JAX QSVs' quantized graph through both executors: the
  52 convolutions and the FC give JAX's codes, the other ops' within one
  step in CODE_FLIP_SHARE of their elements."""
  graph = mobilenet.build_mobilenet_v2(batch=1, image_size=IMAGE)
  qt = Quantizer(graph, 'default_a8w8')
  qt.quantize(qt.calibrate(test_data.create_random_dataset(
      graph, num_samples=4), device='cpu'))
  sg = qt._result.quantized_model.main_subgraph()
  assert all(t.dtype.startswith('int') for t in sg.tensors)
  cmp = qt.validate(num_samples=2, device='cpu')
  assert cmp.get_all_tensor_results()['probs'] < 1e-3
  _, frac = cmp.get_model_size_reduction()
  assert frac > 0.70

  qsvs, want_g = jax_pipeline
  got_g = Quantizer(graph, 'default_a8w8').quantize(qsvs).quantized_model
  assert graph_record(got_g) == graph_record(to_port_graph(want_g))
  feed = {'image': np.random.default_rng(3).standard_normal(
      (1, IMAGE, IMAGE, 3)).astype(np.float32)}
  calls = _counting(monkeypatch)
  want, got = _run_both(want_g, got_g, feed)
  assert len(calls) == 52 and sum(calls) == 17
  jsg = want_g.subgraphs[0]
  for op in jsg.ops:
    for tid in op.outputs:
      name = jsg.tensors[tid].name
      w, g = want[name], got[name]
      assert g.dtype == w.dtype, name
      diff = np.abs(g.astype(np.int64) - w.astype(np.int64))
      if op.opcode in ('CONV_2D', 'DEPTHWISE_CONV_2D', 'FULLY_CONNECTED'):
        assert not diff.any(), name
      else:
        assert diff.max() <= 1 and np.mean(diff > 0) <= CODE_FLIP_SHARE, name


def test_flops_match_jax():
  want = jax_mobilenet.build_mobilenet_v2(batch=64, image_size=224)
  got = mobilenet.build_mobilenet_v2(batch=64, image_size=224)
  fl = flops.graph_flops(got)
  assert fl == jax_flops.graph_flops(want)
  assert 38e9 < fl < 39e9  # bench.py's mobilenet preset: 38.5 GFLOP a call
  # bench.py's bench_encoder shape, and a small one.
  for cfg, batch in ((encoder.BERT_BASE_LITE, 32),
                     (encoder.EncoderConfig(**SMALL_ENCODER), 2)):
    jenc = jax_encoder.build_encoder(
        jax_encoder.EncoderConfig(**dataclasses.asdict(cfg)), batch=batch)
    tenc = encoder.build_encoder(cfg, batch=batch)
    assert flops.graph_flops(tenc) == jax_flops.graph_flops(jenc) > 0
    for sg_t, sg_j in zip(tenc.subgraphs, jenc.subgraphs):
      assert flops.subgraph_flops(sg_t) == jax_flops.subgraph_flops(sg_j)
