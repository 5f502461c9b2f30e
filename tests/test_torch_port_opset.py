"""The port's whole op vocabulary (ops/impl.py) against the JAX package's,
through both executors on the CPU.

Float: one small single-op graph an opcode (a few variants for the ones
with strides, paddings or dtypes), built by the JAX package's builder and
carried to the port's IR field by field, runs through the JAX executor
and the port's on the same seeded inputs (structural operands as graph
constants where the op takes them, so `_STRUCTURAL_OPERANDS` is read).
Integer, shape, selection, comparison and piecewise ops are exact, and so
is SQRT (XLA's float32 root is correctly rounded; the port's is too,
through float64). RSQRT and the transcendentals are held to
TRANSCENDENTAL_ULPS: XLA's CPU polynomials and torch's are each within a
few ulps of the true value, not equal to each other. Convolutions,
resizes, the average pool and MEAN sum in another order than XLA's:
CONV_RTOL, RESIZE_RTOL, POOL_RTOL and MEAN_RTOL of the output's largest
magnitude.

a8w8: the single-op fixtures of tests/test_e2e_per_op.py, calibrated by
the JAX package, quantized by both packages from the same QSVs (the same
graph, every dtype, scale and zero point) and run by both executors with
every tensor captured: integer codes one step apart at most, in at most
CODE_FLIP_SHARE of a tensor's elements; float tensors as above. Then
CONV_2D_TRANSPOSE under a8w8 and weight-only at strides 1 and 2, and the
constrained-op lists of every constraint.
"""

import dataclasses
import inspect
import zlib

import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu.execution import executor as jax_executor
from ai_edge_quantizer_tpu.graph.builder import GraphBuilder
from ai_edge_quantizer_tpu.ops import impl as jax_impl
from ai_edge_quantizer_tpu.utils import constrained_ops_utils as jax_constrained
from ai_edge_quantizer_tpu.utils import test_data as jax_test_data
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch.algorithms.uniform import engine
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.ops import impl
from ai_edge_quantizer_tpu_torch.utils import constrained_ops_utils
from ai_edge_quantizer_tpu_torch.utils import test_utils

import test_e2e_per_op
from test_torch_port_quantizer import graph_record, to_port_graph

JAX_OPTS = dict(activation_dtype='float32', **executor.JAX_DEFAULT_OPTIONS)
# XLA's CPU float32 rsqrt, exp, log, sin, cos, erf, logistic and pow
# against torch's CPU ones. Over 1e6 draws against a float64 reference,
# XLA's erf was up to 5 ulps off (its logistic 2, the others 1), torch's
# 1 or 2, and the two at most 5 apart.
TRANSCENDENTAL_ULPS = 6
# Sums of products in another order (the convolutions' f32 sums, the
# bilinear resize's two contractions, MEAN's sum: float64 in the port):
# of the output's largest magnitude.
CONV_RTOL = 2e-6
RESIZE_RTOL = 1e-6
POOL_RTOL = 1e-6
MEAN_RTOL = 1e-6
# Share of a quantized tensor's codes that may differ by one step between
# the executors (a float op's last ulp rounding a code the other way).
CODE_FLIP_SHARE = 1e-2
# The average pool (a mean of four codes) and the bilinear resize (weights
# of 1/4 and 3/4) put many values on exact ties of the output's grid,
# where XLA's fused float arithmetic (it rewrites a division by a constant
# as a product by the reciprocal) rounds to the other side more often:
# 2 of 64 and 15 of 1024 codes at the fixtures' shapes.
TIE_FLIP_SHARE = 5e-2
TIE_OPS = ('AVERAGE_POOL_2D', 'RESIZE_BILINEAR')
CALIBRATION_SAMPLES = 4

EXACT = ('exact', 0)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  """One torch thread for this file: under parallel test workers, torch's
  default of a thread a core oversubscribes the cores, and its CPU
  convolutions then run several times slower than on one thread."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _ulps(tol):
  return ('ulps', tol)


def _rel(tol):
  return ('rel', tol)


@dataclasses.dataclass
class Case:
  opcode: str
  operands: list          # [('x' graph input | 'c' constant, array)]
  out_shapes: list
  tol: tuple = EXACT
  attrs: dict = dataclasses.field(default_factory=dict)
  out_dtypes: list = None


def _rng(key):
  return np.random.default_rng(zlib.crc32(key.encode()))


def _f(rng, *shape, scale=1.0):
  return (rng.standard_normal(shape) * scale).astype(np.float32)


def _away_from_zero(rng, *shape):
  v = _f(rng, *shape)
  return (np.sign(v) * (0.5 + np.abs(v))).astype(np.float32)


def _ints(rng, lo, hi, *shape):
  return rng.integers(lo, hi, shape).astype(np.int32)


def _binary(op, a, b, out_dtype='float32', tol=EXACT):
  shape = np.broadcast_shapes(a.shape, b.shape)
  return Case(op, [('x', a), ('x', b)], [shape], tol, out_dtypes=[out_dtype])


def _unary(op, x, tol=EXACT, attrs=None):
  return Case(op, [('x', x)], [x.shape], tol, attrs or {},
              out_dtypes=[str(x.dtype)])


def _conv(op, rng, x_shape, w_shape, stride, padding, out_shape,
          act='RELU6'):
  return Case(op, [('x', _f(rng, *x_shape)), ('c', _f(rng, *w_shape) * 0.3),
                   ('c', _f(rng, w_shape[0] if op == 'CONV_2D'
                            else w_shape[-1]) * 0.1)],
              [out_shape], _rel(CONV_RTOL),
              {'stride': stride, 'padding': padding,
               'fused_activation': act})


def _tconv(rng, stride, padding, out_hw):
  x = _f(rng, 1, 5, 6, 3)
  out = (1,) + out_hw + (4,)
  return Case('CONV_2D_TRANSPOSE',
              [('c', np.array(out, np.int32)), ('c', _f(rng, 4, 3, 3, 3)),
               ('x', x), ('c', _f(rng, 4) * 0.1)],
              [out], _rel(CONV_RTOL), {'stride': stride, 'padding': padding})


def _pool(op, rng, size, stride, padding, x_shape, out_shape):
  tol = _rel(POOL_RTOL) if op == 'AVERAGE_POOL_2D' else EXACT
  return Case(op, [('x', _f(rng, *x_shape))], [out_shape], tol,
              {'filter_size': size, 'stride': stride, 'padding': padding})


def _build_cases():
  c = {}

  def add(key, make):
    c[key] = make(_rng(key))

  tu = _ulps(TRANSCENDENTAL_ULPS)
  # -- binary
  add('DIV', lambda r: _binary('DIV', _f(r, 4, 16), _away_from_zero(r, 4, 16)))
  add('DIV/int32', lambda r: _binary('DIV', _ints(r, -50, 50, 4, 16),
                                     _ints(r, 1, 9, 16)))
  add('MAXIMUM', lambda r: _binary('MAXIMUM', _f(r, 4, 16), _f(r, 16)))
  add('MINIMUM', lambda r: _binary('MINIMUM', _f(r, 4, 16), _f(r, 1, 16)))
  add('SQUARED_DIFFERENCE', lambda r: _binary('SQUARED_DIFFERENCE',
                                              _f(r, 4, 16), _f(r, 4, 16)))
  add('NOT_EQUAL', lambda r: _binary('NOT_EQUAL', _ints(r, 0, 3, 4, 16),
                                     _ints(r, 0, 3, 16), 'bool'))
  add('LESS', lambda r: _binary('LESS', np.round(_f(r, 4, 16)),
                                np.round(_f(r, 4, 16)), 'bool'))
  add('GREATER', lambda r: _binary('GREATER', np.round(_f(r, 4, 16)),
                                   np.round(_f(r, 16)), 'bool'))
  add('LOGICAL_AND', lambda r: _binary('LOGICAL_AND', _f(r, 4, 16) > 0,
                                       _f(r, 4, 16) > 0, 'bool'))
  add('LOGICAL_OR', lambda r: _binary('LOGICAL_OR', _f(r, 4, 16) > 0,
                                      _f(r, 4, 16) > 0, 'bool'))
  add('POW', lambda r: _binary(
      'POW', r.uniform(0.1, 3.0, (4, 16)).astype(np.float32),
      _f(r, 4, 16), tol=tu))
  add('FLOOR_DIV', lambda r: _binary('FLOOR_DIV', _f(r, 4, 16, scale=10),
                                     _away_from_zero(r, 4, 16)))
  add('FLOOR_DIV/int32', lambda r: _binary(
      'FLOOR_DIV', _ints(r, -50, 50, 4, 16),
      _ints(r, 1, 9, 4, 16) * np.where(_f(r, 4, 16) > 0, 1, -1).astype(
          np.int32), 'int32'))
  add('FLOOR_MOD', lambda r: _binary('FLOOR_MOD', _f(r, 4, 16, scale=10),
                                     _away_from_zero(r, 4, 16)))
  add('FLOOR_MOD/int32', lambda r: _binary(
      'FLOOR_MOD', _ints(r, -50, 50, 4, 16),
      _ints(r, 1, 9, 4, 16) * np.where(_f(r, 4, 16) > 0, 1, -1).astype(
          np.int32), 'int32'))
  # -- unary
  def with_specials(r):
    x = _f(r, 4, 16, scale=3)
    x[0, :4] = [0.0, -0.0, np.nan, 2.5]
    return x
  for op in ('RELU', 'NEG', 'ABS', 'SIGN', 'FLOOR', 'IDENTITY',
             'HARD_SWISH'):
    add(op, lambda r, op=op: _unary(op, with_specials(r)))
  add('SIGN/int32', lambda r: _unary('SIGN', _ints(r, -3, 4, 4, 16)))
  for op in ('LOGISTIC', 'SIN', 'COS', 'ERF'):
    add(op, lambda r, op=op: _unary(op, _f(r, 8, 64, scale=3), tu))
  add('EXP', lambda r: _unary('EXP', _f(r, 8, 64, scale=4), tu))
  for op in ('LOG', 'SQRT', 'RSQRT'):
    add(op, lambda r, op=op: _unary(
        op, np.exp(_f(r, 8, 64, scale=4)).astype(np.float32),
        EXACT if op == 'SQRT' else tu))
  # -- spatial: stride-2 SAME on even sizes pads (0, 1)
  add('CONV_2D', lambda r: _conv('CONV_2D', r, (2, 8, 8, 3), (5, 3, 3, 3),
                                 2, 'SAME', (2, 4, 4, 5)))
  add('CONV_2D/s1', lambda r: _conv('CONV_2D', r, (1, 7, 6, 4), (6, 3, 3, 4),
                                    1, 'SAME', (1, 7, 6, 6), 'RELU'))
  add('CONV_2D/valid', lambda r: _conv('CONV_2D', r, (1, 9, 8, 4),
                                       (6, 3, 2, 4), 2, 'VALID',
                                       (1, 4, 4, 6), 'NONE'))
  add('CONV_2D/1x1', lambda r: _conv('CONV_2D', r, (2, 5, 5, 8), (4, 1, 1, 8),
                                     1, 'SAME', (2, 5, 5, 4), 'NONE'))
  add('DEPTHWISE_CONV_2D', lambda r: _conv(
      'DEPTHWISE_CONV_2D', r, (2, 8, 8, 6), (1, 3, 3, 6), 2, 'SAME',
      (2, 4, 4, 6)))
  add('DEPTHWISE_CONV_2D/s1', lambda r: _conv(
      'DEPTHWISE_CONV_2D', r, (1, 7, 5, 6), (1, 3, 3, 6), 1, 'SAME',
      (1, 7, 5, 6)))
  add('CONV_2D_TRANSPOSE', lambda r: _tconv(r, 2, 'SAME', (10, 12)))
  add('CONV_2D_TRANSPOSE/s1', lambda r: _tconv(r, 1, 'SAME', (5, 6)))
  add('CONV_2D_TRANSPOSE/valid', lambda r: _tconv(r, 2, 'VALID', (11, 13)))
  add('AVERAGE_POOL_2D', lambda r: _pool('AVERAGE_POOL_2D', r, 2, 2, 'VALID',
                                         (2, 8, 8, 3), (2, 4, 4, 3)))
  add('AVERAGE_POOL_2D/same', lambda r: _pool(
      'AVERAGE_POOL_2D', r, 3, 2, 'SAME', (1, 7, 8, 3), (1, 4, 4, 3)))
  add('MAX_POOL_2D', lambda r: _pool('MAX_POOL_2D', r, 2, 2, 'VALID',
                                     (2, 8, 8, 3), (2, 4, 4, 3)))
  add('MAX_POOL_2D/same', lambda r: _pool('MAX_POOL_2D', r, 3, 2, 'SAME',
                                          (1, 7, 8, 3), (1, 4, 4, 3)))
  add('RESIZE_BILINEAR', lambda r: Case(
      'RESIZE_BILINEAR', [('x', _f(r, 1, 5, 6, 3)),
                          ('c', np.array([10, 12], np.int32))],
      [(1, 10, 12, 3)], _rel(RESIZE_RTOL)))
  add('RESIZE_BILINEAR/down', lambda r: Case(
      'RESIZE_BILINEAR', [('x', _f(r, 2, 13, 17, 3))], [(2, 7, 9, 3)],
      _rel(RESIZE_RTOL)))
  add('RESIZE_NEAREST_NEIGHBOR', lambda r: Case(
      'RESIZE_NEAREST_NEIGHBOR', [('x', _f(r, 1, 5, 6, 3)),
                                  ('c', np.array([10, 12], np.int32))],
      [(1, 10, 12, 3)]))
  add('RESIZE_NEAREST_NEIGHBOR/down', lambda r: Case(
      'RESIZE_NEAREST_NEIGHBOR', [('x', _f(r, 2, 13, 17, 3))],
      [(2, 7, 9, 3)]))
  add('SPACE_TO_DEPTH', lambda r: Case(
      'SPACE_TO_DEPTH', [('x', _f(r, 2, 4, 6, 3))], [(2, 2, 3, 12)],
      attrs={'block_size': 2}))
  # -- shape, data and reduction
  add('CONCATENATION', lambda r: Case(
      'CONCATENATION', [('x', _f(r, 2, 3, 4)), ('x', _f(r, 2, 5, 4)),
                        ('c', _f(r, 2, 1, 4))], [(2, 9, 4)],
      attrs={'axis': 1}))
  add('STRIDED_SLICE', lambda r: Case(
      'STRIDED_SLICE', [('x', _f(r, 6, 10, 4))], [(3, 3, 4)],
      attrs={'begin': [0, 1, 0], 'end': [6, 9, 4], 'strides': [2, 3, 1]}))
  add('STRIDED_SLICE/negative', lambda r: Case(
      'STRIDED_SLICE', [('x', _f(r, 6, 10, 4)),
                        ('c', np.array([5, 8, 0], np.int32)),
                        ('c', np.array([0, -11, 4], np.int32)),
                        ('c', np.array([-2, -3, 1], np.int32))],
      [(3, 3, 4)]))
  add('SPLIT', lambda r: Case(
      'SPLIT', [('c', np.array(1, np.int32)), ('x', _f(r, 4, 9, 2))],
      [(4, 3, 2)] * 3, attrs={'num_splits': 3}))
  add('PAD', lambda r: Case(
      'PAD', [('x', _f(r, 3, 4, 2)),
              ('c', np.array([[1, 0], [2, 3], [0, 1]], np.int32))],
      [(4, 9, 3)]))
  add('PADV2', lambda r: Case(
      'PADV2', [('x', _f(r, 3, 4))], [(5, 5)],
      attrs={'paddings': [[1, 1], [0, 1]], 'constant': 0.5}))
  add('PADV2/operand', lambda r: Case(
      'PADV2', [('x', _f(r, 3, 4)),
                ('c', np.array([[0, 2], [1, 1]], np.int32)),
                ('c', np.array([-1.25], np.float32))], [(5, 6)]))
  add('MIRROR_PAD', lambda r: Case(
      'MIRROR_PAD', [('x', _f(r, 4, 5, 2)),
                     ('c', np.array([[2, 3], [1, 4], [0, 0]], np.int32))],
      [(9, 10, 2)], attrs={'mode': 'REFLECT'}))
  add('MIRROR_PAD/symmetric', lambda r: Case(
      'MIRROR_PAD', [('x', _f(r, 4, 5, 2))], [(9, 10, 2)],
      attrs={'paddings': [[2, 3], [5, 0], [0, 0]], 'mode': 'SYMMETRIC'}))
  # Out-of-range and negative indices: JAX clamps (after wrapping a
  # negative index once).
  add('GATHER_ND', lambda r: Case(
      'GATHER_ND', [('x', _f(r, 5, 6, 4)),
                    ('c', np.array([[[0, 1], [4, 5], [7, 2]],
                                    [[-1, 0], [2, -9], [3, 3]]], np.int32))],
      [(2, 3, 4)]))
  add('PACK', lambda r: Case(
      'PACK', [('x', _f(r, 3, 4)), ('x', _f(r, 3, 4)), ('c', _f(r, 3, 4))],
      [(3, 3, 4)], attrs={'axis': 1}))
  add('UNPACK', lambda r: Case('UNPACK', [('x', _f(r, 3, 2, 4))],
                               [(3, 4)] * 2, attrs={'axis': 1}))
  add('BROADCAST_IN_DIM', lambda r: Case(
      'BROADCAST_IN_DIM', [('x', _f(r, 3, 1))], [(2, 3, 4)],
      attrs={'shape': [2, 3, 4], 'broadcast_dimensions': [1, 2]}))
  add('SELECT', lambda r: Case(
      'SELECT', [('x', _f(r, 4, 8) > 0), ('x', _f(r, 4, 8)),
                 ('x', _f(r, 4, 8))], [(4, 8)]))
  add('SELECT_V2', lambda r: Case(
      'SELECT_V2', [('x', _f(r, 4, 1) > 0), ('x', _f(r, 4, 8)),
                    ('x', _f(r, 8))], [(4, 8)]))
  add('SELECT_N', lambda r: Case(
      'SELECT_N', [('x', _f(r, 4, 8) > 0), ('x', _f(r, 4, 8)),
                   ('x', _f(r, 4, 8))], [(4, 8)]))
  add('SELECT_N/3', lambda r: Case(
      'SELECT_N', [('x', _ints(r, 0, 3, 4, 8)), ('x', _f(r, 4, 8)),
                   ('x', _f(r, 4, 8)), ('x', _f(r, 4, 8))], [(4, 8)]))
  add('INTEGER_POW', lambda r: _unary('INTEGER_POW', _f(r, 4, 16),
                                      attrs={'exponent': 5}))
  add('INTEGER_POW/negative', lambda r: _unary(
      'INTEGER_POW', _away_from_zero(r, 4, 16), attrs={'exponent': -3}))
  add('INTEGER_POW/int32', lambda r: _unary(
      'INTEGER_POW', _ints(r, -9, 9, 4, 16), attrs={'exponent': 3}))
  add('MEAN', lambda r: Case(
      'MEAN', [('x', _f(r, 2, 7, 7, 16))], [(2, 16)], _rel(MEAN_RTOL),
      {'axis': [1, 2], 'keep_dims': False}))
  add('MEAN/operand', lambda r: Case(
      'MEAN', [('x', _f(r, 3, 5, 6)), ('c', np.array([2], np.int32))],
      [(3, 5, 1)], _rel(MEAN_RTOL), {'keep_dims': True}))
  add('REDUCE_MAX', lambda r: Case(
      'REDUCE_MAX', [('x', _f(r, 3, 5, 6))], [(3, 6)],
      attrs={'axis': [1], 'keep_dims': False}))
  return c


CASES = _build_cases()
# STABLEHLO_COMPOSITE's impl only raises in both packages: the executors
# run a composite through its body subgraph
# (tests/test_torch_port_control_flow.py).
COMPOSITE = {'STABLEHLO_COMPOSITE'}
# The opcodes this file holds (the rest of the vocabulary is in
# tests/test_torch_port_ops.py).
OPCODES = {case.opcode for case in CASES.values()}


def single_op_graph(case):
  """(JAX graph, feed) of one op over the case's operands."""
  b = GraphBuilder('main')
  ids, feed = [], {}
  for i, (kind, arr) in enumerate(case.operands):
    name = f'in{i}'
    if kind == 'x':
      ids.append(b.input(name, arr.shape, str(arr.dtype)))
      feed[name] = arr
    else:
      ids.append(b.constant(name, arr))
  n = len(case.out_shapes)
  outs = b.op(case.opcode, ids, case.out_shapes,
              output_names=[f'out{j}' for j in range(n)],
              attrs=case.attrs,
              output_dtypes=case.out_dtypes or ['float32'] * n)
  for o in (outs if n > 1 else [outs]):
    b.output(o)
  return b.finalize(), feed


def _ordered(a):
  i = a.astype(np.float32).view(np.int32).astype(np.int64)
  return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def assert_close(got, want, tol, name=''):
  assert got.shape == want.shape and got.dtype == want.dtype, (
      name, got.shape, want.shape, got.dtype, want.dtype)
  kind, bound = tol
  if kind == 'exact' or not np.issubdtype(want.dtype, np.floating):
    np.testing.assert_array_equal(got, want, err_msg=name)
    return
  both_nan = np.isnan(got) & np.isnan(want)
  if kind == 'ulps':
    ulps = np.where(both_nan, 0, np.abs(_ordered(got) - _ordered(want)))
    assert ulps.max(initial=0) <= bound, (name, ulps.max())
  else:
    err = np.where(both_nan, 0, np.abs(got.astype(np.float64) - want))
    scale = max(float(np.nanmax(np.abs(want), initial=0)), 1e-30)
    assert err.max(initial=0) <= bound * scale, (name, err.max() / scale)


def _run_float(jgraph, feed):
  want = jax_executor.GraphExecutor(jgraph).signature_runner()(feed)
  got = executor.GraphExecutor(to_port_graph(jgraph), device='cpu',
                               **JAX_OPTS).signature_runner()(feed)
  return {k: np.asarray(v) for k, v in want.items()}, got


@pytest.mark.parametrize('key', sorted(CASES))
def test_op_matches_jax_executor(key):
  case = CASES[key]
  jgraph, feed = single_op_graph(case)
  want, got = _run_float(jgraph, feed)
  assert set(got) == set(want) == {f'out{j}' for j in
                                   range(len(case.out_shapes))}
  for name in want:
    assert_close(got[name], want[name], case.tol, f'{key} {name}')


def test_vocabulary_is_the_jax_packages():
  """Every JAX opcode is registered in the port, and this file holds the
  51 that the decode and encoder paths do not use (the composite is held
  through its body subgraph elsewhere)."""
  assert set(impl.OPS) == set(jax_impl.OPS)
  assert not OPCODES & COMPOSITE
  assert len(OPCODES) == 51
  assert OPCODES <= set(impl.OPS)


# -- a8w8 -------------------------------------------------------------------


def quantize_both(jgraph, recipe, samples=CALIBRATION_SAMPLES):
  """(JAX quantized graph, the port's from the JAX QSVs); the two equal
  field by field."""
  jq = JaxQuantizer(jgraph, recipe)
  qsvs = None
  if jq.need_calibration:
    qsvs = jq.calibrate(jax_test_data.create_random_dataset(
        jgraph, num_samples=samples))
  want = jq.quantize(qsvs).quantized_model
  got = Quantizer(to_port_graph(jgraph), recipe).quantize(
      qsvs).quantized_model
  assert graph_record(got) == graph_record(to_port_graph(want))
  return want, got


def run_both_captured(want_g, got_g, feed):
  want = jax_executor.GraphExecutor(want_g).signature_runner(
      capture_all=True)(feed)
  got = executor.GraphExecutor(got_g, device='cpu', **JAX_OPTS
                               ).signature_runner(capture_all=True)(feed)
  return {k: np.asarray(v) for k, v in want.items()}, got


def assert_codes_close(got, want, name='', share=CODE_FLIP_SHARE):
  assert got.shape == want.shape and got.dtype == want.dtype, name
  diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
  assert diff.max(initial=0) <= 1, (name, diff.max())
  assert np.mean(diff > 0) <= share, (name, np.mean(diff > 0))


def _float_rule(opcode):
  """The float tolerance of opcode's outputs (the captured dequantized
  views and float tensors)."""
  rel = {'CONV_2D': CONV_RTOL, 'DEPTHWISE_CONV_2D': CONV_RTOL,
         'CONV_2D_TRANSPOSE': CONV_RTOL, 'RESIZE_BILINEAR': RESIZE_RTOL,
         'MEAN': MEAN_RTOL, 'BATCH_MATMUL': CONV_RTOL, 'SUM': MEAN_RTOL,
         'AVERAGE_POOL_2D': POOL_RTOL,
         'FULLY_CONNECTED': CONV_RTOL, 'SOFTMAX': CONV_RTOL,
         'GELU': CONV_RTOL}
  if opcode in rel:
    return _rel(rel[opcode])
  if opcode in ('TANH', 'LOGISTIC', 'EXP', 'LOG', 'RSQRT'):
    return _ulps(TRANSCENDENTAL_ULPS)
  return EXACT


def assert_quantized_runs_agree(want_g, got_g, feed):
  want, got = run_both_captured(want_g, got_g, feed)
  assert set(got) == set(want)
  sg = want_g.subgraphs[0]
  producer = {sg.tensors[tid].name: op.opcode
              for op in sg.ops for tid in op.outputs}
  for name, w in want.items():
    opcode = producer.get(name)
    if np.issubdtype(w.dtype, np.integer) and w.dtype.itemsize <= 2:
      assert_codes_close(got[name], w, name, TIE_FLIP_SHARE
                         if opcode in TIE_OPS else CODE_FLIP_SHARE)
    else:
      assert_close(got[name], w, _float_rule(opcode), name)


PER_OP = sorted(set(test_e2e_per_op._BUILDERS) - {'EMBEDDING_LOOKUP'})


@pytest.mark.parametrize('op_name', PER_OP)
def test_a8w8_single_op_matches_jax(op_name, monkeypatch):
  # The fixtures draw their weights from test_e2e_per_op's module RNG:
  # a generator of this test's own leaves that file's draws as they are.
  monkeypatch.setattr(test_e2e_per_op, 'RNG', _rng(op_name))
  jgraph = test_e2e_per_op._BUILDERS[op_name]()
  want_g, got_g = quantize_both(jgraph, 'default_a8w8')
  feed = jax_test_data.create_random_dataset(jgraph, num_samples=1,
                                             seed=7)['serving_default'][0]
  assert_quantized_runs_agree(want_g, got_g, feed)


def _tconv_graph(stride):
  rng = _rng(f'tconv{stride}')
  b = GraphBuilder('main')
  x = b.input('x', (1, 8, 8, 4))
  out = (1, 8 * stride, 8 * stride, 8)
  w = b.constant('tconv/w', _f(rng, 8, 3, 3, 4) * 0.2)
  shape_t = b.constant('tconv/shape', np.array(out, np.int32))
  bias = b.constant('tconv/b', _f(rng, 8) * 0.1)
  y = b.op('CONV_2D_TRANSPOSE', [shape_t, w, x, bias], [out],
           output_names=['tconv/out'],
           attrs={'stride': stride, 'padding': 'SAME'})
  b.output(y)
  return b.finalize()


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('recipe', ['default_a8w8', 'default_af32w8float'])
def test_conv2d_transpose_quantized_matches_jax(recipe, stride):
  jgraph = _tconv_graph(stride)
  want_g, got_g = quantize_both(jgraph, recipe)
  sg = got_g.subgraphs[0]
  assert sg.tensor_by_name('tconv/w').dtype == 'int8'
  feed = {'x': _f(_rng(f'tconv feed{stride}'), 1, 8, 8, 4)}
  assert_quantized_runs_agree(want_g, got_g, feed)


@pytest.mark.parametrize('op_name', [
    'BATCH_MATMUL', 'EMBEDDING_LOOKUP', 'CONV_2D', 'DEPTHWISE_CONV_2D'])
def test_base_op_test_case_weight_only_on_the_cpu(op_name, monkeypatch):
  """The port's `BaseOpTestCase` helper on tests/test_e2e_per_op.py's
  weight-only fixtures, with its bounds (size down by half, weight and
  output mse <= 1e-2), the CPU asked for."""
  monkeypatch.setattr(test_e2e_per_op, 'RNG', _rng(op_name))
  graph = to_port_graph(test_e2e_per_op._BUILDERS[op_name]())
  test_utils.BaseOpTestCase.assert_quantization_accuracy_and_size(
      graph, 'default_af32w8float', min_size_reduction=0.5,
      weight_tolerance=1e-2, output_tolerance=1e-2, device='cpu')


def test_base_op_test_case_runs_on_the_card_by_default():
  """The helpers' device is the `Quantizer`'s: the card, unless asked."""
  want = inspect.signature(Quantizer.calibrate).parameters['device'].default
  assert want == 'cuda'
  for fn in (test_utils.BaseOpTestCase.quantize_and_validate,
             test_utils.BaseOpTestCase.assert_quantization_accuracy_and_size):
    assert inspect.signature(fn).parameters['device'].default == want


@pytest.mark.parametrize('constraint', list(engine.OpQuantConstraint),
                         ids=lambda c: c.name)
def test_constrained_op_lists_match_jax(constraint):
  want = jax_constrained.get_constrained_op_list(
      jax_constrained.OpQuantConstraint[constraint.name])
  assert constrained_ops_utils.get_constrained_op_list(constraint) == want
  assert want or constraint == engine.OpQuantConstraint.NO_CONSTRAIN
