"""The port's op semantics (ops/impl.py) against the JAX package's."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu.graph import ir as jax_ir
from ai_edge_quantizer_tpu.ops import impl as jax_impl
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.ops import impl

_RNG = np.random.default_rng(0)


def _f(*shape):
  return _RNG.standard_normal(shape).astype(np.float32)


def _i(lo, hi, *shape):
  return _RNG.integers(lo, hi, size=shape).astype(np.int32)


# opcode -> (inputs, attrs, output shape, output dtype, exact)
CASES = {
    'FULLY_CONNECTED': ([_f(2, 3, 8), _f(5, 8), _f(5)],
                        {'fused_activation': 'RELU'}, (2, 3, 5), 'float32',
                        False),
    'BATCH_MATMUL': ([_f(2, 4, 6), _f(2, 5, 6)], {'adj_y': True}, (2, 4, 5),
                     'float32', False),
    'EMBEDDING_LOOKUP': ([_i(0, 10, 2, 3), _f(10, 4)], {}, (2, 3, 4),
                         'float32', True),
    'RMS_NORM': ([_f(2, 3, 16), _f(16)], {'epsilon': 1e-6}, (2, 3, 16),
                 'float32', False),
    'ROPE': ([_f(2, 3, 4, 8), _i(0, 50, 2, 3)], {'rope_base': 10000.0},
             (2, 3, 4, 8), 'float32', False),
    'GELU': ([_f(4, 64) * 3], {'approximate': True}, (4, 64), 'float32',
             False),
    'SOFTMAX': ([_f(3, 17)], {'beta': 1.0}, (3, 17), 'float32', False),
    'ADD': ([_f(2, 3), _f(3)], {}, (2, 3), 'float32', True),
    'SUB': ([_f(2, 3), _f(1)], {}, (2, 3), 'float32', True),
    'MUL': ([_f(2, 1, 3), _f(4, 1)], {}, (2, 4, 3), 'float32', True),
    'EQUAL': ([_i(0, 3, 4, 5), _i(0, 3, 5)], {}, (4, 5), 'bool', True),
    'LESS_EQUAL': ([_i(0, 9, 1, 8), _i(0, 9, 3, 1)], {}, (3, 8), 'bool',
                   True),
    'GREATER_EQUAL': ([_f(4, 5), _f(4, 5)], {}, (4, 5), 'bool', True),
    'RESHAPE': ([_f(2, 3, 4)], {}, (6, 4), 'float32', True),
    'TRANSPOSE': ([_f(2, 3, 4, 5)], {'perm': [0, 2, 1, 3]}, (2, 4, 3, 5),
                  'float32', True),
    'SLICE': ([_f(3, 8, 10)], {'begin': [0, 6, 2]}, (3, 4, 5), 'float32',
              True),  # begin 6 + 4 > 8: the start clamps to 4
    'BROADCAST_TO': ([_f(1, 3, 1)], {}, (2, 3, 4), 'float32', True),
    'CAST': ([_f(3, 4) * 5], {}, (3, 4), 'int32', True),
    'SUM': ([_f(2, 3, 4)], {'axis': [1], 'keep_dims': True}, (2, 1, 4),
            'float32', False),
    'REDUCE_MIN': ([_f(2, 3, 4)], {'axis': [2], 'keep_dims': False}, (2, 3),
                   'float32', True),
    'ARG_MAX': ([np.array([[1, 5, 5, 2], [7, 7, 0, 7]], np.float32)],
                {'axis': -1}, (2,), 'int32', True),
    'DYNAMIC_UPDATE_SLICE': ([_i(-9, 9, 2, 1, 6, 4), _i(-9, 9, 2, 1, 1, 4),
                              np.array([0, 0, 9, 0], np.int32)], {},
                             (2, 1, 6, 4), 'int32', True),  # start clamps
    # Inserted by the *_hadamard recipes (tests/test_torch_port_hadamard.py
    # holds it at bf16 too).
    'HADAMARD_ROTATION': ([_f(2, 3, 32)], {'hadamard_size': 8}, (2, 3, 32),
                          'float32', False),
}


def _ctx(mod, opcode, attrs, out_shape, out_dtype):
  sg = mod.Subgraph(name='main')
  sg.tensors.append(mod.Tensor(name='out', shape=tuple(out_shape),
                               dtype=out_dtype))
  op = mod.Op(opcode=opcode, inputs=[], outputs=[0], attrs=dict(attrs))
  return op, sg


@pytest.mark.parametrize('opcode', sorted(CASES))
def test_op_matches_jax(opcode):
  inputs, attrs, out_shape, out_dtype, exact = CASES[opcode]
  jop, jsg = _ctx(jax_ir, opcode, attrs, out_shape, out_dtype)
  top, tsg = _ctx(ir, opcode, attrs, out_shape, out_dtype)
  want = jax_impl.OPS[opcode](
      jax_impl.OpContext(op=jop, subgraph=jsg, graph=jax_ir.Graph()),
      *[jnp.asarray(x) for x in inputs])
  got = impl.OPS[opcode](
      impl.OpContext(op=top, subgraph=tsg, graph=ir.Graph()),
      *[torch.from_numpy(np.array(x)) for x in inputs])
  want = np.asarray(want)
  got = got.numpy()
  assert got.shape == want.shape == tuple(out_shape)
  assert got.dtype == want.dtype
  if exact:
    np.testing.assert_array_equal(got, want)
  else:
    # Different libm / summation order: a few float32 ulps.
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


# The int4-group KV cache's ops, held against the JAX package's in
# tests/test_torch_port_int4g.py.
INT4G_OPCODES = {'INT4G_ATTENTION', 'INT4G_ATTENTION_SCATTER'}


def test_registry_covers_the_decode_graph():
  assert set(impl.OPS) == set(CASES) | INT4G_OPCODES
