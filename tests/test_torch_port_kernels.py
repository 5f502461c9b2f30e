"""The PyTorch port's kernel modules against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both sides. The JAX side
runs its Pallas kernels in interpret mode, as its own tests do; the port
runs the plain PyTorch versions (a CPU tensor never reaches a CUDA
kernel). The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu.execution import quant_arith as jax_quant_arith
from ai_edge_quantizer_tpu.graph import ir as jax_ir
from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu.kernels import pallas_head
from ai_edge_quantizer_tpu.kernels import pallas_mlp
from ai_edge_quantizer_tpu.kernels import pallas_qmatmul
from ai_edge_quantizer_tpu.kernels import qmatmul as jax_qmatmul
from ai_edge_quantizer_tpu_torch.execution import quant_arith
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.kernels import head
from ai_edge_quantizer_tpu_torch.kernels import mlp
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import qmatmul


def _t(a):
  return torch.from_numpy(np.array(a))


def _j(a):
  return jnp.asarray(np.asarray(a))


def _bf16_ulps(got, want, atol=0.0):
  """Largest |got - want|, less atol, in bf16 units in the last place of
  want."""
  w = np.asarray(want, np.float32)
  ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0**-126))) - 7)
  diff = np.maximum(np.abs(np.asarray(got, np.float32) - w) - atol, 0.0)
  return float(np.max(diff / ulp))


# -- byte layouts -------------------------------------------------------------


@pytest.mark.parametrize('n,k,group', [(8, 32, 8), (128, 256, 128),
                                       (40, 512, 64)])
def test_int4_packing_byte_identical(n, k, group):
  rng = np.random.default_rng(n + k)
  w_q = rng.integers(-8, 8, size=(n, k)).astype(np.int8)
  want = np.asarray(pallas_qmatmul.pack_int4_split(_j(w_q)))
  got = packed_qmatmul.pack_int4_split(_t(w_q)).numpy()
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(
      packed_qmatmul.unpack_int4_split(_t(want)).numpy(),
      np.asarray(pallas_qmatmul.unpack_int4_split(_j(want))))
  want_g = np.asarray(pallas_mlp.pack_int4_split_grouped(_j(w_q), group))
  got_g = mlp.pack_int4_split_grouped(_t(w_q), group).numpy()
  np.testing.assert_array_equal(got_g, want_g)
  np.testing.assert_array_equal(
      mlp.unpack_int4_split_grouped(_t(want_g), group).numpy(),
      np.asarray(pallas_mlp.unpack_int4_split_grouped(_j(want_g), group)))
  np.testing.assert_array_equal(
      mlp.unpack_int4_split_grouped(_t(want_g), group).numpy(), w_q)


# -- int4 DRQ matmul -----------------------------------------------------------


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('with_bias', [False, True])
@pytest.mark.parametrize('k,n', [(256, 256), (512, 384)])
@pytest.mark.parametrize('m', [1, 5, 64])
def test_qmatmul_int4_packed_drq_matches_pallas(m, k, n, with_bias, dtype):
  rng = np.random.default_rng(m * 7 + k + n)
  x = rng.standard_normal((m, k)).astype(np.float32)
  w_q = rng.integers(-8, 8, size=(n, k)).astype(np.int8)
  scale = (rng.uniform(0.5, 2.0, size=n) * 0.01).astype(np.float32)
  bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
  w_packed = np.asarray(pallas_qmatmul.pack_int4_split(_j(w_q)))
  jx = _j(x).astype(jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32)
  want = np.asarray(pallas_qmatmul.qmatmul_pallas_int4_packed_drq(
      jx, _j(w_packed), _j(scale),
      bias=None if bias is None else _j(bias), interpret=True
  ).astype(jnp.float32))
  tx = _t(x).to(getattr(torch, dtype))
  calls = packed_qmatmul.qmatmul_int4_packed_drq.plain_calls
  got = packed_qmatmul.qmatmul_int4_packed_drq(
      tx, _t(w_packed), _t(scale), bias=None if bias is None else _t(bias))
  assert got.dtype == tx.dtype and got.shape == (m, n)
  assert packed_qmatmul.qmatmul_int4_packed_drq.plain_calls == calls + 1
  got = got.to(torch.float32).numpy()
  # XLA on the CPU contracts (acc * xs) * s + bias into one FMA; the port
  # rounds the product first (as the kernel's formula reads), so with a
  # bias the sum may differ by half an f32 ulp of the product term.
  atol = np.finfo(np.float32).eps * np.max(np.abs(want)) if with_bias else 0.0
  if dtype == 'float32':
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
  else:
    assert _bf16_ulps(got, want, atol) <= 1.0


# -- stale-cache attention -------------------------------------------------------


@pytest.mark.parametrize('nk,g,compute', [(1, 2, 'f32'), (1, 8, 'f32'),
                                          (2, 2, 'f32'), (2, 8, 'f32'),
                                          (2, 8, 'bf16'), (1, 8, 'int8')])
def test_stale_attention_matches_pallas(nk, g, compute):
  b, s, h = 3, 256, 128
  rng = np.random.default_rng(nk * 10 + g)
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  k_cache = rng.integers(-127, 128, size=(b, nk, s, h)).astype(np.int8)
  v_cache = rng.integers(-127, 128, size=(b, nk, s, h)).astype(np.int8)
  k_new = rng.integers(-127, 128, size=(b, nk, 1, h)).astype(np.int8)
  v_new = rng.integers(-127, 128, size=(b, nk, 1, h)).astype(np.int8)
  lengths = np.array([1, s, 97], np.int32)  # the new row only; full; mid
  k_scale, v_scale, zp_k, zp_v = 0.05, 0.03, 3.0, -2.0
  want = np.asarray(pallas_attention.decode_attention_int8_lengths_stale(
      _j(q), _j(k_cache), _j(v_cache), k_scale, v_scale, _j(lengths),
      _j(k_new), _j(v_new), k_zero_point=zp_k, v_zero_point=zp_v,
      compute=compute, batch_block=1, interpret=True))
  got = attention.decode_attention_int8_lengths_stale(
      _t(q), _t(k_cache), _t(v_cache), k_scale, v_scale, _t(lengths),
      _t(k_new), _t(v_new), k_zero_point=zp_k, v_zero_point=zp_v,
      compute=compute).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- MLP ------------------------------------------------------------------------


def _mlp_case(seed, m=8, d=256, f=512, bf=128):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((m, d)).astype(np.float32)
  wgu = rng.integers(-8, 8, size=(2 * f, d)).astype(np.int8)
  wd = rng.integers(-8, 8, size=(d, f)).astype(np.int8)
  s_gu = (rng.uniform(0.5, 2.0, size=2 * f) * 0.02).astype(np.float32)
  s_d = (rng.uniform(0.5, 2.0, size=d) * 0.02).astype(np.float32)
  wgu_p = np.asarray(pallas_qmatmul.pack_int4_split(_j(wgu)))
  wd_g = np.asarray(pallas_mlp.pack_int4_split_grouped(_j(wd), bf))
  return x, wgu_p, s_gu, wd_g, s_d


@pytest.mark.parametrize('drq,act,bf', [(True, 'gelu', 128),
                                        (True, 'gelu', 256),
                                        (True, 'silu', 128),
                                        (True, 'silu', 256),
                                        (False, 'gelu', 128)])
def test_mlp_int4_packed_matches_pallas(drq, act, bf):
  x, wgu_p, s_gu, wd_g, s_d = _mlp_case(bf + len(act), bf=bf)
  want = np.asarray(pallas_mlp.mlp_pallas_int4_packed(
      _j(x), _j(wgu_p), _j(s_gu), _j(wd_g), _j(s_d), act=act, drq=drq,
      bf=bf, interpret=True))
  got = mlp.mlp_int4_packed(_t(x), _t(wgu_p), _t(s_gu), _t(wd_g), _t(s_d),
                            act=act, drq=drq, bf=bf).numpy()
  # XLA's tanh/logistic and torch's differ by an ulp or two; one such
  # difference may flip the int8 rounding of one hidden value (a change
  # of one step of its group scale in one product), hence 1e-3 * max|y|.
  assert np.max(np.abs(got - want)) <= 1e-3 * np.max(np.abs(want))


# -- greedy head -----------------------------------------------------------------


@pytest.mark.parametrize('drq', [True, False])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('packed', [False, True])
def test_head_argmax_matches_pallas(packed, dtype, drq):
  m, n, k, true_n = 6, 640, 256, 600
  rng = np.random.default_rng(int(packed) * 2 + len(dtype))
  # Positive activations: rows whose weights are all +7 then score highest.
  x = (np.abs(rng.standard_normal((m, k))) + 0.1).astype(np.float32)
  w_q = rng.integers(-7, 8, size=(n, k)).astype(np.int8)
  scale = np.full(n, 0.01, np.float32)
  # A tie planted across two 128-wide tiles: rows 10 and 300 are equal and
  # win; padded rows >= true_n have huge scales and must never win.
  w_q[10] = w_q[300] = 7
  scale[10] = scale[300] = 0.05
  scale[true_n:] = 100.0
  w = (np.asarray(pallas_qmatmul.pack_int4_split(_j(w_q))) if packed
       else w_q)
  jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
  want = np.asarray(pallas_head.head_argmax_pallas(
      _j(x).astype(jdt), _j(w), _j(scale), packed=packed, true_n=true_n,
      bn=128, drq=drq, interpret=True))
  got = head.head_argmax(_t(x).to(getattr(torch, dtype)), _t(w), _t(scale),
                         packed=packed, true_n=true_n, drq=drq).numpy()
  np.testing.assert_array_equal(got, want)
  assert (got == 10).all()  # the first index of the tie, for every row


def test_head_argmax_without_planted_winner():
  m, n, k = 9, 512, 128
  rng = np.random.default_rng(5)
  x = rng.standard_normal((m, k)).astype(np.float32)
  w_q = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
  scale = (rng.uniform(0.5, 2.0, size=n) * 0.01).astype(np.float32)
  want = np.asarray(pallas_head.head_argmax_pallas(
      _j(x), _j(w_q), _j(scale), packed=False, bn=128, drq=True,
      interpret=True))
  got = head.head_argmax(_t(x), _t(w_q), _t(scale), packed=False).numpy()
  np.testing.assert_array_equal(got, want)


# -- plain twins of kernels/qmatmul.py and quant_arith ---------------------------


@pytest.mark.parametrize('case', ['channelwise', 'zero_point', 'blockwise',
                                  'drq'])
def test_qmatmul_twins_match_jax(case):
  rng = np.random.default_rng(len(case))
  n, k, bs = 32, 128, 32
  x = rng.standard_normal((4, k)).astype(np.float32)
  w_q = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
  scale = (rng.uniform(0.5, 2.0, size=n) * 0.01).astype(np.float32)
  bias = rng.standard_normal(n).astype(np.float32)
  if case == 'drq':
    want = jax_qmatmul.drq_matmul_ref(_j(x), _j(w_q), _j(scale), _j(bias))
    got = qmatmul.drq_matmul_ref(_t(x), _t(w_q), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    xq, xs = qmatmul.dynamic_quantize_activation(_t(x))
    jxq, jxs = jax_qmatmul.dynamic_quantize_activation(_j(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    return
  zp = None
  block = 0
  if case == 'zero_point':
    zp = rng.integers(-3, 4, size=n).astype(np.int32)
  if case == 'blockwise':
    block = bs
    scale = (rng.uniform(0.5, 2.0, size=(n, k // bs)) * 0.01).astype(
        np.float32)
  want = jax_qmatmul.qmatmul_ref(
      _j(x), _j(w_q), _j(scale), zero_point=None if zp is None else _j(zp),
      bias=_j(bias), block_size=block)
  got = qmatmul.qmatmul_ref(
      _t(x), _t(w_q), _t(scale), zero_point=None if zp is None else _t(zp),
      bias=_t(bias), block_size=block)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)


@pytest.mark.parametrize('kind', ['per_tensor', 'per_channel', 'zero_point'])
def test_quant_arith_matches_jax(kind):
  rng = np.random.default_rng(len(kind))
  x = (rng.standard_normal((4, 6)) * 3).astype(np.float32)
  if kind == 'per_tensor':
    scale, zp, qdim = np.array([0.06], np.float32), np.array([0]), None
  elif kind == 'per_channel':
    scale = rng.uniform(0.01, 0.1, size=6).astype(np.float32)
    zp, qdim = np.zeros(6, np.int64), 1
  else:
    scale, zp, qdim = np.array([0.05], np.float32), np.array([3]), None
  infos = [mod.QuantizationInfo(scale=scale, zero_point=zp,
                                quantized_dimension=qdim, num_bits=8)
           for mod in (jax_ir, ir)]
  want = np.asarray(jax_quant_arith.quantize(_j(x), infos[0], jnp.int8))
  got = quant_arith.quantize(_t(x), infos[1], torch.int8).numpy()
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(
      quant_arith.dequantize(_t(want), infos[1]).numpy(),
      np.asarray(jax_quant_arith.dequantize(_j(want), infos[0])))
