"""The port's lengths and flash attention against the JAX package's Pallas
kernels (interpret mode), on the CPU.

Inputs are made with numpy from a seed and fed to both sides; the port
runs the plain PyTorch versions (a CPU tensor never reaches a CUDA
kernel). chip_smoke.py holds the CUDA kernels against these plain
versions on the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels import attention


def _t(a):
  return torch.from_numpy(np.array(a))


def _j(a):
  return jnp.asarray(np.asarray(a))


# -- lengths-masked decode attention -------------------------------------------


@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('compute', ['f32', 'bf16', 'int8'])
def test_lengths_attention_matches_pallas(compute, out_dtype):
  b, nk, g, s, h = 4, 1, 8, 256, 128
  rng = np.random.default_rng(len(compute) + len(out_dtype))
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  k_cache = rng.integers(-127, 128, size=(b, nk, s, h)).astype(np.int8)
  v_cache = rng.integers(-127, 128, size=(b, nk, s, h)).astype(np.int8)
  # Empty (every row weighs 1/S), one row, a middle prefix, the full cache.
  lengths = np.array([0, 1, 37, s], np.int32)
  k_scale, v_scale, zp_k, zp_v = 0.05, 0.03, 3.0, -2.0
  want = np.asarray(pallas_attention.decode_attention_int8_lengths(
      _j(q), _j(k_cache), _j(v_cache), k_scale, v_scale, _j(lengths),
      k_zero_point=zp_k, v_zero_point=zp_v, compute=compute, batch_block=1,
      out_dtype=getattr(jnp, out_dtype), interpret=True).astype(jnp.float32))
  fn = attention.decode_attention_int8_lengths
  before = (fn.plain_calls, fn.launches)
  got = fn(_t(q), _t(k_cache), _t(v_cache), k_scale, v_scale, _t(lengths),
           k_zero_point=zp_k, v_zero_point=zp_v, compute=compute,
           out_dtype=getattr(torch, out_dtype))
  assert (fn.plain_calls, fn.launches) == (before[0] + 1, before[1])
  assert got.dtype == getattr(torch, out_dtype)
  got = got.to(torch.float32).numpy()
  # f32 sums in another order (1e-5 of values of order 1); in bf16 one
  # rounding of the output (2^-8 relative); with int8 compute one 7-bit
  # probability may round the other way (one step of 1/127 of a V code).
  tol = {'f32': 1e-5, 'bf16': 1e-5, 'int8': 2 * 127 * v_scale / 127}[compute]
  if out_dtype == 'bfloat16':
    tol = max(tol, 2.0**-8 * float(np.max(np.abs(want))))
  np.testing.assert_allclose(got, want, rtol=0, atol=tol)
  # length 0: the TPU kernel's max is -1e30 and every row weighs 1/S (in
  # int8 compute 1/S rounds to the 7-bit code 0 and the context to 0).
  mean_v = v_cache[0, 0].astype(np.float64).mean(axis=0)
  if compute == 'int8':
    mean_v = np.zeros_like(mean_v)
  np.testing.assert_allclose(
      got[0, 0], np.broadcast_to((mean_v - zp_v) * v_scale, (g, h)),
      atol=max(tol, 1e-4))


def test_lengths_attention_is_the_masked_twin_on_prefix_masks():
  """Exact twin of the additive-mask attention when the mask is a prefix:
  the executor's plain twin (softmax over masked scores) agrees."""
  b, nk, g, s, h = 3, 2, 4, 64, 32
  rng = np.random.default_rng(11)
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  k_cache = rng.integers(-127, 128, size=(b, nk, s, h)).astype(np.int8)
  v_cache = rng.integers(-127, 128, size=(b, nk, s, h)).astype(np.int8)
  lengths = np.array([1, 30, 64], np.int32)
  mask = np.where(np.arange(s)[None, :] < lengths[:, None], 0.0,
                  -1e9).astype(np.float32).reshape(b, 1, 1, s)
  want = np.asarray(pallas_attention.decode_attention_int8_masked(
      _j(q), _j(k_cache), _j(v_cache), 0.04, 0.02,
      _j(np.broadcast_to(mask, (b, 1, g, s))), batch_block=1,
      interpret=True))
  got = attention.decode_attention_int8_lengths(
      _t(q), _t(k_cache), _t(v_cache), 0.04, 0.02, _t(lengths)).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- flash attention (prefill) -----------------------------------------------


def _causal_mask(b, g, t, s, start):
  """The prefill device mask: query row (g, t) sees keys <= start + t."""
  pos = start + np.arange(t)
  rows = np.where(np.arange(s)[None, :] <= pos[:, None], 0.0, -1e9)
  return np.broadcast_to(rows, (b, 1, g, t, s)).reshape(
      b, 1, g * t, s).astype(np.float32).copy()


@pytest.mark.parametrize('nk,mask_nk', [(1, 1), (2, 1), (2, 2)])
def test_flash_attention_matches_pallas(nk, mask_nk):
  b, g, t, s, h = 2, 4, 16, 512, 64
  rng = np.random.default_rng(nk * 10 + mask_nk)
  q = rng.standard_normal((b, nk, g * t, h)).astype(np.float32)
  k_cache = rng.integers(-127, 128, size=(b, nk, s, h)).astype(np.int8)
  v_cache = rng.integers(-127, 128, size=(b, nk, s, h)).astype(np.int8)
  mask = _causal_mask(b, g, t, s, start=300)
  mask[1, :, 5, :] = -1e9  # one fully masked row
  if mask_nk == 2:
    mask = np.concatenate([mask, mask[:, :, ::-1].copy()], axis=1)
  k_scale, v_scale, zp_k, zp_v = 0.05, 0.03, 3.0, -2.0
  want = np.asarray(pallas_attention.flash_attention_int8_masked(
      _j(q), _j(k_cache), _j(v_cache), k_scale, v_scale, _j(mask),
      k_zero_point=zp_k, v_zero_point=zp_v, block_s=128, interpret=True))
  # The same S blocks as the TPU kernel (four of 128): the online softmax
  # rescales in the same places, so only summation order differs.
  got = attention.flash_attention_int8_masked_plain(
      _t(q), _t(k_cache), _t(v_cache), k_scale, v_scale, _t(mask),
      k_zero_point=zp_k, v_zero_point=zp_v, block_s=128).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
  # The fully masked row averages every V row, as the TPU kernel's does.
  assert np.all(np.isfinite(got))
  # The wrapper (TPU blocking, min(512, S) = one block) on a CPU tensor:
  # its plain version, within f32 rounding of the re-blocked online softmax.
  fn = attention.flash_attention_int8_masked
  before = (fn.plain_calls, fn.launches)
  got1 = fn(_t(q), _t(k_cache), _t(v_cache), k_scale, v_scale, _t(mask),
            k_zero_point=zp_k, v_zero_point=zp_v)
  assert (fn.plain_calls, fn.launches) == (before[0] + 1, before[1])
  assert got1.dtype == torch.float32 and got1.shape == (b, nk, g * t, h)
  np.testing.assert_allclose(got1.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('s,want_bs', [(1024, 512), (1536, 512), (640, 128),
                                       (384, 384), (64, 64)])
def test_flash_block_follows_the_tpu_kernel(s, want_bs):
  assert attention.flash_block_s(s) == want_bs


@pytest.mark.parametrize('status,raised', [
    (0, None), (_build.SHAPE_REFUSED, ValueError), (1, RuntimeError)])
def test_launch_status_raises_for_a_refused_shape(status, raised):
  """A C entry point refuses a shape its kernel does not take (the limits
  live beside the kernel in csrc/); the wrapper raises, launching nothing."""
  if raised is None:
    _build.check(status, 'k', 'H=384')
    return
  with pytest.raises(raised, match='k: '):
    _build.check(status, 'k', 'H=384')


# -- the executor's dispatch ------------------------------------------------------


@pytest.mark.parametrize('h,s,rows,attn_lengths,want', [
    (256, 1024, 1024, True, 'flash'),    # the server's prefill pass
    (256, 1024, 8, True, 'lengths'),     # the server's decode tick
    (256, 1024, 8, False, 'masked'),
    (128, 128, 32, False, 'flash'),      # 32 grouped rows: prefill-shaped
    (128, 128, 31, True, 'lengths'),
    # Shapes the CUDA kernels do not take but the JAX gate sends to Pallas:
    # they stay on the kernels' path, whose wrappers raise on the card.
    (256, 8192, 8, True, 'lengths'),     # G x S scores exceed shared memory
    (384, 1024, 1024, True, 'flash'),    # no flash kernel for H = 384
    # The JAX gate (H and S multiples of 128): the plain twin.
    (64, 1024, 1024, True, 'twin'),
    (256, 64, 8, True, 'twin'),
    (256, 1000, 1024, True, 'twin'),
])
def test_attention_route_is_the_jax_gate(h, s, rows, attn_lengths, want):
  from ai_edge_quantizer_tpu_torch.execution import executor
  assert executor.attention_route(h, s, rows, attn_lengths) == want


@pytest.mark.parametrize('head_dim,seq,sig,attn_lengths,ran', [
    (128, 128, 'prefill', True, 'flash'),    # >= 32 grouped rows
    (64, 128, 'prefill', True, None),        # H = 64: the plain twin
    (128, 64, 'prefill', True, None),        # S = 64: the plain twin
    (128, 128, 'decode', True, 'lengths'),   # decode rows, lengths mode
    (128, 128, 'decode', False, None),       # masked mode: neither kernel
    (256, 8192, 'decode', True, 'lengths'),  # refused by the CUDA kernel
])
def test_executor_dispatch_follows_the_kernel_gates(head_dim, seq, sig,
                                                    attn_lengths, ran):
  from ai_edge_quantizer_tpu_torch.execution import executor
  from ai_edge_quantizer_tpu_torch.models import gemma
  cfg = gemma.DecoderConfig(vocab_size=256, embed_dim=128, num_layers=2,
                            num_query_heads=8, num_kv_heads=1,
                            head_dim=head_dim, ffn_dim=256, max_seq_len=seq)
  graph = gemma.build_decoder(cfg, batch=2, prefill_len=16,
                              signatures=('prefill', 'decode'),
                              materialize_weights=False)
  gemma.stamp_int8_kv_cache(graph)
  ex = executor.GraphExecutor(graph, device='cpu',
                              activation_dtype='float32',
                              attn_lengths=attn_lengths, attn_writeback=None)
  ex.load_weights(gemma.device_materialize_quantized(graph, device='cpu'))
  t = 16 if sig == 'prefill' else 1
  inputs = gemma.make_inputs(cfg, sig, 2, t, device='cpu')
  wrappers = {'flash': attention.flash_attention_int8_masked,
              'lengths': attention.decode_attention_int8_lengths}
  before = {k: w.plain_calls for k, w in wrappers.items()}
  out = ex(inputs, sig)
  assert torch.isfinite(out['logits']).all()
  calls = {k: w.plain_calls - before[k] for k, w in wrappers.items()}
  assert calls == {k: cfg.num_layers if k == ran else 0 for k in wrappers}
