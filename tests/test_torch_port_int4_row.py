"""The port's last two TPU kernels and the int4-KV A/B tool, on the CPU.

Inputs made with numpy from a seed go through the Pallas kernels in
interpret mode, compiled with XLA's excess precision off (`_exact`: XLA on
the CPU otherwise drops the kernels' bf16 roundings), and through the
port's wrappers on CPU tensors, which run the plain versions:

  * `quantize_kv_rows_int4` (pallas_attention.py:1319): packed bytes and
    scales bit for bit;
  * `decode_attention_int4_lengths` (#21, pallas_attention.py:1376): G 8,
    H 128 and 256, S 256, lengths 0, 1, a middle prefix and S, f32 and
    bf16 outputs. q and the nibbles are exact in bf16 and their products
    exact in f32, so only the order of the f32 sums differs: within
    INT4_FINE of max |ctx|, except where a probability's bf16 operand
    bf16(p * vscale) rounds the other way (at most INT4_ROWS_OFF rows,
    each within one bf16 step of that operand times the largest V code,
    INT4_FLIP of max |ctx|); bf16 outputs one bf16 ulp beyond that. The
    XLA twin `decode_attention_int4_ref` (dequantize, then f32 attention)
    differs by the kernel's bf16 roundings of q and of p * vscale: within
    INT4_REF_RTOL of max |ctx|;
  * `decode_attention_int8` (#22, pallas_attention.py:57): the Pallas
    kernel's order (scale after the dot), f32 sums in another order:
    within 1e-5 of max(max |ctx|, 1); its plain version is the lengths
    attention's plain version with both zero points 0, bit for bit (its
    CUDA kernel runs that body);
  * the A/B tool (`tools/attn_int4_bench.py`) at B 2, S 256, L 2, H 128 on
    `--device cpu`: each format's chained output against the JAX kernel
    chained the same way on the same operands, and the same artifact keys
    as `scripts/attn_int4_bench.py`.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.tools import attn_int4_bench

from test_torch_port_attn_block import _exact

INT4_FINE = 1e-5      # of max |ctx|: f32 sums in another order
INT4_FLIP = 2.0**-8 * 8  # one bf16 step of p * vscale times |code| <= 8
INT4_ROWS_OFF = 1
INT4_REF_RTOL = 2e-2  # the twin leaves out the bf16 roundings


def _t(a):
  return torch.from_numpy(np.array(a))


def _j(a):
  return jnp.asarray(np.asarray(a))


def _rows(s, case):
  return {'empty': 0, 'one': 1, 'mid': 97, 'full': s}[case]


def _int4_case(seed, b=4, h=128, s=256):
  """q, K/V rows (the A/B tool's distributions), lengths 0, 1, 97, S."""
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, 1, 8, h)).astype(np.float32)
  k = (rng.standard_normal((b, 1, s, h)) * 0.3 + 0.4).astype(np.float32)
  v = (rng.standard_normal((b, 1, s, h)) * 0.3).astype(np.float32)
  lengths = np.array([_rows(s, c) for c in ('empty', 'one', 'mid', 'full')],
                     np.int32)[:b]
  return q, k, v, lengths


def _jax_scales(ks, vs, b, s):
  sc = jnp.zeros((b, 1, 8, s), jnp.bfloat16)
  sc = sc.at[:, :, 0, :].set(ks.astype(jnp.bfloat16))
  return sc.at[:, :, 1, :].set(vs.astype(jnp.bfloat16))


@pytest.mark.parametrize('h', [128, 256])
def test_quantize_kv_rows_int4_matches_jax(h):
  """Packed bytes, scales and the [B, NK, 8, S] bf16 scale operand bit for
  bit (half-to-even rounding of x / scale, scale max(absmax, 1e-9) *
  f32(1/7)), a zero row among them."""
  _, k, v, _ = _int4_case(h, h=h)
  k[0, 0, 3] = 0.0
  for x in (k, v):
    jp, js = pallas_attention.quantize_kv_rows_int4(_j(x))
    tp, ts = attention.quantize_kv_rows_int4(_t(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        attention.unpack_int4_rows(tp).numpy(),
        np.asarray(pallas_attention.unpack_int4_rows(jp)))
  _, ks = pallas_attention.quantize_kv_rows_int4(_j(k))
  _, vs = pallas_attention.quantize_kv_rows_int4(_j(v))
  b, _, s, _ = k.shape
  want = np.asarray(_jax_scales(ks, vs, b, s).astype(jnp.float32))
  got = attention.build_kv_scales_rows(_t(np.asarray(ks)), _t(np.asarray(vs)))
  assert got.dtype == torch.bfloat16
  np.testing.assert_array_equal(got.float().numpy(), want)


def _int4_operands(seed, h):
  q, k, v, lengths = _int4_case(seed, h=h)
  kp, ks = pallas_attention.quantize_kv_rows_int4(_j(k))
  vp, vs = pallas_attention.quantize_kv_rows_int4(_j(v))
  sc = _jax_scales(ks, vs, q.shape[0], k.shape[2])
  return q, kp, vp, sc, lengths


def _int4_check(got, want, bf16):
  """The rule of the module docstring; returns the rows beyond fine."""
  h = want.shape[-1]
  ymax = float(np.abs(want).max())
  diff = np.abs(got - want).reshape(-1, h)
  extra = (2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126)))
                   - 7)).reshape(-1, h) if bf16 else 0.0
  beyond = diff - extra
  off = int(np.sum(np.max(beyond, axis=1) > INT4_FINE * ymax))
  assert off <= INT4_ROWS_OFF, off
  assert np.max(beyond) <= (INT4_FINE + INT4_FLIP) * ymax, np.max(beyond)
  return off


@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('h', [128, 256])
def test_int4_row_attention_matches_pallas(h, out_dtype):
  q, kp, vp, sc, lengths = _int4_operands(h + len(out_dtype), h)
  jfn = _exact(pallas_attention.decode_attention_int4_lengths)
  want = np.asarray(jfn(
      _j(q), kp, vp, sc, _j(lengths), batch_block=1,
      out_dtype=getattr(jnp, out_dtype), interpret=True).astype(jnp.float32))
  fn = attention.decode_attention_int4_lengths
  before = (fn.plain_calls, fn.launches)
  got = fn(_t(q), _t(kp), _t(vp), _t(np.asarray(sc.astype(jnp.float32))).to(
      torch.bfloat16), _t(lengths), out_dtype=getattr(torch, out_dtype))
  assert (fn.plain_calls, fn.launches) == (before[0] + 1, before[1])
  assert got.dtype == getattr(torch, out_dtype)
  _int4_check(got.float().numpy(), want, out_dtype == 'bfloat16')
  # Length 0: the TPU kernel's max is -1e30, every row weighs 1/S.
  assert np.all(np.isfinite(got.float().numpy()[0]))


def test_int4_row_attention_near_the_float_twin():
  """decode_attention_int4_ref (q f32, the dequantized rows, f32
  attention) against the port: the kernel's bf16 roundings of q and of
  p * vscale only."""
  q, kp, vp, sc, lengths = _int4_operands(5, 256)
  want = np.asarray(pallas_attention.decode_attention_int4_ref(
      _j(q), kp, vp, sc, _j(lengths)))
  got = attention.decode_attention_int4_lengths(
      _t(q), _t(kp), _t(vp),
      _t(np.asarray(sc.astype(jnp.float32))).to(torch.bfloat16),
      _t(lengths)).numpy()
  err = np.abs(got - want).max() / np.abs(want).max()
  assert 0 < err <= INT4_REF_RTOL, err


def test_int4_row_plain_keeps_the_kernel_roundings(monkeypatch):
  """The check above can see a dropped rounding: without the bf16 rounding
  of p * vscale the plain version moves beyond the fine tolerance in most
  rows."""
  q, kp, vp, sc, lengths = _int4_operands(6, 128)
  scf = _t(np.asarray(sc.astype(jnp.float32))).to(torch.bfloat16)
  args = (_t(q), _t(kp), _t(vp), scf, _t(lengths))
  want = attention.decode_attention_int4_lengths_plain(*args).numpy()
  orig = attention._bf16_round
  calls = []

  def skip_second(t):
    calls.append(1)
    return t if len(calls) == 2 else orig(t)

  monkeypatch.setattr(attention, '_bf16_round', skip_second)
  dropped = attention.decode_attention_int4_lengths_plain(*args).numpy()
  assert len(calls) == 2
  ymax = np.abs(want).max()
  rows = np.max(np.abs(dropped - want).reshape(-1, 128), axis=1)
  assert np.sum(rows > INT4_FINE * ymax) > INT4_ROWS_OFF


def test_int4_row_attention_refuses_a_meta_tensor():
  """Only CPU tensors (the plain version) and CUDA tensors (the kernel)
  are taken."""
  q, kp, vp, sc, lengths = _int4_operands(7, 128)
  with pytest.raises(ValueError, match='meta'):
    attention.decode_attention_int4_lengths(
        _t(q).to('meta'), _t(kp), _t(vp), _t(np.zeros((4, 1, 8, 256),
                                                       np.float32)),
        _t(lengths))


# -- #22: the basic int8 decode attention -------------------------------------


@pytest.mark.parametrize('nk,h', [(1, 128), (1, 256), (2, 128)])
def test_int8_basic_attention_matches_pallas(nk, h):
  b, g, s = 4, 8, 256
  rng = np.random.default_rng(nk * 1000 + h)
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  kc = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  vc = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  lengths = np.array([0, 1, 97, s], np.int32)
  k_scale, v_scale = 0.05, 0.03
  want = np.asarray(pallas_attention.decode_attention_int8(
      _j(q), _j(kc), _j(vc), jnp.float32(k_scale), jnp.float32(v_scale),
      _j(lengths), interpret=True))
  fn = attention.decode_attention_int8
  before = (fn.plain_calls, fn.launches)
  got = fn(_t(q), _t(kc), _t(vc), k_scale, v_scale, _t(lengths))
  assert (fn.plain_calls, fn.launches) == (before[0] + 1, before[1])
  assert got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=1e-5 * max(np.abs(want).max(), 1.0))
  # Its CUDA kernel runs the lengths body with zero points 0: the plain
  # versions agree bit for bit.
  twin = attention.decode_attention_int8_lengths_plain(
      _t(q), _t(kc), _t(vc), k_scale, v_scale, _t(lengths))
  torch.testing.assert_close(got, twin, rtol=0, atol=0)
  # The XLA twin scales the caches before the dot: another rounding.
  ref = np.asarray(pallas_attention.decode_attention_int8_ref(
      _j(q), _j(kc), _j(vc), k_scale, v_scale, _j(lengths)))
  np.testing.assert_allclose(got.numpy()[1:], ref[1:], rtol=0, atol=1e-4)


# -- the A/B tool --------------------------------------------------------------

AB_ENV = dict(AEQT_AB_BATCH='2', AEQT_AB_SEQ='256', AEQT_AB_LAYERS='2',
              AEQT_AB_HEADDIM='128', AEQT_AB_ITERS='2')
# The chained outputs against the JAX kernels chained on the same operands,
# relative to their largest magnitude: int8 (f32 compute) f32 sums in
# another order; the int4 formats also round each launch's q to bf16, so
# an ulp of one launch's output may move the next q by a bf16 step.
AB_RTOL = {'int8': 1e-5, 'int4_row': 1e-3, 'int4_group': 1e-3}


@pytest.fixture(scope='module')
def ab_run():
  with pytest.MonkeyPatch.context() as mp:
    for key, val in AB_ENV.items():
      mp.setenv(key, val)
    return attn_int4_bench.main(['--device', 'cpu'])


def _jax_format(label, ops):
  """One launch of the JAX kernel of a format, on the tool's operands."""
  o = {k: (jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
           if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
           else jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
       for k, v in ops.items()}
  if label == 'int8':
    return lambda q: pallas_attention.decode_attention_int8_lengths(
        q, o['k8'], o['v8'], o['ks8'], o['vs8'], o['lengths'],
        batch_block=1, interpret=True)
  if label == 'int4_row':
    fn = _exact(pallas_attention.decode_attention_int4_lengths)
    return lambda q: fn(q, o['kp_r'], o['vp_r'], o['scales_r'], o['lengths'],
                        batch_block=1, interpret=True)
  fn = _exact(pallas_attention.decode_attention_int4_group_lengths)
  return lambda q: fn(q, o['kp_g'], o['vp_g'], o['sidecar'], o['lengths'],
                      group=attn_int4_bench.GROUP, batch_block=1,
                      interpret=True)


@pytest.mark.parametrize('label', ['int8', 'int4_row', 'int4_group'])
def test_ab_tool_matches_jax_kernels(label, ab_run):
  art, ops = ab_run['artifact'], ab_run['operands']
  fn = _jax_format(label, ops)
  out = jnp.asarray(ops['q'].numpy())
  for _ in range(art['iters']):
    for _ in range(art['L']):
      out = fn(out)
    out = out * 1e-3
  want = np.asarray(out)
  got = ab_run['outputs'][label].numpy()
  rel = np.abs(got - want).max() / np.abs(want).max()
  assert rel <= AB_RTOL[label], rel


def test_ab_tool_artifact(ab_run, capsys):
  art = ab_run['artifact']
  assert {k: art[k] for k in ('B', 'NK', 'G', 'H', 'S', 'L', 'group')} == dict(
      B=2, NK=1, G=8, H=128, S=256, L=2, group=16)
  assert art['backend'] == 'cpu'
  assert sorted(art['kernels']) == ['int4_group', 'int4_row', 'int8']
  for r in art['kernels'].values():
    # No time is taken on the CPU; the error is the format's own.
    assert r['ms'] is None and r['gbs'] is None
    assert 0 < r['rel_err_vs_float'] < 0.5
  # int4 per row loses most, per group less, int8 least (the JAX tool's
  # ordering on its own data).
  errs = {k: r['rel_err_vs_float'] for k, r in art['kernels'].items()}
  assert errs['int8'] < errs['int4_group'] < errs['int4_row']


def test_ab_tool_writes_only_with_out(tmp_path, monkeypatch, capsys):
  for key, val in AB_ENV.items():
    monkeypatch.setenv(key, val)
  monkeypatch.setenv('AEQT_AB_LAYERS', '1')
  monkeypatch.setenv('AEQT_AB_ITERS', '1')
  monkeypatch.chdir(tmp_path)
  attn_int4_bench.main(['--device', 'cpu'])
  assert not list(tmp_path.iterdir())
  printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert printed['L'] == 1
  out = tmp_path / 'ab.json'
  attn_int4_bench.main(['--device', 'cpu', '--out', str(out)])
  assert json.loads(out.read_text())['kernels'].keys() == printed[
      'kernels'].keys()


def test_ab_tool_refuses_cuda_without_a_card(monkeypatch):
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  for key, val in AB_ENV.items():
    monkeypatch.setenv(key, val)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    attn_int4_bench.main([])
