"""The bf16 and int8 compute modes of the masked (#17), splice (#8) and
out-projection-epilogue (#19) attentions of the port, on the CPU.

Kernels: inputs made with numpy from a seed go through the Pallas kernels
in interpret mode, compiled with XLA's excess precision off (`_exact`),
with `compute` set, and through the port's wrappers on CPU tensors, which
run the plain versions. The contexts are held by the rule of
tests/test_torch_port_attn_compute.py (`_check_ctx`: a row within
MODE_FINE of max(max |ctx|, 1), but at most MODE_ROWS_OFF rows within
MODE_FLIP_STEPS steps of a flipped probability operand):
  * #17 `decode_attention_int8_masked`: NK 1 and 2, H 128 and 256, S 128
    and 256, a [B, 1, 1, S] prefix mask and a [B, 1, G, S] mask with holes,
    each with an idle row (-1e9 everywhere: uniform weights; in int8 every
    code is rint(127 / S), 1 at S 128 and 0 at S 256, where the context is
    -zp_v * v_scale), zero points 3 and -2;
  * #8 `decode_attention_int8_lengths_writeback`: pos inside a 32-row tile
    and at its edge, lengths pos + 1, a shorter one and 0 (all S rows at
    1/S, the spliced one among them) at S 128 and 256; both pools bit for
    bit;
  * #19 `decode_attention_oproj`: DRQ and weight-only, f32 and bf16 x, by
    the rule of test_attention_oproj_matches_pallas with the context in
    the mode.

Slice, against the JAX executor, whose dispatch off a TPU differs by mode
(named here, not hidden):
  * it runs #17 on its f32 XLA twin whatever the mode (executor.py:2047)
    and #8 not at all (it writes by DUS and attends with the twin,
    executor.py:1686-1692): the port's default-mode DecodeServer in each
    mode gives the JAX server's tokens with #17 held to f32, and the
    splice decode step the JAX executor's logits and caches with #8 held
    to f32; run in the mode, their contexts differ from f32 on the same
    inputs by more than nothing and at most MODE_VS_F32;
  * it runs #19 in interpret mode in the mode (executor.py:2032-2036): the
    attention-block decode step in each mode is held to it directly.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.parallel import batching as jax_batching
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul as pq
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.parallel import batching

import test_torch_port_attn_block as attn_block
from test_torch_port_attn_compute import MODE_FINE, MODE_FLIP_STEPS
from test_torch_port_attn_compute import MODE_VS_F32, MODES
from test_torch_port_attn_compute import _Recorder, _check_ctx, _flip_step
from test_torch_port_cache_modes import STEPS, _assert_step_matches
from test_torch_port_cache_modes import _decode_pair, _inputs
from test_torch_port_cache_modes import _random_caches, _steps
from test_torch_port_default_mode import DEFAULT_CFG, _quantized
from test_torch_port_serving import SLOTS, _finished, _serve, _trace
from test_torch_port_serving import _track

_exact = attn_block._exact
MASKED = attention.decode_attention_int8_masked
WRITEBACK = attention.decode_attention_int8_lengths_writeback
OPROJ = attention.decode_attention_oproj
ZP_K, ZP_V, K_SCALE, V_SCALE = 3.0, -2.0, 0.05, 0.03


def _t(a):
  return torch.from_numpy(np.array(a))


def _j(a):
  return jnp.asarray(np.asarray(a))


def _as_f32(a):
  return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _run_counted(wrapper, *args, **kw):
  """wrapper(*args, **kw) on CPU tensors: one plain run, no launch."""
  before = (wrapper.plain_calls, wrapper.launches)
  out = wrapper(*args, **kw)
  assert (wrapper.plain_calls, wrapper.launches) == (before[0] + 1,
                                                     before[1])
  return out


# -- #17: the additive-mask decode attention -----------------------------------


def _mask(kind, b, g, s, rng):
  """'row' [B, 1, 1, S]: prefixes (one of a single column, one of S);
  'group' [B, 1, G, S]: random holes that differ by query row. Row 1 is
  idle in both (-1e9 everywhere)."""
  if kind == 'group':
    mask = np.where(rng.random((b, 1, g, s)) < 0.4, -1e9, 0.0)
  else:
    lengths = rng.integers(1, s + 1, b)
    lengths[0], lengths[-1] = 1, s
    mask = np.where(np.arange(s)[None] < lengths[:, None], 0.0, -1e9)
    mask = mask.reshape(b, 1, 1, s)
  mask = mask.astype(np.float32)
  mask[1] = -1e9
  return mask


@pytest.mark.parametrize('nk,h,kind,s', [(1, 128, 'row', 256),
                                         (1, 256, 'group', 256),
                                         (2, 128, 'row', 128),
                                         (2, 256, 'group', 128)])
@pytest.mark.parametrize('mode', MODES)
def test_masked_attention_mode_matches_pallas(mode, nk, h, kind, s):
  """The plain version against interpret-mode Pallas in the mode; the idle
  row weighs every cache row 1/S (int8: code 1 at S 128, so the mean of V;
  code 0 at S 256, so -zp_v * v_scale exactly)."""
  b, g = 4, 8
  rng = np.random.default_rng(h + nk + s + len(kind))
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  kc = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  vc = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  mask = _mask(kind, b, g, s, rng)
  fn = _exact(pallas_attention.decode_attention_int8_masked)
  want = np.asarray(fn(_j(q), _j(kc), _j(vc), K_SCALE, V_SCALE, _j(mask),
                       k_zero_point=ZP_K, v_zero_point=ZP_V, compute=mode,
                       interpret=True))
  got = _run_counted(MASKED, _t(q), _t(kc), _t(vc), K_SCALE, V_SCALE,
                     _t(mask), k_zero_point=ZP_K, v_zero_point=ZP_V,
                     compute=mode)
  assert got.dtype == torch.float32 and got.shape == (b, nk, g, h)
  got = got.numpy()
  _check_ctx(got, want, mode, V_SCALE, ZP_V)
  idle = got[1]
  if mode == 'int8' and s == 256:
    want_idle = (np.float32(0.0) - np.float32(ZP_V)) * np.float32(V_SCALE)
    np.testing.assert_array_equal(idle, np.full_like(idle, want_idle))
  else:
    mean_v = vc[1].astype(np.float64).mean(axis=1, keepdims=True)
    np.testing.assert_allclose(
        idle, np.broadcast_to((mean_v - ZP_V) * V_SCALE, idle.shape),
        atol=2e-3)
  # The mode ran: the f32 plain version differs.
  f32 = attention.decode_attention_int8_masked_plain(
      _t(q), _t(kc), _t(vc), K_SCALE, V_SCALE, _t(mask), ZP_K, ZP_V)
  assert not np.array_equal(f32.numpy(), got)


# -- #8: the splice attention ---------------------------------------------------


@pytest.mark.parametrize('pos,s', [(31, 128), (32, 256), (255, 256)])
@pytest.mark.parametrize('mode', MODES)
def test_splice_mode_matches_pallas(mode, pos, s):
  """Row pos of both caches replaced by the new rows and written in place,
  bit for bit; the context in the mode. Lengths pos + 1, a shorter prefix
  and 0: all S rows at 1/S, the spliced one among them (int8: S codes of 1
  at S 128, of 0 at S 256)."""
  b, nk, g, h = 3, 2, 4, 128
  rng = np.random.default_rng(pos + s)
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  kc, vc = (rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
            for _ in range(2))
  kn, vn = (rng.integers(-127, 128, (b, nk, 1, h)).astype(np.int8)
            for _ in range(2))
  lengths = np.array([pos + 1, max(pos - 20, 1), 0], np.int32)
  kw = dict(k_zero_point=ZP_K, v_zero_point=ZP_V, compute=mode)
  ctx, k_out, v_out = _exact(
      pallas_attention.decode_attention_int8_lengths_writeback)(
          _j(q), _j(kc), _j(vc), K_SCALE, V_SCALE, _j(lengths), _j(kn),
          _j(vn), jnp.int32(pos), batch_block=2, interpret=True, **kw)
  tk, tv = _t(kc), _t(vc)
  got, gk, gv = _run_counted(WRITEBACK, _t(q), tk, tv, K_SCALE, V_SCALE,
                             _t(lengths), _t(kn), _t(vn), pos, **kw)
  assert gk is tk and gv is tv
  np.testing.assert_array_equal(tk.numpy(), np.asarray(k_out))
  np.testing.assert_array_equal(tv.numpy(), np.asarray(v_out))
  _check_ctx(got.numpy(), np.asarray(ctx), mode, V_SCALE, ZP_V)
  zero = got.numpy()[2]
  if mode == 'int8' and s == 256:
    want_zero = (np.float32(0.0) - np.float32(ZP_V)) * np.float32(V_SCALE)
    np.testing.assert_array_equal(zero, np.full_like(zero, want_zero))
  else:  # every row weighs 1/S: the mean of the spliced V rows
    mean_v = tv.numpy()[2].astype(np.float64).mean(axis=1, keepdims=True)
    np.testing.assert_allclose(
        zero, np.broadcast_to((mean_v - ZP_V) * V_SCALE, zero.shape),
        atol=2e-3)


# -- #19: attention + out projection + residual ---------------------------------


def _jax_ctx(q, kq, vq, lens, cast, mode):
  """The Pallas epilogue's context in the mode: its body `_ctx_prefix_len`
  row by row, q rounded to the activation dtype, the result cast to it,
  compiled as the kernel is."""
  scales = jnp.asarray([[*attn_block.SCALES, attn_block.KW['k_zero_point'],
                         attn_block.KW['v_zero_point']]], jnp.float32)

  def rows(q, kq, vq, lens):
    qf = q.astype(cast).astype(jnp.float32)
    return jnp.stack([pallas_attention._ctx_prefix_len(
        mode, qf[b, 0], kq[b, 0], vq[b, 0], lens[b], scales).astype(cast)
                      for b in range(q.shape[0])])

  return _exact(rows)(_j(q), _j(kq), _j(vq), _j(lens))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('drq', [True, False])
@pytest.mark.parametrize('mode', MODES)
def test_attention_oproj_mode_matches_pallas(mode, drq, dtype):
  """test_attention_oproj_matches_pallas's rule in the mode: B 8 (lengths
  0, S and random), G 4, H 128, S 128, D 256. The plain context in the
  mode against the Pallas kernel's by _check_ctx; end to end, rows within
  1e-5 of max |y| (DRQ) or int_weights_tolerance plus 1e-5 (weight-only),
  one bf16 ulp more at bf16, but for rows whose context differs beyond
  MODE_FINE (each within its flip steps through the projection) and at
  most ROWS_OFF DRQ rows within two code steps; given the kernel's
  context, the projection and residual bit for bit (DRQ at bf16) or as
  there."""
  q, kq, vq, lens, x, wo, so = attn_block._oproj_case(5 + drq)
  cast = getattr(jnp, dtype)
  kw = dict(attn_block.KW, compute=mode)
  jx = jnp.asarray(x, dtype)
  want = _as_f32(_exact(pallas_attention.decode_attention_oproj_pallas)(
      _j(q), _j(kq), _j(vq), *attn_block.SCALES, _j(lens), jx, _j(wo),
      _j(so), drq=drq, interpret=True, **kw))
  tx = _t(_as_f32(jx)).to(getattr(torch, dtype))
  got = _run_counted(OPROJ, _t(q), _t(kq), _t(vq), *attn_block.SCALES,
                     _t(lens), tx, _t(wo), _t(so), drq=drq, **kw)
  assert got.dtype == tx.dtype and got.shape == x.shape
  got = got.float().numpy()
  b, k = len(x), q.shape[2] * q.shape[3]
  jctx = _as_f32(_jax_ctx(q, kq, vq, lens, cast, mode)).reshape(b, k)
  tctx = attention.decode_attention_int8_lengths_plain(
      _t(q).to(getattr(torch, dtype)).float(), _t(kq), _t(vq),
      *attn_block.SCALES, _t(lens), compute=mode,
      out_dtype=getattr(torch, dtype), **attn_block.KW).reshape(b, k)
  v_scale, zp_v = attn_block.SCALES[1], attn_block.KW['v_zero_point']
  fine = MODE_FINE if dtype == 'float32' else 2.0**-8
  _check_ctx(tctx.float().numpy(), jctx, mode, v_scale, zp_v, fine)
  ctx_off = np.max(np.abs(tctx.float().numpy() - jctx), axis=1) > (
      fine * max(np.abs(jctx).max(), 1.0))
  bf16 = dtype == 'bfloat16'
  ymax = float(np.abs(want).max())
  tol = 1e-5 * ymax + (0.0 if drq else attn_block.int_qmatmul
                       .int_weights_tolerance(k, 0, ymax))
  if bf16:
    tol = tol + attn_block._bf16_ulp(want)
  err = np.abs(got - want)
  rows_off = np.nonzero(np.any(err > tol, axis=1))[0]
  xs = np.maximum(np.abs(jctx).max(axis=1), 1e-9) / 127.0
  drq_rows = [r for r in rows_off if not ctx_off[r]]
  assert len(drq_rows) <= (attn_block.ROWS_OFF if drq else 0), rows_off
  for r in rows_off:
    # A context that moved by flipped probability operands moves y through
    # every weight (8 * so at most), its DRQ codes by a step each.
    bound = (k * 8 * so.max() * (MODE_FLIP_STEPS * _flip_step(
        mode, v_scale, zp_v) + 2 * xs[r]) if ctx_off[r]
             else 2 * 8 * xs[r] * so.max())
    assert err[r].max() <= bound + np.max(tol), r
  # Given the Pallas kernel's context: the projection and the residual.
  tj = _t(jctx).to(getattr(torch, dtype))
  o = (pq.qmatmul_int4_packed_drq_plain if drq
       else pq.qmatmul_int4_packed_plain)(tj, _t(wo), _t(so))
  y = (tx + o).float().numpy()
  if drq and bf16:
    np.testing.assert_array_equal(y, want)
  elif drq:  # XLA on the CPU contracts x + o into an FMA
    bound = 2.0**-22 * (np.abs(x) + np.abs(o.numpy()) + np.abs(want))
    assert np.all(np.abs(y - want) <= bound)
  else:
    assert attn_block._within(y, want, tol, bf16)


def test_attention_oproj_refuses_an_unknown_mode():
  """compute must be one of the three (ValueError, as the lengths plain
  version and the C code refuse it); the shape errors stay ValueErrors
  in every mode."""
  q, kq, vq, lens, x, wo, so = attn_block._oproj_case(0)
  args = (_t(q), _t(kq), _t(vq), *attn_block.SCALES, _t(lens), _t(x),
          _t(wo), _t(so))
  with pytest.raises(ValueError, match='compute'):
    OPROJ(*args, compute='fp8')
  for mode in MODES:
    with pytest.raises(ValueError, match='even head count'):
      OPROJ(_t(q[:, :, :3]), *args[1:], compute=mode)


# -- the slice --------------------------------------------------------------------


def _record(monkeypatch, name, as_jax):
  rec = _Recorder(getattr(attention, name),
                  getattr(attention, f'{name}_plain'), as_jax)
  monkeypatch.setattr(attention, name, rec)
  return rec


@pytest.fixture(scope='module')
def default_jax_server():
  """The JAX DecodeServer with no AEQT_* variable set over serve_gemma's
  quantization of the toy serving graph (F 1024, so the MLP fuses), and
  the port's quantization of the same graph; one JAX server for both
  modes (it runs #17 at f32 off a TPU whatever AEQT_ATTN_COMPUTE says)."""
  with pytest.MonkeyPatch.context() as mp:
    for var in [v for v in os.environ if v.startswith('AEQT_')]:
      mp.delenv(var)
    jcfg = jax_gemma.DecoderConfig(**DEFAULT_CFG)
    tcfg = gemma.DecoderConfig(**DEFAULT_CFG)
    jserver = jax_batching.DecodeServer(
        _quantized(jax_gemma, JaxQuantizer, jcfg), jcfg, SLOTS,
        pack_weights=True, activation_dtype='float32', starvation_age_s=None)
    jserver._executor.prepare_serving_weights(min_weight_params=0)
    _track(jserver)
    yield jserver, _quantized(gemma, Quantizer, tcfg), tcfg


def _default_port_server(graph, cfg, mode):
  server = batching.DecodeServer(
      graph, cfg, SLOTS, pack_weights=True, activation_dtype='float32',
      device='cpu', starvation_age_s=None,
      executor_options={**executor.JAX_DEFAULT_OPTIONS, 'attn_compute': mode})
  server._executor.prepare_serving_weights(min_weight_params=0)
  _track(server)
  return server


@pytest.mark.parametrize('mode', MODES)
def test_default_mode_server_matches_jax_with_masked_at_f32(
    mode, default_jax_server, monkeypatch):
  """The port's default-mode server in the mode, its ticks' masked
  attention held to f32 (the JAX executor's twin off a TPU): the JAX
  server's tokens. The executor asked for the mode at every call."""
  jserver, graph, cfg = default_jax_server
  tserver = _default_port_server(graph, cfg, mode)
  assert tserver._executor.attn_compute == mode
  rec = _record(monkeypatch, 'decode_attention_int8_masked', as_jax=True)
  trace = _trace(cfg, seed=len(mode))
  jids = _serve(jserver, trace, 0)
  tids = _serve(tserver, trace, 0)
  assert rec.modes and set(rec.modes) == {mode}
  got, want = _finished(tserver, tids), _finished(jserver, jids)
  assert [got[r] for r in tids] == [want[r] for r in jids]
  for rid, (_, n) in zip(tids, trace):
    assert got[rid][0] == 'done' and len(got[rid][1]) == n


@pytest.mark.parametrize('mode', MODES)
def test_default_mode_server_ticks_differ_from_f32_within_bound(
    mode, default_jax_server, monkeypatch):
  """The named difference: the ticks' masked attention runs in the mode,
  one call a layer a tick; on its inputs its context differs from f32 by
  more than nothing and at most MODE_VS_F32. Every request ends done with
  its tokens in range."""
  _, graph, cfg = default_jax_server
  tserver = _default_port_server(graph, cfg, mode)
  rec = _record(monkeypatch, 'decode_attention_int8_masked', as_jax=False)
  trace = _trace(cfg, seed=5)
  tids = _serve(tserver, trace, 4)
  got = _finished(tserver, tids)
  for rid, (_, n) in zip(tids, trace):
    status, tokens = got[rid]
    assert status == 'done' and len(tokens) == n
    assert min(tokens) >= 0 and max(tokens) < cfg.vocab_size
  assert len(rec.pairs) == cfg.num_layers * tserver.metrics['decode_ticks']
  diff = rec.largest_rel_diff()
  assert 0 < diff <= MODE_VS_F32[mode], diff


SPLICE_ENV = {'AEQT_ATTN_WRITEBACK': '1',
              'AEQT_ATTN_WRITEBACK_MODE': 'splice'}


@pytest.mark.parametrize('mode', MODES)
def test_splice_decode_mode_matches_jax_with_splice_at_f32(mode,
                                                           monkeypatch):
  """bench.py's decode graph with attn_writeback='splice' in the mode
  against AEQT_ATTN_WRITEBACK_MODE=splice with AEQT_ATTN_COMPUTE set: with
  the splice held to f32 (the JAX executor writes by DUS and attends with
  its f32 twin off a TPU) the logits and caches of STEPS steps, one splice
  call a layer a step, into the step's input pools. Then the splice in
  the mode on a step of random caches (lengths 51, 20, 1 and 0): its
  context differs from f32 on the same inputs by more than nothing and
  at most MODE_VS_F32."""
  cfg, jgraph, jex, tex = _decode_pair(
      monkeypatch, dict(SPLICE_ENV, AEQT_ATTN_COMPUTE=mode),
      {'attn_writeback': 'splice', 'attn_compute': mode})
  rec = _record(monkeypatch, 'decode_attention_int8_lengths_writeback',
                as_jax=True)
  for step, jout, tout, tin in _steps(cfg, jgraph, jex, tex):
    _assert_step_matches(jout, tout, step)
    for li in range(cfg.num_layers):
      key = f'layer_{li}_k_cache'
      assert tout[key] is tin[f'{key}_in']
  assert rec.modes == [mode] * (STEPS * cfg.num_layers)
  rec.as_jax = False
  feed = dict(_random_caches(cfg, 7), **_inputs(cfg, 50, [51, 20, 1, 0], 7))
  tex({k: _t(v) for k, v in feed.items()}, 'decode')
  assert len(rec.pairs) == cfg.num_layers
  diff = rec.largest_rel_diff()
  assert 0 < diff <= MODE_VS_F32[mode], diff


@pytest.mark.parametrize('dtype,drq', [('float32', True),
                                       ('bfloat16', False)])
@pytest.mark.parametrize('mode', MODES)
def test_attn_block_decode_mode_matches_jax(mode, dtype, drq, monkeypatch):
  """bench.py's decode graph with the attention block (SERVE_CFG: every
  layer's prologue and epilogue) in the mode against AEQT_ATTN_BLOCK=1
  with AEQT_ATTN_COMPUTE set, the JAX executor running #19 in interpret
  mode in the mode (compiled with excess precision off): two decode steps
  from position 37 over random caches, logits within STEP_TOL, ids where
  the JAX top-2 margin is clear, cache codes within one step; each
  epilogue ran its plain version once a step, in the mode."""
  setting = f'attn_block_{mode}'
  monkeypatch.setitem(attn_block.SETTINGS, setting, (
      {'AEQT_ATTN_BLOCK': '1', 'AEQT_ATTN_COMPUTE': mode},
      {'attn_block': True, 'attn_compute': mode}))
  attn_block._patch_exact(monkeypatch)
  cfg, jgraph, jex, tex = attn_block._pair(monkeypatch, 'mqa128', setting,
                                           drq=drq, dtype=dtype)
  assert tex.attn_compute == mode
  sig = jgraph.signature_by_key('decode')
  caches = attn_block._random_caches(cfg, 1)
  before = OPROJ.plain_calls
  rtol, codes = attn_block.STEP_TOL[dtype]
  for step in range(attn_block.STEPS):
    feed = dict(caches, **attn_block._inputs(cfg, 37 + step, step))
    jout = jex._run_signature(sig.subgraph_index, 'decode', False,
                              jex._weights,
                              {k: jnp.asarray(v) for k, v in feed.items()})
    tout = tex({k: _t(v) for k, v in feed.items()}, 'decode')
    want = _as_f32(jout['logits'])
    got = tout['logits'].float().numpy()
    atol = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=f'step {step}')
    top2 = np.sort(want.reshape(attn_block.BATCH, -1), axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * (atol + rtol * top2[:, 1])
    ids = (got.reshape(attn_block.BATCH, -1).argmax(-1),
           want.reshape(attn_block.BATCH, -1).argmax(-1))
    assert np.array_equal(ids[0][clear], ids[1][clear]), step
    for key, val in tout.items():
      if key.endswith('_cache'):
        diff = np.abs(val.numpy().astype(np.int32)
                      - np.asarray(jout[key]).astype(np.int32))
        assert diff.max() <= codes, (key, step)
    caches = {f'{k}_in': np.asarray(jout[k]) for k in jout
              if k.endswith('_cache')}
  epilogues = len(attn_block._units(tex)['epilogue'])
  assert epilogues == cfg.num_layers
  assert OPROJ.plain_calls - before == attn_block.STEPS * epilogues


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_int8_softmax_sum_does_not_hang_on_order(seed):
  """In int8 the softmax denominator is an f64 sum rounded once to f32
  (`attention._softmax_sum`; the kernels' `SumT`): every order of the terms
  gives the same f32, where f32 sums in other orders need not, and the
  probability codes round(e / sum * 127) hang on its last bit."""
  rng = np.random.default_rng(seed)
  e = torch.from_numpy(np.exp(
      rng.standard_normal((64, 1024)) * 4.0 - 8.0).astype(np.float32))
  want = attention._softmax_sum(e, 'int8')
  assert want.dtype == torch.float32
  f32_orders_differ = False
  for _ in range(8):
    perm = torch.from_numpy(rng.permutation(e.shape[1]))
    assert torch.equal(attention._softmax_sum(e[:, perm], 'int8'), want)
    f32_orders_differ |= not torch.equal(
        attention._softmax_sum(e[:, perm], 'f32'),
        attention._softmax_sum(e, 'f32'))
  assert f32_orders_differ
