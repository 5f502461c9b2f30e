"""bench.py's decode graph in the bf16 and int8 compute modes with the
splice writeback (#8) and with the attention block (#19) against the JAX
executor, on the CPU (split from the former test_torch_port_attn_modes.py;
its kernel cases are in test_torch_port_attn_modes_kernels.py).

The JAX executor's dispatch off a TPU differs by mode (named here, not
hidden):
  * it runs #8 not at all (it writes by DUS and attends with the twin,
    executor.py:1686-1692): the splice decode step gives the JAX
    executor's logits and caches with #8 held to f32; run in the mode, its
    contexts differ from f32 on the same inputs by more than nothing and at
    most MODE_VS_F32;
  * it runs #19 in interpret mode in the mode (executor.py:2032-2036): the
    attention-block decode step in each mode is held to it directly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_torch_port_attn_block as attn_block
from test_torch_port_attn_compute import MODE_VS_F32, MODES
from test_torch_port_attn_modes_kernels import OPROJ, _as_f32, _record, _t
from test_torch_port_cache_modes import STEPS, _assert_step_matches
from test_torch_port_cache_modes import _decode_pair, _inputs
from test_torch_port_cache_modes import _random_caches, _steps


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  """One torch thread for this file: under parallel test workers, torch's
  default of a thread a core oversubscribes the cores."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


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
