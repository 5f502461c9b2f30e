"""The attention compute modes of the port (`attn_compute`) on the slice, on
the CPU: bench.py's decode graph at test_torch_port_block's narrow 3-layer
width with the decode block, and the serving graph's DecodeServer, under
each mode, against the JAX executor with AEQT_ATTN_COMPUTE set.

The kernels' parity in the modes, the rules (MODE_VS_F32) and the recorder
live in tests/test_torch_port_attn_compute.py, whose docstring names the
two differences of the JAX executor off a TPU that these tests hold:
  * it runs the decode block in interpret mode in the mode
    (executor.py:589), as the port's plain version does: the same;
  * it runs the stale attention (executor.py:1916, layer 0 of the decode
    step) and the lengths attention (executor.py:2047, the server's ticks)
    on its f32 XLA twin whatever the mode, where the port runs them in
    the mode. With those two wrappers held to f32 the port equals the JAX
    executor (ids and caches); run in the mode, their contexts differ from
    f32 on the same inputs by at most MODE_VS_F32 of the largest
    magnitude, and by more than nothing.
Each module fixture (one per mode) builds its JAX run once.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ai_edge_quantizer_tpu.execution import executor as jax_executor
from ai_edge_quantizer_tpu.kernels import pallas_block
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.parallel import batching as jax_batching
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.kernels import attention, block
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.parallel import batching

from test_torch_port_attn_block import _exact
from test_torch_port_attn_compute import MODES, MODE_VS_F32, _Recorder
from test_torch_port_block import BLOCK_ENV, SMALL, _inputs as block_inputs
from test_torch_port_serving import BENCH_KW, SERVE_CFG, SLOTS, _serve
from test_torch_port_serving import _finished, _trace, _track
from test_torch_port_slice import JAX_SERVING_ENV, shared_weights


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  """One torch thread for this file: under parallel test workers, torch's
  default of a thread a core oversubscribes the cores."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _stale_recorder(monkeypatch, as_jax):
  rec = _Recorder(attention.decode_attention_int8_lengths_stale,
                  attention.decode_attention_int8_lengths_stale_plain, as_jax)
  monkeypatch.setattr(attention, 'decode_attention_int8_lengths_stale', rec)
  return rec


@pytest.fixture(scope='module', params=MODES)
def mode_decode(request):
  """(mode, port config, port graph, port weights, the JAX executor's
  outputs) for bench.py's decode with the block under AEQT_ATTN_COMPUTE,
  the JAX run made once per mode; its block compiled with excess
  precision off."""
  mode = request.param
  jcfg = dataclasses.replace(jax_gemma.GEMMA_2B_LITE, **SMALL)
  tcfg = dataclasses.replace(gemma.GEMMA_2B_LITE, **SMALL)
  kw = dict(batch=8, prefill_len=8, signatures=('decode',),
            materialize_weights=False, fused_projections=True,
            greedy_head=True)
  jgraph = jax_gemma.build_decoder(jcfg, **kw)
  tgraph = gemma.build_decoder(tcfg, **kw)
  jax_gemma.stamp_int8_kv_cache(jgraph)
  gemma.stamp_int8_kv_cache(tgraph)
  jweights, tweights = shared_weights(jgraph, tgraph)
  with pytest.MonkeyPatch.context() as mp:
    for var, val in BLOCK_ENV + (('AEQT_ATTN_COMPUTE', mode),):
      mp.setenv(var, val)
    mp.setattr(pallas_block, 'fused_mlp_qkv_attention',
               _exact(pallas_block.fused_mlp_qkv_attention))
    jex = jax_executor.GraphExecutor(jgraph, activation_dtype='float32')
    jex._weights = dict(jweights)
    jex.prepare_serving_weights(min_weight_params=0)
    sig = jgraph.signature_by_key('decode')
    jout = jex._run_signature(
        sig.subgraph_index, 'decode', False, jex._weights,
        {k: jnp.asarray(v.numpy()) for k, v in block_inputs(tcfg).items()})
    blocks = len(jex._block_fusions)
  return (mode, tcfg, tgraph, tweights,
          {k: np.asarray(v) for k, v in jout.items()}, blocks)


def _port_decode(mode_decode):
  mode, cfg, graph, weights, _, _ = mode_decode
  ex = executor.GraphExecutor(graph, device='cpu', activation_dtype='float32',
                              mlp_bf=512, attn_compute=mode)
  ex.load_weights(weights)
  ex.prepare_serving_weights(min_weight_params=0)
  return ex, ex(block_inputs(cfg), 'decode')


def test_decode_mode_matches_jax_with_layer0_as_jax_runs_it(mode_decode,
                                                          monkeypatch):
  """Layer 0's stale attention held to f32 (the JAX executor's XLA twin off
  a TPU); every decode-block unit runs in the mode on both sides: the same
  ids and caches."""
  mode, cfg, _, _, jout, jax_blocks = mode_decode
  rec = _stale_recorder(monkeypatch, as_jax=True)
  runs = block.fused_mlp_qkv_attention.plain_calls
  ex, out = _port_decode(mode_decode)
  assert ex.attn_compute == mode
  assert len(ex._block_fusions) == jax_blocks == cfg.num_layers - 1
  assert block.fused_mlp_qkv_attention.plain_calls - runs == jax_blocks
  assert rec.calls == 1 and not rec.pairs
  assert sorted(out) == sorted(jout)
  np.testing.assert_array_equal(out['next_tokens'].numpy(),
                                jout['next_tokens'])
  for key, val in out.items():
    if key.endswith('_cache'):
      np.testing.assert_array_equal(val.numpy(), jout[key], err_msg=key)


def test_decode_mode_layer0_differs_from_f32_within_bound(mode_decode,
                                                          monkeypatch):
  """The named difference: the port runs layer 0's stale attention in the
  mode. On the same inputs its context differs from f32 (so the mode ran)
  by at most MODE_VS_F32; the step's ids stay in range."""
  mode, cfg = mode_decode[0], mode_decode[1]
  rec = _stale_recorder(monkeypatch, as_jax=False)
  _, out = _port_decode(mode_decode)
  assert len(rec.pairs) == 1
  diff = rec.largest_rel_diff()
  assert 0 < diff <= MODE_VS_F32[mode], diff
  ids = out['next_tokens'].numpy()
  assert ids.min() >= 0 and ids.max() < cfg.vocab_size


@pytest.fixture(scope='module', params=MODES)
def mode_servers(request):
  """A JAX server under AEQT_ATTN_COMPUTE and a port server with
  executor_options={'attn_compute': mode}, on the bench's serving graph at
  test_torch_port_serving's widths; the variable stays set while the JAX
  server compiles (its first serve)."""
  mode = request.param
  jcfg = jax_gemma.DecoderConfig(**SERVE_CFG)
  tcfg = gemma.DecoderConfig(**SERVE_CFG)
  jgraph = jax_gemma.build_serving_decoder(
      jcfg, batch_slots=SLOTS, materialize_weights=False, **BENCH_KW)
  tgraph = gemma.build_serving_decoder(
      tcfg, batch_slots=SLOTS, materialize_weights=False, **BENCH_KW)
  jax_gemma.stamp_int8_kv_cache(jgraph)
  gemma.stamp_int8_kv_cache(tgraph)
  jweights, tweights = shared_weights(jgraph, tgraph)
  with pytest.MonkeyPatch.context() as mp:
    for var, val in JAX_SERVING_ENV + (('AEQT_ATTN_WRITEBACK', '1'),
                                       ('AEQT_ATTN_COMPUTE', mode)):
      mp.setenv(var, val)
    tserver = batching.DecodeServer(
        tgraph, tcfg, SLOTS, weights=tweights, pack_weights=True,
        activation_dtype='float32', device='cpu', starvation_age_s=None,
        executor_options={'attn_compute': mode})
    tserver._executor.mlp_bf = 128
    tserver._executor.prepare_serving_weights(min_weight_params=0)
    jserver = jax_batching.DecodeServer(
        jgraph, jcfg, SLOTS, weights=jweights, pack_weights=True,
        activation_dtype='float32', starvation_age_s=None)
    jserver._executor.prepare_serving_weights(min_weight_params=0)
    for server in (tserver, jserver):
      _track(server)
    yield mode, jserver, tserver, tcfg


def _lengths_recorder(monkeypatch, as_jax):
  rec = _Recorder(attention.decode_attention_int8_lengths,
                  attention.decode_attention_int8_lengths_plain, as_jax)
  monkeypatch.setattr(attention, 'decode_attention_int8_lengths', rec)
  return rec


def test_server_mode_matches_jax_with_its_f32_ticks(mode_servers,
                                                    monkeypatch):
  """The ticks' lengths attention held to f32 (the JAX executor's twin off
  a TPU): the port's server in the mode gives the JAX server's tokens."""
  mode, jserver, tserver, cfg = mode_servers
  assert tserver._executor.attn_compute == mode
  rec = _lengths_recorder(monkeypatch, as_jax=True)
  trace = _trace(cfg, seed=3)
  jids = _serve(jserver, trace, 0)
  tids = _serve(tserver, trace, 0)
  assert rec.calls > 0
  got, want = _finished(tserver, tids), _finished(jserver, jids)
  assert [got[r] for r in tids] == [want[r] for r in jids]
  for rid, (_, n) in zip(tids, trace):
    assert got[rid][0] == 'done' and len(got[rid][1]) == n


def test_server_mode_ticks_differ_from_f32_within_bound(mode_servers,
                                                        monkeypatch):
  """The named difference: the port's ticks run the lengths attention in
  the mode; each tick's context differs from f32 on its inputs by at most
  MODE_VS_F32. Every request ends done with its tokens in range."""
  mode, _, tserver, cfg = mode_servers
  rec = _lengths_recorder(monkeypatch, as_jax=False)
  ticks = tserver.metrics['decode_ticks']
  trace = _trace(cfg, seed=4)
  tids = _serve(tserver, trace, 4)
  got = _finished(tserver, tids)
  for rid, (_, n) in zip(tids, trace):
    status, tokens = got[rid]
    assert status == 'done' and len(tokens) == n
    assert min(tokens) >= 0 and max(tokens) < cfg.vocab_size
  assert len(rec.pairs) == cfg.num_layers * (
      tserver.metrics['decode_ticks'] - ticks)
  diff = rec.largest_rel_diff()
  assert 0 < diff <= MODE_VS_F32[mode], diff
