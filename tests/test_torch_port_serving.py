"""The port's DecodeServer and serving graph against the JAX package's, on
the CPU.

Both servers serve the same request trace over one weight draw (the
port's materializer, carried to the JAX graph by `shared_weights`) with
the bench's serving options: packed int4 DRQ FCs, the fused MLP and head,
int8 KV caches, lengths attention at decode and flash attention at
prefill. The JAX server jits its programs and runs its Pallas kernels in
interpret mode; the port runs eagerly on the CPU, where every kernel
wrapper runs its plain version. The JAX server's decode block is off
(AEQT_DECODE_BLOCK=0) except where a test says so; the port's server keeps
its executor's default (on), which finds no unit on the serving graph
(`test_server_finds_the_block_units_jax_finds`).

Starvation aging is off on both servers (`starvation_age_s=None`) wherever
they must make the same admission choices: it reads the wall clock, and a
request can age past the limit on one server and not on the other (the JAX
server compiles inside the timed trace). `test_starvation_aging_matches_jax`
holds aging itself, both servers on one fake clock.
"""

import numpy as np
import pytest

import torch

from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.parallel import batching as jax_batching
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.kernels import head
from ai_edge_quantizer_tpu_torch.kernels import mlp
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.parallel import batching

from test_torch_port_slice import JAX_SERVING_ENV, MQA, _graph_signature
from test_torch_port_slice import shared_weights

SLOTS = 4
# test_torch_port_slice's MQA config with head dim and cache length 128:
# the JAX executor's gate (H and S multiples of 128) then sends attention to
# the Pallas kernels, so the port runs its lengths and flash wrappers.
SERVE_CFG = dict(MQA, head_dim=128, max_seq_len=128)
# The bench's serving graph (bench.py:bench_server) at toy widths.
BENCH_KW = dict(prefill_len=16, prefill_batch=2, prefill_tail_len=8,
                device_masks=True, fused_projections=True, greedy_head=True,
                prefill_device_masks=True, prefill_greedy=True,
                prefill_head_cols=True)
# More requests than slots; one and several chunks, tail and full plans.
PROMPT_LENS = (5, 16, 20, 40, 8, 33, 12, 48)
NEW_TOKENS = (6, 9, 4, 7, 12, 5, 8, 3)
KERNELS = (packed_qmatmul.qmatmul_int4_packed_drq, mlp.mlp_int4_packed,
           head.head_argmax, attention.decode_attention_int8_lengths,
           attention.flash_attention_int8_masked)


@pytest.fixture(scope='module')
def serving_env():
  """The JAX executor's serving options (read from the environment)."""
  with pytest.MonkeyPatch.context() as mp:
    for var, val in JAX_SERVING_ENV + (('AEQT_ATTN_WRITEBACK', '1'),):
      mp.setenv(var, val)
    yield


def _servers(server_kw=None, samplers=None, with_jax=True, **graph_kw):
  """(JAX server or None, port server, port config) over one graph
  structure and one weight draw, starvation aging off unless server_kw
  sets it. samplers: (JAX sample_fn, port sample_fn). Needs the
  `serving_env` fixture."""
  jcfg = jax_gemma.DecoderConfig(**SERVE_CFG)
  tcfg = gemma.DecoderConfig(**SERVE_CFG)
  kw = dict(BENCH_KW, **graph_kw)
  jgraph = jax_gemma.build_serving_decoder(
      jcfg, batch_slots=SLOTS, materialize_weights=False, **kw)
  tgraph = gemma.build_serving_decoder(
      tcfg, batch_slots=SLOTS, materialize_weights=False, **kw)
  for g, mod in ((jgraph, jax_gemma), (tgraph, gemma)):
    mod.stamp_int8_kv_cache(g)
  jweights, tweights = shared_weights(jgraph, tgraph)
  server_kw = dict(dict(starvation_age_s=None), **(server_kw or {}))
  jkw, tkw = dict(server_kw), dict(server_kw)
  if samplers is not None:
    jkw['sample_fn'], tkw['sample_fn'] = samplers
  tserver = batching.DecodeServer(
      tgraph, tcfg, SLOTS, weights=tweights, pack_weights=True,
      activation_dtype='float32', device='cpu', **tkw)
  # Toy weights are below the packing threshold: pack them all, with the
  # MLP's F-groups of 128 (AEQT_MLP_BF on the JAX side).
  tserver._executor.mlp_bf = 128
  tserver._executor.prepare_serving_weights(min_weight_params=0)
  _track(tserver)
  if not with_jax:
    return None, tserver, tcfg
  jserver = jax_batching.DecodeServer(
      jgraph, jcfg, SLOTS, weights=jweights, pack_weights=True,
      activation_dtype='float32', **jkw)
  jserver._executor.prepare_serving_weights(min_weight_params=0)
  _track(jserver)
  assert len(tserver._executor._mlp_fusions) == len(
      jserver._executor._mlp_fusions) > 0
  return jserver, tserver, tcfg


@pytest.fixture(scope='module')
def bench_servers(serving_env):
  """One JAX and one port server on the bench's graph, shared by the tests
  that serve traces on it in turn (the JAX server compiles its programs
  once). Each test compares the metrics its own trace adds."""
  return _servers()


def _trace(cfg, seed=0):
  rng = np.random.default_rng(seed)
  return [(rng.integers(1, cfg.vocab_size, p).astype(np.int32), n)
          for p, n in zip(PROMPT_LENS, NEW_TOKENS)]


def _serve(server, trace, chunk):
  ids = [server.submit(p, max_new_tokens=n) for p, n in trace]
  while server.has_work():
    if chunk:
      server.step_chunk(chunk)
    else:
      server.step()
  return ids


def _finished(server, ids):
  """{request id: (status, tokens)} from the server's finished requests."""
  return {rid: server._done[rid] for rid in ids}


def _track(server):
  """Record every finished request (both servers call _finish)."""
  server._done = {}
  finish = server._finish

  def _finish(req, status):
    finish(req, status)
    server._done[req.request_id] = (status, list(req.generated))

  server._finish = _finish


METRICS = ('decode_ticks', 'prefill_groups', 'prefill_pad_rows', 'prefills',
           'tokens_generated', 'requests_completed', 'requests_cancelled',
           'requests_timeout', 'bucket_switches')


def _metrics(server, since=None):
  """The server's METRICS, less those of `since` (an earlier reading)."""
  now = {m: server.metrics[m] for m in METRICS}
  return {m: now[m] - (since or {}).get(m, 0) for m in METRICS}


@pytest.mark.parametrize('chunk', [0, 4])
def test_server_tokens_match_jax(chunk, bench_servers):
  jserver, tserver, cfg = bench_servers
  trace = _trace(cfg)
  before = [(k.plain_calls, k.launches) for k in KERNELS]
  since = _metrics(tserver)
  ttfts = len(tserver.ttft_log)
  jids = _serve(jserver, trace, chunk)
  tids = _serve(tserver, trace, chunk)
  assert tids == jids
  got, want = _finished(tserver, tids), _finished(jserver, jids)
  assert got == want
  for rid, (p, n) in zip(tids, trace):
    assert got[rid][0] == 'done' and len(got[rid][1]) == n
  assert _metrics(tserver) == _metrics(jserver)
  added = _metrics(tserver, since)
  assert len(tserver.ttft_log) - ttfts == len(trace)
  # The pools the one-hot blend and the prefill scatter wrote: int8 codes
  # within one rounding step (the floats before the rounding may differ in
  # the last place).
  for key, cache in tserver._caches.items():
    diff = cache.to(torch.int32) - torch.from_numpy(
        np.asarray(jserver._caches[key]).astype(np.int32))
    assert int(diff.abs().max()) <= 1, key
  # Every kernel of the path ran its plain version; none launched.
  ran = [k.plain_calls - b[0] for k, b in zip(KERNELS, before)]
  assert all(k.launches == b[1] for k, b in zip(KERNELS, before))
  assert all(n > 0 for n in ran), ran
  layers = cfg.num_layers
  assert ran[3] == added['decode_ticks'] * layers  # lengths
  assert ran[4] % layers == 0 and ran[4] >= (
      added['prefill_groups'] * layers)  # flash, every pass


class _Clock:
  """A monotonic clock that moves only when the test moves it."""

  def __init__(self):
    self.now = 0.0

  def monotonic(self):
    return self.now


def _aging_run(server, clock, head_trace, late_trace, monkeypatch):
  """Serve head_trace, then queue late_trace behind it, the clock 0.5 s
  per tick. Returns (prefill groups as indices into the requests in submit
  order, finished requests, metrics)."""
  groups = []
  prefill_group = server._prefill_group

  def recorded(slot_reqs, *args, **kwargs):
    groups.append([req.request_id for _, req in slot_reqs])
    return prefill_group(slot_reqs, *args, **kwargs)

  monkeypatch.setattr(server, '_prefill_group', recorded)
  since = _metrics(server)
  clock.now = 0.0
  ids = [server.submit(p, max_new_tokens=n) for p, n in head_trace]
  server.step()
  clock.now += 0.5
  ids += [server.submit(p, max_new_tokens=n) for p, n in late_trace]
  while server.has_work():
    server.step()
    clock.now += 0.5
  pos = {rid: i for i, rid in enumerate(ids)}
  return ([[pos[r] for r in g] for g in groups], list(
      _finished(server, ids).values()), _metrics(server, since))


def test_starvation_aging_matches_jax(bench_servers, monkeypatch):
  """Starvation aging on both servers, driven by one fake clock: a late
  tail-plan request waits past the limit (0.25 s) while a full group of
  its successors could go first; both servers admit it first at the same
  tick, and without aging both admit the full group first."""
  jserver, tserver, cfg = bench_servers
  clock = _Clock()
  monkeypatch.setattr(jax_batching, 'time', clock)
  monkeypatch.setattr(batching, 'time', clock)
  rng = np.random.default_rng(6)
  head_trace = [(rng.integers(1, cfg.vocab_size, 16).astype(np.int32), n)
                for n in (3, 3, 12, 12)]
  late_trace = [(rng.integers(1, cfg.vocab_size, p).astype(np.int32), 4)
                for p in (5, 16, 16)]
  runs = {}
  for age in (0.25, None):
    for name, server in (('jax', jserver), ('port', tserver)):
      monkeypatch.setattr(server, '_starvation_age_s', age)
      runs[name, age] = _aging_run(server, clock, head_trace, late_trace,
                                   monkeypatch)
  assert runs['port', 0.25] == runs['jax', 0.25]
  assert runs['port', None] == runs['jax', None]
  # Two slots free up at the third tick, when request 4 has waited 0.5 s:
  # aged, it goes first (with 5 in the remaining slot); without aging the
  # full group (5, 6) goes first.
  assert runs['port', 0.25][0] == [[0, 1], [2, 3], [4], [5], [6]]
  assert runs['port', None][0] == [[0, 1], [2, 3], [5, 6], [4]]


def test_server_finds_the_block_units_jax_finds(serving_env, monkeypatch):
  """With the decode block on both sides (the port's executor default),
  the servers' executors find the same units on the serving graph: none,
  since its one-hot pool update leaves no cache DUS to fold into the
  attention."""
  monkeypatch.setenv('AEQT_DECODE_BLOCK', '1')
  jserver, tserver, _ = _servers()
  assert tserver._executor.decode_block
  assert len(tserver._executor._block_fusions) == len(
      jserver._executor._block_fusions) == 0
  assert len(tserver._executor._attn_fusions) == len(
      jserver._executor._attn_fusions) > 0


def test_server_host_masks_and_host_sampler_match_jax(serving_env):
  """Host-built prefill masks (_host_prefill_mask), logits heads and a
  seeded top-k sampler on the host."""
  samplers = (jax_batching.make_topk_sampler(k=5, temperature=0.8, seed=7),
              batching.make_topk_sampler(k=5, temperature=0.8,
                                         rng=np.random.default_rng(7)))
  jserver, tserver, cfg = _servers(
      samplers=samplers, greedy_head=False, prefill_greedy=False,
      prefill_device_masks=False, prefill_tail_len=0,
      prefill_head_cols=False)
  trace = _trace(cfg, seed=1)[:6]
  jids = _serve(jserver, trace, 0)
  tids = _serve(tserver, trace, 0)
  assert _finished(tserver, tids) == _finished(jserver, jids)
  assert _metrics(tserver) == _metrics(jserver)


def test_server_cache_buckets_match_jax(serving_env):
  jserver, tserver, cfg = _servers(cache_buckets=(32,))
  assert tserver._buckets == jserver._buckets == [32, 128]
  # Prompts within the smallest bucket; generation grows the pool. The
  # 32-row bucket runs the plain twin (S % 128), the 128-row one the
  # lengths wrapper, as the JAX executor's gate has it.
  trace = [(p[:24], 12) for p, _ in _trace(cfg, seed=2)[:5]]
  jids = _serve(jserver, trace, 4)
  tids = _serve(tserver, trace, 4)
  assert _finished(tserver, tids) == _finished(jserver, jids)
  assert tserver.metrics['bucket_switches'] == jserver.metrics[
      'bucket_switches'] > 0


def test_prompt_longer_than_the_bucket_keeps_its_rows(serving_env):
  """A prompt longer than the pool's current bucket: the port grows the
  pool before it writes the prompt's cache rows, so the rows past the
  smallest bucket survive and the tokens are those of a server without
  buckets (the JAX server cuts those rows; ROADMAP.md, Queue 3)."""
  _, plain, cfg = _servers(with_jax=False)
  _, bucketed, _ = _servers(with_jax=False, cache_buckets=(32,))
  prompt = _trace(cfg, seed=3)[3][0]
  assert prompt.size == 40
  for server in (plain, bucketed):
    server.submit(prompt, max_new_tokens=6)
    server._admit()
  assert bucketed._bucket == 128
  for key, cache in plain._caches.items():
    torch.testing.assert_close(bucketed._caches[key], cache, rtol=0, atol=0)
  assert torch.count_nonzero(plain._caches['layer_0_k_cache_in'][0, :, 32:40])
  for server in (plain, bucketed):
    while server.has_work():
      server.step()
  assert plain._done == bucketed._done


def test_server_cancel_and_timeout_match_jax(bench_servers):
  jserver, tserver, cfg = bench_servers
  outcomes = []
  for server in (jserver, tserver):
    since = _metrics(server)
    trace = _trace(cfg, seed=4)[:6]
    ids = [server.submit(p, max_new_tokens=n) for p, n in trace]
    server.step()
    assert server.cancel(ids[0]) and server.cancel(ids[-1])
    assert not server.cancel(12345)
    # Already past its deadline: times out at the next tick.
    late = server.submit(trace[1][0], max_new_tokens=3, timeout_s=-1.0)
    while server.has_work():
      server.step_chunk(4)
    assert server.stats()['requests_completed'] == server.metrics[
        'requests_completed']
    outcomes.append((_finished(server, ids + [late]),
                     _metrics(server, since)))
  assert outcomes[1] == outcomes[0]
  done, metrics = outcomes[1]
  assert metrics['requests_cancelled'] == 2
  assert metrics['requests_timeout'] == 1
  assert [s for s, _ in done.values()].count('done') == len(done) - 3


def test_server_request_timeout_default(serving_env):
  _, tserver, cfg = _servers(server_kw=dict(request_timeout_s=-1.0),
                             with_jax=False)
  ids = [tserver.submit(p, max_new_tokens=n) for p, n in _trace(cfg)[:3]]
  tserver.step()
  assert {tserver._done[i][0] for i in ids} == {'timeout'}
  assert not tserver.has_work()


@pytest.mark.parametrize('which', ['topk', 'topp'])
def test_samplers_match_jax(which):
  rng = np.random.default_rng(9)
  logits = [rng.standard_normal(64).astype(np.float32) for _ in range(20)]
  if which == 'topk':
    want = jax_batching.make_topk_sampler(k=8, temperature=0.7, seed=3)
    got = batching.make_topk_sampler(k=8, temperature=0.7,
                                     rng=np.random.default_rng(3))
  else:
    want = jax_batching.make_topp_sampler(p=0.8, temperature=1.3, seed=3)
    got = batching.make_topp_sampler(p=0.8, temperature=1.3,
                                     rng=np.random.default_rng(3))
  assert [got(x) for x in logits] == [want(x) for x in logits]
  assert batching.greedy_sampler(logits[0]) == int(np.argmax(logits[0]))


def test_server_refuses_what_is_not_ported():
  cfg = gemma.DecoderConfig(**MQA)
  graph = gemma.build_serving_decoder(cfg, batch_slots=2, **BENCH_KW)
  with pytest.raises(NotImplementedError, match='mesh'):
    batching.DecodeServer(graph, cfg, 2, device='cpu', mesh=object())
  with pytest.raises(ValueError, match='batch_slots'):
    batching.DecodeServer(graph, cfg, 3, device='cpu')
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='cuda'):
      batching.DecodeServer(graph, cfg, 2)


# -- the serving graph ---------------------------------------------------------


@pytest.mark.parametrize('name,kw', [
    ('toy', dict(batch_slots=4, **BENCH_KW)),
    ('toy', dict(batch_slots=2, prefill_len=16, cache_buckets=(32,),
                 greedy_head=True)),
    ('gemma_2b', dict(batch_slots=64, prefill_len=128, prefill_batch=8,
                      prefill_tail_len=64, device_masks=True,
                      fused_projections=True, greedy_head=True,
                      prefill_device_masks=True, prefill_greedy=True,
                      prefill_head_cols=True, materialize_weights=False)),
])
def test_build_serving_decoder_matches_jax(name, kw):
  if name == 'gemma_2b':
    jcfg, tcfg = jax_gemma.GEMMA_2B, gemma.GEMMA_2B
  else:
    jcfg, tcfg = jax_gemma.TOY_DECODER, gemma.TOY_DECODER
  jgraph = jax_gemma.build_serving_decoder(jcfg, **kw)
  tgraph = gemma.build_serving_decoder(tcfg, **kw)
  jax_gemma.stamp_int8_kv_cache(jgraph)
  gemma.stamp_int8_kv_cache(tgraph)
  assert _graph_signature(tgraph) == _graph_signature(jgraph)
  assert tgraph.metadata == jgraph.metadata
