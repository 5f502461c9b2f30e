"""The port's int4-per-group KV cache against the JAX package, on the CPU.

The row quantizers and the sidecar builder must match the reference bit
for bit; the plain version of `decode_attention_int4_group_lengths` is held
to the Pallas kernel run in interpret mode (as the JAX package's ops run it
off the TPU), the two INT4G opcodes to the reference's ops (pools and
sidecar exact), a 2-layer `build_decoder(kv_int4_group=16)` decode to the
JAX executor, and `DecodeServer` over `build_serving_decoder(kv_int4_group=
16)` to the JAX server. Both sides take the port's crc32-seeded weights
(`test_torch_port_slice.shared_weights`); starvation aging is off on both
servers, as in `test_torch_port_serving.py`.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu.execution import executor as jax_executor
from ai_edge_quantizer_tpu.graph import ir as jax_ir
from ai_edge_quantizer_tpu.kernels import pallas_attention as pa
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.ops import impl as jax_impl
from ai_edge_quantizer_tpu.parallel import batching as jax_batching
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.ops import impl
from ai_edge_quantizer_tpu_torch.parallel import batching

from test_torch_port_slice import JAX_SERVING_ENV, MQA, _graph_signature
from test_torch_port_slice import shared_weights

GROUP = 16
KERNEL = attention.decode_attention_int4_group_lengths
# The JAX executor's options of bench.py, and the Pallas kernel's batch
# block 1 (AEQT_ATTN_BB; it changes no number, and interpret mode compiles
# a one-row body several times faster).
JAX_ENV = JAX_SERVING_ENV + (('AEQT_ATTN_WRITEBACK', '1'),
                             ('AEQT_ATTN_BB', '1'))


def _t(a):
  a = np.array(a)
  if a.dtype.name == 'bfloat16':  # numpy's bf16 (ml_dtypes), bit for bit
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
  return torch.from_numpy(a)


def _j(a):
  return jnp.asarray(np.asarray(a))


def _np(x):
  """A JAX or torch array as numpy (bf16 as float32, exactly)."""
  if isinstance(x, torch.Tensor):
    x = x.to(torch.float32) if x.dtype == torch.bfloat16 else x
    return x.numpy()
  x = np.asarray(x)
  return x.astype(np.float32) if x.dtype.name == 'bfloat16' else x


def _bits(x):
  """The bit patterns of a float array (exact comparisons, -0.0 and NaN
  included)."""
  x = _np(x)
  return x.view(np.uint32) if x.dtype == np.float32 else x


def _bf16_ulps(got, want, atol=0.0):
  w = np.asarray(want, np.float32)
  ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0**-126))) - 7)
  diff = np.maximum(np.abs(np.asarray(got, np.float32) - w) - atol, 0.0)
  return float(np.max(diff / ulp))


def _kv_rows(rng, *shape):
  """K rows off centre (the regime asymmetric K exists for, as
  tests/test_kernels.py makes them) and centred V rows, f32."""
  k = (rng.standard_normal(shape) * 0.5 + 0.8).astype(np.float32)
  v = rng.standard_normal(shape).astype(np.float32)
  return k, v


def _pools(rng, b, nk, s, h, group=GROUP):
  """int4-group pools and sidecar from random rows, by the reference."""
  k, v = _kv_rows(rng, b, nk, s, h)
  kp, ks, km = pa.quantize_k_rows_int4_asym(_j(k), group)
  vp, vs = pa.quantize_v_rows_int4_group(_j(v), group)
  return (np.array(kp), np.array(vp),
          np.array(pa.build_kv_sidecar_group(ks, km, vs)))


# -- helpers ---------------------------------------------------------------------


def test_pack_int4_rows_byte_identical():
  rng = np.random.default_rng(0)
  x = rng.integers(-8, 8, size=(3, 5, 64)).astype(np.int8)
  packed = attention.pack_int4_rows(_t(x))
  np.testing.assert_array_equal(packed.numpy(),
                                np.asarray(pa.pack_int4_rows(_j(x))))
  np.testing.assert_array_equal(attention.unpack_int4_rows(packed).numpy(), x)
  np.testing.assert_array_equal(
      attention.unpack_int4_rows(packed).numpy(),
      np.asarray(pa.unpack_int4_rows(_j(packed.numpy()))))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('group', [16, 8])
def test_row_quantizers_and_sidecar_match_jax_bit_for_bit(dtype, group):
  b, nk, s, h = 2, 2, 128, 64
  rng = np.random.default_rng(group + len(dtype))
  k, v = _kv_rows(rng, b, nk, s, h)
  # Edge rows: all zero (the 1e-9 floor), one constant group, values on
  # half steps of the grid (round half to even).
  k[0, 0, 0], v[0, 0, 0] = 0.0, 0.0
  k[0, 1, 1, :group] = 0.25
  v[1, 0, 2, :group] = np.arange(group, dtype=np.float32) * 0.5 - 3.5
  jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
  tdt = getattr(torch, dtype)
  jk, jv = _j(k).astype(jdt), _j(v).astype(jdt)
  tk, tv = _t(k).to(tdt), _t(v).to(tdt)
  want_k = pa.quantize_k_rows_int4_asym(jk, group)
  want_v = pa.quantize_v_rows_int4_group(jv, group)
  got_k = attention.quantize_k_rows_int4_asym(tk, group)
  got_v = attention.quantize_v_rows_int4_group(tv, group)
  for got, want in zip(got_k + got_v, want_k + want_v):
    assert got.dtype == getattr(torch, str(np.asarray(want).dtype))
    np.testing.assert_array_equal(_bits(got), _bits(want))
  got_sc = attention.build_kv_sidecar_group(got_k[1], got_k[2], got_v[1])
  want_sc = pa.build_kv_sidecar_group(want_k[1], want_k[2], want_v[1])
  assert got_sc.dtype == torch.bfloat16
  assert tuple(got_sc.shape) == (b, nk, 3 * h // group, s)
  np.testing.assert_array_equal(_bits(got_sc), _bits(want_sc))


# -- the kernel's plain version against the Pallas kernel ------------------------


# B, S and H of the kernel and op tests: the op tests' Pallas calls then
# reuse the (2, 2, 16) cases' compiled programs.
B, S, H = 4, 128, 64


@pytest.mark.parametrize('nk,g,group,out', [
    (2, 2, 16, 'float32'), (2, 2, 16, 'bfloat16'), (1, 8, 8, 'float32')])
def test_plain_kernel_matches_pallas(nk, g, group, out):
  b, s, h = B, S, H
  rng = np.random.default_rng(nk * 100 + g * 10 + group)
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  kp, vp, sidecar = _pools(rng, b, nk, s, h, group)
  lengths = np.array([1, s, 77, 0], np.int32)  # one row; full; mid; none
  jdt = jnp.bfloat16 if out == 'bfloat16' else jnp.float32
  want = _np(pa.decode_attention_int4_group_lengths(
      _j(q), _j(kp), _j(vp), _j(sidecar), _j(lengths), group=group,
      out_dtype=jnp.dtype(jdt), batch_block=1, interpret=True))
  calls = KERNEL.plain_calls
  got = KERNEL(_t(q), _t(kp), _t(vp), _t(sidecar), _t(lengths), group=group,
               out_dtype=getattr(torch, out))
  assert KERNEL.plain_calls == calls + 1
  assert got.dtype == getattr(torch, out) and tuple(got.shape) == q.shape
  got = _np(got)
  if out == 'float32':
    # f32 sums in another order than XLA's dots.
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
  else:
    assert _bf16_ulps(got, want) <= 1.0


# -- the two opcodes ---------------------------------------------------------------


def _op(mod, opcode, b, nk, g, s, h, qdtype):
  sg = mod.Subgraph(name='main')
  for name, shape, dt in (
      ('ctx', (b, nk, g, h), qdtype), ('k', (b, nk, s, h // 2), 'uint8'),
      ('v', (b, nk, s, h // 2), 'uint8'),
      ('s', (b, nk, 3 * h // GROUP, s), 'bfloat16')):
    sg.tensors.append(mod.Tensor(name=name, shape=shape, dtype=dt))
  op = mod.Op(opcode=opcode, inputs=[], outputs=[0, 1, 2, 3],
              attrs={'group': GROUP})
  return op, sg


@pytest.fixture
def jax_env(monkeypatch):
  for var, val in JAX_ENV:
    monkeypatch.setenv(var, val)


@pytest.mark.parametrize('opcode,where,qdtype', [
    ('INT4G_ATTENTION', 0, 'float32'), ('INT4G_ATTENTION', 45, 'bfloat16'),
    ('INT4G_ATTENTION', 130, 'float32'),  # past S: the write clamps to S - 1
    ('INT4G_ATTENTION_SCATTER', None, 'float32'),
    ('INT4G_ATTENTION_SCATTER', None, 'bfloat16')])
def test_int4g_ops_match_jax(opcode, where, qdtype, jax_env):
  b, nk, g, s, h = B, 2, 2, S, H
  rng = np.random.default_rng(len(opcode) + (where or 0))
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  k_rows, v_rows = _kv_rows(rng, b, nk, 1, h)
  kp, vp, sidecar = _pools(rng, b, nk, s, h)
  if where is None:
    # Per-row positions; s writes nothing and attends over every row.
    pos_in = np.array([[0], [17], [s - 1], [s]], np.int32)
  else:
    pos_in = np.array([0, 0, where, 0], np.int32)
  jdt = jnp.bfloat16 if qdtype == 'bfloat16' else jnp.float32
  jop, jsg = _op(jax_ir, opcode, b, nk, g, s, h, qdtype)
  top, tsg = _op(ir, opcode, b, nk, g, s, h, qdtype)
  want = jax_impl.OPS[opcode](
      jax_impl.OpContext(op=jop, subgraph=jsg, graph=jax_ir.Graph()),
      _j(q).astype(jdt), _j(k_rows).astype(jdt), _j(v_rows).astype(jdt),
      _j(kp), _j(vp), _j(sidecar), _j(pos_in))
  calls = KERNEL.plain_calls
  got = impl.OPS[opcode](
      impl.OpContext(op=top, subgraph=tsg, graph=ir.Graph()),
      _t(q).to(getattr(torch, qdtype)), _t(k_rows).to(getattr(torch, qdtype)),
      _t(v_rows).to(getattr(torch, qdtype)), _t(kp), _t(vp), _t(sidecar),
      _t(pos_in))
  assert KERNEL.plain_calls == calls + 1
  for name, gt, wt in zip(('k', 'v', 's'), got[1:], want[1:]):
    assert gt.dtype == getattr(torch, str(np.asarray(wt).dtype)), name
    np.testing.assert_array_equal(_bits(gt), _bits(wt), err_msg=name)
  # The ops wrote something (and only where the reference did).
  assert not np.array_equal(got[1].numpy(), kp)
  ctx, wctx = _np(got[0]), _np(want[0])
  assert got[0].dtype == getattr(torch, qdtype)
  if qdtype == 'float32':
    assert np.max(np.abs(ctx - wctx)) <= 1e-5 * np.max(np.abs(wctx))
  else:
    assert _bf16_ulps(ctx, wctx) <= 1.0


# -- graphs, executor and inputs --------------------------------------------------


@pytest.mark.parametrize('name', ['toy', 'gemma_2b'])
def test_int4g_graphs_match_jax(name):
  if name == 'gemma_2b':
    jcfg, tcfg, extra = jax_gemma.GEMMA_2B, gemma.GEMMA_2B, dict(
        materialize_weights=False)
  else:
    jcfg, tcfg, extra = jax_gemma.TOY_DECODER, gemma.TOY_DECODER, {}
  kw = dict(extra, batch=4, signatures=('decode',), fused_projections=True,
            greedy_head=True, kv_int4_group=GROUP)
  assert _graph_signature(gemma.build_decoder(tcfg, **kw)) == \
      _graph_signature(jax_gemma.build_decoder(jcfg, **kw))
  kw = dict(extra, batch_slots=4, prefill_len=8, prefill_batch=2,
            prefill_tail_len=4, device_masks=True, fused_projections=True,
            greedy_head=True, prefill_device_masks=True, prefill_greedy=True,
            prefill_head_cols=True, kv_int4_group=GROUP)
  tgraph = gemma.build_serving_decoder(tcfg, **kw)
  jgraph = jax_gemma.build_serving_decoder(jcfg, **kw)
  assert _graph_signature(tgraph) == _graph_signature(jgraph)
  assert tgraph.metadata == jgraph.metadata


def test_inputs_and_zero_pools_of_an_int4g_graph():
  """make_inputs makes float k/v caches, as the reference's does;
  zero_caches makes the decode signature's uint8 pools and bf16 sidecars
  on the device, as bench.py allocates them."""
  cfg = gemma.TOY_DECODER
  graph = gemma.build_decoder(cfg, batch=3, signatures=('decode',),
                              kv_int4_group=GROUP)
  pools = gemma.zero_caches(graph, 'decode', device='cpu')
  h2, ng3 = cfg.head_dim // 2, 3 * cfg.head_dim // GROUP
  for li in range(cfg.num_layers):
    for kind, shape, dtype in (
        ('k', (3, 2, cfg.max_seq_len, h2), torch.uint8),
        ('v', (3, 2, cfg.max_seq_len, h2), torch.uint8),
        ('s', (3, 2, ng3, cfg.max_seq_len), torch.bfloat16)):
      pool = pools.pop(f'layer_{li}_{kind}_cache_in')
      assert (tuple(pool.shape), pool.dtype) == (shape, dtype)
      assert not torch.count_nonzero(pool)
  assert not pools
  inputs = gemma.make_inputs(cfg, 'decode', 3, 1, device='cpu')
  jinputs = jax_gemma.make_inputs(jax_gemma.TOY_DECODER, 'decode', 3, 1)
  assert sorted(inputs) == sorted(jinputs)
  assert not any('_s_cache' in key for key in inputs)


def test_int4g_graph_weights_travel_both_ways(tmp_path):
  """The materialized weights of an int4g graph (whose extra cache inputs
  shift no weight's tensor id) go through the npz format both ways."""
  kw = dict(batch=2, signatures=('decode',), materialize_weights=False,
            fused_projections=True, greedy_head=True, kv_int4_group=GROUP)
  tgraph = gemma.build_decoder(gemma.TOY_DECODER, **kw)
  tw = gemma.device_materialize_quantized(tgraph, device='cpu')
  path = str(tmp_path / 'w.npz')
  gemma.save_materialized(tgraph, tw, path)
  jgraph = jax_gemma.build_decoder(jax_gemma.TOY_DECODER, **kw)
  jw = jax_gemma.load_materialized(jgraph, path)
  assert sorted(jw) == sorted(tw)
  back = gemma.load_materialized(gemma.build_decoder(gemma.TOY_DECODER, **kw),
                                 path, device='cpu')
  for key, arr in tw.items():
    np.testing.assert_array_equal(np.asarray(jw[key]), arr.numpy())
    np.testing.assert_array_equal(back[key].numpy(), arr.numpy())
    assert jgraph.subgraphs[key[0]].tensors[key[1]].name == \
        tgraph.subgraphs[key[0]].tensors[key[1]].name


def test_no_fusion_units_in_an_int4g_graph(jax_env, monkeypatch):
  """No attention, and so no decode-block, unit matches an int4g decode
  graph, on either side: bench.py's int4g step runs unfused."""
  monkeypatch.setenv('AEQT_DECODE_BLOCK', '1')
  cfg = dict(MQA)
  kw = dict(batch=4, signatures=('decode',), materialize_weights=False,
            fused_projections=True, greedy_head=True, kv_int4_group=GROUP)
  jgraph = jax_gemma.build_decoder(jax_gemma.DecoderConfig(**cfg), **kw)
  tgraph = gemma.build_decoder(gemma.DecoderConfig(**cfg), **kw)
  jweights, tweights = shared_weights(jgraph, tgraph)
  jex = jax_executor.GraphExecutor(jgraph, activation_dtype='float32')
  jex._weights = dict(jweights)
  jex.prepare_serving_weights(min_weight_params=0)
  tex = executor.GraphExecutor(tgraph, device='cpu', mlp_bf=128)
  tex.load_weights(tweights)
  tex.prepare_serving_weights(min_weight_params=0)
  assert tex.decode_block
  for ex in (jex, tex):
    assert len(ex._attn_fusions) == len(ex._block_fusions) == 0
  assert len(tex._mlp_fusions) == len(jex._mlp_fusions) == 2
  assert len(tex._head_fusions) == len(jex._head_fusions) == 1


def test_cuda_wrapper_takes_only_cuda_or_cpu_tensors():
  q = torch.zeros((1, 1, 2, 64), device='meta')
  pool = torch.zeros((1, 1, 8, 32), dtype=torch.uint8, device='meta')
  sidecar = torch.zeros((1, 1, 12, 8), dtype=torch.bfloat16, device='meta')
  before = (KERNEL.launches, KERNEL.plain_calls)
  with pytest.raises(ValueError, match='meta'):
    KERNEL(q, pool, pool, sidecar, torch.ones(1, dtype=torch.int32))
  assert (KERNEL.launches, KERNEL.plain_calls) == before


# -- the decode step ----------------------------------------------------------------

STEPS = 4
BATCH = 4
START = 5


def _decode_pair(greedy):
  """(port config, JAX graph, JAX executor, port executor) of the 2-layer
  MQA int4g decode graph over one weight draw. Needs `jax_env`."""
  kw = dict(batch=BATCH, signatures=('decode',), materialize_weights=False,
            fused_projections=True, greedy_head=greedy, kv_int4_group=GROUP)
  jcfg, tcfg = jax_gemma.DecoderConfig(**MQA), gemma.DecoderConfig(**MQA)
  jgraph = jax_gemma.build_decoder(jcfg, **kw)
  tgraph = gemma.build_decoder(tcfg, **kw)
  jweights, tweights = shared_weights(jgraph, tgraph)
  jex = jax_executor.GraphExecutor(jgraph, activation_dtype='float32')
  jex._weights = dict(jweights)
  jex.prepare_serving_weights(min_weight_params=0)
  tex = executor.GraphExecutor(tgraph, device='cpu',
                               activation_dtype='float32', mlp_bf=128)
  tex.load_weights(tweights)
  tex.prepare_serving_weights(min_weight_params=0)
  return tcfg, jgraph, jex, tex


def _codes(pool):
  return attention.unpack_int4_rows(_t(_np(pool))).to(torch.int32).numpy()


def test_int4g_decode_matches_jax(jax_env):
  """Four greedy steps of the 2-layer MQA decoder from position 5 over
  pools holding 5 quantized random rows, both sides fed the JAX side's
  ids and pools at every step (so a difference does not compound): the
  same ids, logits within 5e-3 of their largest magnitude, every int4 code
  within one step and every sidecar value within 2 bf16 ulps, at most 4
  codes and 8 sidecar values apart per pool and step.

  Why not exact: the JAX RMS_NORM takes an f32 mean of squares, the port
  an f64 sum (ops/impl.py `rms_inverse`); the norm's outputs differ in the
  last place, which can flip an int8 DRQ code of the activation and move
  a row's projections by about 1e-3 relative; a K or V value that moves
  so can round to the neighbouring int4 code and a group's statistics to
  the neighbouring bf16 value. Here, at step 3: one V code one step
  apart, one sidecar value one bf16 ulp apart, the logits 5.4e-4."""
  cfg, jgraph, jex, tex = _decode_pair(greedy=False)
  sig = jgraph.signature_by_key('decode')
  rng = np.random.default_rng(3)
  h, s = cfg.head_dim, cfg.max_seq_len
  jin, tin = {}, {}
  for li in range(cfg.num_layers):
    kp, vp, sidecar = _pools(rng, BATCH, 1, s, h)
    # Rows past START are empty, as in a pool that decode has filled.
    kp[:, :, START:], vp[:, :, START:], sidecar[..., START:] = 0, 0, 0
    for kind, arr in (('k', kp), ('v', vp), ('s', sidecar)):
      jin[f'layer_{li}_{kind}_cache_in'] = _j(arr)
      tin[f'layer_{li}_{kind}_cache_in'] = _t(arr)
  tokens = rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
  calls = KERNEL.plain_calls
  for step in range(STEPS):
    pos = START + step
    mask = np.full((BATCH, 1, cfg.num_query_heads, s), -1e9, np.float32)
    mask[..., :pos + 1] = 0.0  # an input of the graph; the op reads pos
    fields = {'tokens': tokens, 'positions': np.full((BATCH, 1), pos,
                                                     np.int32),
              'cache_pos': np.array([0, 0, pos, 0], np.int32), 'mask': mask}
    jin.update({k: _j(v) for k, v in fields.items()})
    tin.update({k: _t(v) for k, v in fields.items()})
    jout = jex._run_signature(sig.subgraph_index, 'decode', False,
                              jex._weights, jin)
    tout = tex(tin, 'decode')
    assert sorted(tout) == sorted(jout)
    want = np.asarray(jout['logits'])
    got = tout['logits'].numpy()
    assert np.max(np.abs(got - want)) <= 5e-3 * np.max(np.abs(want)), step
    ids = np.argmax(want[:, -1], axis=-1)
    np.testing.assert_array_equal(np.argmax(got[:, -1], axis=-1), ids)
    for key, val in tout.items():
      if not key.endswith('_cache'):
        continue
      assert val.dtype == _t(np.asarray(jout[key])).dtype, key
      if key.endswith('_s_cache'):
        apart = _np(val) != _np(jout[key])
        assert _bf16_ulps(_np(val), _np(jout[key])) <= 2.0, (key, step)
      else:
        diff = np.abs(_codes(val) - _codes(jout[key]))
        apart = diff != 0
        assert diff.max() <= 1, (key, step)
      assert apart.sum() <= (8 if key.endswith('_s_cache') else 4), (
          key, step)
      jin[f'{key}_in'], tin[f'{key}_in'] = jout[key], _t(np.asarray(jout[key]))
    tokens = ids.reshape(BATCH, 1).astype(np.int32)
  assert KERNEL.plain_calls == calls + STEPS * cfg.num_layers


# -- the server ---------------------------------------------------------------------

SLOTS = 4
# The reference's int4-group server test (tests/test_serving.py, the
# kv_int4_group case): TOY_DECODER, 4 slots, prefill groups of 2 x 8.
SERVE_KW = dict(prefill_len=8, device_masks=True, fused_projections=True,
                greedy_head=True, prefill_batch=2, prefill_device_masks=True,
                prefill_greedy=True, prefill_head_cols=True,
                kv_int4_group=GROUP)
PROMPTS = (3, 8, 13)   # 13 spans two prefill chunks
NEW = 6


@pytest.fixture(scope='module')
def serving_env():
  with pytest.MonkeyPatch.context() as mp:
    for var, val in JAX_ENV:
      mp.setenv(var, val)
    yield


def _servers(with_jax=True, **graph_kw):
  """(JAX server or None, port server) over one int4g serving graph and
  one weight draw, every int4 FC packed, aging off."""
  kw = dict(SERVE_KW, **graph_kw)
  tgraph = gemma.build_serving_decoder(
      gemma.TOY_DECODER, batch_slots=SLOTS, materialize_weights=False, **kw)
  if with_jax:
    jgraph = jax_gemma.build_serving_decoder(
        jax_gemma.TOY_DECODER, batch_slots=SLOTS, materialize_weights=False,
        **kw)
    jweights, tweights = shared_weights(jgraph, tgraph)
  else:
    tweights = gemma.device_materialize_quantized(tgraph, device='cpu')
  tserver = batching.DecodeServer(
      tgraph, gemma.TOY_DECODER, SLOTS, weights=tweights, pack_weights=True,
      activation_dtype='float32', starvation_age_s=None, device='cpu')
  tserver._executor.prepare_serving_weights(min_weight_params=0)
  if not with_jax:
    return None, tserver
  jserver = jax_batching.DecodeServer(
      jgraph, jax_gemma.TOY_DECODER, SLOTS, weights=jweights,
      pack_weights=True, activation_dtype='float32', starvation_age_s=None)
  jserver._executor.prepare_serving_weights(min_weight_params=0)
  return jserver, tserver


@pytest.fixture(scope='module')
def int4g_servers(serving_env):
  """One JAX and one port server, shared by the tests that serve on them
  in turn (the JAX server compiles its programs once). Their pools start
  in a 16-row bucket, which generation outgrows (the sidecar pads on its
  last axis, the pools on their third)."""
  return _servers(cache_buckets=(16,))


def _serve(server, chunk, seed=1, prompts=PROMPTS, new=NEW):
  rng = np.random.default_rng(seed)
  for plen in prompts:
    server.submit(rng.integers(1, gemma.TOY_DECODER.vocab_size, plen).astype(
        np.int32), max_new_tokens=new)
  reqs = list(server._queue)
  while server.has_work():
    if chunk:
      server.step_chunk(chunk)
    else:
      server.step()
  return [(r.status, list(r.generated)) for r in reqs]


@pytest.mark.parametrize('chunk', [0, 4])
def test_int4g_server_tokens_match_jax(chunk, int4g_servers):
  jserver, tserver = int4g_servers
  calls = KERNEL.plain_calls
  ticks = tserver.metrics['decode_ticks']
  want = _serve(jserver, chunk)
  got = _serve(tserver, chunk)
  assert got == want
  assert all(status == 'done' and len(ids) == NEW for status, ids in got)
  layers = gemma.TOY_DECODER.num_layers
  assert KERNEL.plain_calls - calls == (
      tserver.metrics['decode_ticks'] - ticks) * layers
  assert tserver._buckets == jserver._buckets == [16, 64]
  assert tserver.metrics['bucket_switches'] == jserver.metrics[
      'bucket_switches'] > 0
  assert sorted(tserver._caches) == sorted(jserver._caches)
  for key, pool in tserver._caches.items():
    assert pool.shape[-1 if key.endswith('_s_cache_in') else 2] == 64, key
    np.testing.assert_array_equal(_bits(pool), _bits(jserver._caches[key]),
                                  err_msg=key)


def test_int4g_prompt_longer_than_the_bucket_keeps_its_rows(serving_env):
  """A 40-token prompt admitted into the 32-row bucket: the port grows the
  pools (the sidecar on its last axis) before the slot writer quantizes
  the prompt's rows into them, so the rows past 32 survive and the tokens
  are those of a server without buckets (ROADMAP.md, Queue 3)."""
  _, plain = _servers(with_jax=False)
  _, bucketed = _servers(with_jax=False, cache_buckets=(32,))
  prompt = np.random.default_rng(3).integers(
      1, gemma.TOY_DECODER.vocab_size, 40).astype(np.int32)
  for server in (plain, bucketed):
    server.submit(prompt, max_new_tokens=NEW)
    server._admit()
  assert bucketed._bucket == 64
  for key, pool in plain._caches.items():
    torch.testing.assert_close(bucketed._caches[key], pool, rtol=0, atol=0)
  assert torch.count_nonzero(plain._caches['layer_0_k_cache_in'][0, :, 32:40])
  assert torch.count_nonzero(plain._caches['layer_0_s_cache_in'][0, ..., 32:40])
  outs = []
  for server in (plain, bucketed):
    req = server._slots[0].request
    while server.has_work():
      server.step()
    outs.append(list(req.generated))
  assert outs[0] == outs[1] and len(outs[0]) == NEW
