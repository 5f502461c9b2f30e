"""The port's Gemma decode slice against the JAX package, on the CPU.

The JAX side builds the graph and runs its executor with the bench's serving options (int4 DRQ, lengths
attention with the stale cache writeback, MLP and head fusions), its
Pallas kernels in interpret mode, with the decode block off on both sides
(AEQT_DECODE_BLOCK=0, `decode_block=False`; tests/test_torch_port_block.py
holds the block). The port builds the same graph with its
own builder; both take one weight draw (`shared_weights`: the port's
materializer, which is the same in every process) and the port runs its
executor on the CPU, where every kernel wrapper runs its plain version.
Eight greedy decode steps feed the tokens back.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu.execution import executor as jax_executor
from ai_edge_quantizer_tpu.graph import ir as jax_ir
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.kernels import attention, head, mlp
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul
from ai_edge_quantizer_tpu_torch.models import gemma

STEPS = 8
BATCH = 4
# MQA like Gemma (one KV head); every FC packs (N % 128 == 0) and the MLP
# fuses (down N = 256 needs no padding; F = 512 = 4 groups of 128).
MQA = dict(vocab_size=512, embed_dim=256, num_layers=2, num_query_heads=4,
           num_kv_heads=1, head_dim=64, ffn_dim=512, max_seq_len=64)
CONFIGS = {
    'toy': (jax_gemma.TOY_DECODER, gemma.TOY_DECODER),
    'mqa': (jax_gemma.DecoderConfig(**MQA), gemma.DecoderConfig(**MQA)),
}
KERNELS = (packed_qmatmul.qmatmul_int4_packed_drq,
           attention.decode_attention_int8_lengths_stale,
           mlp.mlp_int4_packed, head.head_argmax)


def shared_weights(jgraph, tgraph, device='cpu'):
  """One weight draw for both sides, the same in every process.

  The port's `device_materialize_quantized` seeds each weight with
  zlib.crc32 of its name (the JAX one with `hash`, which Python salts per
  process). Its int weights and scales are stamped onto the JAX graph as
  the JAX materializer stamps them, and the same arrays go to both sides.
  Returns (JAX weight dict, port weight dict).
  """
  tweights = gemma.device_materialize_quantized(tgraph, fc_bits=4,
                                                embedding_bits=8,
                                                device=device)
  jweights, shared = {}, {}
  for (sg_idx, tid), arr in tweights.items():
    if id(arr) not in shared:
      shared[id(arr)] = jnp.asarray(arr.cpu().numpy())
    jweights[(sg_idx, tid)] = shared[id(arr)]
    tq = tgraph.subgraphs[sg_idx].tensors[tid].quantization
    if tq is not None:
      jt = jgraph.subgraphs[sg_idx].tensors[tid]
      scale32 = np.asarray(tq.scale, np.float32)
      jt.quantization = jax_ir.QuantizationInfo(
          scale=scale32, zero_point=np.zeros_like(scale32, np.int8),
          quantized_dimension=0, num_bits=tq.num_bits)
      jt.dtype = jax_ir.dtype_for_bits(tq.num_bits)
  return jweights, tweights


JAX_SERVING_ENV = (('AEQT_INT4_DRQ', '1'), ('AEQT_ATTN_WRITEBACK_MODE', 'stale'),
                   ('AEQT_ATTN_LENGTHS', '1'), ('AEQT_MLP_BF', '128'),
                   ('AEQT_MLP_FUSION', '1'), ('AEQT_HEAD_FUSION', '1'),
                   ('AEQT_DECODE_BLOCK', '0'))


def _serving_pair(name, greedy, monkeypatch, writeback=True,
                  signatures=('decode',), fused=True):
  jcfg, tcfg = CONFIGS[name]
  kw = dict(batch=BATCH, signatures=signatures, materialize_weights=False,
            fused_projections=fused, greedy_head=greedy)
  jgraph = jax_gemma.build_decoder(jcfg, **kw)
  jax_gemma.stamp_int8_kv_cache(jgraph)
  tgraph = gemma.build_decoder(tcfg, **kw)
  gemma.stamp_int8_kv_cache(tgraph)
  jweights, tweights = shared_weights(jgraph, tgraph)
  for var, val in JAX_SERVING_ENV + (
      ('AEQT_ATTN_WRITEBACK', '1' if writeback else '0'),):
    monkeypatch.setenv(var, val)
  jex = jax_executor.GraphExecutor(jgraph, activation_dtype='float32')
  jex._weights = dict(jweights)
  jex.prepare_serving_weights(min_weight_params=0)
  tex = executor.GraphExecutor(tgraph, device='cpu',
                               activation_dtype='float32', int4_drq=True,
                               attn_lengths=True,
                               attn_writeback='stale' if writeback else None,
                               mlp_fusion=True, mlp_bf=128, head_fusion=True,
                               decode_block=False)
  tex.load_weights(tweights)
  tex.prepare_serving_weights(min_weight_params=0)
  return jcfg, jgraph, jex, tex


def _step_inputs(cfg, pos, tokens):
  g = cfg.num_query_heads // cfg.num_kv_heads
  mask = np.full((BATCH, 1, g, cfg.max_seq_len), -1e9, np.float32)
  mask[..., :pos + 1] = 0.0
  return {'tokens': tokens.reshape(BATCH, 1).astype(np.int32),
          'positions': np.full((BATCH, 1), pos, np.int32),
          'mask': mask, 'cache_pos': np.array([0, 0, pos, 0], np.int32)}


def _decode_both(name, greedy, monkeypatch, writeback=True, fused=True,
                 shared_caches=False):
  """Run STEPS decode steps on both sides; yields per-step outputs.

  With shared_caches, both sides take the JAX side's output caches as the
  next step's input caches, so each step's difference is its own (an int8
  KV code that rounds the other way does not compound)."""
  cfg, jgraph, jex, tex = _serving_pair(name, greedy, monkeypatch,
                                        writeback, fused=fused)
  sig = jgraph.signature_by_key('decode')
  start = jax_gemma.make_inputs(cfg, 'decode', BATCH, 1, start_pos=0)
  jin = {k: jnp.asarray(v) for k, v in start.items()}
  tin = {k: torch.from_numpy(np.array(v)) for k, v in start.items()}
  for step in range(STEPS):
    jout = jex._run_signature(sig.subgraph_index, 'decode', False,
                              jex._weights, jin)
    tout = tex(tin, 'decode')
    yield step, jout, tout
    if greedy:
      tokens = np.asarray(jout['next_tokens'])
    else:
      tokens = np.argmax(np.asarray(jout['logits'])[:, -1], axis=-1)
    for li in range(cfg.num_layers):
      for kind in ('k', 'v'):
        key = f'layer_{li}_{kind}_cache'
        jin[f'{key}_in'] = jout[key]
        tin[f'{key}_in'] = (torch.from_numpy(np.array(jout[key]))
                            if shared_caches else tout[key])
    for k, v in _step_inputs(cfg, step + 1, tokens).items():
      jin[k] = jnp.asarray(v)
      tin[k] = torch.from_numpy(v)


@pytest.mark.parametrize('name', ['toy', 'mqa'])
def test_greedy_decode_ids_match_jax(name, monkeypatch):
  before = [(k.plain_calls, k.launches) for k in KERNELS]
  for step, jout, tout in _decode_both(name, True, monkeypatch):
    np.testing.assert_array_equal(
        tout['next_tokens'].numpy(), np.asarray(jout['next_tokens']),
        err_msg=f'{name} step {step}')
    for key, val in tout.items():
      if key.endswith('_cache'):
        diff = np.abs(val.numpy().astype(np.int32)
                      - np.asarray(jout[key]).astype(np.int32))
        assert diff.max() <= 1, (key, step)  # int8 codes, one rounding step
  ran = [k.plain_calls - b[0] for k, b in zip(KERNELS, before)]
  assert all(k.launches == b[1] for k, b in zip(KERNELS, before))
  layers = CONFIGS[name][1].num_layers
  mlp_fused = name == 'mqa'  # TOY's down FC (N = 128) pads, so no fusion
  want = [STEPS * layers * (2 if mlp_fused else 4), STEPS * layers,
          STEPS * layers if mlp_fused else 0, STEPS]
  assert ran == want


@pytest.mark.parametrize('name', ['toy', 'mqa'])
def test_fusion_counts_match_jax(name, monkeypatch):
  _, _, jex, tex = _serving_pair(name, True, monkeypatch)
  assert len(tex._attn_fusions) == len(jex._attn_fusions) > 0
  assert len(tex._mlp_fusions) == len(jex._mlp_fusions)
  assert len(tex._head_fusions) == len(jex._head_fusions) == 1
  assert tex._packed_int4_keys == jex._packed_int4_keys
  assert tex._packed_pad_n == jex._packed_pad_n
  if name == 'mqa':
    assert len(tex._mlp_fusions) == 2
  for key, arr in jex._weights.items():
    np.testing.assert_array_equal(tex._weights[key].numpy(), np.asarray(arr),
                                  err_msg=str(key))


@pytest.mark.parametrize('name', ['toy', 'mqa'])
def test_logits_decode_matches_jax(name, monkeypatch):
  for step, jout, tout in _decode_both(name, False, monkeypatch,
                                       shared_caches=True):
    np.testing.assert_allclose(tout['logits'].numpy(),
                               np.asarray(jout['logits']), rtol=1e-4,
                               atol=1e-4, err_msg=f'{name} step {step}')


@pytest.mark.parametrize('name', ['toy', 'mqa'])
def test_unfused_attention_decode_matches_jax(name, monkeypatch):
  """No cache writeback: the attention chain runs the executor's plain
  twin (the path the card refuses until its kernels are ported)."""
  for step, jout, tout in _decode_both(name, True, monkeypatch,
                                       writeback=False):
    np.testing.assert_array_equal(
        tout['next_tokens'].numpy(), np.asarray(jout['next_tokens']),
        err_msg=f'{name} step {step}')


def test_separate_projections_decode_matches_jax(monkeypatch):
  """fused_projections=False: separate q/k/v and gate/up FCs, so the MLP
  fusion matches its second pattern (gate and up FCs on one input)."""
  _, _, jex, tex = _serving_pair('mqa', True, monkeypatch, fused=False)
  assert len(tex._mlp_fusions) == len(jex._mlp_fusions) == 2
  assert len(tex._attn_fusions) == len(jex._attn_fusions) == 2
  for step, jout, tout in _decode_both('mqa', True, monkeypatch,
                                       fused=False):
    np.testing.assert_array_equal(
        tout['next_tokens'].numpy(), np.asarray(jout['next_tokens']),
        err_msg=f'step {step}')


def test_prefill_matches_jax(monkeypatch):
  """The prefill signature: 16 query rows per sequence, so attention
  takes the prefill-shaped plain twin."""
  cfg, jgraph, jex, tex = _serving_pair('toy', False, monkeypatch,
                                        signatures=('prefill', 'decode'))
  sig = jgraph.signature_by_key('prefill')
  start = jax_gemma.make_inputs(cfg, 'prefill', BATCH, 16, start_pos=0)
  jout = jex._run_signature(sig.subgraph_index, 'prefill', False,
                            jex._weights,
                            {k: jnp.asarray(v) for k, v in start.items()})
  tout = tex({k: torch.from_numpy(np.array(v)) for k, v in start.items()},
             'prefill')
  assert sorted(tout) == sorted(jout)
  np.testing.assert_allclose(tout['logits'].numpy(),
                             np.asarray(jout['logits']), rtol=1e-4,
                             atol=1e-4)
  for key, val in tout.items():
    if key.endswith('_cache'):
      diff = np.abs(val.numpy().astype(np.int32)
                    - np.asarray(jout[key]).astype(np.int32))
      assert diff.max() <= 1, key  # int8 codes, one rounding step


# -- graph, weights and inputs ------------------------------------------------


def _graph_signature(graph):
  """Everything the builder decides, as plain Python values."""
  out = []
  for sg in graph.subgraphs:
    tensors = []
    for t in sg.tensors:
      q = t.quantization
      stamp = None if q is None else (
          np.asarray(q.scale).tolist(), np.asarray(q.zero_point).tolist(),
          q.quantized_dimension, q.num_bits, q.block_size)
      tensors.append((t.name, tuple(t.shape), t.dtype, t.buffer, stamp))
    ops = [(o.opcode, list(o.inputs), list(o.outputs), repr(o.attrs))
           for o in sg.ops]
    out.append((sg.name, tensors, ops, list(sg.inputs), list(sg.outputs)))
  sigs = [(s.signature_key, s.subgraph_index, dict(s.inputs), dict(s.outputs))
          for s in graph.signatures]
  buffers = [None if b.data is None else np.asarray(b.data).tolist()
             for b in graph.buffers]
  return out, sigs, buffers


@pytest.mark.parametrize('name,kw', [
    ('toy', dict(signatures=('prefill', 'decode'))),
    ('toy', dict(signatures=('decode',), fused_projections=True,
                 greedy_head=True)),
    ('gemma_2b', dict(signatures=('decode',), fused_projections=True,
                      greedy_head=True, batch=64)),
])
def test_build_decoder_matches_jax(name, kw):
  if name == 'gemma_2b':
    jcfg, tcfg = jax_gemma.GEMMA_2B, gemma.GEMMA_2B
    kw = dict(kw, materialize_weights=False)
  else:
    jcfg, tcfg = CONFIGS[name]
  jgraph = jax_gemma.build_decoder(jcfg, **kw)
  tgraph = gemma.build_decoder(tcfg, **kw)
  jax_gemma.stamp_int8_kv_cache(jgraph)
  gemma.stamp_int8_kv_cache(tgraph)
  assert _graph_signature(tgraph) == _graph_signature(jgraph)
  assert (tgraph.metadata['weight_init_specs']
          == jgraph.metadata['weight_init_specs'])


def test_device_materialize_quantized_stamps_like_jax():
  kw = dict(batch=2, signatures=('decode',), materialize_weights=False,
            fused_projections=True, greedy_head=True)
  jgraph = jax_gemma.build_decoder(jax_gemma.TOY_DECODER, **kw)
  tgraph = gemma.build_decoder(gemma.TOY_DECODER, **kw)
  jw = jax_gemma.device_materialize_quantized(jgraph)
  tw = gemma.device_materialize_quantized(tgraph, device='cpu')
  again = gemma.device_materialize_quantized(
      gemma.build_decoder(gemma.TOY_DECODER, **kw), device='cpu')
  assert sorted(tw) == sorted(jw)
  for key, arr in jw.items():
    jt = jgraph.subgraphs[key[0]].tensors[key[1]]
    tt = tgraph.subgraphs[key[0]].tensors[key[1]]
    assert (tt.dtype, tuple(tw[key].shape)) == (jt.dtype, arr.shape)
    assert tw[key].dtype == getattr(torch, str(arr.dtype))
    assert (jt.quantization is None) == (tt.quantization is None)
    if tt.quantization is not None:
      assert tt.quantization.num_bits == jt.quantization.num_bits
      assert np.asarray(tt.quantization.scale).shape == np.asarray(
          jt.quantization.scale).shape
    torch.testing.assert_close(tw[key], again[key], rtol=0, atol=0)


def test_load_materialized_reads_jax_npz(tmp_path):
  kw = dict(batch=2, signatures=('decode',), materialize_weights=False,
            fused_projections=True, greedy_head=True)
  jgraph = jax_gemma.build_decoder(jax_gemma.TOY_DECODER, **kw)
  jw = jax_gemma.device_materialize_quantized(jgraph)
  path = str(tmp_path / 'w.npz')
  jax_gemma.save_materialized(jgraph, jw, path)
  tgraph = gemma.build_decoder(gemma.TOY_DECODER, **kw)
  tw = gemma.load_materialized(tgraph, path, device='cpu')
  assert sorted(tw) == sorted(jw)
  for key, arr in jw.items():
    np.testing.assert_array_equal(tw[key].numpy(), np.asarray(arr))
    jq = jgraph.subgraphs[key[0]].tensors[key[1]].quantization
    tq = tgraph.subgraphs[key[0]].tensors[key[1]].quantization
    if jq is not None:
      np.testing.assert_array_equal(tq.scale, jq.scale)
      assert tq.num_bits == jq.num_bits
  # And back: the port's file reads in the JAX package.
  path2 = str(tmp_path / 'w2.npz')
  gemma.save_materialized(tgraph, tw, path2)
  jgraph2 = jax_gemma.build_decoder(jax_gemma.TOY_DECODER, **kw)
  jw2 = jax_gemma.load_materialized(jgraph2, path2)
  for key, arr in jw.items():
    np.testing.assert_array_equal(np.asarray(jw2[key]), np.asarray(arr))


@pytest.mark.parametrize('start_pos', [0, 5])
def test_make_inputs_matches_jax(start_pos):
  cfg = dataclasses.replace(gemma.TOY_DECODER, num_layers=1)
  jcfg = dataclasses.replace(jax_gemma.TOY_DECODER, num_layers=1)
  want = jax_gemma.make_inputs(jcfg, 'decode', 3, 2, start_pos=start_pos,
                               seed=4)
  got = gemma.make_inputs(cfg, 'decode', 3, 2, start_pos=start_pos, seed=4,
                          device='cpu')
  assert sorted(got) == sorted(want)
  for key, arr in want.items():
    np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)


def test_shared_weights_do_not_depend_on_the_hash_seed():
  """The parity tests' weights (and their scales) are the same in every
  process, whatever PYTHONHASHSEED salts `hash` with."""
  code = (
      'import hashlib\n'
      'import numpy as np\n'
      'from ai_edge_quantizer_tpu_torch.models import gemma\n'
      f'cfg = gemma.DecoderConfig(**{MQA!r})\n'
      'g = gemma.build_decoder(cfg, batch=4, signatures=("decode",), '
      'materialize_weights=False, fused_projections=True, greedy_head=True)\n'
      'w = gemma.device_materialize_quantized(g, device="cpu")\n'
      'h = hashlib.sha256()\n'
      'for (sg, tid) in sorted(w):\n'
      '  h.update(w[(sg, tid)].numpy().tobytes())\n'
      '  q = g.subgraphs[sg].tensors[tid].quantization\n'
      '  if q is not None:\n'
      '    h.update(np.asarray(q.scale, np.float32).tobytes())\n'
      'print(h.hexdigest())\n')
  root = pathlib.Path(__file__).resolve().parent.parent
  outs = [subprocess.run([sys.executable, '-c', code], cwd=root,
                         env=dict(os.environ, PYTHONHASHSEED=seed),
                         capture_output=True, text=True, timeout=120)
          for seed in ('1', '2')]
  assert outs[0].returncode == 0, outs[0].stderr
  assert outs[0].stdout == outs[1].stdout
