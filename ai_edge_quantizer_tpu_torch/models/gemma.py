"""Gemma-class decoder-only transformer as Graph IR (PyTorch port).

Port of `ai_edge_quantizer_tpu/models/gemma.py`. The graph builders
(`DecoderConfig` and its configs, `_WeightStore`, `_build_signature`,
`build_decoder`, `build_serving_decoder`, `stamp_int8_kv_cache`) are
copied: they are numpy only.
`device_materialize_quantized` and `make_inputs` make torch tensors on
the chosen device; `save_materialized` / `load_materialized` read and
write the same npz files as the JAX package, and `weights_from_numpy`
carries a JAX executor's weight dict across.

The builders make a multi-signature model (prefill + decode) over ONE
shared weight store. The KV cache is functional state: caches enter as
signature inputs and leave as outputs, updated with DYNAMIC_UPDATE_SLICE.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional
import zlib

import numpy as np
import torch

from ai_edge_quantizer_tpu_torch.execution import quant_arith
from ai_edge_quantizer_tpu_torch.graph import builder as builder_lib
from ai_edge_quantizer_tpu_torch.graph import ir


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
  vocab_size: int
  embed_dim: int
  num_layers: int
  num_query_heads: int
  num_kv_heads: int
  head_dim: int
  ffn_dim: int
  max_seq_len: int
  rope_base: float = 10000.0
  norm_eps: float = 1e-6
  tie_embedding: bool = True
  # Mixture-of-Experts FFN: num_experts > 0 replaces the dense GeGLU FFN
  # with a top-k routed expert bank (per-expert gate/up/down FCs emitted
  # as regular FULLY_CONNECTED ops so the quantizer pipeline quantizes
  # expert weights like any weight op; routing is built from stock ops).
  # The executor's EP fusion stacks the quantized experts and shards them
  # over an 'ep' mesh axis (parallel/moe.py).
  num_experts: int = 0
  moe_top_k: int = 2


TOY_DECODER = DecoderConfig(
    vocab_size=512, embed_dim=128, num_layers=2, num_query_heads=4,
    num_kv_heads=2, head_dim=32, ffn_dim=256, max_seq_len=64)

# Toy MoE variant: 4 experts, top-2 routing (EP integration tests +
# dryrun stage 5 run this through the quantizer + executor).
TOY_MOE = DecoderConfig(
    vocab_size=512, embed_dim=128, num_layers=2, num_query_heads=4,
    num_kv_heads=2, head_dim=32, ffn_dim=128, max_seq_len=64,
    num_experts=4, moe_top_k=2)

# Gemma-2B-shaped configuration (Gemma 1 2B: MQA with 1 KV head).
GEMMA_2B = DecoderConfig(
    vocab_size=256128, embed_dim=2048, num_layers=18, num_query_heads=8,
    num_kv_heads=1, head_dim=256, ffn_dim=16384, max_seq_len=1024)

# A mid-size config for benchmarking on a single chip without the 256k
# embedding dominating build time.
GEMMA_2B_LITE = DecoderConfig(
    vocab_size=32000, embed_dim=2048, num_layers=18, num_query_heads=8,
    num_kv_heads=1, head_dim=256, ffn_dim=16384, max_seq_len=1024)

# Gemma-7B-shaped configuration (Gemma 1 7B: MHA, 16 heads x 256).
# int4 weights ~3.9 GiB + int8 embedding 0.5 GiB fit a single 16 GiB
# chip with int8 KV caches at B=16, S=512 (28 layers x 2 x 16 x 256 B
# = 229 KB/token-slot); larger batches/contexts shard over a mesh.
GEMMA_7B = DecoderConfig(
    vocab_size=256128, embed_dim=3072, num_layers=28, num_query_heads=16,
    num_kv_heads=16, head_dim=256, ffn_dim=24576, max_seq_len=512)


class _WeightStore:
  """Creates each weight buffer once; later subgraphs alias it.

  With materialize=False, buffers stay empty (data=None) and `init_specs`
  records (shape, init_scale) per key so weights can be generated ON DEVICE
  later (models.gemma.device_materialize_quantized) — host memory never
  touches the fp32 weights.
  """

  def __init__(self, cfg: DecoderConfig, seed: int = 0,
               materialize: bool = True):
    self.cfg = cfg
    self.materialize = materialize
    self.rng = np.random.default_rng(seed)
    self._buffers: dict = {}   # name -> (buffer_id, shape)
    self.init_specs: dict = {}  # key -> (shape, init_scale)

  def tensor(self, b: builder_lib.GraphBuilder, name: str, shape,
             init_scale: float) -> int:
    """Constant tensor aliasing the store's buffer for `name`."""
    key = name.split('/', 1)[1] if '/' in name else name  # strip sig prefix
    if key not in self._buffers:
      if self.materialize:
        # Native-f32 generation + in-place scale: avoids f64 temporaries
        # and fresh large allocations (page-fault bound on big models).
        data = self.rng.standard_normal(size=shape, dtype=np.float32)
        data *= init_scale
      else:
        data = None
      buf_id = b.graph.add_buffer(data)
      self._buffers[key] = (buf_id, tuple(shape))
      self.init_specs[key] = (tuple(shape), init_scale)
    buf_id, stored_shape = self._buffers[key]
    assert stored_shape == tuple(shape), (name, stored_shape, shape)
    return b.shared_constant(name, buf_id, shape, 'float32')


def _build_signature(
    b: builder_lib.GraphBuilder,
    store: _WeightStore,
    sig: str,
    batch: int,
    seq_len: int,
    cache_update: str = 'dus',
    fused_projections: bool = False,
    device_masks: bool = False,
    greedy_head: bool = False,
    head_cols: bool = False,
    kv_int4_group: int = 0,
) -> None:
  """Build one decoder pass (prefill: seq_len=T, decode: seq_len=1).

  kv_int4_group (decode + dus only): KV caches are int4-packed with
  per-group sidecar scales of this group size; the whole
  quantize-write-attend step is ONE custom op (INT4G_ATTENTION,
  ops/impl.py) over uint8 caches + a bf16 sidecar — half the int8 cache
  stream, the decode step's dominant HBM traffic.

  head_cols (prefill, T > 1): add a `head_cols` [B, 1] int32 input and
  run the vocab head on ONE gathered row per batch element (one-hot
  blend over T) instead of all T positions. Admission consumes exactly
  one next-token per request, and nothing at all from intermediate
  chunks, so the full-T head is pure waste: 2*B*T*D*V FLOPs (~137
  GFLOP/chunk at 2B-lite shapes) collapse to 2*B*D*V.

  cache_update: 'dus' writes all rows at one shared position
  (DYNAMIC_UPDATE_SLICE, the SAME_AS_OUTPUT-scale int8-cache path);
  'onehot' scatters per-row positions via masked blend (continuous
  batching: every sequence in the batch writes its own cache slot).

  device_masks (decode + onehot only): the attention mask and the cache
  scatter one-hot are DERIVED IN-GRAPH from `positions` (iota compare),
  so a serving tick transfers only tokens + positions — no [B,1,G,S]
  host-built mask crosses the link.
  """
  cfg = store.cfg
  B, T, D = batch, seq_len, cfg.embed_dim
  NQ, NK, H = cfg.num_query_heads, cfg.num_kv_heads, cfg.head_dim
  G = NQ // NK
  S = cfg.max_seq_len
  F = cfg.ffn_dim

  tokens = b.input(f'{sig}/tokens', (B, T), 'int32')
  positions = b.input(f'{sig}/positions', (B, T), 'int32')
  cache_pos = -1
  cache_onehot = -1
  if device_masks and T == 1 and cache_update == 'onehot':
    shape4 = b.constant(f'{sig}/pos4_shape',
                        np.asarray([B, 1, 1, 1], np.int32))
    pos4 = b.op('RESHAPE', [positions, shape4], [(B, 1, 1, 1)],
                output_names=[f'{sig}/pos4'])
    iota_row = b.constant(
        f'{sig}/iota_row', np.arange(S, dtype=np.int32).reshape(1, 1, 1, S))
    visible = b.op('LESS_EQUAL', [iota_row, pos4], [(B, 1, 1, S)],
                   output_names=[f'{sig}/mask_visible'])
    visible_f = b.activation(f'{sig}/mask_visible_f', (B, 1, 1, S))
    b.subgraph.ops.append(ir.Op(opcode='CAST', inputs=[visible],
                                outputs=[visible_f]))
    one = b.constant(f'{sig}/mask_one', np.asarray(1.0, np.float32))
    neg = b.constant(f'{sig}/mask_neg', np.asarray(1e9, np.float32))
    m1 = b.op('SUB', [visible_f, one], [(B, 1, 1, S)],
              output_names=[f'{sig}/mask_m1'])
    mask = b.op('MUL', [m1, neg], [(B, 1, 1, S)],
                output_names=[f'{sig}/mask'])
    iota_col = b.constant(
        f'{sig}/iota_col', np.arange(S, dtype=np.int32).reshape(1, 1, S, 1))
    hit = b.op('EQUAL', [iota_col, pos4], [(B, 1, S, 1)],
               output_names=[f'{sig}/cache_hit'])
    cache_onehot = b.activation(f'{sig}/cache_onehot', (B, 1, S, 1))
    b.subgraph.ops.append(ir.Op(opcode='CAST', inputs=[hit],
                                outputs=[cache_onehot]))
  elif device_masks and cache_update == 'dus':
    # Prefill device masks: the causal mask is DERIVED IN-GRAPH from
    # `positions` (key column s visible to query row t iff s <= pos[b,t]),
    # so an admission ships tokens + positions + a 4-int cache_pos — not a
    # host-built [B,1,G*T,S] float mask (~4 MB/chunk at 2B scale, the
    # dominant per-admission transfer through a high-latency host link).
    # Padded prompt columns carry positions beyond every valid row's
    # position, so valid rows never attend to them; padded rows' outputs
    # are discarded and their cache writes are overwritten by decode
    # before any mask exposes them.
    shape4 = b.constant(f'{sig}/pos4_shape',
                        np.asarray([B, 1, T, 1], np.int32))
    pos4 = b.op('RESHAPE', [positions, shape4], [(B, 1, T, 1)],
                output_names=[f'{sig}/pos4'])
    iota_row = b.constant(
        f'{sig}/iota_row', np.arange(S, dtype=np.int32).reshape(1, 1, 1, S))
    visible = b.op('LESS_EQUAL', [iota_row, pos4], [(B, 1, T, S)],
                   output_names=[f'{sig}/mask_visible'])
    visible_f = b.activation(f'{sig}/mask_visible_f', (B, 1, T, S))
    b.subgraph.ops.append(ir.Op(opcode='CAST', inputs=[visible],
                                outputs=[visible_f]))
    one = b.constant(f'{sig}/mask_one', np.asarray(1.0, np.float32))
    neg = b.constant(f'{sig}/mask_neg', np.asarray(1e9, np.float32))
    m1 = b.op('SUB', [visible_f, one], [(B, 1, T, S)],
              output_names=[f'{sig}/mask_m1'])
    mask_rows = b.op('MUL', [m1, neg], [(B, 1, T, S)],
                     output_names=[f'{sig}/mask_rows'])
    if G == 1:
      mask = mask_rows  # already [B, 1, G*T, S]
    else:
      # Tile the T query rows across the G grouped-query heads: the score
      # layout is g-major ([B, NK, G*T, S]), so broadcast the G axis in
      # front of T, then flatten.
      maskg = b.op('BROADCAST_TO', [mask_rows], [(B, G, T, S)],
                   output_names=[f'{sig}/mask_g'])
      mask = b.op('RESHAPE', [maskg], [(B, 1, G * T, S)],
                  output_names=[f'{sig}/mask'],
                  attrs={'new_shape': [B, 1, G * T, S]})
    cache_pos = b.input(f'{sig}/cache_pos', (4,), 'int32')
  else:
    # Additive attention mask over the full cache: 0 for visible,
    # -inf-like for hidden. Broadcasts over grouped score rows.
    mask = b.input(f'{sig}/mask', (B, 1, G * T, S), 'float32')
    if cache_update == 'dus':
      # Cache write position as DUS start indices [b, head, pos, dim].
      cache_pos = b.input(f'{sig}/cache_pos', (4,), 'int32')
    else:
      # Per-row scatter mask: cache_onehot[b, 0, s, 0] = 1 at row b's
      # write positions (T ones per row).
      cache_onehot = b.input(f'{sig}/cache_onehot', (B, 1, S, 1), 'float32')

  embed_w = store.tensor(b, f'{sig}/embedder/w', (cfg.vocab_size, D),
                         1.0 / math.sqrt(D))
  x = b.op('EMBEDDING_LOOKUP', [tokens, embed_w], [(B, T, D)],
           output_names=[f'{sig}/embedder/out'])
  # Gemma scales embeddings by sqrt(dim).
  esc = b.constant(f'{sig}/embed_scale', np.array([math.sqrt(D)], np.float32))
  x = b.op('MUL', [x, esc], [(B, T, D)],
           output_names=[f'{sig}/embed_scaled'])

  one_const = -1
  if cache_update != 'dus':
    one_const = b.constant(f'{sig}/one', np.array([1.0], np.float32))

  if kv_int4_group:
    if T != 1:
      raise ValueError('kv_int4_group requires decode (T=1).')
    if H % kv_int4_group:
      raise ValueError(f'head_dim {H} must divide by group '
                       f'{kv_int4_group}.')
  kv_outs = []
  for li in range(cfg.num_layers):
    p = f'{sig}/layer_{li}'
    if kv_int4_group:
      ng3 = 3 * (H // kv_int4_group)
      k_cache = b.input(f'{p}/k_cache', (B, NK, S, H // 2), 'uint8',
                        user_name=f'layer_{li}_k_cache_in')
      v_cache = b.input(f'{p}/v_cache', (B, NK, S, H // 2), 'uint8',
                        user_name=f'layer_{li}_v_cache_in')
      kv_sidecar = b.input(f'{p}/kv_sidecar', (B, NK, ng3, S), 'bfloat16',
                           user_name=f'layer_{li}_s_cache_in')
    else:
      k_cache = b.input(f'{p}/k_cache', (B, NK, S, H), 'float32',
                        user_name=f'layer_{li}_k_cache_in')
      v_cache = b.input(f'{p}/v_cache', (B, NK, S, H), 'float32',
                        user_name=f'layer_{li}_v_cache_in')

    # -- attention block --
    gamma1 = store.tensor(b, f'{p}/pre_attn_norm/gamma', (D,), 0.1)
    xn = b.op('RMS_NORM', [x, gamma1], [(B, T, D)],
              output_names=[f'{p}/pre_attn_norm/out'],
              attrs={'epsilon': cfg.norm_eps})
    if fused_projections:
      # One fused QKV matmul: fewer, larger kernels (serving-optimal).
      qkv_dim = (NQ + 2 * NK) * H
      wqkv = store.tensor(b, f'{p}/attn/qkv/w', (qkv_dim, D), 0.02)
      qkv = b.op('FULLY_CONNECTED', [xn, wqkv, -1], [(B, T, qkv_dim)],
                 output_names=[f'{p}/attn/qkv/out'],
                 attrs={'fused_activation': 'NONE'})
      q = b.op('SLICE', [qkv], [(B, T, NQ * H)],
               output_names=[f'{p}/attn/q/out'],
               attrs={'begin': [0, 0, 0]})
      k = b.op('SLICE', [qkv], [(B, T, NK * H)],
               output_names=[f'{p}/attn/k/out'],
               attrs={'begin': [0, 0, NQ * H]})
      v = b.op('SLICE', [qkv], [(B, T, NK * H)],
               output_names=[f'{p}/attn/v/out'],
               attrs={'begin': [0, 0, (NQ + NK) * H]})
    else:
      wq = store.tensor(b, f'{p}/attn/q/w', (NQ * H, D), 0.02)
      wk = store.tensor(b, f'{p}/attn/k/w', (NK * H, D), 0.02)
      wv = store.tensor(b, f'{p}/attn/v/w', (NK * H, D), 0.02)
      q = b.op('FULLY_CONNECTED', [xn, wq, -1], [(B, T, NQ * H)],
               output_names=[f'{p}/attn/q/out'],
               attrs={'fused_activation': 'NONE'})
      k = b.op('FULLY_CONNECTED', [xn, wk, -1], [(B, T, NK * H)],
               output_names=[f'{p}/attn/k/out'],
               attrs={'fused_activation': 'NONE'})
      v = b.op('FULLY_CONNECTED', [xn, wv, -1], [(B, T, NK * H)],
               output_names=[f'{p}/attn/v/out'],
               attrs={'fused_activation': 'NONE'})

    q4 = b.op('RESHAPE', [q], [(B, T, NQ, H)],
              output_names=[f'{p}/attn/q_4d'],
              attrs={'new_shape': [B, T, NQ, H]})
    k4 = b.op('RESHAPE', [k], [(B, T, NK, H)],
              output_names=[f'{p}/attn/k_4d'],
              attrs={'new_shape': [B, T, NK, H]})
    qr = b.op('ROPE', [q4, positions], [(B, T, NQ, H)],
              output_names=[f'{p}/attn/q_rope'],
              attrs={'rope_base': cfg.rope_base})
    kr = b.op('ROPE', [k4, positions], [(B, T, NK, H)],
              output_names=[f'{p}/attn/k_rope'],
              attrs={'rope_base': cfg.rope_base})

    # [B,T,NQ,H] -> [B,NQ,T,H] -> grouped [B,NK,G*T,H]
    qt = b.op('TRANSPOSE', [qr], [(B, NQ, T, H)],
              output_names=[f'{p}/attn/q_t'], attrs={'perm': [0, 2, 1, 3]})
    qg = b.op('RESHAPE', [qt], [(B, NK, G * T, H)],
              output_names=[f'{p}/attn/q_grouped'],
              attrs={'new_shape': [B, NK, G * T, H]})
    kt = b.op('TRANSPOSE', [kr], [(B, NK, T, H)],
              output_names=[f'{p}/attn/k_t'], attrs={'perm': [0, 2, 1, 3]})
    v4 = b.op('RESHAPE', [v], [(B, T, NK, H)],
              output_names=[f'{p}/attn/v_4d'],
              attrs={'new_shape': [B, T, NK, H]})
    vt = b.op('TRANSPOSE', [v4], [(B, NK, T, H)],
              output_names=[f'{p}/attn/v_t'], attrs={'perm': [0, 2, 1, 3]})

    if kv_int4_group:
      ng3 = 3 * (H // kv_int4_group)
      if cache_update == 'dus':
        # Shared write position (static decode bench).
        opcode, pos_in = 'INT4G_ATTENTION', cache_pos
      else:
        # Continuous batching: every slot writes its own row; the op
        # scatters per-row from `positions` and masks per-row lengths.
        opcode, pos_in = 'INT4G_ATTENTION_SCATTER', positions
      attn_outs = b.op(
          opcode,
          [qg, kt, vt, k_cache, v_cache, kv_sidecar, pos_in],
          [(B, NK, G * T, H), (B, NK, S, H // 2), (B, NK, S, H // 2),
           (B, NK, ng3, S)],
          output_names=[f'{p}/attn/ctx', f'{p}/k_cache_new',
                        f'{p}/v_cache_new', f'{p}/kv_sidecar_new'],
          attrs={'group': kv_int4_group},
          output_dtypes=['float32', 'uint8', 'uint8', 'bfloat16'])
      ctx, k_new, v_new, sidecar_new = attn_outs
      kv_outs.append((f'layer_{li}_k_cache', k_new))
      kv_outs.append((f'layer_{li}_v_cache', v_new))
      kv_outs.append((f'layer_{li}_s_cache', sidecar_new))
    elif cache_update == 'dus':
      k_new = b.op('DYNAMIC_UPDATE_SLICE', [k_cache, kt, cache_pos],
                   [(B, NK, S, H)], output_names=[f'{p}/k_cache_new'])
      v_new = b.op('DYNAMIC_UPDATE_SLICE', [v_cache, vt, cache_pos],
                   [(B, NK, S, H)], output_names=[f'{p}/v_cache_new'])
    else:
      # Per-row one-hot blend: cache*(1-m) + new*m. Decode only (T == 1).
      if T != 1:
        raise ValueError('onehot cache update supports decode (T=1) only.')
      inv = b.op('SUB', [one_const, cache_onehot], [(B, 1, S, 1)],
                 output_names=[f'{p}/cache_keep_mask'])
      k_keep = b.op('MUL', [k_cache, inv], [(B, NK, S, H)],
                    output_names=[f'{p}/k_keep'])
      k_put = b.op('MUL', [kt, cache_onehot], [(B, NK, S, H)],
                   output_names=[f'{p}/k_put'])
      k_new = b.op('ADD', [k_keep, k_put], [(B, NK, S, H)],
                   output_names=[f'{p}/k_cache_new'])
      v_keep = b.op('MUL', [v_cache, inv], [(B, NK, S, H)],
                    output_names=[f'{p}/v_keep'])
      v_put = b.op('MUL', [vt, cache_onehot], [(B, NK, S, H)],
                   output_names=[f'{p}/v_put'])
      v_new = b.op('ADD', [v_keep, v_put], [(B, NK, S, H)],
                   output_names=[f'{p}/v_cache_new'])
    if not kv_int4_group:
      kv_outs.append((f'layer_{li}_k_cache', k_new))
      kv_outs.append((f'layer_{li}_v_cache', v_new))

      scores = b.op('BATCH_MATMUL', [qg, k_new], [(B, NK, G * T, S)],
                    output_names=[f'{p}/attn/scores'],
                    attrs={'adj_y': True})
      ssc = b.constant(f'{p}/attn/score_scale',
                       np.array([1.0 / math.sqrt(H)], np.float32))
      scaled = b.op('MUL', [scores, ssc], [(B, NK, G * T, S)],
                    output_names=[f'{p}/attn/scores_scaled'])
      masked = b.op('ADD', [scaled, mask], [(B, NK, G * T, S)],
                    output_names=[f'{p}/attn/scores_masked'])
      probs = b.op('SOFTMAX', [masked], [(B, NK, G * T, S)],
                   output_names=[f'{p}/attn/probs'])
      ctx = b.op('BATCH_MATMUL', [probs, v_new], [(B, NK, G * T, H)],
                 output_names=[f'{p}/attn/ctx'], attrs={'adj_y': False})
    ctx4 = b.op('RESHAPE', [ctx], [(B, NQ, T, H)],
                output_names=[f'{p}/attn/ctx_4d'],
                attrs={'new_shape': [B, NQ, T, H]})
    ctx_t = b.op('TRANSPOSE', [ctx4], [(B, T, NQ, H)],
                 output_names=[f'{p}/attn/ctx_t'],
                 attrs={'perm': [0, 2, 1, 3]})
    ctx2 = b.op('RESHAPE', [ctx_t], [(B, T, NQ * H)],
                output_names=[f'{p}/attn/ctx_2d'],
                attrs={'new_shape': [B, T, NQ * H]})
    wo = store.tensor(b, f'{p}/attn/o/w', (D, NQ * H), 0.02)
    attn_out = b.op('FULLY_CONNECTED', [ctx2, wo, -1], [(B, T, D)],
                    output_names=[f'{p}/attn/o/out'],
                    attrs={'fused_activation': 'NONE'})
    x = b.op('ADD', [x, attn_out], [(B, T, D)],
             output_names=[f'{p}/attn_residual'])

    # -- ffn block (GeGLU / MoE) --
    gamma2 = store.tensor(b, f'{p}/pre_ffn_norm/gamma', (D,), 0.1)
    fn = b.op('RMS_NORM', [x, gamma2], [(B, T, D)],
              output_names=[f'{p}/pre_ffn_norm/out'],
              attrs={'epsilon': cfg.norm_eps})
    if cfg.num_experts > 0:
      # Top-k routed expert bank. Routing is stock ops (FC -> k-th-max
      # threshold -> GREATER_EQUAL mask -> SELECT_V2 -> SOFTMAX), gating
      # semantics identical to parallel/moe.topk_gates (ties included by
      # >= threshold). Expert FFNs are plain FCs — the quantizer treats
      # them exactly like dense weights; the executor's EP fusion
      # (AEQT moe fusion) stacks them and dispatches parallel/moe.
      E, K = cfg.num_experts, cfg.moe_top_k
      mp = f'{p}/moe'
      w_router = store.tensor(b, f'{mp}/router/w', (E, D), 0.05)
      logits = b.op('FULLY_CONNECTED', [fn, w_router, -1], [(B, T, E)],
                    output_names=[f'{mp}/router/out'],
                    attrs={'fused_activation': 'NONE',
                           'moe_group': mp, 'moe_role': 'router'})
      neg1 = b.constant(f'{mp}/neg1', np.full((1,), -1.0, np.float32))
      ninf = b.constant(f'{mp}/ninf', np.full((1,), -1e30, np.float32))
      cur = logits
      thresh = None
      for ki in range(K):
        negv = b.op('MUL', [cur, neg1], [(B, T, E)],
                    output_names=[f'{mp}/neg_{ki}'],
                    attrs={'moe_group': mp})
        nmin = b.op('REDUCE_MIN', [negv], [(B, T, 1)],
                    output_names=[f'{mp}/negmin_{ki}'],
                    attrs={'axis': [2], 'keep_dims': True,
                           'moe_group': mp})
        thresh = b.op('MUL', [nmin, neg1], [(B, T, 1)],
                      output_names=[f'{mp}/kmax_{ki}'],
                      attrs={'moe_group': mp})
        if ki < K - 1:
          is_max = b.op('GREATER_EQUAL', [cur, thresh], [(B, T, E)],
                        output_names=[f'{mp}/ismax_{ki}'],
                        output_dtypes=['bool'],
                        attrs={'moe_group': mp})
          cur = b.op('SELECT_V2', [is_max, ninf, cur], [(B, T, E)],
                     output_names=[f'{mp}/masked_{ki}'],
                     attrs={'moe_group': mp})
      keep = b.op('GREATER_EQUAL', [logits, thresh], [(B, T, E)],
                  output_names=[f'{mp}/topk_mask'],
                  output_dtypes=['bool'],
                  attrs={'moe_group': mp})
      gated = b.op('SELECT_V2', [keep, logits, ninf], [(B, T, E)],
                   output_names=[f'{mp}/gated_logits'],
                   attrs={'moe_group': mp})
      gates = b.op('SOFTMAX', [gated], [(B, T, E)],
                   output_names=[f'{mp}/gates'],
                   attrs={'moe_group': mp, 'moe_role': 'gates',
                          'moe_top_k': K})
      moe_out = None
      for e in range(E):
        ep = f'{mp}/expert_{e}'
        wg_e = store.tensor(b, f'{ep}/gate/w', (F, D), 0.02)
        wu_e = store.tensor(b, f'{ep}/up/w', (F, D), 0.02)
        wd_e = store.tensor(b, f'{ep}/down/w', (D, F), 0.02)
        g_e = b.op('FULLY_CONNECTED', [fn, wg_e, -1], [(B, T, F)],
                   output_names=[f'{ep}/gate/out'],
                   attrs={'fused_activation': 'NONE', 'moe_group': mp,
                          'moe_role': f'expert_gate_{e}'})
        u_e = b.op('FULLY_CONNECTED', [fn, wu_e, -1], [(B, T, F)],
                   output_names=[f'{ep}/up/out'],
                   attrs={'fused_activation': 'NONE', 'moe_group': mp,
                          'moe_role': f'expert_up_{e}'})
        ga_e = b.op('GELU', [g_e], [(B, T, F)],
                    output_names=[f'{ep}/gelu'], attrs={'moe_group': mp})
        h_e = b.op('MUL', [ga_e, u_e], [(B, T, F)],
                   output_names=[f'{ep}/prod'], attrs={'moe_group': mp})
        d_e = b.op('FULLY_CONNECTED', [h_e, wd_e, -1], [(B, T, D)],
                   output_names=[f'{ep}/down/out'],
                   attrs={'fused_activation': 'NONE', 'moe_group': mp,
                          'moe_role': f'expert_down_{e}'})
        gate_col = b.op('SLICE', [gates], [(B, T, 1)],
                        output_names=[f'{ep}/gate_col'],
                        attrs={'begin': [0, 0, e], 'moe_group': mp})
        contrib = b.op('MUL', [d_e, gate_col], [(B, T, D)],
                       output_names=[f'{ep}/contrib'],
                       attrs={'moe_group': mp})
        if moe_out is None:
          moe_out = contrib
        else:
          moe_out = b.op('ADD', [moe_out, contrib], [(B, T, D)],
                         output_names=[f'{mp}/sum_{e}'],
                         attrs={'moe_group': mp,
                                'moe_role': ('combine'
                                             if e == E - 1 else None)})
      x = b.op('ADD', [x, moe_out], [(B, T, D)],
               output_names=[f'{p}/ffn_residual'])
      continue
    wd = store.tensor(b, f'{p}/ffw/down/w', (D, F), 0.02)
    if fused_projections:
      wgu = store.tensor(b, f'{p}/ffw/gate_up/w', (2 * F, D), 0.02)
      gu = b.op('FULLY_CONNECTED', [fn, wgu, -1], [(B, T, 2 * F)],
                output_names=[f'{p}/ffw/gate_up/out'],
                attrs={'fused_activation': 'NONE'})
      gate = b.op('SLICE', [gu], [(B, T, F)],
                  output_names=[f'{p}/ffw/gate/out'],
                  attrs={'begin': [0, 0, 0]})
      up = b.op('SLICE', [gu], [(B, T, F)],
                output_names=[f'{p}/ffw/up/out'],
                attrs={'begin': [0, 0, F]})
    else:
      wg = store.tensor(b, f'{p}/ffw/gate/w', (F, D), 0.02)
      wu = store.tensor(b, f'{p}/ffw/up/w', (F, D), 0.02)
      gate = b.op('FULLY_CONNECTED', [fn, wg, -1], [(B, T, F)],
                  output_names=[f'{p}/ffw/gate/out'],
                  attrs={'fused_activation': 'NONE'})
      up = b.op('FULLY_CONNECTED', [fn, wu, -1], [(B, T, F)],
                output_names=[f'{p}/ffw/up/out'],
                attrs={'fused_activation': 'NONE'})
    gact = b.op('GELU', [gate], [(B, T, F)],
                output_names=[f'{p}/ffw/gelu'])
    prod = b.op('MUL', [gact, up], [(B, T, F)],
                output_names=[f'{p}/ffw/prod'])
    down = b.op('FULLY_CONNECTED', [prod, wd, -1], [(B, T, D)],
                output_names=[f'{p}/ffw/down/out'],
                attrs={'fused_activation': 'NONE'})
    x = b.op('ADD', [x, down], [(B, T, D)],
             output_names=[f'{p}/ffn_residual'])

  gamma_f = store.tensor(b, f'{sig}/final_norm/gamma', (D,), 0.1)
  xf = b.op('RMS_NORM', [x, gamma_f], [(B, T, D)],
            output_names=[f'{sig}/final_norm/out'],
            attrs={'epsilon': cfg.norm_eps})
  head_t = T
  if head_cols and T > 1:
    # Gather each row's single head position in-graph (one-hot blend over
    # T): the [B, T, V] head collapses to [B, 1, V].
    hc = b.input(f'{sig}/head_cols', (B, 1), 'int32')
    hc_shape = b.constant(f'{sig}/head_cols_shape',
                          np.asarray([B, 1, 1], np.int32))
    hc3 = b.op('RESHAPE', [hc, hc_shape], [(B, 1, 1)],
               output_names=[f'{sig}/head_cols3'])
    iota_t = b.constant(f'{sig}/head_iota',
                        np.arange(T, dtype=np.int32).reshape(1, T, 1))
    hit = b.op('EQUAL', [iota_t, hc3], [(B, T, 1)],
               output_names=[f'{sig}/head_hit'], output_dtypes=['bool'])
    hit_f = b.activation(f'{sig}/head_hit_f', (B, T, 1))
    b.subgraph.ops.append(ir.Op(opcode='CAST', inputs=[hit],
                                outputs=[hit_f]))
    picked = b.op('MUL', [xf, hit_f], [(B, T, D)],
                  output_names=[f'{sig}/head_picked'])
    axes = b.constant(f'{sig}/head_sum_axes', np.asarray([1], np.int32))
    xf = b.op('SUM', [picked, axes], [(B, 1, D)],
              output_names=[f'{sig}/head_row'],
              attrs={'keep_dims': True})
    head_t = 1
  if cfg.tie_embedding:
    # Tied logits head: the FC consumes the embedding table's buffer — the
    # classic shared-buffer case the planner must reconcile or duplicate.
    buf_id, shape = store._buffers['embedder/w']
    logits_w = b.shared_constant(f'{sig}/logits/w', buf_id, shape, 'float32')
  else:
    logits_w = store.tensor(b, f'{sig}/logits/w', (cfg.vocab_size, D),
                            1.0 / math.sqrt(D))
  logits = b.op('FULLY_CONNECTED', [xf, logits_w, -1],
                [(B, head_t, cfg.vocab_size)],
                output_names=[f'{sig}/logits'],
                attrs={'fused_activation': 'NONE'})
  if greedy_head:
    # Greedy sampling IN-GRAPH: the executor fuses FC -> ARG_MAX into one
    # vocab-tiled kernel, so the [B, T, vocab] logits never reach HBM.
    # (The logits tensor is intentionally NOT a signature output — an
    # escaping logits output would block the fusion.)
    tokens_out = b.op('ARG_MAX', [logits], [(B, head_t)],
                      output_names=[f'{sig}/next_tokens'],
                      attrs={'axis': -1}, output_dtypes=['int32'])
    b.output(tokens_out, user_name='next_tokens')
  else:
    b.output(logits, user_name='logits')
  for name, tid in kv_outs:
    b.output(tid, user_name=name)


def build_decoder(
    cfg: DecoderConfig = TOY_DECODER,
    batch: int = 1,
    prefill_len: int = 16,
    seed: int = 0,
    signatures=('prefill', 'decode'),
    materialize_weights: bool = True,
    decode_cache_update: str = 'dus',
    fused_projections: bool = False,
    decode_device_masks: bool = False,
    greedy_head: bool = False,
    kv_int4_group: int = 0,
) -> ir.Graph:
  """Multi-signature decoder graph over one shared weight store."""
  graph = ir.Graph()
  store = _WeightStore(cfg, seed=seed, materialize=materialize_weights)
  for sig in signatures:
    b = builder_lib.GraphBuilder(sig, graph=graph)
    seq = prefill_len if sig == 'prefill' else 1
    _build_signature(b, store, sig, batch, seq,
                     cache_update=(decode_cache_update if sig == 'decode'
                                   else 'dus'),
                     fused_projections=fused_projections,
                     device_masks=(decode_device_masks and sig == 'decode'),
                     greedy_head=(greedy_head and sig == 'decode'),
                     kv_int4_group=(kv_int4_group if sig == 'decode'
                                    else 0))
    b.finalize(signature_key=sig)
  graph.metadata['weight_init_specs'] = store.init_specs
  if decode_device_masks:
    graph.metadata['decode_device_masks'] = True
  return graph


def build_serving_decoder(
    cfg: DecoderConfig,
    batch_slots: int,
    prefill_len: int = 16,
    seed: int = 0,
    materialize_weights: bool = True,
    device_masks: bool = False,
    cache_buckets=None,
    fused_projections: bool = False,
    greedy_head: bool = False,
    prefill_batch: int = 1,
    prefill_device_masks: bool = False,
    prefill_greedy: bool = False,
    prefill_head_cols: bool = False,
    kv_int4_group: int = 0,
    prefill_tail_len: int = 0,
) -> ir.Graph:
  """Serving-shaped graph: prefill at batch=prefill_batch (admission) +
  decode at batch=batch_slots with per-slot one-hot cache updates, one
  shared weight store (a copy of the JAX package's builder).

  cache_buckets: optional ascending context-length buckets (e.g.
  (128, 256, 1024)); one decode signature is built PER bucket, with KV
  caches sized to that bucket, and the server runs the smallest program
  covering the longest active sequence. Buckets must not exceed
  cfg.max_seq_len; the last bucket is forced to cfg.max_seq_len.

  greedy_head: decode signatures emit `next_tokens` in-graph (FC +
  ARG_MAX fuse into the head kernel) instead of `logits`.
  prefill_batch: batch dimension of the prefill signature (admission
  prefills up to prefill_batch queued requests in one pass).
  prefill_device_masks: derive the prefill causal mask in-graph from
  `positions`. prefill_greedy: prefill also emits `next_tokens`.
  prefill_head_cols: the prefill head runs on one gathered row per batch
  element. prefill_tail_len: a short 'prefill_tail' program for a
  prompt's final partial chunk. kv_int4_group: int4-group KV decode
  pools (INT4G_ATTENTION_SCATTER; the prefill caches stay float).
  """
  graph = ir.Graph()
  store = _WeightStore(cfg, seed=seed, materialize=materialize_weights)
  b = builder_lib.GraphBuilder('prefill', graph=graph)
  _build_signature(b, store, 'prefill', prefill_batch, prefill_len,
                   cache_update='dus',
                   fused_projections=fused_projections,
                   device_masks=prefill_device_masks,
                   greedy_head=prefill_greedy,
                   head_cols=prefill_head_cols)
  b.finalize(signature_key='prefill')
  if prefill_tail_len:
    if prefill_tail_len >= prefill_len:
      raise ValueError('prefill_tail_len must be < prefill_len')
    b = builder_lib.GraphBuilder('prefill_tail', graph=graph)
    _build_signature(b, store, 'prefill_tail', prefill_batch,
                     prefill_tail_len, cache_update='dus',
                     fused_projections=fused_projections,
                     device_masks=prefill_device_masks,
                     greedy_head=prefill_greedy,
                     head_cols=prefill_head_cols)
    b.finalize(signature_key='prefill_tail')
    graph.metadata['prefill_tail_len'] = int(prefill_tail_len)
  if cache_buckets:
    buckets = sorted({min(int(s), cfg.max_seq_len) for s in cache_buckets}
                     | {cfg.max_seq_len})
    if buckets[0] < prefill_len:
      raise ValueError(
          f'smallest cache bucket {buckets[0]} < prefill_len {prefill_len}')
    for s in buckets:
      cfg_s = dataclasses.replace(cfg, max_seq_len=s)
      store.cfg = cfg_s
      b = builder_lib.GraphBuilder(f'decode_{s}', graph=graph)
      _build_signature(b, store, f'decode_{s}', batch_slots, 1,
                       cache_update='onehot', device_masks=device_masks,
                       fused_projections=fused_projections,
                       greedy_head=greedy_head,
                       kv_int4_group=kv_int4_group)
      b.finalize(signature_key=f'decode_{s}')
    store.cfg = cfg
    graph.metadata['decode_buckets'] = buckets
  else:
    b = builder_lib.GraphBuilder('decode', graph=graph)
    _build_signature(b, store, 'decode', batch_slots, 1,
                     cache_update='onehot', device_masks=device_masks,
                     fused_projections=fused_projections,
                     greedy_head=greedy_head,
                     kv_int4_group=kv_int4_group)
    b.finalize(signature_key='decode')
  graph.metadata['weight_init_specs'] = store.init_specs
  if device_masks:
    graph.metadata['decode_device_masks'] = True
  if prefill_device_masks:
    graph.metadata['prefill_device_masks'] = True
  if prefill_head_cols:
    graph.metadata['prefill_head_cols'] = True
  if kv_int4_group:
    graph.metadata['kv_int4_group'] = int(kv_int4_group)
  return graph


def stamp_int8_kv_cache(graph: ir.Graph, cache_scale: float = 0.06) -> None:
  """Mark all KV-cache tensors int8 with one shared per-tensor scale.

  The serving-side shortcut for benchmark/deployment graphs built in
  process: cache inputs, the K/V update tensors, and cache outputs get the
  same symmetric int8 params, so the executor's int8 DUS fast path and the
  fused attention kernel engage (no calibration pass needed; for real
  models use the calibrated int8-cache recipe flow instead).
  """
  scale = np.array([cache_scale], np.float32)
  for sg in graph.subgraphs:
    for t in sg.tensors:
      name = t.name
      if (
          name.endswith('/k_cache') or name.endswith('/v_cache')
          or name.endswith('k_cache_new') or name.endswith('v_cache_new')
          or name.endswith('attn/k_t') or name.endswith('attn/v_t')
      ):
        t.quantization = ir.QuantizationInfo(
            scale=np.array(scale), zero_point=np.array([0], np.int8),
            quantized_dimension=None, num_bits=8)
        t.dtype = 'int8'


def _plan_weights(graph: ir.Graph, fc_bits: int, embedding_bits: int):
  """One entry per unique buffer: buffer id -> (key, shape, init_scale,
  bits or None), and buffer id -> [(sg_idx, tid)] of its users."""
  specs = graph.metadata.get('weight_init_specs', {})
  plan: dict = {}
  buffer_users: dict = {}
  for sg_idx, sg in enumerate(graph.subgraphs):
    fc_weight_tids = {op.inputs[1] for op in sg.ops
                      if op.opcode == 'FULLY_CONNECTED'
                      and len(op.inputs) > 1 and op.inputs[1] >= 0}
    emb_weight_tids = {op.inputs[1] for op in sg.ops
                       if op.opcode == 'EMBEDDING_LOOKUP'
                       and len(op.inputs) > 1 and op.inputs[1] >= 0}
    for tid, t in enumerate(sg.tensors):
      if t.buffer < 0:
        continue
      buffer_users.setdefault(t.buffer, []).append((sg_idx, tid))
      key = t.name.split('/', 1)[1] if '/' in t.name else t.name
      shape, init_scale = specs.get(key, (t.shape, 0.02))
      bits = None
      if tid in fc_weight_tids:
        bits = fc_bits
      elif tid in emb_weight_tids:
        bits = embedding_bits
      prev = plan.get(t.buffer)
      if prev is None or (prev[3] is None and bits is not None):
        plan[t.buffer] = (key, tuple(shape), float(init_scale), bits)
  return plan, buffer_users


def _stamp(graph: ir.Graph, sg_idx: int, tid: int, scale: np.ndarray,
           bits: int) -> None:
  """Per-channel symmetric quantization stamp on one weight tensor."""
  t = graph.subgraphs[sg_idx].tensors[tid]
  scale32 = np.asarray(scale, np.float32)
  t.quantization = ir.QuantizationInfo(
      scale=scale32, zero_point=np.zeros_like(scale32, np.int8),
      quantized_dimension=0 if scale32.size > 1 else None, num_bits=bits)
  t.dtype = ir.dtype_for_bits(bits)


def device_materialize_quantized(
    graph: ir.Graph,
    fc_bits: int = 4,
    embedding_bits: int = 8,
    seed: int = 0,
    device='cuda',
):
  """Generate + quantize the decoder's weights on `device`.

  For a graph built with materialize_weights=False: every FC/embedding
  weight is drawn from a cheap deterministic generator, per-channel
  symmetric-quantized on the device, and stamped into the IR (int storage
  dtype + QuantizationInfo). Returns the executor weight dict
  {(sg_idx, tensor_id): tensor}. The host never holds the fp32 weights.

  The generator is the JAX package's `_fast_init` (a sin hash of the
  element index); its per-weight phase hashes the weight's name with
  zlib.crc32, so a run repeats from process to process. The weights are
  not the JAX package's (the JAX package hashes with `hash`): parity
  tests hand this function's weights to both sides.

  Graph constants (buffers that hold data and are no weight of the
  store: the embedding and score scales, the device masks' iotas and
  constants) keep their values, as the executor loads them. The JAX
  package's materializer draws them as weights too (see ROADMAP.md,
  Queue 3).
  """
  device = torch.device(device)
  plan, buffer_users = _plan_weights(graph, fc_bits, embedding_bits)
  specs = graph.metadata.get('weight_init_specs', {})
  constants: dict = {}
  for buf_id in list(plan):
    data = graph.buffers[buf_id].data
    if data is not None and plan[buf_id][0] not in specs:
      del plan[buf_id]
      for sg_idx, tid in buffer_users[buf_id]:
        t = graph.subgraphs[sg_idx].tensors[tid]
        dtype = quant_arith.storage_dtype_of(t)
        constants[(sg_idx, tid)] = torch.as_tensor(
            np.asarray(data).reshape(t.shape), device=device).to(
                torch.int32 if dtype == torch.int64 else dtype)

  def fast_init(key: str, shape, init_scale: float) -> torch.Tensor:
    n = 1
    for d in shape:
      n *= d
    phase = float((seed * 1_000_003 + zlib.crc32(key.encode())) % 65521) + 0.5
    idx = torch.arange(n, dtype=torch.float32, device=device).reshape(shape)
    u = torch.sin((idx + phase) * 12.9898) * 43758.5453
    u = u - torch.floor(u)  # ~U[0,1)
    return (u * 2.0 - 1.0) * (init_scale * 1.732)

  generated: dict = {}
  for buf_id, (key, shape, init_scale, bits) in plan.items():
    w = fast_init(key, shape, init_scale)
    if bits is None:
      generated[buf_id] = (w, None)
      continue
    qmax = float(2 ** (bits - 1) - 1)
    qmax_t = torch.full((), qmax, dtype=torch.float32, device=device)
    absmax = torch.clamp_min(torch.amax(torch.abs(w), dim=1), 1e-9)
    scale = absmax / qmax_t
    w_q = torch.clamp(torch.round(w / scale[:, None]), -qmax, qmax).to(
        torch.int8)
    del w
    generated[buf_id] = (w_q, scale)
  # One host transfer for all scales together (set-up, not the step).
  scale_bufs = [b for b, (_, s) in generated.items() if s is not None]
  scales_np = {}
  if scale_bufs:
    flat = torch.cat([generated[b][1] for b in scale_bufs]).cpu().numpy()
    offset = 0
    for b in scale_bufs:
      n = generated[b][1].numel()
      scales_np[b] = flat[offset:offset + n]
      offset += n

  weights: dict = dict(constants)
  for buf_id, (arr, _) in generated.items():
    bits = plan[buf_id][3]
    for (sg_idx, tid) in buffer_users[buf_id]:
      if buf_id in scales_np:
        _stamp(graph, sg_idx, tid, scales_np[buf_id], bits)
      weights[(sg_idx, tid)] = arr
  return weights


def make_inputs(cfg: DecoderConfig, sig: str, batch: int, seq_len: int,
                start_pos: int = 0, seed: int = 0, device='cuda') -> dict:
  """Random-but-valid inputs (+ zero caches) for one signature call.

  The same values as the JAX package's make_inputs (numpy, from `seed`),
  as torch tensors on `device`; the caches are float32 zeros made there.
  """
  rng = np.random.default_rng(seed)
  B, T, S = batch, seq_len, cfg.max_seq_len
  G = cfg.num_query_heads // cfg.num_kv_heads
  mask = np.full((B, 1, G * T, S), -1e9, np.float32)
  for t in range(T):
    limit = start_pos + t + 1
    for g in range(G):
      mask[:, :, g * T + t, :limit] = 0.0
  host = {
      'tokens': rng.integers(0, cfg.vocab_size, size=(B, T)).astype(
          np.int32),
      'positions': (np.arange(T, dtype=np.int32)[None, :] + start_pos
                    ).repeat(B, 0),
      'mask': mask,
      'cache_pos': np.array([0, 0, start_pos, 0], np.int32),
  }
  inputs = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
  for li in range(cfg.num_layers):
    for kind in ('k', 'v'):
      inputs[f'layer_{li}_{kind}_cache_in'] = torch.zeros(
          (B, cfg.num_kv_heads, S, cfg.head_dim), dtype=torch.float32,
          device=device)
  return inputs


def zero_caches(graph: ir.Graph, signature: str = 'decode',
                device='cuda') -> dict:
  """Zero cache pools for a signature's `*_cache_in` inputs, made on the
  device in each tensor's storage dtype (int8 once the caches are stamped),
  as bench.py allocates them: no host copy of the pools."""
  sig = graph.signature_by_key(signature)
  tensors = graph.subgraphs[sig.subgraph_index].tensors
  return {name: torch.zeros(tuple(tensors[tid].shape),
                            dtype=quant_arith.storage_dtype_of(tensors[tid]),
                            device=device)
          for name, tid in sig.inputs.items() if name.endswith('_cache_in')}


def weights_from_numpy(graph: ir.Graph, weights_np: dict,
                       stamps: Optional[dict] = None,
                       device='cuda') -> dict:
  """Carry a JAX executor's weights across to the port.

  weights_np: {(sg_idx, tid): numpy array} (the JAX weight dict after
  np.asarray), for the same graph structure as `graph` (the port's
  build_decoder makes the same tensor ids). stamps: {(sg_idx, tid):
  (scale, num_bits)} of the quantized weights, stamped onto `graph` as
  device_materialize_quantized stamps them. Returns the port's weight
  dict {(sg_idx, tid): tensor on device}.
  """
  for (sg_idx, tid), (scale, bits) in (stamps or {}).items():
    _stamp(graph, sg_idx, tid, scale, bits)
  weights: dict = {}
  shared: dict = {}  # arrays shared by several views copy once
  for key, arr in weights_np.items():
    arr = np.asarray(arr)
    if id(arr) not in shared:
      shared[id(arr)] = torch.tensor(arr, device=device)
    weights[key] = shared[id(arr)]
  return weights


def save_materialized(graph: ir.Graph, weights: dict, path: str) -> None:
  """Persist materialized weights + quantization stamps (the JAX
  package's npz format)."""
  payload = {}
  for (sg_idx, tid), arr in weights.items():
    payload[f'w__{sg_idx}__{tid}'] = arr.detach().cpu().numpy()
    t = graph.subgraphs[sg_idx].tensors[tid]
    if t.quantization is not None:
      payload[f's__{sg_idx}__{tid}'] = np.asarray(t.quantization.scale)
      payload[f'b__{sg_idx}__{tid}'] = np.asarray(
          [t.quantization.num_bits], np.int32)
  # Atomic write: a killed process must never leave a truncated file.
  tmp = path + '.tmp.npz'
  np.savez(tmp, **payload)
  os.replace(tmp, path)


def load_materialized(graph: ir.Graph, path: str, device='cuda') -> dict:
  """Restore weights + re-stamp tensor quantization from a saved npz
  (written by this module or by the JAX package's save_materialized)."""
  weights_np: dict = {}
  stamps: dict = {}
  with np.load(path) as data:
    for name in data.files:
      if not name.startswith('w__'):
        continue
      _, sg_idx, tid = name.split('__')
      key = (int(sg_idx), int(tid))
      weights_np[key] = data[name]
      skey = f's__{sg_idx}__{tid}'
      if skey in data.files:
        stamps[key] = (np.asarray(data[skey], np.float32),
                       int(data[f'b__{sg_idx}__{tid}'][0]))
  return weights_from_numpy(graph, weights_np, stamps, device=device)
