"""BERT/ViT-class bidirectional transformer encoder as Graph IR.

Third model family next to the Gemma decoder (`models/gemma.py`) and
MobileNetV2 (`models/mobilenet.py`): a fixed-length encoder — token +
learned-position embeddings, N pre-norm blocks of bidirectional multi-head
attention and a GELU MLP, a CLS pooler (tanh FC) and a softmax classifier
head. RMS_NORM is used for the norms (the quantizer's native norm op; same
role as the reference's odml.rms_norm composite).

The op mix (EMBEDDING_LOOKUP, GATHER, FC, BATCH_MATMUL, SOFTMAX, MUL/ADD,
GELU, SLICE, RESHAPE, TRANSPOSE, TANH) exercises the SRQ pipeline on a
non-causal, cache-free transformer: fixed-scale softmax both inside
attention and at the classifier output, SAME_AS_INPUT propagation through
the reshape/transpose shuffles, and fused-bias quantization in every
projection. Weights are random-initialized; the point is architecture
coverage, not pretrained accuracy.

A copy of `ai_edge_quantizer_tpu/models/encoder.py`: the graph is numpy
(the port's IR, as `models/gemma.py` builds it), drawn from one seed by
`np.random.default_rng` in the same order, so `build_encoder(cfg, batch,
seed)` gives the JAX package's weights bit for bit and `make_inputs` its
inputs; the tests check that rather than carry the arrays across.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ai_edge_quantizer_tpu_torch.graph import builder as builder_lib
from ai_edge_quantizer_tpu_torch.graph import ir


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
  """Encoder hyperparameters (defaults: a BERT-tiny-class model)."""

  vocab_size: int = 8192
  seq_len: int = 128
  embed_dim: int = 256
  num_layers: int = 4
  num_heads: int = 4
  ffn_dim: int = 1024
  num_classes: int = 16
  norm_eps: float = 1e-6

  @property
  def head_dim(self) -> int:
    assert self.embed_dim % self.num_heads == 0
    return self.embed_dim // self.num_heads


# A larger, serving-shaped config (BERT-base-class widths).
BERT_BASE_LITE = EncoderConfig(
    vocab_size=30528, seq_len=512, embed_dim=768, num_layers=4,
    num_heads=12, ffn_dim=3072, num_classes=2)


def build_encoder(
    cfg: EncoderConfig = EncoderConfig(),
    batch: int = 1,
    seed: int = 0,
) -> ir.Graph:
  """Builds the encoder graph with one `serving_default` signature.

  Inputs: tokens [B, T] int32, positions [B, T] int32.
  Outputs: `probs` [B, num_classes] (softmax) and `pooled` [B, D].
  """
  rng = np.random.default_rng(seed)
  b = builder_lib.GraphBuilder('main')
  B, T, D = batch, cfg.seq_len, cfg.embed_dim
  N, H, F = cfg.num_heads, cfg.head_dim, cfg.ffn_dim

  def _w(name, shape, scale):
    data = rng.standard_normal(size=shape, dtype=np.float32)
    data *= scale
    return b.constant(name, data)

  tokens = b.input('tokens', (B, T), 'int32')
  positions = b.input('positions', (B, T), 'int32')

  embed_w = _w('embedder/w', (cfg.vocab_size, D), 1.0 / math.sqrt(D))
  tok_e = b.op('EMBEDDING_LOOKUP', [tokens, embed_w], [(B, T, D)],
               output_names=['embedder/out'])
  pos_table = _w('pos_embedder/w', (cfg.seq_len, D), 0.02)
  pos_e = b.op('GATHER', [pos_table, positions], [(B, T, D)],
               output_names=['pos_embedder/out'], attrs={'axis': 0})
  x = b.op('ADD', [tok_e, pos_e], [(B, T, D)], output_names=['embed_sum'])

  for li in range(cfg.num_layers):
    p = f'layer_{li}'
    # -- attention block (pre-norm, bidirectional: no mask) --
    g1 = _w(f'{p}/pre_attn_norm/gamma', (D,), 0.1)
    xn = b.op('RMS_NORM', [x, g1], [(B, T, D)],
              output_names=[f'{p}/pre_attn_norm/out'],
              attrs={'epsilon': cfg.norm_eps})
    qkv = {}
    for proj in ('q', 'k', 'v'):
      w = _w(f'{p}/attn/{proj}/w', (N * H, D), 0.02)
      bias = _w(f'{p}/attn/{proj}/b', (N * H,), 0.01)
      out = b.op('FULLY_CONNECTED', [xn, w, bias], [(B, T, N * H)],
                 output_names=[f'{p}/attn/{proj}/out'],
                 attrs={'fused_activation': 'NONE'})
      r4 = b.op('RESHAPE', [out], [(B, T, N, H)],
                output_names=[f'{p}/attn/{proj}_4d'],
                attrs={'new_shape': [B, T, N, H]})
      qkv[proj] = b.op('TRANSPOSE', [r4], [(B, N, T, H)],
                       output_names=[f'{p}/attn/{proj}_t'],
                       attrs={'perm': [0, 2, 1, 3]})
    scores = b.op('BATCH_MATMUL', [qkv['q'], qkv['k']], [(B, N, T, T)],
                  output_names=[f'{p}/attn/scores'], attrs={'adj_y': True})
    ssc = b.constant(f'{p}/attn/score_scale',
                     np.array([1.0 / math.sqrt(H)], np.float32))
    scaled = b.op('MUL', [scores, ssc], [(B, N, T, T)],
                  output_names=[f'{p}/attn/scores_scaled'])
    probs = b.op('SOFTMAX', [scaled], [(B, N, T, T)],
                 output_names=[f'{p}/attn/probs'])
    ctx = b.op('BATCH_MATMUL', [probs, qkv['v']], [(B, N, T, H)],
               output_names=[f'{p}/attn/ctx'], attrs={'adj_y': False})
    ctx_t = b.op('TRANSPOSE', [ctx], [(B, T, N, H)],
                 output_names=[f'{p}/attn/ctx_t'],
                 attrs={'perm': [0, 2, 1, 3]})
    ctx2 = b.op('RESHAPE', [ctx_t], [(B, T, N * H)],
                output_names=[f'{p}/attn/ctx_2d'],
                attrs={'new_shape': [B, T, N * H]})
    wo = _w(f'{p}/attn/o/w', (D, N * H), 0.02)
    bo = _w(f'{p}/attn/o/b', (D,), 0.01)
    attn_out = b.op('FULLY_CONNECTED', [ctx2, wo, bo], [(B, T, D)],
                    output_names=[f'{p}/attn/o/out'],
                    attrs={'fused_activation': 'NONE'})
    x = b.op('ADD', [x, attn_out], [(B, T, D)],
             output_names=[f'{p}/attn_residual'])

    # -- MLP block --
    g2 = _w(f'{p}/pre_mlp_norm/gamma', (D,), 0.1)
    mn = b.op('RMS_NORM', [x, g2], [(B, T, D)],
              output_names=[f'{p}/pre_mlp_norm/out'],
              attrs={'epsilon': cfg.norm_eps})
    w_up = _w(f'{p}/mlp/up/w', (F, D), 0.02)
    b_up = _w(f'{p}/mlp/up/b', (F,), 0.01)
    up = b.op('FULLY_CONNECTED', [mn, w_up, b_up], [(B, T, F)],
              output_names=[f'{p}/mlp/up/out'],
              attrs={'fused_activation': 'NONE'})
    act = b.op('GELU', [up], [(B, T, F)], output_names=[f'{p}/mlp/gelu'])
    w_dn = _w(f'{p}/mlp/down/w', (D, F), 0.02)
    b_dn = _w(f'{p}/mlp/down/b', (D,), 0.01)
    dn = b.op('FULLY_CONNECTED', [act, w_dn, b_dn], [(B, T, D)],
              output_names=[f'{p}/mlp/down/out'],
              attrs={'fused_activation': 'NONE'})
    x = b.op('ADD', [x, dn], [(B, T, D)],
             output_names=[f'{p}/mlp_residual'])

  # -- CLS pooler + classifier head --
  gf = _w('final_norm/gamma', (D,), 0.1)
  xf = b.op('RMS_NORM', [x, gf], [(B, T, D)],
            output_names=['final_norm/out'],
            attrs={'epsilon': cfg.norm_eps})
  cls = b.op('SLICE', [xf], [(B, 1, D)], output_names=['cls_token'],
             attrs={'begin': [0, 0, 0]})
  cls2 = b.op('RESHAPE', [cls], [(B, D)], output_names=['cls_2d'],
              attrs={'new_shape': [B, D]})
  wp = _w('pooler/w', (D, D), 0.02)
  bp = _w('pooler/b', (D,), 0.01)
  pooled_fc = b.op('FULLY_CONNECTED', [cls2, wp, bp], [(B, D)],
                   output_names=['pooler/out'],
                   attrs={'fused_activation': 'NONE'})
  pooled = b.op('TANH', [pooled_fc], [(B, D)], output_names=['pooled'])
  wc = _w('classifier/w', (cfg.num_classes, D), 0.02)
  bc = _w('classifier/b', (cfg.num_classes,), 0.01)
  logits = b.op('FULLY_CONNECTED', [pooled, wc, bc], [(B, cfg.num_classes)],
                output_names=['logits'],
                attrs={'fused_activation': 'NONE'})
  out = b.op('SOFTMAX', [logits], [(B, cfg.num_classes)],
             output_names=['probs'])
  b.output(out, user_name='probs')
  b.output(pooled, user_name='pooled')
  return b.finalize()


def make_inputs(cfg: EncoderConfig, batch: int, seed: int = 0) -> dict:
  """Random calibration/test inputs for the encoder signature."""
  rng = np.random.default_rng(seed)
  return {
      'tokens': rng.integers(0, cfg.vocab_size, (batch, cfg.seq_len),
                             dtype=np.int32),
      'positions': np.broadcast_to(
          np.arange(cfg.seq_len, dtype=np.int32),
          (batch, cfg.seq_len)).copy(),
  }
