"""The per-row int4 decode attention (#21, `attention.
decode_attention_int4_lengths`) on the split-S tensor-core core
(`csrc/attention_split_tc.cuh`: `attend_int4r`) on the CPU, where no CUDA
kernel runs: a PyTorch twin of the kernel's schedule held against the plain
version and the TPU kernel (interpret-mode Pallas compiled with XLA's
excess precision off, `_exact`).

The twin: bf16(q) over the low half of H against the low K nibbles, one
f32 FMA chain over h, and over the high half against the high nibbles,
another (the plain version's two matmuls in their order on the card);
((lo + hi) * kscale) * f32(1 / sqrt(H)); -1e30 past the length; the slices
of S a cluster's CTAs take (1, 2 or 3 of them), their maxima met, their
sums of e added in split order, p = e / sum in f32; bf16(p * vscale) (the
product rounded in f32, then to bf16) against the exact V codes, each
slice's f32 context added in split order. Held to chip_smoke.py's rule
(INT4G_CTX_RTOL of the largest magnitude, at most INT4G_FINE_SHARE of the
elements beyond INT4G_FINE_RTOL of it; bf16 outputs one bf16 ulp beyond
INT4G_CTX_RTOL), at H 128 and 256, lengths 0, 1, a middle prefix and S,
f32 and bf16 out; and to the TPU kernel by the rule
tests/test_torch_port_int4_row.py holds the plain version to. The
constants are read from the header's source.
"""

import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu_torch.kernels import attention

import test_torch_port_attn_split as split
from test_torch_port_attn_split_lengths import chain_dot
from test_torch_port_int4_row import _int4_check

_exact = split._exact
_j = split._j
CHUNK = split.CHUNK
SOURCE = split.SOURCE
ROW_SOURCE = (split.CSRC / 'attention_int4_row.cu').read_text()
# chip_smoke.py's rule (int4g_ctx_ok) and its bf16-output allowance.
INT4G_CTX_RTOL, INT4G_FINE_RTOL, INT4G_FINE_SHARE = 1e-3, 1e-5, 0.1


def _bf16(t):
  return t.to(torch.bfloat16).to(torch.float32)


def _live(lengths, b, s):
  pos = torch.arange(s).reshape(1, 1, 1, s)
  return pos < lengths.to(torch.int64).reshape(b, 1, 1, 1)


def int4r_twin(q, kp, vp, scales, lengths, n_split=None,
               out_dtype=torch.float32):
  """#21's arithmetic on the split schedule: [B, NK, G, H] in out_dtype."""
  b, nk, g, h = q.shape
  s = kp.shape[2]
  h2 = h // 2
  slices = split._slices(s, n_split or split.splits(s)[0])
  qb = _bf16(q.to(torch.float32))
  kq = attention.unpack_int4_rows(kp).to(torch.float32)
  lo = chain_dot(qb[..., :h2], kq[..., :h2])
  hi = chain_dot(qb[..., h2:], kq[..., h2:])
  sc = scales.to(torch.float32)
  scores = ((lo + hi) * sc[:, :, 0:1, :]) * attention._f32(1.0 / h ** 0.5,
                                                           'cpu')
  scores = torch.where(_live(lengths, b, s), scores, -1e30)
  m = torch.amax(torch.stack([torch.amax(scores[..., x], -1, keepdim=True)
                              for x in slices]), dim=0)
  e = torch.exp(scores - m)
  denom = split._split_sum([torch.sum(e[..., x], -1, keepdim=True)
                            for x in slices])
  pv = _bf16((e / denom) * sc[:, :, 1:2, :])
  vq = attention.unpack_int4_rows(vp).to(torch.float32)
  ctx = split._split_sum([
      torch.cat([torch.matmul(pv[..., x], vq[:, :, x, :h2]),
                 torch.matmul(pv[..., x], vq[:, :, x, h2:])], dim=-1)
      for x in slices])
  return ctx.to(out_dtype)


def _ok(got, want):
  """chip_smoke.int4g_ctx_ok on f32 outputs, or one bf16 ulp beyond
  INT4G_CTX_RTOL of max |want| on bf16 ones."""
  g, w = got.to(torch.float64), want.to(torch.float64)
  d = torch.abs(g - w)
  ymax = float(torch.max(torch.abs(w)))
  if want.dtype == torch.bfloat16:
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp_min(
        torch.abs(w), 2.0**-126))) - 7)
    ulps = float(torch.max(torch.clamp_min(d - INT4G_CTX_RTOL * ymax, 0.0)
                           / ulp))
    return ulps <= 1.0, ulps
  rel = float(torch.max(d)) / ymax
  share = float(torch.mean((d > INT4G_FINE_RTOL * ymax).to(torch.float64)))
  return rel <= INT4G_CTX_RTOL and share <= INT4G_FINE_SHARE, (rel, share)


def _inputs(b, nk, g, s, h, lengths, seed):
  """q and K / V rows as the A/B tool draws them, quantized per row."""
  rng = np.random.default_rng(seed)
  q = torch.from_numpy(rng.standard_normal((b, nk, g, h)).astype(np.float32))
  k = torch.from_numpy(
      (rng.standard_normal((b, nk, s, h)) * 0.3 + 0.4).astype(np.float32))
  v = torch.from_numpy(
      (rng.standard_normal((b, nk, s, h)) * 0.3).astype(np.float32))
  kp, ks = attention.quantize_kv_rows_int4(k)
  vp, vs = attention.quantize_kv_rows_int4(v)
  return (q, kp, vp, attention.build_kv_scales_rows(ks, vs),
          torch.tensor(lengths, dtype=torch.int32))


def _pallas(q, kp, vp, scales, lengths, out_dtype):
  import jax.numpy as jnp
  sc = jnp.asarray(scales.to(torch.float32).numpy()).astype(jnp.bfloat16)
  fn = _exact(pallas_attention.decode_attention_int4_lengths)
  return np.asarray(fn(_j(q), _j(kp), _j(vp), sc, _j(lengths),
                       batch_block=1, interpret=True,
                       out_dtype=getattr(jnp, str(out_dtype).split('.')[-1]))
                    .astype(jnp.float32))


# Lengths 0 (each of the S rows weighs 1 / S), 1, a middle prefix (one
# inside a slice's second chunk) and S; G 8 and 4, two KV heads; H 128 and
# 256; S of two and three chunks.
CASES = [((0, 1, 200, 384), 1, 8, 384, 128),
         ((256, 0, CHUNK + 37, 1), 2, 4, 256, 256),
         ((0, 97, 384), 1, 8, 384, 256)]


@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('lengths,nk,g,s,h', CASES)
def test_twin_holds_the_rule(lengths, nk, g, s, h, out_dtype):
  b = len(lengths)
  args = _inputs(b, nk, g, s, h, lengths, seed=sum(lengths) + h)
  got = int4r_twin(*args, out_dtype=out_dtype)
  assert got.dtype == out_dtype
  assert torch.all(torch.isfinite(got.float()))
  plain = attention.decode_attention_int4_lengths_plain(
      *args, out_dtype=out_dtype)
  ok, why = _ok(got, plain)
  assert ok, why
  _int4_check(got.float().numpy(), _pallas(*args, out_dtype),
              out_dtype == torch.bfloat16)


@pytest.mark.parametrize('n_split', [1, 2, 3])
def test_twin_at_each_split(n_split):
  """Each split choose_plan may take at S 384 holds the rule, and a
  zero-length row is bf16(vscale / S) against every V row's codes."""
  lengths = (0, 1, 384, 257)
  args = _inputs(4, 1, 8, 384, 128, lengths, seed=n_split)
  got = int4r_twin(*args, n_split=n_split)
  ok, why = _ok(got, attention.decode_attention_int4_lengths_plain(*args))
  assert ok, why
  q, kp, vp, scales, _ = args
  pv = _bf16(torch.tensor(1.0 / 384, dtype=torch.float32)
             * scales[0, :, 1, :].to(torch.float32))  # [NK, S]
  vq = attention.unpack_int4_rows(vp[0]).to(torch.float32)  # [NK, S, H]
  uniform = torch.matmul(pv[:, None, :].expand(-1, 8, -1), vq)
  ok, why = _ok(got[0], uniform)
  assert ok, why


def test_splits_of_the_twin():
  assert split.splits(384) == [3, 2, 1]
  assert split.splits(1024)[0] == 8


def test_rule_sees_the_probability_rounding():
  """The rule the twin meets refuses the twin with bf16(p * vscale) left
  unrounded (p * vscale in f32): that rounding is needed."""
  args = _inputs(4, 1, 8, 384, 128, (384, 300, 77, 200), seed=9)
  want = attention.decode_attention_int4_lengths_plain(*args)
  assert _ok(int4r_twin(*args), want)[0]
  real = attention._bf16_round
  calls = []

  def patched(t):
    calls.append(t)
    return t if len(calls) == 2 else real(t)

  attention._bf16_round = patched
  try:
    unrounded = attention.decode_attention_int4_lengths_plain(*args)
  finally:
    attention._bf16_round = real
  assert len(calls) == 2
  assert not _ok(unrounded, want)[0]


def test_int4_row_runs_on_the_split_core():
  """#21 is a body of attention_split_tc.cuh with its own plan export; its
  one-block kernel stays only for the shapes the core does not take, by a
  fixed rule."""
  assert 'aeqt::split::attend_int4r<H, NTS>(a)' in ROW_SOURCE
  assert 'extern "C" int aeqt_attention_int4_row_plan' in ROW_SOURCE
  assert 'if (split != nullptr) {' in ROW_SOURCE  # the fixed rule
  assert 'aeqt::split::takes_int4r(R, G, S, H)' in ROW_SOURCE
  for part in ('acc[hf][i] = __fmaf_rn(qv.x, kf[0], acc[hf][i])',
               'const float dot = acc[0][i] + acc[1][i];',
               '__fmul_rn(pv.x, vs[0])', 'code_pair(__byte_perm(x01',
               'softmax_cluster<kLengths, kF32>',
               'tc::bulk_load(dst + kChunk * H2'):
    assert part in SOURCE, part
  for call in ('cublas', 'cudnn', 'scaled_dot_product'):
    assert call not in ROW_SOURCE.lower()
