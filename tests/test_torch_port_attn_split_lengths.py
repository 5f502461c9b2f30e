"""The lengths (#7) and int4-group (#10) decode attentions on the split-S
tensor-core core (`csrc/attention_split_tc.cuh`: `attend<kLengths, C>` and
`attend_int4g`) on the CPU, where no CUDA kernel runs: PyTorch twins of the
kernels' schedules held against the plain versions and the TPU kernels
(interpret-mode Pallas compiled with XLA's excess precision off, `_exact`).

#7 is #17's schedule (tests/test_torch_port_attn_split.py's `masked_twin`)
with the scores of rows at or past a row's length -1e30 and only the live
rows read; a zero-length row reads every V row, each weighing 1 / S. Its
f32 mode forms q . k as one f32 FMA chain over h in increasing order (the
plain version's matmul order on the card), then the split softmax and the
context with p * kPScale in kPParts fp16 parts, slices added in split
order. Held, as chip_smoke.py holds the card, to 1e-5 absolute in f32 (one
p part fewer fails it), by the compute modes' rule in bf16
(test_torch_port_attn_compute._check_ctx) and bit for bit in int8.

#10's twin: bf16(q) . K, K = bf16(kcode * kscale), one f32 FMA chain over
h, plus the group sums of bf16(q) against the K mins, one more over the
groups, times f32(1 / sqrt(H)) (the plain version's order on the card);
-1e30 past the length; the split softmax with an f32 sum, p rounded to
bf16; each slice's p . bf16(vcode * vscale) in f32, added in split order.
Held to chip_smoke.py's rule (INT4G_CTX_RTOL of the largest magnitude, at
most INT4G_FINE_SHARE of the elements beyond INT4G_FINE_RTOL of it), which
the plain version without any one of its four bf16 roundings fails here
too. The constants are read from the header's source.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu_torch.kernels import attention

import test_torch_port_attn_split as split
from test_torch_port_attn_compute import _check_ctx

_exact = split._exact
_j = split._j
CHUNK, P_PARTS = split.CHUNK, split.P_PARTS
ZP_K, ZP_V, K_SCALE, V_SCALE = (split.ZP_K, split.ZP_V, split.K_SCALE,
                                split.V_SCALE)
BOUND = 1e-5  # #7's f32 bound, absolute (chip_smoke.lengths_kernel)
# chip_smoke.py's int4g rule at the twins' shapes (the card's INT4G_CTX_RTOL
# is 4e-3: at 33 live rows a flipped bf16 rounding of p moves the bench
# case's context by up to 2e-3 of its largest value).
INT4G_CTX_RTOL, INT4G_FINE_RTOL, INT4G_FINE_SHARE = 1e-3, 1e-5, 0.1


def chain_dot(a, b):
  """a [..., G, K] . b [..., N, K] as one f32 FMA chain over k = 0 .. K - 1
  (each step exact in f64, rounded once): [..., G, N]."""
  ad, bd = a.to(torch.float64), b.to(torch.float64)
  acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32)
  for k in range(a.shape[-1]):
    acc = (acc.to(torch.float64)
           + ad[..., k:k + 1] * bd[..., k][..., None, :]).to(torch.float32)
  return acc


def _jb(t):
  """A torch array as a JAX array, bf16 bit for bit."""
  if t.dtype == torch.bfloat16:
    return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
  return _j(t)


def _live(lengths, b, s):
  pos = torch.arange(s).reshape(1, 1, 1, s)
  return pos < lengths.to(torch.int64).reshape(b, 1, 1, 1)


def lengths_twin(q, k_cache, v_cache, lengths, compute='f32', p_parts=None,
                 n_split=None):
  """#7's arithmetic on the split schedule: #17's with a -1e30 prefix
  mask, the f32 scores from the FMA chain."""
  b, nk, g, h = q.shape
  s = k_cache.shape[2]
  mask = torch.where(_live(lengths, b, s), 0.0, -1e30)
  scores = None
  if compute == 'f32':
    qf = q.to(torch.float32)
    scores = (chain_dot(qf, k_cache) - ZP_K * torch.sum(qf, -1, keepdim=True)
              ) * attention.score_scale(K_SCALE, h)
  return split.masked_twin(q, k_cache, v_cache, mask, compute,
                           p_parts=p_parts, n_split=n_split, scores=scores)


def _lengths_inputs(b, nk, g, s, h, lengths, seed):
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  kc = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  vc = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  return (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
          torch.tensor(lengths, dtype=torch.int32))


def _lengths_plain(q, kc, vc, lens, compute):
  return attention.decode_attention_int8_lengths_plain(
      q, kc, vc, K_SCALE, V_SCALE, lens, k_zero_point=ZP_K,
      v_zero_point=ZP_V, compute=compute)


def _lengths_pallas(q, kc, vc, lens, compute):
  fn = _exact(pallas_attention.decode_attention_int8_lengths)
  return torch.from_numpy(np.array(fn(
      _j(q), _j(kc), _j(vc), K_SCALE, V_SCALE, _j(lens), k_zero_point=ZP_K,
      v_zero_point=ZP_V, compute=compute, batch_block=1, interpret=True)))


def _hold(got, want, compute):
  if compute == 'int8':
    assert torch.equal(got, want)
  elif compute == 'bf16':
    _check_ctx(got.numpy(), want.numpy(), compute, V_SCALE, ZP_V)
  else:
    err = float(torch.max(torch.abs(got - want)))
    assert err <= BOUND, err


# Lengths 0 (every S row weighs 1 / S), 1, a full row and ragged ones (one
# inside a slice's second chunk); G 8 and 4, H 64 and 128, two KV heads.
LENGTHS_CASES = [
    ((0, 1, 384, CHUNK + 37), 1, 8, 384, 128),
    ((512, 0, 200, 1), 2, 4, 512, 64),
    ((3, 256, 0, 129), 1, 8, 256, 64)]


@pytest.mark.parametrize('compute', ['f32', 'bf16', 'int8'])
@pytest.mark.parametrize('lengths,nk,g,s,h', LENGTHS_CASES)
def test_lengths_twin_holds_the_rules(lengths, nk, g, s, h, compute):
  b = len(lengths)
  q, kc, vc, lens = _lengths_inputs(b, nk, g, s, h, lengths,
                                    seed=sum(lengths) + h)
  got = lengths_twin(q, kc, vc, lens, compute)
  assert torch.all(torch.isfinite(got))
  _hold(got, _lengths_plain(q, kc, vc, lens, compute), compute)
  if compute == 'int8':  # the codes exact against the TPU kernel's too
    _check_ctx(got.numpy(), _lengths_pallas(q, kc, vc, lens, 'int8').numpy(),
               'int8', V_SCALE, ZP_V)
  else:
    _hold(got, _lengths_pallas(q, kc, vc, lens, compute), compute)


@pytest.mark.parametrize('n_split', [1, 2, 3, 4, 8])
def test_lengths_twin_at_each_split(n_split):
  """Each split choose_plan may take at S 1024 holds every mode's rule,
  and a zero-length row is the mean of all S V rows in each."""
  lengths = (0, 1, 1024, 700)
  q, kc, vc, lens = _lengths_inputs(4, 1, 8, 1024, 128, lengths,
                                    seed=n_split)
  for compute in ('f32', 'bf16', 'int8'):
    got = lengths_twin(q, kc, vc, lens, compute, n_split=n_split)
    _hold(got, _lengths_plain(q, kc, vc, lens, compute), compute)
  mean = (vc[0].to(torch.float64).mean(dim=1, keepdim=True) - ZP_V) * V_SCALE
  f32 = lengths_twin(q, kc, vc, lens, 'f32', n_split=n_split)[0]
  assert float(torch.max(torch.abs(f32.to(torch.float64) - mean))) <= BOUND


def test_one_p_part_fewer_fails_the_bound():
  """The f32 form's probabilities need their kPParts fp16 parts: the twin
  holds #7's bound on four inputs, one part fewer misses it on each."""
  for seed in range(4):
    q, kc, vc, lens = _lengths_inputs(2, 1, 8, 512, 128, (512, 300),
                                      seed=seed)
    want = _lengths_plain(q, kc, vc, lens, 'f32')
    err = float(torch.max(torch.abs(lengths_twin(q, kc, vc, lens) - want)))
    assert err <= BOUND, (seed, err)
    fewer = float(torch.max(torch.abs(
        lengths_twin(q, kc, vc, lens, p_parts=P_PARTS - 1) - want)))
    assert fewer > BOUND, (seed, fewer)


# -- #10 --------------------------------------------------------------------------


def _bf16(t):
  return t.to(torch.bfloat16).to(torch.float32)


def int4g_twin(q, kp, vp, sidecar, lengths, group, n_split=None):
  """#10's arithmetic on the split schedule: [B, NK, G, H] f32."""
  b, nk, g, h = q.shape
  s = kp.shape[2]
  ng = h // group
  n_split = n_split or split.splits(s)[0]
  slices = split._slices(s, n_split)
  qb = _bf16(q.to(torch.float32))
  grp = torch.arange(h) // group
  sc = sidecar.to(torch.float32)
  k32 = kp.to(torch.int32)
  kcodes = torch.cat([k32 & 0xF, k32 >> 4], dim=-1).to(torch.float32)
  kd = _bf16(kcodes * sc[:, :, :ng, :].transpose(-1, -2)[..., grp])
  dot = chain_dot(qb, kd)
  qsums = torch.sum(qb.reshape(b, nk, g, ng, group), dim=-1)
  off = chain_dot(qsums, sc[:, :, ng:2 * ng, :].transpose(-1, -2))
  scores = (dot + off) * attention._f32(1.0 / h ** 0.5, 'cpu')
  scores = torch.where(_live(lengths, b, s), scores, -1e30)
  m = torch.amax(torch.stack([torch.amax(scores[..., x], -1, keepdim=True)
                              for x in slices]), dim=0)
  e = torch.exp(scores - m)
  denom = split._split_sum([torch.sum(e[..., x], -1, keepdim=True)
                            for x in slices])
  p = _bf16(e / denom)
  vcodes = attention.unpack_int4_rows(vp).to(torch.float32)
  vd = _bf16(vcodes * sc[:, :, 2 * ng:, :].transpose(-1, -2)[..., grp])
  return split._split_sum([torch.matmul(p[..., x], vd[:, :, x])
                           for x in slices])


def _int4g_ok(got, want):
  d = torch.abs(got.to(torch.float64) - want.to(torch.float64))
  ymax = float(torch.max(torch.abs(want.to(torch.float64))))
  rel = float(torch.max(d)) / ymax
  share = float(torch.mean((d > INT4G_FINE_RTOL * ymax).to(torch.float64)))
  return rel <= INT4G_CTX_RTOL and share <= INT4G_FINE_SHARE, (rel, share)


def _int4g_inputs(b, nk, g, s, h, group, lengths, seed):
  rng = np.random.default_rng(seed)
  q = torch.from_numpy(rng.standard_normal((b, nk, g, h)).astype(np.float32))
  k = torch.from_numpy(
      (rng.standard_normal((b, nk, s, h)) * 0.5 + 0.8).astype(np.float32))
  v = torch.from_numpy(rng.standard_normal((b, nk, s, h)).astype(np.float32))
  kp, ks, km = attention.quantize_k_rows_int4_asym(k, group)
  vp, vs = attention.quantize_v_rows_int4_group(v, group)
  return (q, kp, vp, attention.build_kv_sidecar_group(ks, km, vs),
          torch.tensor(lengths, dtype=torch.int32))


# Groups 4 and 16; lengths 0, 1, full and ragged; G 8 and 4; H 64 and 128;
# two KV heads; two to four slices.
INT4G_CASES = [
    ((0, 1, 512, 300), 1, 8, 512, 128, 16),
    ((384, 0, 131, 2), 2, 4, 384, 64, 4),
    ((0, 256, 100), 1, 8, 256, 128, 4)]


@pytest.mark.parametrize('lengths,nk,g,s,h,group', INT4G_CASES)
def test_int4g_twin_holds_the_rule(lengths, nk, g, s, h, group):
  b = len(lengths)
  q, kp, vp, sidecar, lens = _int4g_inputs(b, nk, g, s, h, group, lengths,
                                           seed=sum(lengths) + group)
  got = int4g_twin(q, kp, vp, sidecar, lens, group)
  assert torch.all(torch.isfinite(got))
  plain = attention.decode_attention_int4_group_lengths_plain(
      q, kp, vp, sidecar, lens, group)
  tpu = torch.from_numpy(np.array(_exact(
      pallas_attention.decode_attention_int4_group_lengths)(
          _j(q), _j(kp), _j(vp), _jb(sidecar), _j(lens), group=group,
          batch_block=1, interpret=True)))
  for want in (plain, tpu):
    ok, why = _int4g_ok(got, want)
    assert ok, why
  # A zero-length row weighs every V row bf16(1 / S).
  w = _bf16(torch.tensor(1.0 / s))
  for row in (i for i, n in enumerate(lengths) if n == 0):
    ng = h // group
    grp = torch.arange(h) // group
    vd = _bf16(attention.unpack_int4_rows(vp[row]).to(torch.float32)
               * sidecar[row, :, 2 * ng:].to(torch.float32)
               .transpose(-1, -2)[..., grp])
    uniform = torch.matmul(torch.full((nk, g, s), float(w)), vd)
    ok, why = _int4g_ok(got[row], uniform)
    assert ok, why


@pytest.mark.parametrize('n_split', [1, 2, 3, 4])
def test_int4g_twin_at_each_split(n_split):
  q, kp, vp, sidecar, lens = _int4g_inputs(4, 1, 8, 512, 128, 16,
                                           (0, 1, 512, 257), seed=n_split)
  got = int4g_twin(q, kp, vp, sidecar, lens, 16, n_split=n_split)
  ok, why = _int4g_ok(got, attention.decode_attention_int4_group_lengths_plain(
      q, kp, vp, sidecar, lens, 16))
  assert ok, why


def test_int4g_rule_sees_each_dropped_rounding():
  """The rule the twin meets refuses the plain version with any one of its
  four bf16 roundings left out (chip_smoke.int4g_kernel's check), so the
  roundings the twin keeps are needed."""
  q, kp, vp, sidecar, lens = _int4g_inputs(4, 1, 8, 512, 128, 16,
                                           (512, 400, 77, 300), seed=5)
  args = (q, kp, vp, sidecar, lens, 16)
  want = attention.decode_attention_int4_group_lengths_plain(*args)
  assert _int4g_ok(int4g_twin(*args[:5], 16), want)[0]
  real = attention._bf16_round
  for which in range(1, 5):
    calls = []

    def patched(t, which=which):
      calls.append(t)
      return t if len(calls) == which else real(t)

    attention._bf16_round = patched
    try:
      dropped = attention.decode_attention_int4_group_lengths_plain(*args)
    finally:
      attention._bf16_round = real
    assert len(calls) == 4
    assert not _int4g_ok(dropped, want)[0], which


def test_lengths_and_int4g_run_on_the_split_core():
  """#7 and #10 are bodies of attention_split_tc.cuh with their own plan
  exports; their one-block kernels stay only for the shapes the core does
  not take, by a fixed rule. #7's launch lives in attention_lengths.cuh
  (aeqt::lengths, shared with #19 and #22)."""
  csrc = split.CSRC
  entry = (csrc / 'attention_lengths.cu').read_text()
  assert 'aeqt::lengths::launch<decltype(mode)::value>(' in entry
  assert 'extern "C" int aeqt_attention_lengths_plan' in entry
  assert 'aeqt::lengths::plan_fields<decltype(mode)::value>(' in entry
  header = (csrc / 'attention_lengths.cuh').read_text()
  assert '#include "attention_split_tc.cuh"' in header
  assert 'split::attend<split::kLengths, C, H, NTS>(a)' in header
  launch = header[header.index('int launch(const void* q'):]
  launch = launch[:launch.index('\n}\n')]
  assert launch.index('if (kernel == nullptr) {') < launch.index(
      'launch_lengths_attention')  # the fixed rule
  assert 'split::launch(kernel' in launch
  lengths = entry + header
  int4g = (csrc / 'attention_int4_group.cu').read_text()
  assert 'aeqt::split::attend_int4g<H, NTS, KG>(a)' in int4g
  assert 'extern "C" int aeqt_attention_int4_group_plan' in int4g
  src = split.SOURCE
  for part in ('score_chunk_chain', '__fmaf_rn(qv.x, kf[4 * u], acc[i])',
               '__fmaf_rn(qv.x, kf[0], acc[i])', 'pad_rows<H / 2>(st, kpad',
               'k_pair(', 'v_pair(', '__hfma2(', 'tc::bulk_load(dst + kChunk'):
    assert part in src, part
  for call in ('cublas', 'cudnn', 'scaled_dot_product'):
    assert call not in lengths.lower() and call not in int4g.lower()
