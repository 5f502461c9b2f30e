"""The split-S decode attentions on tensor cores (#17 masked, #18 live
prefix; `csrc/attention_split_tc.cuh`) on the CPU, where no CUDA kernel
runs: a PyTorch twin of the kernels' schedule held against the plain
versions and the TPU kernels.

The kernels split a (batch, kv-head) row's S cache rows across a cluster
of n_split CTAs of `rows` rows each, whole chunks of `kChunk` streamed
through a ring (n_split up to `kMaxSplit`: on the card the most whose
clusters the device holds at once, by the occupancy query, else one). Each scores its slice on the tensor cores (an f32 q in
`kQPartsF32` bf16 parts, the smallest part's products first; bf16 mode one
part; int8 mode the codes, exact), takes its slice's maximum per query row;
the maxima meet (order free, so e = exp(s - m) is the one-block value);
the slices' sums of e (f32, f64 in int8) are added in split order; the
mode's operand follows (f32 p, bf16 p, int8 codes); each slice's context
runs with p * `kPScale` in `kPParts` fp16 parts (bf16 mode one part;
int8 the codes, exact), and the slices' partials are added in split
order. The live-prefix kernel keeps e unnormalised, l the cluster's sum.
The twin repeats that (the f32 sums in the CPU's order) and must hold:
f32 within 1e-5 * max(|y|, 1) of the plain versions and of interpret-mode
Pallas (the card's bound in chip_smoke.py), bf16 by the compute modes'
rule (test_torch_port_attn_compute._check_ctx), int8 codes and context bit
for bit with the plain version; one part fewer of q or of p must fail the
f32 bound. The constants are read from the header's source.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_edge_quantizer_tpu.kernels import pallas_attention
from ai_edge_quantizer_tpu_torch.kernels import _build
from ai_edge_quantizer_tpu_torch.kernels import attention

import test_torch_port_attn_block as attn_block
from test_torch_port_attn_compute import _check_ctx

CSRC = pathlib.Path(_build.CSRC)
SOURCE = (CSRC / 'attention_split_tc.cuh').read_text()
_exact = attn_block._exact


def _const(name):
  found = re.search(rf'constexpr (?:int|float) {name} = ([0-9.]+)f?;',
                    SOURCE)
  assert found, name
  return float(found.group(1))


CHUNK = int(_const('kChunk'))
MAX_SPLIT = int(_const('kMaxSplit'))
Q_PARTS_F32 = int(_const('kQPartsF32'))
P_PARTS = int(_const('kPParts'))
P_SCALE = _const('kPScale')
ZP_K, ZP_V, K_SCALE, V_SCALE = 3.0, -2.0, 0.06, 0.06


def splits(s):
  """choose_plan's candidate splits, most CTAs first: ceil(chunks / per)
  for each count `per` of chunks a CTA, at most kMaxSplit, down to one."""
  chunks = max(-(-s // CHUNK), 1)
  out = []
  for per in range(-(-chunks // MAX_SPLIT), chunks + 1):
    n = -(-chunks // per)
    if n not in out:
      out.append(n)
  return out


def _parts(x, n, dtype):
  """n parts of x in `dtype` whose sum is x (to the parts' precision):
  each part rounds what the earlier ones left."""
  parts, rest = [], x
  for _ in range(n):
    part = rest.to(dtype)
    parts.append(part)
    rest = rest - part.to(torch.float32)
  return parts


def _slices(s, n_split):
  """The CTAs' slices: whole chunks, the last slice cut at S."""
  chunks = -(-s // CHUNK)
  rows = -(-chunks // n_split) * CHUNK
  return [slice(i * rows, min((i + 1) * rows, s)) for i in range(n_split)
          if i * rows < s]


def _split_sum(terms):
  """Terms added in split order, from the first."""
  total = terms[0]
  for t in terms[1:]:
    total = total + t
  return total


def _scores(q, k_cache, compute, q_parts):
  """q . k - zp_k * sum(q) per mode, on the tensor cores' operands."""
  qf = q.to(torch.float32)
  kf = k_cache.to(torch.float32)
  if compute == 'int8':  # the codes: exact, as the plain version's
    return attention._mode_scores(qf, kf, ZP_K, 'int8')
  parts = _parts(qf, q_parts or (Q_PARTS_F32 if compute == 'f32' else 1),
                 torch.bfloat16)
  dot = _split_sum([torch.matmul(p.to(torch.float32), kf.transpose(-1, -2))
                    for p in reversed(parts)])  # the smallest part first
  return dot - ZP_K * torch.sum(qf, dim=-1, keepdim=True)


def _context(p, v_cache, n_parts, n_split):
  """Each slice's p . v with p * kPScale in fp16 parts, added in split
  order, unscaled."""
  s = v_cache.shape[2]
  vf = v_cache.to(torch.float32)
  partials = []
  for sl in _slices(s, n_split):
    parts = _parts(p[..., sl] * P_SCALE, n_parts, torch.float16)
    partials.append(_split_sum([torch.matmul(x.to(torch.float32), vf[:, :, sl])
                                for x in reversed(parts)]))
  return _split_sum(partials) / P_SCALE


def masked_twin(q, k_cache, v_cache, mask, compute='f32', q_parts=None,
                p_parts=None, n_split=None, scores=None):
  """#17's arithmetic on the split schedule (make_plan's split unless
  given): [B, NK, G, H] f32. `scores`, where given, stands for the scaled
  scores before the mask."""
  b, nk, g, h = q.shape
  s = k_cache.shape[2]
  n_split = n_split or splits(s)[0]
  ks = attention.score_scale(K_SCALE, h)
  v_scale = float(np.float32(V_SCALE))
  maskf = torch.broadcast_to(mask.to(torch.float32), (b, nk, g, s))
  if scores is None:
    scores = _scores(q, k_cache, compute, q_parts) * ks
  sc = scores + maskf
  m = torch.amax(torch.stack([torch.amax(sc[..., sl], dim=-1, keepdim=True)
                              for sl in _slices(s, n_split)]), dim=0)
  e = torch.exp(sc - m)
  sum_t = torch.float64 if compute == 'int8' else torch.float32
  denom = _split_sum([torch.sum(e[..., sl].to(sum_t), dim=-1, keepdim=True)
                      for sl in _slices(s, n_split)]).to(torch.float32)
  p = e / denom
  if compute == 'int8':
    codes = torch.round(p * 127.0)
    vf = v_cache.to(torch.float64)
    ctx = _split_sum([torch.matmul(codes[..., sl].to(torch.float64),
                                   vf[:, :, sl])
                      for sl in _slices(s, n_split)])
    p_sum = torch.clamp_min(torch.sum(codes, dim=-1, keepdim=True), 1.0)
    return (ctx.to(torch.float32) / p_sum - ZP_V) * v_scale
  if compute == 'bf16':
    p = p.to(torch.bfloat16).to(torch.float32)
    ctx = _context(p, v_cache, p_parts or 1, n_split)
  else:
    ctx = _context(p, v_cache, p_parts or P_PARTS, n_split)
  return (ctx - ZP_V) * v_scale


def dynlen_twin(q, k_cache, v_cache, lengths, chunk=256, row_block=8,
                n_split=None):
  """#18's arithmetic on the split schedule: the row's maximum over the
  cluster, e unnormalised (1 on a zero-length row's n_chunks * c rows, 0
  past them and past a length), l the slices' sums in split order."""
  b, nk, g, h = q.shape
  s = k_cache.shape[2]
  r = b * nk
  n_split = n_split or splits(s)[0]
  c, rb = attention.dynlen_blocking(r, s, h, chunk, row_block)
  lens = torch.repeat_interleave(lengths.to(torch.int64), nk).reshape(b, nk)
  blk = torch.amax(lens.reshape(r // rb, rb), dim=1)
  n_chunks = torch.clamp(-(-blk // c), 1, s // c)
  n_chunks = torch.repeat_interleave(n_chunks, rb).reshape(b, nk)
  live_k = torch.where(lens > 0, torch.minimum(lens, n_chunks * c), 0)
  live_v = torch.where(lens > 0, live_k, n_chunks * c)
  pos = torch.arange(s).reshape(1, 1, 1, s)
  ks = attention.score_scale(K_SCALE, h)
  sc = _scores(q, k_cache, 'f32', None) * ks
  sc = torch.where(pos < live_k[..., None, None], sc, -1e30)
  m = torch.amax(torch.stack([torch.amax(sc[..., sl], dim=-1, keepdim=True)
                              for sl in _slices(s, n_split)]), dim=0)
  e = torch.where(pos < live_v[..., None, None], torch.exp(sc - m), 0.0)
  l = _split_sum([torch.sum(e[..., sl], dim=-1, keepdim=True)
                  for sl in _slices(s, n_split)])
  acc = _context(e, v_cache, P_PARTS, n_split)
  v_scale = float(np.float32(V_SCALE))
  return (acc / torch.clamp_min(l, 1e-30) - ZP_V) * v_scale


def _bound(want):
  return 1e-5 * max(float(torch.max(torch.abs(want))), 1.0)


def _j(t):
  return jnp.asarray(t.numpy())


def _masked_inputs(b, nk, g, s, h, kind, seed):
  """q, caches and a mask: 'row' [B, 1, 1, S] prefixes (lengths 1, S and
  one inside a slice), 'group' [B, 1, G, S] holes; batch row 1 idle (-1e9
  everywhere) and query row 2 of batch row 0 hidden everywhere."""
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  kc = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  vc = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  if kind == 'group':
    mask = np.where(rng.random((b, 1, g, s)) < 0.4, -1e9, 0.0)
    mask[0, 0, 2] = -1e9
  else:
    lengths = rng.integers(1, s + 1, b)
    lengths[0], lengths[-1] = 1, s
    if b > 2:
      lengths[2] = CHUNK + 37  # ends inside the second chunk
    mask = np.where(np.arange(s)[None] < lengths[:, None], 0.0, -1e9)
    mask = mask.reshape(b, 1, 1, s)
  mask = mask.astype(np.float32)
  if b > 1:
    mask[1] = -1e9
  return tuple(torch.from_numpy(a) for a in (q, kc, vc, mask))


def _plain(q, kc, vc, mask, compute):
  return attention.decode_attention_int8_masked_plain(
      q, kc, vc, K_SCALE, V_SCALE, mask, k_zero_point=ZP_K,
      v_zero_point=ZP_V, compute=compute)


def _pallas(q, kc, vc, mask, compute):
  fn = _exact(pallas_attention.decode_attention_int8_masked)
  return torch.from_numpy(np.array(fn(
      _j(q), _j(kc), _j(vc), K_SCALE, V_SCALE, _j(mask), k_zero_point=ZP_K,
      v_zero_point=ZP_V, compute=compute, interpret=True)))


# (b, nk, g, s, h, mask kind): 2 to 4 slices, G 8 and 4, H 64 to 256.
MASKED_SHAPES = [(4, 1, 8, 256, 256, 'row'), (4, 2, 4, 512, 128, 'group'),
                 (3, 1, 8, 384, 64, 'row'), (2, 2, 8, 512, 256, 'group')]


@pytest.mark.parametrize('compute', ['f32', 'bf16', 'int8'])
@pytest.mark.parametrize('b,nk,g,s,h,kind', MASKED_SHAPES)
def test_masked_twin_holds_the_rules(b, nk, g, s, h, kind, compute):
  q, kc, vc, mask = _masked_inputs(b, nk, g, s, h, kind, seed=b + s + h + g)
  got = masked_twin(q, kc, vc, mask, compute)
  assert torch.all(torch.isfinite(got))
  plain = _plain(q, kc, vc, mask, compute)
  if compute == 'int8':
    assert torch.equal(got, plain)
    _check_ctx(got.numpy(), _pallas(q, kc, vc, mask, compute).numpy(),
               compute, V_SCALE, ZP_V)
  elif compute == 'bf16':
    for want in (plain, _pallas(q, kc, vc, mask, compute)):
      _check_ctx(got.numpy(), want.numpy(), compute, V_SCALE, ZP_V)
  else:
    for want in (plain, _pallas(q, kc, vc, mask, compute)):
      err = float(torch.max(torch.abs(got - want)))
      assert err <= _bound(want), (err, _bound(want))


def test_masked_idle_row_is_uniform():
  """A batch row masked -1e9 everywhere weighs every cache row alike, on
  every slice: in int8 every code is rint(127 / S) = 0 at S 512, so the
  context is -zp_v * v_scale; in f32 the mean of V."""
  q, kc, vc, mask = _masked_inputs(2, 1, 8, 512, 128, 'row', seed=3)
  idle = masked_twin(q, kc, vc, mask, 'int8')[1]
  assert torch.all(idle == np.float32(-ZP_V) * np.float32(V_SCALE))
  mean = (vc[1].to(torch.float64).mean(dim=1, keepdim=True) - ZP_V) * V_SCALE
  f32 = masked_twin(q, kc, vc, mask, 'f32')[1].to(torch.float64)
  assert float(torch.max(torch.abs(f32 - mean))) <= 1e-5


def _dynlen_inputs(b, nk, g, s, h, lengths, seed):
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, nk, g, h)).astype(np.float32)
  kc = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  vc = rng.integers(-127, 128, (b, nk, s, h)).astype(np.int8)
  return (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
          torch.tensor(lengths, dtype=torch.int32))


# Zero-length rows beside full ones in one row block; lengths that end
# inside a slice or are shorter than one; every row idle; two KV heads.
DYNLEN_CASES = [
    ((0, 512, 1, 100, 127, 129, 0, 300), 1, 8, 512, 128),
    ((0, 0, 0, 0), 1, 4, 256, 256),
    ((5, 0, 384, 17), 2, 8, 384, 64),
    ((256, 255, 0, 1), 1, 4, 512, 256)]


@pytest.mark.parametrize('lengths,nk,g,s,h', DYNLEN_CASES)
def test_dynlen_twin_holds_the_bound(lengths, nk, g, s, h):
  b = len(lengths)
  q, kc, vc, lens = _dynlen_inputs(b, nk, g, s, h, lengths,
                                   seed=sum(lengths) + s + h)
  got = dynlen_twin(q, kc, vc, lens)
  assert torch.all(torch.isfinite(got))
  kw = dict(k_zero_point=ZP_K, v_zero_point=ZP_V)
  plain = attention.decode_attention_int8_dynlen_plain(
      q, kc, vc, K_SCALE, V_SCALE, lens, **kw)
  tpu = torch.from_numpy(np.array(
      pallas_attention.decode_attention_int8_dynlen(
          _j(q), _j(kc), _j(vc), K_SCALE, V_SCALE, _j(lens), interpret=True,
          **kw)))
  for want in (plain, tpu):
    err = float(torch.max(torch.abs(got - want)))
    assert err <= _bound(want), (err, _bound(want))


@pytest.mark.parametrize('fewer', ['q', 'p'])
def test_one_part_fewer_fails_the_bound(fewer):
  """At Gemma-2B's width (G 8, H 256) over 1024 visible cache rows, with
  q of the spread of an activation (standard deviation 2), each split is
  needed: the twin stays within the f32 bound on four inputs (below 0.2
  of it), while an f32 q in one bf16 part fewer (16 bits) misses it on
  some of them (up to about 2.8 times it), and p in one fp16 part fewer
  on all of them."""
  kw = ({'q_parts': Q_PARTS_F32 - 1} if fewer == 'q'
        else {'p_parts': P_PARTS - 1})
  worst, always = 0.0, True
  for seed in range(4):
    q, kc, vc, mask = _masked_inputs(1, 1, 8, 1024, 256, 'row', seed=seed)
    q, mask = 2.0 * q, torch.zeros_like(mask)
    want = _plain(q, kc, vc, mask, 'f32')
    err = float(torch.max(torch.abs(masked_twin(q, kc, vc, mask) - want)))
    assert err <= _bound(want), (seed, err, _bound(want))
    fewer_err = float(torch.max(torch.abs(
        masked_twin(q, kc, vc, mask, **kw) - want))) / _bound(want)
    worst, always = max(worst, fewer_err), always and fewer_err > 1.0
  assert worst > 1.0, worst
  if fewer == 'p':
    assert always


@pytest.mark.parametrize('s,want', [
    (1024, [8, 4, 3, 2, 1]), (2048, [8, 6, 4, 3, 2, 1]), (256, [2, 1]),
    (200, [2, 1]), (128, [1])])
def test_candidate_splits(s, want):
  """At most kMaxSplit CTAs a row (a portable cluster), whole chunks each:
  every slice holds rows, and the slices cover S."""
  assert splits(s) == want
  for n in want:
    sl = _slices(s, n)
    assert len(sl) == n and sl[-1].stop == s
    assert all(x.stop > x.start for x in sl)


@pytest.mark.parametrize('n_split', [1, 2, 3, 4, 8])
def test_twin_at_each_split(n_split):
  """Each split choose_plan may take at S 1024: 1024, 512, 384 (the last
  CTA 256), 256 and 128 rows a CTA hold the f32 bound and int8 bit for
  bit."""
  q, kc, vc, mask = _masked_inputs(2, 1, 8, 1024, 256, 'row', seed=n_split)
  for compute in ('f32', 'int8'):
    got = masked_twin(q, kc, vc, mask, compute, n_split=n_split)
    want = _plain(q, kc, vc, mask, compute)
    if compute == 'int8':
      assert torch.equal(got, want)
    else:
      err = float(torch.max(torch.abs(got - want)))
      assert err <= _bound(want), (err, _bound(want))
  lens = torch.tensor([0, 1024], dtype=torch.int32)
  got = dynlen_twin(q, kc, vc, lens, n_split=n_split)
  want = attention.decode_attention_int8_dynlen_plain(
      q, kc, vc, K_SCALE, V_SCALE, lens, k_zero_point=ZP_K,
      v_zero_point=ZP_V)
  assert float(torch.max(torch.abs(got - want))) <= _bound(want)


def test_kernels_run_on_the_split_core():
  """Both kernels are bodies of attention_split_tc.cuh: a cluster of CTAs
  over S, bulk copies of K and V chunks into a ring, mma.sync for the
  scores (bf16, s8) and the context (f16, s8); the one-block bodies are
  gone, and no library call stands in."""
  for mma in ('mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32',
              'mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32',
              'mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32'):
    assert mma in SOURCE
  for part in ('tc::bulk_load(ring', '(is_v ? a.v : a.k)',
               'tc::cluster_sync()', 'tc::cluster_map(',
               'cudaLaunchAttributeClusterDimension'):
    assert part in SOURCE
  ptx = (CSRC / 'tc_ptx.cuh').read_text()
  for part in ('cp.async.bulk.shared::cluster.global', 'barrier.cluster',
               'mapa.u64'):
    assert part in ptx
  for name, body in (
      ('attention_masked', 'attend<aeqt::split::kMasked, C, H, NTS>'),
      ('attention_dynlen', 'attend<aeqt::split::kDynlen, aeqt::kF32, H, NTS>')):
    src = (CSRC / f'{name}.cu').read_text()
    assert '#include "attention_split_tc.cuh"' in src and body in src
    for old in ('<<<', 'context_phase', 'softmax_row', 'score_rows',
                'dot_row', 'context_rows'):
      assert old not in src, (name, old)
  for call in ('cublas', 'cudnn', 'scaled_dot_product'):
    assert call not in SOURCE.lower()
