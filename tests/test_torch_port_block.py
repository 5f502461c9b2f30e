"""The port's fused decode block against the JAX package, on the CPU.

Kernel level: `kernels/block.fused_mlp_qkv_attention` (its plain version,
which is what the wrapper runs on a CPU tensor) against
`pallas_block.fused_mlp_qkv_attention(..., writeback=False,
interpret=True)` followed by the write of the new rows into the pools, at
`tests/test_block_kernel.py`'s shapes. Executor level: the port's
`GraphExecutor(decode_block=True)` against the JAX executor with
`AEQT_DECODE_BLOCK=1` on `tests/test_block_fusion_executor.py`'s decode
graph, and the port's block on against off.

Tolerances. The int8 codes (k_new, v_new, the pools) must be equal. x_ffn
and ctx are floats summed in another order: XLA on the CPU contracts
`acc += part * hs` and `x + acc * s_d` into FMAs and computes rsqrt its
own way, while the port rounds every product (the bias finding of
ROADMAP.md Queue 3); x_ffn is held to 2e-6 relative to its largest value
(read: 4.8e-7) and ctx, of values up to 7.5, to 5e-5 absolute (read:
1.3e-5). At Gemma-2B's width (D 2048, 256 rows) a few rows carry a DRQ
code that flips; the tests there bound how many (see below).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai_edge_quantizer_tpu.execution import executor as jax_executor
from ai_edge_quantizer_tpu.graph import ir as jax_ir
from ai_edge_quantizer_tpu.kernels import pallas_block, pallas_mlp
from ai_edge_quantizer_tpu.kernels import pallas_qmatmul
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.ops import impl as jax_impl
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.kernels import attention, block, head, mlp
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.ops import impl

from test_torch_port_ops import _ctx as op_context
from test_torch_port_slice import shared_weights

B, D, F, NQ, H, S, BF = 16, 256, 512, 4, 128, 64, 256
KS, VS, KQS, VQS = 0.061, 0.059, 0.061, 0.059
POSITIONS = (0, 31, 32, S - 1)
XFFN_RTOL = 2e-6
CTX_ATOL = 5e-5


@pytest.fixture(scope='module')
def weights():
  rng = np.random.default_rng(0)
  return dict(
      x=rng.standard_normal((B, D)).astype(np.float32) * 0.5,
      g1=(rng.random(D) * 0.2 + 0.9).astype(np.float32),
      g2=(rng.random(D) * 0.2 + 0.9).astype(np.float32),
      wgu=rng.integers(-7, 8, (2 * F, D)).astype(np.int8),
      sgu=(rng.random(2 * F) * 0.01 + 0.005).astype(np.float32),
      wd=rng.integers(-7, 8, (D, F)).astype(np.int8),
      sd=(rng.random(D) * 0.01 + 0.005).astype(np.float32),
      wqkv=rng.integers(-7, 8, ((NQ + 2) * H, D)).astype(np.int8),
      sqkv=(rng.random((NQ + 2) * H) * 0.01 + 0.005).astype(np.float32),
      kc=rng.integers(-127, 128, (B, S, H)).astype(np.int8),
      vc=rng.integers(-127, 128, (B, S, H)).astype(np.int8))


def _step_inputs(pos):
  """lengths (1..pos+1, the first row pos+1) and cos, sin of pos."""
  rng = np.random.default_rng(pos)
  lengths = rng.integers(1, pos + 2, B).astype(np.int32)
  lengths[0] = pos + 1
  half = H // 2
  freqs = 10000.0 ** (-np.arange(0, half, dtype=np.float32) / half)
  ang = np.float32(pos) * freqs
  cos = np.broadcast_to(np.cos(ang), (B, half)).astype(np.float32)
  sin = np.broadcast_to(np.sin(ang), (B, half)).astype(np.float32)
  return lengths, cos, sin


def _x(w, dtype):
  x = torch.from_numpy(w['x'])
  return x.to(torch.bfloat16) if dtype == 'bf16' else x


@pytest.fixture(scope='module')
def jax_block(weights):
  """JAX block outputs by (dtype, act, pos), computed once each."""
  w = weights
  done = {}

  def run(dtype, act, pos):
    if (dtype, act, pos) not in done:
      lengths, cos, sin = _step_inputs(pos)
      xj = jnp.asarray(_x(w, dtype).float().numpy()).astype(
          jnp.bfloat16 if dtype == 'bf16' else jnp.float32)
      ctx, x_ffn, k_new, v_new, k_pool, v_pool = (
          pallas_block.fused_mlp_qkv_attention(
              xj, jnp.asarray(w['g1']),
              pallas_qmatmul.pack_int4_split(jnp.asarray(w['wgu'])),
              jnp.asarray(w['sgu']),
              pallas_mlp.pack_int4_split_grouped(jnp.asarray(w['wd']), BF),
              jnp.asarray(w['sd']), jnp.asarray(w['g2']),
              pallas_qmatmul.pack_int4_split(jnp.asarray(w['wqkv'])),
              jnp.asarray(w['sqkv']), jnp.asarray(cos), jnp.asarray(sin),
              jnp.asarray(w['kc']), jnp.asarray(w['vc']),
              jnp.asarray(lengths), jnp.int32(pos), KS, VS, KQS, VQS, NQ,
              act=act, eps=1e-6, bf=BF, bb=4, ring=2, writeback=False,
              interpret=True))
      # writeback=False leaves the pools to the caller's DUS of the rows.
      k_pool = np.array(k_pool)
      v_pool = np.array(v_pool)
      k_pool[:, pos] = np.asarray(k_new)
      v_pool[:, pos] = np.asarray(v_new)
      done[(dtype, act, pos)] = dict(
          ctx=np.asarray(ctx), x_ffn=np.asarray(x_ffn.astype(jnp.float32)),
          k_new=np.asarray(k_new), v_new=np.asarray(v_new), k_pool=k_pool,
          v_pool=v_pool)
    return done[(dtype, act, pos)]

  return run


def _port_args(w, dtype, pos):
  lengths, cos, sin = _step_inputs(pos)
  t = torch.from_numpy
  return [_x(w, dtype), t(w['g1']), packed_qmatmul.pack_int4_split(
      t(w['wgu'])), t(w['sgu']), mlp.pack_int4_split_grouped(t(w['wd']), BF),
          t(w['sd']), t(w['g2']), packed_qmatmul.pack_int4_split(t(w['wqkv'])),
          t(w['sqkv']), t(cos), t(sin), t(w['kc'].copy()),
          t(w['vc'].copy()), t(lengths), pos, KS, VS, KQS, VQS, NQ]


@pytest.mark.parametrize('pos', POSITIONS)
@pytest.mark.parametrize('act', ['gelu', 'silu'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_block_matches_pallas(dtype, act, pos, weights, jax_block):
  want = jax_block(dtype, act, pos)
  args = _port_args(weights, dtype, pos)
  fn = block.fused_mlp_qkv_attention
  before = (fn.launches, fn.plain_calls)
  ctx, x_ffn, k_new, v_new = fn(*args, act=act, bf=BF)
  assert (fn.launches, fn.plain_calls) == (before[0], before[1] + 1)
  assert x_ffn.dtype == args[0].dtype and ctx.shape == (B, NQ, H)
  np.testing.assert_array_equal(k_new.numpy(), want['k_new'])
  np.testing.assert_array_equal(v_new.numpy(), want['v_new'])
  np.testing.assert_array_equal(args[11].numpy(), want['k_pool'])
  np.testing.assert_array_equal(args[12].numpy(), want['v_pool'])
  xmax = float(np.abs(want['x_ffn']).max())
  np.testing.assert_allclose(x_ffn.float().numpy(), want['x_ffn'], rtol=0,
                             atol=XFFN_RTOL * xmax)
  np.testing.assert_allclose(ctx.numpy(), want['ctx'], rtol=0,
                             atol=CTX_ATOL)


def test_block_plain_is_the_composition(weights):
  """The plain block equals the port's own unfused kernels' plain versions
  in a row: MLP, residual, norm, QKV, RoPE, quantize, stale attention."""
  pos = 31
  args = _port_args(weights, 'f32', pos)
  ctx, x_ffn, k_new, v_new = block.fused_mlp_qkv_attention(*args, bf=BF)
  (x, g1, wgu, sgu, wd, sd, g2, wqkv, sqkv, cos, sin, _, _, lengths) = (
      args[:14])
  xn = x * block.rms_inverse(x, 1e-6) * g1
  x_ffn2 = x + mlp.mlp_int4_packed_plain(xn, wgu, sgu, wd, sd, bf=BF)
  torch.testing.assert_close(x_ffn, x_ffn2, rtol=0, atol=0)
  xn2 = x_ffn2 * block.rms_inverse(x_ffn2, 1e-6) * g2
  qkv = packed_qmatmul.qmatmul_int4_packed_drq_plain(xn2, wqkv, sqkv)
  q = block.rope_rotate(qkv[:, :NQ * H].reshape(B, NQ, H), cos[:, None],
                  sin[:, None])
  k = torch.round(block.rope_rotate(qkv[:, NQ * H:(NQ + 1) * H], cos, sin)
                  * float(np.float32(1 / KQS))).clamp(-127, 127).to(
                      torch.int8)
  torch.testing.assert_close(k_new, k, rtol=0, atol=0)
  ctx2 = attention.decode_attention_int8_lengths_stale_plain(
      q[:, None], torch.from_numpy(weights['kc'])[:, None],
      torch.from_numpy(weights['vc'])[:, None], KS, VS, lengths,
      k_new[:, None, None], v_new[:, None, None])
  torch.testing.assert_close(ctx, ctx2.reshape(B, NQ, H), rtol=0, atol=0)


def test_block_cuda_path_refuses_what_it_does_not_take(weights):
  """The CUDA path raises (ValueError, nothing counted) on CPU tensors and
  on shapes it does not take; the wrapper never runs it on the CPU."""
  fn = block.fused_mlp_qkv_attention
  before = (fn.launches, fn.plain_calls)
  args = _port_args(weights, 'f32', 0)
  with pytest.raises(ValueError, match='must be a CUDA tensor'):
    block._launch(*args, bf=BF)
  bad = list(args)
  bad[4] = bad[4][:, :-16]  # the down weight of another F
  with pytest.raises(ValueError, match='wd_grouped shape'):
    block._launch(*bad, bf=BF)
  bad = list(args)
  bad[11] = bad[11][:, :-1]  # K pool one row short of the V pool
  with pytest.raises(ValueError, match='pool shapes'):
    block._launch(*bad, bf=BF)
  with pytest.raises(ValueError, match='must divide F'):
    block._launch(*args, bf=384)
  assert (fn.launches, fn.plain_calls) == before
  with pytest.raises(ValueError, match='must divide F'):
    fn(*args, bf=384)  # the plain version's own check
  assert fn.launches == before[0]


# -- Gemma-2B's width -----------------------------------------------------------
# At D 2048 the norm sums 2048 squares. XLA on the CPU sums them in f32 in
# its own order and takes rsqrt; the port sums in f64 and takes 1 / sqrt
# (ops/impl.py `rms_inverse`), which keeps the CUDA kernels equal to the
# plain versions. Either way the mean of squares differs from XLA's by an
# ulp in about half the rows (an f32 mean in PyTorch too: it sums in
# another order), and a DRQ code on a rounding boundary then flips by one. The tests bound what that does at Gemma-2B's width over
# bench.py's 256 decode rows (bf16-rounded and f32 residuals, each row of
# its own scale). Read: 2 and 6 of 4.2M norm codes flipped (f32, bf16
# rows), by one, the scales within 3.5e-7 relative; through the whole
# block 4 (f32) and 6 (bf16) of 256 rows fell outside the toy width's
# agreement, 3 of them with new K/V codes that differ, by at most 2.
GEMMA_D, GEMMA_ROWS, GEMMA_DRAWS = 2048, 256, 8
NORM_FLIPS = 16      # of GEMMA_DRAWS * GEMMA_ROWS * GEMMA_D codes
NORM_RTOL = 5e-7     # the scales, and the RMS_NORM op's output per row max
BLOCK_ROWS_OFF = 12  # rows that may disagree (below), of GEMMA_ROWS


def _gemma_rows(dtype, draws, seed=0):
  """[draws * GEMMA_ROWS, GEMMA_D] residual rows of random scales (f32, or
  f32 rounded to bf16) and a gamma near 1."""
  rng = np.random.default_rng(seed)
  x = (rng.standard_normal((draws * GEMMA_ROWS, GEMMA_D)).astype(np.float32)
       * (rng.random((draws * GEMMA_ROWS, 1)) * 4 + 0.1).astype(np.float32))
  if dtype == 'bf16':
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
  g = (1 + 0.1 * rng.standard_normal(GEMMA_D)).astype(np.float32)
  return x, g


def _rms_norm_op(mod, impl_mod, rows):
  """An OpContext of RMS_NORM (epsilon 1e-6) over [rows, GEMMA_D]."""
  op, sg = op_context(mod, 'RMS_NORM', {'epsilon': 1e-6}, (rows, GEMMA_D),
                      'float32')
  return impl_mod.OpContext(op=op, subgraph=sg, graph=mod.Graph())


def _bf16_steps(a, b):
  """The most bf16 steps between two tensors' entries, rounded to bf16."""
  def ordered(x):
    i = x.to(torch.bfloat16).view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)
  return int(torch.max(torch.abs(ordered(a) - ordered(b))))


def _codes_off(got, want):
  """(codes that differ, largest difference) of two int8 arrays."""
  d = np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32)
  return int(np.count_nonzero(d)), int(np.abs(d).max())


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_norm_codes_match_jax_at_gemma_width(dtype):
  """The block's norm + DRQ (`rmsnorm_quant`) against
  `pallas_block._rmsnorm_quant`, and the RMS_NORM op against the JAX op
  (both outputs quantized by the port's DRQ), at D 2048."""
  x, g = _gemma_rows(dtype, GEMMA_DRAWS)
  rows = x.shape[0]
  jq, js = jax.jit(lambda a, b: pallas_block._rmsnorm_quant(a, b, 1e-6))(
      jnp.asarray(x), jnp.asarray(g))
  tq, ts = block.rmsnorm_quant(torch.from_numpy(x), torch.from_numpy(g), 1e-6)
  flips, worst = _codes_off(tq.numpy(), jq)
  assert flips <= NORM_FLIPS and worst <= 1, (flips, worst)
  np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=NORM_RTOL,
                             atol=0)
  jy = np.array(jax.jit(lambda a, b: jax_impl.OPS['RMS_NORM'](
      _rms_norm_op(jax_ir, jax_impl, rows), a, b))(jnp.asarray(x),
                                                   jnp.asarray(g)))
  ty = impl.OPS['RMS_NORM'](_rms_norm_op(ir, impl, rows), torch.from_numpy(x),
                            torch.from_numpy(g))
  ymax = np.abs(jy).max(axis=1, keepdims=True)
  assert float(np.max(np.abs(ty.numpy() - jy) / ymax)) <= NORM_RTOL
  flips, worst = _codes_off(packed_qmatmul.quantize_rows_drq(ty)[0],
                            packed_qmatmul.quantize_rows_drq(
                                torch.from_numpy(jy))[0])
  assert flips <= NORM_FLIPS and worst <= 1, (flips, worst)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_block_matches_pallas_at_gemma_width(dtype):
  """The plain block against the Pallas block (interpret mode) at D 2048
  over 256 rows, every row at its last cache row (F, NQ, H and S stay
  small). A norm code that flips (above) moves that row's MLP or QKV by
  one weight step, so in a few rows the new K/V codes differ by one or
  two, or x_ffn or ctx by more than the toy width's tolerances; every
  other row must agree within them, and the pools take the port's rows."""
  gb, gf, pos = GEMMA_ROWS, F, S - 1
  rng = np.random.default_rng(1)
  x, g1 = _gemma_rows(dtype, 1, seed=1)
  g2 = (1 + 0.1 * rng.standard_normal(GEMMA_D)).astype(np.float32)
  wgu = rng.integers(-8, 8, (2 * gf, GEMMA_D)).astype(np.int8)
  sgu = (rng.random(2 * gf) * 0.01 + 0.005).astype(np.float32)
  wd = rng.integers(-8, 8, (GEMMA_D, gf)).astype(np.int8)
  sd = (rng.random(GEMMA_D) * 0.01 + 0.005).astype(np.float32)
  wqkv = rng.integers(-8, 8, ((NQ + 2) * H, GEMMA_D)).astype(np.int8)
  sqkv = (rng.random((NQ + 2) * H) * 0.01 + 0.005).astype(np.float32)
  kc = rng.integers(-127, 128, (gb, S, H)).astype(np.int8)
  vc = rng.integers(-127, 128, (gb, S, H)).astype(np.int8)
  lengths = np.full(gb, S, np.int32)
  half = H // 2
  ang = np.float32(pos) * (
      10000.0 ** (-np.arange(0, half, dtype=np.float32) / half))
  cos = np.broadcast_to(np.cos(ang), (gb, half)).astype(np.float32)
  sin = np.broadcast_to(np.sin(ang), (gb, half)).astype(np.float32)
  xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == 'bf16' else jnp.float32)
  ja = jnp.asarray
  jctx, jx, jk, jv, _, _ = pallas_block.fused_mlp_qkv_attention(
      xj, ja(g1), pallas_qmatmul.pack_int4_split(ja(wgu)), ja(sgu),
      pallas_mlp.pack_int4_split_grouped(ja(wd), BF), ja(sd), ja(g2),
      pallas_qmatmul.pack_int4_split(ja(wqkv)), ja(sqkv), ja(cos), ja(sin),
      ja(kc), ja(vc), ja(lengths), jnp.int32(pos), KS, VS, KQS, VQS, NQ,
      eps=1e-6, bf=BF, bb=8, ring=2, writeback=False, interpret=True)
  t = torch.from_numpy
  xt = t(x).to(torch.bfloat16) if dtype == 'bf16' else t(x)
  kp, vp = t(kc.copy()), t(vc.copy())
  ctx, x_ffn, k_new, v_new = block.fused_mlp_qkv_attention(
      xt, t(g1), packed_qmatmul.pack_int4_split(t(wgu)), t(sgu),
      mlp.pack_int4_split_grouped(t(wd), BF), t(sd), t(g2),
      packed_qmatmul.pack_int4_split(t(wqkv)), t(sqkv), t(cos), t(sin), kp,
      vp, t(lengths), pos, KS, VS, KQS, VQS, NQ, bf=BF)
  jk, jv, jctx = np.asarray(jk), np.asarray(jv), np.asarray(jctx)
  jx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
  # Rows that agree as at the toy width: equal codes, ctx within CTX_ATOL,
  # x_ffn within XFFN_RTOL of its largest value (f32) or one bf16 step.
  same = (np.all(k_new.numpy() == jk, axis=1)
          & np.all(v_new.numpy() == jv, axis=1)
          & (np.abs(ctx.numpy() - jctx).max(axis=(1, 2)) <= CTX_ATOL))
  if dtype == 'f32':
    xmax = float(jx.abs().max())
    same &= (np.abs(x_ffn.numpy() - jx.numpy()).max(axis=1)
             <= XFFN_RTOL * xmax)
  else:
    same &= np.array([_bf16_steps(x_ffn[r], jx[r]) <= 1 for r in range(gb)])
  assert int((~same).sum()) <= BLOCK_ROWS_OFF, np.nonzero(~same)[0]
  assert _codes_off(k_new.numpy(), jk)[1] <= 2
  assert _codes_off(v_new.numpy(), jv)[1] <= 2
  np.testing.assert_array_equal(kp.numpy()[:, pos], k_new.numpy())
  np.testing.assert_array_equal(vp.numpy()[:, pos], v_new.numpy())
  np.testing.assert_array_equal(np.delete(kp.numpy(), pos, axis=1),
                                np.delete(kc, pos, axis=1))


# -- executor level -------------------------------------------------------------

SMALL = dict(num_layers=3, max_seq_len=128, embed_dim=512, ffn_dim=2048,
             num_query_heads=2, num_kv_heads=1, head_dim=256,
             vocab_size=4096)
BATCH, START = 8, 64
BLOCK_ENV = (('AEQT_INT4_DRQ', '1'), ('AEQT_ATTN_LENGTHS', '1'),
             ('AEQT_ATTN_WRITEBACK', '1'),
             ('AEQT_ATTN_WRITEBACK_MODE', 'stale'), ('AEQT_MLP_BF', '512'),
             ('AEQT_MLP_FUSION', '1'), ('AEQT_HEAD_FUSION', '1'),
             ('AEQT_DECODE_BLOCK', '1'))
STEP_KERNELS = (block.fused_mlp_qkv_attention,
                attention.decode_attention_int8_lengths_stale,
                mlp.mlp_int4_packed, head.head_argmax,
                packed_qmatmul.qmatmul_int4_packed_drq)


def _inputs(cfg):
  """make_inputs at START with random int8 caches (rows past START are
  never read)."""
  inputs = gemma.make_inputs(cfg, 'decode', BATCH, 1, start_pos=START,
                             device='cpu')
  rng = np.random.default_rng(3)
  out = {}
  for key, val in inputs.items():
    if key.endswith('_cache_in'):
      val = torch.from_numpy(rng.integers(-127, 128, tuple(val.shape))
                             .astype(np.int8))
    out[key] = val
  return out


@pytest.fixture(scope='module')
def small_decode():
  """(port config, port graph, port weights, JAX executor's outputs and
  block count) for the block on both sides, the JAX run made once."""
  jcfg = dataclasses.replace(jax_gemma.GEMMA_2B_LITE, **SMALL)
  tcfg = dataclasses.replace(gemma.GEMMA_2B_LITE, **SMALL)
  kw = dict(batch=BATCH, prefill_len=8, signatures=('decode',),
            materialize_weights=False, fused_projections=True,
            greedy_head=True)
  jgraph = jax_gemma.build_decoder(jcfg, **kw)
  tgraph = gemma.build_decoder(tcfg, **kw)
  jax_gemma.stamp_int8_kv_cache(jgraph)
  gemma.stamp_int8_kv_cache(tgraph)
  jweights, tweights = shared_weights(jgraph, tgraph)
  with pytest.MonkeyPatch.context() as mp:
    for var, val in BLOCK_ENV:
      mp.setenv(var, val)
    jex = jax_executor.GraphExecutor(jgraph, activation_dtype='float32')
    jex._weights = dict(jweights)
    jex.prepare_serving_weights(min_weight_params=0)
    sig = jgraph.signature_by_key('decode')
    inputs = _inputs(tcfg)
    jout = jex._run_signature(
        sig.subgraph_index, 'decode', False, jex._weights,
        {k: jnp.asarray(v.numpy()) for k, v in inputs.items()})
  jout = {k: np.asarray(v) for k, v in jout.items()}
  return tcfg, tgraph, tweights, jout, len(jex._block_fusions)


def _port_run(small_decode, block_on):
  cfg, graph, weights, _, _ = small_decode
  ex = executor.GraphExecutor(graph, device='cpu', activation_dtype='float32',
                              mlp_bf=512, decode_block=block_on)
  ex.load_weights(weights)
  ex.prepare_serving_weights(min_weight_params=0)
  before = [k.plain_calls for k in STEP_KERNELS]
  out = ex(_inputs(cfg), 'decode')
  ran = [k.plain_calls - b for k, b in zip(STEP_KERNELS, before)]
  return ex, out, ran


def test_executor_block_matches_jax(small_decode):
  cfg, _, _, jout, jax_blocks = small_decode
  ex, out, ran = _port_run(small_decode, True)
  assert len(ex._block_fusions) == jax_blocks == cfg.num_layers - 1
  # Per step: a block per layer unit; the first layer's attention, the
  # last layer's MLP, the head, and the layer-0 QKV plus every
  # out-projection as packed matmuls.
  assert ran == [cfg.num_layers - 1, 1, 1, 1, 1 + cfg.num_layers]
  assert sorted(out) == sorted(jout)
  np.testing.assert_array_equal(out['next_tokens'].numpy(),
                                jout['next_tokens'])
  for key, val in out.items():
    if key.endswith('_cache'):
      np.testing.assert_array_equal(val.numpy(), jout[key], err_msg=key)


def test_executor_block_on_equals_off_at_f32(small_decode):
  _, on, ran_on = _port_run(small_decode, True)
  ex_off, off, ran_off = _port_run(small_decode, False)
  assert not ex_off._block_fusions and ran_off[0] == 0 and ran_on[0] > 0
  assert sorted(on) == sorted(off)
  for key in on:
    torch.testing.assert_close(on[key], off[key], rtol=0, atol=0, msg=key)


def test_executor_block_leaves_its_inputs_alone(small_decode):
  cfg, graph, weights, _, _ = small_decode
  ex = executor.GraphExecutor(graph, device='cpu', activation_dtype='float32',
                              mlp_bf=512)
  ex.load_weights(weights)
  ex.prepare_serving_weights(min_weight_params=0)
  inputs = _inputs(cfg)
  kept = {k: v.clone() for k, v in inputs.items()}
  out = ex(inputs, 'decode')
  for key, val in inputs.items():
    torch.testing.assert_close(val, kept[key], rtol=0, atol=0, msg=key)
  # The new rows went into the outputs' pools (row START of every row).
  for li in range(1, cfg.num_layers):
    cache = out[f'layer_{li}_k_cache']
    assert not torch.equal(cache[:, :, START], kept[f'layer_{li}_k_cache_in'][
        :, :, START])
