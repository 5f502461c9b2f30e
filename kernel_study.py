#!/usr/bin/env python3
"""Measurements behind the port's redesigned kernels, on one NVIDIA GPU.
Each prints one JSON line per measurement.

  python3 kernel_study.py [--root CHECKOUT] [--kernels K,...] [--reps N]
                          STUDY [STUDY ...]

--root picks the checkout whose kernels (and chip_smoke.py) run (default:
this file's), so two checkouts can be timed in turns on one card, one
process each. --kernels picks the groups that `times` and `launches`
cover (default: all seven). Times are CUDA-event medians of --reps calls as
chip_smoke.Timer takes them (L2 flushed before each).

Kernel groups of `times`:
  mlp          #3 (kernels/mlp.py): the DRQ branch (bf 2048 and 512) and
               the weight-only branch with bf16 x (bf 512 and 2048) at a
               decode tick's rows (M 64), a bench step's (256) and a
               prefill pass's (1024), GEMMA_2B widths (D 2048, F 16384),
               gelu; #22 (decode_attention_int8) at B 64 and 256 (S 1024,
               random lengths with rows 0, 1 and S: chip_smoke.
               int8_basic_kernel's inputs).
  attention    the split-S core (csrc/attention_split_tc.cuh): #7 at the
               server's tick (B 64, random lengths) and at bench.py's
               decode (B 256, 897 rows), every compute mode, bf16 out; #2
               at B 64 (random lengths, rows 1 and S) and at bench.py's
               decode (897 long: 896 stale rows), #8 at pos 896 with
               lengths 897 at both batches, every compute mode, bf16 out;
               #10 at bench.py's decode and the server's tick; #21 at the
               A/B tool's shape (B 256, lengths S - 2) and at B 64 with
               lengths 0..S, f32 out.
  block        #5 (block.fused_mlp_qkv_attention) at bench.py's decode
               step (GEMMA_2B widths, B 256, S 1024, every row 897 long,
               pos 896, bf 2048) in every compute mode with f32 and with
               bf16 x; #4 (head.head_argmax, DRQ) on the tied int8 head
               and a packed int4 one (N 256128, K 2048) at M 64 and 256,
               bf16 x.
  fusion       #14 (packed_qmatmul.qmatmul_int4_packed_rmsnorm) at the norm
               fusion's shapes (K 2048; the QKV, N 2560, and the gate/up,
               N 32768) at M 256 (a bench step) and 64 (a decode tick),
               bf16 x, beside the unfused RMS_NORM op + #12 and #12 alone on
               rows normalized beforehand; #19 (attention.
               decode_attention_oproj) at bench.py's decode (B 256, every
               row 897 long) and at B 64, DRQ in every compute mode and
               weight-only in f32, bf16 x_res, beside #7 + #1 (or #12) +
               the residual ADD and #7 + #1 (or #12) alone.
  prologue     #20 (qkv.qkv_rope) at bench.py's attention-block shape (D
               2048, 8 query heads and 1 KV head of 256, N 2560, bf16 x) at
               M 256 (a bench step) and 64 (a decode tick), DRQ and
               weight-only, beside #1 (packed_qmatmul.qmatmul_int4_packed_
               drq) on rows normalized beforehand and #14's QKV chain (the
               norm + #12's core, qmatmul_int4_packed_rmsnorm at N 2560);
               #4's weight-only branch (head.head_argmax_bf16) on a packed
               int4 and an int8 head (N 256128, K 2048, true_n N - 64) at M
               64 and 256, bf16 x, beside the library composition
               (torch.matmul of x against the bf16-dequantized weights,
               * s, the cast, torch.argmax).
  cache        #11 (cache.dus_row_inplace) at bench.py's decode shape (a
               [256, 1, 1024, 256] int8 pool, row 896) beside its launch
               floor (cache.launch_floor, an empty kernel launched the same
               way; a checkout without it times the kernel alone) and one
               slice assignment; also 36 launches in a row, as an in-place
               step makes them, timed together (chain_ms, a launch).
  int_weights  #16 (int_qmatmul.qmatmul_int_weights) at chip_smoke.
               int_weight_kernels' rows: gemma_mixed48_b32's blockwise-32
               FCs at decode (M 64: gate/up N 32768 at K 2048, down N 2048
               at K 16384, head N 256128 at K 2048) and at a prefill pass's
               rows (M 1024; the head 8 rows), and the channelwise branch
               at M 64, N 2048, K 2048 beside torch.matmul on f32 weights;
               each with bf16 x and full-mantissa f32 x.

Studies:
  times     the rows of the groups above.
  launches  the device time of each launch of one call at the `mlp`,
            `block`, `fusion` and `prologue` rows of --kernels (`fusion`
            with the unfused kernels each replaces; torch.profiler, the
            mean of 5
            calls each after an L2 flush: device_us a launch of each
            kernel, device_us_per_call its launches' sum in one call).
  host      the host time of one #3 call at decode (M 64, bf 2048 and
            512, both branches): the wrapper's Python, its allocations and
            every launch it enqueues, with the card kept busy so that no
            call waits for it (the median over 5 rounds of 50 calls).
  server    chip_smoke.quantizer_phase for examples/serve_gemma.py's
            default mode alone (serve_gemma's quantization at
            chip_smoke.QUANT_LAYERS, served by DecodeServer with the JAX
            executor's default options: #12, #3's and #4's weight-only
            branches, #17): a chunk of 8 ticks' wall and device busy time
            (torch.profiler) and the head's device time a chunk, one
            process a checkout.
  steps     bench.py's decode through chip_smoke.bench_decode_phase under
            --settings (default: the block on, the block off, the in-place
            writes, the norm fusion and the attention block; ms a step,
            host clock, median
            of chip_smoke's timed
            steps; the device's busy time and idle share by
            torch.profiler), one process a checkout.
  order     the share of the split core's plain versions' f32 matmul
            outputs on the card (#7's q . k, #10's q . K and its offset
            term, #21's two half dots as its plain version slices them,
            #2's one-column q . k_new) equal to one f32 FMA chain over the
            contraction in increasing order; for #2's q . k_new also the
            share equal to the kernel's order (new_column_order in the
            header) at R 1, 64, 65 and 256.
  truth     #7's f32 context at B 64 (chip_smoke.lengths_kernel's inputs,
            eight seeds) against an f64 run of the same function, for the
            plain version and the kernel, and the two against each other.
  variants  copies of this checkout's csrc/ with one edit each, built
            under kernels/_build/variants/ and timed with the unchanged
            kernel built the same way, in turns, for the groups of
            --kernels that have variants. int_weights: at #16's decode
            rows with bf16 x, one part of the bs-32 decode loop taken out
            (wrong results, for the time only): 'no_flush' (y + p * s left
            out, and with it the scale loads), 'no_scale_load' (the block
            scales a constant, the flush kept), 'no_widen' (constant A
            fragments: no shared-memory read or widening of the weights)
            and 'stream' (no widening, no wgmma, no flush: the consumers
            only release the stages, so the ring's stream of weight and x
            tiles alone sets the time). mlp: 'vsub4', the int8 core's
            split-half unpack with drq_common.cuh's nib_lo / nib_hi
            (__vsub4) in place of sign_extend_nibbles (the same bytes),
            at #3's DRQ rows (bf 2048), #1's QKV shape (N 2560, K 2048)
            and #6's down shape (N 2048, K 16384) at M 64 and 1024.
            prologue: at #20's rows (bf16 x, M 256 and 64; DRQ, and
            weight-only at 256) and #4's weight-only head (packed M 64 and
            256, int8 M 64): 'norm_then_quantize' (#20's DRQ route as the
            norm launch, then #1's row quantize as a dependent launch,
            then the pair tile, in place of the norm that ends in the
            codes), 'pairs_nt128' (#20's weight-only pair tile at
            ChannelScale's 128 tokens for two warpgroups, in place of
            64), 'head_sub1' (#4's weight-only ring stage at one 64-byte
            K step of the weight rows, in place of two), 'head_r4' (four
            token tiles a pass above 64 rows, in place of passes of two),
            and, wrong ids for the time only, 'head_no_widen'
            (constant A fragments), 'head_stream' (no widening, no wgmma)
            and 'head_half_x' (the x tiles loaded at every other stage
            only: half the x bytes from L2); each variant's ptxas
            registers, spills and wgmma serialization notes are emitted
            with its times.
"""

import argparse
import functools
import json
import pathlib
import re
import statistics
import sys
import time

D, F, V = 2048, 16384, 256128
MLP_ROWS = (64, 256, 1024)
B, S, H, G = 64, 1024, 256, 8
BENCH_B, BENCH_ROWS = 256, 897
K_SCALE, V_SCALE, ZP_K, ZP_V = 0.06, 0.06, 3.0, -2.0
PREFILL_ROWS, PREFILL_BATCH, QUANT_BLOCK = 1024, 8, 32
GROUPS = ('mlp', 'attention', 'block', 'fusion', 'prologue', 'int_weights',
          'cache')
# The kernel libraries each group and study builds (steps: every one).
SOURCES = {
    'mlp': ('mlp_int4_drq', 'mlp_int4_bf16', 'attention_int8_basic'),
    'attention': ('attention_lengths', 'attention_stale',
                  'attention_writeback', 'attention_int4_group',
                  'attention_int4_row'),
    'block': ('fused_block', 'head_argmax'),
    'fusion': ('qmatmul_int4_rmsnorm', 'attention_oproj',
               'qmatmul_int4_weight_only', 'qmatmul_int4_drq',
               'attention_lengths'),
    'prologue': ('qkv_rope', 'head_argmax', 'qmatmul_int4_rmsnorm',
                 'qmatmul_int4_drq'),
    'int_weights': ('qmatmul_int_weights',),
    'cache': ('cache_row_write',)}
STUDY_GROUP = {'host': 'mlp', 'order': 'attention', 'truth': 'attention'}
STEP_SETTINGS = ('block on', 'block off', 'inplace', 'norm fusion',
                 'attn block')


def emit(**row):
  print(json.dumps(row), flush=True)


# ------------------------------------------------------------------- #3, #22


def mlp_cases(torch, mods, rows=MLP_ROWS, bfs=None):
  """(key, call) of each #3 case; weights from one seed."""
  mlp, pq = mods['mlp'], mods['pq']
  gen = torch.Generator(device='cuda').manual_seed(3)

  def randint(*shape):
    return torch.randint(-8, 8, shape, generator=gen, device='cuda').to(
        torch.int8)

  def scales(n):
    return torch.rand((n,), generator=gen, device='cuda') * 0.01 + 0.005

  wgu, sgu, sd = pq.pack_int4_split(randint(2 * F, D)), scales(2 * F), \
      scales(D)
  wd_q = randint(D, F)
  cases = []
  for drq, branch_bfs in ((True, (2048, 512)), (False, (512, 2048))):
    for bf in bfs or branch_bfs:
      wd = mlp.pack_int4_split_grouped(wd_q, bf)
      for m in rows:
        x = torch.randn((m, D), generator=gen, device='cuda').to(
            torch.bfloat16)
        fn = mlp.mlp_int4_packed if drq else mlp.mlp_int4_packed_bf16
        cases.append(({'kernel': 'mlp_int4_packed' if drq
                       else 'mlp_int4_packed_bf16', 'bf': bf, 'M': m},
                      lambda fn=fn, x=x, wd=wd, bf=bf: fn(x, wgu, sgu, wd,
                                                          sd, bf=bf)))
  return cases


def basic_cases(torch, att):
  gen = torch.Generator(device='cuda').manual_seed(22)
  cases = []
  for b in (64, 256):
    q = torch.randn((b, 1, G, H), generator=gen, device='cuda')
    kc, vc = (torch.randint(-127, 128, (b, 1, S, H), generator=gen,
                            device='cuda').to(torch.int8) for _ in range(2))
    lengths = torch.randint(0, S + 1, (b,), generator=gen,
                            device='cuda').to(torch.int32)
    lengths[0], lengths[1], lengths[2] = 0, 1, S
    args = (q, kc, vc, 0.06, 0.05, lengths)
    cases.append(({'kernel': 'decode_attention_int8', 'B': b},
                   lambda args=args: att.decode_attention_int8(*args)))
  return cases


def mlp_times(torch, mods, timer):
  for key, call in (mlp_cases(torch, mods)
                    + basic_cases(torch, mods['att'])):
    call()
    emit(study='times', **key, ms=timer(call))


def launches(torch, mods, timer, calls=5):
  flush = torch.empty(128 * 2**20, dtype=torch.uint8, device='cuda')
  cases = [c for g in mods['groups'] if g in LAUNCH_CASES
           for c in LAUNCH_CASES[g](torch, mods)]
  for key, call in cases:
    for _ in range(3):
      call()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
      for _ in range(calls):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        call()
      torch.cuda.synchronize()
    per, per_call = {}, {}
    for e in prof.key_averages():
      if 'sleep' in e.key or 'spin' in e.key or 'zero' in e.key \
          or 'fill' in e.key.lower():
        continue
      us = getattr(e, 'device_time', 0) or 0
      if us:
        name = e.key.replace('(anonymous namespace)::', '').split('(')[0]
        per[name[:80]] = round(us, 3)
        per_call[name[:80]] = round(
            (getattr(e, 'device_time_total', 0) or 0) / calls, 3)
    emit(study='launches', **key, device_us=per, device_us_per_call=per_call,
         total_us_per_call=round(sum(per_call.values()), 3))


def host(torch, mods, timer, calls=50, rounds=5):
  for key, call in mlp_cases(torch, mods, rows=(64,), bfs=(2048, 512)):
    for _ in range(3):
      call()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
      torch.cuda._sleep(200_000_000)  # longer than the calls' enqueueing
      t0 = time.perf_counter()
      for _ in range(calls):
        call()
      per_call.append((time.perf_counter() - t0) / calls * 1e6)
      torch.cuda.synchronize()
    emit(study='host', **key, host_us=statistics.median(per_call),
         rounds_us=[round(t, 3) for t in per_call])


def steps(torch, mods, timer):
  """chip_smoke's bench decode phase under STEP_SETTINGS only."""
  cs = mods['cs']
  from ai_edge_quantizer_tpu_torch.execution import executor
  from ai_edge_quantizer_tpu_torch.kernels import block, cache, head
  from ai_edge_quantizer_tpu_torch.kernels import qkv
  from ai_edge_quantizer_tpu_torch.models import gemma
  att, pq = mods['att'], mods['pq']
  wrappers = {
      'fused_mlp_qkv_attention': block.fused_mlp_qkv_attention,
      'decode_attention_int8_lengths_stale':
          att.decode_attention_int8_lengths_stale,
      'decode_attention_int8_lengths': att.decode_attention_int8_lengths,
      'decode_attention_oproj': att.decode_attention_oproj,
      'mlp_int4_packed': mods['mlp'].mlp_int4_packed,
      'head_argmax': head.head_argmax,
      'qmatmul_int4_packed_drq': pq.qmatmul_int4_packed_drq,
      'qmatmul_int4_packed_drq_kblock': pq.qmatmul_int4_packed_drq_kblock,
      'qmatmul_int4_packed_rmsnorm': pq.qmatmul_int4_packed_rmsnorm,
      'dus_row_inplace': cache.dus_row_inplace, 'qkv_rope': qkv.qkv_rope}
  kernels = [{'name': n, 'wrapper': w} for n, w in wrappers.items()]
  cs.sync = torch.cuda.synchronize
  cs.BENCH_SETTINGS = {k: cs.BENCH_SETTINGS[k] for k in mods['settings']}
  cs.MODE_SETTINGS = {}
  results = cs.bench_decode_phase(
      torch, {'gemma': gemma, 'executor': executor}, kernels,
      gemma.GEMMA_2B, 'cuda')
  for label in mods['settings']:
    r = results[label]
    emit(study='steps', setting=label, ms_per_step=r['ms_per_step'],
         step_ms=r['step_ms'],
         device_busy_ms_per_step=r['device_busy_ms_per_step'],
         device_idle_share=r['device_idle_share'])


def server(torch, mods, timer):
  """chip_smoke's quantizer phase for the default-mode server alone."""
  cs = mods['cs']
  from ai_edge_quantizer_tpu_torch import Quantizer
  from ai_edge_quantizer_tpu_torch.execution import executor
  from ai_edge_quantizer_tpu_torch.graph import ir, serialize
  from ai_edge_quantizer_tpu_torch.kernels import head
  from ai_edge_quantizer_tpu_torch.models import gemma
  from ai_edge_quantizer_tpu_torch.parallel import batching
  from ai_edge_quantizer_tpu_torch.utils import progress_utils
  att, mlp, pq = mods['att'], mods['mlp'], mods['pq']
  port = dict(executor=executor, gemma=gemma, batching=batching, ir=ir,
              serialize=serialize, Quantizer=Quantizer,
              progress_utils=progress_utils, head=head, _build=mods['build'])
  wrappers = {
      'qmatmul_int4_packed': pq.qmatmul_int4_packed,
      'mlp_int4_packed_bf16': mlp.mlp_int4_packed_bf16,
      'head_argmax_bf16': head.head_argmax_bf16,
      'decode_attention_int8_masked': att.decode_attention_int8_masked,
      'flash_attention_int8_masked': att.flash_attention_int8_masked}
  kernels = [{'name': n, 'wrapper': w} for n, w in wrappers.items()]
  cs.sync = torch.cuda.synchronize
  cs.QUANT_RECIPES = (cs.DEFAULT_MODE,)
  cs.default_mode_servers = lambda *args, **kw: {}
  r = cs.quantizer_phase(torch, port, kernels, gemma.GEMMA_2B, 'cuda')[
      cs.DEFAULT_MODE]
  emit(study='server', recipe=cs.DEFAULT_MODE, layers=r['layers'],
       chunk_ms=r['chunk_ms'], chunk_device_busy_ms=r['chunk_device_busy_ms'],
       chunk_idle_share=r['chunk_idle_share'],
       head_ms_a_chunk=sum(ms for name, ms in r['chunk_by_kernel'].items()
                           if 'head_' in name),
       tokens_per_s=r['tokens_per_s'])


# ------------------------------------------------------------------- #5, #4


def block_cases(torch, mods):
  """(key, call) of each #5 and #4 case (see the `block` group)."""
  from ai_edge_quantizer_tpu_torch.kernels import block, head
  from ai_edge_quantizer_tpu_torch.ops import impl
  mlp, pq = mods['mlp'], mods['pq']
  gen = torch.Generator(device='cuda').manual_seed(5)

  def randint(lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device='cuda').to(
        torch.int8)

  def scales(n):
    return torch.rand((n,), generator=gen, device='cuda') * 0.01 + 0.005

  nq, bf, n = G, 2048, (G + 2) * H
  x32 = torch.randn((BENCH_B, D), generator=gen, device='cuda')
  g1, g2 = (1.0 + 0.1 * torch.randn((D,), generator=gen, device='cuda')
            for _ in range(2))
  wgu, sgu = pq.pack_int4_split(randint(-8, 8, 2 * F, D)), scales(2 * F)
  wd, sd = mlp.pack_int4_split_grouped(randint(-8, 8, D, F), bf), scales(D)
  wqkv, sqkv = pq.pack_int4_split(randint(-8, 8, n, D)), scales(n)
  kc, vc = (randint(-127, 128, BENCH_B, S, H) for _ in range(2))
  ang = (float(BENCH_ROWS - 1) * impl.rope_freqs(10000.0, H // 2, 'cuda')
         ).reshape(1, H // 2).expand(BENCH_B, H // 2)
  cos, sin = torch.cos(ang).contiguous(), torch.sin(ang).contiguous()
  lengths = torch.full((BENCH_B,), BENCH_ROWS, dtype=torch.int32,
                       device='cuda')
  # The write position on the device, as the executor passes it.
  pos = torch.tensor(BENCH_ROWS - 1, dtype=torch.int32, device='cuda')
  cases = []
  for compute in ('f32', 'bf16', 'int8'):
    for xname, x in (('f32', x32), ('bf16', x32.to(torch.bfloat16))):
      args = (x, g1, wgu, sgu, wd, sd, g2, wqkv, sqkv, cos, sin, kc, vc,
              lengths, pos, 0.06, 0.06, 0.06, 0.06, nq)
      cases.append(({'kernel': 'fused_mlp_qkv_attention', 'B': BENCH_B,
                     'compute': compute, 'x': xname},
                    lambda args=args, compute=compute:
                    block.fused_mlp_qkv_attention(*args, bf=bf,
                                                  compute=compute)))
  w8, s8 = randint(-127, 128, V, D), scales(V)
  w4, s4 = pq.pack_int4_split(randint(-8, 8, V, D)), scales(V)
  for packed, w, s in ((False, w8, s8), (True, w4, s4)):
    for m in (64, 256):
      x = torch.randn((m, D), generator=gen, device='cuda').to(torch.bfloat16)
      cases.append(({'kernel': 'head_argmax', 'packed': packed, 'M': m},
                    lambda x=x, w=w, s=s, packed=packed:
                    head.head_argmax(x, w, s, packed=packed)))
  return cases


def block_times(torch, mods, timer):
  for key, call in block_cases(torch, mods):
    call()
    emit(study='times', **key, ms=timer(call))


# ------------------------------------------------------------ #14, #19


def fusion_cases(torch, mods, unfused=False):
  """(key, call) of each #14 and #19 case (see the `fusion` group); with
  `unfused` also the unfused kernels each replaces."""
  cs, att, pq = mods['cs'], mods['att'], mods['pq']
  from ai_edge_quantizer_tpu_torch.ops import impl
  gen = torch.Generator(device='cuda').manual_seed(14)
  bf16 = torch.bfloat16

  def randint(lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device='cuda').to(
        torch.int8)

  def scales(n):
    return torch.rand((n,), generator=gen, device='cuda') * 0.01 + 0.005

  cases = []
  gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device='cuda')
  for label, n in (('qkv', (G + 2) * H), ('gate_up', 2 * F)):
    w, s = pq.pack_int4_split(randint(-8, 8, n, D)), scales(n)
    for m in (BENCH_B, B):
      x = (torch.randn((m, D), generator=gen, device='cuda') * 3).to(bf16)
      key = {'kernel': 'qmatmul_int4_packed_rmsnorm', 'shape': label, 'M': m}
      cases.append((key, lambda x=x, w=w, s=s:
                    pq.qmatmul_int4_packed_rmsnorm(x, gamma, w, s)))
      if unfused:
        xn = cs.rmsnorm_unfused(torch, impl, x, gamma)
        cases.append((dict(key, kernel='RMS_NORM op + #12'),
                      lambda x=x, w=w, s=s: pq.qmatmul_int4_packed(
                          cs.rmsnorm_unfused(torch, impl, x, gamma), w, s)))
        cases.append((dict(key, kernel='#12 on normalized rows'),
                      lambda xn=xn, w=w, s=s: pq.qmatmul_int4_packed(
                          xn, w, s)))
  wo, so = pq.pack_int4_split(randint(-8, 8, D, G * H)), scales(D)
  for b in (BENCH_B, B):
    q = torch.randn((b, 1, G, H), generator=gen, device='cuda').to(bf16)
    kc, vc = (randint(-127, 128, b, 1, S, H) for _ in range(2))
    x = torch.randn((b, D), generator=gen, device='cuda').to(bf16)
    lengths = torch.full((b,), BENCH_ROWS, dtype=torch.int32, device='cuda')
    args = (q, kc, vc, K_SCALE, V_SCALE, lengths, x, wo, so, ZP_K, ZP_V)
    for compute, drq in (('f32', True), ('bf16', True), ('int8', True),
                         ('f32', False)):
      key = {'kernel': 'decode_attention_oproj', 'B': b, 'compute': compute,
             'drq': drq}
      cases.append((key, lambda args=args, compute=compute, drq=drq:
                    att.decode_attention_oproj(*args, compute=compute,
                                               drq=drq)))
      if unfused:
        proj = pq.qmatmul_int4_packed_drq if drq else pq.qmatmul_int4_packed

        def kernels(args=args, compute=compute, proj=proj, b=b):
          ctx = att.decode_attention_int8_lengths(
              *args[:6], ZP_K, ZP_V, compute=compute, out_dtype=bf16)
          return proj(ctx.reshape(b, G * H), wo, so)

        cases.append((dict(key, kernel='#7 + projection + ADD'),
                      lambda x=x, kernels=kernels: x + kernels()))
        cases.append((dict(key, kernel='#7 + projection'), kernels))
  return cases


def fusion_times(torch, mods, timer):
  for key, call in fusion_cases(torch, mods, unfused=True):
    call()
    emit(study='times', **key, ms=timer(call))


# ------------------------------------------------------------ #20, #4 bf16


def prologue_cases(torch, mods, unfused=False):
  """(key, call) of each #20 and #4 weight-only case (see the `prologue`
  group); with `unfused` also what each is held against."""
  cs, pq = mods['cs'], mods['pq']
  from ai_edge_quantizer_tpu_torch.kernels import head, qkv
  from ai_edge_quantizer_tpu_torch.ops import impl
  gen = torch.Generator(device='cuda').manual_seed(20)
  bf16 = torch.bfloat16
  n = (G + 2) * H
  w = pq.pack_int4_split(torch.randint(-8, 8, (n, D), generator=gen,
                                       device='cuda').to(torch.int8))
  s = torch.rand((n,), generator=gen, device='cuda') * 0.01 + 0.005
  gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device='cuda')
  cases = []
  for m in (BENCH_B, B):
    x = (torch.randn((m, D), generator=gen, device='cuda') * 3).to(bf16)
    pos = torch.randint(BENCH_ROWS - 64, BENCH_ROWS + 64, (m, 1),
                        generator=gen, device='cuda')
    cos, sin = qkv.rope_cos_sin(pos, H, 10000.0)
    for drq in (True, False):
      key = {'kernel': 'qkv_rope', 'M': m, 'drq': drq}
      cases.append((key, lambda x=x, cos=cos, sin=sin, drq=drq: qkv.qkv_rope(
          x, gamma, w, s, cos, sin, nq=G, nk=1, h=H, drq=drq)))
    if unfused:
      xn = cs.rmsnorm_unfused(torch, impl, x, gamma)
      cases.append(({'kernel': '#1 on normalized rows', 'M': m},
                    lambda xn=xn: pq.qmatmul_int4_packed_drq(xn, w, s)))
      cases.append(({'kernel': "#14's QKV chain", 'M': m},
                    lambda x=x: pq.qmatmul_int4_packed_rmsnorm(
                        x, gamma, w, s)))
  for packed in (True, False):
    lo, hi = (-8, 8) if packed else (-127, 128)
    w_q = torch.randint(lo, hi, (V, D), generator=gen, device='cuda').to(
        torch.int8)
    wh = pq.pack_int4_split(w_q) if packed else w_q
    sh = torch.rand((V,), generator=gen, device='cuda') * 0.01 + 0.005
    wdq = w_q.to(bf16) if unfused else None
    del w_q
    for m in (B, BENCH_B):
      x = torch.randn((m, D), generator=gen, device='cuda').to(bf16)
      key = {'kernel': 'head_argmax_bf16', 'packed': packed, 'M': m}
      cases.append((key, lambda x=x, wh=wh, sh=sh, packed=packed:
                    head.head_argmax_bf16(x, wh, sh, packed=packed,
                                          true_n=V - 64)))
      if unfused:
        def library(x=x, wdq=wdq, sh=sh):
          y = (torch.matmul(x, wdq.T) * sh).to(bf16)
          y[:, V - 64:] = -3.4e38
          return torch.argmax(y, dim=-1)
        cases.append((dict(key, kernel='library composition'), library))
  return cases


def prologue_times(torch, mods, timer):
  for key, call in prologue_cases(torch, mods, unfused=True):
    call()
    emit(study='times', **key, ms=timer(call))


# ------------------------------------------------------ the split-S core


def attention_times(torch, mods, timer):
  att, cs = mods['att'], mods['cs']
  gen = torch.Generator(device='cuda').manual_seed(7)
  kw = dict(k_zero_point=ZP_K, v_zero_point=ZP_V, out_dtype=torch.bfloat16)

  def lengths_for(b):
    if b == B:
      return torch.randint(1, S + 1, (b,), generator=gen, device='cuda').to(
          torch.int32)
    return torch.full((b,), BENCH_ROWS, dtype=torch.int32, device='cuda')

  for b in (B, BENCH_B):
    q = torch.randn((b, 1, G, H), generator=gen, device='cuda').to(
        torch.bfloat16)
    kc, vc = (torch.randint(-127, 128, (b, 1, S, H), generator=gen,
                            device='cuda').to(torch.int8) for _ in range(2))
    lens = lengths_for(b)
    for mode in ('f32', 'bf16', 'int8'):
      emit(kernel='decode_attention_int8_lengths', B=b, compute=mode,
           ms=timer(lambda: att.decode_attention_int8_lengths(
               q, kc, vc, K_SCALE, V_SCALE, lens, compute=mode, **kw)))
  for b in (B, BENCH_B):
    q = torch.randn((b, 1, G, H), generator=gen, device='cuda').to(
        torch.bfloat16)
    kc, vc = (torch.randint(-127, 128, (b, 1, S, H), generator=gen,
                            device='cuda').to(torch.int8) for _ in range(2))
    kn, vn = (torch.randint(-127, 128, (b, 1, 1, H), generator=gen,
                            device='cuda').to(torch.int8) for _ in range(2))
    if b == B:
      lens = torch.randint(1, S + 1, (b,), generator=gen, device='cuda').to(
          torch.int32)
      lens[0], lens[1] = 1, S
    else:
      lens = torch.full((b,), BENCH_ROWS, dtype=torch.int32, device='cuda')
    rows = torch.full((b,), BENCH_ROWS, dtype=torch.int32, device='cuda')
    pos = torch.tensor([BENCH_ROWS - 1], dtype=torch.int32, device='cuda')
    for mode in ('f32', 'bf16', 'int8'):
      emit(kernel='decode_attention_int8_lengths_stale', B=b, compute=mode,
           ms=timer(lambda: att.decode_attention_int8_lengths_stale(
               q, kc, vc, K_SCALE, V_SCALE, lens, kn, vn, compute=mode,
               **kw)))
      emit(kernel='decode_attention_int8_lengths_writeback', B=b,
           compute=mode,
           ms=timer(lambda: att.decode_attention_int8_lengths_writeback(
               q, kc, vc, K_SCALE, V_SCALE, rows, kn, vn, pos, compute=mode,
               **kw)))
  for b in (BENCH_B, B):
    q = torch.randn((b, 1, G, H), generator=gen, device='cuda').to(
        torch.bfloat16)
    kp, vp, sc = cs.int4g_pools(torch, att, b, 1, S, H, gen, 'cuda')
    lens = lengths_for(b)
    emit(kernel='decode_attention_int4_group_lengths', B=b,
         ms=timer(lambda: att.decode_attention_int4_group_lengths(
             q, kp, vp, sc, lens, 16, out_dtype=torch.bfloat16)))
  from ai_edge_quantizer_tpu_torch.tools import attn_int4_bench as tool
  for b, seed in ((BENCH_B, 1), (B, 2)):
    ops = tool.make_operands(b, S, H, seed=seed, device='cuda')
    lens = ops['lengths']
    if b == B:
      lens = torch.randint(0, S + 1, (b,), generator=gen, device='cuda').to(
          torch.int32)
      lens[0], lens[1], lens[2] = 0, 1, S
    args = (ops['q'], ops['kp_r'], ops['vp_r'], ops['scales_r'], lens)
    emit(kernel='decode_attention_int4_lengths', B=b,
         ms=timer(lambda: att.decode_attention_int4_lengths(*args)))


def chain(torch, a, b):
  """a [..., M, K] . b [..., N, K] as one f32 FMA chain over k = 0 .. K - 1
  (each step exact in f64, rounded once)."""
  acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), device=a.device)
  for k in range(a.shape[-1]):
    acc = (acc.double() + a[..., k:k + 1].double()
           * b[..., k].double()[..., None, :]).float()
  return acc


def new_column(torch, a, b, r):
  """a [..., G, H] . b [..., 1, H] -> [..., G] in the stale kernel's order
  of the new column at R = r rows (attention_split_tc.cuh
  new_column_order): `parts` f32 FMA chains, then added as a butterfly or
  in order."""
  h = a.shape[-1]
  if r == 1:
    parts, strided, butterfly = 32, False, True
  elif r <= 64:
    parts, strided, butterfly = min(16, h // 8), False, True
  elif h == 64:
    parts, strided, butterfly = 4, True, True
  else:
    parts, strided, butterfly = 16, True, False
  n = h // parts
  idx = torch.tensor([[l + parts * i if strided else l * n + i
                       for i in range(n)] for l in range(parts)],
                     device=a.device)
  x = a[..., idx].double()              # [..., G, parts, n]
  y = b[..., 0, :][..., idx].double()   # [..., parts, n]
  acc = torch.zeros(x.shape[:-1], device=a.device)
  for i in range(n):
    acc = (acc.double() + x[..., i] * y[..., None, :, i]).float()
  if butterfly:
    while acc.shape[-1] > 1:
      half = acc.shape[-1] // 2
      acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]
  total = acc[..., 0]
  for l in range(1, parts):
    total = total + acc[..., l]
  return total


def order(torch, mods, timer):
  att = mods['att']
  gen = torch.Generator(device='cuda').manual_seed(0)
  for b in (B, BENCH_B):
    q = torch.randn((b, 1, G, H), generator=gen, device='cuda').to(
        torch.bfloat16).float()
    k8 = torch.randint(-127, 128, (b, 1, S, H), generator=gen,
                       device='cuda').to(torch.int8).float()
    kb = torch.randn((b, 1, S, H), generator=gen, device='cuda').to(
        torch.bfloat16).float()
    qs = torch.randn((b, 1, G, 16), generator=gen, device='cuda') * 3
    kmin = torch.randn((b, 1, 16, S), generator=gen, device='cuda').to(
        torch.bfloat16).float()
    # #21's operands as its plain version forms them: the unpacked codes
    # [..., S, H] f32, both sliced at H / 2 (strided views).
    k4 = att.unpack_int4_rows(torch.randint(
        0, 256, (b, 1, S, H // 2), generator=gen, device='cuda').to(
            torch.uint8)).to(torch.float32)
    h2 = H // 2
    for what, x, y, mm in (
        ('#7 q . k', q, k8, torch.matmul(q, k8.transpose(-1, -2))),
        ('#10 q . K', q, kb, torch.matmul(q, kb.transpose(-1, -2))),
        ('#10 offset', qs, kmin.transpose(-1, -2), torch.matmul(qs, kmin)),
        ('#21 q lo . k lo', q[..., :h2], k4[..., :h2],
         att._qdot(q[..., :h2], k4[..., :h2])),
        ('#21 q hi . k hi', q[..., h2:], k4[..., h2:],
         att._qdot(q[..., h2:], k4[..., h2:]))):
      emit(study='order', B=b, matmul=what,
           share_equal_to_chain=float((chain(torch, x, y) == mm).double()
                                      .mean()))
  # #2's new column: the plain version's [G, H] . [H, 1] matmul per row.
  for b in (1, B, B + 1, BENCH_B):
    q = torch.randn((b, 1, G, H), generator=gen, device='cuda').to(
        torch.bfloat16).float()
    kn = torch.randint(-127, 128, (b, 1, 1, H), generator=gen,
                       device='cuda').to(torch.int8).float()
    mm = att._qdot(q, kn)[..., 0]
    emit(study='order', B=b, matmul='#2 q . k_new',
         share_equal_to_chain=float((chain(torch, q, kn)[..., 0] == mm)
                                    .double().mean()),
         share_equal_to_kernel=float((new_column(torch, q, kn, b) == mm)
                                     .double().mean()))


def truth(torch, mods, timer):
  att = mods['att']
  kw = dict(k_zero_point=ZP_K, v_zero_point=ZP_V)
  ks = att.score_scale(K_SCALE, H)
  vs = float(torch.tensor(V_SCALE, dtype=torch.float32))
  for seed in range(8):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    q = torch.randn((B, 1, G, H), generator=gen, device='cuda').to(
        torch.bfloat16)
    kc, vc = (torch.randint(-127, 128, (B, 1, S, H), generator=gen,
                            device='cuda').to(torch.int8) for _ in range(2))
    lens = torch.randint(1, S + 1, (B,), generator=gen, device='cuda').to(
        torch.int32)
    lens[0], lens[-1] = 1, S
    qd = q.double()
    scores = (torch.matmul(qd, kc.double().transpose(-1, -2))
              - ZP_K * qd.sum(-1, keepdim=True)) * ks
    live = torch.arange(S, device='cuda')[None, None, None, :] < lens.reshape(
        B, 1, 1, 1)
    p = torch.softmax(torch.where(live, scores, -1e30), -1)
    f64 = (torch.matmul(p, vc.double()) - ZP_V) * vs
    plain = att.decode_attention_int8_lengths_plain(
        q, kc, vc, K_SCALE, V_SCALE, lens, **kw)
    kern = att.decode_attention_int8_lengths(q, kc, vc, K_SCALE, V_SCALE,
                                             lens, **kw)
    torch.cuda.synchronize()

    def err(x, y):
      return float((x.double() - y.double()).abs().max())

    emit(study='truth', seed=seed, plain_vs_f64=err(plain, f64),
         kernel_vs_f64=err(kern, f64), kernel_vs_plain=err(kern, plain))


# -------------------------------------------------------------------- #16


def int_weights_times(torch, mods, timer):
  iq = mods['iq']
  gen = torch.Generator(device='cuda').manual_seed(3)
  rows = [('decode', B, 'gate_up', 2 * F, D), ('decode', B, 'down', D, F),
          ('decode', B, 'head', V, D),
          ('prefill', PREFILL_ROWS, 'gate_up', 2 * F, D),
          ('prefill', PREFILL_ROWS, 'down', D, F),
          ('prefill', PREFILL_BATCH, 'head', V, D),
          ('channelwise', B, 'out_proj', D, D)]
  for phase, m, label, n, k in rows:
    bs = 0 if phase == 'channelwise' else QUANT_BLOCK
    x = torch.randn((m, k), generator=gen, device='cuda').to(torch.bfloat16)
    x32 = torch.randn((m, k), generator=gen, device='cuda')
    w = torch.randint(-8, 8, (n, k), generator=gen, device='cuda').to(
        torch.int8)
    s = torch.rand((n, k // bs) if bs else (n,), generator=gen,
                   device='cuda') * 0.01 + 0.005
    row = {'phase': phase, 'shape': label, 'M': m, 'N': n, 'K': k,
           'block_size': bs,
           'ms': timer(lambda: iq.qmatmul_int_weights(x, w, s,
                                                      block_size=bs)),
           'ms_f32_x': timer(lambda: iq.qmatmul_int_weights(
               x32, w, s, block_size=bs))}
    if hasattr(iq, 'int_weights_plan'):
      row['launch'] = iq.int_weights_plan(m, n, k, bs, True)
    if not bs:
      wf, xf = w.float(), x.float()
      row['library_ms'] = timer(lambda: torch.matmul(xf, wf.T))
      row['library_ms_f32_x'] = timer(lambda: torch.matmul(x32, wf.T))
    emit(study='times', kernel='qmatmul_int_weights', **row)
    del x, x32, w, s


# A variant: (file of csrc/, exact text, its stand-in) edits of a copy of
# csrc/. #16's: one part of the bs-32 decode loop taken out (times only).
_IW = 'qmatmul_int_weights.cu'
_FLUSH = (_IW, """    const float scaled = p[r] * s[(r >> 1) & 1];
    y[r] = y[r] + scaled;""", """    if (r == 0) y[r] = y[r] + p[r];""")
_WIDEN = (_IW, """      w4::a_frags_int8(st + XP * G::kX, row, cw, q, a[cw]);""",
          """      for (int e = 0; e < 4; ++e)
        a[cw][e] = 0x3F803F80u ^ (uint32_t)(i & 1);""")
_STREAM = (_IW, """    } else if constexpr (kTwoSums) {""",
           """    } else if constexpr (kTwoSums) {
      mbar_arrive(&empty_bar[s]);
      y[0] = y[0] + s0[0] + s1[1] + (float)st[XP * G::kX + row * kStepK];
    } else if constexpr (kTwoSums && false) {""")
_SCALES = (_IW, '''        const float2 v =
            __ldg(reinterpret_cast<const float2*>(srow[u]) + step);
        s0[u] = v.x;
        s1[u] = v.y;''', '''        s0[u] = bias != nullptr ? 0.5f : 0.25f;
        s1[u] = s0[u];''')
# The int8 core's split-half unpack (#3's both contractions, #1, #6) with
# the nibbles sign-extended by drq_common.cuh's nib_lo / nib_hi (__vsub4,
# ((v ^ 8) - 8) a byte; the same bytes) in place of sign_extend_nibbles.
_VSUB4 = ('int8_tc_gemm.cuh', """      l[e] = sign_extend_nibbles(w[e] & 0x0F0F0F0Fu);
      h[e] = sign_extend_nibbles((w[e] >> 4) & 0x0F0F0F0Fu);""",
          """      l[e] = (uint32_t)nib_lo(w[e]);
      h[e] = (uint32_t)nib_hi(w[e]);""")
# #20's DRQ route with the norm and #1's row quantize as two launches (the
# norm's rows into the qkv scratch, which the bench shape's N >= D holds).
_NORM_THEN_QUANT = ('qkv_rope.cu', """    err = aeqt::launch_rmsnorm_quant_rows<T>(x, gamma, xn, xs, M, D, eps,
                                              stream);""", """    err = aeqt::launch_rmsnorm_rows<T, false>(x, gamma, qkv, M, D, eps,
                                              stream);
    if (err != 0) return err;
    err = tc::launch_quantize<tc::SplitNibblesRecipB, T, true>(qkv, xn, xs,
                                                               M, D, stream);""")
# #4's weight-only head: four token tiles a pass above 64 rows (in place
# of passes of two); one 64-byte K step of the weight rows a ring stage (in
# place of two).
_HA = 'head_argmax.cu'
_HEAD_R4 = [(_HA, """  p.r = M <= kWoTok ? 1 : 2;""",
             """  p.r = M <= kWoTok ? 1 : 4;"""),
            (_HA, """  return launch_wo_kernel<kPacked, 2, 2>(""",
             """  return launch_wo_kernel<kPacked, 2, 4>(""")]
_HEAD_SUB1 = (_HA, """constexpr int kWoSub = 2;""", """constexpr int kWoSub = 1;""")
# #4's weight-only loop with a part taken out (wrong ids, for the time
# only): 'head_no_widen' (constant A fragments: no shared-memory read or
# widening of the weights), 'head_stream' (no widening and no wgmma: the
# consumers only wait for and release the stages, so the ring's stream of
# weight and x tiles and the epilogue set the time), 'head_half_x' (the x
# tiles of every other stage not loaded: half the x bytes from L2).
_HEAD_NO_WIDEN = (_HA, """            if constexpr (kPacked)
              w4::a_frags(wu, row, c, q, alo[u][c], ahi[u][c], kWRow);
            else
              w4::a_frags_int8(wu, row, c, q, alo[u][c], kWRow);""",
                  """            for (int e = 0; e < 4; ++e) {
              alo[u][c][e] = 0x3F803F80u ^ (uint32_t)(jj & 1);
              ahi[u][kPacked ? c : 0][e] = alo[u][c][e] ^ (uint32_t)wu[0];
            }""")
_HEAD_NO_WGMMA = (_HA, """            for (int r = 0; r < R; ++r) {
              const uint8_t* xt""", """            for (int r = 0; r < 0; ++r) {
              const uint8_t* xt""")
_HEAD_HALF_X = (_HA, """        tc::mbar_expect_tx(&full_bar[s], (uint32_t)kStage);
        const int i = j % steps, p = (j / steps) % passes;
        for (int u = 0; u < kWoSub; ++u) {  // x tiles of sub-step u""",
                """        const bool xl = (j & 1) == 0;
        tc::mbar_expect_tx(&full_bar[s],
                           (uint32_t)(xl ? kStage
                                         : kStage - kWoSub * kXTiles * kX));
        const int i = j % steps, p = (j / steps) % passes;
        for (int u = 0; u < (xl ? kWoSub : 0); ++u) {""")
# #20's weight-only pair tile at 128 tokens a tile for two warpgroups
# (ChannelScale's), in place of 64.
_PAIRS_NT128 = ('int4_bf16_tc_gemm.cuh', """struct QkvRopePairs : ChannelScale {
  static constexpr int kNT2 = 64;""", """struct QkvRopePairs : ChannelScale {
  static constexpr int kNT2 = 128;""")
# Each group's variants and the libraries they build.
VARIANTS = {
    'int_weights': (('qmatmul_int_weights',),
                    {'kernel': [], 'no_flush': [_FLUSH],
                     'no_scale_load': [_SCALES], 'no_widen': [_WIDEN],
                     'stream': [_WIDEN, _STREAM]}),
    'mlp': (('mlp_int4_drq', 'qmatmul_int4_drq', 'qmatmul_int4_drq_kblock'),
            {'kernel': [], 'vsub4': [_VSUB4]}),
    'prologue': (('qkv_rope', 'head_argmax'),
                 {'kernel': [], 'norm_then_quantize': [_NORM_THEN_QUANT],
                  'pairs_nt128': [_PAIRS_NT128],
                  'head_half_x': [_HEAD_HALF_X],
                  'head_sub1': [_HEAD_SUB1],
                  'head_r4': _HEAD_R4,
                  'head_no_widen': [_HEAD_NO_WIDEN],
                  'head_stream': [_HEAD_NO_WIDEN, _HEAD_NO_WGMMA]})}


def build_variants(build, group):
  """{variant: {library: path}}, each variant's libraries built from its
  own patched copy of csrc/ (under kernels/_build/variants/), every nvcc
  started together."""
  import shutil
  import subprocess
  names, edits_of = VARIANTS[group]
  out = build.BUILD_DIR / 'variants' / group
  shutil.rmtree(out, ignore_errors=True)
  procs, libs = {}, {}
  for variant, edits in edits_of.items():
    csrc = out / variant / 'csrc'
    shutil.copytree(build.CSRC, csrc)
    for file, old, new in edits:
      text = (csrc / file).read_text()
      if text.count(old) != 1:
        raise RuntimeError(f'variant {variant}: anchor not found once: {old}')
      (csrc / file).write_text(text.replace(old, new))
    libs[variant] = {}
    for name in names:
      lib = out / variant / f'lib{name}.so'
      libs[variant][name] = lib
      with open(out / variant / f'{name}.log', 'w') as log:
        procs[variant, name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, '-I', str(csrc), '-o',
             str(lib), str(csrc / f'{name}.cu')],
            stdout=log, stderr=subprocess.STDOUT)
  for key, proc in procs.items():
    if proc.wait():
      raise RuntimeError(f'variant {key} did not build')
  return libs


def variant_ptxas(lib):
  """Registers, spills and wgmma serialization notes (ptxas C75xx) of each
  kernel in a variant's build log."""
  found, current = {}, None
  for line in (lib.parent / f'{lib.name[3:-3]}.log').read_text().splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
      current = found.setdefault(m.group(1), {'notes': []})
    m = re.search(r'\((C75\d\d)\).*function \'(\S+)\'', line)
    if m:
      found.setdefault(m.group(2), {'notes': []})['notes'].append(m.group(1))
    m = re.search(r'(\d+) bytes spill stores', line)
    if m and current is not None:
      current['spill_stores'] = int(m.group(1))
    m = re.search(r'Used (\d+) registers', line)
    if m and current is not None:
      current['registers'] = int(m.group(1))
  return [dict(function=fn[:140], **r) for fn, r in found.items()]


def variant_calls(torch, mods, group):
  """(label, call) of the rows each group's variants are timed at."""
  gen = torch.Generator(device='cuda').manual_seed(3)
  if group == 'prologue':
    return [(f"{key['kernel']}_{'packed_' if key.get('packed') else ''}"
             f"{'drq_' if key.get('drq') else ''}M{key['M']}", call)
            for key, call in prologue_cases(torch, mods)
            if (key['kernel'] == 'qkv_rope'
                and (key['drq'] or key['M'] == BENCH_B))
            or (key['kernel'] == 'head_argmax_bf16'
                and (key['packed'] or key['M'] == B))]
  if group == 'int_weights':
    iq, calls = mods['iq'], []
    for label, n, k in (('gate_up', 2 * F, D), ('down', D, F),
                        ('head', V, D)):
      x = torch.randn((B, k), generator=gen, device='cuda').to(torch.bfloat16)
      w = torch.randint(-8, 8, (n, k), generator=gen, device='cuda').to(
          torch.int8)
      s = torch.rand((n, k // QUANT_BLOCK), generator=gen,
                     device='cuda') * 0.01 + 0.005
      calls.append((label, lambda x=x, w=w, s=s: iq.qmatmul_int_weights(
          x, w, s, block_size=QUANT_BLOCK)))
    return calls
  calls = [(f'mlp_int4_packed_bf{key["bf"]}_M{key["M"]}', call)
           for key, call in mlp_cases(torch, mods, bfs=(2048,))
           if key['kernel'] == 'mlp_int4_packed']
  pq = mods['pq']
  w = pq.pack_int4_split(torch.randint(-8, 8, (2560, D), generator=gen,
                                       device='cuda').to(torch.int8))
  s = torch.rand((2560,), generator=gen, device='cuda') * 0.01 + 0.005
  wk = pq.pack_int4_split(torch.randint(-8, 8, (D, F), generator=gen,
                                        device='cuda').to(torch.int8))
  sk = torch.rand((D,), generator=gen, device='cuda') * 0.01 + 0.005
  for m in (64, 1024):
    x = torch.randn((m, D), generator=gen, device='cuda').to(torch.bfloat16)
    xk = torch.randn((m, F), generator=gen, device='cuda').to(torch.bfloat16)
    # #1 at the QKV projection's shape, #6 at the down projection's.
    calls.append((f'qmatmul_int4_packed_drq_M{m}',
                  lambda x=x: pq.qmatmul_int4_packed_drq(x, w, s)))
    calls.append((f'qmatmul_int4_packed_drq_kblock_M{m}',
                  lambda xk=xk: pq.qmatmul_int4_packed_drq_kblock(xk, wk, sk)))
  return calls


def variants(torch, mods, timer, groups):
  import ctypes
  build = mods['build']
  for group in groups:
    if group not in VARIANTS:
      continue
    libs = build_variants(build, group)
    for variant, built in libs.items():
      for name, lib in built.items():
        emit(study='variants', group=group, variant=variant, library=name,
             ptxas=[r for r in variant_ptxas(lib)
                    if r['notes'] or r.get('spill_stores')
                    or 'head_wo' in r['function']
                    or 'mlp_tc_kernelILi3E' in r['function']])
    calls = variant_calls(torch, mods, group)
    turns = list(libs) + list(libs)[::-1]  # in turns
    for variant in turns:
      loaded = {n: ctypes.CDLL(str(p)) for n, p in libs[variant].items()}
      build.library = lambda name, loaded=loaded: loaded[name]
      row = {'group': group, 'variant': variant}
      for label, call in calls:
        call()
        row[label + '_ms'] = timer(call)
      emit(study='variants', **row)


# ------------------------------------------------------------------- #11


# Launches of #11 in a row, as an in-place bench step makes them (two a
# layer of Gemma-2B).
CHAIN = 36


def cache_times(torch, mods, timer):
  """#11 at bench.py's decode shape, its launch floor and one slice
  assignment (chip_smoke.cache_row_kernel's inputs); and a chain of CHAIN
  launches of each in a row, timed as one call (chain_ms: the time a
  launch, where a programmatic dependent launch overlaps the one before
  it)."""
  from ai_edge_quantizer_tpu_torch.kernels import cache
  gen = torch.Generator(device='cuda').manual_seed(0)
  pool = torch.randint(-127, 128, (BENCH_B, 1, S, H), generator=gen,
                       device='cuda').to(torch.int8)
  upd = torch.randint(-127, 128, (BENCH_B, 1, 1, H), generator=gen,
                      device='cuda').to(torch.int8)
  pos = BENCH_ROWS - 1
  st = torch.tensor((0, 0, pos, 0), dtype=torch.int32, device='cuda')

  def assign():
    pool[:, :, pos:pos + 1] = upd

  def chain(fn):
    def run():
      for _ in range(CHAIN):
        fn()
    return timer(run) / CHAIN

  row = dict(study='times', kernel='dus_row_inplace', shape=[BENCH_B, 1, S, H],
             ms=timer(lambda: cache.dus_row_inplace(pool, upd, st)),
             library_ms=timer(assign),
             chain_ms=chain(lambda: cache.dus_row_inplace(pool, upd, st)))
  if hasattr(cache, 'launch_floor'):
    row.update(launch_floor_ms=timer(lambda: cache.launch_floor(pool)),
               chain_floor_ms=chain(lambda: cache.launch_floor(pool)),
               plan=cache.plan(BENCH_B, H))
  emit(**row)


# ------------------------------------------------------------------- main

TIMES = {'mlp': mlp_times, 'attention': attention_times,
         'block': block_times, 'fusion': fusion_times,
         'prologue': prologue_times, 'int_weights': int_weights_times,
         'cache': cache_times}
LAUNCH_CASES = {'mlp': mlp_cases, 'block': block_cases,
                'fusion': functools.partial(fusion_cases, unfused=True),
                'prologue': prologue_cases}
STUDIES = {'launches': launches, 'host': host, 'steps': steps,
           'server': server, 'order': order, 'truth': truth}


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--root', default=str(pathlib.Path(__file__).parent))
  parser.add_argument('--kernels', default=','.join(GROUPS))
  parser.add_argument('--reps', type=int, default=25)
  parser.add_argument('--settings', default=','.join(STEP_SETTINGS),
                      help='the bench settings `steps` runs')
  parser.add_argument('studies', nargs='+',
                      choices=('times', 'variants') + tuple(STUDIES))
  args = parser.parse_args()
  groups = [g for g in args.kernels.split(',') if g]
  if any(g not in GROUPS for g in groups):
    parser.error(f'--kernels takes {",".join(GROUPS)}')
  import torch
  if not torch.cuda.is_available():
    print('kernel_study: no CUDA device; nothing was run.', file=sys.stderr)
    return 2
  root = pathlib.Path(args.root).resolve()
  sys.path.insert(0, str(root))
  import chip_smoke as cs
  from ai_edge_quantizer_tpu_torch.kernels import _build
  from ai_edge_quantizer_tpu_torch.kernels import attention as att
  from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul as iq
  from ai_edge_quantizer_tpu_torch.kernels import mlp
  from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul as pq
  # Only the studied kernels' libraries are built; the steps and the
  # server, every one.
  if not {'steps', 'server'} & set(args.studies):
    needed = set(groups if {'times', 'variants'} & set(args.studies)
                 else ())
    if 'launches' in args.studies:
      needed |= set(groups) & set(LAUNCH_CASES)
    needed |= {STUDY_GROUP[s] for s in args.studies if s in STUDY_GROUP}
    _build.SOURCES = tuple(n for g in GROUPS if g in needed
                           for n in SOURCES[g])
  _build.build(_build.SOURCES)
  torch.backends.cuda.matmul.allow_tf32 = False
  timer = functools.partial(cs.Timer(torch).__call__, reps=args.reps)
  settings = tuple(x for x in args.settings.split(',') if x)
  if any(x not in STEP_SETTINGS for x in settings):
    parser.error(f'--settings takes {",".join(STEP_SETTINGS)}')
  mods = dict(cs=cs, build=_build, att=att, iq=iq, mlp=mlp, pq=pq,
              groups=groups, settings=settings)
  emit(card=cs.run_text(['nvidia-smi', '--query-gpu=name,power.limit',
                         '--format=csv,noheader']).splitlines()[0],
       root=str(root))
  for study in args.studies:
    if study == 'times':
      for group in groups:
        TIMES[group](torch, mods, timer)
    elif study == 'variants':
      variants(torch, mods, timer, groups)
    else:
      STUDIES[study](torch, mods, timer)
  return 0


if __name__ == '__main__':
  sys.exit(main())
