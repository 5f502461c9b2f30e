#!/usr/bin/env python3
"""Drives the PyTorch port (ai_edge_quantizer_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA device, nvcc (on PATH or /usr/local/cuda/bin) and no network. It
builds the port's CUDA kernels from kernels/csrc at first use, then:

  1. facts: torch.version.cuda, nvcc --version, the card's name and power
     limit (nvidia-smi) and the kernels' build time;
  2. kernels: each of the twenty-two kernels against its plain PyTorch version
     on the card at the main paths' shapes (Gemma-2B; decode at batch 64
     and cache 1024, bench.py's decode at batch 256 with 897 live cache
     rows, prefill at 8 x 128 tokens; bf16 activations), with the stated
     tolerances; CUDA-event medians of the kernel, the plain version and,
     where one PyTorch call computes the same contraction or attention,
     that call (`library_ms`, never used by the port), and for the fused
     decode block the composition of the unfused kernels it replaces; the
     bound from bytes over 3.35 TB/s or operations over the peak rate; the
     int4-group attention at pos 0/31/32/896/1023 and the server's mixed
     lengths, with INT4G_ATTENTION_SCATTER's pools and sidecar equal to
     its CPU run bit for bit; the int8 DRQ matmul (bit for bit) and the
     weight-only matmul (blockwise 32 and channelwise, within
     int_qmatmul.int_weights_tolerance) at the quantized serving graph's
     shapes; the K-blocked int4 DRQ matmul bit for bit at the down
     projection's shapes (N 2048, K 16384, decode and prefill rows), M = 1,
     an odd M and two small K, bf16 and f32 x, with and without a bias,
     timed beside torch._int_mm; the kernels of the JAX executor's
     default mode (default_mode_kernels): the weight-only packed matmul at
     the QKV and out-projection shapes (decode, prefill and an odd M; bf16
     and f32 x, with and without a bias), the additive-mask decode
     attention (B 64 and 256, S 1024, prefix and non-prefix masks), the
     MLP's and the head's weight-only branches (bf 512; the head packed
     and int8 at N 256128, ids judged by the plain top-2 margins); the
     kernels of the blockwise server and the opt-in cache modes
     (cache_mode_kernels): the blockwise packed matmul at every FC shape of
     Gemma-2B (decode and prefill rows, block 128, and block 256 at one
     shape; bf16 and f32 x, with and without a bias), the splice attention
     at bench.py's shape (pos 896, 0, 31, 32, 1023; pools bit for bit),
     the in-place row write (bit for bit, clipped starts) and the
     live-prefix attention (B 64 and 256, zero-length rows); the kernels
     of the norm fusion and the attention block (attn_block_kernels): the
     norm-fused weight-only matmul at the QKV and gate/up shapes (M 256
     and 64, bf16 and f32 x, with and without a bias, N padded), the
     norm + QKV + RoPE prologue (M 256 and 64, bf16 and f32, DRQ bit for
     bit and weight-only) and the attention + out-projection + residual
     epilogue (B 256 and 64, lengths 897, 0, 1 and S, bf16 and f32, DRQ bit
     for bit given the lengths kernel's context, weight-only), each timed
     beside the unfused kernels it replaces; four attention shapes the CUDA
     kernels do not take must raise, and the epilogue with two KV heads
     or an odd head count;
  3. decode loop: the Gemma-2B int4 greedy decode graph at batch 64 with an
     int8 KV cache answers 64 requests (8 prompt tokens fed through the
     decode step, then 16 greedy tokens), the decode block off; launch
     counts per kernel are checked against 36 / 18 / 18 / 1 per step;
  3b. bench decode: bench.py's decode step (batch 256, cache 1024,
     start_pos 896, zero int8 pools, full vocabulary) through the executor,
     3 warm-up and 8 timed steps, with the decode block on (launches per
     step: block 17, stale attention 1, MLP 1, head 1, packed matmul 19)
     and off on the same weights; ms/step, tokens/s, device idle share;
     then bench.py's int4g decode (AEQT_BENCH_KV=int4g: zero uint8 pools
     and bf16 sidecars, no decode-block unit; launches per step: int4g
     attention 18, MLP 18, head 1, packed matmul 36); and with the block
     off the splice writeback (splice attention 18 a step) and the in-place
     row writes without writeback (row write 36, lengths attention 18),
     each writing into its step's input pools, ids compared with the
     block off's; and bench.py's settings with AEQT_ATTN_BLOCK=1
     (launches per step: prologue 18, epilogue 18, MLP 18, head 1) and
     with AEQT_NORM_FUSION=1 (norm-fused matmul 36, stale attention 18,
     int4 DRQ 18, K-blocked int4 DRQ 18, head 1), ids compared likewise;
  4. server: the port's DecodeServer at bench.py's server settings serves
     128 requests (prompt lengths cycling 32..512, 48 new tokens each) by
     step_chunk(8); every request must end done with 48 ids in range, and
     each kernel's launches must match the executor calls (the plain
     versions never run on the card); tokens/s, TTFT p50/p99, ms per
     prefill pass and per chunk of 8 ticks, and the device's idle share
     (torch.profiler) are printed; then the same with int4-group pools
     (AEQT_BENCH_SERVER_KV=int4g: int4g attention 18 per tick, no flash
     or lengths launch);
  4b. quantizer: examples/serve_gemma.py's flow at full width through the
     port's own entry points: the float serving graph (weights drawn on
     the host, int8 KV stamped) built once at each depth, then for
     gemma_mixed48, gemma_mixed48_b32 and gemma_mixed48_hr (a Hadamard
     rotation before each int4 FC, OCTAV clipping) and serve_gemma's own
     quantization (DEFAULT_MODE: add_dynamic_config with every FC int4,
     served with executor.JAX_DEFAULT_OPTIONS, the JAX executor's default
     mode), these four at 2 layers (QUANT_LAYERS), and the same in blocks
     of 128 (BLOCKWISE_MODE, 18 layers, served with JAX_DEFAULT_OPTIONS
     and attn_dynlen):
     Quantizer(graph, recipe).quantize(), export_model
     to a temporary .aeqg, serialize.load_graph (every buffer and
     parameter equal), DecodeServer(loaded, pack_weights=True) serving the
     server's 128 requests; build, quantize, export and load times, file
     size, peak host memory, tokens/s, TTFT and the launches by kernel
     per layer L (gemma_mixed48: int8 DRQ 2L a tick or pass, MLP L, head
     1; _b32: int8 DRQ 2L, weight-only 2L+1; _hr: int8 DRQ 2L, int4 DRQ L,
     K-blocked int4 DRQ L, head 1; DEFAULT_MODE: weight-only packed 2L,
     MLP and head in their weight-only branches L and 1, masked attention
     L a tick, flash L a pass, no DRQ kernel; BLOCKWISE_MODE:
     blockwise packed 73 a tick or pass, live-prefix attention 18 a tick,
     flash 18 a pass);
  5. card against CPU: the decode step at batch 8 with the decode block
     off (18 layers) and on (4 layers; the block is one op) and the int4g
     step (4 layers), and the server's first prefill pass and decode tick
     at 2 layers with int8 and with int4-group pools, f32 activations, run
     op by op on the card from the CPU's values; every op must agree
     within a few f32 ulps (the fused MLP of the prefill pass within 1e-3,
     the int4g context as the kernel phase holds it: int4g_ctx_ok), int8
     codes within one step, the int4g pools and sidecars bit for bit, and
     the card's ids must equal the port's CPU ids, except rows whose CPU
     top-2 logit margin is below 1e-3 relative (see OpByOp);
     then the block on against off on the card at f32 (4 layers, batch 8,
     4 steps from start_pos 896), ids and caches compared; then a float
     serving graph quantized with each recipe (2 layers, the quantizer
     phase's graphs where their depth agrees), its
     server's first prefill pass and decode tick held op by op (the int8
     DRQ and the K-blocked int4 DRQ FCs bit for bit, the blockwise, the
     default mode's weight-only and the packed blockwise FCs within their
     tolerance); and the decode step at FUSION_CPU_LAYERS layers with the
     attention block and with the norm fusion (the norm-fused FCs within
     int_weights_tolerance, the epilogue's rows by EPILOGUE_ROW_RTOL).

Its last lines: the `kernels` JSON line, the nvidia-smi line, and
{"ok": true, "device": {...}}. Any failure raises and exits nonzero.
`--skip-cpu` leaves out phase 5 (for quick runs by hand).
"""

import argparse
import dataclasses
import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import tracemalloc

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak
B, S = 64, 1024                # main-path batch and cache length
PROMPT, GENERATE = 8, 16
# bench.py's decode (bench.py:477-591): batch 256, start_pos S - 128.
BENCH_B, BENCH_START = 256, 896
BENCH_WARMUP, BENCH_STEPS = 3, 8
# The server phase: bench.py's bench_server settings.
PREFILL_LEN, PREFILL_BATCH, PREFILL_TAIL = 128, 8, 64
PREFILL_ROWS = PREFILL_BATCH * PREFILL_LEN   # rows of a prefill pass
SERVE_REQUESTS, SERVE_NEW, SERVE_CHUNK = 128, 48, 8
SERVE_PROMPTS = (32, 64, 128, 256, 512)


def sync():
  """Wait for the card (set to torch.cuda.synchronize in main)."""


def log(msg):
  print(msg, flush=True)


def run_text(cmd):
  return subprocess.run(cmd, capture_output=True, text=True,
                        check=True).stdout.strip()


def bound(nbytes, *work):
  """(ms, 'bytes' or 'operations'): the largest of nbytes over the memory
  rate and each unit's operations over its peak rate; work is (operations,
  peak rate) pairs. Work on separate units (int8 tensor cores, f32 SIMT)
  can overlap, so their times do not add."""
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = max(ops / rate for ops, rate in zip(work[::2], work[1::2])) * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


class Timer:
  """Median CUDA-event time of one call, L2 flushed before each launch
  (each decode layer reads its weights and cache cold). A spin of the card
  (about 2.5 ms) before each start event lets the host enqueue the whole
  call first, so the events time the card's work, not the host's."""

  def __init__(self, torch):
    self.torch = torch
    self.flush = torch.empty(128 * 2**20, dtype=torch.uint8, device='cuda')

  def __call__(self, fn, reps=25, warmup=3):
    torch = self.torch
    events = []
    for i in range(warmup + reps):
      self.flush.zero_()
      torch.cuda._sleep(5_000_000)
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      fn()
      end.record()
      if i >= warmup:
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bf16_ulps(torch, got, want, atol=0.0):
  """Largest difference, less `atol`, in bf16 units in the last place of
  `want`."""
  w = want.float()
  ulp = torch.clamp_min(torch.abs(w), 2.0**-126)
  ulp = torch.exp2(torch.floor(torch.log2(ulp)) - 7)
  diff = torch.clamp_min(torch.abs(got.float() - w) - atol, 0.0)
  return float(torch.max(diff / ulp))


def kernel_phase(torch, port, cfg, dev, timer):
  """Each kernel against its plain version at the main path's shapes."""
  pq, att, mlp, head, gemma = (port['packed_qmatmul'], port['attention'],
                               port['mlp'], port['head'], port['gemma'])
  D, F, V = cfg.embed_dim, cfg.ffn_dim, cfg.vocab_size
  NQ, NK, H = cfg.num_query_heads, cfg.num_kv_heads, cfg.head_dim
  S = cfg.max_seq_len
  G = NQ // NK
  gen = torch.Generator(device=dev).manual_seed(0)
  bf16 = torch.bfloat16

  def randn(*shape, dtype=bf16):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)

  def randint(lo, hi, *shape, dtype=torch.int8):
    return torch.randint(lo, hi, shape, generator=gen, device=dev).to(dtype)

  def scales(n):
    return (torch.rand((n,), generator=gen, device=dev) * 0.01 + 0.005)

  results = []

  # 1. int4 DRQ matmul: the fused QKV and the out-projection of a layer, at
  # a decode step's rows (B), bench.py's decode rows (BENCH_B) and a prefill
  # pass's rows (Bp * T).
  by_shape = []
  for phase, m in (('decode', B), ('bench', BENCH_B),
                   ('prefill', PREFILL_ROWS)):
    for label, n in (('qkv', (NQ + 2 * NK) * H), ('out_proj', D)):
      x = randn(m, 1, D)
      w_q = randint(-8, 8, n, D)
      w = pq.pack_int4_split(w_q)
      s = scales(n)
      got = pq.qmatmul_int4_packed_drq(x, w, s)
      want = pq.qmatmul_int4_packed_drq_plain(x, w, s)
      sync()
      ulps = bf16_ulps(torch, got, want)
      err = float(torch.max(torch.abs(got.float() - want.float())))
      if ulps > 1.0:
        raise AssertionError(f'qmatmul {label}: {ulps} bf16 ulps from plain')
      got32 = pq.qmatmul_int4_packed_drq(x.float(), w, s)
      want32 = pq.qmatmul_int4_packed_drq_plain(x.float(), w, s)
      rel32 = float(torch.max(torch.abs(got32 - want32)
                              / torch.clamp_min(torch.abs(want32), 1e-30)))
      if rel32 > 1e-6:
        raise AssertionError(f'qmatmul {label} f32: rel err {rel32}')
      xq = torch.round(x.reshape(m, D).float() * 10).clamp(-127, 127).to(
          torch.int8)
      w_t = w_q.t()
      lib_ms = timer(lambda: torch._int_mm(xq, w_t))
      nbytes = m * D * 2 + n * D // 2 + n * 4 + m * n * 2
      b_ms, b_by = bound(nbytes, 2 * m * n * D, INT8_OPS_PER_S)
      by_shape.append({
          'phase': phase, 'shape': label, 'M': m, 'N': n, 'K': D,
          'ms': timer(lambda: pq.qmatmul_int4_packed_drq(x, w, s)),
          'plain_ms': timer(
              lambda: pq.qmatmul_int4_packed_drq_plain(x, w, s)),
          'library_ms': lib_ms, 'bound_ms': b_ms, 'bound_by': b_by,
          'max_abs_err': err, 'max_bf16_ulps': ulps,
          'max_rel_err_f32': rel32})

  def mean(key, phase):
    rows = [r[key] for r in by_shape if r['phase'] == phase]
    return sum(rows) / len(rows)

  results.append({
      'name': 'qmatmul_int4_packed_drq', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/qmatmul_int4_drq.cuh',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py:667',
      'jax': 'pallas_qmatmul.qmatmul_pallas_int4_packed_drq',
      'wrapper': pq.qmatmul_int4_packed_drq, 'per_step': 2 * cfg.num_layers,
      'max_abs_err': max(r['max_abs_err'] for r in by_shape),
      'ms': mean('ms', 'decode'), 'plain_ms': mean('plain_ms', 'decode'),
      'bound_ms': mean('bound_ms', 'decode'), 'bound_by': 'bytes',
      'library_ms': mean('library_ms', 'decode'),
      'library': 'torch._int_mm on the unpacked int8 weight (contraction '
                 'only)',
      'prefill': {key: mean(key, 'prefill') for key in
                  ('ms', 'plain_ms', 'bound_ms', 'library_ms')},
      'bench': {key: mean(key, 'bench') for key in
                ('ms', 'plain_ms', 'bound_ms', 'library_ms')},
      'by_shape': by_shape})
  log(f'kernel qmatmul_int4_packed_drq ok: {by_shape}')

  # 2. Stale-cache attention, f32 compute, bf16 output.
  q = randn(B, NK, G, H)
  kc = randint(-127, 128, B, NK, S, H)
  vc = randint(-127, 128, B, NK, S, H)
  kn = randint(-127, 128, B, NK, 1, H)
  vn = randint(-127, 128, B, NK, 1, H)
  lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev).to(
      torch.int32)
  lengths[0], lengths[1] = 1, S
  k_scale, v_scale, zp_k, zp_v = 0.06, 0.06, 3.0, -2.0
  args = (q, kc, vc, k_scale, v_scale, lengths, kn, vn)
  kw = dict(k_zero_point=zp_k, v_zero_point=zp_v, out_dtype=bf16)
  got = att.decode_attention_int8_lengths_stale(*args, **kw)
  want = att.decode_attention_int8_lengths_stale_plain(*args, **kw)
  got32 = att.decode_attention_int8_lengths_stale(
      *args, k_zero_point=zp_k, v_zero_point=zp_v)
  want32 = att.decode_attention_int8_lengths_stale_plain(
      *args, k_zero_point=zp_k, v_zero_point=zp_v)
  sync()
  err32 = float(torch.max(torch.abs(got32 - want32)))
  ulps = bf16_ulps(torch, got, want, atol=1e-5)
  if err32 > 1e-5 or ulps > 1.0:
    raise AssertionError(f'attention: f32 err {err32}, {ulps} bf16 ulps')
  # Cache rows the kernel must read: lengths - 1 per (batch, kv-head).
  live = NK * int(torch.sum(torch.clamp_min(lengths - 1, 0)))
  nbytes = (q.numel() * 2 + 2 * live * H + kn.numel() + vn.numel()
            + lengths.numel() * 4 + q.numel() * 2)
  b_ms, b_by = bound(nbytes, 4 * G * H * (live + B * NK), F32_OPS_PER_S)
  kd = (kc.float() * k_scale).to(bf16).reshape(B, NK, S, H)
  vd = (vc.float() * v_scale).to(bf16).reshape(B, NK, S, H)
  amask = torch.where(
      torch.arange(S, device=dev)[None, :] < lengths[:, None], 0.0,
      float('-inf')).to(bf16).reshape(B, 1, 1, S)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  results.append({
      'name': 'decode_attention_int8_lengths_stale', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/attention_stale.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:695',
      'jax': 'pallas_attention.decode_attention_int8_lengths_stale',
      'wrapper': att.decode_attention_int8_lengths_stale,
      'per_step': cfg.num_layers, 'max_abs_err': err32,
      'max_bf16_ulps': ulps,
      'ms': timer(lambda: att.decode_attention_int8_lengths_stale(*args,
                                                                  **kw)),
      'plain_ms': timer(
          lambda: att.decode_attention_int8_lengths_stale_plain(*args, **kw)),
      'bound_ms': b_ms, 'bound_by': b_by,
      'library_ms': timer(lambda: sdpa(q, kd, vd, attn_mask=amask)),
      'library': 'scaled_dot_product_attention over a dequantized bf16 cache',
      'live_rows': live,
      'bench': stale_bench(torch, att, cfg, dev, timer, gen)})
  log(f'kernel decode_attention_int8_lengths_stale ok: err {err32}')

  # 3. MLP, DRQ branch, bf = 2048 (the bench's AEQT_MLP_BF), at a decode
  # step's rows and a prefill pass's rows.
  bf = min(2048, F // 2)
  wgu = pq.pack_int4_split(randint(-8, 8, 2 * F, D))
  sgu = scales(2 * F)
  wd = mlp.pack_int4_split_grouped(randint(-8, 8, D, F), bf)
  sd = scales(D)
  mlp_rows = {}
  for phase, m in (('decode', B), ('bench', BENCH_B),
                   ('prefill', PREFILL_ROWS)):
    x = randn(m, 1, D)
    margs = (x, wgu, sgu, wd, sd)
    got = mlp.mlp_int4_packed(*margs, bf=bf)
    want = mlp.mlp_int4_packed_plain(*margs, bf=bf)
    sync()
    err = float(torch.max(torch.abs(got.float() - want.float())))
    ymax = float(torch.max(torch.abs(want.float())))
    # A one-ulp tanh difference may flip one hidden rounding.
    if err > 1e-3 * ymax:
      raise AssertionError(f'mlp {phase}: max err {err} vs max |y| {ymax}')
    nbytes = (m * D * 2 + 2 * F * D // 2 + 2 * F * 4 + D * F // 2 + D * 4
              + m * D * 2)
    b_ms, b_by = bound(nbytes, 3 * 2 * m * F * D, INT8_OPS_PER_S)
    mlp_rows[phase] = {
        'M': m, 'max_abs_err': err, 'max_abs_y': ymax,
        'ms': timer(lambda: mlp.mlp_int4_packed(*margs, bf=bf)),
        'plain_ms': timer(lambda: mlp.mlp_int4_packed_plain(*margs, bf=bf),
                          reps=25 if phase == 'decode' else 5),
        'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None}
  dec = mlp_rows['decode']
  results.append({
      'name': 'mlp_int4_packed', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/mlp_int4_drq.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_mlp.py:268',
      'jax': 'pallas_mlp.mlp_pallas_int4_packed (drq=True)',
      'wrapper': mlp.mlp_int4_packed, 'per_step': cfg.num_layers,
      'max_abs_err': max(r['max_abs_err'] for r in mlp_rows.values()),
      'max_abs_y': dec['max_abs_y'], 'ms': dec['ms'],
      'plain_ms': dec['plain_ms'], 'bound_ms': dec['bound_ms'],
      'bound_by': dec['bound_by'], 'library_ms': None,
      'prefill': mlp_rows['prefill'], 'bench': mlp_rows['bench']})
  err = max(r['max_abs_err'] for r in mlp_rows.values())
  ymax = dec['max_abs_y']
  log(f'kernel mlp_int4_packed ok: err {err} (max |y| {ymax})')

  # 4. Greedy head, int8 DRQ (the tied 256128 x 2048 embedding).
  x = randn(B, 1, D)
  w_q = randint(-127, 128, V, D)
  s = scales(V)
  # A planted tie across two vocab tiles: rows 100 and V - 100 equal and
  # scaled to win.
  w_q[V - 100] = w_q[100]
  s[100] = s[V - 100] = 1.0
  hargs = (x, w_q, s)
  for rows in (hargs, (x[:PREFILL_BATCH], w_q, s)):  # decode; prefill
    got = head.head_argmax(*rows, packed=False)
    want = head.head_argmax_plain(*rows, packed=False)
    sync()
    mism = int(torch.sum(got != want))
    if mism:
      raise AssertionError(f'head: {mism} ids differ from plain')
  nbytes = B * D * 2 + V * D + V * 4 + B * 4
  b_ms, b_by = bound(nbytes, 2 * B * V * D, INT8_OPS_PER_S)
  xb = randn(BENCH_B, 1, D)
  hb_ms, hb_by = bound(BENCH_B * D * 2 + V * D + V * 4 + BENCH_B * 4,
                       2 * BENCH_B * V * D, INT8_OPS_PER_S)
  head_bench = {
      'M': BENCH_B,
      'ms': timer(lambda: head.head_argmax(xb, w_q, s, packed=False)),
      'plain_ms': timer(lambda: head.head_argmax_plain(xb, w_q, s,
                                                       packed=False)),
      'bound_ms': hb_ms, 'bound_by': hb_by, 'library_ms': None}
  results.append({
      'name': 'head_argmax', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/head_argmax.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_head.py:169',
      'jax': 'pallas_head.head_argmax_pallas (int8, drq=True)',
      'wrapper': head.head_argmax, 'per_step': 1, 'max_abs_err': 0.0,
      'ms': timer(lambda: head.head_argmax(*hargs, packed=False)),
      'plain_ms': timer(lambda: head.head_argmax_plain(*hargs,
                                                        packed=False)),
      'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
      'bench': head_bench})
  log('kernel head_argmax ok: ids identical (planted tie included)')
  results.append(lengths_kernel(torch, att, cfg, dev, timer, gen))
  results.append(flash_kernel(torch, att, cfg, dev, timer, gen))
  results.append(block_kernel(torch, port, cfg, dev, timer, gen))
  results.append(int4g_kernel(torch, port, cfg, dev, timer, gen))
  results.extend(int_weight_kernels(torch, port, cfg, dev, timer, gen))
  results.append(kblock_kernel(torch, port, cfg, dev, timer, gen))
  results.extend(default_mode_kernels(torch, port, cfg, dev, timer, gen))
  results.extend(cache_mode_kernels(torch, port, cfg, dev, timer, gen))
  results.extend(attn_block_kernels(torch, port, cfg, dev, timer, gen))
  refused_shapes(torch, att, dev)
  return results


def stale_bench(torch, att, cfg, dev, timer, gen):
  """Stale attention at bench.py's decode: BENCH_B rows, every one
  BENCH_START + 1 long (BENCH_START live cache rows), f32 compute, bf16
  output; checked against the plain version as in the kernel phase."""
  NK, H = cfg.num_kv_heads, cfg.head_dim
  G = cfg.num_query_heads // NK
  S = cfg.max_seq_len
  bf16 = torch.bfloat16
  q = torch.randn((BENCH_B, NK, G, H), generator=gen, device=dev).to(bf16)
  kc, vc = (torch.randint(-127, 128, (BENCH_B, NK, S, H), generator=gen,
                          device=dev).to(torch.int8) for _ in range(2))
  kn, vn = (torch.randint(-127, 128, (BENCH_B, NK, 1, H), generator=gen,
                          device=dev).to(torch.int8) for _ in range(2))
  lengths = torch.full((BENCH_B,), BENCH_START + 1, dtype=torch.int32,
                       device=dev)
  args = (q, kc, vc, 0.06, 0.06, lengths, kn, vn)
  got = att.decode_attention_int8_lengths_stale(*args)
  want = att.decode_attention_int8_lengths_stale_plain(*args)
  sync()
  # f32 sums over 896 rows in another order than the plain version's
  # matmul; values up to 127 * 0.06.
  err = float(torch.max(torch.abs(got - want)))
  ymax = float(torch.max(torch.abs(want)))
  if err > 1e-5 * max(ymax, 1.0):
    raise AssertionError(f'stale attention at the bench shape: err {err}, '
                         f'max |y| {ymax}')
  live = NK * BENCH_B * BENCH_START
  nbytes = (q.numel() * 2 + 2 * live * H + kn.numel() + vn.numel()
            + lengths.numel() * 4 + q.numel() * 2)
  b_ms, b_by = bound(nbytes, 4 * G * H * (live + BENCH_B * NK),
                     F32_OPS_PER_S)
  kw = dict(out_dtype=bf16)
  kd = (kc.float() * 0.06).to(bf16)
  vd = (vc.float() * 0.06).to(bf16)
  amask = torch.where(
      torch.arange(S, device=dev)[None, :] < lengths[:, None], 0.0,
      float('-inf')).to(bf16).reshape(BENCH_B, 1, 1, S)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  return {
      'B': BENCH_B, 'live_rows': live, 'max_abs_err': err, 'max_abs_y': ymax,
      'ms': timer(lambda: att.decode_attention_int8_lengths_stale(*args,
                                                                  **kw)),
      'plain_ms': timer(
          lambda: att.decode_attention_int8_lengths_stale_plain(*args, **kw)),
      'bound_ms': b_ms, 'bound_by': b_by,
      'library_ms': timer(lambda: sdpa(q, kd, vd, attn_mask=amask))}


def block_kernel(torch, port, cfg, dev, timer, gen):
  """The fused decode block against its plain version at bench.py's shape:
  GEMMA_2B widths, BENCH_B rows, S = 1024, bf = 2048, random pools.

  Cases: bf16 x_res with random lengths 1..S at pos 0, 31, 32 and S - 1;
  then bench.py's step (every row BENCH_START + 1 long, pos BENCH_START)
  with bf16 and with f32 x_res (the executor passes f32). k_new, v_new and
  both pools must equal the plain version's bit for bit. x_ffn is held to
  one bf16 ulp (bf16 x_res) or 1e-6 relative (f32), ctx to 5e-5 of its
  largest magnitude: f32 sums in another order, scores of order 10, whose
  rounding exp amplifies. The bench step is timed beside the plain version
  and the composition it replaces (RMS norm, the MLP kernel, residual,
  norm, the QKV matmul kernel, RoPE, quantize, the stale kernel and the
  pools' row write), which at f32 must give the same x_ffn and ctx."""
  blk, pq, mlp = port['block'], port['packed_qmatmul'], port['mlp']
  att, impl = port['attention'], port['ops_impl']
  D, F, V = cfg.embed_dim, cfg.ffn_dim, cfg.vocab_size
  NQ, H, S = cfg.num_query_heads, cfg.head_dim, cfg.max_seq_len
  N = (NQ + 2) * H
  bf = 2048
  eps = cfg.norm_eps
  Bb = BENCH_B
  f32 = torch.float32

  def randint(lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device=dev).to(
        torch.int8)

  def scales(n):
    return torch.rand((n,), generator=gen, device=dev) * 0.01 + 0.005

  x32 = torch.randn((Bb, D), generator=gen, device=dev)
  x16 = x32.to(torch.bfloat16)
  x32 = x16.float()
  g1 = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=dev)
  g2 = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=dev)
  wgu = pq.pack_int4_split(randint(-8, 8, 2 * F, D))
  sgu = scales(2 * F)
  wd = mlp.pack_int4_split_grouped(randint(-8, 8, D, F), bf)
  sd = scales(D)
  wqkv = pq.pack_int4_split(randint(-8, 8, N, D))
  sqkv = scales(N)
  kc, vc = randint(-127, 128, Bb, S, H), randint(-127, 128, Bb, S, H)
  scale = 0.06  # the stamped KV scale; the graph's score factor is 1
  freqs = impl.rope_freqs(10000.0, H // 2, dev)

  def inputs(x, pos, lengths):
    ang = (float(pos) * freqs).reshape(1, H // 2).expand(Bb, H // 2)
    return ([x, g1, wgu, sgu, wd, sd, g2, wqkv, sqkv,
             torch.cos(ang).contiguous(), torch.sin(ang).contiguous(),
             kc.clone(), vc.clone(), lengths, pos]
            + [scale] * 4 + [NQ])

  def check(x, pos, lengths, label):
    a = inputs(x, pos, lengths)
    b = list(a)
    b[11], b[12] = kc.clone(), vc.clone()
    got = blk.fused_mlp_qkv_attention(*a, eps=eps, bf=bf)
    want = blk.fused_mlp_qkv_attention_plain(*b, eps=eps, bf=bf)
    sync()
    codes = {name: int(torch.sum(g != w)) for name, g, w in (
        ('k_new', got[2], want[2]), ('v_new', got[3], want[3]),
        ('k_pool', a[11], b[11]), ('v_pool', a[12], b[12]))}
    ctx_err = float(torch.max(torch.abs(got[0] - want[0])))
    ctx_max = float(torch.max(torch.abs(want[0])))
    if x.dtype == torch.bfloat16:
      x_err = bf16_ulps(torch, got[1], want[1])
      x_ok = x_err <= 1.0
    else:
      x_err = float(torch.max(torch.abs(got[1] - want[1]))
                    / torch.max(torch.abs(want[1])))
      x_ok = x_err <= 1e-6
    if any(codes.values()) or not x_ok or ctx_err > 5e-5 * ctx_max:
      raise AssertionError(f'fused block {label}: codes that differ '
                           f'{codes}, x_ffn err {x_err}, ctx err {ctx_err} '
                           f'(max |ctx| {ctx_max})')
    log(f'kernel fused_mlp_qkv_attention {label} ok: int8 codes equal, '
        f'x_ffn err {x_err:.3g}, ctx err {ctx_err:.3g} (max |ctx| '
        f'{ctx_max:.3g})')
    return {'case': label, 'x_ffn_err': x_err, 'ctx_max_abs_err': ctx_err,
            'ctx_max_abs': ctx_max}

  cases = []
  for pos in (0, 31, 32, S - 1):
    lengths = torch.randint(1, S + 1, (Bb,), generator=gen, device=dev).to(
        torch.int32)
    lengths[0], lengths[-1] = 1, S
    cases.append(check(x16, pos, lengths, f'bf16 pos {pos}'))
  lengths = torch.full((Bb,), BENCH_START + 1, dtype=torch.int32, device=dev)
  for x, name in ((x16, 'bf16'), (x32, 'f32')):
    cases.append(check(x, BENCH_START, lengths, f'{name} bench step'))

  a = inputs(x32, BENCH_START, lengths)
  cos, sin = a[9], a[10]
  rope = blk.rope_rotate

  def composition():
    xn = x32 * impl.rms_inverse(x32, eps) * g1
    x_ffn = x32 + mlp.mlp_int4_packed(xn, wgu, sgu, wd, sd, bf=bf)
    xn2 = x_ffn * impl.rms_inverse(x_ffn, eps) * g2
    qkv = pq.qmatmul_int4_packed_drq(xn2, wqkv, sqkv)
    q = rope(qkv[:, :NQ * H].reshape(Bb, NQ, H), cos[:, None], sin[:, None])
    k = rope(qkv[:, NQ * H:(NQ + 1) * H], cos, sin)
    k_new, v_new = (torch.clamp(torch.round(t / scale), -127, 127).to(
        torch.int8) for t in (k, qkv[:, (NQ + 1) * H:]))
    ctx = att.decode_attention_int8_lengths_stale(
        q[:, None], kc[:, None], vc[:, None], scale, scale, lengths,
        k_new[:, None, None], v_new[:, None, None])
    k_pool, v_pool = kc.clone(), vc.clone()
    k_pool[:, BENCH_START] = k_new
    v_pool[:, BENCH_START] = v_new
    return ctx.reshape(Bb, NQ, H), x_ffn, k_new, v_new

  got = blk.fused_mlp_qkv_attention(*a, eps=eps, bf=bf)
  comp = composition()
  sync()
  comp_x = float(torch.max(torch.abs(got[1] - comp[1])))
  comp_ctx = float(torch.max(torch.abs(got[0] - comp[0])))
  comp_codes = int(torch.sum(got[2] != comp[2]) + torch.sum(got[3] != comp[3]))
  log(f'fused block against the unfused kernels at f32: x_ffn err {comp_x}, '
      f'ctx err {comp_ctx:.3g}, new-row codes that differ {comp_codes} (the '
      'unfused quantize divides by the scale, the block multiplies by its '
      'f32 inverse)')
  if comp_x != 0.0 or comp_ctx > 5e-5 * cases[-1]['ctx_max_abs']:
    raise AssertionError('the fused block and the unfused kernels disagree')

  live = Bb * BENCH_START
  nbytes = (2 * F * D // 2 + D * F // 2 + N * D // 2
            + (2 * F + N + 3 * D) * 4          # scales and gammas
            + Bb * D * 2 + Bb * H * 4 + Bb * 4  # x (bf16), cos, sin, lengths
            + 2 * live * H                      # the live K and V rows
            + Bb * NQ * H * 4 + Bb * D * 2      # ctx, x_ffn
            + 4 * Bb * H)                       # k_new, v_new, pool rows
  int8_ops = 2 * Bb * (3 * D * F + N * D)
  f32_ops = 4 * NQ * H * (live + Bb)
  b_ms, b_by = bound(nbytes, int8_ops, INT8_OPS_PER_S, f32_ops,
                     F32_OPS_PER_S)
  a16 = inputs(x16, BENCH_START, lengths)
  ms = timer(lambda: blk.fused_mlp_qkv_attention(*a16, eps=eps, bf=bf))
  plain_ms = timer(lambda: blk.fused_mlp_qkv_attention_plain(
      *a16, eps=eps, bf=bf), reps=5)
  comp_ms = timer(composition)
  log(f'kernel fused_mlp_qkv_attention: {ms:.3f} ms (plain {plain_ms:.3f}, '
      f'unfused kernels {comp_ms:.3f}, bound {b_ms:.4f} by {b_by})')
  return {
      'name': 'fused_mlp_qkv_attention', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/fused_block.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_block.py:233',
      'jax': 'pallas_block.fused_mlp_qkv_attention (f32 attention)',
      'wrapper': blk.fused_mlp_qkv_attention, 'per_step': 0,
      'per_bench_step': cfg.num_layers - 1,
      'max_abs_err': max(c['ctx_max_abs_err'] for c in cases),
      'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
      'library_ms': None, 'composition_ms': comp_ms,
      'composition': 'RMS norm, mlp_int4_packed, residual, RMS norm, '
                     'qmatmul_int4_packed_drq, RoPE, quantize, '
                     'decode_attention_int8_lengths_stale, row write',
      'composition_vs_block': {'x_ffn_err': comp_x, 'ctx_err': comp_ctx,
                               'new_row_codes_differ': comp_codes},
      'B': Bb, 'live_rows': live, 'cases': cases}


INT4G_GROUP = 16   # bench.py's kv_int4_group
# The int4-group attention's context against its plain version, relative
# to its largest magnitude: a probability whose f32 value differs in the
# last place can round to the neighbouring bf16 value (2^-8 of it) before
# the context sum; 3.5e-4 was read at 33 live rows on an H100 80GB HBM3.
# Such flips touch few rows, so at most INT4G_FINE_SHARE of the elements
# may differ by more than INT4G_FINE_RTOL of that magnitude (1.35 % was
# read); a kernel that leaves out one bf16 rounding of q, of the K or V
# operand or of the probabilities moves most elements (int4g_kernel holds
# that, see plain_without_rounding).
INT4G_CTX_RTOL = 1e-3
INT4G_FINE_RTOL, INT4G_FINE_SHARE = 1e-5, 0.1


def int4g_ctx_diff(torch, got, want):
  """(largest |got - want| over max |want|, share of the elements that
  differ by more than INT4G_FINE_RTOL of max |want|)."""
  d = torch.abs(got.double() - want.double())
  ymax = max(float(torch.max(torch.abs(want.double()))), 1e-30)
  return (float(torch.max(d)) / ymax,
          float(torch.mean((d > INT4G_FINE_RTOL * ymax).double())))


def int4g_ctx_ok(rel, share):
  return rel <= INT4G_CTX_RTOL and share <= INT4G_FINE_SHARE


def plain_without_rounding(att, which, *args):
  """The plain int4-group attention with its `which`-th bf16 rounding left
  out (1 q, 2 the K operand, 3 the V operand, 4 the probabilities, the
  order of its calls to _bf16_round): what a kernel that dropped that
  rounding would give."""
  real, calls = att._bf16_round, []

  def patched(t):
    calls.append(t)
    return t if len(calls) == which else real(t)

  att._bf16_round = patched
  try:
    out = att.decode_attention_int4_group_lengths_plain(*args)
  finally:
    att._bf16_round = real
  if len(calls) != 4:
    raise AssertionError(f'the plain version rounds {len(calls)} times, '
                         'not 4: plain_without_rounding needs its new order')
  return out


def int4g_pools(torch, att, b, nk, s, h, gen, dev):
  """int4-group pools and sidecar quantized from random float rows on
  `dev` (K off centre, the regime asymmetric K exists for; V centred)."""
  k = torch.randn((b, nk, s, h), generator=gen, device=dev) * 0.5 + 0.8
  v = torch.randn((b, nk, s, h), generator=gen, device=dev)
  kp, ks, km = att.quantize_k_rows_int4_asym(k, INT4G_GROUP)
  vp, vs = att.quantize_v_rows_int4_group(v, INT4G_GROUP)
  return kp, vp, att.build_kv_sidecar_group(ks, km, vs)


def int4g_kernel(torch, port, cfg, dev, timer, gen):
  """The int4-group decode attention against its plain version on the card.

  Shapes: bench.py's int4g decode (BENCH_B rows, every row pos + 1 long,
  pos 0, 31, 32, BENCH_START and S - 1) and the server's tick (B slots,
  random lengths 1..S, one row 0 long), GEMMA_2B widths, group 16, pools
  quantized from random rows. ctx at f32 is held to INT4G_CTX_RTOL of its
  largest magnitude, with at most INT4G_FINE_SHARE of its elements beyond
  INT4G_FINE_RTOL of it, and at bf16 to one bf16 ulp beyond INT4G_CTX_RTOL:
  the kernel sums in another order than the plain version, and a
  probability whose f32 value differs in the last place can round to the
  neighbouring bf16 value (2^-8 relative) before the context sum. The
  same check must refuse the plain version with any one of its four bf16
  roundings left out, at the server's shape with f32 q. Then
  INT4G_ATTENTION_SCATTER at the server's shape on the card and on the CPU
  from the same inputs: the pools and the sidecar it writes must be equal
  bit for bit, the context held as the kernel's. Timed at
  bench.py's step (pos BENCH_START) beside the plain version and SDPA over
  the pools dequantized to bf16."""
  att, impl, ir = port['attention'], port['ops_impl'], port['ir']
  NK, H, S = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
  G = cfg.num_query_heads // NK
  NG = H // INT4G_GROUP
  bf16, i32 = torch.bfloat16, torch.int32
  kern = att.decode_attention_int4_group_lengths
  plain = att.decode_attention_int4_group_lengths_plain

  def check(q, kp, vp, sc, lengths, label):
    args = (q, kp, vp, sc, lengths, INT4G_GROUP)
    got32, want32 = kern(*args), plain(*args)
    got = kern(*args, out_dtype=bf16)
    want = plain(*args, out_dtype=bf16)
    sync()
    ymax = float(torch.max(torch.abs(want32)))
    err = float(torch.max(torch.abs(got32 - want32)))
    rel, share = int4g_ctx_diff(torch, got32, want32)
    ulps = bf16_ulps(torch, got, want, atol=INT4G_CTX_RTOL * ymax)
    log(f'kernel decode_attention_int4_group_lengths {label}: f32 err '
        f'{err:.3g} (max |ctx| {ymax:.3g}), share beyond {INT4G_FINE_RTOL:g} '
        f'{share:.4g}, bf16 {ulps} ulps beyond it')
    if not (int4g_ctx_ok(rel, share) and ulps <= 1.0):
      raise AssertionError(f'int4g attention {label}: f32 err {err} '
                           f'(max |ctx| {ymax}), share {share}, {ulps} bf16 '
                           'ulps')
    return {'case': label, 'max_abs_err': err, 'max_abs_ctx': ymax,
            'share_beyond_fine': share, 'bf16_ulps_beyond_tol': ulps}

  def randn(*shape):
    return torch.randn(shape, generator=gen, device=dev).to(bf16)

  cases = []
  q = randn(BENCH_B, NK, G, H)
  kp, vp, sc = int4g_pools(torch, att, BENCH_B, NK, S, H, gen, dev)
  for pos in (0, 31, 32, BENCH_START, S - 1):
    lengths = torch.full((BENCH_B,), pos + 1, dtype=i32, device=dev)
    cases.append(check(q, kp, vp, sc, lengths, f'bench pos {pos}'))
  qs = randn(B, NK, G, H)
  kps, vps, scs = int4g_pools(torch, att, B, NK, S, H, gen, dev)
  lens_s = torch.randint(1, S + 1, (B,), generator=gen, device=dev).to(i32)
  lens_s[0], lens_s[1], lens_s[2] = 1, S, 0
  cases.append(check(qs, kps, vps, scs, lens_s, 'server tick'))

  # The check can see a dropped rounding (f32 q, so that q's counts).
  args_f = (torch.randn((B, NK, G, H), generator=gen, device=dev), kps, vps,
            scs, lens_s, INT4G_GROUP)
  want_f = plain(*args_f)
  dropped = {}
  for which, what in enumerate(('q', 'K operand', 'V operand', 'probs'), 1):
    rel, share = int4g_ctx_diff(
        torch, plain_without_rounding(att, which, *args_f), want_f)
    dropped[what] = {'max_rel_err': rel, 'share_beyond_fine': share}
    if int4g_ctx_ok(rel, share):
      raise AssertionError(f'int4g check: passes a plain version without '
                           f'the {what} rounding ({rel}, share {share})')
  log(f'int4g check refuses the plain version without each rounding: '
      f'{dropped}')

  # The op: quantize the new rows, write them, attend; card against CPU.
  op = ir.Op(opcode='INT4G_ATTENTION_SCATTER', inputs=[], outputs=[],
             attrs={'group': INT4G_GROUP})
  ctx_op = impl.OpContext(op=op, subgraph=None, graph=None)
  k_rows = torch.randn((B, NK, 1, H), generator=gen, device=dev) + 0.8
  v_rows = torch.randn((B, NK, 1, H), generator=gen, device=dev)
  positions = (lens_s - 1).clamp_min(0).reshape(B, 1)
  op_in = (qs, k_rows, v_rows, kps, vps, scs, positions)
  on_card = impl.OPS['INT4G_ATTENTION_SCATTER'](ctx_op, *op_in)
  on_cpu = impl.OPS['INT4G_ATTENTION_SCATTER'](
      ctx_op, *(t.cpu() for t in op_in))
  sync()
  op_diff = {name: int(torch.sum(a.cpu().view(torch.int16 if a.dtype == bf16
                                             else a.dtype)
                                 != b.view(torch.int16 if b.dtype == bf16
                                           else b.dtype)))
             for name, a, b in zip(('k_pool', 'v_pool', 'sidecar'),
                                   on_card[1:], on_cpu[1:])}
  op_err = float(torch.max(torch.abs(on_card[0].float().cpu()
                                     - on_cpu[0].float())))
  op_rel, op_share = int4g_ctx_diff(torch, on_card[0].cpu(), on_cpu[0])
  log(f'INT4G_ATTENTION_SCATTER card against CPU: values that differ '
      f'{op_diff}, ctx err {op_err:.3g} ({op_rel:.3g} relative, share '
      f'beyond {INT4G_FINE_RTOL:g} {op_share:.4g})')
  if any(op_diff.values()):
    raise AssertionError(f'INT4G_ATTENTION_SCATTER: pools or sidecar differ '
                         f'from the CPU: {op_diff}')
  if not int4g_ctx_ok(op_rel, op_share):
    raise AssertionError(f'INT4G_ATTENTION_SCATTER: ctx {op_rel} relative, '
                         f'share {op_share}')

  # Timing at bench.py's step; SDPA over the dequantized bf16 pools.
  lengths = torch.full((BENCH_B,), BENCH_START + 1, dtype=i32, device=dev)
  args = (q, kp, vp, sc, lengths, INT4G_GROUP)
  kw = dict(out_dtype=bf16)
  scf = sc.float()
  grp = torch.arange(H, device=dev) // INT4G_GROUP
  k32 = kp.to(torch.int32)
  kcodes = torch.cat([k32 & 0xF, k32 >> 4], dim=-1).float()
  kd = (kcodes * scf[:, :, :NG].transpose(-1, -2)[..., grp]
        + scf[:, :, NG:2 * NG].transpose(-1, -2)[..., grp]).to(bf16)
  vd = (att.unpack_int4_rows(vp).float()
        * scf[:, :, 2 * NG:].transpose(-1, -2)[..., grp]).to(bf16)
  del k32, kcodes, scf
  amask = torch.where(
      torch.arange(S, device=dev)[None, :] < lengths[:, None], 0.0,
      float('-inf')).to(bf16).reshape(BENCH_B, 1, 1, S)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  live = NK * BENCH_B * (BENCH_START + 1)
  nbytes = (q.numel() * 2 + live * (H + 6 * NG) + lengths.numel() * 4
            + q.numel() * 2)
  b_ms, b_by = bound(nbytes, 4 * G * H * live, BF16_OPS_PER_S)
  ms = timer(lambda: kern(*args, **kw))
  plain_ms = timer(lambda: plain(*args, **kw))
  lib_ms = timer(lambda: sdpa(q, kd, vd, attn_mask=amask))
  log(f'kernel decode_attention_int4_group_lengths: {ms:.4f} ms at the bench '
      f'step (plain {plain_ms:.4f}, SDPA on bf16 pools {lib_ms:.4f}, bound '
      f'{b_ms:.4f} by {b_by}; {nbytes / 1e6:.1f} MB, {live} live rows)')
  return {
      'name': 'decode_attention_int4_group_lengths', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'attention_int4_group.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:1677',
      'jax': 'pallas_attention.decode_attention_int4_group_lengths',
      'wrapper': kern, 'per_step': 0, 'per_bench_step_int4g': cfg.num_layers,
      'per_tick_int4g': cfg.num_layers,
      'max_abs_err': max(c['max_abs_err'] for c in cases),
      'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
      'library_ms': lib_ms,
      'library': 'scaled_dot_product_attention over the pools dequantized '
                 'to bf16',
      'B': BENCH_B, 'live_rows': live, 'bytes': nbytes, 'cases': cases,
      'dropped_rounding_refused': dropped,
      'op_card_vs_cpu': {'values_differ': op_diff, 'ctx_max_abs_err': op_err,
                         'ctx_share_beyond_fine': op_share}}

QUANT_BLOCK = 32   # gemma_mixed48_b32's block size


def int_weight_kernels(torch, port, cfg, dev, timer, gen):
  """The int8 DRQ kernel and the weight-only kernel against their plain
  versions on the card, at the shapes the quantized serving graph gives
  them (GEMMA_2B, fused projections), decode rows (B) and a prefill
  pass's rows (PREFILL_ROWS; the prefill head reads PREFILL_BATCH rows).

  int8 DRQ (the attention FCs of gemma_mixed48 and _b32): QKV N 2560 and
  out-projection N 2048 at K 2048, bf16 x as the server runs it, and f32
  x with and without a bias: every output bit for bit (the row codes and
  the int32 sums are exact; the epilogue rounds as the plain version).
  Weight-only (the blockwise-32 FFN and head FCs of _b32): gate/up N 32768
  at K 2048, down N 2048 at K 16384, head N 256128 at K 2048, checked at
  bf16 x widened to f32 and at full-mantissa f32 x within
  int_qmatmul.int_weights_tolerance of max |y|, and its channelwise branch
  (no entry point reaches it) at N 2048, K 2048. Timed with bf16 x beside
  the plain versions and, where one PyTorch call computes the same
  contraction, that call; each kernel's headline times are the means of
  its decode shapes, as for the other matmuls."""
  iq, pq = port['int_qmatmul'], port['packed_qmatmul']
  D, F, V = cfg.embed_dim, cfg.ffn_dim, cfg.vocab_size
  NQ, NK, H = cfg.num_query_heads, cfg.num_kv_heads, cfg.head_dim
  bf16 = torch.bfloat16

  def randn(*shape):
    return torch.randn(shape, generator=gen, device=dev).to(bf16)

  def randint(lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device=dev).to(
        torch.int8)

  def scales(*shape):
    return torch.rand(shape, generator=gen, device=dev) * 0.01 + 0.005

  def bits_differ(a, b):
    view = torch.int16 if a.dtype == bf16 else torch.int32
    return int(torch.sum(a.view(view) != b.view(view)))

  drq_rows = []
  for phase, m in (('decode', B), ('prefill', PREFILL_ROWS)):
    for label, n, k in (('qkv', (NQ + 2 * NK) * H, D), ('out_proj', D, NQ * H)):
      x, w, s = randn(m, k), randint(-127, 128, n, k), scales(n)
      bias = torch.randn((n,), generator=gen, device=dev)
      cases = ((x, None), (x.float(), None), (x.float(), bias))
      differ = [bits_differ(iq.qmatmul_int8_drq(xi, w, s, bi),
                            iq.qmatmul_int8_drq_plain(xi, w, s, bi))
                for xi, bi in cases]
      sync()
      if any(differ):
        raise AssertionError(f'int8 DRQ {phase} {label}: {differ} outputs '
                             'differ from the plain version (bf16, f32, '
                             'f32 with bias)')
      xq = pq.quantize_rows_drq(x.float())[0]
      w_t = w.t()
      nbytes = m * k * 2 + n * k + n * 4 + m * n * 2
      b_ms, b_by = bound(nbytes, 2 * m * n * k, INT8_OPS_PER_S)
      plain_reps = 25 if phase == 'decode' else 5
      drq_rows.append({
          'phase': phase, 'shape': label, 'M': m, 'N': n, 'K': k,
          'outputs_differ': differ,
          'ms': timer(lambda: iq.qmatmul_int8_drq(x, w, s)),
          'plain_ms': timer(lambda: iq.qmatmul_int8_drq_plain(x, w, s),
                            reps=plain_reps),
          'library_ms': timer(lambda: torch._int_mm(xq, w_t)),
          'bound_ms': b_ms, 'bound_by': b_by})
  log(f'kernel qmatmul_int8_drq ok: bit for bit; {drq_rows}')

  wo_rows = []
  shapes = [('decode', B, 'gate_up', 2 * F, D), ('decode', B, 'down', D, F),
            ('decode', B, 'head', V, D),
            ('prefill', PREFILL_ROWS, 'gate_up', 2 * F, D),
            ('prefill', PREFILL_ROWS, 'down', D, F),
            ('prefill', PREFILL_BATCH, 'head', V, D),
            ('channelwise', B, 'out_proj', D, D)]
  for phase, m, label, n, k in shapes:
    bs = 0 if phase == 'channelwise' else QUANT_BLOCK
    x, w = randn(m, k), randint(-8, 8, n, k)
    s = scales(n, k // bs) if bs else scales(n)
    # bf16 values widened to f32 (every product exact) and f32 values with
    # a full mantissa (a kernel that rounded x would fail these).
    checks = {}
    for key, xi in (('bf16_x', x.float()),
                    ('f32_x', torch.randn((m, k), generator=gen, device=dev))):
      got = iq.qmatmul_int_weights(xi, w, s, block_size=bs)
      want = iq.qmatmul_int_weights_plain(xi, w, s, block_size=bs)
      sync()
      err = float(torch.max(torch.abs(got - want)))
      ymax = float(torch.max(torch.abs(want)))
      tol = iq.int_weights_tolerance(k, bs, ymax)
      if not err <= tol:
        raise AssertionError(f'weight-only {phase} {label} {key}: err {err} '
                             f'> {tol} (max |y| {ymax})')
      checks[key] = {'max_abs_err': err, 'max_abs_y': ymax, 'tolerance': tol}
      del got, want, xi
    # Both operands are exact in bf16 (int8 codes, bf16 x), so bf16 tensor
    # cores with f32 sums compute this function: their peak bounds it.
    nbytes = m * k * 2 + n * k + s.numel() * 4 + m * n * 2
    b_ms, b_by = bound(nbytes, 2 * m * n * k, BF16_OPS_PER_S)
    row = {'phase': phase, 'shape': label, 'M': m, 'N': n, 'K': k,
           'block_size': bs,
           'max_abs_err': max(c['max_abs_err'] for c in checks.values()),
           'checks': checks,
           'ms': timer(lambda: iq.qmatmul_int_weights(x, w, s,
                                                      block_size=bs)),
           'plain_ms': timer(lambda: iq.qmatmul_int_weights_plain(
               x, w, s, block_size=bs),
                             reps=25 if m <= B else 3, warmup=1),
           'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None}
    if not bs:
      wf, x32 = w.float(), x.float()
      row['library_ms'] = timer(lambda: torch.matmul(x32, wf.T))
    wo_rows.append(row)
  log(f'kernel qmatmul_int_weights ok: {wo_rows}')

  def mean(rows, key, phase):
    vals = [r[key] for r in rows if r['phase'] == phase]
    return sum(vals) / len(vals)

  def summary(rows, phase, keys):
    return {key: mean(rows, key, phase) for key in keys}

  timing = ('ms', 'plain_ms', 'bound_ms', 'library_ms')
  blockwise = [r for r in wo_rows if r['block_size']]
  return [{
      'name': 'qmatmul_int8_drq', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/qmatmul_int8_drq.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py:553',
      'jax': 'pallas_qmatmul.qmatmul_pallas_int8_drq',
      'wrapper': iq.qmatmul_int8_drq, 'per_step': 0,
      'per_tick_quantized': 2 * QUANT_LAYERS['gemma_mixed48'],
      'max_abs_err': 0.0,
      **summary(drq_rows, 'decode', timing),
      'bound_by': drq_rows[0]['bound_by'],
      'library': 'torch._int_mm on the codes (contraction only)',
      'prefill': summary(drq_rows, 'prefill', timing), 'by_shape': drq_rows},
      {
      'name': 'qmatmul_int_weights', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'qmatmul_int_weights.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py:753',
      'jax': 'pallas_qmatmul.qmatmul_pallas (blockwise and channelwise)',
      'wrapper': iq.qmatmul_int_weights, 'per_step': 0,
      'per_tick_quantized_b32': 2 * QUANT_LAYERS['gemma_mixed48_b32'] + 1,
      'max_abs_err': max(r['max_abs_err'] for r in blockwise),
      **summary(blockwise, 'decode', ('ms', 'plain_ms', 'bound_ms')),
      'bound_by': wo_rows[0]['bound_by'], 'library_ms': None,
      'prefill': summary(blockwise, 'prefill', ('ms', 'plain_ms',
                                                'bound_ms')),
      'library': 'none for the blockwise branch; torch.matmul on f32 '
                 'weights for the channelwise one (by_shape)',
      'by_shape': wo_rows}]


# The K-blocked kernel's checks: (label, M, N, K). The server's down
# projection at decode and prefill rows, then M = 1, an odd M, one ragged K
# step (K/2 = 528 bytes) and two full steps with a ragged third (2080).
KBLOCK_SHAPES = (('decode', B, None, None), ('prefill', PREFILL_ROWS, None,
                                             None),
                 ('m1', 1, 256, None), ('odd_m', 37, 256, None),
                 ('small_k', 37, 256, 1056), ('ragged_k', 64, 256, 4160))


def kblock_kernel(torch, port, cfg, dev, timer, gen):
  """The K-blocked int4 DRQ kernel against its plain version on the card,
  at KBLOCK_SHAPES (N = D and K = F, gemma_mixed48_hr's down projection,
  where a shape leaves them None); bf16 and f32 x, with and without a
  bias, every output bit for bit (the codes divide as the plain version
  does, the int32 sums are exact, the epilogue rounds in the same order).
  Timed at decode and prefill with bf16 x and no bias (the server's down
  FC) beside the plain version and torch._int_mm on the codes (the
  contraction only; it needs M > 16). A K the kernel does not take must be
  refused."""
  pq = port['packed_qmatmul']
  bf16 = torch.bfloat16

  def bits_differ(a, b):
    view = torch.int16 if a.dtype == bf16 else torch.int32
    return int(torch.sum(a.view(view) != b.view(view)))

  rows = []
  for phase, m, n, k in KBLOCK_SHAPES:
    n, k = n or cfg.embed_dim, k or cfg.ffn_dim
    x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
    w = pq.pack_int4_split(torch.randint(-8, 8, (n, k), generator=gen,
                                         device=dev).to(torch.int8))
    s = torch.rand((n,), generator=gen, device=dev) * 0.01 + 0.005
    bias = torch.randn((n,), generator=gen, device=dev)
    cases = ((x, None), (x, bias), (x.float(), None), (x.float(), bias))
    differ = [bits_differ(pq.qmatmul_int4_packed_drq_kblock(xi, w, s, bi),
                          pq.qmatmul_int4_packed_drq_kblock_plain(xi, w, s,
                                                                  bi))
              for xi, bi in cases]
    sync()
    if any(differ):
      raise AssertionError(f'K-blocked int4 DRQ {phase} (M {m}, N {n}, K '
                           f'{k}): {differ} outputs differ from the plain '
                           'version (bf16, bf16 with bias, f32, f32 with '
                           'bias)')
    row = {'phase': phase, 'M': m, 'N': n, 'K': k, 'outputs_differ': differ}
    if phase in ('decode', 'prefill'):
      xq = pq.quantize_rows_drq_div(x.float())[0]
      w_t = pq.unpack_int4_split(w).t()
      nbytes = m * k * 2 + n * k // 2 + n * 4 + m * n * 2
      b_ms, b_by = bound(nbytes, 2 * m * n * k, INT8_OPS_PER_S)
      row.update(
          ms=timer(lambda: pq.qmatmul_int4_packed_drq_kblock(x, w, s)),
          plain_ms=timer(lambda: pq.qmatmul_int4_packed_drq_kblock_plain(
              x, w, s), reps=25 if phase == 'decode' else 5),
          library_ms=timer(lambda: torch._int_mm(xq, w_t)),
          bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
  log(f'kernel qmatmul_int4_packed_drq_kblock ok: bit for bit; {rows}')

  x = torch.randn((4, 48), device=dev)
  w = torch.zeros((256, 24), dtype=torch.uint8, device=dev)
  s = torch.ones((256,), device=dev)
  try:
    pq.qmatmul_int4_packed_drq_kblock(x, w, s)
  except ValueError as e:
    log(f'K-blocked kernel refuses K 48: {e}')
  else:
    raise AssertionError('the K-blocked kernel took K = 48')

  def at(phase):
    r = next(r for r in rows if r['phase'] == phase)
    return {key: r[key] for key in ('ms', 'plain_ms', 'bound_ms',
                                    'library_ms')}

  return {
      'name': 'qmatmul_int4_packed_drq_kblock', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'qmatmul_int4_drq_kblock.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py:882',
      'jax': 'pallas_qmatmul.qmatmul_pallas_int4_packed_drq_kblock',
      'wrapper': pq.qmatmul_int4_packed_drq_kblock, 'per_step': 0,
      'per_tick_quantized_hr': QUANT_LAYERS['gemma_mixed48_hr'],
      'max_abs_err': 0.0,
      **at('decode'), 'bound_by': rows[0]['bound_by'],
      'library': 'torch._int_mm on the codes (contraction only)',
      'prefill': at('prefill'), 'by_shape': rows}


def default_mode_kernels(torch, port, cfg, dev, timer, gen):
  """The kernels of the JAX executor's default mode (AEQT_INT4_DRQ=0,
  AEQT_ATTN_LENGTHS=0) against their plain versions on the card, at the
  shapes the default-mode server gives them (GEMMA_2B, bf16 activations as
  the server runs them, f32 as the op-by-op phase does):

  * the weight-only packed matmul (QKV N 2560 and out-projection N 2048 at
    K 2048; decode rows B, a prefill pass's rows and an odd M; bf16 and
    full-mantissa f32 x, with and without a bias): f32 outputs within
    int_qmatmul.int_weights_tolerance of max |y| (f32 sums in another
    order), bf16 outputs within one bf16 ulp beyond it; timed beside
    torch.matmul on the weight dequantized to bf16;
  * the additive-mask decode attention (B 64 and 256, S 1024, zero points
    3 and -2; the graph's [B, 1, 1, S] prefix mask, the same broadcast to
    [B, 1, G, S], and a non-prefix [B, 1, G, S] mask with one row hidden
    everywhere): within 1e-5 of max(max |y|, 1) (f32 sums in another
    order); timed beside scaled_dot_product_attention over the pools
    dequantized to bf16 with the mask;
  * the MLP's weight-only branch (bf 512, gelu; decode and prefill rows):
    bf16 x within one bf16 ulp beyond 1e-3 of max |y| (a sum in another
    order can round a bf16 hidden value the other way), f32 x within 1e-5
    of max |y|;
  * the head's weight-only branch (packed int4 and int8 weights, N 256128,
    M B and BENCH_B): with a planted winner (two equal rows of the largest
    code in different vocab tiles, scaled to win, and positive x) every id
    is the first of the two; without
    it, an id may differ from the plain version's only where the plain
    top-2 logit margin is within the kernel's logit error
    (int_weights_tolerance of the largest |logit| plus one bf16 ulp of the
    winner, the cast_dt rounding)."""
  pq, att, mlp, head = (port['packed_qmatmul'], port['attention'],
                        port['mlp'], port['head'])
  iq = port['int_qmatmul']
  D, F, V = cfg.embed_dim, cfg.ffn_dim, cfg.vocab_size
  NQ, NK, H = cfg.num_query_heads, cfg.num_kv_heads, cfg.head_dim
  S = cfg.max_seq_len
  G = NQ // NK
  L = QUANT_LAYERS.get(DEFAULT_MODE, cfg.num_layers)  # the server's depth
  bf16 = torch.bfloat16

  def randn(*shape, dtype=bf16):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)

  def randint(lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device=dev).to(
        torch.int8)

  def scales(n):
    return torch.rand((n,), generator=gen, device=dev) * 0.01 + 0.005

  def mean(rows, key, phase):
    vals = [r[key] for r in rows if r['phase'] == phase]
    return sum(vals) / len(vals)

  timing = ('ms', 'plain_ms', 'bound_ms', 'library_ms')
  results = []

  # 1. Weight-only packed int4 matmul (#12).
  wo_rows = []
  for phase, m in (('decode', B), ('prefill', PREFILL_ROWS), ('odd_m', 37)):
    for label, n, k in (('qkv', (NQ + 2 * NK) * H, D),
                        ('out_proj', D, NQ * H)):
      w = pq.pack_int4_split(randint(-8, 8, n, k))
      s = scales(n)
      bias = torch.randn((n,), generator=gen, device=dev)
      x = randn(m, k)
      x32 = torch.randn((m, k), generator=gen, device=dev)
      checks = []
      for xi, bi in ((x, None), (x, bias), (x32, None), (x32, bias)):
        got = pq.qmatmul_int4_packed(xi, w, s, bi)
        want = pq.qmatmul_int4_packed_plain(xi, w, s, bi)
        sync()
        ymax = float(torch.max(torch.abs(want.float())))
        tol = iq.int_weights_tolerance(k, 0, ymax)
        err = float(torch.max(torch.abs(got.float() - want.float())))
        ulps = bf16_ulps(torch, got, want, atol=tol) if xi.dtype == bf16 \
            else None
        if (ulps is not None and ulps > 1.0) or (ulps is None
                                                 and not err <= tol):
          raise AssertionError(
              f'weight-only packed {phase} {label} ({xi.dtype}, bias '
              f'{bi is not None}): err {err}, tolerance {tol}, bf16 ulps '
              f'beyond it {ulps}')
        checks.append({'x': str(xi.dtype).split('.')[-1],
                       'bias': bi is not None, 'max_abs_err': err,
                       'max_abs_y': ymax, 'tolerance': tol,
                       'bf16_ulps_beyond': ulps})
      row = {'phase': phase, 'shape': label, 'M': m, 'N': n, 'K': k,
             'max_abs_err': max(c['max_abs_err'] for c in checks),
             'checks': checks}
      if phase != 'odd_m':
        wdq = (pq.unpack_int4_split(w).float() * s[:, None]).to(bf16)
        nbytes = m * k * 2 + n * k // 2 + n * 4 + m * n * 2
        b_ms, b_by = bound(nbytes, 2 * m * n * k, BF16_OPS_PER_S)
        row.update(
            ms=timer(lambda: pq.qmatmul_int4_packed(x, w, s)),
            plain_ms=timer(lambda: pq.qmatmul_int4_packed_plain(x, w, s),
                           reps=25 if phase == 'decode' else 5),
            library_ms=timer(lambda: torch.matmul(x, wdq.T)),
            bound_ms=b_ms, bound_by=b_by)
      wo_rows.append(row)
  log(f'kernel qmatmul_int4_packed ok: {wo_rows}')
  results.append({
      'name': 'qmatmul_int4_packed', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'qmatmul_int4_weight_only.cuh',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py:199',
      'jax': 'pallas_qmatmul.qmatmul_pallas_int4_packed',
      'wrapper': pq.qmatmul_int4_packed, 'per_step': 0,
      'per_tick_default_mode': 2 * L,
      'max_abs_err': max(r['max_abs_err'] for r in wo_rows),
      **{key: mean(wo_rows, key, 'decode') for key in timing},
      'bound_by': next(r['bound_by'] for r in wo_rows
                       if r['phase'] == 'decode'),
      'library': 'torch.matmul on the weight dequantized to bf16',
      'prefill': {key: mean(wo_rows, key, 'prefill') for key in timing},
      'by_shape': wo_rows})

  # 2. Additive-mask decode attention (#17).
  k_scale, v_scale, zp_k, zp_v = 0.06, 0.06, 3.0, -2.0
  sdpa = torch.nn.functional.scaled_dot_product_attention
  att_rows = []
  for b in (B, BENCH_B):
    q = randn(b, NK, G, H)
    kc, vc = randint(-127, 128, b, NK, S, H), randint(-127, 128, b, NK, S, H)
    lengths = torch.randint(1, S + 1, (b,), generator=gen, device=dev)
    lengths[0], lengths[-1] = 1, S
    prefix = torch.where(torch.arange(S, device=dev)[None, :]
                         < lengths[:, None], 0.0, -1e9).reshape(b, 1, 1, S)
    holes = torch.where(torch.rand((b, 1, G, S), generator=gen, device=dev)
                        < 0.4, -1e9, 0.0)
    holes[0, 0, 1] = -1e9  # one query row hidden everywhere: uniform
    masks = {'prefix_row': prefix,
             'prefix_g': prefix.expand(b, 1, G, S).contiguous(),
             'nonprefix': holes}
    kd = ((kc.float() - zp_k) * k_scale).to(bf16)
    vd = ((vc.float() - zp_v) * v_scale).to(bf16)
    for mname, mask in masks.items():
      args = (q, kc, vc, k_scale, v_scale, mask)
      kw = dict(k_zero_point=zp_k, v_zero_point=zp_v)
      got = att.decode_attention_int8_masked(*args, **kw)
      want = att.decode_attention_int8_masked_plain(*args, **kw)
      sync()
      err = float(torch.max(torch.abs(got - want)))
      ymax = float(torch.max(torch.abs(want)))
      if not err <= 1e-5 * max(ymax, 1.0):
        raise AssertionError(f'masked attention B {b} {mname}: err {err}, '
                             f'max |y| {ymax}')
      row = {'phase': 'decode' if b == B else 'bench', 'B': b, 'mask': mname,
             'mask_shape': list(mask.shape), 'max_abs_err': err,
             'max_abs_y': ymax}
      if mname != 'prefix_g':
        nbytes = (q.numel() * 2 + kc.numel() + vc.numel()
                  + mask.numel() * 4 + got.numel() * 4)
        b_ms, b_by = bound(nbytes, 4 * b * NK * G * S * H, F32_OPS_PER_S)
        mask_bf16 = mask.to(bf16)
        row.update(
            ms=timer(lambda: att.decode_attention_int8_masked(*args, **kw)),
            plain_ms=timer(
                lambda: att.decode_attention_int8_masked_plain(*args, **kw)),
            library_ms=timer(lambda: sdpa(q, kd, vd, attn_mask=mask_bf16)),
            bound_ms=b_ms, bound_by=b_by)
      att_rows.append(row)
  log(f'kernel decode_attention_int8_masked ok: {att_rows}')

  def att_at(b, mname):
    r = next(r for r in att_rows if r['B'] == b and r['mask'] == mname)
    return {key: r[key] for key in timing}

  results.append({
      'name': 'decode_attention_int8_masked', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/attention_masked.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:1085',
      'jax': 'pallas_attention.decode_attention_int8_masked (f32 compute)',
      'wrapper': att.decode_attention_int8_masked, 'per_step': 0,
      'per_tick_default_mode': L,
      'max_abs_err': max(r['max_abs_err'] for r in att_rows),
      **att_at(B, 'prefix_row'),
      'bound_by': next(r['bound_by'] for r in att_rows if 'bound_by' in r),
      'library': 'scaled_dot_product_attention with the mask over the pools '
                 'dequantized to bf16',
      'bench': att_at(BENCH_B, 'prefix_row'),
      'nonprefix': att_at(B, 'nonprefix'), 'by_shape': att_rows})

  # 3. The MLP's weight-only branch (#3, drq=False), bf 512.
  bf = 512
  wgu = pq.pack_int4_split(randint(-8, 8, 2 * F, D))
  sgu = scales(2 * F)
  wd = mlp.pack_int4_split_grouped(randint(-8, 8, D, F), bf)
  sd = scales(D)
  mlp_rows = {}
  for phase, m in (('decode', B), ('prefill', PREFILL_ROWS)):
    x = randn(m, 1, D)
    margs = (x, wgu, sgu, wd, sd)
    checks = {}
    for key, xi in (('bf16_x', x), ('f32_x', torch.randn(
        (m, 1, D), generator=gen, device=dev))):
      got = mlp.mlp_int4_packed_bf16(xi, *margs[1:], bf=bf)
      want = mlp.mlp_int4_packed_plain(xi, *margs[1:], drq=False, bf=bf)
      sync()
      err = float(torch.max(torch.abs(got.float() - want.float())))
      ymax = float(torch.max(torch.abs(want.float())))
      if key == 'bf16_x':
        ulps = bf16_ulps(torch, got, want, atol=1e-3 * ymax)
        bad = ulps > 1.0
      else:
        ulps, bad = None, not err <= 1e-5 * ymax
      if bad:
        raise AssertionError(f'mlp bf16 branch {phase} {key}: err {err}, '
                             f'max |y| {ymax}, bf16 ulps beyond 1e-3 of it '
                             f'{ulps}')
      checks[key] = {'max_abs_err': err, 'max_abs_y': ymax,
                     'bf16_ulps_beyond': ulps}
      del got, want
    nbytes = (m * D * 2 + 2 * F * D // 2 + 2 * F * 4 + D * F // 2 + D * 4
              + m * D * 2)
    b_ms, b_by = bound(nbytes, 3 * 2 * m * F * D, BF16_OPS_PER_S)
    mlp_rows[phase] = {
        'M': m, 'max_abs_err': max(c['max_abs_err'] for c in checks.values()),
        'checks': checks,
        'ms': timer(lambda: mlp.mlp_int4_packed_bf16(*margs, bf=bf)),
        'plain_ms': timer(
            lambda: mlp.mlp_int4_packed_plain(*margs, drq=False, bf=bf),
            reps=25 if phase == 'decode' else 5),
        'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None}
  log(f'kernel mlp_int4_packed_bf16 ok: {mlp_rows}')
  dec = mlp_rows['decode']
  results.append({
      'name': 'mlp_int4_packed_bf16', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/mlp_int4_bf16.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_mlp.py:268',
      'jax': 'pallas_mlp.mlp_pallas_int4_packed (drq=False)',
      'wrapper': mlp.mlp_int4_packed_bf16, 'per_step': 0,
      'per_tick_default_mode': L, 'max_abs_err': dec['max_abs_err'],
      **{key: dec[key] for key in timing}, 'bound_by': dec['bound_by'],
      'prefill': mlp_rows['prefill']})

  # 4. The head's weight-only branch (#4, drq=False), N = V.
  head_rows = []
  for packed in (True, False):
    w_q = randint(-8, 8, V, D) if packed else randint(-127, 128, V, D)
    w = pq.pack_int4_split(w_q) if packed else w_q
    del w_q
    top = 0x77 if packed else 127  # every value of a row 7 or 127
    for m in (B, BENCH_B):
      for planted in (True, False):
        x = randn(m, 1, D)
        s = scales(V)
        if planted:
          # Rows 100 and V - 100 equal, every value the largest code, and
          # scaled to win: with positive x they win every row, tied.
          x = torch.abs(x) + 0.1
          w[100] = w[V - 100] = top
          s[100] = s[V - 100] = 1.0
        hkw = dict(packed=packed, true_n=V - 64)
        got = head.head_argmax_bf16(x, w, s, **hkw)
        want = head.head_argmax_plain(x, w, s, drq=False, **hkw)
        logits = head.head_logits_plain(x.reshape(m, D), w, s, drq=False,
                                        **hkw)
        sync()
        top2 = torch.topk(logits, 2, dim=-1).values
        lmax = float(torch.max(torch.abs(top2[:, 0])))
        tol = iq.int_weights_tolerance(D, 0, lmax)
        ulp = torch.exp2(torch.floor(torch.log2(torch.abs(top2[:, 0]))) - 7)
        margin = top2[:, 0] - top2[:, 1]
        differ = (got.reshape(-1) != want.reshape(-1))
        unclear = differ & (margin > tol + ulp)
        if int(torch.sum(unclear)) or (planted and not bool(
            torch.all(got == 100))):
          raise AssertionError(
              f'head bf16 branch packed {packed} M {m} planted {planted}: '
              f'{int(torch.sum(differ))} ids differ, {int(torch.sum(unclear))}'
              f' with a clear margin; ids {got.reshape(-1)[:8].tolist()}')
        # The plain logit the kernel's id gave up: 0 where the ids agree.
        rows_d = torch.nonzero(differ).flatten()
        gap = float(torch.max(
            logits[rows_d, want.reshape(-1)[rows_d].long()]
            - logits[rows_d, got.reshape(-1)[rows_d].long()])) if len(
                rows_d) else 0.0
        row = {'packed': packed, 'M': m, 'planted': planted,
               'ids_differ': int(torch.sum(differ)), 'winner_logit_gap': gap,
               'smallest_margin': float(torch.min(margin)),
               'logit_tolerance': tol}
        if planted:
          kb = D // 2 if packed else D
          nbytes = m * D * 2 + V * kb + V * 4 + m * 4
          b_ms, b_by = bound(nbytes, 2 * m * V * D, BF16_OPS_PER_S)
          row.update(
              ms=timer(lambda: head.head_argmax_bf16(x, w, s, **hkw)),
              plain_ms=timer(lambda: head.head_argmax_plain(
                  x, w, s, drq=False, **hkw), reps=5, warmup=1),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
        head_rows.append(row)
        del logits, top2
    del w
    torch.cuda.empty_cache()
  log(f'kernel head_argmax_bf16 ok: {head_rows}')

  def head_at(packed, m):
    r = next(r for r in head_rows if r['packed'] == packed and r['M'] == m
             and r['planted'])
    return {key: r[key] for key in timing}

  results.append({
      'name': 'head_argmax_bf16', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/head_argmax.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_head.py:169',
      'jax': 'pallas_head.head_argmax_pallas (packed int4 and int8, '
             'drq=False)',
      'wrapper': head.head_argmax_bf16, 'per_step': 0,
      'per_tick_default_mode': 1,
      'max_abs_err': max(r['winner_logit_gap'] for r in head_rows),
      **head_at(True, B), 'bound_by': head_rows[0]['bound_by'],
      'int8': head_at(False, B), 'bench': head_at(True, BENCH_B),
      'by_shape': head_rows})
  return results

# The blockwise packed matmul's checks: (phase, M, label, N, K, block size).
# Every FC of the blockwise-128 server (Gemma-2B, fused projections, the
# tied head) at decode and prefill rows, and block size 256 at one shape.
def blockwise_shapes(cfg):
  D, F, V = cfg.embed_dim, cfg.ffn_dim, cfg.vocab_size
  NQ, NK, H = cfg.num_query_heads, cfg.num_kv_heads, cfg.head_dim
  fcs = (('qkv', (NQ + 2 * NK) * H, D), ('out_proj', D, NQ * H),
         ('gate_up', 2 * F, D), ('down', D, F), ('head', V, D))
  return ([(phase, m, label, n, k, 128)
           for phase, m in (('decode', B), ('prefill', PREFILL_ROWS))
           for label, n, k in fcs]
          + [('decode_bs256', B, 'qkv', (NQ + 2 * NK) * H, D, 256)])


def blockwise_kernel(torch, port, cfg, dev, timer, gen):
  """The blockwise packed int4 matmul (#13) against its plain version on
  the card at blockwise_shapes: bf16 x (the server's) and full-mantissa f32
  x, with and without a bias. f32 outputs within
  int_qmatmul.int_weights_tolerance(K, bs) of max |y| (f32 sums in another
  order within a block), bf16 outputs within one bf16 ulp beyond it. Timed
  with bf16 x and no bias beside the plain version and torch.matmul on the
  weight dequantized to bf16 (scales per block applied); the headline
  times are the means of the decode QKV and out-projection shapes, as for
  #12."""
  pq, iq = port['packed_qmatmul'], port['int_qmatmul']
  bf16 = torch.bfloat16
  rows = []
  for phase, m, label, n, k, bs in blockwise_shapes(cfg):
    w = pq.pack_int4_split(torch.randint(-8, 8, (n, k), generator=gen,
                                         device=dev).to(torch.int8))
    s = torch.rand((n, k // bs), generator=gen, device=dev) * 0.01 + 0.005
    bias = torch.randn((n,), generator=gen, device=dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
    x32 = torch.randn((m, k), generator=gen, device=dev)
    checks = []
    for xi, bi in ((x, None), (x, bias), (x32, None), (x32, bias)):
      got = pq.qmatmul_int4_packed_blockwise(xi, w, s, bi)
      want = pq.qmatmul_int4_packed_blockwise_plain(xi, w, s, bi)
      sync()
      ymax = float(torch.max(torch.abs(want.float())))
      tol = iq.int_weights_tolerance(k, bs, ymax)
      err = float(torch.max(torch.abs(got.float() - want.float())))
      ulps = (bf16_ulps(torch, got, want, atol=tol) if xi.dtype == bf16
              else None)
      if (ulps is not None and ulps > 1.0) or (ulps is None
                                               and not err <= tol):
        raise AssertionError(
            f'blockwise packed {phase} {label} (bs {bs}, {xi.dtype}, bias '
            f'{bi is not None}): err {err}, tolerance {tol}, bf16 ulps '
            f'beyond it {ulps}')
      checks.append({'x': str(xi.dtype).split('.')[-1],
                     'bias': bi is not None, 'max_abs_err': err,
                     'max_abs_y': ymax, 'tolerance': tol,
                     'bf16_ulps_beyond': ulps})
      del got, want
    big = n * k >= 2**28
    wdq = (pq.unpack_int4_split(w).to(bf16).reshape(n, k // bs, bs)
           * s[:, :, None].to(bf16)).reshape(n, k)
    nbytes = m * k * 2 + n * k // 2 + s.numel() * 4 + m * n * 2
    b_ms, b_by = bound(nbytes, 2 * m * n * k, BF16_OPS_PER_S)
    rows.append({
        'phase': phase, 'shape': label, 'M': m, 'N': n, 'K': k,
        'block_size': bs,
        'max_abs_err': max(c['max_abs_err'] for c in checks),
        'checks': checks,
        'ms': timer(lambda: pq.qmatmul_int4_packed_blockwise(x, w, s)),
        'plain_ms': timer(
            lambda: pq.qmatmul_int4_packed_blockwise_plain(x, w, s),
            reps=25 if m <= B and not big else 3, warmup=1),
        'library_ms': timer(lambda: torch.matmul(x, wdq.T)),
        'bound_ms': b_ms, 'bound_by': b_by})
    del w, s, wdq, x, x32
    torch.cuda.empty_cache()
  log(f'kernel qmatmul_int4_packed_blockwise ok: {rows}')
  timing = ('ms', 'plain_ms', 'bound_ms', 'library_ms')

  def mean(phase):
    sel = [r for r in rows if r['phase'] == phase
           and r['shape'] in ('qkv', 'out_proj')]
    return {key: sum(r[key] for r in sel) / len(sel) for key in timing}

  return {
      'name': 'qmatmul_int4_packed_blockwise', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'qmatmul_int4_blockwise.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py:461',
      'jax': 'pallas_qmatmul.qmatmul_pallas_int4_packed_blockwise',
      'wrapper': pq.qmatmul_int4_packed_blockwise, 'per_step': 0,
      'per_tick_blockwise': 4 * cfg.num_layers + 1,
      'max_abs_err': max(r['max_abs_err'] for r in rows),
      **mean('decode'), 'bound_by': rows[0]['bound_by'],
      'library': 'torch.matmul on the weight dequantized to bf16',
      'prefill': mean('prefill'), 'by_shape': rows}


def cache_row_kernel(torch, port, cfg, dev, timer, gen):
  """The in-place row write (#11) against its plain version on the card at
  bench.py's decode shape (a [256, 1, 1024, 256] int8 pool, one row): the
  pool bit for bit, written in its own storage, at rows 0, 31, 32, 896 and
  1023 and at starts that lax clips (5000 and -3 on the row axis, 7 on a
  full-extent axis). Timed at row 896 beside one slice assignment."""
  cache = port['cache']
  NK, H, S = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
  pool = torch.randint(-127, 128, (BENCH_B, NK, S, H), generator=gen,
                       device=dev).to(torch.int8)
  upd = torch.randint(-127, 128, (BENCH_B, NK, 1, H), generator=gen,
                      device=dev).to(torch.int8)
  cases = []
  for starts in ((0, 0, 0, 0), (0, 0, 31, 0), (0, 0, 32, 0),
                 (0, 0, BENCH_START, 0),
                 (0, 0, S - 1, 0), (0, 0, 5000, 0), (0, 0, -3, 0),
                 (7, 0, 100, 0)):
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    got_pool, want_pool = pool.clone(), pool.clone()
    got = cache.dus_row_inplace(got_pool, upd, st)
    cache.dus_row_inplace_plain(want_pool, upd, st)
    sync()
    if got.data_ptr() != got_pool.data_ptr() or not torch.equal(
        got_pool, want_pool):
      raise AssertionError(f'row write at starts {starts}: differs from the '
                           'plain version or not in place')
    cases.append(list(starts))
  st = torch.tensor((0, 0, BENCH_START, 0), dtype=torch.int32, device=dev)
  work = pool.clone()

  def assign():
    work[:, :, BENCH_START:BENCH_START + 1] = upd

  nbytes = 2 * upd.numel() + st.numel() * 4
  b_ms, b_by = bound(nbytes, 0, F32_OPS_PER_S)
  log(f'kernel dus_row_inplace ok: bit for bit, in place, starts {cases}')
  return {
      'name': 'dus_row_inplace', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/cache_row_write.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_cache.py:105',
      'jax': 'pallas_cache.dus_row_inplace_pallas',
      'wrapper': cache.dus_row_inplace, 'per_step': 0,
      'per_step_bench_inplace': 2 * cfg.num_layers, 'max_abs_err': 0.0,
      'starts_checked': cases,
      'ms': timer(lambda: cache.dus_row_inplace(work, upd, st)),
      'plain_ms': timer(lambda: cache.dus_row_inplace_plain(work, upd, st)),
      'bound_ms': b_ms, 'bound_by': b_by,
      'library_ms': timer(assign),
      'library': 'one slice assignment pool[:, :, p:p+1] = update (host p)'}


def attention_lengths_mask(torch, lengths, s, dtype):
  """The additive [B, 1, 1, S] mask of prefix lengths (-inf past them) for
  scaled_dot_product_attention; a length of 0 hides every row."""
  return torch.where(
      torch.arange(s, device=lengths.device)[None, :] < lengths[:, None],
      0.0, float('-inf')).to(dtype).reshape(-1, 1, 1, s)


def writeback_kernel(torch, att, cfg, dev, timer, gen):
  """The splice attention (#8) against its plain version on the card at
  bench.py's decode shape (B 256, one KV head, G 8, H 256, S 1024), pos
  896 and 0, 31, 32, S - 1; lengths pos + 1 but for a shorter row and a
  zero-length one: f32 context within 1e-5 of max(max |y|, 1) (f32 sums
  in another order over up to 1024 rows), bf16 (the executor's output)
  within one bf16 ulp beyond that, both pools bit for bit (each side on
  its own copies) and written in place. Timed at pos 896 beside SDPA over
  the pools dequantized to bf16 with the lengths mask."""
  NK, H, S = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
  G = cfg.num_query_heads // NK
  b = BENCH_B
  bf16 = torch.bfloat16
  q = torch.randn((b, NK, G, H), generator=gen, device=dev).to(bf16)
  kc, vc = (torch.randint(-127, 128, (b, NK, S, H), generator=gen,
                          device=dev).to(torch.int8) for _ in range(2))
  kn, vn = (torch.randint(-127, 128, (b, NK, 1, H), generator=gen,
                          device=dev).to(torch.int8) for _ in range(2))
  k_scale, v_scale, zp_k, zp_v = 0.06, 0.06, 3.0, -2.0
  checks = []
  for pos in (BENCH_START, 0, 31, 32, S - 1):
    lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
    lengths[1], lengths[2] = max(pos - 20, 1), 0
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    errs = {}
    for out_dtype in (torch.float32, bf16):
      gk, gv, wk, wv = kc.clone(), vc.clone(), kc.clone(), vc.clone()
      args = (k_scale, v_scale, lengths, kn, vn, p)
      kw = dict(k_zero_point=zp_k, v_zero_point=zp_v, out_dtype=out_dtype)
      got, ko, vo = att.decode_attention_int8_lengths_writeback(
          q, gk, gv, *args, **kw)
      want, _, _ = att.decode_attention_int8_lengths_writeback_plain(
          q, wk, wv, *args, **kw)
      sync()
      if (ko.data_ptr(), vo.data_ptr()) != (gk.data_ptr(), gv.data_ptr()) \
          or not (torch.equal(gk, wk) and torch.equal(gv, wv)):
        raise AssertionError(f'splice attention pos {pos}: pools differ from '
                             'the plain version or not in place')
      if out_dtype == torch.float32:
        errs['f32'] = float(torch.max(torch.abs(got - want)))
        errs['max_abs_y'] = float(torch.max(torch.abs(want)))
        tol = 1e-5 * max(errs['max_abs_y'], 1.0)
      else:
        errs['bf16_ulps'] = bf16_ulps(torch, got, want, atol=tol)
    if errs['f32'] > tol or errs['bf16_ulps'] > 1.0:
      raise AssertionError(f'splice attention pos {pos}: {errs}')
    checks.append({'pos': pos, **errs})
  lengths = torch.full((b,), BENCH_START + 1, dtype=torch.int32, device=dev)
  p = torch.tensor([BENCH_START], dtype=torch.int32, device=dev)
  gk, gv = kc.clone(), vc.clone()
  args = (q, gk, gv, k_scale, v_scale, lengths, kn, vn, p)
  kw = dict(k_zero_point=zp_k, v_zero_point=zp_v, out_dtype=bf16)
  live = NK * b * (BENCH_START + 1)
  nbytes = q.numel() * 2 + 2 * live * H + 4 * kn.numel() + q.numel() * 2
  b_ms, b_by = bound(nbytes, 4 * G * H * live, F32_OPS_PER_S)
  kd = ((gk.float() - zp_k) * k_scale).to(bf16)
  vd = ((gv.float() - zp_v) * v_scale).to(bf16)
  amask = attention_lengths_mask(torch, lengths, S, bf16)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  log(f'kernel decode_attention_int8_lengths_writeback ok: {checks}')
  return {
      'name': 'decode_attention_int8_lengths_writeback', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'attention_writeback.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:850',
      'jax': 'pallas_attention.decode_attention_int8_lengths_writeback '
             '(f32 compute)',
      'wrapper': att.decode_attention_int8_lengths_writeback, 'per_step': 0,
      'per_step_bench_splice': cfg.num_layers,
      'max_abs_err': max(c['f32'] for c in checks), 'checks': checks,
      'ms': timer(lambda: att.decode_attention_int8_lengths_writeback(
          *args, **kw)),
      'plain_ms': timer(
          lambda: att.decode_attention_int8_lengths_writeback_plain(
              *args, **kw)),
      'bound_ms': b_ms, 'bound_by': b_by,
      'library_ms': timer(lambda: sdpa(q, kd, vd, attn_mask=amask)),
      'library': 'scaled_dot_product_attention over the pools dequantized '
                 'to bf16 with the lengths mask (no row write)',
      'live_rows': live}


def dynlen_bytes(torch, att, lengths, nk, s, h, chunk=256, row_block=8):
  """Cache bytes the live-prefix attention must read for these lengths: K
  and V of each row's live prefix, and for a zero-length row the V rows of
  its row block's n_chunks * c (its context is their mean)."""
  r = lengths.numel() * nk
  c, rb = att.dynlen_blocking(r, s, h, chunk, row_block)
  lens = torch.repeat_interleave(lengths.to(torch.int64).clamp(0, s), nk)
  blk = torch.amax(lens.reshape(r // rb, rb), dim=1)
  n_chunks = torch.clamp((blk + c - 1) // c, 1, s // c)
  n_chunks = torch.repeat_interleave(n_chunks, rb)
  rows_kv = int(torch.sum(lens))
  rows_v0 = int(torch.sum(torch.where(lens == 0, n_chunks * c, 0)))
  return (2 * rows_kv + rows_v0) * h, rows_kv


def dynlen_kernel(torch, att, cfg, dev, timer, gen):
  """The live-prefix attention (#18) against its plain version on the card
  at the server's tick shapes (B 64 and 256, S 1024, G 8, H 256, chunk 256,
  row blocks of 8): lengths spanning 1..S with zero-length rows (idle
  slots), one in a row block beside a full row; f32 outputs within 1e-5 of
  max(max |y|, 1) (f32 sums in another order). Timed at B 64 beside SDPA
  over the pools dequantized to bf16 with the lengths mask (a zero-length
  row there is all -inf: SDPA gives NaN where the kernel gives the TPU's
  mean)."""
  NK, H, S = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
  G = cfg.num_query_heads // NK
  bf16 = torch.bfloat16
  k_scale, v_scale, zp_k, zp_v = 0.06, 0.06, 3.0, -2.0
  kw = dict(k_zero_point=zp_k, v_zero_point=zp_v)
  rows = []
  for b in (B, BENCH_B):
    q = torch.randn((b, NK, G, H), generator=gen, device=dev).to(bf16)
    kc, vc = (torch.randint(-127, 128, (b, NK, S, H), generator=gen,
                            device=dev).to(torch.int8) for _ in range(2))
    lengths = torch.randint(1, S + 1, (b,), generator=gen, device=dev).to(
        torch.int32)
    lengths[0], lengths[1], lengths[2] = 0, S, 1
    lengths[9], lengths[17] = 0, 0  # idle slots in other row blocks
    args = (q, kc, vc, k_scale, v_scale, lengths)
    got = att.decode_attention_int8_dynlen(*args, **kw)
    want = att.decode_attention_int8_dynlen_plain(*args, **kw)
    sync()
    err = float(torch.max(torch.abs(got - want)))
    ymax = float(torch.max(torch.abs(want)))
    if not err <= 1e-5 * max(ymax, 1.0):
      raise AssertionError(f'dynlen attention B {b}: err {err}, max |y| '
                           f'{ymax}')
    cache_bytes, live = dynlen_bytes(torch, att, lengths, NK, S, H)
    nbytes = q.numel() * 2 + cache_bytes + lengths.numel() * 4 + q.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * G * H * live, F32_OPS_PER_S)
    kd = ((kc.float() - zp_k) * k_scale).to(bf16)
    vd = ((vc.float() - zp_v) * v_scale).to(bf16)
    amask = attention_lengths_mask(torch, lengths, S, bf16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows.append({
        'phase': 'decode' if b == B else 'bench', 'B': b,
        'max_abs_err': err, 'max_abs_y': ymax, 'live_rows': live,
        'cache_bytes': cache_bytes,
        'ms': timer(lambda: att.decode_attention_int8_dynlen(*args, **kw)),
        'plain_ms': timer(
            lambda: att.decode_attention_int8_dynlen_plain(*args, **kw)),
        'library_ms': timer(lambda: sdpa(q, kd, vd, attn_mask=amask)),
        'bound_ms': b_ms, 'bound_by': b_by})
    del kc, vc, kd, vd
  log(f'kernel decode_attention_int8_dynlen ok: {rows}')
  timing = ('ms', 'plain_ms', 'bound_ms', 'library_ms')
  return {
      'name': 'decode_attention_int8_dynlen', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/attention_dynlen.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:1018',
      'jax': 'pallas_attention.decode_attention_int8_dynlen',
      'wrapper': att.decode_attention_int8_dynlen, 'per_step': 0,
      'per_tick_blockwise': cfg.num_layers,
      'max_abs_err': max(r['max_abs_err'] for r in rows),
      **{key: rows[0][key] for key in timing}, 'bound_by': rows[0]['bound_by'],
      'library': 'scaled_dot_product_attention over the pools dequantized to '
                 'bf16 with the lengths mask',
      'bench': {key: rows[1][key] for key in timing}, 'by_shape': rows}


def cache_mode_kernels(torch, port, cfg, dev, timer, gen):
  """The four kernels of the blockwise server and the opt-in cache modes."""
  att = port['attention']
  return [blockwise_kernel(torch, port, cfg, dev, timer, gen),
          writeback_kernel(torch, att, cfg, dev, timer, gen),
          cache_row_kernel(torch, port, cfg, dev, timer, gen),
          dynlen_kernel(torch, att, cfg, dev, timer, gen)]


# -- the norm fusion and the attention-block fusions (#14, #20, #19) ---------


def rmsnorm_unfused(torch, ops_impl, x, gamma, eps=1e-6):
  """The unfused RMS_NORM op's arithmetic (ops/impl.py), at x's dtype."""
  y = x * ops_impl.rms_inverse(x.float(), eps).to(x.dtype)
  return (y.float() * gamma).to(x.dtype)


def rmsnorm_kernel(torch, port, cfg, dev, timer, gen):
  """The norm-fused weight-only matmul (#14) against its plain version at
  the shapes the norm fusion gives it on bench.py's decode (K = D 2048; N
  the fused QKV 2560 and the gate/up projection 2F 32768; M BENCH_B and
  B), bf16 and full-mantissa f32 x, with and without a bias, and with N
  padded (the last 64 rows padding: the true N sliced off, no bias in the
  kernel, as the executor calls it before adding the bias): f32 outputs
  within int_qmatmul.int_weights_tolerance of max |y| (the mma.sync and
  SIMT f32 sums run in another order), bf16 outputs within one bf16 ulp
  beyond it.
  Timed at BENCH_B beside the unfused route it replaces: the RMS_NORM op's
  torch arithmetic, then the weight-only matmul (#12)."""
  pq, iq, ops_impl = port['packed_qmatmul'], port['int_qmatmul'], \
      port['ops_impl']
  D, F = cfg.embed_dim, cfg.ffn_dim
  NQ, NK, H = cfg.num_query_heads, cfg.num_kv_heads, cfg.head_dim
  bf16 = torch.bfloat16
  rows = []
  for label, n in (('qkv', (NQ + 2 * NK) * H), ('gate_up', 2 * F)):
    w = pq.pack_int4_split(torch.randint(-8, 8, (n, D), generator=gen,
                                         device=dev).to(torch.int8))
    s = torch.rand((n,), generator=gen, device=dev) * 0.01 + 0.005
    gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
    bias = torch.randn((n,), generator=gen, device=dev)
    for phase, m in (('bench', BENCH_B), ('decode', B)):
      x = (torch.randn((m, D), generator=gen, device=dev) * 3).to(bf16)
      x32 = torch.randn((m, D), generator=gen, device=dev) * 3
      checks = []
      for xi, case in ((x, 'plain'), (x, 'bias'), (x32, 'plain'),
                       (x32, 'bias'), (x, 'padded'), (x32, 'padded')):
        true_n = n - 64 if case == 'padded' else None
        bi = bias if case == 'bias' else None
        got = pq.qmatmul_int4_packed_rmsnorm(xi, gamma, w, s, bi)
        want = pq.qmatmul_int4_packed_rmsnorm_plain(xi, gamma, w, s, bi)
        if true_n:  # the executor adds the bias after the slice (torch)
          got, want = got[:, :true_n], want[:, :true_n]
        sync()
        ymax = float(torch.max(torch.abs(want.float())))
        tol = iq.int_weights_tolerance(D, 0, ymax)
        err = float(torch.max(torch.abs(got.float() - want.float())))
        ulps = bf16_ulps(torch, got, want, atol=tol) \
            if xi.dtype == bf16 else None
        if (ulps is not None and ulps > 1.0) or (ulps is None
                                                 and not err <= tol):
          raise AssertionError(
              f'norm-fused matmul {label} M {m} ({xi.dtype}, {case}): err '
              f'{err}, tolerance {tol}, bf16 ulps beyond it {ulps}')
        checks.append({'x': str(xi.dtype).split('.')[-1], 'case': case,
                       'max_abs_err': err, 'max_abs_y': ymax,
                       'tolerance': tol, 'bf16_ulps_beyond': ulps})
      nbytes = m * D * 2 + D * 4 + n * D // 2 + n * 4 + m * n * 2
      b_ms, b_by = bound(nbytes, 2 * m * n * D, BF16_OPS_PER_S)
      rows.append({
          'phase': phase, 'shape': label, 'M': m, 'N': n, 'K': D,
          'max_abs_err': max(c['max_abs_err'] for c in checks),
          'checks': checks,
          'ms': timer(lambda: pq.qmatmul_int4_packed_rmsnorm(x, gamma, w, s)),
          'plain_ms': timer(lambda: pq.qmatmul_int4_packed_rmsnorm_plain(
              x, gamma, w, s), reps=5),
          'composition_ms': timer(lambda: pq.qmatmul_int4_packed(
              rmsnorm_unfused(torch, ops_impl, x, gamma), w, s)),
          'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None})
  log(f'kernel qmatmul_int4_packed_rmsnorm ok: '
      f'{[{k: v for k, v in r.items() if k != "checks"} for r in rows]}')
  bench = [r for r in rows if r['phase'] == 'bench']
  timing = ('ms', 'plain_ms', 'composition_ms', 'bound_ms')
  return {
      'name': 'qmatmul_int4_packed_rmsnorm', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'qmatmul_int4_rmsnorm.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py:297',
      'jax': 'pallas_qmatmul.qmatmul_pallas_int4_packed_rmsnorm',
      'wrapper': pq.qmatmul_int4_packed_rmsnorm, 'per_step': 0,
      'per_bench_step_norm_fusion': 2 * cfg.num_layers,
      'max_abs_err': max(r['max_abs_err'] for r in rows),
      # A bench step's pair: one QKV and one gate/up call.
      **{key: sum(r[key] for r in bench) for key in timing},
      'bound_by': 'operations', 'library_ms': None,
      'composition': 'the RMS_NORM op (torch) + qmatmul_int4_packed (#12), '
                     'per layer: the QKV and the gate/up call summed',
      'by_shape': rows}


def qkv_kernel(torch, port, cfg, dev, timer, gen):
  """The norm + QKV + RoPE prologue (#20) against its plain version at
  bench.py's decode shape (M BENCH_B, D 2048, 8 query heads and 1 KV head
  of 256) and at M B, bf16 and f32 x, DRQ on and off, cos and sin of
  positions near BENCH_START formed on the card: DRQ q, k and v bit for
  bit (int32 sums, the norm's f64 sum and the DRQ formula repeated in
  order), weight-only within int_qmatmul.int_weights_tolerance of max |y|
  and one bf16 ulp beyond it at bf16 (q and k: beyond twice the tolerance
  and 4 bf16 ulps of the head's largest output, the RoPE mixing two
  projections that were each rounded to bf16). Timed at BENCH_B (DRQ,
  bf16) beside
  the unfused route: the RMS_NORM op's torch arithmetic, the int4 DRQ
  matmul (#1) and the RoPE of q and k in torch."""
  pq, iq, ops_impl = port['packed_qmatmul'], port['int_qmatmul'], \
      port['ops_impl']
  qkv, blk = port['qkv'], port['block']
  D, NQ, NK, H = cfg.embed_dim, cfg.num_query_heads, cfg.num_kv_heads, \
      cfg.head_dim
  N = (NQ + 2 * NK) * H
  bf16 = torch.bfloat16
  w = pq.pack_int4_split(torch.randint(-8, 8, (N, D), generator=gen,
                                       device=dev).to(torch.int8))
  s = torch.rand((N,), generator=gen, device=dev) * 0.01 + 0.005
  gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
  kw = dict(nq=NQ, nk=NK, h=H)
  rows = []
  for phase, m in (('bench', BENCH_B), ('decode', B)):
    pos = torch.randint(BENCH_START - 64, BENCH_START + 64, (m, 1),
                        generator=gen, device=dev)
    cos, sin = qkv.rope_cos_sin(pos, H, 10000.0)
    x = (torch.randn((m, D), generator=gen, device=dev) * 3).to(bf16)
    x32 = torch.randn((m, D), generator=gen, device=dev) * 3
    checks = []
    for xi in (x, x32):
      for drq in (True, False):
        args = (xi, gamma, w, s, cos, sin)
        got = qkv.qkv_rope(*args, drq=drq, **kw)
        want = qkv.qkv_rope_plain(*args, drq=drq, **kw)
        sync()
        for part, a, b in zip('qkv', got, want):
          err = float(torch.max(torch.abs(a.float() - b.float())))
          ymax = float(torch.max(torch.abs(b.float())))
          tol = 0.0 if drq else iq.int_weights_tolerance(D, 0, ymax)
          atol = tol
          if part != 'v' and xi.dtype == bf16:
            # The RoPE mixes the pair (x1, x2) of the projection, each
            # rounded to bf16 first: an ulp of either moves the output by
            # an ulp of the pair's size (<= sqrt(2) * the head's largest
            # output), twice, beyond the output's own rounding.
            heads = b.float().reshape(b.shape[0], -1, H)
            hmax = torch.amax(torch.abs(heads), dim=-1, keepdim=True)
            ulp = torch.exp2(torch.floor(torch.log2(
                torch.clamp_min(hmax, 2.0**-126))) - 7)
            atol = (2 * tol + 4 * ulp).expand_as(heads).reshape(b.shape)
          ulps = bf16_ulps(torch, a, b, atol=atol) \
              if xi.dtype == bf16 and not drq else None
          ok = (err == 0.0) if drq else (
              ulps <= 1.0 if ulps is not None else err <= tol)
          if not ok or a.dtype != xi.dtype:
            raise AssertionError(
                f'qkv_rope {phase} {part} ({xi.dtype}, drq {drq}): err {err}, '
                f'tolerance {tol}, bf16 ulps beyond it {ulps}')
          checks.append({'x': str(xi.dtype).split('.')[-1], 'drq': drq,
                         'out': part, 'max_abs_err': err, 'max_abs_y': ymax,
                         'bf16_ulps_beyond': ulps})

    def composition(x=x, cos=cos, sin=sin, m=m):
      xn = rmsnorm_unfused(torch, ops_impl, x, gamma)
      heads = pq.qmatmul_int4_packed_drq(xn, w, s).reshape(m, NQ + 2 * NK, H)
      c, sn = cos.reshape(m, 1, H // 2), sin.reshape(m, 1, H // 2)
      return (blk.rope_rotate(heads[:, :NQ + NK].float(), c, sn).to(bf16),
              heads[:, NQ + NK:])

    nbytes = (m * D * 2 + D * 4 + N * D // 2 + N * 4 + 2 * m * H // 2 * 4
              + m * N * 2)
    b_ms, b_by = bound(nbytes, 2 * m * N * D, INT8_OPS_PER_S)
    args = (x, gamma, w, s, cos, sin)
    rows.append({
        'phase': phase, 'M': m, 'N': N, 'K': D,
        'max_abs_err': max(c['max_abs_err'] for c in checks),
        'checks': checks,
        'ms': timer(lambda: qkv.qkv_rope(*args, **kw)),
        'plain_ms': timer(lambda: qkv.qkv_rope_plain(*args, **kw), reps=5),
        'composition_ms': timer(composition),
        'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None})
  log(f'kernel qkv_rope ok: '
      f'{[{k: v for k, v in r.items() if k != "checks"} for r in rows]}')
  timing = ('ms', 'plain_ms', 'composition_ms', 'bound_ms')
  return {
      'name': 'qkv_rope', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/qkv_rope.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qkv.py:177',
      'jax': 'pallas_qkv.qkv_rope_pallas',
      'wrapper': qkv.qkv_rope, 'per_step': 0,
      'per_bench_step_attn_block': cfg.num_layers,
      'max_abs_err': max(r['max_abs_err'] for r in rows),
      **{key: rows[0][key] for key in timing}, 'bound_by': rows[0]['bound_by'],
      'library_ms': None,
      'composition': 'the RMS_NORM op (torch) + qmatmul_int4_packed_drq (#1) '
                     '+ RoPE of q and k (torch)',
      'decode': {key: rows[1][key] for key in timing}, 'by_shape': rows}


def oproj_kernel(torch, port, cfg, dev, timer, gen):
  """The attention + out projection + residual epilogue (#19) against its
  plain version at bench.py's decode shape (B BENCH_B, S 1024, one KV head,
  G 8, H 256, D 2048) and at B B, lengths BENCH_START + 1 = 897 (the bench
  step's), 0, 1 and S, bf16 and f32 x_res, DRQ on and off. The kernel's
  attention is the lengths kernel (#7); given #7's context the projection
  and the residual are the plain version's bit for bit (DRQ) or within
  int_qmatmul.int_weights_tolerance over K = G*H and, at bf16, one bf16
  ulp of the projection (rounded before the add) and one of y beyond it
  (weight-only). End to end against the plain version (its attention
  sums in another f32 order, so a DRQ code of the context can flip) the
  largest error is reported and held to 1e-2 of max |y| (a wrong head,
  pairing or scale moves it by far more). Timed at BENCH_B, lengths 897,
  DRQ, bf16, beside the unfused route: #7, #1 and the residual ADD.
  NK 2 and odd G raise ValueError on the card and launch nothing."""
  pq, iq, att = port['packed_qmatmul'], port['int_qmatmul'], port['attention']
  D, NK, H, S = cfg.embed_dim, cfg.num_kv_heads, cfg.head_dim, \
      cfg.max_seq_len
  G = cfg.num_query_heads // NK
  bf16 = torch.bfloat16
  k_scale, v_scale, zp_k, zp_v = 0.06, 0.06, 3.0, -2.0
  wo = pq.pack_int4_split(torch.randint(-8, 8, (D, G * H), generator=gen,
                                        device=dev).to(torch.int8))
  so = torch.rand((D,), generator=gen, device=dev) * 0.01 + 0.005
  rows = []
  for phase, b in (('bench', BENCH_B), ('decode', B)):
    q = torch.randn((b, 1, G, H), generator=gen, device=dev).to(bf16)
    kc, vc = (torch.randint(-127, 128, (b, 1, S, H), generator=gen,
                            device=dev).to(torch.int8) for _ in range(2))
    x = torch.randn((b, D), generator=gen, device=dev).to(bf16)
    checks = []
    for n_live in (BENCH_START + 1, 0, 1, S):
      lengths = torch.full((b,), n_live, dtype=torch.int32, device=dev)
      for xi in (x, x.float()):
        cast = xi.dtype
        for drq in (True, False):
          args = (q, kc, vc, k_scale, v_scale, lengths, xi, wo, so, zp_k,
                  zp_v, 'f32', drq)
          got = att.decode_attention_oproj(*args)
          want = att.decode_attention_oproj_plain(*args)
          ctx = att.decode_attention_int8_lengths(
              q.to(cast), kc, vc, k_scale, v_scale, lengths, zp_k, zp_v,
              out_dtype=cast).reshape(b, G * H)
          proj = (pq.qmatmul_int4_packed_drq_plain if drq
                  else pq.qmatmul_int4_packed_plain)
          o = proj(ctx, wo, so)
          given = xi + o
          sync()
          ymax = float(torch.max(torch.abs(want.float())))
          err = float(torch.max(torch.abs(got.float() - want.float())))
          err_given = float(torch.max(torch.abs(got.float()
                                                - given.float())))
          tol = 0.0 if drq else iq.int_weights_tolerance(G * H, 0, ymax)
          # At bf16 the projection is rounded before the residual add, so
          # its own ulp (larger than y's where x_res cancels it) carries.
          atol = tol + torch.exp2(torch.floor(torch.log2(torch.clamp_min(
              torch.abs(o.float()), 2.0**-126))) - 7) if cast == bf16 else tol
          ulps = bf16_ulps(torch, got, given, atol=atol) \
              if cast == bf16 and not drq else None
          ok_given = (err_given == 0.0) if drq else (
              ulps <= 1.0 if ulps is not None else err_given <= tol)
          if not ok_given or not err <= 1e-2 * ymax or got.dtype != cast:
            raise AssertionError(
                f'attention epilogue {phase} L {n_live} ({cast}, drq {drq}): '
                f'err given #7\'s context {err_given} (tolerance {tol}, bf16 '
                f'ulps beyond it {ulps}), err end to end {err}, max |y| '
                f'{ymax}')
          checks.append({'lengths': n_live, 'x': str(cast).split('.')[-1],
                         'drq': drq, 'max_abs_err_given_ctx': err_given,
                         'max_abs_err': err, 'max_abs_y': ymax,
                         'bf16_ulps_beyond': ulps})
    lengths = torch.full((b,), BENCH_START + 1, dtype=torch.int32,
                         device=dev)
    args = (q, kc, vc, k_scale, v_scale, lengths, x, wo, so, zp_k, zp_v)

    def composition(b=b, args=args):
      ctx = att.decode_attention_int8_lengths(*args[:6], zp_k, zp_v,
                                              out_dtype=bf16)
      return x + pq.qmatmul_int4_packed_drq(ctx.reshape(b, G * H), wo, so)

    live = b * (BENCH_START + 1)
    nbytes = (b * G * H * 2 + 2 * live * H + b * 4 + b * D * 2
              + D * G * H // 2 + D * 4 + b * D * 2)
    b_ms, b_by = bound(nbytes, 4 * G * H * live, F32_OPS_PER_S,
                       2 * b * D * G * H, INT8_OPS_PER_S)
    rows.append({
        'phase': phase, 'B': b, 'live_rows': live,
        'max_abs_err': max(c['max_abs_err'] for c in checks),
        'max_abs_err_given_ctx': max(c['max_abs_err_given_ctx']
                                     for c in checks),
        'checks': checks,
        'ms': timer(lambda: att.decode_attention_oproj(*args)),
        'plain_ms': timer(lambda: att.decode_attention_oproj_plain(*args),
                          reps=5),
        'composition_ms': timer(composition),
        'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None})
    del kc, vc
  log(f'kernel decode_attention_oproj ok: '
      f'{[{k: v for k, v in r.items() if k != "checks"} for r in rows]}')
  refused = {}
  q = torch.zeros((4, 2, 8, H), device=dev)
  c2 = torch.zeros((4, 2, S, H), dtype=torch.int8, device=dev)
  lens = torch.ones(4, dtype=torch.int32, device=dev)
  x4 = torch.zeros((4, D), device=dev)
  for what, call in (
      ('NK 2', lambda: att.decode_attention_oproj(
          q, c2, c2, 1.0, 1.0, lens, x4, wo, so)),
      ('G 7', lambda: att.decode_attention_oproj(
          q[:, :1, :7], c2[:, :1], c2[:, :1], 1.0, 1.0, lens, x4, wo, so))):
    before = (att.decode_attention_oproj.launches,
              att.decode_attention_oproj.plain_calls)
    try:
      call()
    except ValueError as e:
      if (att.decode_attention_oproj.launches,
          att.decode_attention_oproj.plain_calls) != before:
        raise AssertionError(f'epilogue {what}: counted a run') from e
      refused[what] = str(e)
      log(f'refused on the card as expected: attention epilogue, {what}: {e}')
      continue
    raise AssertionError(f'attention epilogue took {what}')
  timing = ('ms', 'plain_ms', 'composition_ms', 'bound_ms')
  return {
      'name': 'decode_attention_oproj', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/attention_oproj.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:1268',
      'jax': 'pallas_attention.decode_attention_oproj_pallas (f32 attention)',
      'wrapper': att.decode_attention_oproj, 'per_step': 0,
      'per_bench_step_attn_block': cfg.num_layers,
      'max_abs_err': max(r['max_abs_err'] for r in rows),
      'max_abs_err_given_ctx': max(r['max_abs_err_given_ctx'] for r in rows),
      **{key: rows[0][key] for key in timing}, 'bound_by': rows[0]['bound_by'],
      'library_ms': None,
      'composition': 'decode_attention_int8_lengths (#7) + '
                     'qmatmul_int4_packed_drq (#1) + the residual ADD',
      'decode': {key: rows[1][key] for key in timing}, 'refused': refused,
      'by_shape': rows}


def attn_block_kernels(torch, port, cfg, dev, timer, gen):
  """The kernels of the norm fusion and the attention block."""
  return [rmsnorm_kernel(torch, port, cfg, dev, timer, gen),
          qkv_kernel(torch, port, cfg, dev, timer, gen),
          oproj_kernel(torch, port, cfg, dev, timer, gen)]


def refused_shapes(torch, att, dev):
  """Shapes that the JAX executor's gate sends to its Pallas kernels but
  that the CUDA kernels do not take: the wrapper raises ValueError on the
  card and launches nothing (the executor has no fallback for them)."""
  def i8(*shape, dtype=torch.int8):
    return torch.zeros(shape, dtype=dtype, device=dev)

  cases = (
      ('lengths attention, G = 8 x S = 8192 scores',
       att.decode_attention_int8_lengths,
       lambda: att.decode_attention_int8_lengths(
           torch.zeros((1, 1, 8, 256), device=dev), i8(1, 1, 8192, 256),
           i8(1, 1, 8192, 256), 1.0, 1.0,
           torch.ones(1, dtype=torch.int32, device=dev))),
      ('flash attention, H = 384', att.flash_attention_int8_masked,
       lambda: att.flash_attention_int8_masked(
           torch.zeros((1, 1, 32, 384), device=dev), i8(1, 1, 128, 384),
           i8(1, 1, 128, 384), 1.0, 1.0,
           torch.zeros((1, 1, 32, 128), device=dev))),
      ('int4-group attention, G = 8 x S = 8192 scores',
       att.decode_attention_int4_group_lengths,
       lambda: att.decode_attention_int4_group_lengths(
           torch.zeros((1, 1, 8, 256), device=dev),
           i8(1, 1, 8192, 128, dtype=torch.uint8),
           i8(1, 1, 8192, 128, dtype=torch.uint8),
           i8(1, 1, 48, 8192, dtype=torch.bfloat16),
           torch.ones(1, dtype=torch.int32, device=dev))),
      ('masked decode attention, G = 8 x S = 8192 scores',
       att.decode_attention_int8_masked,
       lambda: att.decode_attention_int8_masked(
           torch.zeros((1, 1, 8, 256), device=dev), i8(1, 1, 8192, 256),
           i8(1, 1, 8192, 256), 1.0, 1.0,
           torch.zeros((1, 1, 1, 8192), device=dev))))
  for what, wrapper, call in cases:
    before = (wrapper.launches, wrapper.plain_calls)
    try:
      call()
    except ValueError as e:
      if (wrapper.launches, wrapper.plain_calls) != before:
        raise AssertionError(f'{what}: counted a run') from e
      log(f'refused on the card as expected: {what}: {e}')
      continue
    raise AssertionError(f'{what}: the CUDA wrapper took a refused shape')


def lengths_kernel(torch, att, cfg, dev, timer, gen):
  """Lengths attention at the server's decode tick: B = 64, S = 1024,
  random lengths 1..1024 (first and last rows 1 and S)."""
  NK, H = cfg.num_kv_heads, cfg.head_dim
  G = cfg.num_query_heads // NK
  S = cfg.max_seq_len
  bf16 = torch.bfloat16
  q = torch.randn((B, NK, G, H), generator=gen, device=dev).to(bf16)
  kc, vc = (torch.randint(-127, 128, (B, NK, S, H), generator=gen,
                          device=dev).to(torch.int8) for _ in range(2))
  lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev).to(
      torch.int32)
  lengths[0], lengths[-1] = 1, S
  k_scale, v_scale, zp_k, zp_v = 0.06, 0.06, 3.0, -2.0
  args = (q, kc, vc, k_scale, v_scale, lengths)
  kw = dict(k_zero_point=zp_k, v_zero_point=zp_v, out_dtype=bf16)
  kw32 = dict(k_zero_point=zp_k, v_zero_point=zp_v)
  got = att.decode_attention_int8_lengths(*args, **kw)
  want = att.decode_attention_int8_lengths_plain(*args, **kw)
  got32 = att.decode_attention_int8_lengths(*args, **kw32)
  want32 = att.decode_attention_int8_lengths_plain(*args, **kw32)
  zero = torch.zeros_like(lengths)
  got0 = att.decode_attention_int8_lengths(q, kc, vc, k_scale, v_scale, zero,
                                           **kw32)
  want0 = att.decode_attention_int8_lengths_plain(q, kc, vc, k_scale,
                                                  v_scale, zero, **kw32)
  sync()
  # f32 sums in another order; values of order 1.
  err32 = float(torch.max(torch.abs(got32 - want32)))
  err0 = float(torch.max(torch.abs(got0 - want0)))
  ulps = bf16_ulps(torch, got, want, atol=1e-5)
  if err32 > 1e-5 or err0 > 1e-5 or ulps > 1.0:
    raise AssertionError(f'lengths attention: f32 err {err32}, length-0 '
                         f'err {err0}, {ulps} bf16 ulps')
  live = NK * int(torch.sum(lengths))
  nbytes = q.numel() * 2 + 2 * live * H + lengths.numel() * 4 + q.numel() * 2
  b_ms, b_by = bound(nbytes, 4 * G * H * live, F32_OPS_PER_S)
  kd = (kc.float() * k_scale).to(bf16)
  vd = (vc.float() * v_scale).to(bf16)
  amask = torch.where(
      torch.arange(S, device=dev)[None, :] < lengths[:, None], 0.0,
      float('-inf')).to(bf16).reshape(B, 1, 1, S)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  log(f'kernel decode_attention_int8_lengths ok: f32 err {err32}, '
      f'length-0 err {err0}, {ulps} bf16 ulps')
  return {
      'name': 'decode_attention_int8_lengths', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/attention_lengths.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:508',
      'jax': 'pallas_attention.decode_attention_int8_lengths (f32 compute)',
      'wrapper': att.decode_attention_int8_lengths, 'per_step': 0,
      'per_tick': cfg.num_layers, 'max_abs_err': err32,
      'max_bf16_ulps': ulps, 'length0_max_abs_err': err0,
      'ms': timer(lambda: att.decode_attention_int8_lengths(*args, **kw)),
      'plain_ms': timer(
          lambda: att.decode_attention_int8_lengths_plain(*args, **kw)),
      'bound_ms': b_ms, 'bound_by': b_by,
      'library_ms': timer(lambda: sdpa(q, kd, vd, attn_mask=amask)),
      'library': 'scaled_dot_product_attention over a dequantized bf16 cache',
      'live_rows': live}


def prefill_mask(torch, dev, g, start, s):
  """The prefill device mask of the chunk at `start`: query row (g, t)
  sees keys <= start + t (0, else -1e9), g-major rows [Bp, 1, G*T, S]."""
  pos = start + torch.arange(PREFILL_LEN, device=dev)
  rows = torch.where(torch.arange(s, device=dev)[None, :] <= pos[:, None],
                     0.0, -1e9)
  return rows.reshape(1, 1, 1, PREFILL_LEN, s).expand(
      PREFILL_BATCH, 1, g, PREFILL_LEN, s).reshape(
          PREFILL_BATCH, 1, g * PREFILL_LEN, s).contiguous()


def flash_kernel(torch, att, cfg, dev, timer, gen):
  """Flash attention at the server's prefill pass: Bp = 8, R = G*T = 1024,
  S = 1024, with the causal device masks of chunks 0 and 3."""
  NK, H = cfg.num_kv_heads, cfg.head_dim
  G = cfg.num_query_heads // NK
  S = cfg.max_seq_len
  R = G * PREFILL_LEN
  bf16 = torch.bfloat16
  q = torch.randn((PREFILL_BATCH, NK, R, H), generator=gen,
                  device=dev).to(bf16)
  kc, vc = (torch.randint(-127, 128, (PREFILL_BATCH, NK, S, H), generator=gen,
                          device=dev).to(torch.int8) for _ in range(2))
  k_scale, v_scale, zp_k, zp_v = 0.06, 0.06, 3.0, -2.0
  kd = (kc.float() * k_scale).to(bf16)
  vd = (vc.float() * v_scale).to(bf16)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  by_chunk = []
  for chunk in (0, 3):
    mask = prefill_mask(torch, dev, G, chunk * PREFILL_LEN, S)
    args = (q, kc, vc, k_scale, v_scale, mask)
    kw = dict(k_zero_point=zp_k, v_zero_point=zp_v)
    got = att.flash_attention_int8_masked(*args, **kw)
    want = att.flash_attention_int8_masked_plain(*args, **kw)
    sync()
    # f32 with fmaf over 64-key tiles against the plain version's 512-key
    # blocks: rounding only, of values of order v_scale * 127.
    err = float(torch.max(torch.abs(got - want)))
    ymax = float(torch.max(torch.abs(want)))
    if not err <= 1e-5 * max(ymax, 1.0):
      raise AssertionError(f'flash attention chunk {chunk}: err {err}, '
                           f'max |y| {ymax}')
    nbytes = (q.numel() * 2 + kc.numel() + vc.numel() + mask.numel() * 4
              + got.numel() * 4)
    b_ms, b_by = bound(nbytes, 4 * PREFILL_BATCH * NK * R * S * H,
                       BF16_OPS_PER_S)
    mask_bf16 = mask.to(bf16)
    by_chunk.append({
        'chunk': chunk, 'max_abs_err': err, 'max_abs_y': ymax,
        'ms': timer(lambda: att.flash_attention_int8_masked(*args, **kw)),
        'plain_ms': timer(
            lambda: att.flash_attention_int8_masked_plain(*args, **kw)),
        'bound_ms': b_ms, 'bound_by': b_by,
        'library_ms': timer(lambda: sdpa(q, kd, vd, attn_mask=mask_bf16))})
  log(f'kernel flash_attention_int8_masked ok: {by_chunk}')

  def mean(key):
    return sum(r[key] for r in by_chunk) / len(by_chunk)

  return {
      'name': 'flash_attention_int8_masked', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'flash_attention_int8.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:229',
      'jax': 'pallas_attention.flash_attention_int8_masked',
      'wrapper': att.flash_attention_int8_masked, 'per_step': 0,
      'per_prefill_pass': cfg.num_layers,
      'max_abs_err': max(r['max_abs_err'] for r in by_chunk),
      'ms': mean('ms'), 'plain_ms': mean('plain_ms'),
      'bound_ms': mean('bound_ms'), 'bound_by': by_chunk[0]['bound_by'],
      'library_ms': mean('library_ms'),
      'library': 'scaled_dot_product_attention with the additive mask over '
                 'a dequantized bf16 cache',
      'by_chunk': by_chunk}


def serve_phase(torch, port, kernels, cfg, dev):
  """64 requests through the decode step of the Gemma-2B int4 graph at
  batch 64, the decode block off."""
  gemma, executor = port['gemma'], port['executor']
  t0 = time.monotonic()
  graph = decode_graph(gemma, cfg, B)
  weights = gemma.device_materialize_quantized(graph, fc_bits=4,
                                               embedding_bits=8, device=dev)
  ex = executor.GraphExecutor(graph, device=dev,
                              activation_dtype='bfloat16',
                              decode_block=False)
  ex.load_weights(weights)
  ex.prepare_serving_weights(min_weight_params=0)
  del weights
  sync()
  log(f'e2e set-up (graph, weights, packing): {time.monotonic() - t0:.1f}s; '
      f'fusions attention {len(ex._attn_fusions)} mlp '
      f'{len(ex._mlp_fusions)} head {len(ex._head_fusions)}')
  rng = np.random.default_rng(1)
  prompts = torch.as_tensor(
      rng.integers(0, cfg.vocab_size, size=(B, PROMPT)), dtype=torch.int32,
      device=dev)
  step = decode_stepper(torch, ex, cfg, B,
                        gemma.zero_caches(graph, 'decode', dev), dev)
  positions = torch.arange(cfg.max_seq_len, dtype=torch.int32, device=dev)
  steps = PROMPT + GENERATE - 1
  generated = []
  tokens = prompts[:, :1]
  for k in kernels:
    k['wrapper'].launches = 0
    k['wrapper'].plain_calls = 0

  step_ms = []
  t_start = time.monotonic()
  for pos in range(steps):
    t_step = time.monotonic()
    nxt = step(positions[pos], tokens)
    if pos + 1 < PROMPT:
      tokens = prompts[:, pos + 1:pos + 2]
    else:
      generated.append(nxt)
      tokens = nxt
    sync()
    step_ms.append((time.monotonic() - t_step) * 1e3)
  wall = time.monotonic() - t_start
  # On the card only launches count; a CPU rehearsal counts plain runs.
  counts = {k['name']: getattr(k['wrapper'],
                               'launches' if dev == 'cuda' else 'plain_calls')
            for k in kernels}
  ids = torch.cat(generated, dim=1)
  if ids.shape != (B, GENERATE):
    raise AssertionError(f'generated {tuple(ids.shape)}')
  lo, hi = int(ids.min()), int(ids.max())
  if lo < 0 or hi >= cfg.vocab_size:
    raise AssertionError(f'ids out of range [{lo}, {hi}]')
  for k in kernels:
    want = k['per_step'] * steps
    if counts[k['name']] != want:
      raise AssertionError(
          f"{k['name']}: {counts[k['name']]} launches, want {want}")
    k['launches_decode_loop'] = counts[k['name']]
  steady = statistics.median(step_ms[1:])
  log(f'e2e served {B} requests: {PROMPT} prompt + {GENERATE} generated '
      f'tokens each, {steps} decode steps, ids in [{lo}, {hi}]')
  log(f'e2e launches {counts} (per step: '
      f'{ {k["name"]: k["per_step"] for k in kernels if k["per_step"]} })')
  log(f'e2e decode: {wall * 1e3 / steps:.3f} ms/step over all steps, '
      f'median {steady:.3f} ms/step after the first; '
      f'{B / steady * 1e3:.1f} tokens/s at batch {B}')
  log(f'e2e first request tokens: {ids[0].tolist()}')
  result = {'ms_per_step': steady, 'tokens_per_s': B / steady * 1e3,
            'ms_per_step_all': wall * 1e3 / steps}
  if dev == 'cuda':
    result.update(profile_steps(torch, lambda i: step(positions[i], tokens),
                                steps, steady))
  return result


def profile_steps(torch, step, pos0, steady_ms, n=3):
  """Device time by kernel over `n` more decode steps (torch.profiler,
  device activity only): where a step's time goes, and the device's idle
  share of the unprofiled median step `steady_ms`."""
  from torch.profiler import ProfilerActivity, profile
  sync()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.monotonic()
    for i in range(n):
      step(pos0 + i)
    sync()
    wall_ms = (time.monotonic() - t0) * 1e3 / n
  by_name = {}
  for e in prof.key_averages():
    us = getattr(e, 'self_device_time_total', 0) or 0
    if us > 0 and e.device_type.name == 'CUDA':
      name = e.key.replace('(anonymous namespace)::', '').split('(')[0][:100]
      by_name[name] = by_name.get(name, 0.0) + us / 1e3 / n
  busy = sum(by_name.values())
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
  log(f'e2e profile ({n} steps, {wall_ms:.3f} ms/step under the profiler): '
      f'device busy {busy:.3f} ms/step, idle share '
      f'{1 - busy / steady_ms:.3f} of the {steady_ms:.3f} ms median step')
  for name, ms in top:
    log(f'  {ms:8.3f} ms/step  {name}')
  return {'device_busy_ms_per_step': busy,
          'device_idle_share': 1 - busy / steady_ms,
          'device_ms_per_step_by_kernel': dict(top)}


def decode_graph(gemma, cfg, batch, kv_int4_group=0):
  """bench.py's decode graph (bench.py:517-529): one `decode` signature,
  fused projections, greedy head, int8 KV caches (AEQT_BENCH_KV=int8) or,
  with kv_int4_group, int4-group pools (AEQT_BENCH_KV=int4g)."""
  graph = gemma.build_decoder(cfg, batch=batch, prefill_len=8,
                              signatures=('decode',),
                              materialize_weights=False,
                              fused_projections=True, greedy_head=True,
                              kv_int4_group=kv_int4_group)
  if not kv_int4_group:
    gemma.stamp_int8_kv_cache(graph)
  return graph


def decode_stepper(torch, ex, cfg, batch, feed, dev):
  """step(pos_t, tokens) -> next tokens: one decode step whose inputs are
  made on the device from the int32 device scalar pos_t, as bench.py's
  one_step makes them (bench.py:593-621); the caches carry over in feed.
  No host sync."""
  S = cfg.max_seq_len
  G = cfg.num_query_heads // cfg.num_kv_heads
  iota = torch.arange(S, device=dev, dtype=torch.int32)
  zero = torch.zeros((), dtype=torch.int32, device=dev)
  cache_keys = [k for k in feed if k.endswith('_cache_in')]

  def step(pos_t, tokens):
    feed['tokens'] = tokens
    feed['positions'] = pos_t.reshape(1, 1).expand(batch, 1)
    feed['mask'] = torch.where(iota <= pos_t, 0.0, -1e9).reshape(
        1, 1, 1, S).expand(batch, 1, G, S)
    feed['cache_pos'] = torch.stack([zero, zero, pos_t, zero])
    out = ex(feed, 'decode')
    for key in cache_keys:
      feed[key] = out[key[:-len('_in')]]
    return out['next_tokens'].reshape(batch, 1).to(torch.int32)

  return step


def bench_steps(torch, gemma, ex, graph, cfg, kernels, per_step, label,
                tokens0, dev):
  """bench.py's step loop on one executor: zero pools made on the device in
  the signature's dtypes, BENCH_WARMUP warm-up steps from BENCH_START, then
  BENCH_STEPS timed steps (host clock around synchronised steps) whose
  launches must be per_step's for each kernel (the plain versions never
  run on the card), then 3 profiled steps. Returns (result, the timed
  steps' ids [BENCH_B, BENCH_STEPS])."""
  feed = gemma.zero_caches(graph, 'decode', device=dev)
  step = decode_stepper(torch, ex, cfg, BENCH_B, feed, dev)
  pos = torch.tensor(BENCH_START, dtype=torch.int32, device=dev)
  tokens = tokens0
  for _ in range(BENCH_WARMUP):
    tokens = step(pos, tokens)
    pos = pos + 1
  sync()
  for k in kernels:
    k['wrapper'].launches = 0
    k['wrapper'].plain_calls = 0
  step_ms, out_ids = [], []
  for _ in range(BENCH_STEPS):
    t1 = time.monotonic()
    tokens = step(pos, tokens)
    pos = pos + 1
    sync()
    step_ms.append((time.monotonic() - t1) * 1e3)
    out_ids.append(tokens)
  # On the card only launches count; a CPU rehearsal counts plain runs.
  on_card = dev == 'cuda'
  launches = {k['name']: getattr(k['wrapper'], 'launches' if on_card
                                 else 'plain_calls') for k in kernels}
  plain = {k['name']: getattr(k['wrapper'], 'plain_calls' if on_card
                              else 'launches') for k in kernels}
  want = {name: n * BENCH_STEPS for name, n in per_step.items()}
  if ({n: launches.get(n, 0) for n in want} != want
      or any(v for n, v in launches.items() if n not in want)
      or any(plain.values())):
    raise AssertionError(f'bench decode {label}: launches {launches}, want '
                         f'{want}; plain runs on the card {plain}')
  for k in kernels:
    k.setdefault('launches_bench_decode', {})[label] = launches[k['name']]
  ids = torch.cat(out_ids, dim=1)
  lo, hi = int(ids.min()), int(ids.max())
  if lo < 0 or hi >= cfg.vocab_size:
    raise AssertionError(f'bench decode {label}: ids out of range')
  med = statistics.median(step_ms)
  log(f'bench decode {label}: {med:.3f} ms/step (median of '
      f'{[round(t, 3) for t in step_ms]}), {BENCH_B / med * 1e3:.1f} '
      f'tokens/s at batch {BENCH_B}; launches per step '
      f'{ {n: v // BENCH_STEPS for n, v in launches.items() if v} }')
  prof = profile_steps(torch, lambda i, pos=pos: step(pos + i, tokens), 0,
                       med)
  return {'ms_per_step': med, 'step_ms': step_ms,
          'tokens_per_s': BENCH_B / med * 1e3,
          'launches_per_step': per_step, **prof}, ids


def bench_tokens(torch, cfg, dev):
  return torch.as_tensor(
      np.random.default_rng(2).integers(0, cfg.vocab_size, (BENCH_B, 1)),
      dtype=torch.int32, device=dev)


# bench.py's decode settings that chip_smoke drives, as executor options:
# the decode block on and off (the stale writeback, bench.py's own), then
# with the block off the splice writeback (AEQT_ATTN_WRITEBACK_MODE=splice)
# and the in-place row writes with no writeback (AEQT_ATTN_WRITEBACK=0,
# AEQT_CACHE_WRITE_PALLAS=1); then bench.py's own settings with
# AEQT_ATTN_BLOCK=1 (the prologue and the epilogue; an attention with an
# epilogue joins no block unit) and with AEQT_NORM_FUSION=1 (the norms
# fold into the QKV and gate/up FCs; a norm-fed chain forms no MLP unit,
# so no block unit either).
BENCH_SETTINGS = {
    'block on': dict(decode_block=True),
    'block off': dict(decode_block=False),
    'splice': dict(decode_block=False, attn_writeback='splice'),
    'inplace': dict(decode_block=False, attn_writeback=None,
                    cache_write_inplace=True),
    'attn block': dict(attn_block=True),
    'norm fusion': dict(norm_fusion=True)}


def bench_decode_phase(torch, port, kernels, cfg, dev):
  """bench.py's decode through the port's GraphExecutor: GEMMA_2B with the
  full vocabulary, int4 packed FCs, int8 embedding and tied head, int8 KV
  with the stamped scales in zero pools made on the device, greedy head,
  bf16 activations, batch BENCH_B, cache 1024, start_pos BENCH_START;
  `bench_steps` under each of BENCH_SETTINGS on the same weights. The
  splice and in-place settings write each step's rows into its input
  pools (the executor's donation); their ids, and those of the attention
  block and the norm fusion, are compared with the block off's (stale
  writeback), the block on's likewise. The norm-fused FCs are weight-only
  where the block off's are DRQ, so the norm fusion's ids may differ from
  the block off's in more places than the others'."""
  gemma, executor = port['gemma'], port['executor']
  t0 = time.monotonic()
  graph = decode_graph(gemma, cfg, BENCH_B)
  weights = gemma.device_materialize_quantized(graph, fc_bits=4,
                                               embedding_bits=8, device=dev)
  layers = cfg.num_layers
  unfused = {'mlp_int4_packed': layers, 'head_argmax': 1,
             'qmatmul_int4_packed_drq': 2 * layers}
  per_step = {
      'block on': {'fused_mlp_qkv_attention': layers - 1,
                   'decode_attention_int8_lengths_stale': 1,
                   'mlp_int4_packed': 1, 'head_argmax': 1,
                   'qmatmul_int4_packed_drq': layers + 1},
      'block off': {'decode_attention_int8_lengths_stale': layers,
                    **unfused},
      'splice': {'decode_attention_int8_lengths_writeback': layers,
                 **unfused},
      'inplace': {'dus_row_inplace': 2 * layers,
                  'decode_attention_int8_lengths': layers, **unfused},
      'attn block': {'qkv_rope': layers, 'decode_attention_oproj': layers,
                     'mlp_int4_packed': layers, 'head_argmax': 1},
      'norm fusion': {'qmatmul_int4_packed_rmsnorm': 2 * layers,
                      'decode_attention_int8_lengths_stale': layers,
                      'qmatmul_int4_packed_drq': layers,
                      'qmatmul_int4_packed_drq_kblock': layers,
                      'head_argmax': 1}}
  results, ids = {}, {}
  for label, options in BENCH_SETTINGS.items():
    ex = executor.GraphExecutor(graph, device=dev,
                                activation_dtype='bfloat16', **options)
    ex.load_weights(weights)
    ex.prepare_serving_weights(min_weight_params=0)
    sync()
    units = {'block': len(ex._block_fusions),
             'attention': len(ex._attn_fusions),
             'epilogue': sum('epilogue' in f
                             for f in ex._attn_fusions.values()),
             'qkv': len(ex._qkv_fusions), 'norm': len(ex._norm_fusions),
             'mlp': len(ex._mlp_fusions), 'head': len(ex._head_fusions)}
    log(f'bench decode {label}: set-up {time.monotonic() - t0:.1f}s; units '
        f'{units}')
    results[label], ids[label] = bench_steps(
        torch, gemma, ex, graph, cfg, kernels, per_step[label], label,
        bench_tokens(torch, cfg, dev), dev)
    results[label]['options'] = options
    results[label]['units'] = units
    del ex
    torch.cuda.empty_cache()
  same = {label: float(torch.mean((ids[label] == ids['block off']).float()))
          for label in BENCH_SETTINGS if label != 'block off'}
  log(f'bench decode: ids equal to the block off\'s (stale writeback, bf16 '
      f'activations) by setting, share of the {BENCH_B} x {BENCH_STEPS}: '
      f'{same}')
  results['ids_equal_share'] = same.pop('block on')
  results['ids_equal_share_vs_block_off'] = same
  return results


def bench_decode_int4g_phase(torch, port, kernels, cfg, dev):
  """bench.py's decode with AEQT_BENCH_KV=int4g (bench.py:516-529 and
  :642-650): the graph built with kv_int4_group=16 and not stamped, one
  INT4G_ATTENTION op per layer over uint8 pools and a bf16 sidecar made
  as zeros on the device; otherwise as bench_decode_phase. The executor
  keeps its defaults (decode block on), and finds no attention unit, so
  no block unit: the step runs unfused, its pool writes into copies of
  the pools (the executor's functional contract)."""
  gemma, executor = port['gemma'], port['executor']
  t0 = time.monotonic()
  graph = decode_graph(gemma, cfg, BENCH_B, kv_int4_group=INT4G_GROUP)
  weights = gemma.device_materialize_quantized(graph, fc_bits=4,
                                               embedding_bits=8, device=dev)
  ex = executor.GraphExecutor(graph, device=dev, activation_dtype='bfloat16')
  ex.load_weights(weights)
  ex.prepare_serving_weights(min_weight_params=0)
  del weights
  sync()
  units = {'block': len(ex._block_fusions),
           'attention': len(ex._attn_fusions),
           'mlp': len(ex._mlp_fusions), 'head': len(ex._head_fusions)}
  log(f'bench decode int4g: set-up {time.monotonic() - t0:.1f}s; units '
      f'{units} (decode block on, no unit: unfused)')
  if units['block'] or units['attention']:
    raise AssertionError(f'bench decode int4g: units {units}')
  layers = cfg.num_layers
  per_step = {'decode_attention_int4_group_lengths': layers,
              'mlp_int4_packed': layers, 'head_argmax': 1,
              'qmatmul_int4_packed_drq': 2 * layers}
  result, _ = bench_steps(torch, gemma, ex, graph, cfg, kernels, per_step,
                          'int4g', bench_tokens(torch, cfg, dev), dev)
  result.update(units=units, block='on; no unit matches, so unfused')
  del ex
  torch.cuda.empty_cache()
  return result


def serving_graph(gemma, cfg, slots, kv_int4_group=0, materialize=False):
  """bench.py's serving graph: prefill groups of 8 x 128 tokens with a
  64-token tail program, greedy heads, device masks, int8 KV caches
  (AEQT_BENCH_SERVER_KV=int8) or, with kv_int4_group, int4-group decode
  pools and float prefill caches (AEQT_BENCH_SERVER_KV=int4g; bench.py
  stamps int8 only without it, bench.py:192-203). materialize: float
  weights drawn on the host (the Quantizer's input), else empty buffers."""
  graph = gemma.build_serving_decoder(
      cfg, batch_slots=slots, prefill_len=PREFILL_LEN,
      prefill_batch=PREFILL_BATCH, prefill_tail_len=PREFILL_TAIL,
      materialize_weights=materialize, device_masks=True,
      fused_projections=True,
      greedy_head=True, prefill_device_masks=True, prefill_greedy=True,
      prefill_head_cols=True, kv_int4_group=kv_int4_group)
  if not kv_int4_group:
    gemma.stamp_int8_kv_cache(graph)
  return graph


class CountingExecutor:
  """Stands in for a server's executor: counts its calls by signature."""

  def __init__(self, inner):
    self.inner = inner
    self.calls = {}

  def __call__(self, inputs, signature_key):
    self.calls[signature_key] = self.calls.get(signature_key, 0) + 1
    return self.inner(inputs, signature_key)

  def __getattr__(self, name):
    return getattr(self.inner, name)


def device_busy(torch, fn):
  """(wall ms, device busy ms, top kernels) of one call of fn under
  torch.profiler (CUDA activity)."""
  from torch.profiler import ProfilerActivity, profile
  sync()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.monotonic()
    fn()
    sync()
    wall_ms = (time.monotonic() - t0) * 1e3
  by_name = {}
  for e in prof.key_averages():
    us = getattr(e, 'self_device_time_total', 0) or 0
    if us > 0 and e.device_type.name == 'CUDA':
      name = e.key.replace('(anonymous namespace)::', '').split('(')[0][:90]
      by_name[name] = by_name.get(name, 0.0) + us / 1e3
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
  return wall_ms, sum(by_name.values()), top


def server_phase(torch, port, kernels, cfg, dev, n_requests=SERVE_REQUESTS,
                 slots=B, kv_int4_group=0):
  """The port's DecodeServer under bench.py's mixed-length load: a warm-up
  request per prompt length, then n_requests requests (prompt lengths
  cycling 32..512, 48 new tokens each) served by step_chunk(8). With
  kv_int4_group, bench.py's AEQT_BENCH_SERVER_KV=int4g server: each tick
  runs INT4G_ATTENTION_SCATTER per layer, and the prefill's float
  attention chain is graph ops (no int8 cache, so no attention unit)."""
  gemma, batching = port['gemma'], port['batching']
  name = 'server int4g' if kv_int4_group else 'server'
  t0 = time.monotonic()
  graph = serving_graph(gemma, cfg, slots, kv_int4_group)
  weights = gemma.device_materialize_quantized(graph, fc_bits=4,
                                               embedding_bits=8, device=dev)
  server = batching.DecodeServer(graph, cfg, slots, weights=weights,
                                 pack_weights=True,
                                 activation_dtype='bfloat16', device=dev)
  del weights
  sync()
  log(f'{name} set-up (graph, weights, packing): '
      f'{time.monotonic() - t0:.1f}s; fusions attention '
      f'{len(server._executor._attn_fusions)} mlp '
      f'{len(server._executor._mlp_fusions)} head '
      f'{len(server._executor._head_fusions)}')
  layers = cfg.num_layers

  def want(ticks, passes):
    counts = {'qmatmul_int4_packed_drq': 2 * layers * (ticks + passes),
              'mlp_int4_packed': layers * (ticks + passes),
              'head_argmax': ticks + passes}
    if kv_int4_group:
      counts['decode_attention_int4_group_lengths'] = layers * ticks
    else:
      counts['decode_attention_int8_lengths'] = layers * ticks
      counts['flash_attention_int8_masked'] = layers * passes
    return counts

  return serve_load(torch, server, kernels, cfg, dev, name, want,
                    n_requests, slots)


def serve_load(torch, server, kernels, cfg, dev, name, want_fn,
               n_requests=SERVE_REQUESTS, slots=B):
  """bench.py's mixed-length load through `server`: a warm-up request per
  prompt length, then n_requests requests (prompt lengths cycling
  32..512, SERVE_NEW new tokens each) served by step_chunk(SERVE_CHUNK).
  Every request must end done with SERVE_NEW ids in range, and each
  kernel's launches must equal want_fn(decode ticks, prefill passes) (0
  for a kernel it leaves out; the plain versions never run on the card).
  Then one full prefill pass and one chunk of SERVE_CHUNK ticks with all
  slots busy, alone and under torch.profiler."""
  rng = np.random.default_rng(0)
  max_p = min(server.max_prompt_len(), cfg.max_seq_len - SERVE_NEW)
  lens = [p for p in SERVE_PROMPTS if p <= max_p]

  def submit(n, plen=None):
    reqs = []
    for i in range(n):
      p = plen or lens[i % len(lens)]
      server.submit(rng.integers(0, cfg.vocab_size, p).astype(np.int32),
                    max_new_tokens=SERVE_NEW)
      reqs.append(server._queue[-1])
    return reqs

  def drain():
    while server.has_work():
      server.step_chunk(SERVE_CHUNK)

  t0 = time.monotonic()
  submit(len(lens))
  drain()
  sync()
  log(f'{name} warm-up ({len(lens)} requests, one per prompt length): '
      f'{time.monotonic() - t0:.1f}s')

  counting = CountingExecutor(server._executor)
  server._executor = counting
  for k in kernels:
    k['wrapper'].launches = 0
    k['wrapper'].plain_calls = 0
  base = dict(server.metrics)
  ttft0 = len(server.ttft_log)
  t0 = time.monotonic()
  reqs = submit(n_requests)
  drain()
  sync()
  wall = time.monotonic() - t0
  # On the card only launches count; a CPU rehearsal counts plain runs.
  on_card = dev == 'cuda'
  launches = {k['name']: getattr(k['wrapper'],
                                 'launches' if on_card else 'plain_calls')
              for k in kernels}
  plain = {k['name']: getattr(k['wrapper'],
                              'plain_calls' if on_card else 'launches')
           for k in kernels}
  calls = dict(counting.calls)
  server._executor = counting.inner
  m = {key: server.metrics[key] - base[key] for key in base}
  ttfts = np.asarray(server.ttft_log[ttft0:])

  bad = [r.request_id for r in reqs
         if r.status != 'done' or len(r.generated) != SERVE_NEW]
  if bad:
    raise AssertionError(f'{len(bad)} requests not done with {SERVE_NEW} '
                         f'tokens: {bad[:8]}')
  ids = np.concatenate([np.asarray(r.generated) for r in reqs])
  if ids.min() < 0 or ids.max() >= cfg.vocab_size:
    raise AssertionError(f'ids out of range [{ids.min()}, {ids.max()}]')
  ticks = calls.get('decode', 0)
  passes = calls.get('prefill', 0) + calls.get('prefill_tail', 0)
  if ticks != m['decode_ticks']:
    raise AssertionError(f'{ticks} decode calls, {m["decode_ticks"]} ticks')
  want = {n: 0 for n in launches}
  want.update(want_fn(ticks, passes))
  if launches != want or any(plain.values()):
    raise AssertionError(f'{name} launches {launches}, want {want}; plain '
                         f'runs on the card {plain}')
  tokens = m['tokens_generated']
  p50, p99 = (float(v) for v in np.percentile(ttfts, [50, 99]))
  log(f'{name} served {n_requests} requests ({SERVE_NEW} new tokens each, '
      f'prompts {lens}) in {wall:.3f}s: {tokens / wall:.1f} tokens/s, '
      f'TTFT p50 {p50 * 1e3:.1f} ms p99 {p99 * 1e3:.1f} ms; decode ticks '
      f'{m["decode_ticks"]}, prefill groups {m["prefill_groups"]}, pad rows '
      f'{m["prefill_pad_rows"]}, executor calls {calls}')
  log(f'{name} launches {launches}; plain runs on the card {plain}')
  result = {'requests': n_requests, 'wall_s': wall,
            'tokens_per_s': tokens / wall, 'ttft_p50_ms': p50 * 1e3,
            'ttft_p99_ms': p99 * 1e3, 'decode_ticks': m['decode_ticks'],
            'prefill_groups': m['prefill_groups'],
            'prefill_pad_rows': m['prefill_pad_rows'],
            'executor_calls': calls, 'launches': launches}

  # One full prefill pass (a group of 8 x 128 tokens) and one chunk of 8
  # decode ticks with all 64 slots busy, alone: host clock, then under
  # torch.profiler for the device's busy time.
  tok = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                     (PREFILL_BATCH, PREFILL_LEN)),
                        dtype=torch.int32, device=dev)
  pf = server._prefill_inputs(tok, np.full(PREFILL_BATCH, PREFILL_LEN - 1,
                                           np.int32), 0, PREFILL_LEN)
  pf.update(server.prefill_zero_caches())

  def prefill_pass():
    server._executor(pf, 'prefill')

  prefill_pass()
  pass_ms = []
  for _ in range(3):
    sync()
    t1 = time.monotonic()
    prefill_pass()
    sync()
    pass_ms.append((time.monotonic() - t1) * 1e3)
  submit(slots, plen=lens[0])
  server.step_chunk(SERVE_CHUNK)  # admits all slots
  chunk_ms = []
  for _ in range(3):
    sync()
    t1 = time.monotonic()
    server.step_chunk(SERVE_CHUNK)
    sync()
    chunk_ms.append((time.monotonic() - t1) * 1e3)
  pf_wall, pf_busy, pf_top = device_busy(torch, prefill_pass)
  ch_wall, ch_busy, ch_top = device_busy(
      torch, lambda: server.step_chunk(SERVE_CHUNK))
  drain()
  pass_med, chunk_med = statistics.median(pass_ms), statistics.median(
      chunk_ms)
  log(f'{name} prefill pass (8 x 128 tokens): {pass_med:.3f} ms (median '
      f'of {[round(t, 3) for t in pass_ms]}); device busy {pf_busy:.3f} ms '
      f'under the profiler ({pf_wall:.3f} ms wall), idle share '
      f'{1 - pf_busy / pass_med:.3f}')
  for kname, ms in pf_top:
    log(f'  {ms:8.3f} ms/pass  {kname}')
  log(f'{name} chunk of {SERVE_CHUNK} decode ticks (64 slots busy): '
      f'{chunk_med:.3f} ms (median of {[round(t, 3) for t in chunk_ms]}); '
      f'device busy {ch_busy:.3f} ms under the profiler ({ch_wall:.3f} ms '
      f'wall), idle share {1 - ch_busy / chunk_med:.3f}')
  for kname, ms in ch_top:
    log(f'  {ms:8.3f} ms/chunk  {kname}')
  device_s = (passes * pf_busy + ticks * ch_busy / SERVE_CHUNK) / 1e3
  log(f'{name} time split (estimate from the two profiles): prefill passes '
      f'{passes} x {pf_busy:.3f} ms + decode ticks {ticks} x '
      f'{ch_busy / SERVE_CHUNK:.3f} ms = {device_s:.3f}s of device work in '
      f'the {wall:.3f}s run; host and idle {wall - device_s:.3f}s')
  result.update({
      'prefill_pass_ms': pass_med, 'prefill_pass_device_busy_ms': pf_busy,
      'prefill_pass_idle_share': 1 - pf_busy / pass_med,
      'chunk_ms': chunk_med, 'chunk_device_busy_ms': ch_busy,
      'chunk_idle_share': 1 - ch_busy / chunk_med,
      'device_work_s_estimate': device_s,
      'prefill_pass_top': dict(pf_top), 'chunk_top': dict(ch_top)})
  return result


# examples/serve_gemma.py's quantization (every FC int4 channelwise, the
# dynamic-range entry of add_dynamic_config), served in the JAX executor's
# default mode (executor.JAX_DEFAULT_OPTIONS: weight-only int4 FCs, MLP and
# head, additive-mask decode attention).
DEFAULT_MODE = 'serve_gemma_default_mode'
# serve_gemma's flow with every FC int4 in blocks of 128
# (add_dynamic_config(..., granularity=BLOCKWISE_128), a granularity the
# default policy allows, recipe/default_policy.py:51), served by the JAX
# executor's defaults with AEQT_ATTN_DYNLEN=1: every FC, the tied head
# included, through the blockwise packed matmul (no fusion takes a
# blockwise weight), the live-prefix attention at every tick.
BLOCKWISE_MODE = 'serve_gemma_blockwise128_dynlen'
QUANT_RECIPES = ('gemma_mixed48', 'gemma_mixed48_b32', 'gemma_mixed48_hr',
                 DEFAULT_MODE, BLOCKWISE_MODE)
# Depths cut to keep the script's time down (the model's widths never
# are): quantizer_phase serves the four EARLIER_RECIPES' quantized paths
# at 2 layers (their kernels are checked at full size by int_weight_kernels,
# kblock_kernel and default_mode_kernels) and BLOCKWISE_MODE at the model's
# depth; quantizer_cpu_phase holds each recipe's graph op by op at
# QUANT_CPU_LAYERS layers, reusing the graph quantizer_phase made where
# the depths agree. The host's quantization dominates both (the tied
# head's 524M weights at any depth; for gemma_mixed48_hr a 512-wide
# rotation and OCTAV in numpy), and host speed varies by up to 1.7x from one
# machine to another.
EARLIER_RECIPES = ('gemma_mixed48', 'gemma_mixed48_b32', 'gemma_mixed48_hr',
                   DEFAULT_MODE)
QUANT_LAYERS = dict.fromkeys(EARLIER_RECIPES, 2)
QUANT_CPU_LAYERS = dict.fromkeys(QUANT_RECIPES, 2)


def quantize(port, graph, recipe):
  """The Quantizer's result for `recipe` (a named recipe, or DEFAULT_MODE:
  serve_gemma's `add_dynamic_config('.*', 'FULLY_CONNECTED', 4)`, or
  BLOCKWISE_MODE: the same with granularity BLOCKWISE_128)."""
  if recipe in (DEFAULT_MODE, BLOCKWISE_MODE):
    qt = port['Quantizer'](graph)
    kw = {'granularity': 'BLOCKWISE_128'} if recipe == BLOCKWISE_MODE else {}
    qt.add_dynamic_config('.*', 'FULLY_CONNECTED', 4, **kw)
    return qt.quantize()
  return port['Quantizer'](graph, recipe).quantize()


def server_options(port, recipe):
  """DecodeServer keyword arguments of `recipe`'s server: the JAX
  executor's defaults for DEFAULT_MODE, with AEQT_ATTN_DYNLEN=1 for
  BLOCKWISE_MODE, the port's (bench.py's) else."""
  defaults = port['executor'].JAX_DEFAULT_OPTIONS
  if recipe == DEFAULT_MODE:
    return {'executor_options': defaults}
  if recipe == BLOCKWISE_MODE:
    return {'executor_options': {**defaults, 'attn_dynlen': True}}
  return {}


def quantized_launches(recipe, layers):
  """serve_load's want_fn for a server over a graph that the Quantizer
  made with `recipe` (fused projections: two attention FCs and two FFN
  FCs a layer, then the tied head; int8 KV stamped). Every recipe: int8
  attention FCs through the int8 DRQ kernel. gemma_mixed48: int4 FFN and
  head packed and fused (MLP and head kernels); _b32: the blockwise-32 FFN
  and head FCs through the weight-only kernel, the head's ARG_MAX a graph
  op; _hr: a Hadamard rotation before each int4 FC, so the MLP does not
  fuse: the gate/up FC (K = D) through the int4 DRQ kernel, the down FC
  (K = F > 8192) through the K-blocked one, and the head, rotated x -> FC
  -> ARG_MAX, fused. DEFAULT_MODE: every FC int4 packed, weight-only:
  the QKV and out-projection FCs through the weight-only packed kernel, the
  MLP and the head fused in their weight-only branches, the additive-mask
  attention at each tick; nothing of the DRQ kernels. BLOCKWISE_MODE:
  every FC (four a layer and the head) through the blockwise packed
  matmul, the live-prefix attention at each tick."""
  def want(ticks, passes):
    calls = ticks + passes
    if recipe == BLOCKWISE_MODE:
      return {'qmatmul_int4_packed_blockwise': (4 * layers + 1) * calls,
              'decode_attention_int8_dynlen': layers * ticks,
              'flash_attention_int8_masked': layers * passes}
    if recipe == DEFAULT_MODE:
      return {'qmatmul_int4_packed': 2 * layers * calls,
              'mlp_int4_packed_bf16': layers * calls,
              'head_argmax_bf16': calls,
              'decode_attention_int8_masked': layers * ticks,
              'flash_attention_int8_masked': layers * passes}
    counts = {'qmatmul_int8_drq': 2 * layers * calls,
              'decode_attention_int8_lengths': layers * ticks,
              'flash_attention_int8_masked': layers * passes}
    if recipe == 'gemma_mixed48':
      counts.update(mlp_int4_packed=layers * calls, head_argmax=calls)
    elif recipe == 'gemma_mixed48_hr':
      counts.update(qmatmul_int4_packed_drq=layers * calls,
                    qmatmul_int4_packed_drq_kblock=layers * calls,
                    head_argmax=calls)
    else:
      counts['qmatmul_int_weights'] = (2 * layers + 1) * calls
    return counts
  return want


def same_graph_data(quantized, loaded):
  """Names of the buffers and tensors whose data or quantization differ
  between a quantized graph and its .aeqg load (the format keeps a 0-d
  array as shape (1,), so arrays compare flattened, dtypes exactly)."""
  def same(a, b):
    if a is None or b is None:
      return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a.reshape(-1),
                                                 b.reshape(-1))
  bad = [f'buffer {i}' for i, (a, b) in enumerate(zip(quantized.buffers,
                                                       loaded.buffers))
         if not same(a.data, b.data)]
  if len(quantized.buffers) != len(loaded.buffers):
    bad.append('buffer count')
  for sq, sl in zip(quantized.subgraphs, loaded.subgraphs):
    for tq, tl in zip(sq.tensors, sl.tensors):
      qq, ql = tq.quantization, tl.quantization
      if (tq.name, tq.shape, tq.dtype, tq.buffer) != (
          tl.name, tl.shape, tl.dtype, tl.buffer) or (qq is None) != (
              ql is None) or (qq is not None and not (
                  same(np.asarray(qq.scale, np.float32), ql.scale)
                  and same(qq.zero_point, ql.zero_point)
                  and qq.block_size == ql.block_size)):
        bad.append(tq.name)
  return bad


def quantizer_phase(torch, port, kernels, cfg, dev, n_requests=SERVE_REQUESTS,
                    slots=B, kept=None):
  """examples/serve_gemma.py's flow at GEMMA_2B's full width, through the
  port's entry points: the float serving graph (server_phase's settings,
  weights drawn on the host, int8 KV stamped) built once at each depth
  QUANT_LAYERS asks for; then for each of
  QUANT_RECIPES: `Quantizer(graph, recipe).quantize()`, `export_model` to
  a temporary .aeqg, `serialize.load_graph` (mmap) with every buffer,
  tensor and quantization parameter equal to the quantized graph's, and
  `DecodeServer(loaded, cfg, slots, pack_weights=True)` serving
  serve_load's requests, with each kernel's launches as
  quantized_launches has them. Host time and peak host memory (numpy
  allocations, tracemalloc) of the build and of each quantization. kept: a
  dict that takes each quantized graph made at its QUANT_CPU_LAYERS depth
  with B slots, for quantizer_cpu_phase."""
  gemma, batching = port['gemma'], port['batching']
  serialize, progress = port['serialize'], port['progress_utils']
  results, graphs = {}, {}

  def float_graph(layers):
    if layers in graphs:
      return graphs[layers]
    graphs.clear()  # one float graph at a time on the host
    gc.collect()
    tracemalloc.start()
    t0 = time.monotonic()
    graph = serving_graph(gemma, dataclasses.replace(cfg, num_layers=layers),
                          slots, materialize=True)
    build_s = time.monotonic() - t0
    build_peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    float_bytes = graph.total_constant_bits() // 8
    log(f'quantizer: float serving graph ({layers} layers) built in '
        f'{build_s:.1f}s, {float_bytes / 2**30:.2f} GiB of f32 constants, '
        f'peak host memory {build_peak / 2**30:.2f} GiB')
    results.setdefault('float_graph', {})[layers] = {
        'build_s': build_s, 'peak_host_bytes': build_peak,
        'constant_bytes': float_bytes}
    graphs[layers] = graph
    return graph

  # The recipes at the model's depth first: its float graph is built once.
  order = sorted(QUANT_RECIPES, key=lambda r: r in QUANT_LAYERS)
  with tempfile.TemporaryDirectory() as tmp:
    for recipe in order:
      cfg_r = dataclasses.replace(
          cfg, num_layers=QUANT_LAYERS.get(recipe, cfg.num_layers))
      graph = float_graph(cfg_r.num_layers)
      report = progress.ProgressReport()
      report.start(graph)
      t0 = time.monotonic()
      result = quantize(port, graph, recipe)
      quantize_s = time.monotonic() - t0
      stats = report.finish(result.quantized_model)
      path = os.path.join(tmp, f'{recipe}.aeqg')
      t0 = time.monotonic()
      result.export_model(path)
      export_s = time.monotonic() - t0
      t0 = time.monotonic()
      loaded = serialize.load_graph(path)
      load_s = time.monotonic() - t0
      bad = same_graph_data(result.quantized_model, loaded)
      if bad:
        raise AssertionError(f'quantizer {recipe}: the .aeqg load differs '
                             f'from the quantized graph: {bad[:8]}')
      size = os.path.getsize(path)
      log(f'quantizer {recipe}: quantize {quantize_s:.1f}s (peak host '
          f'memory {stats["peak_host_memory_bytes"] / 2**30:.2f} GiB, '
          f'constants {stats["model_size_before_bytes"] / 2**30:.2f} -> '
          f'{stats["model_size_after_bytes"] / 2**30:.2f} GiB), export '
          f'{export_s:.1f}s, {size} bytes, load {load_s:.2f}s, '
          f'{len(loaded.buffers)} buffers equal')
      if (kept is not None and slots == B
          and cfg_r.num_layers == QUANT_CPU_LAYERS[recipe]):
        kept[recipe] = result.quantized_model
      del result
      gc.collect()
      t0 = time.monotonic()
      server = batching.DecodeServer(loaded, cfg_r, slots, pack_weights=True,
                                     activation_dtype='bfloat16', device=dev,
                                     **server_options(port, recipe))
      sync()
      ex = server._executor
      units = {'attention': len(ex._attn_fusions),
               'mlp': len(ex._mlp_fusions), 'head': len(ex._head_fusions),
               'block': len(ex._block_fusions),
               'packed': len(ex._packed_int4_keys)}
      setup_s = time.monotonic() - t0
      log(f'quantizer {recipe}: server set-up (weights to the card, '
          f'packing) {setup_s:.1f}s; units {units}')
      served = serve_load(torch, server, kernels, cfg_r, dev,
                          f'quantized {recipe}',
                          quantized_launches(recipe, cfg_r.num_layers),
                          n_requests, slots)
      served.update(layers=cfg_r.num_layers, quantize_s=quantize_s,
                    quantize_peak_host_bytes=stats['peak_host_memory_bytes'],
                    quantized_constant_bytes=stats['model_size_after_bytes'],
                    export_s=export_s, aeqg_bytes=size, load_s=load_s,
                    server_setup_s=setup_s, units=units)
      results[recipe] = served
      del server, ex, loaded
      gc.collect()
      os.remove(path)  # one full-depth .aeqg at a time on the disk
      torch.cuda.empty_cache()
  return results


def quantizer_cpu_phase(torch, port, cfg, dev, kept=None):
  """The card against the port on the CPU, op by op, on graphs the
  Quantizer made: GEMMA_2B widths at QUANT_CPU_LAYERS layers (the graphs
  in `kept`, quantizer_phase's at that depth, else one float serving graph
  at each depth quantized here), for each of QUANT_RECIPES
  served on both devices (f32 activations) through the first prefill pass
  (8 requests of 128 tokens) and decode tick, as server_cpu_phase holds
  the server. The int8 DRQ FCs and the K-blocked packed FCs
  (gemma_mixed48_hr's down projections) must equal the CPU's bit for bit,
  the blockwise FCs and DEFAULT_MODE's weight-only packed FCs agree to
  int_qmatmul.int_weights_tolerance, int8 codes within one step."""
  t0 = time.monotonic()
  kept = {} if kept is None else kept
  graphs, out = {}, {}
  for recipe in sorted(QUANT_RECIPES, key=QUANT_CPU_LAYERS.get):
    layers = QUANT_CPU_LAYERS[recipe]
    cfg_l = dataclasses.replace(cfg, num_layers=layers)
    quantized = kept.pop(recipe, None)
    if quantized is None:
      if layers not in graphs:
        graphs.clear()
        gc.collect()
        graphs[layers] = serving_graph(port['gemma'], cfg_l, B,
                                       materialize=True)
      quantized = quantize(port, graphs[layers], recipe).quantized_model
    log(f'quantizer card-vs-cpu {recipe}: {layers}-layer graph quantized, '
        f'{time.monotonic() - t0:.1f}s')
    out[recipe] = server_cpu_phase(torch, port, cfg_l, dev, graph=quantized,
                                   label=f'quantized {recipe} card-vs-cpu',
                                   **server_options(port, recipe))
    kinds = {k.split('/')[1] for k in out[recipe]['worst_rel_err_by_opcode']}
    if recipe == DEFAULT_MODE:
      need = {'FC int4 weight-only', 'MLP'}
    elif recipe == BLOCKWISE_MODE:
      need = {'FC int4 blockwise'}
    else:
      need = {'FC int8 DRQ'} | ({'FC blockwise'} if recipe.endswith('_b32')
                                else set()) | (
                                    {'FC int4 DRQ K-blocked'}
                                    if recipe.endswith('_hr') else set())
    if not need <= kinds:
      raise AssertionError(f'{recipe}: no {need - kinds} op held')
    del quantized
    gc.collect()
  return out


# An attention-epilogue row whose DRQ code of the context flipped between
# the card and the CPU: one code moves the row by at most 8 * xs * max(so)
# (an int4 weight of 8), about 3e-4 of the row's largest output at Gemma-
# 2B's widths; 1e-3 leaves room for three such codes in one row.
EPILOGUE_ROW_RTOL = 1e-3
# Depth of the op-by-op runs of the attention-block and norm-fusion steps.
FUSION_CPU_LAYERS = 3


class OpByOp:
  """Makes an executor keep, or hold, each op's outputs.

  Recording (want None): `seen[i]` keeps every output of the i-th
  signature call. Holding (want from a recording): each output of the
  i-th call is held against want[i] (float outputs to 1e-5 of their
  largest magnitude, int8 codes to one step, other integers exactly) and
  the run goes on from the wanted value; ARG_MAX ids that differ are kept
  in `id_diffs` for the caller to judge by the logit margin. The fused
  MLP's output in a call of a signature listed in `mlp_rtol` is held to
  that tolerance instead. An INT4G_ATTENTION op's pools and sidecar must
  equal the CPU's bit for bit, its context is held as the kernel phase
  holds the kernel (int4g_ctx_ok; `fine_share` keeps the largest share of
  elements beyond INT4G_FINE_RTOL). `worst` keeps the largest relative
  error by signature and opcode ('MLP' for the fused MLP, FUSED_BLOCK for
  a decode block unit, one op with four outputs), `flips` the int8 codes
  that differ by one step. An unpacked integer FULLY_CONNECTED (a
  quantized graph's) is held by its kernel's rule: a DRQ one ('FC int8
  DRQ') bit for bit, a blockwise one ('FC blockwise') to
  int_qmatmul.int_weights_tolerance of its largest magnitude; so is a
  packed one on the K-blocked route ('FC int4 DRQ K-blocked'): bit for bit;
  a packed one on the weight-only route of the JAX executor's default
  mode ('FC int4 weight-only'), a packed blockwise one ('FC int4
  blockwise') and a norm-fused one ('FC int4 norm-fused', weight-only):
  to int_weights_tolerance. The attention-block prologue's q, k and v
  ('QKV prologue') are held as other float outputs. The epilogue's output
  ('attention epilogue', x_res + W_o . ctx) may differ beyond 1e-5 of its
  largest magnitude in a row where an f32 ulp of the context (its sums
  run in another order on the card) flipped one of the row's DRQ codes:
  such a row must stay within EPILOGUE_ROW_RTOL, and `epilogue_rows_off`
  counts them.
  """

  def __init__(self, torch, ex, want=None, mlp_rtol=None,
               int_qmatmul=None):
    self.torch, self.ex, self.want = torch, ex, want
    self.int_qmatmul = int_qmatmul
    self.mlp_rtol = dict(mlp_rtol or {})
    self.mlp_outs = {f['out'] for f in ex._mlp_fusions.values()}
    self.epilogue_outs = {f['epilogue']['y'] for f in
                          ex._attn_fusions.values() if 'epilogue' in f}
    self.qkv_outs = {f[key] for f in ex._qkv_fusions.values()
                     for key in ('q_out', 'k_out', 'v_out')}
    self.epilogue_rows_off = 0
    self.seen, self.worst, self.id_diffs, self.flips = [], {}, [], {}
    self.fine_share = 0.0
    store = ex._store_outputs
    call = ex.__call__

    def watched_call(inputs, signature_key='serving_default'):
      self.seen.append({'sig': signature_key})
      return call(inputs, signature_key)

    def watched_store(sg, op, values, env):
      store(sg, op, values, env)
      self._check(sg, op, env)

    ex._store_outputs = watched_store
    self.call = watched_call  # the server's executor while watched

  def _fc_rule(self, sg, op):
    """'FC int8 DRQ' or ('FC blockwise', rel tol) for an unpacked integer
    FC, ('FC int4 blockwise', rel tol) for a packed blockwise one, 'FC int4
    DRQ K-blocked' for a packed one on the K-blocked kernel's route, ('FC
    int4 weight-only', rel tol) for a packed channelwise one with DRQ off,
    else None."""
    if op.opcode != 'FULLY_CONNECTED' or len(op.inputs) < 2:
      return None
    w = sg.tensors[op.inputs[1]]
    q = w.quantization
    sg_idx = next(i for i, s in enumerate(self.ex.graph.subgraphs)
                  if s is sg)
    if q is None or w.dtype not in ('int2', 'int4', 'int8'):
      return None
    key = (sg_idx, op.inputs[1])
    if key in self.ex._packed_int4_keys:
      bs = self.ex._packed_block_size.get(key)
      if not bs and (sg_idx, op.inputs[0]) in self.ex._norm_fusions:
        return ('FC int4 norm-fused', self.int_qmatmul.int_weights_tolerance(
            w.shape[-1], 0, 1.0))
      if bs:
        return ('FC int4 blockwise', self.int_qmatmul.int_weights_tolerance(
            w.shape[-1], bs, 1.0))
      if not self.ex.int4_drq:
        return ('FC int4 weight-only', self.int_qmatmul.int_weights_tolerance(
            w.shape[-1], 0, 1.0))
      return 'FC int4 DRQ K-blocked' if w.shape[-1] > 8192 else None
    if q.block_size:
      k = w.shape[-1]
      return ('FC blockwise',
              self.int_qmatmul.int_weights_tolerance(k, q.block_size, 1.0))
    return 'FC int8 DRQ'

  def _check(self, sg, op, env):
    torch = self.torch
    i = len(self.seen) - 1
    int4g = op.opcode.startswith('INT4G_ATTENTION')
    fc_rule = self._fc_rule(sg, op) if self.want is not None else None
    for tid in op.outputs:
      if self.want is None:
        self.seen[i][tid] = env[tid].cpu()
        continue
      if i >= len(self.want):
        continue
      want, got = self.want[i][tid], env[tid].cpu()
      if op.opcode == 'ARG_MAX':
        for r in torch.nonzero(got.reshape(-1) != want.reshape(-1)).flatten():
          self.id_diffs.append((i, tid, int(r)))
      elif int4g and tid != op.outputs[0]:
        # The int4 pools (uint8) and the bf16 sidecar: bit for bit.
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
          raise AssertionError(f'{sg.tensors[tid].name}: differs from the '
                               'CPU')
      elif got.is_floating_point():
        err = float(torch.max(torch.abs(got.double() - want.double())))
        rel = err / max(float(torch.max(torch.abs(want.double()))), 1e-30)
        sig = self.seen[i]['sig']
        is_mlp = tid in self.mlp_outs
        kind = f'{sig}/{"MLP" if is_mlp else op.opcode}'
        if tid in self.qkv_outs:
          kind = f'{sig}/QKV prologue'
        if tid in self.epilogue_outs:
          kind = f'{sig}/attention epilogue'
        if fc_rule is not None:
          kind = f'{sig}/{fc_rule if isinstance(fc_rule, str) else fc_rule[0]}'
        self.worst[kind] = max(self.worst.get(kind, 0.0), rel)
        if fc_rule in ('FC int8 DRQ', 'FC int4 DRQ K-blocked'):
          if err != 0.0:
            raise AssertionError(f'{sg.tensors[tid].name}: {fc_rule} output '
                                 f'differs from the CPU (rel err {rel})')
        elif fc_rule is not None:
          if rel > fc_rule[1]:
            raise AssertionError(f'{sg.tensors[tid].name}: {fc_rule[0]} rel '
                                 f'err {rel} > {fc_rule[1]}')
        elif tid in self.epilogue_outs:
          w2 = want.double().reshape(-1, want.shape[-1])
          row_rel = torch.amax(torch.abs(got.double().reshape(w2.shape) - w2),
                               dim=1) / max(float(torch.max(torch.abs(w2))),
                                            1e-30)
          self.epilogue_rows_off += int(torch.sum(row_rel > 1e-5))
          if float(torch.max(row_rel)) > EPILOGUE_ROW_RTOL:
            raise AssertionError(f'{sg.tensors[tid].name}: a row rel err '
                                 f'{float(torch.max(row_rel))}')
        elif int4g:
          rel, share = int4g_ctx_diff(torch, got, want)
          self.fine_share = max(self.fine_share, share)
          if not int4g_ctx_ok(rel, share):
            raise AssertionError(f'{sg.tensors[tid].name}: rel err {rel}, '
                                 f'share {share}')
        elif rel > (self.mlp_rtol.get(sig, 1e-5) if is_mlp else 1e-5):
          raise AssertionError(f'{sg.tensors[tid].name}: rel err {rel}')
      else:
        diff = torch.abs(got.long() - want.long())
        err = int(torch.max(diff))
        if err > (1 if got.dtype == torch.int8 else 0):
          raise AssertionError(f'{sg.tensors[tid].name}: int err {err}')
        if err:
          kind = f'{self.seen[i]["sig"]}/{op.opcode}'
          self.flips[kind] = self.flips.get(kind, 0) + int(
              torch.count_nonzero(diff))
      env[tid] = want.to(self.ex.device)


def top2_margins(torch, head, watch, call, tid):
  """Relative top-2 logit margins of each row, on the recorded CPU run
  `watch`, of the greedy head whose ARG_MAX output is `tid` in signature
  call `call`."""
  ex = watch.ex
  sg_idx = ex.graph.signature_by_key(watch.seen[call]['sig']).subgraph_index
  fusion = next((f for key, f in ex._head_fusions.items()
                 if key[0] == sg_idx and f['out'] == tid), None)
  if fusion is None:  # an unfused head: the ARG_MAX op's recorded input
    sg = ex.graph.subgraphs[sg_idx]
    am = next(o for o in sg.ops if o.opcode == 'ARG_MAX'
              and tid in o.outputs)
    logits = watch.seen[call][am.inputs[0]].float()
    logits = logits.reshape(-1, logits.shape[-1])
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) / torch.clamp_min(
        torch.abs(top2[:, 0]), 1e-30)
  x = watch.seen[call][fusion['x']]
  w = ex._weights[(sg_idx, fusion['w_tid'])]
  scale, drq = ex.head_mode(sg_idx, fusion, w)
  logits = head.head_logits_plain(
      x.reshape(-1, x.shape[-1]), w, scale, packed=fusion['packed'],
      true_n=fusion['true_n'], drq=drq)
  top2 = torch.topk(logits, 2, dim=-1).values
  return (top2[:, 0] - top2[:, 1]) / torch.clamp_min(torch.abs(top2[:, 0]),
                                                     1e-30)


def judge_ids(torch, head, cpu_watch, card_watch, label):
  """An id of the card may differ from the CPU's only where the CPU's
  top-2 logit margin is below 1e-3 relative (a tie within f32
  rounding)."""
  for call, tid, r in card_watch.id_diffs:
    margin = float(top2_margins(torch, head, cpu_watch, call, tid)[r])
    log(f'{label}: call {call} row {r} id differs, cpu top-2 margin '
        f'{margin:.3e}')
    if margin >= 1e-3:
      raise AssertionError(f'{label}: call {call} row {r} differs with a '
                           'clear margin')


def server_cpu_phase(torch, port, cfg, dev, kv_int4_group=0, graph=None,
                     label=None, executor_options=None):
  """The server's first prefill pass and first decode tick, the card
  against the port on the CPU, op by op (as cpu_phase holds the decode
  step): GEMMA_2B widths at 2 layers, f32 activations, 8 requests of 128
  prompt tokens (one full group, one pass). With kv_int4_group the
  server's int4-group pools: the slot writer quantizes the prefilled rows
  (the CPU's values, held op by op) on each device, and the tick's
  INT4G_ATTENTION_SCATTER ops must write the CPU's pools and sidecars.

  The fused MLP of the prefill pass is held to 1e-3, the kernel phase's
  tolerance: CPU and card tanh differ by an ulp here and there, and with
  M = 1024 rows (16M hidden values) one such ulp rounds an int8 hidden
  code the other way (one step of its group scale; 1.96e-4 relative was
  read on an H100 80GB HBM3). The decode tick's MLP keeps 1e-5.

  graph: a graph the Quantizer made (at cfg's depth) instead, whose
  weights are its own buffers (quantizer_cpu_phase). executor_options: the
  servers' (DecodeServer's argument)."""
  gemma, batching, head = port['gemma'], port['batching'], port['head']
  if graph is None:
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    graph = serving_graph(gemma, cfg2, B, kv_int4_group)
    weights = gemma.device_materialize_quantized(graph, fc_bits=4,
                                                 embedding_bits=8, seed=5,
                                                 device='cpu')
  else:  # a quantized graph: its weights are its buffers
    cfg2, weights = cfg, None
  label = label or 'server card-vs-cpu' + (' (int4g)' if kv_int4_group
                                           else '')
  prompts = np.random.default_rng(5).integers(
      0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN)).astype(np.int32)
  watches = []
  t0 = time.monotonic()
  for device in ('cpu', dev):
    server = batching.DecodeServer(graph, cfg2, B, weights=weights,
                                   pack_weights=True,
                                   activation_dtype='float32', device=device,
                                   executor_options=executor_options)
    watch = OpByOp(torch, server._executor,
                   want=watches[0].seen if watches else None,
                   mlp_rtol={'prefill': 1e-3},
                   int_qmatmul=port['int_qmatmul'])
    server._executor = watch.call
    for p in prompts:
      server.submit(p, max_new_tokens=4)
    server.step()  # the admission's prefill pass, then one decode tick
    watches.append(watch)
    log(f'{label}: {device} prefill pass + decode tick '
        f'{time.monotonic() - t0:.1f}s, calls '
        f'{[c["sig"] for c in watch.seen]}')
  cpu_watch, card_watch = watches
  if [c['sig'] for c in card_watch.seen] != ['prefill', 'decode']:
    raise AssertionError(f'calls {[c["sig"] for c in card_watch.seen]}')
  if kv_int4_group and 'decode/INT4G_ATTENTION_SCATTER' not in card_watch.worst:
    raise AssertionError(f'{label}: no INT4G_ATTENTION_SCATTER op held')
  judge_ids(torch, head, cpu_watch, card_watch, label)
  worst = {k: f'{v:.2e}' for k, v in sorted(card_watch.worst.items())}
  log(f'{label} ok: first prefill pass and decode tick op by op, '
      f'largest relative error by opcode {worst}; ids that differ '
      f'{len(card_watch.id_diffs)}; int4g ctx share beyond '
      f'{INT4G_FINE_RTOL:g} {card_watch.fine_share:.4g}')
  return {'worst_rel_err_by_opcode': card_watch.worst,
          'id_diffs': len(card_watch.id_diffs),
          'int4g_ctx_share_beyond_fine': card_watch.fine_share}


def cpu_phase(torch, port, cfg, dev, decode_block=False, kv_int4_group=0,
              layers=None, setting=None):
  """Same weights, same first step at batch 8, f32: the card against the
  port on the CPU, at `layers` layers (default: all of cfg's).

  The CPU run keeps every op's output. The card then runs the step op by
  op from those values: each op's inputs are the CPU's, so each op's
  difference is its own. Float outputs must agree to 1e-5 of their largest
  magnitude (CPU and card differ by a few f32 ulps in libm and summation
  order), int8 codes to one step (the float before the rounding may differ
  by an ulp), and the ids exactly, except rows whose CPU top-2 logit
  margin is below 1e-3 relative.

  decode_block=False: start_pos 0 over zero caches. A free
  run of the card follows, reported only: there an ulp of one RMS_NORM
  flips int8 KV codes (per-tensor scale 0.06) and the flips compound over
  18 layers, so its ids may differ. decode_block=True runs the step with
  a decode-block unit in each layer but the first, each one op with four
  outputs held to the
  same tolerances (x_ffn and ctx 1e-5, the new K/V rows in the pools one
  code: the block forms cos and sin on its own device, and an ulp of cos
  can round a K code the other way), at start_pos BENCH_START over random
  int8 caches so that the attention reads 896 rows. kv_int4_group: the
  int4g step (executor defaults, no unit) at start_pos BENCH_START over
  int4-group pools quantized from random rows; each INT4G_ATTENTION op
  must write the CPU's pools and sidecar bit for bit (OpByOp). setting:
  one of BENCH_SETTINGS ('attn block', 'norm fusion'), the executor's
  options on top of bench.py's, at start_pos BENCH_START over random int8
  caches: no block unit forms; each layer's prologue and epilogue, or its
  two norm-fused FCs, must have been held (OpByOp's rules).
  """
  gemma, executor, head = port['gemma'], port['executor'], port['head']
  cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)
  b8 = 8
  graph = decode_graph(gemma, cfg, b8, kv_int4_group)
  weights = gemma.device_materialize_quantized(graph, fc_bits=4,
                                               embedding_bits=8, seed=3,
                                               device=dev)
  start = BENCH_START if decode_block or kv_int4_group or setting else 0
  inputs = gemma.make_inputs(cfg, 'decode', b8, 1, start_pos=start, seed=3,
                             device='cpu')
  if decode_block or setting:
    rng = np.random.default_rng(3)
    for key in [k for k in inputs if k.endswith('_cache_in')]:
      inputs[key] = torch.from_numpy(rng.integers(
          -127, 128, tuple(inputs[key].shape)).astype(np.int8))
  if kv_int4_group:
    gen = torch.Generator().manual_seed(3)
    for li in range(cfg.num_layers):
      inputs.update(zip(
          (f'layer_{li}_{kind}_cache_in' for kind in 'kvs'),
          int4g_pools(torch, port['attention'], b8, cfg.num_kv_heads,
                      cfg.max_seq_len, cfg.head_dim, gen, 'cpu')))
  label = 'card-vs-cpu' + (' (decode block)' if decode_block else '') + (
      ' (int4g)' if kv_int4_group else '') + (f' ({setting})' if setting
                                               else '')
  options = BENCH_SETTINGS[setting] if setting else dict(
      decode_block=decode_block or bool(kv_int4_group))

  def watched(device, want=None):
    ex = executor.GraphExecutor(graph, device=device,
                                activation_dtype='float32', **options)
    ex.load_weights(weights)
    ex.prepare_serving_weights(min_weight_params=0)
    return OpByOp(torch, ex, want=want, int_qmatmul=port['int_qmatmul'])

  t0 = time.monotonic()
  cpu = watched('cpu')
  cpu_ids = cpu.call(inputs, 'decode')['next_tokens'].reshape(-1)
  log(f'{label}: cpu step {time.monotonic() - t0:.1f}s ids '
      f'{cpu_ids.tolist()}')
  head_tid = next(iter(cpu.ex._head_fusions.values()))['out']
  margin = top2_margins(torch, head, cpu, 0, head_tid)
  card = watched(dev, want=cpu.seen)
  card.call(inputs, 'decode')
  units = len(card.ex._block_fusions)
  held = {'attn block': ('decode/QKV prologue', 'decode/attention epilogue'),
          'norm fusion': ('decode/FC int4 norm-fused',)}.get(setting, ())
  if units != (cfg.num_layers - 1 if decode_block else 0) or (
      decode_block and 'decode/FUSED_BLOCK' not in card.worst) or (
          kv_int4_group and 'decode/INT4G_ATTENTION' not in card.worst) or (
              any(kind not in card.worst for kind in held)):
    raise AssertionError(f'{label}: {units} decode-block units, ops held '
                         f'{sorted(card.worst)}')
  worst = {k: f'{v:.2e}' for k, v in sorted(card.worst.items())}
  log(f'{label} op by op: largest relative error by opcode {worst}; int8 '
      f'codes one step apart by opcode {card.flips}; int4g ctx share beyond '
      f'{INT4G_FINE_RTOL:g} {card.fine_share:.4g}; attention-epilogue rows '
      f'beyond 1e-5 {card.epilogue_rows_off}')
  judge_ids(torch, head, cpu, card, label)
  log(f'{label} ok: the card\'s ids equal the cpu ids in '
      f'{b8 - len(card.id_diffs)} of {b8} rows, cpu top-2 margins '
      f'{[f"{float(m):.2e}" for m in margin]}')
  result = {'worst_rel_err_by_opcode': card.worst,
            'int8_flips_by_opcode': card.flips,
            'id_diffs': len(card.id_diffs), 'block_units': units,
            'int4g_ctx_share_beyond_fine': card.fine_share,
            'epilogue_rows_beyond_1e-5': card.epilogue_rows_off,
            'layers': cfg.num_layers}
  if decode_block or kv_int4_group or setting:
    return result
  free = watched(dev)
  free_ids = free.call(inputs, 'decode')['next_tokens'].reshape(-1).cpu()
  tids = {t.name: tid for tid, t in enumerate(
      graph.subgraphs[graph.signature_by_key('decode').subgraph_index]
      .tensors)}

  def drift(name):
    got, want = free.seen[0][tids[name]].double(), cpu.seen[0][tids[name]]
    return float(torch.max(torch.abs(got - want.double()))
                 / torch.max(torch.abs(want.double())))

  log(f'card-vs-cpu free run (reported only): ids {free_ids.tolist()}, '
      f'{int(torch.sum(free_ids != cpu_ids))} of {b8} rows differ; largest '
      'relative difference '
      f'{drift("decode/layer_0/attn_residual"):.2e} in layer 0\'s attention '
      f'residual, {drift("decode/final_norm/out"):.2e} at the final norm')
  return result


def block_on_off_phase(torch, port, cfg, dev, layers=4, batch=8, steps=4):
  """The decode block on against off on the card at f32 activations
  (`tests/test_block_fusion_executor.py`'s contract): GEMMA_2B widths cut
  to `layers` layers, `batch` rows, `steps` greedy steps from start_pos
  BENCH_START over random int8 caches. Reported: ids and cache codes that
  differ. Where they differ, the cause is the new row's quantization: the
  unfused path divides by the scale (quant_arith.quantize), the block
  multiplies by its f32 inverse as the TPU kernel does, and the two round
  a code the other way about once in a million."""
  gemma, executor = port['gemma'], port['executor']
  cfg_l = dataclasses.replace(cfg, num_layers=layers)
  graph = decode_graph(gemma, cfg_l, batch)
  weights = gemma.device_materialize_quantized(graph, fc_bits=4,
                                               embedding_bits=8, seed=7,
                                               device=dev)
  gen = torch.Generator(device=dev).manual_seed(7)
  caches = {k: torch.randint(-127, 128, tuple(v.shape), generator=gen,
                             device=dev).to(torch.int8)
            for k, v in gemma.zero_caches(graph, 'decode', dev).items()}
  tokens0 = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                          device=dev).to(torch.int32)
  runs = {}
  for block_on in (True, False):
    ex = executor.GraphExecutor(graph, device=dev, activation_dtype='float32',
                                decode_block=block_on)
    ex.load_weights(weights)
    ex.prepare_serving_weights(min_weight_params=0)
    feed = {k: v.clone() for k, v in caches.items()}
    step = decode_stepper(torch, ex, cfg_l, batch, feed, dev)
    pos = torch.tensor(BENCH_START, dtype=torch.int32, device=dev)
    tokens, ids = tokens0, []
    for _ in range(steps):
      tokens = step(pos, tokens)
      pos = pos + 1
      ids.append(tokens)
    runs[block_on] = (len(ex._block_fusions), torch.cat(ids, dim=1), feed)
  units, ids_on, caches_on = runs[True]
  _, ids_off, caches_off = runs[False]
  if units != layers - 1:
    raise AssertionError(f'block on/off: {units} units')
  id_diffs = int(torch.sum(ids_on != ids_off))
  code_diffs = sum(int(torch.sum(caches_on[k] != caches_off[k]))
                   for k in caches_on)
  max_diff = max(int(torch.max(torch.abs(caches_on[k].int()
                                         - caches_off[k].int())))
                 for k in caches_on)
  log(f'block on against off on the card, f32, {layers} layers, batch '
      f'{batch}, {steps} steps from {BENCH_START}: ids that differ '
      f'{id_diffs} of {ids_on.numel()}, cache codes that differ {code_diffs} '
      f'(largest difference {max_diff})')
  return {'layers': layers, 'batch': batch, 'steps': steps,
          'id_diffs': id_diffs, 'cache_code_diffs': code_diffs,
          'cache_max_code_diff': max_diff}


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--skip-cpu', action='store_true')
  args = parser.parse_args()
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; nothing was run.', file=sys.stderr)
    return 2
  root = pathlib.Path(__file__).resolve().parent
  if not (root / 'ai_edge_quantizer_tpu_torch' / 'kernels' / 'csrc').is_dir():
    print('chip_smoke: run it from a checkout of the repository.',
          file=sys.stderr)
    return 2
  sys.path.insert(0, str(root))
  from ai_edge_quantizer_tpu_torch import Quantizer
  from ai_edge_quantizer_tpu_torch.execution import executor
  from ai_edge_quantizer_tpu_torch.graph import ir, serialize
  from ai_edge_quantizer_tpu_torch.kernels import _build
  from ai_edge_quantizer_tpu_torch.kernels import attention, block, cache
  from ai_edge_quantizer_tpu_torch.kernels import head
  from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
  from ai_edge_quantizer_tpu_torch.kernels import mlp, packed_qmatmul, qkv
  from ai_edge_quantizer_tpu_torch.models import gemma
  from ai_edge_quantizer_tpu_torch.ops import impl as ops_impl
  from ai_edge_quantizer_tpu_torch.parallel import batching
  from ai_edge_quantizer_tpu_torch.utils import progress_utils
  if any(m == 'jax' or m.startswith(('jax.', 'ai_edge_quantizer_tpu.'))
         or m == 'ai_edge_quantizer_tpu' for m in sys.modules):
    raise AssertionError('the port imported jax or the JAX package')
  port = dict(executor=executor, attention=attention, block=block,
              cache=cache, head=head,
              mlp=mlp, packed_qmatmul=packed_qmatmul, gemma=gemma,
              batching=batching, ops_impl=ops_impl, ir=ir,
              int_qmatmul=int_qmatmul, serialize=serialize, qkv=qkv,
              Quantizer=Quantizer, progress_utils=progress_utils)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  t_start = time.monotonic()
  smi = run_text(['nvidia-smi', '--query-gpu=name,power.limit',
                  '--format=csv,noheader']).splitlines()[0]
  nvcc = run_text([_build.nvcc_path(), '--version']).splitlines()[-1]
  build_s = _build.build()
  log(f'facts: torch {torch.__version__} cuda {torch.version.cuda}; '
      f'nvcc {nvcc}; card {smi}; kernel build {build_s:.1f}s')
  for name in _build.SOURCES:
    report = (_build.BUILD_DIR / f'{name}.log').read_text()
    lines = [l.strip() for l in report.splitlines()
             if 'registers' in l or 'spill' in l]
    log(f'ptxas {name}: ' + ' | '.join(lines[:8]))

  global sync
  sync = torch.cuda.synchronize
  cfg = gemma.GEMMA_2B
  kernels = kernel_phase(torch, port, cfg, 'cuda', Timer(torch))
  log(f'phase kernels done at {time.monotonic() - t_start:.1f}s')
  e2e = serve_phase(torch, port, kernels, cfg, 'cuda')
  log(f'e2e on {smi}: {e2e["ms_per_step"]:.3f} ms/step (median), '
      f'{e2e["tokens_per_s"]:.1f} tokens/s at batch {B}')
  log(f'phase decode loop done at {time.monotonic() - t_start:.1f}s')
  bench = bench_decode_phase(torch, port, kernels, cfg, 'cuda')
  for mode in BENCH_SETTINGS:
    r = bench[mode]
    log(f'bench decode on {smi}, {mode}: {r["ms_per_step"]:.3f} ms/step '
        f'(median), {r["tokens_per_s"]:.1f} tokens/s at batch {BENCH_B}, '
        f'device idle share {r["device_idle_share"]:.3f}')
  bench4 = bench_decode_int4g_phase(torch, port, kernels, cfg, 'cuda')
  log(f'bench decode int4g on {smi}: {bench4["ms_per_step"]:.3f} ms/step '
      f'(median), {bench4["tokens_per_s"]:.1f} tokens/s at batch {BENCH_B}, '
      f'device idle share {bench4["device_idle_share"]:.3f}')
  log(f'phase bench decode done at {time.monotonic() - t_start:.1f}s')
  server = server_phase(torch, port, kernels, cfg, 'cuda')
  log(f'server on {smi}: {server["tokens_per_s"]:.1f} tokens/s, TTFT p50 '
      f'{server["ttft_p50_ms"]:.1f} ms p99 {server["ttft_p99_ms"]:.1f} ms')
  server4 = server_phase(torch, port, kernels, cfg, 'cuda',
                         kv_int4_group=INT4G_GROUP)
  log(f'server int4g on {smi}: {server4["tokens_per_s"]:.1f} tokens/s, TTFT '
      f'p50 {server4["ttft_p50_ms"]:.1f} ms p99 {server4["ttft_p99_ms"]:.1f} '
      f'ms, chunk of {SERVE_CHUNK} ticks {server4["chunk_ms"]:.3f} ms (idle '
      f'{server4["chunk_idle_share"]:.3f})')
  log(f'phase server done at {time.monotonic() - t_start:.1f}s')
  kept = None if args.skip_cpu else {}
  quant = quantizer_phase(torch, port, kernels, cfg, 'cuda', kept=kept)
  for recipe in QUANT_RECIPES:
    r = quant[recipe]
    log(f'quantized {recipe} server ({r["layers"]} layers) on {smi}: '
        f'{r["tokens_per_s"]:.1f} tokens/s, TTFT p50 {r["ttft_p50_ms"]:.1f} '
        f'ms p99 {r["ttft_p99_ms"]:.1f} ms; prefill pass '
        f'{r["prefill_pass_ms"]:.3f} ms, chunk of {SERVE_CHUNK} ticks '
        f'{r["chunk_ms"]:.3f} ms (idle {r["chunk_idle_share"]:.3f}); quantize '
        f'{r["quantize_s"]:.1f}s, export {r["export_s"]:.1f}s, load '
        f'{r["load_s"]:.1f}s, .aeqg {r["aeqg_bytes"]} bytes')
  log(f'phase quantizer done at {time.monotonic() - t_start:.1f}s')
  if not args.skip_cpu:
    def done(label):
      log(f'card-vs-cpu {label} done at {time.monotonic() - t_start:.1f}s')
    e2e['card_vs_cpu'] = cpu_phase(torch, port, cfg, 'cuda')
    done('decode step')
    bench['card_vs_cpu'] = cpu_phase(torch, port, cfg, 'cuda',
                                     decode_block=True, layers=4)
    done('block step')
    bench4['card_vs_cpu'] = cpu_phase(torch, port, cfg, 'cuda',
                                      kv_int4_group=INT4G_GROUP, layers=4)
    done('int4g step')
    for setting in ('attn block', 'norm fusion'):
      bench[f'card_vs_cpu_{setting}'] = cpu_phase(
          torch, port, cfg, 'cuda', setting=setting, layers=FUSION_CPU_LAYERS)
      done(f'{setting} step')
    server['card_vs_cpu'] = server_cpu_phase(torch, port, cfg, 'cuda')
    done('server')
    server4['card_vs_cpu'] = server_cpu_phase(torch, port, cfg, 'cuda',
                                              kv_int4_group=INT4G_GROUP)
    done('int4g server')
    bench['block_on_vs_off_f32'] = block_on_off_phase(torch, port, cfg,
                                                      'cuda')
    done('block on/off')
    quant['card_vs_cpu'] = quantizer_cpu_phase(torch, port, cfg, 'cuda',
                                               kept=kept)
    log(f'phase card-vs-cpu done at {time.monotonic() - t_start:.1f}s')
  line = []
  for k in kernels:
    entry = {key: v for key, v in k.items() if key != 'wrapper'}
    bench_launches = entry.pop('launches_bench_decode')
    entry['launches_by_path'] = {
        'decode_loop': entry.pop('launches_decode_loop'),
        'server': server['launches'][k['name']],
        'bench_decode_block_on': bench_launches['block on'],
        'bench_decode_block_off': bench_launches['block off'],
        'bench_decode_splice': bench_launches['splice'],
        'bench_decode_inplace': bench_launches['inplace'],
        'bench_decode_attn_block': bench_launches['attn block'],
        'bench_decode_norm_fusion': bench_launches['norm fusion'],
        'bench_decode_int4g': bench_launches['int4g'],
        'server_int4g': server4['launches'][k['name']],
        **{f'server_{recipe}': quant[recipe]['launches'][k['name']]
           for recipe in QUANT_RECIPES}}
    # The count of the path that runs the kernel (the stale kernel runs
    # only in the decode loops: the server's one-hot cache update leaves
    # no row write to fold into attention; the fused block only in the
    # bench decode with the block on; the int4-group attention only on
    # the int4g paths; the int8 DRQ and weight-only kernels only on the
    # quantized graphs' servers; the splice attention and the in-place row
    # write only in the bench decode with those settings; the blockwise
    # matmul and the live-prefix attention only in the blockwise server;
    # the prologue and the epilogue only in the bench decode with the
    # attention block, the norm-fused matmul only with the norm fusion).
    by_path = entry['launches_by_path']
    entry['launches'] = (by_path['server'] or by_path['decode_loop']
                         or by_path['bench_decode_block_on']
                         or by_path['server_int4g']
                         or by_path['bench_decode_int4g']
                         or by_path['server_gemma_mixed48']
                         or by_path['server_gemma_mixed48_b32']
                         or by_path['server_gemma_mixed48_hr']
                         or by_path[f'server_{DEFAULT_MODE}']
                         or by_path['bench_decode_splice']
                         or by_path['bench_decode_inplace']
                         or by_path[f'server_{BLOCKWISE_MODE}']
                         or by_path['bench_decode_attn_block']
                         or by_path['bench_decode_norm_fusion'])
    entry['kernel_ms'] = entry['ms']
    entry['launches_per_step'] = entry.pop('per_step')
    line.append(entry)
  missing = [e['name'] for e in line if not e['launches']]
  if missing:
    raise AssertionError(f'kernels never launched on the main paths: '
                         f'{missing}')
  print(json.dumps({'kernels': line, 'e2e': e2e, 'bench_decode': bench,
                    'bench_decode_int4g': bench4, 'server': server,
                    'server_int4g': server4, 'quantizer': quant,
                    'card': smi}), flush=True)
  print(smi, flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
