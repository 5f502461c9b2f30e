#!/usr/bin/env python3
"""Drives the PyTorch port (ai_edge_quantizer_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA device, nvcc (on PATH or /usr/local/cuda/bin) and no network. It
builds the port's CUDA kernels from kernels/csrc at first use, then:

  1. facts: torch.version.cuda, nvcc --version, the card's name and power
     limit (nvidia-smi) and the kernels' build time;
  2. kernels: each of the twenty-four kernel wrappers (the 22 Pallas
     sites of the JAX package; #3 and #4 have a DRQ and a weight-only
     wrapper each) against its plain PyTorch version
     on the card at the main paths' shapes (Gemma-2B; decode at batch 64
     and cache 1024, bench.py's decode at batch 256 with 897 live cache
     rows, prefill at 8 x 128 tokens; bf16 activations), with the stated
     tolerances; CUDA-event medians of the kernel, the plain version and,
     where one PyTorch call computes the same contraction or attention,
     that call (`library_ms`, never used by the port), and for the fused
     decode block the composition of the unfused kernels it replaces; the
     greedy head's DRQ branches (head_kernel: int8 at decode, prefill and
     bench rows, packed int4 at decode and bench rows, ties across and
     inside 128-column tiles, true_n < N; ids identical); the fused block
     (block_kernel) also with NQ 17, where #2's one-block body takes its
     attention, in each compute mode; the
     bound from bytes over 3.35 TB/s or operations over the peak rate; the
     int4-group attention at pos 0/31/32/896/1023 and the server's mixed
     lengths, with INT4G_ATTENTION_SCATTER's pools and sidecar equal to
     its CPU run bit for bit, and its bench case over the draws of
     INT4G_SWEEP_SEEDS (int4g_seed_sweep); the int8 DRQ matmul (bit for bit) and the
     weight-only matmul (blockwise 32 and channelwise, within
     int_qmatmul.int_weights_tolerance) at the quantized serving graph's
     shapes; the K-blocked int4 DRQ matmul bit for bit at the down
     projection's shapes (N 2048, K 16384, decode and prefill rows), M = 1,
     17, an odd M and 200, N 200 and two small K, bf16 and f32 x, with and
     without a bias, timed beside torch._int_mm; the three DRQ matmuls
     of the int8 tensor-core core (int8, K-blocked and the int4 DRQ
     matmul, this one at the QKV and out-projection shapes, decode,
     bench and prefill rows, M 1, 17 and 200, a ragged N and K and
     uneven splits) also at their edge shapes and twice in a row
     on fresh inputs, bit for bit, with each shape's launch plan (grid,
     split-K, shared memory) and ptxas' registers and spills logged; the
     tensor-core flash attention at the server's prefill and at
     FLASH_CASES (H 64 and 128, NK 2 with both mask layouts, f32 q, a bf16
     mask, ragged and odd S, ragged R, a fully masked row), with its
     launch plans and registers; the kernels of the JAX executor's
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
     at bench.py's shape (pos 896, 0, 31, 32, 127, 128, 1023) and at B 64
     (pos 896), pools bit for bit,
     the in-place row write (bit for bit, clipped starts) and the
     live-prefix attention (B 64 and 256, zero-length rows; at B 64 also
     every length S and every length below 128); the split-S attentions
     of attention_split_tc.cuh (#17, #18, the lengths attention #7, the
     stale attention #2, the splice attention #8 and the int4-group
     attention #10, #7, #2, #8 and #10 timed at B 64 and at bench.py's
     B 256, #7, #2 and #8 in every compute mode) log each shape's launch
     (splits, cluster, rows a CTA; cluster 0 for a one-block kernel, which
     takes the shapes the core does not) and ptxas' registers, and #7,
     #2, #8 and #10 run at S 8192 (the core's) and H 512 (the one-block
     kernels'); the kernels
     of the norm fusion and the attention block (attn_block_kernels): the
     norm-fused weight-only matmul at the QKV and gate/up shapes (M 256
     and 64, bf16 and f32 x, with and without a bias, N padded), the
     norm + QKV + RoPE prologue (M 256 and 64, bf16 and f32, DRQ bit for
     bit and weight-only) and the attention + out-projection + residual
     epilogue (B 256 and 64, lengths 897, 0, 1 and S, bf16 and f32, DRQ bit
     for bit given the lengths kernel's context, weight-only), each timed
     beside the unfused kernels it replaces (and the norm-fused matmul
     beside #12 alone, the epilogue beside #7 + #1 alone) with its
     launches' plans and ptxas report; the attention compute modes
     (compute_mode_kernels): the stale attention (B 64 and bench.py's
     decode), the lengths attention (the server's tick, and a zero length)
     and the decode block (bench.py's step) in bf16 and int8 beside their
     f32 rows (mode_ctx_check; the block's codes and pools bit for bit);
     the masked attention (B 64 and 256, prefix masks with an idle row
     and a non-prefix mask), the splice attention (bench.py's shape and
     B 64, a zero-length row) and the epilogue (bench.py's DRQ step, B 64
     weight-only) in bf16 and int8, int8 bit for bit (#8's pools too);
     the basic int8 decode attention (#22, B 64 and 256, equal to the
     lengths attention's plain version with zero points 0) and the per-row
     int4 KV attention (#21, the A/B tool's shape B 256 and B 64, against
     its plain version and the f32 twin of decode_attention_int4_ref);
     four attention shapes the CUDA kernels do not take must raise (#7 and
     #10 at S 65536), and the epilogue with two KV heads or an odd head
     count;
  2b. A/B tool: `python -m ai_edge_quantizer_tpu_torch.tools.attn_int4_bench`
     at its defaults (B 256, S 1024, 18 chained launches, 16 steps) through
     its `main`: its artifact line (ms, GB/s, rel_err_vs_float per format:
     int8 lengths f32, int4 per row, int4 per group), each format's chained
     output against the same chain of the plain versions, the launches;
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
     and bench.py's own settings with AEQT_ATTN_COMPUTE=bf16 and =int8
     (attn_compute; the block on's launches: block 17, stale attention 1),
     and the splice and attention-block settings in each mode (splice 18,
     epilogue 18 a step, in the mode), ids compared with the same setting's
     at f32 (MODE_SETTINGS);
  4. server: the port's DecodeServer at bench.py's server settings serves
     128 requests (prompt lengths cycling 32..512, 48 new tokens each) by
     step_chunk(8); every request must end done with 48 ids in range, and
     each kernel's launches must match the executor calls (the plain
     versions never run on the card); tokens/s, TTFT p50/p99, ms per
     prefill pass and per chunk of 8 ticks, and the device's idle share
     (torch.profiler) are printed; then the same with int4-group pools
     (AEQT_BENCH_SERVER_KV=int4g: int4g attention 18 per tick, no flash
     or lengths launch); then the int8-KV server with
     executor_options={'attn_compute': 'bf16'} and {'attn_compute':
     'int8'} (the ticks' lengths attention 18 a tick in the mode);
  4b. quantizer: examples/serve_gemma.py's flow at full width through the
     port's own entry points: the float serving graph (weights drawn on
     the host, int8 KV stamped) built once at each depth, then for
     gemma_mixed48, gemma_mixed48_b32 and gemma_mixed48_hr (a Hadamard
     rotation before each int4 FC, OCTAV clipping) and serve_gemma's own
     quantization (DEFAULT_MODE: add_dynamic_config with every FC int4,
     served with executor.JAX_DEFAULT_OPTIONS, the JAX executor's default
     mode), these four at 2 layers (QUANT_LAYERS), and the same in blocks
     of 128 (BLOCKWISE_MODE, 9 layers, served with JAX_DEFAULT_OPTIONS
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
     flash 18 a pass); DEFAULT_MODE's loaded graph then served again with
     attn_compute bf16 and int8 (default_mode_servers: the masked attention
     in the mode, as many launches as the f32 server's); the live-prefix
     attention's device time in the blockwise server's chunk of ticks and
     the masked attention's in the default-mode servers' (chunk_device_ms);
  4c. static range (static_range_phase): bench.py's bench_encoder at full
     width and depth (BERT_BASE_LITE: D 768, 12 heads, FFN 3072, T 512, 4
     layers, vocab 30528; batch 32, weights from seed 0) through the
     port's entry points: Quantizer.calibrate in device_stats mode (4
     samples) and in capture mode (one; min and max equal to device_stats'
     on it), default_a8w8 quantized and run (sequences/s, device busy),
     then op by op against the CPU port at batch 2 (the static-range FC and
     BATCH_MATMUL codes equal, other ops' one-step flips within
     SRQ_FLIP_SHARE), default_a16w8 end to end, validate() of the a8w8
     model (at batch 2), dynamic_wi4_afp32_gptq_octav calibrated,
     quantized and run with its Newton-Schulz Hessian inverse on the card
     against the host's, and compare_model(..., use_serving_paths=True)
     of the quantizer phase's 2-layer gemma_mixed48 serving graph (the
     int8 DRQ, MLP, head and lengths-attention kernels launched under
     capture); host seconds of each step;
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
     int_weights_tolerance, the epilogue's rows by EPILOGUE_ROW_RTOL); and
     the decode step at FUSION_CPU_LAYERS layers in each of MODE_SETTINGS
     (the block, the splice and the attention block in each compute mode:
     the context rows, and the epilogue's, by ATTN_MODE_ROW_RTOL, at most
     ATTN_MODE_ROWS_OFF of them beyond 1e-5 in a layer), and DEFAULT_MODE's
     server pass and tick in each compute mode (the masked attention's
     context by the same rule).

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
import re
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

  # 1. int4 DRQ matmul (on the int8 tensor-core core): bit for bit at
  # INT4_DRQ_EDGE_SHAPES, then timed at the fused
  # QKV and the out-projection of a layer, at a decode step's rows (B),
  # bench.py's decode rows (BENCH_B) and a prefill pass's rows (Bp * T).
  def drq_inputs(m, n, k):
    w = pq.pack_int4_split(randint(-8, 8, n, k))
    return (randn(m, k), w, scales(n),
            torch.randn((n,), generator=gen, device=dev))

  def drq_plan(m, n, k):
    return port['_build'].plan('qmatmul_int4_drq',
                               'aeqt_qmatmul_int4_drq_plan',
                               'qmatmul_int4_packed_drq', m, n, k)

  shapes = [(name, m, n or (NQ + 2 * NK) * H, k or D)
            for name, m, n, k in INT4_DRQ_EDGE_SHAPES]
  shapes += [(f'{phase}_{label}', m, n, D)
             for phase, m in (('decode', B), ('bench', BENCH_B),
                              ('prefill', PREFILL_ROWS))
             for label, n in (('qkv', (NQ + 2 * NK) * H), ('out_proj', D))]
  drq_edges = tc_edge_checks(torch, pq.qmatmul_int4_packed_drq,
                             pq.qmatmul_int4_packed_drq_plain, drq_inputs,
                             shapes, 'int4 DRQ')
  for row in drq_edges:
    row['launch'] = drq_plan(row['M'], row['N'], row['K'])
  drq_ptxas = ptxas_report(port['_build'], 'qmatmul_int4_drq',
                           'int8_tc_gemm_kernel')
  log(f'kernel qmatmul_int4_packed_drq edges ok: bit for bit, twice in a '
      f'row; {drq_edges}; ptxas {drq_ptxas}')
  by_shape = []
  for phase, m in (('decode', B), ('bench', BENCH_B),
                   ('prefill', PREFILL_ROWS)):
    for label, n in (('qkv', (NQ + 2 * NK) * H), ('out_proj', D)):
      x, w, s, _ = drq_inputs(m, n, D)
      xq = pq.quantize_rows_drq(x.float())[0]
      w_t = pq.unpack_int4_split(w).t()
      nbytes = m * D * 2 + n * D // 2 + n * 4 + m * n * 2
      b_ms, b_by = bound(nbytes, 2 * m * n * D, INT8_OPS_PER_S)
      by_shape.append({
          'phase': phase, 'shape': label, 'M': m, 'N': n, 'K': D,
          'ms': timer(lambda: pq.qmatmul_int4_packed_drq(x, w, s)),
          'plain_ms': timer(
              lambda: pq.qmatmul_int4_packed_drq_plain(x, w, s)),
          'library_ms': timer(lambda: torch._int_mm(xq, w_t)),
          'bound_ms': b_ms, 'bound_by': b_by, 'launch': drq_plan(m, n, D)})

  def mean(key, phase):
    rows = [r[key] for r in by_shape if r['phase'] == phase]
    return sum(rows) / len(rows)

  timing = ('ms', 'plain_ms', 'bound_ms', 'library_ms')
  results.append({
      'name': 'qmatmul_int4_packed_drq', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/qmatmul_int4_drq.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py:667',
      'jax': 'pallas_qmatmul.qmatmul_pallas_int4_packed_drq',
      'wrapper': pq.qmatmul_int4_packed_drq, 'per_step': 2 * cfg.num_layers,
      'max_abs_err': max(r['max_abs_err'] for r in drq_edges),
      **{key: mean(key, 'decode') for key in timing}, 'bound_by': 'bytes',
      'library': 'torch._int_mm on the unpacked int8 weight (contraction '
                 'only)',
      'prefill': {key: mean(key, 'prefill') for key in timing},
      'bench': {key: mean(key, 'bench') for key in timing},
      'by_shape': by_shape, 'edge_checks': drq_edges, 'ptxas': drq_ptxas})
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
  build = port['_build']
  results.append({
      'name': 'decode_attention_int8_lengths_stale', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/attention_stale.cu',
      'core': SPLIT_CORE,
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
      'launch': split_plan(build, 'attention_stale', B * NK, G, S, H, 0),
      'bench': stale_bench(torch, att, build, cfg, dev, timer, gen),
      'ptxas': ptxas_report(build, 'attention_stale',
                            'stale_attention_split_kernel')})
  log(f'kernel decode_attention_int8_lengths_stale ok: err {err32}, launch '
      f'{results[-1]["launch"]}')

  # 3. MLP, DRQ branch (#3, on the int8 tensor-core core).
  results.append(mlp_drq_kernel(torch, port, cfg, dev, timer, gen))

  # 4. Greedy head, DRQ (the tied 256128 x 2048 embedding, and packed):
  # the shared generator's draws are the ones this check always took, so
  # that every later check sees the inputs it saw before; head_kernel's
  # further inputs come from a generator of its own.
  x = randn(B, 1, D)
  w_q = randint(-127, 128, V, D)
  s = scales(V)
  xb = randn(BENCH_B, 1, D)
  results.append(head_kernel(torch, port, cfg, dev, timer, (x, w_q, s, xb)))
  results.append(lengths_kernel(torch, att, port['_build'], cfg, dev, timer,
                                gen))
  results.append(flash_kernel(torch, att, port['_build'], cfg, dev, timer,
                              gen))
  results.append(block_kernel(torch, port, cfg, dev, timer, gen))
  results.append(int4g_kernel(torch, port, cfg, dev, timer, gen))
  results[-1]['seed_sweep'] = int4g_seed_sweep(torch, port, cfg, dev)
  results.extend(int_weight_kernels(torch, port, cfg, dev, timer, gen))
  results.append(kblock_kernel(torch, port, cfg, dev, timer, gen))
  results.extend(default_mode_kernels(torch, port, cfg, dev, timer, gen))
  results.extend(cache_mode_kernels(torch, port, cfg, dev, timer, gen))
  results.extend(attn_block_kernels(torch, port, cfg, dev, timer, gen))
  compute_mode_kernels(torch, port, cfg, dev, timer, gen, results)
  results.append(int8_basic_kernel(torch, port, cfg, dev, timer, gen))
  results.append(int4_row_kernel(torch, port, cfg, dev, timer, gen))
  split_edge_shapes(torch, att, port['_build'], dev, gen, results)
  refused_shapes(torch, att, dev)
  return results


def mlp_drq_kernel(torch, port, cfg, dev, timer, gen):
  """#3's DRQ branch against its plain version at bf 2048 (the bench's
  AEQT_MLP_BF) and 512: a decode step's rows (B), a bench step's
  (BENCH_B), a prefill pass's (PREFILL_ROWS) and a ragged M 7, gelu, and
  silu once at decode; held to 1e-3 of max |y| (a one-ulp tanh difference
  may flip one hidden rounding), the outputs that differ in any bit
  counted. Timed at the three row counts of each bf beside the plain
  version and, as a yardstick only, the library composition of the same
  function: torch._int_mm for gate/up and per group for the down, the
  quantizes and scales in torch (many calls, so library_ms stays null);
  with each shape's launch plan (mlp.drq_plan) and ptxas' report."""
  pq, mlp = port['packed_qmatmul'], port['mlp']
  build = port['_build']
  D, F = cfg.embed_dim, cfg.ffn_dim

  def randint(lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device=dev).to(
        torch.int8)

  def scales(n):
    return torch.rand((n,), generator=gen, device=dev) * 0.01 + 0.005

  wgu_q = randint(-8, 8, 2 * F, D)
  wd_q = randint(-8, 8, D, F)
  wgu, sgu, sd = pq.pack_int4_split(wgu_q), scales(2 * F), scales(D)

  def library(x, wd_groups, act):
    """The same function from PyTorch calls (a yardstick, on no path)."""
    xq, xs = pq.quantize_rows_drq(x.reshape(-1, D).float())
    gu = torch._int_mm(xq, wgu_q.t())
    gate = (gu[:, :F].float() * xs) * sgu[:F]
    up = (gu[:, F:].float() * xs) * sgu[F:]
    h = mlp.activation(act)(gate) * up
    acc = torch.zeros((x.shape[0], D), dtype=torch.float32, device=dev)
    bf = F // len(wd_groups)
    for t, w in enumerate(wd_groups):
      hq, hs = pq.quantize_rows_drq(h[:, t * bf:(t + 1) * bf])
      acc = acc + torch._int_mm(hq, w.t()).float() * hs
    return (acc * sd).to(x.dtype)

  rows = {}
  for bf in (min(2048, F // 2), min(512, F // 2)):
    wd = mlp.pack_int4_split_grouped(wd_q, bf)
    wd_groups = [wd_q[:, t * bf:(t + 1) * bf].contiguous()
                 for t in range(F // bf)]
    shapes = [('decode', B, 'gelu'), ('bench', BENCH_B, 'gelu'),
              ('prefill', PREFILL_ROWS, 'gelu'), ('ragged', 7, 'gelu')]
    if bf == min(512, F // 2):
      shapes.append(('decode_silu', B, 'silu'))
    for phase, m, act in shapes:
      x = torch.randn((m, 1, D), generator=gen, device=dev).to(torch.bfloat16)
      margs = (x, wgu, sgu, wd, sd)
      got = mlp.mlp_int4_packed(*margs, act=act, bf=bf)
      want = mlp.mlp_int4_packed_plain(*margs, act=act, bf=bf)
      sync()
      err = float(torch.max(torch.abs(got.float() - want.float())))
      ymax = float(torch.max(torch.abs(want.float())))
      if err > 1e-3 * ymax:
        raise AssertionError(f'mlp bf {bf} {phase}: max err {err} vs max '
                             f'|y| {ymax}')
      row = {'M': m, 'bf': bf, 'act': act, 'max_abs_err': err,
             'max_abs_y': ymax, 'outputs_differ': bits_differ(torch, got,
                                                              want),
             'launch': mlp.drq_plan(m, D, F, bf)}
      if phase in ('decode', 'bench', 'prefill'):
        nbytes = (m * D * 2 + 2 * F * D // 2 + 2 * F * 4 + D * F // 2
                  + D * 4 + m * D * 2)
        b_ms, b_by = bound(nbytes, 3 * 2 * m * F * D, INT8_OPS_PER_S)
        lib = library(x.reshape(m, D), wd_groups, act)
        sync()
        row.update(
            ms=timer(lambda: mlp.mlp_int4_packed(*margs, act=act, bf=bf)),
            plain_ms=timer(lambda: mlp.mlp_int4_packed_plain(
                *margs, act=act, bf=bf), reps=25 if m <= B else 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            library_composition_ms=timer(
                lambda: library(x.reshape(m, D), wd_groups, act), reps=5),
            library_composition_max_abs_err=float(torch.max(torch.abs(
                lib.float() - want.reshape(m, D).float()))))
      rows[f'bf{bf}_{phase}'] = row
      log(f'kernel mlp_int4_packed bf {bf} {phase} (M {m}, {act}) ok: err '
          f'{err} (max |y| {ymax}), {row["outputs_differ"]} outputs differ; '
          + (f'{row["ms"]:.4f} ms (plain {row["plain_ms"]:.4f}, library '
             f'composition {row["library_composition_ms"]:.4f}, bound '
             f'{row["bound_ms"]:.4f}); ' if 'ms' in row else '')
          + f'launch {row["launch"]}')
  bf = min(2048, F // 2)
  dec = rows[f'bf{bf}_decode']
  return {
      'name': 'mlp_int4_packed', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/mlp_int4_drq.cu',
      'core': 'ai_edge_quantizer_tpu_torch/kernels/csrc/int8_tc_gemm.cuh',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_mlp.py:268',
      'jax': 'pallas_mlp.mlp_pallas_int4_packed (drq=True)',
      'wrapper': mlp.mlp_int4_packed, 'per_step': cfg.num_layers,
      'max_abs_err': max(r['max_abs_err'] for r in rows.values()),
      'max_abs_y': dec['max_abs_y'], 'ms': dec['ms'],
      'plain_ms': dec['plain_ms'], 'bound_ms': dec['bound_ms'],
      'bound_by': dec['bound_by'], 'library_ms': None,
      'library_composition_ms': dec['library_composition_ms'],
      'library_composition': 'torch._int_mm for gate/up and for each '
                             'group of the down, the quantizes in torch',
      'launch': dec['launch'], 'prefill': rows[f'bf{bf}_prefill'],
      'bench': rows[f'bf{bf}_bench'], 'rows': rows,
      'ptxas': ptxas_report(build, 'mlp_int4_drq', 'mlp_tc_kernel')
               + ptxas_report(build, 'mlp_int4_drq', 'hquant_kernel')}


def stale_bench(torch, att, build, cfg, dev, timer, gen):
  """Stale attention at bench.py's decode: BENCH_B rows, every one
  BENCH_START + 1 long (BENCH_START live cache rows), f32 compute, bf16
  output; checked against the plain version as in the kernel phase, with
  its launch (split_plan)."""
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
      'library_ms': timer(lambda: sdpa(q, kd, vd, attn_mask=amask)),
      'launch': split_plan(build, 'attention_stale', BENCH_B * NK, G, S, H,
                           0)}


def head_kernel(torch, port, cfg, dev, timer, drawn):
  """#4's DRQ branches (csrc/head_argmax.cu on the int8 tensor-core core
  with an argmax epilogue) against the plain version: the tied int8 head
  (V x D; `drawn`: x at B rows, its weights and scales, x at BENCH_B
  rows) at a decode tick's rows (B), a prefill pass's (PREFILL_BATCH, the
  first of x) and a bench step's (BENCH_B), with a tie planted across two
  128-column tiles (rows 100 and V - 100, scaled to win), at B also with
  true_n < N
  and with a tie inside one tile (rows 200 and 201; weights of their own),
  and the packed int4 head at B and BENCH_B. Ids must be identical. Timed
  at B and BENCH_B beside the plain version and, as a yardstick only, the
  library composition torch._int_mm + scale + cast + torch.argmax on the
  same codes (the unpacked weights for the packed head; the codes and
  scales of x made before, untimed), with the tile launch's plan and
  ptxas' report."""
  head, pq, build = port['head'], port['packed_qmatmul'], port['_build']
  D, V = cfg.embed_dim, cfg.vocab_size
  gen = torch.Generator(device=dev).manual_seed(4)

  def randint(lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device=dev).to(
        torch.int8)

  def scales(n):
    return torch.rand((n,), generator=gen, device=dev) * 0.01 + 0.005

  def planted(lo, hi, a, b_, s_win):
    w, s = randint(lo, hi, V, D), scales(V)
    w[b_] = w[a]
    s[a] = s[b_] = s_win
    return w, s

  x, w8, s8, xb = drawn
  w8[V - 100] = w8[100]  # across tiles
  s8[100] = s8[V - 100] = 1.0
  w8_in, s8_in = planted(-127, 128, 200, 201, 1.0)   # inside one tile
  w4_q, s4 = planted(-8, 8, 100, V - 100, 1.0)
  w4 = pq.pack_int4_split(w4_q)
  cases = []

  def check(label, x, w, s, packed, true_n=None):
    got = head.head_argmax(x, w, s, packed=packed, true_n=true_n)
    want = head.head_argmax_plain(x, w, s, packed=packed, true_n=true_n)
    sync()
    mism = int(torch.sum(got != want))
    if mism:
      raise AssertionError(f'head {label}: {mism} ids differ from plain')
    cases.append({'case': label, 'M': x.shape[0], 'packed': packed,
                  'true_n': true_n, 'ids_differ': 0})

  xs_by_m = {B: x, PREFILL_BATCH: x[:PREFILL_BATCH], BENCH_B: xb}
  for m, x in xs_by_m.items():
    check(f'int8 M {m}, tie across tiles', x, w8, s8, False)
  x = xs_by_m[B]
  check(f'int8 M {B}, true_n {V - 1000}', x, w8, s8, False, V - 1000)
  check(f'int8 M {B}, tie inside a tile', x, w8_in, s8_in, False)
  check(f'int8 M {B}, f32 x', x.float(), w8, s8, False)
  for m in (B, BENCH_B):
    check(f'packed M {m}, tie across tiles', xs_by_m[m], w4, s4, True)

  def timed(m, packed):
    x = xs_by_m[m]
    w, s, w_int8 = (w4, s4, w4_q) if packed else (w8, s8, w8)
    k_bytes = D // 2 if packed else D
    nbytes = m * D * 2 + V * k_bytes + V * 4 + m * 4
    b_ms, b_by = bound(nbytes, 2 * m * V * D, INT8_OPS_PER_S)
    xq, xq_s = pq.quantize_rows_drq(x.reshape(m, D).float())
    w_t = w_int8.t()

    def library():
      y = torch._int_mm(xq, w_t).float() * xq_s * s
      return torch.argmax(y.to(torch.bfloat16).float(), dim=-1)
    return {'M': m, 'packed': packed,
            'ms': timer(lambda: head.head_argmax(x, w, s, packed=packed)),
            'plain_ms': timer(lambda: head.head_argmax_plain(
                x, w, s, packed=packed), reps=5),
            'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
            'library_composition_ms': timer(library),
            'launch': head.drq_plan(m, V, D, packed)}

  rows = {f'{"packed" if p else "int8"}_M{m}': timed(m, p)
          for p in (False, True) for m in (B, BENCH_B)}
  main = rows[f'int8_M{B}']
  log(f'kernel head_argmax ok: ids identical in {len(cases)} cases (planted '
      'ties included); ' + ', '.join(
          f'{k} {r["ms"]:.4f} ms (library composition '
          f'{r["library_composition_ms"]:.4f}, bound {r["bound_ms"]:.4f})'
          for k, r in rows.items()))
  return {
      'name': 'head_argmax', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/head_argmax.cu',
      'core': 'ai_edge_quantizer_tpu_torch/kernels/csrc/int8_tc_gemm.cuh',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_head.py:169',
      'jax': 'pallas_head.head_argmax_pallas (int8, drq=True)',
      'wrapper': head.head_argmax, 'per_step': 1, 'max_abs_err': 0.0,
      **{k: main[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by',
                              'library_ms', 'library_composition_ms',
                              'launch')},
      'library_composition': 'torch._int_mm + scale + cast + torch.argmax '
                             '(the codes of x made before, untimed)',
      'bench': rows[f'int8_M{BENCH_B}'], 'rows': rows, 'cases': cases,
      'ptxas': ptxas_report(build, 'head_argmax', 'head_tc_kernel')}


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

  cases.extend(block_one_block_cases(torch, port, dev))

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
      'bound_parts': {'bytes': nbytes, 'int8_ops': int8_ops,
                      'attention_ops': f32_ops},
      'B': Bb, 'live_rows': live, 'cases': cases,
      'core': 'ai_edge_quantizer_tpu_torch/kernels/csrc/int8_tc_gemm.cuh, '
              'attention_split_tc.cuh',
      'launch': blk.plan(Bb, D, F, bf, NQ, H, S, 'f32', True),
      'ptxas': ptxas_report(port['_build'], 'fused_block', '')}


def block_one_block_cases(torch, port, dev):
  """The fused block where #2's split core does not take the attention
  (NQ 17 query rows, more than its 16): the one-block body, by the fixed
  rule, at small widths in each compute mode; k_new, v_new, both pools
  and the f32 x_ffn's bits equal to the plain version's, ctx to 5e-5 of
  its largest magnitude in f32 and bf16 (the bf16 mode's operands round
  alike in both) and bit for bit in int8."""
  blk, pq, mlp = port['block'], port['packed_qmatmul'], port['mlp']
  impl = port['ops_impl']
  b, d, f, bf, nq, h, s, pos = 4, 256, 512, 256, 17, 128, 256, 100
  n = (nq + 2) * h
  gen = torch.Generator(device=dev).manual_seed(17)  # the later checks'
  # inputs stay those of the shared generator

  def randint(lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device=dev).to(
        torch.int8)

  def scales(k):
    return torch.rand((k,), generator=gen, device=dev) * 0.01 + 0.005

  x = torch.randn((b, d), generator=gen, device=dev)
  ang = (pos * impl.rope_freqs(10000.0, h // 2, dev)).reshape(
      1, h // 2).expand(b, h // 2)
  lengths = torch.tensor([1, pos + 1, pos + 40, s], dtype=torch.int32,
                         device=dev)
  fixed = [x, 1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev),
           pq.pack_int4_split(randint(-8, 8, 2 * f, d)), scales(2 * f),
           mlp.pack_int4_split_grouped(randint(-8, 8, d, f), bf), scales(d),
           1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev),
           pq.pack_int4_split(randint(-8, 8, n, d)), scales(n),
           torch.cos(ang).contiguous(), torch.sin(ang).contiguous()]
  kc, vc = randint(-127, 128, b, s, h), randint(-127, 128, b, s, h)
  out = []
  for mode in ('f32', 'bf16', 'int8'):
    plan = blk.plan(b, d, f, bf, nq, h, s, mode, False)
    if plan['attention_cluster'] != 0:
      raise AssertionError(f'fused block NQ {nq}: the split core took it')
    runs = []
    for fn in (blk.fused_mlp_qkv_attention,
               blk.fused_mlp_qkv_attention_plain):
      pools = [kc.clone(), vc.clone()]
      runs.append((fn(*fixed, *pools, lengths, pos, 0.06, 0.06, 0.06, 0.06,
                      nq, bf=bf, compute=mode), pools))
    sync()
    (got, gp), (want, wp) = runs
    codes = sum(int(torch.sum(g != w)) for g, w in (
        (got[2], want[2]), (got[3], want[3]), (gp[0], wp[0]),
        (gp[1], wp[1])))
    x_bits = bits_differ(torch, got[1], want[1])
    err = float(torch.max(torch.abs(got[0] - want[0])))
    ctx_max = float(torch.max(torch.abs(want[0])))
    if codes or x_bits or err > (0.0 if mode == 'int8' else 5e-5 * ctx_max):
      raise AssertionError(f'fused block one-block attention {mode}: codes '
                           f'that differ {codes}, x_ffn bits {x_bits}, ctx '
                           f'err {err} (max |ctx| {ctx_max})')
    log(f'kernel fused_mlp_qkv_attention NQ {nq} (one-block attention) '
        f'{mode} ok: ctx err {err:.3g}, launch {plan}')
    out.append({'case': f'one-block attention NQ {nq} {mode}',
                'ctx_max_abs_err': err, 'ctx_max_abs': ctx_max,
                'x_ffn_err': 0.0, 'launch': plan})
  return out


INT4G_GROUP = 16   # bench.py's kv_int4_group
# The int4-group attention's context against its plain version, relative
# to its largest magnitude: a probability whose f32 value differs in the
# last place can round to the neighbouring bf16 value (2^-8 of it) before
# the context sum, in the kernel or in the plain version. Over 128 draws
# of the bench case (int4g_seed_sweep, 64 seeds at pos 32 and 896, H100
# 80GB HBM3) the plain version sat up to 1.99e-3 from its own function in
# f64 and the kernel up to 1.37e-3, and 5 draws at 33 live rows put them
# more than 1e-3 apart (at most 1.99e-3): the bound is their two largest
# distances from the function, rounded up. Such flips touch few rows, so
# at most INT4G_FINE_SHARE of the elements may differ by more than
# INT4G_FINE_RTOL of that magnitude (0.6 % was read); a kernel that leaves
# out one bf16 rounding of q, of the K or V operand or of the
# probabilities moves most elements (70-81 % were read; int4g_kernel holds
# that, see plain_without_rounding).
INT4G_CTX_RTOL = 4e-3
INT4G_FINE_RTOL, INT4G_FINE_SHARE = 1e-5, 0.1


def int4g_ctx_diff(torch, got, want):
  """(largest |got - want| over max |want|, share of the elements that
  differ by more than INT4G_FINE_RTOL of max |want|)."""
  d = torch.abs(got.double() - want.double())
  ymax = max(float(torch.max(torch.abs(want.double()))), 1e-30)
  return (float(torch.max(d)) / ymax,
          float(torch.mean((d > INT4G_FINE_RTOL * ymax).double())))


def int4g_ctx_ok(rel, share, rtol=INT4G_CTX_RTOL):
  return rel <= rtol and share <= INT4G_FINE_SHARE


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
  bench.py's step (pos BENCH_START) and at the server's tick (B rows, the
  tick's lengths) beside the plain version and SDPA over the pools
  dequantized to bf16, each with its launch (split_plan)."""
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

  # Timing at bench.py's step and the server's tick; SDPA over the pools
  # dequantized to bf16.
  sdpa = torch.nn.functional.scaled_dot_product_attention

  def timed(q, kp, vp, sc, lengths, label):
    b = q.shape[0]
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
        float('-inf')).to(bf16).reshape(b, 1, 1, S)
    live = NK * int(torch.sum(lengths))
    nbytes = (q.numel() * 2 + live * (H + 6 * NG) + lengths.numel() * 4
              + q.numel() * 2)
    b_ms, b_by = bound(nbytes, 4 * G * H * live, BF16_OPS_PER_S)
    row = {
        'B': b, 'live_rows': live, 'bytes': nbytes,
        'ms': timer(lambda: kern(*args, **kw)),
        'plain_ms': timer(lambda: plain(*args, **kw)),
        'bound_ms': b_ms, 'bound_by': b_by,
        'library_ms': timer(lambda: sdpa(q, kd, vd, attn_mask=amask)),
        'launch': split_plan(port['_build'], 'attention_int4_group', b * NK,
                             G, S, H, INT4G_GROUP)}
    log(f'kernel decode_attention_int4_group_lengths: {row["ms"]:.4f} ms at '
        f'the {label} (plain {row["plain_ms"]:.4f}, SDPA on bf16 pools '
        f'{row["library_ms"]:.4f}, bound {b_ms:.4f} by {b_by}; '
        f'{nbytes / 1e6:.1f} MB, {live} live rows), launch {row["launch"]}')
    return row

  lengths = torch.full((BENCH_B,), BENCH_START + 1, dtype=i32, device=dev)
  bench = timed(q, kp, vp, sc, lengths, 'bench step')
  tick = timed(qs, kps, vps, scs, lens_s, 'server tick')
  return {
      'name': 'decode_attention_int4_group_lengths', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'attention_int4_group.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:1677',
      'jax': 'pallas_attention.decode_attention_int4_group_lengths',
      'core': SPLIT_CORE,
      'wrapper': kern, 'per_step': 0, 'per_bench_step_int4g': cfg.num_layers,
      'per_tick_int4g': cfg.num_layers,
      'max_abs_err': max(c['max_abs_err'] for c in cases),
      **{k: bench[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by',
                               'library_ms', 'B', 'live_rows', 'bytes',
                               'launch')},
      'library': 'scaled_dot_product_attention over the pools dequantized '
                 'to bf16',
      'tick': tick, 'cases': cases,
      'ptxas': ptxas_report(port['_build'], 'attention_int4_group',
                            'int4_group_attention_split_kernel'),
      'dropped_rounding_refused': dropped,
      'op_card_vs_cpu': {'values_differ': op_diff, 'ctx_max_abs_err': op_err,
                         'ctx_share_beyond_fine': op_share}}

# #10's f32 check over draws of its bench case, each seed a generator of
# its own (the kernel phase's shared generator is not touched).
INT4G_SWEEP_SEEDS = tuple(range(16))
INT4G_SWEEP_POS = (32, BENCH_START)


def int4g_seed_sweep(torch, port, cfg, dev):
  """#10 (the int4-group decode attention) at bench.py's int4g decode
  (BENCH_B rows, every row pos + 1 long, pos in INT4G_SWEEP_POS), q and
  pools drawn anew from each seed of INT4G_SWEEP_SEEDS: the f32 context
  against the plain version by int4g_kernel's rule (int4g_ctx_ok), and
  both against int4g_f64 (the plain version's function in f64, its four
  bf16 roundings kept), which shows how far the plain version's own f32
  order sits from its function. Returns the largest relative errors, the
  largest share beyond INT4G_FINE_RTOL and each draw's figures; raises
  where a draw fails the rule."""
  att = port['attention']
  NK, H, S = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
  G = cfg.num_query_heads // NK
  kern = att.decode_attention_int4_group_lengths
  plain = att.decode_attention_int4_group_lengths_plain
  draws, failed = [], []
  t0 = time.monotonic()
  for seed in INT4G_SWEEP_SEEDS:
    gen = torch.Generator(device=dev).manual_seed(1000 + seed)
    q = torch.randn((BENCH_B, NK, G, H), generator=gen,
                    device=dev).to(torch.bfloat16)
    kp, vp, sc = int4g_pools(torch, att, BENCH_B, NK, S, H, gen, dev)
    for pos in INT4G_SWEEP_POS:
      lengths = torch.full((BENCH_B,), pos + 1, dtype=torch.int32,
                           device=dev)
      args = (q, kp, vp, sc, lengths, INT4G_GROUP)
      got, want = kern(*args), plain(*args)
      exact = int4g_f64(torch, att, *args)
      rel, share = int4g_ctx_diff(torch, got, want)
      draw = {'seed': seed, 'pos': pos, 'rel_err': rel,
              'share_beyond_fine': share,
              'plain_rel_err_f64': int4g_ctx_diff(torch, want, exact)[0],
              'kernel_rel_err_f64': int4g_ctx_diff(torch, got, exact)[0]}
      draws.append(draw)
      if not int4g_ctx_ok(rel, share):
        failed.append(draw)
    del kp, vp, sc
  out = {'draws': len(draws),
         'failed': failed,
         'max_rel_err': max(d['rel_err'] for d in draws),
         'max_share_beyond_fine': max(d['share_beyond_fine'] for d in draws),
         'draws_beyond_1e-3': sum(d['rel_err'] > 1e-3 for d in draws),
         'seconds': time.monotonic() - t0,
         'max_plain_rel_err_f64': max(d['plain_rel_err_f64'] for d in draws),
         'max_kernel_rel_err_f64': max(d['kernel_rel_err_f64']
                                       for d in draws),
         'by_draw': draws}
  log(f'int4g seed sweep: {({k: v for k, v in out.items() if k != "by_draw"})}')
  if failed:
    raise AssertionError(f'int4g attention over seeds: {failed}')
  return out


QUANT_BLOCK = 32   # gemma_mixed48_b32's block size


def ptxas_report(build, lib, part):
  """Registers and spills, as ptxas printed them into _build/<lib>.log,
  of each entry function whose mangled name contains `part`."""
  found, fn, spills = [], None, None
  for line in (build.BUILD_DIR / f'{lib}.log').read_text().splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
      fn, spills = m.group(1), None
      continue
    m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
    if m:
      spills = (int(m.group(1)), int(m.group(2)))
      continue
    m = re.search(r'Used (\d+) registers', line)
    if m and fn and part in fn:
      found.append({'function': fn, 'registers': int(m.group(1)),
                    'spill_stores': spills and spills[0],
                    'spill_loads': spills and spills[1]})
  return found


def bits_differ(torch, a, b):
  """Count of outputs whose bits differ (bf16 or f32)."""
  view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
  return int(torch.sum(a.view(view) != b.view(view)))


def tc_edge_checks(torch, wrapper, plain, make, shapes, label):
  """A tensor-core DRQ matmul against its plain version bit for bit at
  `shapes` ((name, M, N, K); make(M, N, K) gives x, w, s, bias), with bf16
  and f32 x, with and without the bias; then two calls in a row on fresh
  inputs at each shape (the split-K counters and slabs must start clean),
  both held to the plain version. Each row also keeps the largest
  absolute difference of the first four outputs (0 when bit for bit)."""
  rows = []
  for name, m, n, k in shapes:
    x, w, s, bias = make(m, n, k)
    pairs = [(wrapper(xi, w, s, bi), plain(xi, w, s, bi))
             for xi in (x, x.float()) for bi in (None, bias)]
    differ = [bits_differ(torch, got, want) for got, want in pairs]
    err = max(float(torch.max(torch.abs(got.float() - want.float())))
              for got, want in pairs)
    first, second = make(m, n, k), make(m, n, k)
    y1 = wrapper(first[0], first[1], first[2], first[3])
    y2 = wrapper(second[0], second[1], second[2], second[3])
    twice = [bits_differ(torch, y1, plain(*first)),
             bits_differ(torch, y2, plain(*second))]
    sync()
    if any(differ) or any(twice):
      raise AssertionError(f'{label} {name} (M {m}, N {n}, K {k}): '
                           f'{differ} outputs differ from the plain version '
                           '(bf16, bf16 with bias, f32, f32 with bias), '
                           f'{twice} in two calls in a row')
    rows.append({'check': name, 'M': m, 'N': n, 'K': k,
                 'outputs_differ': differ, 'twice_differ': twice,
                 'max_abs_err': err})
  return rows


# The int8 DRQ kernel's edge checks: (name, M, N, K). M 1, 17 and 200 at
# the QKV FC, N 2112 (not a multiple of the 128-column tile), K = 16 * 129
# with N 200, a K split 3 ways (rows shared unevenly in the cluster), and
# decode and prefill.
INT8_EDGE_SHAPES = (('m1', 1, 2560, 2048), ('m17', 17, 2560, 2048),
                    ('m200', 200, 2560, 2048), ('ragged_n', 64, 2112, 2048),
                    ('k16_odd', 37, 200, 2064), ('split_3', 64, 128, 1536),
                    ('decode', B, 2560, 2048),
                    ('prefill', PREFILL_ROWS, 2048, 2048))


# The int4 DRQ kernel's edge checks: (name, M, N, K), N and K the QKV FC's
# (NQ + 2 NK) * H and D where None. M 1, 17 and 200, N 2112 (not a
# multiple of the 128-column tile), K = 2560 split 3 + 3 + 3 + 1 steps, K
# = 1792 split 3 + 3 + 1 (rows 22, 22, 20 a block), at two warpgroups K =
# 3584 split 5 + 5 + 4, K = 2080 (a ragged K step) at M 37 and N 200; then
# the server's shapes (kernel_phase).
INT4_DRQ_EDGE_SHAPES = (('m1', 1, None, None), ('m17', 17, None, None),
                        ('m200', 200, None, None),
                        ('ragged_n', 64, 2112, None),
                        ('split_4_uneven', 64, 128, 2560),
                        ('split_3_uneven', 64, 256, 1792),
                        ('split_3_uneven_m200', 200, 256, 3584),
                        ('ragged_k', 37, 200, 2080))


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
  int_qmatmul.int_weights_tolerance of max |y|, at bf16 x (bf16 out)
  within one bf16 ulp beyond it, and its channelwise branch (no entry
  point reaches it) at N 2048, K 2048. Timed with bf16 x and with f32 x
  beside the plain versions and, where one PyTorch call computes the same
  contraction, that call; each row's launch plan and the kernels' ptxas
  registers and spills logged; each kernel's headline times are the means
  of its decode shapes, as for the other matmuls."""
  iq, pq, build = port['int_qmatmul'], port['packed_qmatmul'], port['_build']
  D, F, V = cfg.embed_dim, cfg.ffn_dim, cfg.vocab_size
  NQ, NK, H = cfg.num_query_heads, cfg.num_kv_heads, cfg.head_dim
  bf16 = torch.bfloat16

  def drq_plan(m, n, k):
    return build.plan('qmatmul_int8_drq', 'aeqt_qmatmul_int8_drq_plan',
                      'qmatmul_int8_drq', m, n, k)

  def randn(*shape):
    return torch.randn(shape, generator=gen, device=dev).to(bf16)

  def randint(lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device=dev).to(
        torch.int8)

  def scales(*shape):
    return torch.rand(shape, generator=gen, device=dev) * 0.01 + 0.005

  def drq_inputs(m, n, k):
    return (randn(m, k), randint(-127, 128, n, k), scales(n),
            torch.randn((n,), generator=gen, device=dev))

  drq_edges = tc_edge_checks(torch, iq.qmatmul_int8_drq,
                             iq.qmatmul_int8_drq_plain, drq_inputs,
                             INT8_EDGE_SHAPES, 'int8 DRQ')
  for row in drq_edges:
    row['launch'] = drq_plan(row['M'], row['N'], row['K'])
  before = (iq.qmatmul_int8_drq.launches, iq.qmatmul_int8_drq.plain_calls)
  try:
    iq.qmatmul_int8_drq(randn(4, 40), randint(-127, 128, 256, 40),
                        scales(256))
  except ValueError as e:
    if (iq.qmatmul_int8_drq.launches,
        iq.qmatmul_int8_drq.plain_calls) != before:
      raise AssertionError('int8 DRQ: a refused K counted a run') from e
    log(f'int8 DRQ kernel refuses K 40: {e}')
  else:
    raise AssertionError('the int8 DRQ kernel took K = 40')
  drq_ptxas = ptxas_report(build, 'qmatmul_int8_drq', 'int8_tc_gemm_kernel')
  log(f'kernel qmatmul_int8_drq edges ok: bit for bit, twice in a row; '
      f'{drq_edges}; ptxas {drq_ptxas}')

  drq_rows = []
  for phase, m in (('decode', B), ('prefill', PREFILL_ROWS)):
    for label, n, k in (('qkv', (NQ + 2 * NK) * H, D), ('out_proj', D, NQ * H)):
      x, w, s = randn(m, k), randint(-127, 128, n, k), scales(n)
      bias = torch.randn((n,), generator=gen, device=dev)
      cases = ((x, None), (x.float(), None), (x.float(), bias))
      differ = [bits_differ(torch, iq.qmatmul_int8_drq(xi, w, s, bi),
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
          'bound_ms': b_ms, 'bound_by': b_by, 'launch': drq_plan(m, n, k)})
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
    x32 = torch.randn((m, k), generator=gen, device=dev)
    s = scales(n, k // bs) if bs else scales(n)
    # bf16 values widened to f32 (every product exact) and f32 values with
    # a full mantissa (a kernel that rounded x would fail these), then bf16
    # x as the server passes it (one bf16 operand, a bf16 result: one bf16
    # ulp beyond the tolerance, as for the packed matmuls' bf16 outputs).
    checks = {}
    for key, xi in (('bf16_x', x.float()), ('f32_x', x32), ('bf16_in', x)):
      got = iq.qmatmul_int_weights(xi, w, s, block_size=bs)
      want = iq.qmatmul_int_weights_plain(xi, w, s, block_size=bs)
      sync()
      err = float(torch.max(torch.abs(got.float() - want.float())))
      ymax = float(torch.max(torch.abs(want.float())))
      tol = iq.int_weights_tolerance(k, bs, ymax)
      ulps = bf16_ulps(torch, got, want, atol=tol) if xi.dtype == bf16 \
          else None
      if (ulps is not None and ulps > 1.0) or (ulps is None
                                               and not err <= tol):
        raise AssertionError(f'weight-only {phase} {label} {key}: err {err} '
                             f'> {tol} (max |y| {ymax}; bf16 ulps beyond '
                             f'it {ulps})')
      checks[key] = {'max_abs_err': err, 'max_abs_y': ymax, 'tolerance': tol,
                     'bf16_ulps_beyond': ulps}
      del got, want, xi
    # Both operands are exact in bf16 (int8 codes, bf16 x), so bf16 tensor
    # cores with f32 sums compute this function: their peak bounds it. An
    # f32 x's three bf16 parts are the kernel's cost, not more work.
    nbytes = m * k * 2 + n * k + s.numel() * 4 + m * n * 2
    b_ms, b_by = bound(nbytes, 2 * m * n * k, BF16_OPS_PER_S)
    row = {'phase': phase, 'shape': label, 'M': m, 'N': n, 'K': k,
           'block_size': bs,
           'max_abs_err': max(c['max_abs_err'] for c in checks.values()),
           'checks': checks,
           'ms': timer(lambda: iq.qmatmul_int_weights(x, w, s,
                                                      block_size=bs)),
           'ms_f32_x': timer(lambda: iq.qmatmul_int_weights(x32, w, s,
                                                            block_size=bs)),
           'plain_ms': timer(lambda: iq.qmatmul_int_weights_plain(
               x, w, s, block_size=bs),
                             reps=25 if m <= B else 3, warmup=1),
           'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
           'launch': iq.int_weights_plan(m, n, k, bs, True),
           'launch_f32_x': iq.int_weights_plan(m, n, k, bs, False)}
    if not bs:
      wf, xf = w.float(), x.float()
      row['library_ms'] = timer(lambda: torch.matmul(xf, wf.T))
      row['library_ms_f32_x'] = timer(lambda: torch.matmul(x32, wf.T))
    wo_rows.append(row)
    del x32
  wo_ptxas = ptxas_report(build, 'qmatmul_int_weights', '_kernel')
  log(f'kernel qmatmul_int_weights ok: {wo_rows}; ptxas {wo_ptxas}')

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
      'max_abs_err': max(r['max_abs_err'] for r in drq_edges),
      **summary(drq_rows, 'decode', timing),
      'bound_by': drq_rows[0]['bound_by'],
      'library': 'torch._int_mm on the codes (contraction only)',
      'prefill': summary(drq_rows, 'prefill', timing), 'by_shape': drq_rows,
      'edge_checks': drq_edges, 'ptxas': drq_ptxas},
      {
      'name': 'qmatmul_int_weights', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'qmatmul_int_weights.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py:753',
      'jax': 'pallas_qmatmul.qmatmul_pallas (blockwise and channelwise)',
      'wrapper': iq.qmatmul_int_weights, 'per_step': 0,
      'per_tick_quantized_b32': 2 * QUANT_LAYERS['gemma_mixed48_b32'] + 1,
      'max_abs_err': max(r['max_abs_err'] for r in blockwise),
      **summary(blockwise, 'decode', ('ms', 'ms_f32_x', 'plain_ms',
                                      'bound_ms')),
      'bound_by': wo_rows[0]['bound_by'], 'library_ms': None,
      'prefill': summary(blockwise, 'prefill', ('ms', 'ms_f32_x', 'plain_ms',
                                                'bound_ms')),
      'library': 'none for the blockwise branch; torch.matmul on f32 '
                 'weights for the channelwise one (by_shape)',
      'by_shape': wo_rows, 'ptxas': wo_ptxas}]


# The K-blocked kernel's checks: (label, M, N, K). The server's down
# projection at decode and prefill rows, then M = 1, 17, an odd M and 200,
# N 200 (not a multiple of the 128-column tile), one ragged K step (K/2 =
# 528 bytes) and two full steps with a ragged third (2080).
KBLOCK_SHAPES = (('decode', B, None, None), ('prefill', PREFILL_ROWS, None,
                                             None),
                 ('m1', 1, 256, None), ('m17', 17, None, None),
                 ('odd_m', 37, 256, None), ('m200', 200, None, None),
                 ('ragged_n', B, 200, None), ('small_k', 37, 256, 1056),
                 ('ragged_k', 64, 256, 4160))


def kblock_kernel(torch, port, cfg, dev, timer, gen):
  """The K-blocked int4 DRQ kernel against its plain version on the card,
  at KBLOCK_SHAPES (N = D and K = F, gemma_mixed48_hr's down projection,
  where a shape leaves them None); bf16 and f32 x, with and without a
  bias, every output bit for bit (the codes divide as the plain version
  does, the int32 sums are exact, the epilogue rounds in the same order),
  and two calls in a row on fresh inputs. Timed at decode and prefill with
  bf16 x and no bias (the server's down FC) beside the plain version and
  torch._int_mm on the codes (the contraction only; it needs M > 16). A K
  the kernel does not take must be refused."""
  pq, build = port['packed_qmatmul'], port['_build']

  def inputs(m, n, k):
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = pq.pack_int4_split(torch.randint(-8, 8, (n, k), generator=gen,
                                         device=dev).to(torch.int8))
    s = torch.rand((n,), generator=gen, device=dev) * 0.01 + 0.005
    return x, w, s, torch.randn((n,), generator=gen, device=dev)

  shapes = [(phase, m, n or cfg.embed_dim, k or cfg.ffn_dim)
            for phase, m, n, k in KBLOCK_SHAPES]
  rows = tc_edge_checks(torch, pq.qmatmul_int4_packed_drq_kblock,
                        pq.qmatmul_int4_packed_drq_kblock_plain, inputs,
                        shapes, 'K-blocked int4 DRQ')
  for row in rows:
    m, n, k = row['M'], row['N'], row['K']
    row['launch'] = build.plan('qmatmul_int4_drq_kblock',
                               'aeqt_qmatmul_int4_drq_kblock_plan',
                               'qmatmul_int4_packed_drq_kblock', m, n, k)
    if row['check'] not in ('decode', 'prefill'):
      continue
    x, w, s, _ = inputs(m, n, k)
    xq = pq.quantize_rows_drq_div(x.float())[0]
    w_t = pq.unpack_int4_split(w).t()
    nbytes = m * k * 2 + n * k // 2 + n * 4 + m * n * 2
    b_ms, b_by = bound(nbytes, 2 * m * n * k, INT8_OPS_PER_S)
    row.update(
        ms=timer(lambda: pq.qmatmul_int4_packed_drq_kblock(x, w, s)),
        plain_ms=timer(lambda: pq.qmatmul_int4_packed_drq_kblock_plain(
            x, w, s), reps=25 if row['check'] == 'decode' else 5),
        library_ms=timer(lambda: torch._int_mm(xq, w_t)),
        bound_ms=b_ms, bound_by=b_by)
  ptxas = ptxas_report(build, 'qmatmul_int4_drq_kblock',
                       'int8_tc_gemm_kernel')
  log(f'kernel qmatmul_int4_packed_drq_kblock ok: bit for bit, twice in a '
      f'row; {rows}; ptxas {ptxas}')

  x = torch.randn((4, 48), device=dev)
  w = torch.zeros((256, 24), dtype=torch.uint8, device=dev)
  s = torch.ones((256,), device=dev)
  wrapper = pq.qmatmul_int4_packed_drq_kblock
  before = (wrapper.launches, wrapper.plain_calls)
  try:
    wrapper(x, w, s)
  except ValueError as e:
    if (wrapper.launches, wrapper.plain_calls) != before:
      raise AssertionError('K-blocked: a refused K counted a run') from e
    log(f'K-blocked kernel refuses K 48: {e}')
  else:
    raise AssertionError('the K-blocked kernel took K = 48')

  def at(phase):
    r = next(r for r in rows if r['check'] == phase)
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
      'max_abs_err': max(r['max_abs_err'] for r in rows),
      **at('decode'), 'bound_by': rows[0]['bound_by'],
      'library': 'torch._int_mm on the codes (contraction only)',
      'prefill': at('prefill'), 'by_shape': rows, 'ptxas': ptxas}


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
    torch.matmul on the weight dequantized to bf16; each shape's launch
    (int4_bf16_tc_gemm.cuh's plan) and ptxas' registers logged;
  * the additive-mask decode attention (B 64 and 256, S 1024, zero points
    3 and -2; the graph's [B, 1, 1, S] prefix mask, the same broadcast to
    [B, 1, G, S], and a non-prefix [B, 1, G, S] mask with one row hidden
    everywhere): within 1e-5 of max(max |y|, 1) (f32 sums in another
    order); timed beside scaled_dot_product_attention over the pools
    dequantized to bf16 with the mask;
  * the MLP's weight-only branch (bf 512 and 2048, gelu; decode, prefill
    and ragged rows): bf16 x within one bf16 ulp beyond 1e-3 of max |y| (a
    sum in another order can round a bf16 hidden value the other way), f32
    x (bf 512) within 1e-5 of max |y|; timed beside the library
    composition of the same function, with each shape's launch plan;
  * the head's weight-only branch (packed int4 and int8 weights, N 256128,
    M B and BENCH_B): with a planted winner (two equal rows of the largest
    code in different vocab tiles, scaled to win, and positive x) every id
    is the first of the two; without
    it, an id may differ from the plain version's only where the plain
    top-2 logit margin is within the kernel's logit error
    (int_weights_tolerance of the largest |logit| plus one bf16 ulp of the
    winner, the cast_dt rounding); timed beside the library composition
    (torch.matmul against the weights dequantized to bf16, the scale, the
    cast and torch.argmax), with each shape's launch plan and the
    kernel's ptxas registers and spills."""
  pq, att, mlp, head = (port['packed_qmatmul'], port['attention'],
                        port['mlp'], port['head'])
  iq, build = port['int_qmatmul'], port['_build']
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
             'checks': checks,
             'launch': build.plan('qmatmul_int4_weight_only',
                                  'aeqt_qmatmul_int4_weight_only_plan',
                                  'qmatmul_int4_packed', m, n, k,
                                  fields=pq.INT4_BF16_PLAN_FIELDS)}
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
  wo_ptxas = ptxas_report(build, 'qmatmul_int4_weight_only',
                          'int4_bf16_tc_kernel')
  log(f'kernel qmatmul_int4_packed ok: {wo_rows}; ptxas {wo_ptxas}')
  for r in wo_rows:
    if 'ms' in r:
      log(f'  #12 {r["phase"]} {r["shape"]} M {r["M"]} N {r["N"]} K '
          f'{r["K"]}: {r["ms"]:.5f} ms, library {r["library_ms"]:.5f}, '
          f'bound {r["bound_ms"]:.5f} ({r["bound_by"]}), launch '
          f'{r["launch"]}')
  results.append({
      'name': 'qmatmul_int4_packed', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'int4_bf16_tc_gemm.cuh',
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
      'by_shape': wo_rows, 'ptxas': wo_ptxas})

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
  att_launch = {str(b): split_plan(build, 'attention_masked', b * NK, G, S, H,
                                   att.compute_code('f32'))
                for b in (B, BENCH_B)}
  att_ptxas = ptxas_report(build, 'attention_masked', 'masked_attention_kernel')
  log(f'kernel decode_attention_int8_masked ok: {att_rows}; launch '
      f'{att_launch}; ptxas {att_ptxas}')

  def att_at(b, mname):
    r = next(r for r in att_rows if r['B'] == b and r['mask'] == mname)
    return {key: r[key] for key in timing}

  results.append({
      'name': 'decode_attention_int8_masked', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/attention_masked.cu',
      'core': SPLIT_CORE, 'launch': att_launch, 'ptxas': att_ptxas,
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

  # 3. The MLP's weight-only branch (#3, drq=False, on the bf16
  # tensor-core core for bf16 x), bf 512 (the JAX package's default) and
  # 2048: decode, prefill and a ragged M 7 with bf16 x (at most 1 bf16 ulp
  # beyond 1e-3 of max |y|), f32 x at bf 512 (the SIMT tiles, 1e-5 of max
  # |y|). Timed beside the plain version and, as a yardstick only, the
  # library composition: torch.matmul against the weights dequantized to
  # bf16, the activation, torch.matmul (library_ms stays null).
  wgu_q, wd_q = randint(-8, 8, 2 * F, D), randint(-8, 8, D, F)
  wgu, sgu, sd = pq.pack_int4_split(wgu_q), scales(2 * F), scales(D)
  wgu_deq = (wgu_q.float() * sgu[:, None]).to(bf16)
  wd_deq = (wd_q.float() * sd[:, None]).to(bf16)

  def library(x2):
    gu = torch.matmul(x2, wgu_deq.T)
    h = (mlp.gelu_tanh(gu[:, :F].float()) * gu[:, F:].float()).to(bf16)
    return torch.matmul(h, wd_deq.T)

  mlp_rows = {}
  for bf in (512, 2048):
    wd = mlp.pack_int4_split_grouped(wd_q, bf)
    for phase, m in (('decode', B), ('prefill', PREFILL_ROWS), ('ragged', 7)):
      x = randn(m, 1, D)
      margs = (x, wgu, sgu, wd, sd)
      checks = {}
      inputs = [('bf16_x', x)]
      if bf == 512 and phase != 'ragged':
        inputs.append(('f32_x', torch.randn((m, 1, D), generator=gen,
                                            device=dev)))
      for key, xi in inputs:
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
          raise AssertionError(f'mlp bf16 branch bf {bf} {phase} {key}: err '
                               f'{err}, max |y| {ymax}, bf16 ulps beyond '
                               f'1e-3 of it {ulps}')
        checks[key] = {'max_abs_err': err, 'max_abs_y': ymax,
                       'bf16_ulps_beyond': ulps}
        del got, want
      row = {'M': m, 'bf': bf,
             'max_abs_err': max(c['max_abs_err'] for c in checks.values()),
             'checks': checks, 'launch': mlp.bf16_plan(m, D, F, bf)}
      if phase != 'ragged':
        nbytes = (m * D * 2 + 2 * F * D // 2 + 2 * F * 4 + D * F // 2
                  + D * 4 + m * D * 2)
        b_ms, b_by = bound(nbytes, 3 * 2 * m * F * D, BF16_OPS_PER_S)
        x2 = x.reshape(m, D)
        row.update(
            ms=timer(lambda: mlp.mlp_int4_packed_bf16(*margs, bf=bf)),
            plain_ms=timer(
                lambda: mlp.mlp_int4_packed_plain(*margs, drq=False, bf=bf),
                reps=25 if phase == 'decode' else 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            library_composition_ms=timer(lambda: library(x2)))
      mlp_rows[f'bf{bf}_{phase}'] = row
      log(f'kernel mlp_int4_packed_bf16 bf {bf} {phase} ok: {row}')
  del wgu_deq, wd_deq
  dec = mlp_rows['bf512_decode']
  results.append({
      'name': 'mlp_int4_packed_bf16', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/mlp_int4_bf16.cu',
      'core': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
              'int4_bf16_tc_gemm.cuh',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_mlp.py:268',
      'jax': 'pallas_mlp.mlp_pallas_int4_packed (drq=False)',
      'wrapper': mlp.mlp_int4_packed_bf16, 'per_step': 0,
      'per_tick_default_mode': L, 'max_abs_err': dec['max_abs_err'],
      **{key: dec[key] for key in timing}, 'bound_by': dec['bound_by'],
      'library_composition_ms': dec['library_composition_ms'],
      'library_composition': 'torch.matmul against bf16-dequantized '
                             'weights, gelu, torch.matmul',
      'launch': dec['launch'], 'prefill': mlp_rows['bf512_prefill'],
      'rows': mlp_rows,
      'ptxas': ptxas_report(port['_build'], 'mlp_int4_bf16',
                            'int4_bf16_tc_kernel')})

  # 4. The head's weight-only branch (#4, drq=False), N = V.
  head_rows = []
  for packed in (True, False):
    w_q = randint(-8, 8, V, D) if packed else randint(-127, 128, V, D)
    w = pq.pack_int4_split(w_q) if packed else w_q
    wdq = w_q.to(bf16)  # the library composition's weights
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
          wdq[100] = wdq[V - 100] = 7 if packed else 127
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

          def library(x=x, s=s, m=m):
            y = (torch.matmul(x.reshape(m, D), wdq.T) * s).to(bf16)
            y[:, V - 64:] = -3.4e38
            return torch.argmax(y, dim=-1)

          row.update(
              ms=timer(lambda: head.head_argmax_bf16(x, w, s, **hkw)),
              plain_ms=timer(lambda: head.head_argmax_plain(
                  x, w, s, drq=False, **hkw), reps=5, warmup=1),
              bound_ms=b_ms, bound_by=b_by, library_ms=None,
              library_composition_ms=timer(library),
              plan=head.wo_plan(m, V, D, packed))
        head_rows.append(row)
        del logits, top2
    del w, wdq
    torch.cuda.empty_cache()
  log(f'kernel head_argmax_bf16 ok: {head_rows}')

  def head_at(packed, m):
    r = next(r for r in head_rows if r['packed'] == packed and r['M'] == m
             and r['planted'])
    return {key: r[key] for key in timing + ('library_composition_ms',)}

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
      'library_composition': 'torch.matmul of x against the weights '
                             'dequantized to bf16, * s, the cast to bf16, '
                             'torch.argmax',
      'int8': head_at(False, B), 'bench': head_at(True, BENCH_B),
      'int8_bench': head_at(False, BENCH_B), 'by_shape': head_rows,
      'ptxas': ptxas_report(port['_build'], 'head_argmax', 'head_wo_kernel')})
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
  weight dequantized to bf16 (scales per block applied; a time only: w * s
  rounded to bf16 is another function), each shape's times, launch
  (int4_bf16_tc_gemm.cuh's plan) and bound logged; the headline times are
  the means of the decode QKV and out-projection shapes, as for #12."""
  pq, iq, build = port['packed_qmatmul'], port['int_qmatmul'], port['_build']
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
        'launch': build.plan('qmatmul_int4_blockwise',
                             'aeqt_qmatmul_int4_blockwise_plan',
                             'qmatmul_int4_packed_blockwise', m, n, k, bs,
                             fields=pq.INT4_BF16_PLAN_FIELDS),
        'ms': timer(lambda: pq.qmatmul_int4_packed_blockwise(x, w, s)),
        'plain_ms': timer(
            lambda: pq.qmatmul_int4_packed_blockwise_plain(x, w, s),
            reps=25 if m <= B and not big else 3, warmup=1),
        'library_ms': timer(lambda: torch.matmul(x, wdq.T)),
        'bound_ms': b_ms, 'bound_by': b_by})
    del w, s, wdq, x, x32
    torch.cuda.empty_cache()
  ptxas = ptxas_report(build, 'qmatmul_int4_blockwise', 'int4_bf16_tc_kernel')
  log(f'kernel qmatmul_int4_packed_blockwise ok: {rows}; ptxas {ptxas}')
  for r in rows:
    log(f'  #13 {r["phase"]} {r["shape"]} M {r["M"]} N {r["N"]} K {r["K"]} '
        f'bs {r["block_size"]}: {r["ms"]:.5f} ms, library '
        f'{r["library_ms"]:.5f}, bound {r["bound_ms"]:.5f} '
        f'({r["bound_by"]}), launch {r["launch"]}')
  timing = ('ms', 'plain_ms', 'bound_ms', 'library_ms')

  def mean(phase):
    sel = [r for r in rows if r['phase'] == phase
           and r['shape'] in ('qkv', 'out_proj')]
    return {key: sum(r[key] for r in sel) / len(sel) for key in timing}

  return {
      'name': 'qmatmul_int4_packed_blockwise', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'int4_bf16_tc_gemm.cuh',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py:461',
      'jax': 'pallas_qmatmul.qmatmul_pallas_int4_packed_blockwise',
      'wrapper': pq.qmatmul_int4_packed_blockwise, 'per_step': 0,
      'per_tick_blockwise': 4 * cfg.num_layers + 1,
      'max_abs_err': max(r['max_abs_err'] for r in rows),
      **mean('decode'), 'bound_by': rows[0]['bound_by'],
      'library': 'torch.matmul on the weight dequantized to bf16',
      'prefill': mean('prefill'), 'by_shape': rows, 'ptxas': ptxas}


def cache_row_kernel(torch, port, cfg, dev, timer, gen):
  """The in-place row write (#11) against its plain version on the card at
  bench.py's decode shape (a [256, 1, 1024, 256] int8 pool, one row): the
  pool bit for bit, written in its own storage, at rows 0, 31, 32, 896 and
  1023 and at starts that lax clips (5000 and -3 on the row axis, 7 on a
  full-extent axis). Timed at row 896 beside one slice assignment and
  beside its launch floor (cache.launch_floor: an empty kernel launched
  with the same grid, block and programmatic dependent launch); its
  launch plan logged."""
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
  launch = cache.plan(BENCH_B * NK, H)
  log(f'kernel dus_row_inplace ok: bit for bit, in place, starts {cases}; '
      f'launch {launch}')
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
      'library': 'one slice assignment pool[:, :, p:p+1] = update (host p)',
      'launch_floor_ms': timer(lambda: cache.launch_floor(work)),
      'plan': launch}


def attention_lengths_mask(torch, lengths, s, dtype):
  """The additive [B, 1, 1, S] mask of prefix lengths (-inf past them) for
  scaled_dot_product_attention; a length of 0 hides every row."""
  return torch.where(
      torch.arange(s, device=lengths.device)[None, :] < lengths[:, None],
      0.0, float('-inf')).to(dtype).reshape(-1, 1, 1, s)


def writeback_kernel(torch, att, build, cfg, dev, timer, gen):
  """The splice attention (#8) against its plain version on the card at
  bench.py's decode shape (B 256, one KV head, G 8, H 256, S 1024), pos
  896 and 0, 31, 32, 127, 128, S - 1, and at the server's tick batch (B 64)
  at pos 896; lengths pos + 1 but for a shorter row and a zero-length one:
  f32 context within 1e-5 of max(max |y|, 1) (f32 sums in another order
  over up to 1024 rows), bf16 (the executor's output) within one bf16 ulp
  beyond that, both pools bit for bit (each side on its own copies) and
  written in place. Timed at pos 896 (lengths 897) at both batches beside
  SDPA over the pools dequantized to bf16 with the lengths mask, each with
  its launch (split_plan)."""
  NK, H, S = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
  G = cfg.num_query_heads // NK
  bf16 = torch.bfloat16
  k_scale, v_scale, zp_k, zp_v = 0.06, 0.06, 3.0, -2.0
  sdpa = torch.nn.functional.scaled_dot_product_attention

  def at_batch(b, positions):
    q = torch.randn((b, NK, G, H), generator=gen, device=dev).to(bf16)
    kc, vc = (torch.randint(-127, 128, (b, NK, S, H), generator=gen,
                            device=dev).to(torch.int8) for _ in range(2))
    kn, vn = (torch.randint(-127, 128, (b, NK, 1, H), generator=gen,
                            device=dev).to(torch.int8) for _ in range(2))
    checks = []
    for pos in positions:
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
          raise AssertionError(f'splice attention B {b} pos {pos}: pools '
                               'differ from the plain version or not in '
                               'place')
        if out_dtype == torch.float32:
          errs['f32'] = float(torch.max(torch.abs(got - want)))
          errs['max_abs_y'] = float(torch.max(torch.abs(want)))
          tol = 1e-5 * max(errs['max_abs_y'], 1.0)
        else:
          errs['bf16_ulps'] = bf16_ulps(torch, got, want, atol=tol)
      if errs['f32'] > tol or errs['bf16_ulps'] > 1.0:
        raise AssertionError(f'splice attention B {b} pos {pos}: {errs}')
      checks.append({'pos': pos, **errs})
    lengths = torch.full((b,), BENCH_START + 1, dtype=torch.int32,
                         device=dev)
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
    row = {
        'B': b, 'live_rows': live, 'max_abs_err': max(c['f32'] for c in checks),
        'checks': checks,
        'ms': timer(lambda: att.decode_attention_int8_lengths_writeback(
            *args, **kw)),
        'plain_ms': timer(
            lambda: att.decode_attention_int8_lengths_writeback_plain(
                *args, **kw)),
        'bound_ms': b_ms, 'bound_by': b_by,
        'library_ms': timer(lambda: sdpa(q, kd, vd, attn_mask=amask)),
        'launch': split_plan(build, 'attention_writeback', b * NK, G, S, H,
                             0)}
    log(f'kernel decode_attention_int8_lengths_writeback B {b} ok: {checks}; '
        f'{row["ms"]:.5f} ms (plain {row["plain_ms"]:.4f}, SDPA '
        f'{row["library_ms"]:.4f}, bound {b_ms:.4f}), launch {row["launch"]}')
    return row

  bench = at_batch(BENCH_B, (BENCH_START, 0, 31, 32, 127, 128, S - 1))
  tick = at_batch(B, (BENCH_START,))
  return {
      'name': 'decode_attention_int8_lengths_writeback', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'attention_writeback.cu',
      'core': SPLIT_CORE,
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:850',
      'jax': 'pallas_attention.decode_attention_int8_lengths_writeback '
             '(f32 compute)',
      'wrapper': att.decode_attention_int8_lengths_writeback, 'per_step': 0,
      'per_step_bench_splice': cfg.num_layers,
      **bench,
      'library': 'scaled_dot_product_attention over the pools dequantized '
                 'to bf16 with the lengths mask (no row write)',
      'b64': tick,
      'ptxas': ptxas_report(build, 'attention_writeback',
                            'splice_attention_split_kernel')}


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


def dynlen_kernel(torch, att, build, cfg, dev, timer, gen):
  """The live-prefix attention (#18) against its plain version on the card
  at the server's tick shapes (B 64 and 256, S 1024, G 8, H 256, chunk 256,
  row blocks of 8): lengths spanning 1..S with zero-length rows (idle
  slots), one in a row block beside a full row; at B 64 also every length
  S (the whole cache) and every length below 128 (one zero: its block's
  mean over one chunk); f32 outputs within 1e-5 of max(max |y|, 1) (f32
  sums in another order). Timed beside SDPA over the pools dequantized to
  bf16 with the lengths mask (a zero-length row there is all -inf: SDPA
  gives NaN where the kernel gives the TPU's mean); each shape's launch
  (attention_split_tc.cuh's plan: splits, cluster, rows a CTA) and ptxas'
  registers logged."""
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
        'bound_ms': b_ms, 'bound_by': b_by,
        'launch': split_plan(build, 'attention_dynlen', b * NK, G, S, H)})
    if b == B:  # the whole cache, and every length below 128
      short = torch.randint(1, 128, (b,), generator=gen, device=dev).to(
          torch.int32)
      short[3] = 0
      for label, lens in (('every length S', torch.full_like(lengths, S)),
                          ('every length below 128', short)):
        a2 = (q, kc, vc, k_scale, v_scale, lens)
        got = att.decode_attention_int8_dynlen(*a2, **kw)
        want = att.decode_attention_int8_dynlen_plain(*a2, **kw)
        sync()
        err = float(torch.max(torch.abs(got - want)))
        ymax = float(torch.max(torch.abs(want)))
        if not err <= 1e-5 * max(ymax, 1.0):
          raise AssertionError(f'dynlen attention B {b}, {label}: err {err}, '
                               f'max |y| {ymax}')
        cache_bytes, live = dynlen_bytes(torch, att, lens, NK, S, H)
        nbytes = (q.numel() * 2 + cache_bytes + lens.numel() * 4
                  + q.numel() * 4)
        b_ms, b_by = bound(nbytes, 4 * G * H * live, F32_OPS_PER_S)
        rows.append({
            'phase': label, 'B': b, 'max_abs_err': err, 'max_abs_y': ymax,
            'live_rows': live, 'cache_bytes': cache_bytes,
            'ms': timer(lambda: att.decode_attention_int8_dynlen(*a2, **kw)),
            'bound_ms': b_ms, 'bound_by': b_by})
    del kc, vc, kd, vd
  ptxas = ptxas_report(build, 'attention_dynlen', 'dynlen_attention_kernel')
  log(f'kernel decode_attention_int8_dynlen ok: {rows}; ptxas {ptxas}')
  timing = ('ms', 'plain_ms', 'bound_ms', 'library_ms')
  decode, bench = (next(r for r in rows if r['phase'] == ph)
                   for ph in ('decode', 'bench'))
  return {
      'name': 'decode_attention_int8_dynlen', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/attention_dynlen.cu',
      'core': SPLIT_CORE, 'ptxas': ptxas,
      'launch': {str(r['B']): r['launch'] for r in rows if 'launch' in r},
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:1018',
      'jax': 'pallas_attention.decode_attention_int8_dynlen',
      'wrapper': att.decode_attention_int8_dynlen, 'per_step': 0,
      'per_tick_blockwise': cfg.num_layers,
      'max_abs_err': max(r['max_abs_err'] for r in rows),
      **{key: decode[key] for key in timing}, 'bound_by': decode['bound_by'],
      'library': 'scaled_dot_product_attention over the pools dequantized to '
                 'bf16 with the lengths mask',
      'bench': {key: bench[key] for key in timing}, 'by_shape': rows}


def cache_mode_kernels(torch, port, cfg, dev, timer, gen):
  """The four kernels of the blockwise server and the opt-in cache modes."""
  att = port['attention']
  return [blockwise_kernel(torch, port, cfg, dev, timer, gen),
          writeback_kernel(torch, att, port['_build'], cfg, dev, timer,
                           gen),
          cache_row_kernel(torch, port, cfg, dev, timer, gen),
          dynlen_kernel(torch, att, port['_build'], cfg, dev, timer, gen)]


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
  Timed at BENCH_B and B beside the unfused route it replaces (the
  RMS_NORM op's torch arithmetic, then the weight-only matmul #12) and
  beside #12 alone on rows normalized beforehand; each row logs both
  launches' plans (bf16 and f32 x) and the ptxas report."""
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
      xn = rmsnorm_unfused(torch, ops_impl, x, gamma)
      rows.append({
          'phase': phase, 'shape': label, 'M': m, 'N': n, 'K': D,
          'max_abs_err': max(c['max_abs_err'] for c in checks),
          'checks': checks,
          'ms': timer(lambda: pq.qmatmul_int4_packed_rmsnorm(x, gamma, w, s)),
          'plain_ms': timer(lambda: pq.qmatmul_int4_packed_rmsnorm_plain(
              x, gamma, w, s), reps=5),
          'composition_ms': timer(lambda: pq.qmatmul_int4_packed(
              rmsnorm_unfused(torch, ops_impl, x, gamma), w, s)),
          'matmul_alone_ms': timer(lambda: pq.qmatmul_int4_packed(xn, w, s)),
          'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
          'plan': pq.rmsnorm_plan(m, n, D, True),
          'plan_f32': pq.rmsnorm_plan(m, n, D, False)})
  log(f'kernel qmatmul_int4_packed_rmsnorm ok: '
      f'{[{k: v for k, v in r.items() if k != "checks"} for r in rows]}')
  bench = [r for r in rows if r['phase'] == 'bench']
  timing = ('ms', 'plain_ms', 'composition_ms', 'matmul_alone_ms',
            'bound_ms')
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
      'matmul_alone': 'qmatmul_int4_packed (#12) on rows normalized '
                      'beforehand',
      'ptxas': ptxas_report(port['_build'], 'qmatmul_int4_rmsnorm', ''),
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
  matmul (#1) and the RoPE of q and k in torch; beside #1 alone on rows
  normalized beforehand (the DRQ chain's second launch does its work and
  the RoPE); and, weight-only, beside #14's QKV chain (the norm and #12's
  core, qmatmul_int4_packed_rmsnorm at the QKV shape). Each row logs the
  launch plan (bf16 x, DRQ and weight-only) and ptxas' registers and
  spills. One more case, at M B, takes a head size the pair tiles do not
  (h 64, 8 query and 2 KV heads: the core's column tile, then the RoPE
  launch), both dtypes and branches by the same rules."""
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
    wo_ms, wo_by = bound(nbytes, 2 * m * N * D, BF16_OPS_PER_S)
    args = (x, gamma, w, s, cos, sin)
    xn = rmsnorm_unfused(torch, ops_impl, x, gamma)
    rows.append({
        'phase': phase, 'M': m, 'N': N, 'K': D,
        'max_abs_err': max(c['max_abs_err'] for c in checks),
        'checks': checks,
        'ms': timer(lambda: qkv.qkv_rope(*args, **kw)),
        'plain_ms': timer(lambda: qkv.qkv_rope_plain(*args, **kw), reps=5),
        'composition_ms': timer(composition),
        'matmul_alone_ms': timer(lambda: pq.qmatmul_int4_packed_drq(
            xn, w, s)),
        'weight_only_ms': timer(lambda: qkv.qkv_rope(*args, drq=False,
                                                     **kw)),
        'norm_fused_chain_ms': timer(lambda: pq.qmatmul_int4_packed_rmsnorm(
            x, gamma, w, s)),
        'bound_ms': b_ms, 'bound_by': b_by,
        'weight_only_bound_ms': wo_ms, 'weight_only_bound_by': wo_by,
        'library_ms': None,
        'plan': qkv.plan(m, D, NQ, NK, H, True, True),
        'plan_weight_only': qkv.plan(m, D, NQ, NK, H, False, True)})
  # A head size the pair tiles do not take: the column route.
  nq2, nk2, h2 = 8, 2, 64
  n2 = (nq2 + 2 * nk2) * h2
  w2 = pq.pack_int4_split(torch.randint(-8, 8, (n2, D), generator=gen,
                                        device=dev).to(torch.int8))
  s2 = torch.rand((n2,), generator=gen, device=dev) * 0.01 + 0.005
  pos = torch.randint(0, S, (B, 1), generator=gen, device=dev)
  cos2, sin2 = qkv.rope_cos_sin(pos, h2, 10000.0)
  x2 = torch.randn((B, D), generator=gen, device=dev) * 3
  column = {'M': B, 'nq': nq2, 'nk': nk2, 'h': h2, 'checks': []}
  for xi in (x2, x2.to(bf16)):
    for drq in (True, False):
      kw2 = dict(nq=nq2, nk=nk2, h=h2, drq=drq)
      got = qkv.qkv_rope(xi, gamma, w2, s2, cos2, sin2, **kw2)
      want = qkv.qkv_rope_plain(xi, gamma, w2, s2, cos2, sin2, **kw2)
      sync()
      for part, a, b in zip('qkv', got, want):
        err = float(torch.max(torch.abs(a.float() - b.float())))
        ymax = float(torch.max(torch.abs(b.float())))
        tol = 0.0 if drq else iq.int_weights_tolerance(D, 0, ymax)
        atol = tol
        if part != 'v' and xi.dtype == bf16:  # as above
          heads = b.float().reshape(b.shape[0], -1, h2)
          hmax = torch.amax(torch.abs(heads), dim=-1, keepdim=True)
          ulp = torch.exp2(torch.floor(torch.log2(
              torch.clamp_min(hmax, 2.0**-126))) - 7)
          atol = (2 * tol + 4 * ulp).expand_as(heads).reshape(b.shape)
        ulps = bf16_ulps(torch, a, b, atol=atol) \
            if xi.dtype == bf16 and not drq else None
        ok = (err == 0.0) if drq else (
            ulps <= 1.0 if ulps is not None else err <= tol)
        if not ok:
          raise AssertionError(
              f'qkv_rope h {h2} {part} ({xi.dtype}, drq {drq}): err {err}, '
              f'tolerance {tol}, bf16 ulps beyond it {ulps}')
        column['checks'].append({'x': str(xi.dtype).split('.')[-1],
                                 'drq': drq, 'out': part, 'max_abs_err': err,
                                 'bf16_ulps_beyond': ulps})
      column.setdefault('plans', []).append(
          qkv.plan(B, D, nq2, nk2, h2, drq, xi.dtype == bf16))
  log(f'kernel qkv_rope ok: '
      f'{[{k: v for k, v in r.items() if k != "checks"} for r in rows]}, '
      f'column route {column["plans"]}')
  timing = ('ms', 'plain_ms', 'composition_ms', 'matmul_alone_ms',
            'weight_only_ms', 'norm_fused_chain_ms', 'bound_ms',
            'weight_only_bound_ms')
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
      'matmul_alone': 'qmatmul_int4_packed_drq (#1) on rows normalized '
                      'beforehand',
      'norm_fused_chain': "qmatmul_int4_packed_rmsnorm (#14's QKV chain: "
                          "the norm and #12's core)",
      'decode': {key: rows[1][key] for key in timing}, 'by_shape': rows,
      'column_route': column,
      'ptxas': ptxas_report(port['_build'], 'qkv_rope', '')}


OPROJ_SCALES = (0.06, 0.06, 3.0, -2.0)   # k_scale, v_scale, zp_k, zp_v


def oproj_context(torch, port, q, kc, vc, lengths, xi, wo, so, drq, compute):
  """The context [B, G*H] that the epilogue's (#19) first launch forms (#7's
  launch, attention_lengths.cuh: the split core, or the one-block body
  where the core refuses the shape): its C entry point called as its
  wrapper calls it, the ctx scratch kept."""
  build = port['_build']
  b, _, g, h = q.shape
  s, d = kc.shape[2], wo.shape[0]
  k_scale, v_scale, zp_k, zp_v = OPROJ_SCALES
  cast = xi.dtype
  q2 = q.to(cast).to(torch.float32).reshape(b, g, h).contiguous()
  lens = lengths.to(torch.int32).reshape(-1).contiguous()
  x2 = xi.reshape(b, d).to(cast).contiguous()
  so32 = so.to(torch.float32).reshape(-1).contiguous()
  ctx, out = (torch.empty((b, n), dtype=cast, device=q.device)
              for n in (g * h, d))
  xq = torch.empty((b, g * h), dtype=torch.int8, device=q.device)
  xs = torch.empty((b,), dtype=torch.float32, device=q.device)
  fn = build.entry('attention_oproj', 'aeqt_attention_oproj',
                   [build.P] * 11 + [build.I] * 8 + [build.F] * 4 + [build.P])
  build.check(fn(q2.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                 lens.data_ptr(), x2.data_ptr(), wo.data_ptr(),
                 so32.data_ptr(), ctx.data_ptr(), xq.data_ptr(),
                 xs.data_ptr(), out.data_ptr(), int(cast == torch.bfloat16),
                 int(drq),
                 port['attention'].compute_code(compute), b, g, s, h, d,
                 port['attention'].score_scale(k_scale, h), float(v_scale),
                 float(zp_k), float(zp_v), build.stream_ptr(q.device)),
              'decode_attention_oproj')
  return ctx


def oproj_case(torch, port, q, kc, vc, lengths, xi, wo, so, drq, compute,
               label):
  """One epilogue call (#19) against its plain version: given the context
  of its first launch in `compute` (oproj_context: #7's launch), the
  projection and the residual are the plain version's bit for
  bit (DRQ) or within int_qmatmul.int_weights_tolerance over K = G*H and,
  at bf16, one bf16 ulp of the projection (rounded before the add) and
  one of y beyond it (weight-only). End to end against the plain version
  the largest error is reported and held to 1e-2 of max |y| (its
  attention sums in another f32 order, so a DRQ code of the context can
  flip; a wrong head, pairing or scale moves it by far more). In a
  compute mode #7's context is also held to its plain version
  (mode_ctx_check), and in int8 (whose context equals the plain one bit
  for bit) the DRQ output end to end bit for bit. Returns the check's
  record; raises beyond these rules."""
  pq, iq, att = port['packed_qmatmul'], port['int_qmatmul'], port['attention']
  k_scale, v_scale, zp_k, zp_v = OPROJ_SCALES
  b, _, G, H = q.shape
  cast = xi.dtype
  bf16 = torch.bfloat16
  args = (q, kc, vc, k_scale, v_scale, lengths, xi, wo, so, zp_k, zp_v,
          compute, drq)
  got = att.decode_attention_oproj(*args)
  want = att.decode_attention_oproj_plain(*args)
  ctx = oproj_context(torch, port, q, kc, vc, lengths, xi, wo, so, drq,
                      compute)
  proj = (pq.qmatmul_int4_packed_drq_plain if drq
          else pq.qmatmul_int4_packed_plain)
  o = proj(ctx, wo, so)
  given = xi + o
  sync()
  ymax = float(torch.max(torch.abs(want.float())))
  err = float(torch.max(torch.abs(got.float() - want.float())))
  err_given = float(torch.max(torch.abs(got.float() - given.float())))
  tol = 0.0 if drq else iq.int_weights_tolerance(G * H, 0, ymax)
  # At bf16 the projection is rounded before the residual add, so its own
  # ulp (larger than y's where x_res cancels it) carries.
  atol = tol + torch.exp2(torch.floor(torch.log2(torch.clamp_min(
      torch.abs(o.float()), 2.0**-126))) - 7) if cast == bf16 else tol
  ulps = bf16_ulps(torch, got, given, atol=atol) \
      if cast == bf16 and not drq else None
  ok_given = (err_given == 0.0) if drq else (
      ulps <= 1.0 if ulps is not None else err_given <= tol)
  exact = compute == 'int8' and drq
  if (not ok_given or not err <= 1e-2 * ymax or got.dtype != cast
      or (exact and err != 0.0)):
    raise AssertionError(
        f'attention epilogue {label} ({cast}, drq {drq}, {compute}): err '
        f'given its first launch\'s context {err_given} (tolerance {tol}, '
        f'bf16 ulps beyond it {ulps}), err end to end {err}, max |y| {ymax}')
  check = {'lengths': int(lengths[0]), 'x': str(cast).split('.')[-1],
           'drq': drq, 'max_abs_err_given_ctx': err_given,
           'max_abs_err': err, 'max_abs_y': ymax, 'bf16_ulps_beyond': ulps}
  if compute != 'f32':
    ctx32 = att.decode_attention_int8_lengths(
        q.to(cast), kc, vc, k_scale, v_scale, lengths, zp_k, zp_v,
        compute=compute)
    plain32 = att.decode_attention_int8_lengths_plain(
        q.to(cast), kc, vc, k_scale, v_scale, lengths, zp_k, zp_v,
        compute=compute)
    sync()
    c_err, off, n = mode_ctx_check(torch, ctx32, plain32, compute, v_scale,
                                   zp_v, f'epilogue context {label}')
    if compute == 'int8' and c_err != 0.0:
      raise AssertionError(f'epilogue context {label} int8: err {c_err}, '
                           'not bit for bit')
    check.update(ctx_max_abs_err=c_err, ctx_rows_beyond_fine=off,
                 ctx_rows=n)
  return check


def oproj_unfused(torch, port, timer, args, drq, compute):
  """The unfused kernels #19 replaces, timed on its inputs `args` (q, caches,
  scales, lengths, x_res, wo, so, zero points): (#7 in `compute` + #1 or
  #12 + the residual ADD, #7 + #1 or #12 alone) in ms."""
  pq, att = port['packed_qmatmul'], port['attention']
  q, kc, vc, k_scale, v_scale, lengths, x, wo, so, zp_k, zp_v = args
  b, _, g, h = q.shape
  proj = pq.qmatmul_int4_packed_drq if drq else pq.qmatmul_int4_packed

  def kernels():
    ctx = att.decode_attention_int8_lengths(
        q, kc, vc, k_scale, v_scale, lengths, zp_k, zp_v, compute=compute,
        out_dtype=x.dtype)
    return proj(ctx.reshape(b, g * h), wo, so)

  return timer(lambda: x + kernels()), timer(kernels)


def oproj_kernel(torch, port, cfg, dev, timer, gen):
  """The attention + out projection + residual epilogue (#19) against its
  plain version at bench.py's decode shape (B BENCH_B, S 1024, one KV head,
  G 8, H 256, D 2048) and at B B, lengths BENCH_START + 1 = 897 (the bench
  step's), 0, 1 and S, bf16 and f32 x_res, DRQ on and off, by oproj_case's
  rules. Timed at BENCH_B and B, lengths 897, DRQ, bf16, beside the
  unfused route (#7, #1 and the residual ADD) and #7 + #1 alone; each row
  logs the launches' plans (DRQ, weight-only at bf16 and f32 x), the
  whole the ptxas report. NK 2 and odd G raise ValueError on the card and
  launch nothing."""
  pq, att = port['packed_qmatmul'], port['attention']
  D, NK, H, S = cfg.embed_dim, cfg.num_kv_heads, cfg.head_dim, \
      cfg.max_seq_len
  G = cfg.num_query_heads // NK
  bf16 = torch.bfloat16
  k_scale, v_scale, zp_k, zp_v = OPROJ_SCALES
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
        for drq in (True, False):
          checks.append(oproj_case(torch, port, q, kc, vc, lengths, xi, wo,
                                   so, drq, 'f32', phase))
    lengths = torch.full((b,), BENCH_START + 1, dtype=torch.int32,
                         device=dev)
    args = (q, kc, vc, k_scale, v_scale, lengths, x, wo, so, zp_k, zp_v)
    composition_ms, alone_ms = oproj_unfused(torch, port, timer, args, True,
                                             'f32')
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
        'composition_ms': composition_ms, 'kernels_alone_ms': alone_ms,
        'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
        'plan': att.oproj_plan(b, G, S, H, D, 'f32', True, True),
        'plan_weight_only': att.oproj_plan(b, G, S, H, D, 'f32', False,
                                           True),
        'plan_weight_only_f32': att.oproj_plan(b, G, S, H, D, 'f32', False,
                                               False)})
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
  timing = ('ms', 'plain_ms', 'composition_ms', 'kernels_alone_ms',
            'bound_ms')
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
      'kernels_alone': '#7 + #1 without the ADD',
      'decode': {key: rows[1][key] for key in timing}, 'refused': refused,
      'ptxas': ptxas_report(port['_build'], 'attention_oproj', ''),
      'by_shape': rows}


def attn_block_kernels(torch, port, cfg, dev, timer, gen):
  """The kernels of the norm fusion and the attention block."""
  return [rmsnorm_kernel(torch, port, cfg, dev, timer, gen),
          qkv_kernel(torch, port, cfg, dev, timer, gen),
          oproj_kernel(torch, port, cfg, dev, timer, gen)]


# -- the attention compute modes, #22 and #21 ---------------------------------

COMPUTE_MODES = ('bf16', 'int8')
# The peak rate of each mode's attention operations (its operands' type).
MODE_OPS_PER_S = {'f32': F32_OPS_PER_S, 'bf16': BF16_OPS_PER_S,
                  'int8': INT8_OPS_PER_S}
# The context of a kernel in a compute mode against its plain version on
# the same inputs: f32 sums in another order, so a row (one query row's H
# values) is held to MODE_RTOL of max(max |ctx|, 1) as the f32 rows are,
# except a row where a probability's operand rounds the other way (the
# plain version's f32 probability and the kernel's differ in the last
# place): a bf16 probability code by one bf16 step (2^-8 of p <= 1), an
# int8 code by one of 127 (the context's code sum p_sum is about 127 at
# these inputs, whose scores are peaked). Such a row must stay within
# MODE_FLIP_STEPS steps of (127 + |zp_v|) * v_scale / 127 (int8) or
# 2^-8 (127 + |zp_v|) v_scale (bf16), and at most MODE_ROWS_OFF_SHARE of the
# rows may be such rows.
MODE_RTOL = 1e-5
MODE_FLIP_STEPS = 2
MODE_ROWS_OFF_SHARE = 0.01


def mode_flip_step(compute, v_scale, zp_v):
  """The largest change of one context value when one probability's
  operand rounds the other way (see MODE_FLIP_STEPS)."""
  span = (127.0 + abs(zp_v)) * v_scale
  return span * 2.0**-8 if compute == 'bf16' else 2.0 * span / 127.0


def mode_ctx_check(torch, got, want, compute, v_scale, zp_v, label,
                   rtol=MODE_RTOL):
  """(max |got - want|, rows beyond the fine tolerance, rows) of a context
  in a compute mode; raises beyond the rules above."""
  h = want.shape[-1]
  g, w = got.float().reshape(-1, h), want.float().reshape(-1, h)
  fine = rtol * max(float(torch.max(torch.abs(w))), 1.0)
  rows_err = torch.amax(torch.abs(g - w), dim=1)
  off = int(torch.sum(rows_err > fine))
  err = float(torch.max(rows_err))
  loose = fine + MODE_FLIP_STEPS * mode_flip_step(compute, v_scale, zp_v)
  if err > loose or off > MODE_ROWS_OFF_SHARE * w.shape[0]:
    raise AssertionError(f'{label} {compute}: max err {err} (fine {fine}, '
                         f'loose {loose}), {off} of {w.shape[0]} rows beyond '
                         'the fine tolerance')
  return err, off, w.shape[0]


def compute_mode_kernels(torch, port, cfg, dev, timer, gen, results):
  """The stale attention (#2, at B and at bench.py's decode), the lengths
  attention (#7, the server's tick), the decode block (#5, bench.py's
  step), the masked attention (#17, masked_mode_rows), the splice
  attention (#8, writeback_mode_rows) and the epilogue (#19,
  oproj_mode_rows) in the bf16 and int8 compute modes against their plain
  versions on the same inputs (mode_ctx_check, and every int8 context bit
  for bit; the block's new-row codes, pools and x_ffn as in f32, bit for
  bit and within 1e-6; #8's pools bit for bit), each timed beside its
  plain version; the bound takes the mode's operations at the peak rate
  of its operands' type. Each row lands in `modes` of the kernel's f32
  entry in `results`."""
  att, blk, impl = port['attention'], port['block'], port['ops_impl']
  pq, mlp = port['packed_qmatmul'], port['mlp']
  NK, H, S = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
  G = cfg.num_query_heads // NK
  by_name = {r['name']: r for r in results}
  bf16, i32 = torch.bfloat16, torch.int32
  k_scale, v_scale, zp_k, zp_v = 0.06, 0.06, 3.0, -2.0

  def randint(*shape):
    return torch.randint(-127, 128, shape, generator=gen, device=dev).to(
        torch.int8)

  def attn_rows(name, kern, plain, args, kw, nbytes, ops, label):
    rows = {}
    for mode in COMPUTE_MODES:
      b_ms, b_by = bound(nbytes, ops, MODE_OPS_PER_S[mode])
      kwm = dict(kw, compute=mode)
      got, want = kern(*args, **kwm), plain(*args, **kwm)
      sync()
      err, off, n = mode_ctx_check(torch, got, want, mode, v_scale, zp_v,
                                   f'{name} {label}')
      if mode == 'int8' and err != 0.0:
        raise AssertionError(f'{name} {label} int8: err {err}, not bit for '
                             'bit')
      rows[mode] = {
          'max_abs_err': err, 'rows_beyond_fine': off, 'rows': n,
          'ms': timer(lambda: kern(*args, **kwm)),
          'plain_ms': timer(lambda: plain(*args, **kwm)),
          'bound_ms': b_ms, 'bound_by': b_by}
      log(f'kernel {name} {label} {mode} ok: err {err:.3g}, {off} of {n} '
          f'rows beyond {MODE_RTOL:g}; {rows[mode]["ms"]:.4f} ms (plain '
          f'{rows[mode]["plain_ms"]:.4f}, bound {b_ms:.4f})')
    return rows

  # #2 at B (random lengths, rows 1 and S) and at bench.py's decode.
  stale = by_name['decode_attention_int8_lengths_stale']
  for label, b, lengths in (
      ('decode', B, None), ('bench', BENCH_B,
                            torch.full((BENCH_B,), BENCH_START + 1, dtype=i32,
                                       device=dev))):
    if lengths is None:
      lengths = torch.randint(1, S + 1, (b,), generator=gen, device=dev).to(
          i32)
      lengths[0], lengths[1] = 1, S
    q = torch.randn((b, NK, G, H), generator=gen, device=dev).to(bf16)
    args = (q, randint(b, NK, S, H), randint(b, NK, S, H), k_scale, v_scale,
            lengths, randint(b, NK, 1, H), randint(b, NK, 1, H))
    live = NK * int(torch.sum(torch.clamp_min(lengths - 1, 0)))
    nbytes = (q.numel() * 2 + 2 * live * H + 2 * b * NK * H + b * 4
              + q.numel() * 4)
    rows = attn_rows(stale['name'], att.decode_attention_int8_lengths_stale,
                     att.decode_attention_int8_lengths_stale_plain, args,
                     dict(k_zero_point=zp_k, v_zero_point=zp_v), nbytes,
                     4 * G * H * (live + b * NK), label)
    for mode, row in rows.items():
      row['B'], row['live_rows'] = b, live
      row['launch'] = split_plan(port['_build'], 'attention_stale', b * NK,
                                 G, S, H, att.compute_code(mode))
      log(f'kernel {stale["name"]} {label} {mode} launch {row["launch"]}')
      stale.setdefault('modes', {}).setdefault(mode, {})[label] = row

  # #7 at the server's tick shape (a zero length too) and at bench.py's
  # decode with in-place writes (BENCH_B rows of BENCH_START + 1), with the
  # launch of each.
  lens = by_name['decode_attention_int8_lengths']
  kw = dict(k_zero_point=zp_k, v_zero_point=zp_v)
  for label, b in (('server tick', B), ('bench', BENCH_B)):
    q = torch.randn((b, NK, G, H), generator=gen, device=dev).to(bf16)
    if b == B:
      lengths = torch.randint(1, S + 1, (b,), generator=gen, device=dev).to(
          i32)
      lengths[0], lengths[-1] = 1, S
    else:
      lengths = torch.full((b,), BENCH_START + 1, dtype=i32, device=dev)
    args = (q, randint(b, NK, S, H), randint(b, NK, S, H), k_scale, v_scale,
            lengths)
    for mode in COMPUTE_MODES:  # a zero-length row: every row weighs 1/S
      zero = torch.zeros_like(lengths)
      got0 = att.decode_attention_int8_lengths(*args[:5], zero, compute=mode,
                                               **kw)
      want0 = att.decode_attention_int8_lengths_plain(*args[:5], zero,
                                                      compute=mode, **kw)
      sync()
      mode_ctx_check(torch, got0, want0, mode, v_scale, zp_v,
                     'lengths attention, length 0')
    live = NK * int(torch.sum(lengths))
    nbytes = q.numel() * 2 + 2 * live * H + b * 4 + q.numel() * 4
    for mode, row in attn_rows(lens['name'],
                               att.decode_attention_int8_lengths,
                               att.decode_attention_int8_lengths_plain, args,
                               kw, nbytes, 4 * G * H * live, label).items():
      row['B'], row['live_rows'] = b, live
      row['launch'] = split_plan(port['_build'], 'attention_lengths', b * NK,
                                 G, S, H, att.compute_code(mode))
      log(f'kernel {lens["name"]} {label} {mode} launch {row["launch"]}')
      if b == B:
        lens.setdefault('modes', {}).setdefault(mode, {}).update(row)
      else:
        lens['modes'][mode]['bench'] = row

  # #5 at bench.py's step (f32 x, as the executor passes it).
  blk_row = by_name['fused_mlp_qkv_attention']
  D, F, NQ = cfg.embed_dim, cfg.ffn_dim, cfg.num_query_heads
  N, bf, eps = (NQ + 2) * H, 2048, cfg.norm_eps

  def w4(*shape):
    return torch.randint(-8, 8, shape, generator=gen, device=dev).to(
        torch.int8)

  def scales(n):
    return torch.rand((n,), generator=gen, device=dev) * 0.01 + 0.005

  x = torch.randn((BENCH_B, D), generator=gen, device=dev).to(bf16).float()
  wgu, sgu = pq.pack_int4_split(w4(2 * F, D)), scales(2 * F)
  wd, sd = mlp.pack_int4_split_grouped(w4(D, F), bf), scales(D)
  wqkv, sqkv = pq.pack_int4_split(w4(N, D)), scales(N)
  g1 = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=dev)
  g2 = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=dev)
  kc, vc = randint(BENCH_B, S, H), randint(BENCH_B, S, H)
  ang = (float(BENCH_START) * impl.rope_freqs(10000.0, H // 2, dev)).reshape(
      1, H // 2).expand(BENCH_B, H // 2)
  cos, sin = torch.cos(ang).contiguous(), torch.sin(ang).contiguous()
  lengths = torch.full((BENCH_B,), BENCH_START + 1, dtype=i32, device=dev)

  def block_args():
    return ([x, g1, wgu, sgu, wd, sd, g2, wqkv, sqkv, cos, sin, kc.clone(),
             vc.clone(), lengths, BENCH_START] + [0.06] * 4 + [NQ])

  for mode in COMPUTE_MODES:
    a, b_ = block_args(), block_args()
    got = blk.fused_mlp_qkv_attention(*a, eps=eps, bf=bf, compute=mode)
    want = blk.fused_mlp_qkv_attention_plain(*b_, eps=eps, bf=bf,
                                             compute=mode)
    sync()
    codes = {name: int(torch.sum(g != w)) for name, g, w in (
        ('k_new', got[2], want[2]), ('v_new', got[3], want[3]),
        ('k_pool', a[11], b_[11]), ('v_pool', a[12], b_[12]))}
    x_err = float(torch.max(torch.abs(got[1] - want[1]))
                  / torch.max(torch.abs(want[1])))
    if any(codes.values()) or x_err > 1e-6:
      raise AssertionError(f'fused block {mode}: codes that differ {codes}, '
                           f'x_ffn err {x_err}')
    # The block's ctx is held as the f32 block's: 5e-5 of max |ctx|.
    err, off, n = mode_ctx_check(torch, got[0], want[0], mode, 0.06, 0.0,
                                 'fused block', rtol=5e-5)
    a16 = block_args()
    ms = timer(lambda: blk.fused_mlp_qkv_attention(*a16, eps=eps, bf=bf,
                                                   compute=mode))
    plain_ms = timer(lambda: blk.fused_mlp_qkv_attention_plain(
        *a16, eps=eps, bf=bf, compute=mode), reps=5)
    parts = blk_row['bound_parts']
    b_ms, b_by = bound(parts['bytes'], parts['int8_ops'], INT8_OPS_PER_S,
                       parts['attention_ops'], MODE_OPS_PER_S[mode])
    blk_row.setdefault('modes', {})[mode] = {
        'max_abs_err': err, 'rows_beyond_fine': off, 'rows': n,
        'x_ffn_rel_err': x_err, 'codes_differ': codes, 'ms': ms,
        'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by}
    log(f'kernel fused_mlp_qkv_attention bench step {mode} ok: codes equal, '
        f'x_ffn err {x_err:.3g}, ctx err {err:.3g} ({off} of {n} rows beyond '
        f'5e-5); {ms:.3f} ms (plain {plain_ms:.3f})')

  masked_mode_rows(torch, att, cfg, dev, by_name, randint, attn_rows, gen)
  writeback_mode_rows(torch, att, cfg, dev, timer, by_name, randint, gen,
                      port['_build'])
  oproj_mode_rows(torch, port, cfg, dev, timer, by_name, randint, gen)


def masked_mode_rows(torch, att, cfg, dev, by_name, randint, attn_rows, gen):
  """#17 in bf16 and int8 at the default-mode server's tick (B 64) and at
  bench.py's batch (B 256), S 1024, zero points 3 and -2: the graph's
  [B, 1, 1, S] prefix mask with rows of one column, of S and of none (an
  idle server slot, -1e9 everywhere: uniform weights, in int8 every code
  rint(127 / 1024) = 0, so ctx = -zp_v * v_scale), and at B 64 a non-prefix
  [B, 1, G, S] mask with one query row hidden everywhere; attn_rows'
  rules. Timed on each mask; the bound counts every
  cache row (the mask decides)."""
  NK, H, S = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
  G = cfg.num_query_heads // NK
  row = by_name['decode_attention_int8_masked']
  kw = dict(k_zero_point=3.0, v_zero_point=-2.0)
  for label, b in (('decode', B), ('bench', BENCH_B)):
    q = torch.randn((b, NK, G, H), generator=gen, device=dev).to(
        torch.bfloat16)
    kc, vc = randint(b, NK, S, H), randint(b, NK, S, H)
    lengths = torch.randint(1, S + 1, (b,), generator=gen, device=dev)
    lengths[0], lengths[1], lengths[2] = 1, S, 0
    prefix = torch.where(torch.arange(S, device=dev)[None, :]
                         < lengths[:, None], 0.0, -1e9).reshape(b, 1, 1, S)
    masks = {'prefix_row': prefix}
    if b == B:
      holes = torch.where(torch.rand((b, 1, G, S), generator=gen, device=dev)
                          < 0.4, -1e9, 0.0)
      holes[0, 0, 1] = -1e9  # one query row hidden everywhere: uniform
      masks['nonprefix'] = holes
    for mname, mask in masks.items():
      nbytes = (q.numel() * 2 + kc.numel() + vc.numel() + mask.numel() * 4
                + q.numel() * 4)
      rows = attn_rows(row['name'], att.decode_attention_int8_masked,
                       att.decode_attention_int8_masked_plain,
                       (q, kc, vc, 0.06, 0.06, mask), kw, nbytes,
                       4 * b * NK * G * S * H, f'{label} {mname}')
      for mode, r in rows.items():
        r.update(B=b, mask=mname, mask_shape=list(mask.shape))
        row.setdefault('modes', {}).setdefault(mode, {})[
            f'{label} {mname}'] = r


def writeback_mode_rows(torch, att, cfg, dev, timer, by_name, randint, gen,
                        build):
  """#8 in bf16 and int8 at bench.py's decode shape (B 256, S 1024, pos
  896) and at the server's tick batch (B 64, `b64`): lengths 897, a shorter
  row (876) and a zero-length one (every row at 1/S, the spliced one among
  them; in int8 every code 0 at S 1024). Each side on its own copies of
  the pools: both pools bit for bit and written in place; the context (f32
  out) by mode_ctx_check, int8 bit for bit, the bf16 out (the executor's)
  int8 bit for bit too. Timed at lengths 897 with bf16 out, as the f32
  row, with its launch (split_plan)."""
  NK, H, S = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
  G = cfg.num_query_heads // NK
  bf16 = torch.bfloat16
  row = by_name['decode_attention_int8_lengths_writeback']
  k_scale, v_scale, zp_k, zp_v = 0.06, 0.06, 3.0, -2.0
  for b in (BENCH_B, B):
    q = torch.randn((b, NK, G, H), generator=gen, device=dev).to(bf16)
    kc, vc = randint(b, NK, S, H), randint(b, NK, S, H)
    kn, vn = randint(b, NK, 1, H), randint(b, NK, 1, H)
    p = torch.tensor([BENCH_START], dtype=torch.int32, device=dev)
    lengths = torch.full((b,), BENCH_START + 1, dtype=torch.int32,
                         device=dev)
    checked = lengths.clone()
    checked[1], checked[2] = BENCH_START - 20, 0
    live = NK * b * (BENCH_START + 1)
    nbytes = q.numel() * 2 + 2 * live * H + 4 * kn.numel() + q.numel() * 2
    for mode in COMPUTE_MODES:
      errs = {}
      for out_dtype in (torch.float32, bf16):
        gk, gv, wk, wv = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        args = (k_scale, v_scale, checked, kn, vn, p)
        kw = dict(k_zero_point=zp_k, v_zero_point=zp_v, out_dtype=out_dtype,
                  compute=mode)
        got, ko, vo = att.decode_attention_int8_lengths_writeback(
            q, gk, gv, *args, **kw)
        want, _, _ = att.decode_attention_int8_lengths_writeback_plain(
            q, wk, wv, *args, **kw)
        sync()
        if (ko.data_ptr(), vo.data_ptr()) != (gk.data_ptr(), gv.data_ptr()) \
            or not (torch.equal(gk, wk) and torch.equal(gv, wv)):
          raise AssertionError(f'splice attention B {b} {mode}: pools differ '
                               'from the plain version or not in place')
        if out_dtype == torch.float32:
          errs['max_abs_err'], errs['rows_beyond_fine'], errs['rows'] = \
              mode_ctx_check(torch, got, want, mode, v_scale, zp_v,
                             f'splice attention B {b}')
        else:
          errs['bf16_out_max_abs_err'] = float(torch.max(torch.abs(
              got.float() - want.float())))
      if mode == 'int8' and (errs['max_abs_err'] or
                             errs['bf16_out_max_abs_err']):
        raise AssertionError(f'splice attention B {b} int8: {errs}, not bit '
                             'for bit')
      gk, gv = kc.clone(), vc.clone()
      targs = (q, gk, gv, k_scale, v_scale, lengths, kn, vn, p)
      tkw = dict(k_zero_point=zp_k, v_zero_point=zp_v, out_dtype=bf16,
                 compute=mode)
      b_ms, b_by = bound(nbytes, 4 * G * H * live, MODE_OPS_PER_S[mode])
      r = {
          **errs, 'pools_equal': True, 'B': b, 'live_rows': live,
          'ms': timer(lambda: att.decode_attention_int8_lengths_writeback(
              *targs, **tkw)),
          'plain_ms': timer(
              lambda: att.decode_attention_int8_lengths_writeback_plain(
                  *targs, **tkw)),
          'bound_ms': b_ms, 'bound_by': b_by,
          'launch': split_plan(build, 'attention_writeback', b * NK, G, S, H,
                               att.compute_code(mode))}
      modes = row.setdefault('modes', {})
      if b == BENCH_B:
        modes[mode] = r
      else:
        modes[mode]['b64'] = r
      log(f'kernel decode_attention_int8_lengths_writeback B {b} {mode} ok: '
          f'pools equal, err {r["max_abs_err"]:.3g} ({r["rows_beyond_fine"]} '
          f'of {r["rows"]} rows beyond {MODE_RTOL:g}); {r["ms"]:.4f} ms '
          f'(plain {r["plain_ms"]:.4f}, bound {b_ms:.4f}), launch '
          f'{r["launch"]}')


def oproj_mode_rows(torch, port, cfg, dev, timer, by_name, randint, gen):
  """#19 in bf16 and int8 by oproj_case's rules: at bench.py's decode
  (B 256, DRQ, bf16 x) and at B 64 weight-only (bf16 x), lengths 897 and
  0; timed at 897 beside the unfused kernels in the mode (#7 + #1 or #12 +
  ADD, and without the ADD). The bound takes the attention's operations at
  the mode's peak and the projection's at the int8 (DRQ) or bf16
  (weight-only) peak."""
  pq, att = port['packed_qmatmul'], port['attention']
  D, NK, H, S = cfg.embed_dim, cfg.num_kv_heads, cfg.head_dim, \
      cfg.max_seq_len
  G = cfg.num_query_heads // NK
  bf16 = torch.bfloat16
  k_scale, v_scale, zp_k, zp_v = OPROJ_SCALES
  row = by_name['decode_attention_oproj']
  wo = pq.pack_int4_split(torch.randint(-8, 8, (D, G * H), generator=gen,
                                        device=dev).to(torch.int8))
  so = torch.rand((D,), generator=gen, device=dev) * 0.01 + 0.005
  for label, b, drq in (('bench drq', BENCH_B, True),
                        ('decode weight-only', B, False)):
    q = torch.randn((b, 1, G, H), generator=gen, device=dev).to(bf16)
    kc, vc = randint(b, 1, S, H), randint(b, 1, S, H)
    x = torch.randn((b, D), generator=gen, device=dev).to(bf16)
    lengths = torch.full((b,), BENCH_START + 1, dtype=torch.int32,
                         device=dev)
    live = b * (BENCH_START + 1)
    nbytes = (b * G * H * 2 + 2 * live * H + b * 4 + b * D * 2
              + D * G * H // 2 + D * 4 + b * D * 2)
    for mode in COMPUTE_MODES:
      checks = [oproj_case(torch, port, q, kc, vc, lens, x, wo, so, drq,
                           mode, label)
                for lens in (lengths, torch.zeros_like(lengths))]
      args = (q, kc, vc, k_scale, v_scale, lengths, x, wo, so, zp_k, zp_v,
              mode, drq)
      b_ms, b_by = bound(nbytes, 4 * G * H * live, MODE_OPS_PER_S[mode],
                         2 * b * D * G * H,
                         INT8_OPS_PER_S if drq else BF16_OPS_PER_S)
      composition_ms, alone_ms = oproj_unfused(torch, port, timer, args[:11],
                                               drq, mode)
      r = row.setdefault('modes', {}).setdefault(mode, {})[label] = {
          'B': b, 'drq': drq, 'live_rows': live, 'checks': checks,
          'max_abs_err': max(c['max_abs_err'] for c in checks),
          'ctx_max_abs_err': max(c['ctx_max_abs_err'] for c in checks),
          'ms': timer(lambda: att.decode_attention_oproj(*args)),
          'plain_ms': timer(lambda: att.decode_attention_oproj_plain(*args),
                            reps=5),
          'composition_ms': composition_ms, 'kernels_alone_ms': alone_ms,
          'bound_ms': b_ms, 'bound_by': b_by,
          'plan': att.oproj_plan(b, G, S, H, D, mode, drq, True)}
      log(f'kernel decode_attention_oproj {label} {mode} ok: err '
          f'{r["max_abs_err"]:.3g}, ctx err {r["ctx_max_abs_err"]:.3g}; '
          f'{r["ms"]:.4f} ms (plain {r["plain_ms"]:.4f}, unfused '
          f'{composition_ms:.4f}, without the ADD {alone_ms:.4f}, bound '
          f'{b_ms:.4f}), plan {r["plan"]}')


def int8_basic_kernel(torch, port, cfg, dev, timer, gen):
  """#22, the basic int8 decode attention, against its plain version at
  B 64 and 256 (S 1024, random lengths 0..S with rows 0, 1 and S): f32
  sums in another order, so held to 1e-5 of max(max |ctx|, 1); its plain
  version must equal the lengths attention's plain version with both zero
  points 0 bit for bit (the kernel runs that body). Timed beside SDPA
  with the lengths mask over the caches dequantized to bf16, with its
  launch (the split core's lengths form where it takes the shape) and
  ptxas' report. No entry point of the JAX package reaches it, so no path
  launches it."""
  att = port['attention']
  build = port['_build']
  NK, H, S = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
  G = cfg.num_query_heads // NK
  k_scale, v_scale = 0.06, 0.05
  sdpa = torch.nn.functional.scaled_dot_product_attention
  rows = {}
  for b in (B, BENCH_B):
    q = torch.randn((b, NK, G, H), generator=gen, device=dev)
    kc, vc = (torch.randint(-127, 128, (b, NK, S, H), generator=gen,
                            device=dev).to(torch.int8) for _ in range(2))
    lengths = torch.randint(0, S + 1, (b,), generator=gen, device=dev).to(
        torch.int32)
    lengths[0], lengths[1], lengths[2] = 0, 1, S
    args = (q, kc, vc, k_scale, v_scale, lengths)
    got = att.decode_attention_int8(*args)
    want = att.decode_attention_int8_plain(*args)
    twin = att.decode_attention_int8_lengths_plain(*args)
    sync()
    err = float(torch.max(torch.abs(got - want)))
    ymax = float(torch.max(torch.abs(want)))
    if err > 1e-5 * max(ymax, 1.0) or not torch.equal(want, twin):
      raise AssertionError(f'decode_attention_int8 B {b}: err {err} (max '
                           f'|ctx| {ymax}), equal to #7 plain with zero '
                           f'points 0: {torch.equal(want, twin)}')
    # A zero-length row attends all S rows (as the Pallas kernel's -1e30).
    live = NK * int(torch.sum(torch.where(lengths > 0,
                                          torch.clamp_max(lengths, S), S)))
    nbytes = 2 * q.numel() * 4 + 2 * live * H + b * 4
    b_ms, b_by = bound(nbytes, 4 * G * H * live, F32_OPS_PER_S)
    kd = (kc.float() * k_scale).to(torch.bfloat16)
    vd = (vc.float() * v_scale).to(torch.bfloat16)
    qb = q.to(torch.bfloat16)
    amask = torch.where(
        torch.arange(S, device=dev)[None, :] < lengths[:, None], 0.0,
        float('-inf')).to(torch.bfloat16).reshape(b, 1, 1, S)
    amask[0] = 0.0
    rows[b] = {'B': b, 'max_abs_err': err, 'max_abs_y': ymax,
               'live_rows': live,
               'ms': timer(lambda: att.decode_attention_int8(*args)),
               'plain_ms': timer(lambda: att.decode_attention_int8_plain(
                   *args)),
               'bound_ms': b_ms, 'bound_by': b_by,
               'library_ms': timer(lambda: sdpa(qb, kd, vd,
                                                attn_mask=amask)),
               'launch': split_plan(build, 'attention_int8_basic', b * NK,
                                    G, S, H)}
    log(f'kernel decode_attention_int8 B {b} ok: err {err:.3g} (max |ctx| '
        f'{ymax:.3g}), plain equal to #7\'s with zero points 0; '
        f'{rows[b]["ms"]:.4f} ms (plain {rows[b]["plain_ms"]:.4f}, SDPA '
        f'{rows[b]["library_ms"]:.4f}, bound {b_ms:.4f}); launch '
        f'{rows[b]["launch"]}')
  dec = rows[B]
  return {
      'name': 'decode_attention_int8', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'attention_int8_basic.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:108',
      'jax': 'pallas_attention.decode_attention_int8',
      'wrapper': att.decode_attention_int8, 'per_step': 0,
      'path': 'none: no entry point of the JAX package reaches it '
              '(tests/test_kernels.py is its one caller), so only this '
              'kernel check launches it',
      'max_abs_err': max(r['max_abs_err'] for r in rows.values()),
      'ms': dec['ms'], 'plain_ms': dec['plain_ms'],
      'bound_ms': dec['bound_ms'], 'bound_by': dec['bound_by'],
      'library_ms': dec['library_ms'],
      'library': 'scaled_dot_product_attention with the lengths mask over '
                 'the caches dequantized to bf16',
      'core': SPLIT_CORE, 'launch': dec['launch'],
      'ptxas': ptxas_report(build, 'attention_int8_basic',
                            'lengths_attention_split_kernel'),
      'bench': rows[BENCH_B]}


# #21 against its plain version: as the int4-group attention (a bf16
# probability operand may round the other way, 2^-8 of it), so the same
# rule (int4g_ctx_ok) with its own bound, INT4_ROW_CTX_RTOL (no sweep of
# #21's draws has measured its own rounding's reach).
# Against the f32 twin of decode_attention_int4_ref (q and the operands
# not rounded to bf16): within INT4_ROW_REF_RTOL of max |ctx|, the bf16
# roundings of q and of p * vscale (2^-9 relative each).
INT4_ROW_REF_RTOL = 2e-2
INT4_ROW_CTX_RTOL = 1e-3


def int4_row_ref(torch, att, q, kp, vp, scales, lengths):
  """decode_attention_int4_ref in plain f32 PyTorch: the dequantized rows,
  then f32 attention."""
  h = q.shape[-1]
  s = kp.shape[2]
  sc = scales.float()
  k = att.unpack_int4_rows(kp).float() * sc[:, :, 0, :, None]
  v = att.unpack_int4_rows(vp).float() * sc[:, :, 1, :, None]
  scores = torch.matmul(q.float(), k.transpose(-1, -2)) / (h ** 0.5)
  live = (torch.arange(s, device=q.device).reshape(1, 1, 1, s)
          < lengths.reshape(-1, 1, 1, 1))
  scores = torch.where(live, scores, -1e30)
  return torch.matmul(torch.softmax(scores, dim=-1), v)


def int4_row_kernel(torch, port, cfg, dev, timer, gen):
  """#21, the per-row int4 KV attention, against its plain version at the
  A/B tool's shape (B 256, S 1024, lengths S - 2) and at B 64 with random
  lengths 0..S, operands made by the tool (its quantizer and scales);
  held by int4g_ctx_ok at f32 (INT4_ROW_CTX_RTOL) and one bf16 ulp beyond
  INT4_ROW_CTX_RTOL at bf16, and against the f32 twin by
  INT4_ROW_REF_RTOL. Timed beside SDPA
  over the pools dequantized to bf16; each shape's launch (the split
  core's plan, cluster 0 for the one-block kernel) and the kernels' ptxas
  registers and spills logged."""
  att, tool = port['attention'], port['attn_int4_bench']
  H, S = cfg.head_dim, cfg.max_seq_len
  kern, plain = att.decode_attention_int4_lengths, (
      att.decode_attention_int4_lengths_plain)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  rows = {}
  for b, seed in ((BENCH_B, 1), (B, 2)):
    ops = tool.make_operands(b, S, H, seed=seed, device=dev)
    lengths = ops['lengths']
    if b == B:
      lengths = torch.randint(0, S + 1, (b,), generator=gen, device=dev).to(
          torch.int32)
      lengths[0], lengths[1], lengths[2] = 0, 1, S
    args = (ops['q'], ops['kp_r'], ops['vp_r'], ops['scales_r'], lengths)
    got32, want32 = kern(*args), plain(*args)
    got16 = kern(*args, out_dtype=torch.bfloat16)
    want16 = plain(*args, out_dtype=torch.bfloat16)
    ref = int4_row_ref(torch, att, *args)
    sync()
    ymax = float(torch.max(torch.abs(want32)))
    err = float(torch.max(torch.abs(got32 - want32)))
    rel, share = int4g_ctx_diff(torch, got32, want32)
    ulps = bf16_ulps(torch, got16, want16, atol=INT4_ROW_CTX_RTOL * ymax)
    ref_rel = float(torch.max(torch.abs(want32 - ref))
                    / torch.max(torch.abs(ref)))
    if not (int4g_ctx_ok(rel, share, INT4_ROW_CTX_RTOL) and ulps <= 1.0
            and ref_rel <= INT4_ROW_REF_RTOL):
      raise AssertionError(f'int4 row attention B {b}: f32 err {err} (max '
                           f'|ctx| {ymax}), share {share}, {ulps} bf16 ulps, '
                           f'plain against the f32 twin {ref_rel}')
    live = int(torch.sum(torch.where(lengths > 0,
                                     torch.clamp_max(lengths, S), S)))
    # Products of bf16 q with int4 values exact in bf16: the bf16 rate.
    nbytes = 2 * ops['q'].numel() * 4 + live * H + 2 * live * 2 + b * 4
    b_ms, b_by = bound(nbytes, 4 * tool.G * H * live, BF16_OPS_PER_S)
    sc = ops['scales_r'].float()
    kd = (att.unpack_int4_rows(ops['kp_r']).float()
          * sc[:, :, 0, :, None]).to(torch.bfloat16)
    vd = (att.unpack_int4_rows(ops['vp_r']).float()
          * sc[:, :, 1, :, None]).to(torch.bfloat16)
    qb = ops['q'].to(torch.bfloat16)
    amask = torch.where(
        torch.arange(S, device=dev)[None, :] < lengths[:, None], 0.0,
        float('-inf')).to(torch.bfloat16).reshape(b, 1, 1, S)
    amask[lengths <= 0] = 0.0
    qb_, nk_, g_, _ = ops['q'].shape
    rows[b] = {'B': b, 'max_abs_err': err, 'max_abs_ctx': ymax,
               'share_beyond_fine': share, 'bf16_ulps_beyond_tol': ulps,
               'plain_vs_f32_twin_rel': ref_rel, 'live_rows': live,
               'launch': split_plan(port['_build'], 'attention_int4_row',
                                    qb_ * nk_, g_, S, H)
                         if dev == 'cuda' else None,
               'ms': timer(lambda: kern(*args)),
               'plain_ms': timer(lambda: plain(*args)),
               'bound_ms': b_ms, 'bound_by': b_by,
               'library_ms': timer(lambda: sdpa(qb, kd, vd,
                                                attn_mask=amask))}
    del ops, kd, vd
    log(f'kernel decode_attention_int4_lengths B {b} ok: f32 err {err:.3g} '
        f'(max |ctx| {ymax:.3g}), share beyond {INT4G_FINE_RTOL:g} '
        f'{share:.4g}, bf16 {ulps} ulps beyond tol, plain vs f32 twin '
        f'{ref_rel:.3g}; {rows[b]["ms"]:.4f} ms (plain '
        f'{rows[b]["plain_ms"]:.4f}, SDPA {rows[b]["library_ms"]:.4f}, bound '
        f'{b_ms:.4f}); launch {rows[b]["launch"]}')
  ab = rows[BENCH_B]
  ptxas = (ptxas_report(port['_build'], 'attention_int4_row', '_kernel')
           if dev == 'cuda' else None)
  log(f'kernel decode_attention_int4_lengths ptxas {ptxas}')
  return {
      'name': 'decode_attention_int4_lengths', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/'
                'attention_int4_row.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:1433',
      'jax': 'pallas_attention.decode_attention_int4_lengths',
      'wrapper': kern, 'per_step': 0, 'per_ab_step': tool.knobs()['layers'],
      'max_abs_err': max(r['max_abs_err'] for r in rows.values()),
      'ms': ab['ms'], 'plain_ms': ab['plain_ms'], 'bound_ms': ab['bound_ms'],
      'bound_by': ab['bound_by'], 'library_ms': ab['library_ms'],
      'library': 'scaled_dot_product_attention with the lengths mask over '
                 'the pools dequantized to bf16',
      'core': SPLIT_CORE, 'launch': ab['launch'], 'ptxas': ptxas,
      'decode': rows[B]}


# The A/B tool's chained outputs (16 steps of 18 launches) against the same
# chain of the plain versions on the card, relative to the largest
# magnitude: f32 sums in another order each launch (int8, f32 compute);
# the int4 formats also round q to bf16 each launch, so an ulp of one
# launch's output can move the next one's q by a bf16 step.
AB_CHAIN_RTOL = {'int8': 1e-4, 'int4_row': 1e-3, 'int4_group': 1e-3}


def ab_tool_phase(torch, port, kernels, dev='cuda'):
  """The A/B tool (tools/attn_int4_bench.py) at its defaults on the card:
  its `main`, which prints its artifact line; each format's launches
  (two chains and one launch for its error, no plain run on the card);
  each chained output against the same chain of the plain versions
  (AB_CHAIN_RTOL); every rel_err_vs_float finite."""
  tool = port['attn_int4_bench']
  for k in kernels:
    k['wrapper'].launches = 0
    k['wrapper'].plain_calls = 0
  result = tool.main([] if dev == 'cuda' else ['--device', dev])
  sync()
  art = result['artifact']
  launches = {k['name']: k['wrapper'].launches for k in kernels}
  plain = {k['name']: k['wrapper'].plain_calls for k in kernels}
  chains = 2 if dev == 'cuda' else 1  # a warm-up chain and a timed one
  per_format = chains * art['L'] * art['iters'] + 1
  want = {name: 0 for name in launches}
  want.update({'decode_attention_int8_lengths': per_format,
               'decode_attention_int4_lengths': per_format,
               'decode_attention_int4_group_lengths': per_format})
  if launches != want or any(plain.values()):
    raise AssertionError(f'A/B tool launches {launches}, want {want}; plain '
                         f'runs on the card {plain}')
  for k in kernels:
    k['launches_ab_tool'] = launches[k['name']]
  ops = result['operands']
  chain = {}
  for label, (fn, _) in tool.formats(ops, plain=True).items():
    want_out = tool.chained(fn, ops['q'], art['L'], art['iters'])
    got = result['outputs'][label]
    rel = float(torch.max(torch.abs(got - want_out))
                / torch.max(torch.abs(want_out)))
    chain[label] = rel
    if rel > AB_CHAIN_RTOL[label]:
      raise AssertionError(f'A/B {label}: chained output rel err {rel}')
  errs = {label: r['rel_err_vs_float'] for label, r in art['kernels'].items()}
  if not all(np.isfinite(v) for v in errs.values()):
    raise AssertionError(f'A/B rel_err_vs_float {errs}')
  log(f'A/B tool ok: chained outputs against the plain chains (rel) {chain}; '
      f'launches {dict((n, v) for n, v in launches.items() if v)}')
  return {**art, 'chain_rel_err_vs_plain': chain}


def int4g_f64(torch, att, q, kp, vp, sidecar, lengths, group):
  """The int4-group attention in f64 with its four bf16 roundings kept (the
  plain version's function, its sums exact to f64)."""
  b, nk, g, h = q.shape
  s = kp.shape[2]
  ng = h // group
  f64 = torch.float64
  qb = q.float().to(torch.bfloat16).to(f64)
  grp = torch.arange(h, device=q.device) // group
  sc = sidecar.to(f64)
  k32 = kp.to(torch.int32)
  kcodes = torch.cat([k32 & 0xF, k32 >> 4], dim=-1).to(f64)
  kd = (kcodes * sc[:, :, :ng].transpose(-1, -2)[..., grp]).to(
      torch.bfloat16).to(f64)
  scores = torch.matmul(qb, kd.transpose(-1, -2))
  qsums = qb.reshape(b, nk, g, ng, group).sum(-1)
  scores = (scores + torch.matmul(qsums, sc[:, :, ng:2 * ng])) / h ** 0.5
  live = torch.arange(s, device=q.device)[None, None, None, :] < (
      lengths.reshape(b, 1, 1, 1))
  p = torch.softmax(torch.where(live, scores, -1e30), -1).to(
      torch.bfloat16).to(f64)
  vd = (att.unpack_int4_rows(vp).to(f64)
        * sc[:, :, 2 * ng:].transpose(-1, -2)[..., grp]).to(
            torch.bfloat16).to(f64)
  return torch.matmul(p, vd)


def split_edge_shapes(torch, att, build, dev, gen, results):
  """#7, #2, #8 and #10 off the main path's shapes, each against its plain
  version with its launch (split_plan), into the kernel's `edge_shapes`: S
  8192, which the split core takes (a slice's scores fit; the one-block
  kernels refused it, G x S scores past shared memory), and H 512, which
  goes to the one-block kernels by the entry points' fixed rule (cluster
  0). #7, #2 and #8 in f32 within 1e-5 * max(|y|, 1) and in int8 bit for
  bit (#2 with a row of no stale row, #8 at a pos in a later slice with a
  zero-length row and its pools bit for bit); #10 by
  int4g_ctx_ok against the plain version at H 512 and against an f64 run of
  the same function (int4g_f64) at S 8192, and there within
  INT4G_CTX_RTOL of the plain version: over thousands of live rows the
  plain version's own f32 sums leave the fine rule's share (on an H100,
  0.1045 of the elements against f64 where the kernel's was 0.0374;
  PERF.md §6)."""
  by_name = {r['name']: r for r in results}
  kw = dict(k_zero_point=3.0, v_zero_point=-2.0)
  for b, s, h in ((2, 8192, 256), (4, 512, 512)):
    q = torch.randn((b, 1, 8, h), generator=gen, device=dev).to(
        torch.bfloat16)
    kc, vc = (torch.randint(-127, 128, (b, 1, s, h), generator=gen,
                            device=dev).to(torch.int8) for _ in range(2))
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev).to(
        torch.int32)
    lengths[0] = s
    args = (q, kc, vc, 0.06, 0.06, lengths)
    for mode in ('f32', 'int8'):
      got = att.decode_attention_int8_lengths(*args, compute=mode, **kw)
      want = att.decode_attention_int8_lengths_plain(*args, compute=mode,
                                                     **kw)
      sync()
      err = float(torch.max(torch.abs(got - want)))
      ymax = float(torch.max(torch.abs(want)))
      if err > (0.0 if mode == 'int8' else 1e-5 * max(ymax, 1.0)):
        raise AssertionError(f'lengths attention S {s} H {h} {mode}: err '
                             f'{err}, max |y| {ymax}')
      row = {'B': b, 'S': s, 'H': h, 'compute': mode, 'max_abs_err': err,
             'launch': split_plan(build, 'attention_lengths', b, 8, s, h,
                                  att.compute_code(mode))}
      by_name['decode_attention_int8_lengths'].setdefault(
          'edge_shapes', []).append(row)
      log(f'kernel decode_attention_int8_lengths edge shape ok: {row}')
    kn, vn = (torch.randint(-127, 128, (b, 1, 1, h), generator=gen,
                            device=dev).to(torch.int8) for _ in range(2))
    lengths[1] = 0  # #2: the new column alone; #8: every V row read
    pos = torch.tensor([s // 2 + 5], dtype=torch.int32, device=dev)
    for mode in ('f32', 'int8'):
      stale = att.decode_attention_int8_lengths_stale(
          *args[:5], lengths, kn, vn, compute=mode, **kw)
      stale_want = att.decode_attention_int8_lengths_stale_plain(
          *args[:5], lengths, kn, vn, compute=mode, **kw)
      gk, gv, wk, wv = kc.clone(), vc.clone(), kc.clone(), vc.clone()
      splice, _, _ = att.decode_attention_int8_lengths_writeback(
          q, gk, gv, 0.06, 0.06, lengths, kn, vn, pos, compute=mode, **kw)
      splice_want, _, _ = att.decode_attention_int8_lengths_writeback_plain(
          q, wk, wv, 0.06, 0.06, lengths, kn, vn, pos, compute=mode, **kw)
      sync()
      if not (torch.equal(gk, wk) and torch.equal(gv, wv)):
        raise AssertionError(f'splice attention S {s} H {h} {mode}: pools '
                             'differ from the plain version')
      for name, lib, got, want in (
          ('decode_attention_int8_lengths_stale', 'attention_stale', stale,
           stale_want),
          ('decode_attention_int8_lengths_writeback', 'attention_writeback',
           splice, splice_want)):
        err = float(torch.max(torch.abs(got - want)))
        ymax = float(torch.max(torch.abs(want)))
        if err > (0.0 if mode == 'int8' else 1e-5 * max(ymax, 1.0)):
          raise AssertionError(f'{name} S {s} H {h} {mode}: err {err}, max '
                               f'|y| {ymax}')
        row = {'B': b, 'S': s, 'H': h, 'compute': mode, 'max_abs_err': err,
               'lengths': lengths.tolist(),
               'launch': split_plan(build, lib, b, 8, s, h,
                                    att.compute_code(mode))}
        if lib == 'attention_writeback':
          row.update(pos=int(pos), pools_equal=True)
        by_name[name].setdefault('edge_shapes', []).append(row)
        log(f'kernel {name} edge shape ok: {row}')
  for b, s, h in ((2, 8192, 256), (2, 256, 512)):
    q = torch.randn((b, 1, 8, h), generator=gen, device=dev).to(
        torch.bfloat16)
    kp, vp, sc = int4g_pools(torch, att, b, 1, s, h, gen, dev)
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev).to(
        torch.int32)
    lengths[0] = s
    args = (q, kp, vp, sc, lengths, INT4G_GROUP)
    got = att.decode_attention_int4_group_lengths(*args)
    want = att.decode_attention_int4_group_lengths_plain(*args)
    sync()
    rel_plain, share_plain = int4g_ctx_diff(torch, got, want)
    ok = int4g_ctx_ok(rel_plain, share_plain)
    row = {'B': b, 'S': s, 'H': h, 'max_rel_err': rel_plain,
           'share_beyond_fine': share_plain,
           'launch': split_plan(build, 'attention_int4_group', b, 8, s, h,
                                INT4G_GROUP)}
    if s > S:
      truth = int4g_f64(torch, att, *args)
      rel, share = int4g_ctx_diff(torch, got, truth)
      plain_rel, plain_share = int4g_ctx_diff(torch, want, truth)
      ok = rel_plain <= INT4G_CTX_RTOL and int4g_ctx_ok(rel, share)
      row.update(f64_max_rel_err=rel, f64_share_beyond_fine=share,
                 plain_f64_max_rel_err=plain_rel,
                 plain_f64_share_beyond_fine=plain_share)
    if not ok:
      raise AssertionError(f'int4g attention S {s} H {h}: {row}')
    by_name['decode_attention_int4_group_lengths'].setdefault(
        'edge_shapes', []).append(row)
    log(f'kernel decode_attention_int4_group_lengths edge shape ok: {row}')


def refused_shapes(torch, att, dev):
  """Shapes that the JAX executor's gate sends to its Pallas kernels but
  that the CUDA kernels do not take: the wrapper raises ValueError on the
  card and launches nothing (the executor has no fallback for them)."""
  def i8(*shape, dtype=torch.int8):
    return torch.zeros(shape, dtype=dtype, device=dev)

  cases = (
      ('lengths attention, G = 8 x S = 65536 scores',
       att.decode_attention_int8_lengths,
       lambda: att.decode_attention_int8_lengths(
           torch.zeros((1, 1, 8, 256), device=dev), i8(1, 1, 65536, 256),
           i8(1, 1, 65536, 256), 1.0, 1.0,
           torch.ones(1, dtype=torch.int32, device=dev))),
      ('flash attention, H = 384', att.flash_attention_int8_masked,
       lambda: att.flash_attention_int8_masked(
           torch.zeros((1, 1, 32, 384), device=dev), i8(1, 1, 128, 384),
           i8(1, 1, 128, 384), 1.0, 1.0,
           torch.zeros((1, 1, 32, 128), device=dev))),
      ('int4-group attention, G = 8 x S = 65536 scores',
       att.decode_attention_int4_group_lengths,
       lambda: att.decode_attention_int4_group_lengths(
           torch.zeros((1, 1, 8, 256), device=dev),
           i8(1, 1, 65536, 128, dtype=torch.uint8),
           i8(1, 1, 65536, 128, dtype=torch.uint8),
           i8(1, 1, 48, 65536, dtype=torch.bfloat16),
           torch.ones(1, dtype=torch.int32, device=dev))),
      ('masked decode attention, H = 384', att.decode_attention_int8_masked,
       lambda: att.decode_attention_int8_masked(
           torch.zeros((1, 1, 8, 384), device=dev), i8(1, 1, 128, 384),
           i8(1, 1, 128, 384), 1.0, 1.0,
           torch.zeros((1, 1, 1, 128), device=dev))))
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


def lengths_kernel(torch, att, build, cfg, dev, timer, gen):
  """Lengths attention at the server's decode tick: B = 64, S = 1024,
  random lengths 1..1024 (first and last rows 1 and S), f32 compute, held
  to 1e-5 absolute in f32 (a zero length too) and one bf16 ulp beyond it;
  then at bench.py's decode with in-place writes (BENCH_B rows of
  BENCH_START + 1: the new row is written first), held to 1e-5 *
  max(|y|, 1) as the stale attention is there. Each timed beside its
  plain version and SDPA, with its launch (split_plan)."""
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
  launch = split_plan(build, 'attention_lengths', B * NK, G, S, H, 0)
  ms = timer(lambda: att.decode_attention_int8_lengths(*args, **kw))
  log(f'kernel decode_attention_int8_lengths ok: f32 err {err32}, '
      f'length-0 err {err0}, {ulps} bf16 ulps; {ms:.5f} ms, launch {launch}')

  # bench.py's decode with in-place writes: B 256, BENCH_START + 1 rows.
  qb = torch.randn((BENCH_B, NK, G, H), generator=gen, device=dev).to(bf16)
  kcb, vcb = (torch.randint(-127, 128, (BENCH_B, NK, S, H), generator=gen,
                            device=dev).to(torch.int8) for _ in range(2))
  lb = torch.full((BENCH_B,), BENCH_START + 1, dtype=torch.int32,
                  device=dev)
  argsb = (qb, kcb, vcb, k_scale, v_scale, lb)
  gotb = att.decode_attention_int8_lengths(*argsb, **kw32)
  wantb = att.decode_attention_int8_lengths_plain(*argsb, **kw32)
  sync()
  errb = float(torch.max(torch.abs(gotb - wantb)))
  ymaxb = float(torch.max(torch.abs(wantb)))
  if errb > 1e-5 * max(ymaxb, 1.0):
    raise AssertionError(f'lengths attention at the bench shape: err {errb}, '
                         f'max |y| {ymaxb}')
  liveb = NK * BENCH_B * (BENCH_START + 1)
  nbytesb = qb.numel() * 2 + 2 * liveb * H + BENCH_B * 4 + qb.numel() * 2
  bb_ms, bb_by = bound(nbytesb, 4 * G * H * liveb, F32_OPS_PER_S)
  kdb = (kcb.float() * k_scale).to(bf16)
  vdb = (vcb.float() * v_scale).to(bf16)
  amaskb = torch.where(
      torch.arange(S, device=dev)[None, :] < lb[:, None], 0.0,
      float('-inf')).to(bf16).reshape(BENCH_B, 1, 1, S)
  bench = {
      'B': BENCH_B, 'live_rows': liveb, 'max_abs_err': errb,
      'max_abs_y': ymaxb,
      'ms': timer(lambda: att.decode_attention_int8_lengths(*argsb, **kw)),
      'plain_ms': timer(
          lambda: att.decode_attention_int8_lengths_plain(*argsb, **kw)),
      'bound_ms': bb_ms, 'bound_by': bb_by,
      'library_ms': timer(lambda: sdpa(qb, kdb, vdb, attn_mask=amaskb)),
      'launch': split_plan(build, 'attention_lengths', BENCH_B * NK, G, S, H,
                           0)}
  log(f'kernel decode_attention_int8_lengths bench shape ok: err {errb:.3g}; '
      f'{bench["ms"]:.5f} ms (plain {bench["plain_ms"]:.4f}, SDPA '
      f'{bench["library_ms"]:.4f}, bound {bb_ms:.4f}), launch '
      f'{bench["launch"]}')
  return {
      'name': 'decode_attention_int8_lengths', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/attention_lengths.cu',
      'core': SPLIT_CORE,
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_attention.py:508',
      'jax': 'pallas_attention.decode_attention_int8_lengths (f32 compute)',
      'wrapper': att.decode_attention_int8_lengths, 'per_step': 0,
      'per_tick': cfg.num_layers, 'max_abs_err': err32,
      'max_bf16_ulps': ulps, 'length0_max_abs_err': err0,
      'ms': ms,
      'plain_ms': timer(
          lambda: att.decode_attention_int8_lengths_plain(*args, **kw)),
      'bound_ms': b_ms, 'bound_by': b_by,
      'library_ms': timer(lambda: sdpa(q, kd, vd, attn_mask=amask)),
      'library': 'scaled_dot_product_attention over a dequantized bf16 cache',
      'live_rows': live, 'launch': launch, 'bench': bench,
      'ptxas': ptxas_report(build, 'attention_lengths',
                            'lengths_attention_split_kernel')}


def prefill_mask(torch, dev, g, start, s):
  """The prefill device mask of the chunk at `start`: query row (g, t)
  sees keys <= start + t (0, else -1e9), g-major rows [Bp, 1, G*T, S]."""
  pos = start + torch.arange(PREFILL_LEN, device=dev)
  rows = torch.where(torch.arange(s, device=dev)[None, :] <= pos[:, None],
                     0.0, -1e9)
  return rows.reshape(1, 1, 1, PREFILL_LEN, s).expand(
      PREFILL_BATCH, 1, g, PREFILL_LEN, s).reshape(
          PREFILL_BATCH, 1, g * PREFILL_LEN, s).contiguous()


# The flash kernel's further checks: (name,
# B, NK, R, S, H, mask_nk, q dtype, mask dtype). H 64 and 128, NK 2 with
# one mask for both kv heads and one each, f32 q (three bf16 parts), a
# bf16 mask, a ragged S (200 and 1000: a last key tile of 8 and 40 keys),
# ragged R, an odd S (203 and 301: mask rows the wrapper pads to whole
# 16-byte units); every case has a fully masked row.
FLASH_CASES = (('h64', 2, 1, 128, 256, 64, 1, 'bfloat16', 'float32'),
               ('h128', 2, 1, 256, 512, 128, 1, 'bfloat16', 'float32'),
               ('nk2_mask1', 2, 2, 128, 256, 128, 1, 'bfloat16', 'float32'),
               ('nk2_mask2', 2, 2, 128, 256, 128, 2, 'bfloat16', 'float32'),
               ('f32_q', 2, 2, 128, 256, 128, 2, 'float32', 'float32'),
               ('f32_q_h64', 2, 1, 128, 256, 64, 1, 'float32', 'float32'),
               ('bf16_mask', 2, 1, 1024, 1024, 256, 1, 'bfloat16',
                'bfloat16'),
               ('ragged_s', 2, 2, 128, 200, 64, 2, 'bfloat16', 'float32'),
               ('ragged_s_h256', 1, 1, 1000, 1000, 256, 1, 'bfloat16',
                'float32'),
               ('odd_s', 2, 2, 128, 203, 128, 2, 'bfloat16', 'float32'),
               ('odd_s_bf16_mask', 1, 1, 192, 301, 64, 1, 'float32',
                'bfloat16'))


# The split-S decode attentions (#17, #18, #7, #2, #8, #10, #21, #22): their
# shared core and the launch fields of its plan (csrc/attention_split_tc.cuh
# plan_fields; a cluster of 0 is a one-block kernel, for a shape the core
# does not take).
SPLIT_CORE = 'ai_edge_quantizer_tpu_torch/kernels/csrc/attention_split_tc.cuh'
SPLIT_PLAN_FIELDS = ('cluster', 'grid_y', 'rows', 'threads', 'smem_bytes')


def split_plan(build, lib, *dims):
  """The launch of #17 (lib 'attention_masked', dims R, G, S, H and the
  compute code), #18 ('attention_dynlen', R, G, S, H), #7
  ('attention_lengths', R, G, S, H, compute code), #2 ('attention_stale',
  the same), #8 ('attention_writeback', the same), #10
  ('attention_int4_group', R, G, S, H, group), #21
  ('attention_int4_row', R, G, S, H) or #22 ('attention_int8_basic', R,
  G, S, H): the cluster size (the splits, grid
  x; 0 for a one-block kernel), grid y (rows), cache rows a CTA, threads,
  shared memory."""
  return build.plan(lib, f'aeqt_{lib}_plan', lib, *dims,
                    fields=SPLIT_PLAN_FIELDS)


def flash_plan(torch, build, b, nk, r, s, h, mask_nk, q_dtype,
               mask_dtype):
  """The launch the flash kernel's C plan gives a shape: grid, bf16 parts
  of q, threads, shared memory, ring stages."""
  return build.plan(
      'flash_attention_int8', 'aeqt_flash_attention_int8_plan',
      'flash_attention_int8_masked', b * nk, nk, r, s, h, mask_nk,
      int(q_dtype == torch.bfloat16), int(mask_dtype == torch.bfloat16),
      fields=('grid_x', 'grid_y', 'q_parts', 'threads', 'smem_bytes',
              'stages'))


def flash_case(torch, att, dev, gen, b, nk, r, s, h, mask_nk, q_dtype,
               mask_dtype, start):
  """Inputs of one flash check: q, int8 caches, the causal prefill mask of
  the chunk at `start` over R = 8 groups of R / 8 rows (one mask for all
  kv heads, or a reversed one for the others), row 3 fully masked."""
  q = torch.randn((b, nk, r, h), generator=gen, device=dev).to(q_dtype)
  kc, vc = (torch.randint(-127, 128, (b, nk, s, h), generator=gen,
                          device=dev).to(torch.int8) for _ in range(2))
  t = max(r // 8, 1)
  pos = start + torch.arange(r, device=dev) % t
  rows = torch.where(torch.arange(s, device=dev)[None, :] <= pos[:, None],
                     0.0, -1e9)
  mask = rows.reshape(1, 1, r, s).expand(b, mask_nk, r, s).contiguous()
  if mask_nk > 1:
    mask[:, 1:] = torch.flip(mask[:, 1:], dims=(-1,))
  mask[0, 0, 3] = -1e9
  return q, kc, vc, mask.to(mask_dtype)


def flash_kernel(torch, att, build, cfg, dev, timer, gen):
  """Flash attention at the server's prefill pass: Bp = 8, R = G*T = 1024,
  S = 1024, with the causal device masks of chunks 0 and 3, then at
  FLASH_CASES; every case within 1e-5 * max(|y|, 1) of the plain version
  (the tensor cores' f32 sums in another order than the plain version's;
  tests/test_torch_port_flash_tc.py holds the kernel's operand splits to
  the same bound on the CPU)."""
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
  kw = dict(k_zero_point=zp_k, v_zero_point=zp_v)
  kd = (kc.float() * k_scale).to(bf16)
  vd = (vc.float() * v_scale).to(bf16)
  sdpa = torch.nn.functional.scaled_dot_product_attention

  def check(label, args):
    got = att.flash_attention_int8_masked(*args, **kw)
    want = att.flash_attention_int8_masked_plain(*args, **kw)
    sync()
    err = float(torch.max(torch.abs(got - want)))
    ymax = float(torch.max(torch.abs(want)))
    if not (err <= 1e-5 * max(ymax, 1.0) and bool(torch.isfinite(got).all())):
      raise AssertionError(f'flash attention {label}: err {err}, max |y| '
                           f'{ymax}')
    return err, ymax

  by_chunk = []
  for chunk in (0, 3):
    mask = prefill_mask(torch, dev, G, chunk * PREFILL_LEN, S)
    args = (q, kc, vc, k_scale, v_scale, mask)
    err, ymax = check(f'chunk {chunk}', args)
    nbytes = (q.numel() * 2 + kc.numel() + vc.numel() + mask.numel() * 4
              + q.numel() * 4)
    b_ms, b_by = bound(nbytes, 4 * PREFILL_BATCH * NK * R * S * H,
                       BF16_OPS_PER_S)
    mask_bf16 = mask.to(bf16)
    by_chunk.append({
        'chunk': chunk, 'max_abs_err': err, 'max_abs_y': ymax,
        'ms': timer(lambda: att.flash_attention_int8_masked(*args, **kw)),
        'plain_ms': timer(
            lambda: att.flash_attention_int8_masked_plain(*args, **kw)),
        'bound_ms': b_ms, 'bound_by': b_by,
        'library_ms': timer(lambda: sdpa(q, kd, vd, attn_mask=mask_bf16)),
        'launch': flash_plan(torch, build, PREFILL_BATCH, NK, R, S, H, 1,
                             bf16, mask.dtype)})
  log(f'kernel flash_attention_int8_masked ok: {by_chunk}')
  cases = []
  for name, b, nk, r, s, h, mask_nk, qd, md in FLASH_CASES:
    qd, md = getattr(torch, qd), getattr(torch, md)
    args = flash_case(torch, att, dev, gen, b, nk, r, s, h, mask_nk, qd, md,
                      start=s // 3)
    err, ymax = check(name, args[:3] + (k_scale, v_scale, args[3]))
    cases.append({'check': name, 'B': b, 'NK': nk, 'R': r, 'S': s, 'H': h,
                  'mask_nk': mask_nk, 'q': str(qd), 'mask': str(md),
                  'max_abs_err': err, 'max_abs_y': ymax,
                  'launch': flash_plan(torch, build, b, nk, r, s, h, mask_nk,
                                       qd, md)})
  ptxas = ptxas_report(build, 'flash_attention_int8',
                       'flash_tc_kernel')
  log(f'kernel flash_attention_int8_masked cases ok: {cases}; ptxas '
      f'{ptxas}')

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
      'max_abs_err': max(r['max_abs_err'] for r in by_chunk + cases),
      'ms': mean('ms'), 'plain_ms': mean('plain_ms'),
      'bound_ms': mean('bound_ms'), 'bound_by': by_chunk[0]['bound_by'],
      'library_ms': mean('library_ms'),
      'library': 'scaled_dot_product_attention with the additive mask over '
                 'a dequantized bf16 cache',
      'by_chunk': by_chunk, 'cases': cases, 'ptxas': ptxas}


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
# so no block unit either); then bench.py's own settings with
# AEQT_ATTN_COMPUTE=bf16 and =int8 (the block's and the stale attention's
# compute mode), and the splice and attention-block settings in each mode
# (#8 and #19 in the mode).
BENCH_SETTINGS = {
    'block on': dict(decode_block=True),
    'block off': dict(decode_block=False),
    'splice': dict(decode_block=False, attn_writeback='splice'),
    'inplace': dict(decode_block=False, attn_writeback=None,
                    cache_write_inplace=True),
    'attn block': dict(attn_block=True),
    'norm fusion': dict(norm_fusion=True),
    'attn bf16': dict(decode_block=True, attn_compute='bf16'),
    'attn int8': dict(decode_block=True, attn_compute='int8'),
    'splice bf16': dict(decode_block=False, attn_writeback='splice',
                        attn_compute='bf16'),
    'splice int8': dict(decode_block=False, attn_writeback='splice',
                        attn_compute='int8'),
    'attn block bf16': dict(attn_block=True, attn_compute='bf16'),
    'attn block int8': dict(attn_block=True, attn_compute='int8')}
# The settings above that only change the attention's compute mode
# (AEQT_ATTN_COMPUTE), each with the f32 setting it is compared with.
MODE_SETTINGS = {'attn bf16': 'block on', 'attn int8': 'block on',
                 'splice bf16': 'splice', 'splice int8': 'splice',
                 'attn block bf16': 'attn block',
                 'attn block int8': 'attn block'}


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
  for label, base in MODE_SETTINGS.items():
    per_step[label] = per_step[base]
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
  # The compute modes against the same setting in f32.
  results['ids_equal_share_vs_f32'] = {
      label: float(torch.mean((ids[label] == ids[base]).float()))
      for label, base in MODE_SETTINGS.items()}
  log(f'bench decode: ids equal to the same setting\'s at f32 attention by '
      f'compute mode: {results["ids_equal_share_vs_f32"]}')
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
  """(wall ms, device busy ms, kernels by device ms, largest first) of one
  call of fn under torch.profiler (CUDA activity)."""
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
  ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
  return wall_ms, sum(by_name.values()), ranked


def server_phase(torch, port, kernels, cfg, dev, n_requests=SERVE_REQUESTS,
                 slots=B, kv_int4_group=0, attn_compute=None):
  """The port's DecodeServer under bench.py's mixed-length load: a warm-up
  request per prompt length, then n_requests requests (prompt lengths
  cycling 32..512, 48 new tokens each) served by step_chunk(8). With
  kv_int4_group, bench.py's AEQT_BENCH_SERVER_KV=int4g server: each tick
  runs INT4G_ATTENTION_SCATTER per layer, and the prefill's float
  attention chain is graph ops (no int8 cache, so no attention unit).
  attn_compute: the executor's attention compute mode
  (executor_options={'attn_compute': ...}, AEQT_ATTN_COMPUTE); the ticks'
  lengths attention runs in it, the prefill's flash attention has none."""
  gemma, batching = port['gemma'], port['batching']
  name = 'server int4g' if kv_int4_group else 'server'
  if attn_compute:
    name = f'{name} attn {attn_compute}'
  t0 = time.monotonic()
  graph = serving_graph(gemma, cfg, slots, kv_int4_group)
  weights = gemma.device_materialize_quantized(graph, fc_bits=4,
                                               embedding_bits=8, device=dev)
  server = batching.DecodeServer(
      graph, cfg, slots, weights=weights, pack_weights=True,
      activation_dtype='bfloat16', device=dev,
      executor_options={'attn_compute': attn_compute} if attn_compute
      else None)
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
  for kname, ms in pf_top[:8]:
    log(f'  {ms:8.3f} ms/pass  {kname}')
  log(f'{name} chunk of {SERVE_CHUNK} decode ticks (64 slots busy): '
      f'{chunk_med:.3f} ms (median of {[round(t, 3) for t in chunk_ms]}); '
      f'device busy {ch_busy:.3f} ms under the profiler ({ch_wall:.3f} ms '
      f'wall), idle share {1 - ch_busy / chunk_med:.3f}')
  for kname, ms in ch_top[:8]:
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
      'prefill_pass_top': dict(pf_top[:8]), 'chunk_top': dict(ch_top[:8]),
      'chunk_by_kernel': dict(ch_top)})
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
# kblock_kernel and default_mode_kernels) and BLOCKWISE_MODE at 9 (half the
# model's depth since the static-range phase came in: its float graph,
# quantization, 4.2 GB .aeqg and server took about 100 s at 18);
# quantizer_cpu_phase holds each recipe's graph op by op at
# QUANT_CPU_LAYERS layers, reusing the graph quantizer_phase made where
# the depths agree. The host's quantization dominates both (the tied
# head's 524M weights at any depth; for gemma_mixed48_hr a 512-wide
# rotation and OCTAV in numpy), and host speed varies by up to 1.7x from one
# machine to another.
EARLIER_RECIPES = ('gemma_mixed48', 'gemma_mixed48_b32', 'gemma_mixed48_hr',
                   DEFAULT_MODE)
QUANT_LAYERS = {**dict.fromkeys(EARLIER_RECIPES, 2), BLOCKWISE_MODE: 9}
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
  with B slots, for quantizer_cpu_phase, and under 'float' gemma_mixed48's
  float graph, for static_range_phase and quantizer_cpu_phase."""
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

  # The recipes by depth: each depth's float graph is built once.
  order = sorted(QUANT_RECIPES,
                 key=lambda r: QUANT_LAYERS.get(r, cfg.num_layers))
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
        if recipe == 'gemma_mixed48':
          kept['float'] = graph
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
      del server, ex
      if recipe == DEFAULT_MODE:
        results.update(default_mode_servers(
            torch, port, kernels, cfg_r, dev, loaded, served, n_requests,
            slots))
      del loaded
      gc.collect()
      os.remove(path)  # one full-depth .aeqg at a time on the disk
      torch.cuda.empty_cache()
  return results


def default_mode_servers(torch, port, kernels, cfg, dev, loaded, f32_served,
                         n_requests=SERVE_REQUESTS, slots=B):
  """DEFAULT_MODE's loaded graph (quantized and loaded once, by
  quantizer_phase) served again with {**JAX_DEFAULT_OPTIONS,
  'attn_compute': mode} for each of COMPUTE_MODES: serve_load's requests,
  launches by quantized_launches (the masked attention #17, in the mode,
  L a tick), and #17's launches equal to the f32 default-mode server's of
  the same run (`f32_served`: the same requests, so the same ticks).
  Returns {'<DEFAULT_MODE> attn <mode>': serve_load's result}."""
  defaults = port['executor'].JAX_DEFAULT_OPTIONS
  name = 'decode_attention_int8_masked'
  out = {}
  for mode in COMPUTE_MODES:
    label = f'{DEFAULT_MODE} attn {mode}'
    t0 = time.monotonic()
    server = port['batching'].DecodeServer(
        loaded, cfg, slots, pack_weights=True, activation_dtype='bfloat16',
        device=dev, executor_options={**defaults, 'attn_compute': mode})
    sync()
    setup_s = time.monotonic() - t0
    served = serve_load(torch, server, kernels, cfg, dev, f'quantized {label}',
                        quantized_launches(DEFAULT_MODE, cfg.num_layers),
                        n_requests, slots)
    if served['launches'][name] != f32_served['launches'][name]:
      raise AssertionError(f'{label}: {served["launches"][name]} launches of '
                           f'{name}, the f32 server '
                           f'{f32_served["launches"][name]}')
    served.update(layers=cfg.num_layers, server_setup_s=setup_s,
                  attn_compute=mode)
    out[label] = served
    del server
    gc.collect()
    torch.cuda.empty_cache()
  return out


# The static-range phase: bench.py's bench_encoder (BERT_BASE_LITE, batch
# 32 of 512 tokens, 4 layers, weights from seed 0, calibration over
# create_random_dataset's 4 samples in device_stats mode, 16 timed calls).
ENC_BATCH, ENC_STEPS, ENC_CALIB_SAMPLES = 32, 16, 4
# Batch of the static-range encoder's card-against-CPU run (full width).
ENC_CPU_BATCH = 2
# Op by op from the CPU's inputs, a static-range FC or BATCH_MATMUL is an
# exact int32 product and one float32 multiply-add, the same on both
# devices: its int8 codes must be equal. An op that reduces floats before
# its output quantizes (SOFTMAX's sum, RMS_NORM's, GELU's and TANH's tanh,
# an ulp apart on the card) may round a code the other way: such codes
# differ by one step (OpByOp) in at most this share of an op kind's
# elements.
SRQ_FLIP_SHARE = 1e-3
# The Newton-Schulz inverse of a Hessian on the card against the host's
# LAPACK inverse: largest difference over the largest entry (the solve
# stops at a residual max|HX - I| of 1e-5 in Jacobi-normalized f32).
GPTQ_INVERSE_RTOL = 1e-3


def encoder_outputs_ok(torch, quant_arith, graph, out, label):
  """Dequantized `probs` rows sum to 1 within one code a class, `pooled`
  in [-1, 1], every value finite; returns them as float32."""
  sg = graph.subgraphs[graph.signatures[0].subgraph_index]
  sig = graph.signatures[0]
  vals = {}
  for name, tid in sig.outputs.items():
    t, v = sg.tensors[tid], out[name]
    vals[name] = (quant_arith.dequantize(v, t.quantization)
                  if t.quantization is not None and not v.is_floating_point()
                  else v.float())
  probs, pooled = vals['probs'], vals['pooled']
  codes = 1.0
  q = sg.tensors[sig.outputs['probs']].quantization
  if q is not None:
    codes = float(np.asarray(q.scale).reshape(-1)[0]) * probs.shape[-1]
  row_err = float(torch.max(torch.abs(probs.sum(-1) - 1.0)))
  if (not all(bool(torch.isfinite(v).all()) for v in vals.values())
      or row_err > max(codes, 1e-5) or float(pooled.abs().max()) > 1.0):
    raise AssertionError(f'{label}: outputs out of range (probs rows off by '
                         f'{row_err}, |pooled| <= '
                         f'{float(pooled.abs().max())})')
  return vals


def static_range_phase(torch, port, kernels, dev, kept, cfg=None,
                       batch=ENC_BATCH, steps=ENC_STEPS,
                       cpu_batch=ENC_CPU_BATCH):
  """The static-range path through the port's entry points, on bench.py's
  bench_encoder (BERT_BASE_LITE at full width and depth unless `cfg` says
  otherwise): (a) `Quantizer(graph, 'default_a8w8').calibrate` in
  device_stats mode over ENC_CALIB_SAMPLES samples of
  create_random_dataset, and in capture mode over the first of them, whose
  min and max must equal device_stats' over that sample exactly; (b) the
  quantized int8 model on the card at `batch` (sequences/s over `steps`
  calls, device busy and idle share of one call, outputs in range), then,
  at `cpu_batch` (the same weights and QSVs), op by op against the CPU
  port (OpByOp: static-range FC and BATCH_MATMUL codes equal, other ops'
  one-step flips within SRQ_FLIP_SHARE); (c) default_a16w8 calibrated,
  quantized and run once; (d) `validate()` of the a8w8 model at
  `cpu_batch` on one random sample, each output's mse printed; (e) dynamic_wi4_afp32_gptq_octav
  calibrated, quantized and run once, and the Newton-Schulz inverse of
  one of its Hessians on the card held against the host's (within
  GPTQ_INVERSE_RTOL); (f) `compare_model(..., use_serving_paths=True)` of
  `kept`'s gemma_mixed48 serving graph (quantizer_phase's, QUANT_LAYERS
  deep; target: an executor with the port's serving options and packed
  weights) against its float graph on one random decode call, the main
  path's kernels launched under capture. Every kernel's launches over
  the phase go to 'launches'."""
  enc, q_arith = port['encoder'], port['quant_arith']
  executor, Quantizer = port['executor'], port['Quantizer']
  test_data, gptq = port['test_data'], port['gptq']
  cfg = cfg or enc.BERT_BASE_LITE
  opts = dict(activation_dtype='float32', **executor.JAX_DEFAULT_OPTIONS)
  out = {'batch': batch, 'seq_len': cfg.seq_len, 'layers': cfg.num_layers}
  on_card = dev == 'cuda'
  for k in kernels:
    k['wrapper'].launches = 0
    k['wrapper'].plain_calls = 0

  def timed(key, fn):
    t0 = time.monotonic()
    r = fn()
    sync()
    out[key] = time.monotonic() - t0
    return r

  graph = timed('build_s', lambda: enc.build_encoder(cfg, batch=batch))
  data = test_data.create_random_dataset(graph, num_samples=ENC_CALIB_SAMPLES)
  first = {k: v[:1] for k, v in data.items()}
  # (a) calibration in both modes.
  qt = Quantizer(graph, 'default_a8w8')
  qsv = timed('calibrate_device_stats_s', lambda: qt.calibrate(
      data, calibration_mode='device_stats', device=dev))
  cap = timed('calibrate_capture_s', lambda: Quantizer(
      graph, 'default_a8w8').calibrate(first, calibration_mode='capture',
                                       device=dev))
  ds1 = Quantizer(graph, 'default_a8w8').calibrate(
      first, calibration_mode='device_stats', device=dev)
  # device_stats reduces the float tensors; capture measures the integer
  # inputs too (tokens, positions), as in the JAX package.
  measured = sorted(n for n, v in ds1.items() if 'min' in v)
  differ = [n for n in measured if 'min' not in cap.get(n, {}) or not (
      np.array_equal(cap[n]['min'], ds1[n]['min'])
      and np.array_equal(cap[n]['max'], ds1[n]['max']))]
  if differ or not measured:
    raise AssertionError(f'static range: capture and device_stats QSVs '
                         f'differ on one sample: {differ[:8]}')
  out['qsv_tensors'] = len(measured)
  log(f'static range (a): calibrated {len(qsv)} tensors: device_stats over '
      f'{ENC_CALIB_SAMPLES} samples {out["calibrate_device_stats_s"]:.2f}s, '
      f'capture over one {out["calibrate_capture_s"]:.2f}s; min and max of '
      f'the two modes equal on it ({len(measured)} float tensors)')
  # (b) the int8 model on the card, then op by op against the CPU.
  qgraph = timed('quantize_a8w8_s', lambda: qt.quantize(qsv)).quantized_model
  ex = executor.GraphExecutor(qgraph, device=dev, **opts)
  inputs = enc.make_inputs(cfg, batch)
  res = ex(inputs)
  sync()
  t0 = time.monotonic()
  for _ in range(steps):
    res = ex(inputs)
  sync()
  elapsed = time.monotonic() - t0
  out['seqs_per_s'] = batch * steps / elapsed
  out['ms_per_call'] = elapsed / steps * 1e3
  encoder_outputs_ok(torch, q_arith, qgraph, res, 'a8w8 encoder')
  if on_card:
    wall, busy, ranked = device_busy(torch, lambda: ex(inputs))
    out.update(call_wall_ms=wall, call_device_busy_ms=busy,
               call_idle_share=1.0 - busy / wall,
               call_by_kernel=dict(ranked[:12]))
  del ex
  log(f'static range (b): int8 encoder {out["seqs_per_s"]:.1f} seqs/s at '
      f'batch {batch}, T {cfg.seq_len} ({out["ms_per_call"]:.3f} ms a call; '
      f'device busy {out.get("call_device_busy_ms", 0.0):.3f} ms of '
      f'{out.get("call_wall_ms", 0.0):.3f}); quantize '
      f'{out["quantize_a8w8_s"]:.2f}s')
  small = enc.build_encoder(cfg, batch=cpu_batch)
  qt_small = Quantizer(small, 'default_a8w8')
  q_small = qt_small.quantize(qsv).quantized_model
  feed = enc.make_inputs(cfg, cpu_batch, seed=1)
  watch = OpByOp(torch, executor.GraphExecutor(q_small, device='cpu', **opts))
  watch.call(feed)
  hold = OpByOp(torch, executor.GraphExecutor(q_small, device=dev, **opts),
                want=watch.seen, int_qmatmul=port['int_qmatmul'])
  hold.call(feed)
  sg = q_small.subgraphs[0]
  elements = {}
  for op in sg.ops:
    kind = f'serving_default/{op.opcode}'
    elements[kind] = elements.get(kind, 0) + sum(
        int(np.prod(sg.tensors[t].shape)) for t in op.outputs)
  share = {kind: n / elements[kind] for kind, n in hold.flips.items()}
  exact = [kind for kind in share if kind.endswith(('/FULLY_CONNECTED',
                                                     '/BATCH_MATMUL'))]
  if exact or any(v > SRQ_FLIP_SHARE for v in share.values()):
    raise AssertionError(f'static range card-vs-cpu: code flips {hold.flips} '
                         f'of {elements}')
  out['card_vs_cpu'] = {'flips': hold.flips, 'flip_share': share,
                        'worst_rel_err_by_opcode': hold.worst}
  log(f'static range (b): card against CPU op by op at batch {cpu_batch}: '
      f'code flips {hold.flips}, float ops worst rel err {hold.worst}')
  del watch, hold
  # (c) default_a16w8 end to end.
  qt16 = Quantizer(graph, 'default_a16w8')
  qsv16 = timed('calibrate_a16w8_s', lambda: qt16.calibrate(
      data, calibration_mode='device_stats', device=dev))
  q16 = timed('quantize_a16w8_s', lambda: qt16.quantize(qsv16)).quantized_model
  ex16 = executor.GraphExecutor(q16, device=dev, **opts)
  timed('run_a16w8_s', lambda: encoder_outputs_ok(
      torch, q_arith, q16, ex16(inputs), 'a16w8 encoder'))
  del ex16, q16
  log(f'static range (c): default_a16w8 calibrated in '
      f'{out["calibrate_a16w8_s"]:.2f}s, quantized in '
      f'{out["quantize_a16w8_s"]:.2f}s, one call {out["run_a16w8_s"]:.2f}s')
  # (d) the validator on the a8w8 model, at cpu_batch (the same weights and
  # QSVs; at `batch` its host-side metrics over every tensor of both models
  # took most of the phase).
  cmp = timed('validate_s', lambda: qt_small.validate(
      test_data=test_data.create_random_dataset(small, num_samples=1),
      device=dev))
  r = cmp.get_signature_comparison_result('serving_default')
  out['validate_outputs_mse'] = dict(r.output_tensors)
  out['validate_tensors'] = len(cmp.get_all_tensor_results())
  if (set(r.output_tensors) != {'probs', 'pooled'}
      or not all(np.isfinite(v) for v in r.output_tensors.values())
      or r.output_tensors['probs'] > 1e-2):
    raise AssertionError(f'static range validate: outputs {r.output_tensors}')
  log(f'static range (d): validate() at batch {cpu_batch} '
      f'{out["validate_s"]:.2f}s over {out["validate_tensors"]} tensors; '
      f'output mse '
      f'{out["validate_outputs_mse"]}')
  # (e) GPTQ.
  qg = Quantizer(graph, 'dynamic_wi4_afp32_gptq_octav')
  qsvg = timed('calibrate_gptq_s', lambda: qg.calibrate(
      data, calibration_mode='device_stats', device=dev))
  gq = timed('quantize_gptq_s', lambda: qg.quantize(qsvg)).quantized_model
  exg = executor.GraphExecutor(gq, device=dev, **opts)
  timed('run_gptq_s', lambda: encoder_outputs_ok(
      torch, q_arith, gq, exg(inputs), 'gptq encoder'))
  del exg, gq
  name = 'layer_0/mlp/gelu'  # the down projection's input, F wide
  h = qsvg[name]['hessian']
  host = gptq._inverse_via_cholesky_host(h, 0.01)
  card = timed('gptq_device_inverse_s', lambda: gptq._inverse_via_cholesky_device(
      h, 0.01, device=dev))
  rel = float(np.max(np.abs(card - host)) / np.max(np.abs(host)))
  out['gptq_inverse'] = {'tensor': name, 'dim': int(h.shape[0]),
                         'rel_err': rel}
  if not rel <= GPTQ_INVERSE_RTOL:
    raise AssertionError(f'GPTQ device inverse of {name}: rel err {rel}')
  log(f'static range (e): dynamic_wi4_afp32_gptq_octav calibrated in '
      f'{out["calibrate_gptq_s"]:.2f}s, quantized in '
      f'{out["quantize_gptq_s"]:.2f}s; Newton-Schulz inverse of {name} '
      f'({h.shape[0]}) on the card in {out["gptq_device_inverse_s"]:.2f}s, '
      f'rel err {rel:.3e} against the host LAPACK inverse')
  del graph, small, qt, qt_small, qt16, qg
  gc.collect()
  # (f) the serving graph's validation with the fused kernels engaged.
  float_graph, target = kept['float'], kept['gemma_mixed48']
  tex = executor.GraphExecutor(target, device=dev, activation_dtype='float32')
  tex.prepare_serving_weights()
  before = {k['name']: getattr(k['wrapper'], 'launches' if on_card
                               else 'plain_calls') for k in kernels}
  cmp = timed('validate_serving_s', lambda: port['model_validator']
              .compare_model(float_graph, target,
                             test_data.create_random_dataset(
                                 float_graph, num_samples=1,
                                 signature_keys=['decode']),
                             target_executor=tex, use_serving_paths=True,
                             device=dev))
  fused = {k['name']: getattr(k['wrapper'], 'launches' if on_card
                              else 'plain_calls') - before[k['name']]
           for k in kernels}
  fused = {n: v for n, v in fused.items() if v}
  r = cmp.get_signature_comparison_result('decode')
  out['serving_validate'] = {'outputs_mse': dict(r.output_tensors),
                             'tensors': len(cmp.get_all_tensor_results()),
                             'launches': fused}
  want = {'qmatmul_int8_drq', 'mlp_int4_packed', 'head_argmax'}
  if not want <= set(fused) or not all(
      np.isfinite(v) for v in r.output_tensors.values()):
    raise AssertionError(f'static range (f): launches {fused}, outputs '
                         f'{r.output_tensors}')
  log(f'static range (f): compare_model of gemma_mixed48 with the serving '
      f'paths {out["validate_serving_s"]:.2f}s over '
      f'{out["serving_validate"]["tensors"]} tensors, launches {fused}; '
      f'output mse {r.output_tensors}')
  del tex, float_graph, target, cmp
  gc.collect()
  out['launches'] = {k['name']: getattr(k['wrapper'], 'launches' if on_card
                                        else 'plain_calls')
                     for k in kernels}
  return out


def quantizer_cpu_phase(torch, port, cfg, dev, kept=None):
  """The card against the port on the CPU, op by op, on graphs the
  Quantizer made: GEMMA_2B widths at QUANT_CPU_LAYERS layers (the graphs
  in `kept`, quantizer_phase's at that depth, else one float serving graph
  at each depth, `kept`'s 'float' where there is one, quantized here), for each of QUANT_RECIPES
  served on both devices (f32 activations) through the first prefill pass
  (8 requests of 128 tokens) and decode tick, as server_cpu_phase holds
  the server. The int8 DRQ FCs and the K-blocked packed FCs
  (gemma_mixed48_hr's down projections) must equal the CPU's bit for bit,
  the blockwise FCs and DEFAULT_MODE's weight-only packed FCs agree to
  int_qmatmul.int_weights_tolerance, int8 codes within one step."""
  t0 = time.monotonic()
  kept = {} if kept is None else kept
  graphs, out = {}, {}
  if 'float' in kept:  # quantizer_phase's float graph at this depth
    graphs[QUANT_CPU_LAYERS['gemma_mixed48']] = kept.pop('float')
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
    if recipe == DEFAULT_MODE:
      # The same graph in each compute mode: the tick's masked attention
      # (#17) in the mode, held by OpByOp's rule for a mode's context rows.
      defaults = port['executor'].JAX_DEFAULT_OPTIONS
      for mode in COMPUTE_MODES:
        label = f'{DEFAULT_MODE} attn {mode}'
        r = out[label] = server_cpu_phase(
            torch, port, cfg_l, dev, graph=quantized,
            label=f'quantized {label} card-vs-cpu',
            executor_options={**defaults, 'attn_compute': mode})
        if 'decode/BATCH_MATMUL' not in r['worst_rel_err_by_opcode']:
          raise AssertionError(f'{label}: no masked attention held')
    del quantized
    gc.collect()
  return out


# An attention-epilogue row whose DRQ code of the context flipped between
# the card and the CPU: one code moves the row by at most 8 * xs * max(so)
# (an int4 weight of 8), about 3e-4 of the row's largest output at Gemma-
# 2B's widths; 1e-3 leaves room for three such codes in one row.
EPILOGUE_ROW_RTOL = 1e-3
# Depth of the op-by-op runs of the attention-block and norm-fusion steps
# and of the compute modes' steps (3 until the static-range phase came in).
FUSION_CPU_LAYERS = 2
# A context row of an attention in a compute mode whose probability
# operand rounded the other way on the card (OpByOp), relative to the
# context's largest magnitude: one bf16 step of a probability moves a row
# by at most 2^-8 of the V span, one int8 code by (|v| + |ctx|) / p_sum
# with p_sum about 127 at peaked scores, about 2 / 127 of the span; the
# largest magnitude is about the span at the Gemma-2B step's random caches.
ATTN_MODE_ROW_RTOL = {'bf16': 1e-2, 'int8': 5e-2}
# At most this many such rows in one attention's context (one layer; 64
# rows at the op-by-op batch of 8): a flip is rare (2 rows in 3 layers in
# the measured bf16 run), while a step run in another mode moves them all.
ATTN_MODE_ROWS_OFF = 4


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
  counts them. In a compute mode other than f32 an attention's context
  (the stale or lengths attention's output, the decode block's ctx) may
  differ beyond 1e-5 of its largest magnitude in a row where one of its
  probabilities' operands rounded the other way (a bf16 step or an int8
  code): such a row must stay within ATTN_MODE_ROW_RTOL of the mode, one
  context may hold at most ATTN_MODE_ROWS_OFF of them, and
  `mode_rows_off` counts them; an epilogue's output in a compute mode is
  held by that rule too (its context's rows move its rows).
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
    self.mode_rtol = ATTN_MODE_ROW_RTOL.get(ex.attn_compute)
    self.mode_outs = set()
    if self.mode_rtol is not None:
      self.mode_outs = ({f['out'] for f in ex._attn_fusions.values()}
                        | {f['ctx_out'] for f in ex._block_fusions.values()}
                        | self.epilogue_outs)
    self.mode_rows_off = 0
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
        elif tid in self.epilogue_outs or tid in self.mode_outs:
          w2 = want.double().reshape(-1, want.shape[-1])
          row_rel = torch.amax(torch.abs(got.double().reshape(w2.shape) - w2),
                               dim=1) / max(float(torch.max(torch.abs(w2))),
                                            1e-30)
          off = int(torch.sum(row_rel > 1e-5))
          if tid in self.mode_outs:
            self.mode_rows_off += off
            row_tol = self.mode_rtol
            if off > ATTN_MODE_ROWS_OFF:
              raise AssertionError(f'{sg.tensors[tid].name}: {off} of '
                                   f'{w2.shape[0]} context rows beyond 1e-5')
          else:
            self.epilogue_rows_off += off
            row_tol = EPILOGUE_ROW_RTOL
          if float(torch.max(row_rel)) > row_tol:
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
      f'{INT4G_FINE_RTOL:g} {card_watch.fine_share:.4g}; compute-mode context '
      f'rows beyond 1e-5 {card_watch.mode_rows_off}')
  return {'worst_rel_err_by_opcode': card_watch.worst,
          'id_diffs': len(card_watch.id_diffs),
          'int4g_ctx_share_beyond_fine': card_watch.fine_share,
          'mode_rows_beyond_1e-5': card_watch.mode_rows_off}


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
  two norm-fused FCs, must have been held (OpByOp's rules); or one of
  MODE_SETTINGS, its f32 setting in a compute mode (decode_block=True for
  'block on''s: a block unit in each layer but the first), its attention
  contexts (and the epilogue's outputs) held by OpByOp's rule for a
  compute mode's context rows. The splice settings write each layer's new
  rows into `inputs`' pools on the CPU run; the card's run reads its own
  copies, and the rows written are the ones the kernel splices anyway.
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
          'norm fusion': ('decode/FC int4 norm-fused',),
          'block on': ('decode/BATCH_MATMUL', 'decode/FUSED_BLOCK'),
          'splice': ('decode/BATCH_MATMUL',)}.get(
              MODE_SETTINGS.get(setting, setting), ())
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
      f'beyond 1e-5 {card.epilogue_rows_off}; compute-mode context rows '
      f'beyond 1e-5 {card.mode_rows_off}')
  judge_ids(torch, head, cpu, card, label)
  log(f'{label} ok: the card\'s ids equal the cpu ids in '
      f'{b8 - len(card.id_diffs)} of {b8} rows, cpu top-2 margins '
      f'{[f"{float(m):.2e}" for m in margin]}')
  result = {'worst_rel_err_by_opcode': card.worst,
            'int8_flips_by_opcode': card.flips,
            'id_diffs': len(card.id_diffs), 'block_units': units,
            'int4g_ctx_share_beyond_fine': card.fine_share,
            'epilogue_rows_beyond_1e-5': card.epilogue_rows_off,
            'mode_rows_beyond_1e-5': card.mode_rows_off,
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


# The path of launches_by_path that runs each kernel in a compute mode
# ('{}' the mode), for the kernels line's launches_by_mode.
MODE_PATHS = {
    'decode_attention_int8_lengths_stale': 'bench_decode_attn_{}',
    'fused_mlp_qkv_attention': 'bench_decode_attn_{}',
    'decode_attention_int8_lengths': 'server_attn_{}',
    'decode_attention_int8_masked': f'server_{DEFAULT_MODE}_attn_{{}}',
    'decode_attention_int8_lengths_writeback': 'bench_decode_splice_{}',
    'decode_attention_oproj': 'bench_decode_attn_block_{}'}


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
  from ai_edge_quantizer_tpu_torch.algorithms.uniform import gptq
  from ai_edge_quantizer_tpu_torch.execution import executor
  from ai_edge_quantizer_tpu_torch.execution import model_validator
  from ai_edge_quantizer_tpu_torch.execution import quant_arith
  from ai_edge_quantizer_tpu_torch.graph import ir, serialize
  from ai_edge_quantizer_tpu_torch.kernels import _build
  from ai_edge_quantizer_tpu_torch.kernels import attention, block, cache
  from ai_edge_quantizer_tpu_torch.kernels import head
  from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul
  from ai_edge_quantizer_tpu_torch.kernels import mlp, packed_qmatmul, qkv
  from ai_edge_quantizer_tpu_torch.models import encoder, gemma
  from ai_edge_quantizer_tpu_torch.ops import impl as ops_impl
  from ai_edge_quantizer_tpu_torch.parallel import batching
  from ai_edge_quantizer_tpu_torch.tools import attn_int4_bench
  from ai_edge_quantizer_tpu_torch.utils import progress_utils, test_data
  if any(m == 'jax' or m.startswith(('jax.', 'ai_edge_quantizer_tpu.'))
         or m == 'ai_edge_quantizer_tpu' for m in sys.modules):
    raise AssertionError('the port imported jax or the JAX package')
  port = dict(executor=executor, attention=attention, block=block,
              cache=cache, head=head,
              mlp=mlp, packed_qmatmul=packed_qmatmul, gemma=gemma,
              batching=batching, ops_impl=ops_impl, ir=ir,
              int_qmatmul=int_qmatmul, serialize=serialize, qkv=qkv,
              Quantizer=Quantizer, progress_utils=progress_utils,
              attn_int4_bench=attn_int4_bench, _build=_build,
              encoder=encoder, quant_arith=quant_arith, test_data=test_data,
              gptq=gptq, model_validator=model_validator)
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
  ab = ab_tool_phase(torch, port, kernels, 'cuda')
  for label, r in ab['kernels'].items():
    log(f'A/B tool on {smi}, {label}: {r["ms"]:.3f} ms a chained step of '
        f'{ab["L"]} launches, {r["gbs"]:.1f} GB/s, rel err vs float '
        f'{r["rel_err_vs_float"]:.5f}')
  log(f'phase A/B tool done at {time.monotonic() - t_start:.1f}s')
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
  servers_mode = {}
  for mode in COMPUTE_MODES:
    r = servers_mode[mode] = server_phase(torch, port, kernels, cfg, 'cuda',
                                          attn_compute=mode)
    log(f'server attn {mode} on {smi}: {r["tokens_per_s"]:.1f} tokens/s, '
        f'TTFT p50 {r["ttft_p50_ms"]:.1f} ms p99 {r["ttft_p99_ms"]:.1f} ms')
  log(f'phase server done at {time.monotonic() - t_start:.1f}s')
  kept = {}
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
  for mode in COMPUTE_MODES:
    r = quant[f'{DEFAULT_MODE} attn {mode}']
    log(f'quantized {DEFAULT_MODE} server attn {mode} ({r["layers"]} layers) '
        f'on {smi}: {r["tokens_per_s"]:.1f} tokens/s, TTFT p50 '
        f'{r["ttft_p50_ms"]:.1f} ms p99 {r["ttft_p99_ms"]:.1f} ms; chunk of '
        f'{SERVE_CHUNK} ticks {r["chunk_ms"]:.3f} ms (idle '
        f'{r["chunk_idle_share"]:.3f})')
  # #18, #17 and #16 in a chunk of ticks of the servers that run them.
  by_kernel = {k['name']: k for k in kernels}
  for name, fn, labels in (
      ('decode_attention_int8_dynlen', 'dynlen_attention_kernel',
       (BLOCKWISE_MODE,)),
      ('qmatmul_int_weights', 'int_weights', ('gemma_mixed48_b32',)),
      ('decode_attention_int8_masked', 'masked_attention_kernel',
       (DEFAULT_MODE,) + tuple(f'{DEFAULT_MODE} attn {m}'
                               for m in COMPUTE_MODES if m != 'f32'))):
    for label in labels:
      ms = sum(t for kname, t in quant[label]['chunk_by_kernel'].items()
               if fn in kname)
      by_kernel[name].setdefault('chunk_device_ms', {})[label] = ms
      log(f'{name} in the {label} server on {smi}: {ms:.3f} ms of device '
          f'time a chunk of {SERVE_CHUNK} ticks')
  # #7 and #10 likewise in the int8 servers (each compute mode) and the
  # int4g server.
  for name, fn, runs in (
      ('decode_attention_int8_lengths', 'lengths_attention',
       {'server': server, **{f'server attn {m}': r
                             for m, r in servers_mode.items()}}),
      ('decode_attention_int4_group_lengths', 'int4_group_attention',
       {'server int4g': server4})):
    for label, r in runs.items():
      ms = sum(t for kname, t in r['chunk_by_kernel'].items() if fn in kname)
      by_kernel[name].setdefault('chunk_device_ms', {})[label] = ms
      log(f'{name} in the {label} on {smi}: {ms:.3f} ms of device time a '
          f'chunk of {SERVE_CHUNK} ticks')
  log(f'phase quantizer done at {time.monotonic() - t_start:.1f}s')
  srq = static_range_phase(torch, port, kernels, 'cuda', kept)
  log(f'static range on {smi}: encoder {srq["layers"]} layers, batch '
      f'{srq["batch"]}, T {srq["seq_len"]}: int8 {srq["seqs_per_s"]:.1f} '
      f'seqs/s; calibrate {srq["calibrate_device_stats_s"]:.2f}s '
      f'(device_stats, {ENC_CALIB_SAMPLES} samples) and '
      f'{srq["calibrate_capture_s"]:.2f}s (capture, one); quantize a8w8 '
      f'{srq["quantize_a8w8_s"]:.2f}s, a16w8 {srq["quantize_a16w8_s"]:.2f}s, '
      f'gptq {srq["quantize_gptq_s"]:.2f}s; validate '
      f'{srq["validate_s"]:.2f}s, serving graph {srq["validate_serving_s"]:.2f}s')
  log(f'phase static range done at {time.monotonic() - t_start:.1f}s')
  if args.skip_cpu:
    kept.clear()
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
    for setting, base in MODE_SETTINGS.items():
      bench[f'card_vs_cpu_{setting}'] = cpu_phase(
          torch, port, cfg, 'cuda', decode_block=base == 'block on',
          setting=setting, layers=FUSION_CPU_LAYERS)
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
        'bench_decode_attn_bf16': bench_launches['attn bf16'],
        'bench_decode_attn_int8': bench_launches['attn int8'],
        'bench_decode_splice_bf16': bench_launches['splice bf16'],
        'bench_decode_splice_int8': bench_launches['splice int8'],
        'bench_decode_attn_block_bf16': bench_launches['attn block bf16'],
        'bench_decode_attn_block_int8': bench_launches['attn block int8'],
        'server_attn_bf16': servers_mode['bf16']['launches'][k['name']],
        'server_attn_int8': servers_mode['int8']['launches'][k['name']],
        'ab_tool': entry.pop('launches_ab_tool'),
        'bench_decode_int4g': bench_launches['int4g'],
        'static_range': srq['launches'][k['name']],
        'server_int4g': server4['launches'][k['name']],
        **{f'server_{recipe}': quant[recipe]['launches'][k['name']]
           for recipe in QUANT_RECIPES},
        **{f'server_{DEFAULT_MODE}_attn_{mode}':
           quant[f'{DEFAULT_MODE} attn {mode}']['launches'][k['name']]
           for mode in COMPUTE_MODES}}
    # The count of the path that runs the kernel (the stale kernel runs
    # only in the decode loops: the server's one-hot cache update leaves
    # no row write to fold into attention; the fused block only in the
    # bench decode with the block on; the int4-group attention only on
    # the int4g paths; the int8 DRQ and weight-only kernels only on the
    # quantized graphs' servers; the splice attention and the in-place row
    # write only in the bench decode with those settings; the blockwise
    # matmul and the live-prefix attention only in the blockwise server;
    # the prologue and the epilogue only in the bench decode with the
    # attention block, the norm-fused matmul only with the norm fusion; the
    # per-row int4 attention only in the A/B tool; the basic int8
    # attention on no path, see its 'path').
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
                         or by_path['bench_decode_norm_fusion']
                         or by_path['ab_tool'])
    if k['name'] in MODE_PATHS:
      entry['launches_by_mode'] = {
          mode: by_path[MODE_PATHS[k['name']].format(mode)]
          for mode in COMPUTE_MODES}
      if not all(entry['launches_by_mode'].values()):
        raise AssertionError(f'{k["name"]}: a compute mode never launched: '
                             f'{entry["launches_by_mode"]}')
    entry['kernel_ms'] = entry['ms']
    entry['launches_per_step'] = entry.pop('per_step')
    line.append(entry)
  # #22 alone is on no path (see its 'path'); every other kernel must be.
  missing = [e['name'] for e in line if not e['launches']
             and e['name'] != 'decode_attention_int8']
  if missing:
    raise AssertionError(f'kernels never launched on the main paths: '
                         f'{missing}')
  print(json.dumps({'kernels': line, 'e2e': e2e, 'bench_decode': bench,
                    'bench_decode_int4g': bench4, 'server': server,
                    'server_int4g': server4, 'quantizer': quant,
                    'server_attn_modes': servers_mode, 'ab_tool': ab,
                    'static_range': srq,
                    'card': smi}), flush=True)
  print(smi, flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
