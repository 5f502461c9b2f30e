#!/usr/bin/env python3
"""Drives the PyTorch port (ai_edge_quantizer_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA device, nvcc (on PATH or /usr/local/cuda/bin) and no network. It
builds the port's CUDA kernels from kernels/csrc at first use, then:

  1. facts: torch.version.cuda, nvcc --version, the card's name and power
     limit (nvidia-smi) and the kernels' build time;
  2. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (Gemma-2B, batch 64, cache 1024, bf16
     activations), with the stated tolerances; CUDA-event medians of the
     kernel, the plain version and, where one PyTorch call computes the
     same contraction or attention, that call (`library_ms`, never used by
     the port); the bound from bytes over 3.35 TB/s or operations over the
     peak rate;
  3. end to end: the Gemma-2B int4 greedy decode graph at batch 64 with an
     int8 KV cache answers 64 requests (8 prompt tokens fed through the
     decode step, then 16 greedy tokens); launch counts per kernel are
     checked against 36 / 18 / 18 / 1 per step;
  4. card against CPU: the same weights and first step at batch 8 with f32
     activations, run op by op on the card from the CPU's values; every op
     must agree within a few f32 ulps and the card's ids must equal the
     port's CPU ids, except rows whose CPU top-2 logit margin is below
     1e-3 relative (see cpu_phase).

Its last lines: the `kernels` JSON line, the nvidia-smi line, and
{"ok": true, "device": {...}}. Any failure raises and exits nonzero.
`--skip-cpu` leaves out phase 4 (for quick runs by hand).
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
B, S = 64, 1024                # main-path batch and cache length
PROMPT, GENERATE = 8, 16


def sync():
  """Wait for the card (set to torch.cuda.synchronize in main)."""


def log(msg):
  print(msg, flush=True)


def run_text(cmd):
  return subprocess.run(cmd, capture_output=True, text=True,
                        check=True).stdout.strip()


def bound(nbytes, ops, ops_rate):
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = ops / ops_rate * 1e3
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

  # 1. int4 DRQ matmul: the fused QKV and the out-projection of a layer.
  by_shape = []
  for label, n in (('qkv', (NQ + 2 * NK) * H), ('out_proj', D)):
    x = randn(B, 1, D)
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
    xq = torch.round(x.reshape(B, D).float() * 10).clamp(-127, 127).to(
        torch.int8)
    w_t = w_q.t()
    lib_ms = timer(lambda: torch._int_mm(xq, w_t))
    nbytes = B * D * 2 + n * D // 2 + n * 4 + B * n * 2
    b_ms, b_by = bound(nbytes, 2 * B * n * D, INT8_OPS_PER_S)
    by_shape.append({
        'shape': label, 'M': B, 'N': n, 'K': D,
        'ms': timer(lambda: pq.qmatmul_int4_packed_drq(x, w, s)),
        'plain_ms': timer(lambda: pq.qmatmul_int4_packed_drq_plain(x, w, s)),
        'library_ms': lib_ms, 'bound_ms': b_ms, 'bound_by': b_by,
        'max_abs_err': err, 'max_bf16_ulps': ulps, 'max_rel_err_f32': rel32})
  mean = lambda key: sum(r[key] for r in by_shape) / len(by_shape)
  results.append({
      'name': 'qmatmul_int4_packed_drq', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/qmatmul_int4_drq.cuh',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py:667',
      'jax': 'pallas_qmatmul.qmatmul_pallas_int4_packed_drq',
      'wrapper': pq.qmatmul_int4_packed_drq, 'per_step': 2 * cfg.num_layers,
      'max_abs_err': max(r['max_abs_err'] for r in by_shape),
      'ms': mean('ms'), 'plain_ms': mean('plain_ms'),
      'bound_ms': mean('bound_ms'), 'bound_by': 'bytes',
      'library_ms': mean('library_ms'),
      'library': 'torch._int_mm on the unpacked int8 weight (contraction '
                 'only)',
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
      'live_rows': live})
  log(f'kernel decode_attention_int8_lengths_stale ok: err {err32}')

  # 3. MLP, DRQ branch, bf = 2048 (the bench's AEQT_MLP_BF).
  bf = min(2048, F // 2)
  x = randn(B, 1, D)
  wgu = pq.pack_int4_split(randint(-8, 8, 2 * F, D))
  sgu = scales(2 * F)
  wd = mlp.pack_int4_split_grouped(randint(-8, 8, D, F), bf)
  sd = scales(D)
  margs = (x, wgu, sgu, wd, sd)
  got = mlp.mlp_int4_packed(*margs, bf=bf)
  want = mlp.mlp_int4_packed_plain(*margs, bf=bf)
  sync()
  err = float(torch.max(torch.abs(got.float() - want.float())))
  ymax = float(torch.max(torch.abs(want.float())))
  # A one-ulp tanh difference may flip one hidden rounding.
  if err > 1e-3 * ymax:
    raise AssertionError(f'mlp: max err {err} vs max |y| {ymax}')
  nbytes = (B * D * 2 + 2 * F * D // 2 + 2 * F * 4 + D * F // 2 + D * 4
            + B * D * 2)
  b_ms, b_by = bound(nbytes, 3 * 2 * B * F * D, INT8_OPS_PER_S)
  results.append({
      'name': 'mlp_int4_packed', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/mlp_int4_drq.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_mlp.py:268',
      'jax': 'pallas_mlp.mlp_pallas_int4_packed (drq=True)',
      'wrapper': mlp.mlp_int4_packed, 'per_step': cfg.num_layers,
      'max_abs_err': err, 'max_abs_y': ymax,
      'ms': timer(lambda: mlp.mlp_int4_packed(*margs, bf=bf)),
      'plain_ms': timer(lambda: mlp.mlp_int4_packed_plain(*margs, bf=bf)),
      'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None})
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
  got = head.head_argmax(*hargs, packed=False)
  want = head.head_argmax_plain(*hargs, packed=False)
  sync()
  mism = int(torch.sum(got != want))
  if mism:
    raise AssertionError(f'head: {mism} ids differ from plain')
  nbytes = B * D * 2 + V * D + V * 4 + B * 4
  b_ms, b_by = bound(nbytes, 2 * B * V * D, INT8_OPS_PER_S)
  results.append({
      'name': 'head_argmax', 'route': 'cuda',
      'source': 'ai_edge_quantizer_tpu_torch/kernels/csrc/head_argmax.cu',
      'replaces': 'ai_edge_quantizer_tpu/kernels/pallas_head.py:169',
      'jax': 'pallas_head.head_argmax_pallas (int8, drq=True)',
      'wrapper': head.head_argmax, 'per_step': 1, 'max_abs_err': 0.0,
      'ms': timer(lambda: head.head_argmax(*hargs, packed=False)),
      'plain_ms': timer(lambda: head.head_argmax_plain(*hargs,
                                                        packed=False)),
      'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None})
  log('kernel head_argmax ok: ids identical (planted tie included)')
  return results


def serve_phase(torch, port, kernels, cfg, dev):
  """64 requests through the decode step of the Gemma-2B int4 graph."""
  gemma, executor = port['gemma'], port['executor']
  S = cfg.max_seq_len
  t0 = time.monotonic()
  graph = gemma.build_decoder(cfg, batch=B, signatures=('decode',),
                              materialize_weights=False,
                              fused_projections=True, greedy_head=True)
  gemma.stamp_int8_kv_cache(graph)
  weights = gemma.device_materialize_quantized(graph, fc_bits=4,
                                               embedding_bits=8, device=dev)
  ex = executor.GraphExecutor(graph, device=dev,
                              activation_dtype='bfloat16')
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
  G = cfg.num_query_heads // cfg.num_kv_heads
  cache_shape = (B, cfg.num_kv_heads, S, cfg.head_dim)
  feed = {}
  for li in range(cfg.num_layers):
    for kind in ('k', 'v'):
      feed[f'layer_{li}_{kind}_cache_in'] = torch.zeros(
          cache_shape, dtype=torch.int8, device=dev)
  iota = torch.arange(S, device=dev)
  steps = PROMPT + GENERATE - 1
  generated = []
  tokens = prompts[:, :1]
  for k in kernels:
    k['wrapper'].launches = 0
    k['wrapper'].plain_calls = 0

  def step(pos, tokens):
    """One decode step at `pos`; the caches carry over in `feed`."""
    feed['tokens'] = tokens
    feed['positions'] = torch.full((B, 1), pos, dtype=torch.int32,
                                   device=dev)
    feed['mask'] = torch.where(iota <= pos, 0.0, -1e9).reshape(
        1, 1, 1, S).expand(B, 1, G, S)
    feed['cache_pos'] = torch.tensor([0, 0, pos, 0], dtype=torch.int32,
                                     device=dev)
    out = ex(feed, 'decode')
    for li in range(cfg.num_layers):
      for kind in ('k', 'v'):
        feed[f'layer_{li}_{kind}_cache_in'] = out[f'layer_{li}_{kind}_cache']
    return out['next_tokens'].reshape(B, 1)

  step_ms = []
  t_start = time.monotonic()
  for pos in range(steps):
    t_step = time.monotonic()
    nxt = step(pos, tokens)
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
    k['launches'] = counts[k['name']]
  steady = statistics.median(step_ms[1:])
  log(f'e2e served {B} requests: {PROMPT} prompt + {GENERATE} generated '
      f'tokens each, {steps} decode steps, ids in [{lo}, {hi}]')
  log(f'e2e launches {counts} (per step: '
      f'{ {k["name"]: k["per_step"] for k in kernels} })')
  log(f'e2e decode: {wall * 1e3 / steps:.3f} ms/step over all steps, '
      f'median {steady:.3f} ms/step after the first; '
      f'{B / steady * 1e3:.1f} tokens/s at batch {B}')
  log(f'e2e first request tokens: {ids[0].tolist()}')
  result = {'ms_per_step': steady, 'tokens_per_s': B / steady * 1e3,
            'ms_per_step_all': wall * 1e3 / steps}
  if dev == 'cuda':
    result.update(profile_steps(torch, lambda pos: step(pos, tokens), steps,
                                steady))
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


def cpu_phase(torch, port, cfg, dev):
  """Same weights, same first step at batch 8, f32: the card against the
  port on the CPU.

  The CPU run keeps every op's output. The card then runs the step op by
  op from those values: each op's inputs are the CPU's, so each op's
  difference is its own. Float outputs must agree to 1e-5 of their largest
  magnitude (CPU and card differ by a few f32 ulps in libm and summation
  order), int8 codes to one step (the float before the rounding may differ
  by an ulp), and the ids exactly, except rows whose CPU top-2 logit
  margin is below 1e-3 relative. A free run of the card follows, reported
  only: there an ulp of one RMS_NORM flips int8 KV codes (per-tensor scale
  0.06) and the flips compound over 18 layers, so its ids may differ.
  """
  gemma, executor, head = port['gemma'], port['executor'], port['head']
  b8 = 8
  graph = gemma.build_decoder(cfg, batch=b8, signatures=('decode',),
                              materialize_weights=False,
                              fused_projections=True, greedy_head=True)
  gemma.stamp_int8_kv_cache(graph)
  weights = gemma.device_materialize_quantized(graph, fc_bits=4,
                                               embedding_bits=8, seed=3,
                                               device=dev)
  inputs = gemma.make_inputs(cfg, 'decode', b8, 1, start_pos=0, seed=3,
                             device='cpu')

  class OpByOp(executor.GraphExecutor):
    """Keeps each op's outputs in `seen`; given `want`, holds each output
    against it and goes on from the wanted value."""
    want = None

    def _store_outputs(self, sg, op, values, env):
      super()._store_outputs(sg, op, values, env)
      for tid in op.outputs:
        if self.want is None:
          self.seen[tid] = env[tid]
          continue
        want, got = self.want[tid], env[tid].cpu()
        if op.opcode == 'ARG_MAX':
          self.ids = got.reshape(-1)
        elif got.is_floating_point():
          err = float(torch.max(torch.abs(got.double() - want.double())))
          rel = err / max(float(torch.max(torch.abs(want.double()))), 1e-30)
          self.worst[op.opcode] = max(self.worst.get(op.opcode, 0.0), rel)
          if rel > 1e-5:
            raise AssertionError(f'{sg.tensors[tid].name}: rel err {rel}')
        else:
          err = int(torch.max(torch.abs(got.long() - want.long())))
          if err > (1 if got.dtype == torch.int8 else 0):
            raise AssertionError(f'{sg.tensors[tid].name}: int err {err}')
        env[tid] = want.to(self.device)

  def executor_on(device, want=None):
    ex = OpByOp(graph, device=device, activation_dtype='float32')
    ex.load_weights(weights)
    ex.prepare_serving_weights(min_weight_params=0)
    ex.seen, ex.worst, ex.want = {}, {}, want
    return ex

  t0 = time.monotonic()
  cpu = executor_on('cpu')
  cpu_ids = cpu(inputs, 'decode')['next_tokens'].reshape(-1)
  log(f'card-vs-cpu: cpu step {time.monotonic() - t0:.1f}s ids '
      f'{cpu_ids.tolist()}')
  (sg_idx, _), fusion = next(iter(cpu._head_fusions.items()))
  logits = head.head_logits_plain(
      cpu.seen[fusion['x']], cpu._weights[(sg_idx, fusion['w_tid'])],
      fusion['scale'], packed=fusion['packed'], true_n=fusion['true_n'])
  top2 = torch.topk(logits, 2, dim=-1).values
  margin = (top2[:, 0] - top2[:, 1]) / torch.clamp_min(
      torch.abs(top2[:, 0]), 1e-30)
  card = executor_on(dev, want=cpu.seen)
  card(inputs, 'decode')
  worst = {k: f'{v:.2e}' for k, v in sorted(card.worst.items())}
  log(f'card-vs-cpu op by op: largest relative error by opcode {worst}')
  for r in range(b8):
    got, want = int(card.ids[r]), int(cpu_ids[r])
    if got != want:
      log(f'card-vs-cpu: row {r} differs (card {got}, cpu {want}), cpu '
          f'top-2 margin {float(margin[r]):.3e}')
      if float(margin[r]) >= 1e-3:
        raise AssertionError(f'row {r} differs with a clear margin')
  log(f'card-vs-cpu ok: ids {card.ids.tolist()}, cpu top-2 margins '
      f'{[f"{float(m):.2e}" for m in margin]}')
  free = executor_on(dev)
  free_ids = free(inputs, 'decode')['next_tokens'].reshape(-1).cpu()
  tids = {t.name: tid for tid, t in enumerate(
      graph.subgraphs[graph.signature_by_key('decode').subgraph_index]
      .tensors)}

  def drift(name):
    got, want = free.seen[tids[name]].cpu().double(), cpu.seen[tids[name]]
    return float(torch.max(torch.abs(got - want.double()))
                 / torch.max(torch.abs(want.double())))

  log(f'card-vs-cpu free run (reported only): ids {free_ids.tolist()}, '
      f'{int(torch.sum(free_ids != cpu_ids))} of {b8} rows differ; largest '
      'relative difference '
      f'{drift("decode/layer_0/attn_residual"):.2e} in layer 0\'s attention '
      f'residual, {drift("decode/final_norm/out"):.2e} at the final norm')


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
  from ai_edge_quantizer_tpu_torch.execution import executor
  from ai_edge_quantizer_tpu_torch.kernels import _build
  from ai_edge_quantizer_tpu_torch.kernels import attention, head, mlp
  from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul
  from ai_edge_quantizer_tpu_torch.models import gemma
  if any(m == 'jax' or m.startswith(('jax.', 'ai_edge_quantizer_tpu.'))
         or m == 'ai_edge_quantizer_tpu' for m in sys.modules):
    raise AssertionError('the port imported jax or the JAX package')
  port = dict(executor=executor, attention=attention, head=head, mlp=mlp,
              packed_qmatmul=packed_qmatmul, gemma=gemma)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

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
  e2e = serve_phase(torch, port, kernels, cfg, 'cuda')
  log(f'e2e on {smi}: {e2e["ms_per_step"]:.3f} ms/step (median), '
      f'{e2e["tokens_per_s"]:.1f} tokens/s at batch {B}')
  if not args.skip_cpu:
    cpu_phase(torch, port, cfg, 'cuda')
  line = []
  for k in kernels:
    entry = {key: v for key, v in k.items() if key != 'wrapper'}
    entry['kernel_ms'] = entry['ms']
    entry['launches_per_step'] = entry.pop('per_step')
    line.append(entry)
  print(json.dumps({'kernels': line, 'e2e': e2e, 'card': smi}), flush=True)
  print(smi, flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
