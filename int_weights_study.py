#!/usr/bin/env python3
"""Times of the weight-only integer matmul (#16, int_qmatmul.
qmatmul_int_weights) at chip_smoke.int_weight_kernels' rows, on one NVIDIA
GPU. Prints one JSON line per row.

  python3 int_weights_study.py [--root CHECKOUT] [--reps N] [--variants]

Rows: gemma_mixed48_b32's blockwise-32 FCs at decode (M 64: gate/up N
32768 at K 2048, down N 2048 at K 16384, head N 256128 at K 2048) and at a
prefill pass's rows (M 1024; the head 8 rows), and the channelwise branch
at M 64, N 2048, K 2048 beside torch.matmul on f32 weights; each with bf16
x (as the server passes it) and full-mantissa f32 x. CUDA-event medians as
chip_smoke.Timer takes them (L2 flushed). --root picks the checkout whose
kernel runs (default: this file's), so two checkouts can be timed in turns
on one card, one process each.

--variants times, at the decode rows with bf16 x, copies of this
checkout's csrc/qmatmul_int_weights.cu with one part of the bs-32 decode
loop taken out (wrong results, for the time only; built under
kernels/_build/int_weights_variants/): 'no_flush' (y + p * s left out,
and with it the scale loads), 'no_scale_load' (the block scales a
constant, the flush kept), 'no_widen' (constant A fragments: no
shared-memory read or widening of the weights) and 'stream' (no
widening, no wgmma, no flush: the consumers only release the stages, so
the ring's stream of weight and x tiles alone sets the time); with the
unchanged kernel built the same way, in turns.
"""

import argparse
import json
import pathlib
import sys

B, PREFILL_ROWS, PREFILL_BATCH = 64, 1024, 8
D, F, V, QUANT_BLOCK = 2048, 16384, 256128, 32


# Each variant: exact text of csrc/qmatmul_int_weights.cu and its stand-in.
_FLUSH = ("""    const float scaled = p[r] * s[(r >> 1) & 1];
    y[r] = y[r] + scaled;""", """    if (r == 0) y[r] = y[r] + p[r];""")
_WIDEN = ("""      a_frags(st + XP * G::kX, row, cw, q, a[cw]);""",
          """      for (int e = 0; e < 4; ++e)
        a[cw][e] = 0x3F803F80u ^ (uint32_t)(i & 1);""")
_STREAM = ("""    } else if constexpr (kTwoSums) {""",
           """    } else if constexpr (kTwoSums) {
      mbar_arrive(&empty_bar[s]);
      y[0] = y[0] + s0[0] + s1[1] + (float)st[XP * G::kX + row * kStepK];
    } else if constexpr (kTwoSums && false) {""")
_SCALES = ('''        const float2 v =
            __ldg(reinterpret_cast<const float2*>(srow[u]) + step);
        s0[u] = v.x;
        s1[u] = v.y;''', '''        s0[u] = bias != nullptr ? 0.5f : 0.25f;
        s1[u] = s0[u];''')
VARIANTS = {'kernel': [], 'no_flush': [_FLUSH], 'no_scale_load': [_SCALES],
            'no_widen': [_WIDEN], 'stream': [_WIDEN, _STREAM]}


def build_variants(build):
  """Each variant's shared library, built from a patched copy of csrc/."""
  import shutil
  import subprocess
  out = build.BUILD_DIR / 'int_weights_variants'
  shutil.rmtree(out, ignore_errors=True)
  shutil.copytree(build.CSRC, out / 'csrc')
  source = (out / 'csrc' / 'qmatmul_int_weights.cu').read_text()
  procs = {}
  for name, edits in VARIANTS.items():
    text = source
    for old, new in edits:
      if text.count(old) != 1:
        raise RuntimeError(f'variant {name}: anchor not found once: {old}')
      text = text.replace(old, new)
    src = out / f'{name}.cu'
    src.write_text(text)
    procs[name] = subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, '-I', str(out / 'csrc'), '-o',
         str(out / f'lib{name}.so'), str(src)],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
  for name, proc in procs.items():
    if proc.wait():
      raise RuntimeError(f'variant {name} did not build')
  return {name: out / f'lib{name}.so' for name in VARIANTS}


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--root', default=str(pathlib.Path(__file__).parent))
  parser.add_argument('--reps', type=int, default=25)
  parser.add_argument('--variants', action='store_true')
  args = parser.parse_args()
  import torch
  if not torch.cuda.is_available():
    print('int_weights_study: no CUDA device; nothing was run.',
          file=sys.stderr)
    return 2
  root = pathlib.Path(args.root).resolve()
  sys.path.insert(0, str(root))
  import chip_smoke as cs
  from ai_edge_quantizer_tpu_torch.kernels import _build
  from ai_edge_quantizer_tpu_torch.kernels import int_qmatmul as iq
  _build.SOURCES = ('qmatmul_int_weights',)  # only this kernel is built
  _build.build(_build.SOURCES)
  torch.backends.cuda.matmul.allow_tf32 = False
  timer = cs.Timer(torch)
  gen = torch.Generator(device='cuda').manual_seed(3)
  print(json.dumps({'card': cs.run_text(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader']).splitlines()[0], 'root': str(root)}),
        flush=True)
  if args.variants:
    return variants(torch, cs, _build, iq, timer, gen, args.reps)
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
           'ms': timer(lambda: iq.qmatmul_int_weights(x, w, s, block_size=bs),
                       reps=args.reps),
           'ms_f32_x': timer(lambda: iq.qmatmul_int_weights(
               x32, w, s, block_size=bs), reps=args.reps)}
    if hasattr(iq, 'int_weights_plan'):
      row['launch'] = iq.int_weights_plan(m, n, k, bs, True)
    if not bs:
      wf, xf = w.float(), x.float()
      row['library_ms'] = timer(lambda: torch.matmul(xf, wf.T),
                                reps=args.reps)
      row['library_ms_f32_x'] = timer(lambda: torch.matmul(x32, wf.T),
                                      reps=args.reps)
    print(json.dumps(row), flush=True)
    del x, x32, w, s
  return 0


def variants(torch, cs, build, iq, timer, gen, reps):
  import ctypes
  libs = build_variants(build)
  shapes = (('gate_up', 2 * F, D), ('down', D, F), ('head', V, D))
  data = {}
  for label, n, k in shapes:
    data[label] = (
        torch.randn((B, k), generator=gen, device='cuda').to(torch.bfloat16),
        torch.randint(-8, 8, (n, k), generator=gen, device='cuda').to(
            torch.int8),
        torch.rand((n, k // QUANT_BLOCK), generator=gen, device='cuda') * 0.01
        + 0.005)
  order = list(libs) + list(libs)[::-1]  # in turns
  for name in order:
    lib = ctypes.CDLL(str(libs[name]))
    build.library = lambda _, lib=lib: lib
    row = {'variant': name}
    for label, (x, w, s) in data.items():
      row[label + '_ms'] = timer(
          lambda: iq.qmatmul_int_weights(x, w, s, block_size=QUANT_BLOCK),
          reps=reps)
    print(json.dumps(row), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
