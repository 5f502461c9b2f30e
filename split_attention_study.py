#!/usr/bin/env python3
"""Measurements behind the lengths (#7), stale (#2), splice (#8),
int4-group (#10) and per-row int4 (#21) decode attentions on the split-S
core (csrc/attention_split_tc.cuh), on one NVIDIA GPU. Each prints one
JSON line per measurement.

  python3 split_attention_study.py [--root CHECKOUT] [times] [order] [truth]

times  #7 at the server's tick (B 64, random lengths) and at bench.py's
       decode (B 256, 897 rows), every compute mode, bf16 out; #2 at B 64
       (random lengths, rows 1 and S: chip_smoke's kernel phase) and at
       bench.py's decode (897 long: 896 stale rows), #8 at pos 896 with
       lengths 897 at both batches, every compute mode, bf16 out; #10 at
       bench.py's decode and the server's tick; #21 at the A/B tool's
       shape (B 256, lengths S - 2) and at B 64 with lengths 0..S
       (chip_smoke.int4_row_kernel's inputs), f32 out; CUDA-event medians
       as chip_smoke.Timer takes them (L2 flushed). --root picks the
       checkout whose kernels run (default: this file's), so two checkouts
       can be timed in turns on one card.
order  the share of the plain versions' f32 matmul outputs on the card
       (#7's q . k, #10's q . K and its offset term, #21's two half dots as
       its plain version slices them, #2's one-column q . k_new) equal to
       one f32 FMA chain over the contraction in increasing order; for #2's
       q . k_new also the share equal to the kernel's order
       (new_column_order in the header) at R 1, 64, 65 and 256.
truth  #7's f32 context at B 64 (chip_smoke.lengths_kernel's inputs, eight
       seeds) against an f64 run of the same function, for the plain
       version and the kernel, and the two against each other.
"""

import argparse
import json
import pathlib
import sys

B, S, H, G = 64, 1024, 256, 8
BENCH_B, BENCH_ROWS = 256, 897
K_SCALE, V_SCALE, ZP_K, ZP_V = 0.06, 0.06, 3.0, -2.0


def emit(**row):
  print(json.dumps(row), flush=True)


def times(torch, cs, att):
  timer = cs.Timer(torch)
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


def order(torch, cs, att):
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


def truth(torch, cs, att):
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


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--root', default=str(pathlib.Path(__file__).parent))
  parser.add_argument('studies', nargs='*', default=['times', 'order',
                                                     'truth'])
  args = parser.parse_args()
  import torch
  if not torch.cuda.is_available():
    print('split_attention_study: no CUDA device; nothing was run.',
          file=sys.stderr)
    return 2
  sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
  import chip_smoke as cs
  from ai_edge_quantizer_tpu_torch.kernels import _build
  from ai_edge_quantizer_tpu_torch.kernels import attention as att
  # Only the studied kernels' libraries are built.
  _build.SOURCES = ('attention_lengths', 'attention_stale',
                    'attention_writeback', 'attention_int4_group',
                    'attention_int4_row')
  _build.build(_build.SOURCES)
  torch.backends.cuda.matmul.allow_tf32 = False
  emit(card=cs.run_text(['nvidia-smi', '--query-gpu=name,power.limit',
                         '--format=csv,noheader']).splitlines()[0],
       root=str(pathlib.Path(args.root).resolve()))
  for study in args.studies:
    {'times': times, 'order': order, 'truth': truth}[study](torch, cs, att)
  return 0


if __name__ == '__main__':
  sys.exit(main())
