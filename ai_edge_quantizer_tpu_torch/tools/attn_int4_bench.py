"""Decode-attention A/B at the decode bench's shape: int8 against int4 KV.

The port's counterpart of `scripts/attn_int4_bench.py`. Three formats of
the same K/V rows, each chained L times a step as in a decode step (each
launch's output is the next launch's q; after every L launches the
output is multiplied by 1e-3), ITERS steps:

  int8        attention.decode_attention_int8_lengths (f32 compute)
  int4_row    attention.decode_attention_int4_lengths (per-row scales)
  int4_group  attention.decode_attention_int4_group_lengths (group 16,
              asymmetric K)

Run: python -m ai_edge_quantizer_tpu_torch.tools.attn_int4_bench
     [--device cuda|cpu] [--out FILE]
Env: AEQT_AB_BATCH (256), AEQT_AB_SEQ (1024), AEQT_AB_LAYERS (18),
     AEQT_AB_HEADDIM (256), AEQT_AB_ITERS (16). One KV head, 8 query
     heads a KV head (Gemma-2B's MQA), lengths S - 2.

It prints one JSON artifact on stdout: per format `ms` (the chained step's
time, L launches, from CUDA events), `gbs` (the cache bytes of L launches
over that time: int8 2 B S H, int4_row B S H + 2 B 8 S, int4_group
B S H + 2 B 3 (H / group) S, as the JAX tool counts them) and
`rel_err_vs_float` (one launch on the first q against f32 attention over
the unquantized rows), with `backend` 'cuda' and the card's name. On the
CPU (`--device cpu`, the tests' mode) the wrappers run their plain
versions and no time is taken: `ms` and `gbs` are null. A file is
written only with --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ai_edge_quantizer_tpu_torch.kernels import attention

NK, G, GROUP = 1, 8, 16  # Gemma-2B's MQA; the int4-group sidecar's group


def knobs() -> dict:
  """The JAX tool's environment knobs with its defaults."""
  env = os.environ.get
  return dict(b=int(env('AEQT_AB_BATCH', '256')),
              s=int(env('AEQT_AB_SEQ', '1024')),
              layers=int(env('AEQT_AB_LAYERS', '18')),
              h=int(env('AEQT_AB_HEADDIM', '256')),
              iters=int(env('AEQT_AB_ITERS', '16')))


def make_operands(b: int, s: int, h: int, seed: int = 0,
                  device='cuda') -> dict:
  """The JAX tool's operands, made on `device` from a seeded
  torch.Generator: q ~ N(0, 1), k = 0.3 N + 0.4, v = 0.3 N, lengths S - 2;
  int8 codes at the per-tensor scale absmax / 127, clipped to 127; int4
  per-row codes with the [B, NK, 8, S] bf16 scales; int4 per-group codes
  with the group sidecar."""
  gen = torch.Generator(device=device).manual_seed(seed)

  def normal(*shape):
    return torch.randn(shape, generator=gen, device=device)

  q = normal(b, NK, G, h)
  k = normal(b, NK, s, h) * 0.3 + 0.4
  v = normal(b, NK, s, h) * 0.3
  lengths = torch.full((b,), s - 2, dtype=torch.int32, device=device)
  ks8 = float(torch.max(torch.abs(k))) / 127.0
  vs8 = float(torch.max(torch.abs(v))) / 127.0
  k8 = torch.clamp(torch.round(k / ks8), -127, 127).to(torch.int8)
  v8 = torch.clamp(torch.round(v / vs8), -127, 127).to(torch.int8)
  kp_r, ks_r = attention.quantize_kv_rows_int4(k)
  vp_r, vs_r = attention.quantize_kv_rows_int4(v)
  kp_g, ks_g, km_g = attention.quantize_k_rows_int4_asym(k, GROUP)
  vp_g, vs_g = attention.quantize_v_rows_int4_group(v, GROUP)
  return dict(q=q, k=k, v=v, lengths=lengths, ks8=ks8, vs8=vs8, k8=k8,
              v8=v8, kp_r=kp_r, vp_r=vp_r,
              scales_r=attention.build_kv_scales_rows(ks_r, vs_r),
              kp_g=kp_g, vp_g=vp_g,
              sidecar=attention.build_kv_sidecar_group(ks_g, km_g, vs_g))


def formats(ops: dict, plain: bool = False) -> dict:
  """{format: (one launch q -> ctx, cache bytes of one launch)}; with
  plain, the kernels' plain versions (on any device)."""
  b, _, s, h = ops['k'].shape
  lengths = ops['lengths']
  if plain:
    int8_fn = attention.decode_attention_int8_lengths_plain
    row_fn = attention.decode_attention_int4_lengths_plain
    group_fn = attention.decode_attention_int4_group_lengths_plain
  else:
    int8_fn = attention.decode_attention_int8_lengths
    row_fn = attention.decode_attention_int4_lengths
    group_fn = attention.decode_attention_int4_group_lengths
  return {
      'int8': (lambda q: int8_fn(q, ops['k8'], ops['v8'], ops['ks8'],
                                 ops['vs8'], lengths),
               2 * b * NK * s * h),
      'int4_row': (lambda q: row_fn(q, ops['kp_r'], ops['vp_r'],
                                    ops['scales_r'], lengths),
                   b * NK * s * h + 2 * b * NK * 8 * s),
      'int4_group': (lambda q: group_fn(q, ops['kp_g'], ops['vp_g'],
                                        ops['sidecar'], lengths, GROUP),
                     b * NK * s * h + 2 * b * NK * 3 * (h // GROUP) * s),
  }


def chained(fn, q0: torch.Tensor, layers: int, iters: int) -> torch.Tensor:
  """iters steps of `layers` launches, each output the next q, the output
  times 1e-3 after every step (the JAX tool's scan body)."""
  out = q0
  for _ in range(iters):
    for _ in range(layers):
      out = fn(out)
    out = out * 1e-3
  return out


def float_reference(ops: dict) -> torch.Tensor:
  """f32 attention over the unquantized rows, lengths-masked."""
  q, k, v = ops['q'], ops['k'], ops['v']
  s, h = k.shape[2], k.shape[3]
  scores = torch.matmul(q, k.transpose(-1, -2)) / (h ** 0.5)
  pos = torch.arange(s, device=q.device)
  live = pos.reshape(1, 1, 1, s) < ops['lengths'].reshape(-1, 1, 1, 1)
  scores = torch.where(live, scores, -1e30)
  return torch.matmul(torch.softmax(scores, dim=-1), v)


def run(b: int, s: int, layers: int, h: int, iters: int,
        device='cuda') -> dict:
  """The A/B: {'artifact': the JSON artifact, 'outputs': {format: chained
  output}, 'operands': make_operands's}. On CUDA each format is chained
  once to warm up, then timed with CUDA events over one chained call."""
  if device == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('attn_int4_bench: no CUDA device; pass --device cpu '
                       'to run the plain versions.')
  ops = make_operands(b, s, h, device=device)
  on_card = torch.device(device).type == 'cuda'
  ref = float_reference(ops)
  results, outputs = {}, {}
  for label, (fn, nbytes) in formats(ops).items():
    out = chained(fn, ops['q'], layers, iters)
    if not bool(torch.isfinite(out).all()):
      raise AssertionError(f'{label}: the chained output is not finite')
    ms = gbs = None
    if on_card:
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      out = chained(fn, ops['q'], layers, iters)
      end.record()
      torch.cuda.synchronize()
      ms = start.elapsed_time(end) / iters
      gbs = layers * nbytes / (ms * 1e-3) / 1e9
    outputs[label] = out
    one = fn(ops['q']).to(torch.float32)
    rel = float(torch.linalg.norm(one - ref) / torch.linalg.norm(ref))
    results[label] = {'ms': ms, 'gbs': gbs, 'rel_err_vs_float': rel}
  artifact = {'B': b, 'NK': NK, 'G': G, 'H': h, 'S': s, 'L': layers,
              'group': GROUP, 'iters': iters,
              'backend': 'cuda' if on_card else 'cpu',
              'device': (torch.cuda.get_device_name(ops['q'].device)
                         if on_card else 'cpu'),
              'kernels': results}
  return {'artifact': artifact, 'outputs': outputs, 'operands': ops}


def main(argv=None) -> dict:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
  parser.add_argument('--out', default=None,
                      help='also write the artifact to this file')
  args = parser.parse_args(argv)
  result = run(**knobs(), device=args.device)
  artifact = result['artifact']
  if args.out:
    with open(args.out, 'w') as f:
      json.dump(artifact, f, indent=1)
  print(json.dumps(artifact), flush=True)
  return result


if __name__ == '__main__':
  main(sys.argv[1:])
