"""Continuous-batching decode server (PyTorch port).

Port of `ai_edge_quantizer_tpu/parallel/batching.py`. The server serves a
quantized decoder over a fixed pool of batch slots: queued requests are
admitted into free slots (a batched, chunked prefill writes their KV
rows), then one batched decode step advances every active slot per tick;
sequences join and leave the batch without stalling the others. The KV
caches live on the device for the server's lifetime; each slot writes its
own cache row through the model's one-hot cache update.

Differences from the JAX server:
  * No jit and no donation: the decode step, the prefill chain and the
    slot writer are plain methods over the port's eager executor. The slot
    writer updates the cache pool in place where the reference donates it.
  * `step_chunk` runs n executor calls in a Python loop instead of a
    `lax.scan`; the sampled tokens feed the next call on the device, and
    the host syncs once per chunk (plus the deferred first tokens of an
    admission wave, fetched together with the chunk).
  * One `.cpu()` of a stacked tensor per admission wave or chunk stands in
    for `jax.device_get`.
  * The samplers take an explicit `np.random.Generator`.
  * `mesh` is not ported and raises NotImplementedError.
  * A prompt longer than the pool's current cache bucket grows the pool
    before its rows are written (the reference writes first and cuts the
    rows past the bucket; see ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ai_edge_quantizer_tpu_torch.execution import executor as executor_lib
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.models import gemma


def greedy_sampler(logits: np.ndarray) -> int:
  return int(np.argmax(logits))


def make_topk_sampler(k: int = 40, temperature: float = 1.0, *,
                      rng: np.random.Generator):
  """Top-k sampling with temperature (host side, per slot)."""

  def sample(logits: np.ndarray) -> int:
    scaled = logits.astype(np.float64) / max(temperature, 1e-6)
    top = np.argpartition(scaled, -k)[-k:]
    p = np.exp(scaled[top] - scaled[top].max())
    p /= p.sum()
    return int(rng.choice(top, p=p))

  return sample


def make_topp_sampler(p: float = 0.95, temperature: float = 1.0, *,
                      rng: np.random.Generator):
  """Nucleus (top-p) sampling with temperature (host side, per slot)."""

  def sample(logits: np.ndarray) -> int:
    scaled = logits.astype(np.float64) / max(temperature, 1e-6)
    probs = np.exp(scaled - scaled.max())
    probs /= probs.sum()
    order = np.argsort(probs)[::-1]
    csum = np.cumsum(probs[order])
    cutoff = int(np.searchsorted(csum, p)) + 1
    keep = order[:cutoff]
    kp = probs[keep] / probs[keep].sum()
    return int(rng.choice(keep, p=kp))

  return sample


@dataclasses.dataclass
class Request:
  request_id: int
  prompt: np.ndarray          # [T] int32 token ids
  max_new_tokens: int
  generated: list = dataclasses.field(default_factory=list)
  done: bool = False
  status: str = 'queued'      # queued|running|done|cancelled|timeout
  deadline: Optional[float] = None   # absolute time.monotonic() limit
  submitted_at: float = 0.0
  first_token_at: Optional[float] = None
  finished_at: Optional[float] = None


@dataclasses.dataclass
class _Slot:
  request: Optional[Request] = None
  pos: int = 0  # next cache write position

  @property
  def active(self) -> bool:
    return self.request is not None


_CACHE_DTYPES = {'int8': torch.int8, 'uint8': torch.uint8,
                 'bfloat16': torch.bfloat16}


class DecodeServer:
  """Continuous batching over a quantized multi-signature decoder graph."""

  def __init__(
      self,
      graph: ir.Graph,
      cfg: gemma.DecoderConfig,
      batch_slots: int,
      weights: Optional[dict] = None,
      sample_fn: Optional[Callable] = None,
      prefill_batch: int = 1,
      eos_token_id: Optional[int] = None,
      request_timeout_s: Optional[float] = None,
      pack_weights: bool = False,
      mesh=None,
      activation_dtype: str = 'float32',
      admit_budget_groups: Optional[int] = None,
      starvation_age_s: float = 2.0,
      device='cuda',
      executor_options: Optional[dict] = None,
  ):
    """graph must have 'decode' (or 'decode_<bucket>'; batch=batch_slots,
    onehot cache update) and 'prefill' signatures
    (models.gemma.build_serving_decoder).

    weights: {(sg_idx, tid): torch tensor}, e.g. from
    gemma.device_materialize_quantized or gemma.weights_from_numpy.
    pack_weights: convert int4 FC weights to the packed serving layout
    (executor.prepare_serving_weights), which engages the port's kernels.
    admit_budget_groups: cap admissions per tick to this many prefill
    groups; the rest stay queued. None admits everything.
    device: 'cuda' (the default) or 'cpu' (the kernels' plain versions).
    executor_options: keyword arguments of the GraphExecutor (the port's
    form of the JAX server's AEQT_* environment); None keeps its defaults,
    the serving options of bench.py, and
    `executor.JAX_DEFAULT_OPTIONS` gives the JAX executor's default mode
    (weight-only int4, additive-mask decode attention). The serving
    graph's one-hot pool update leaves no cache DUS to fold, so the
    executor's decode block finds no unit in it.

    A graph built with kv_int4_group (int4-per-group KV pools) keeps three
    pools per layer, 'k' and 'v' [B, NK, S, H/2] uint8 and the sidecar 's'
    [B, NK, 3 * H / group, S] bf16; its prefill stays float and the slot
    writer quantizes the prefilled rows into the pools.
    """
    if mesh is not None:
      raise NotImplementedError(
          'DecodeServer(mesh=...): the multi-device server is not ported '
          'yet (ROADMAP.md Queue 1 item 7, multi-device).')
    self._kv_group = int(graph.metadata.get('kv_int4_group', 0))
    self.cfg = cfg
    self.batch_slots = batch_slots
    self.graph = graph
    self._executor = executor_lib.GraphExecutor(
        graph, device=device, activation_dtype=activation_dtype,
        **(executor_options or {}))
    self.device = self._executor.device
    if weights is not None:
      self._executor.load_weights(weights)
    if pack_weights:
      self._executor.prepare_serving_weights()
    self._admit_budget_groups = admit_budget_groups
    # Once the oldest queued request has waited this long, its plan's
    # (possibly partial) group goes ahead of full groups.
    self._starvation_age_s = starvation_age_s
    self._slots = [_Slot() for _ in range(batch_slots)]
    self._queue: collections.deque = collections.deque()
    # Per-plan FIFO buckets, rebuilt lazily after the queue changed
    # outside _admit (submit/cancel/expire).
    self._plan_buckets: Optional[dict] = None
    self._next_id = 0
    self._sample = sample_fn or greedy_sampler
    self._eos = eos_token_id
    self._default_timeout = request_timeout_s
    self.metrics = {
        'tokens_generated': 0,
        'requests_completed': 0,
        'requests_cancelled': 0,
        'requests_timeout': 0,
        'decode_ticks': 0,
        'prefills': 0,
        'prefill_groups': 0,
        'prefill_pad_rows': 0,  # padded (wasted) rows across all groups
        'ttft_sum_s': 0.0,        # time-to-first-token accumulator
        'latency_sum_s': 0.0,     # request end-to-end accumulator
        'bucket_switches': 0,
    }

    # Context-length buckets: one decode signature per bucket; the server
    # runs the smallest one covering the longest active sequence.
    self._buckets = list(graph.metadata.get('decode_buckets', []))
    if self._buckets:
      self._bucket = self._buckets[0]
    else:
      self._bucket = cfg.max_seq_len
    dec_sig = graph.signature_by_key(self._decode_key(self._bucket))
    # Device-side greedy sampling: decode signatures built with
    # greedy_head=True emit `next_tokens`; a tick then fetches B ids.
    self._device_greedy = (
        'next_tokens' in dec_sig.outputs and sample_fn is None)
    if 'next_tokens' in dec_sig.outputs and sample_fn is not None:
      raise ValueError(
          'This serving graph was built with greedy_head=True (decode '
          'emits next_tokens, not logits) — a custom sample_fn cannot '
          'run. Build with greedy_head=False for host-side sampling.')
    graph_batch = graph.subgraphs[dec_sig.subgraph_index].tensors[
        dec_sig.inputs['tokens']].shape[0]
    if graph_batch != batch_slots:
      raise ValueError(
          f'DecodeServer(batch_slots={batch_slots}) does not match the '
          f"graph's decode batch ({graph_batch}); build the serving graph "
          'with the same batch_slots.')
    pre_sig = graph.signature_by_key('prefill')
    pre_tokens_shape = graph.subgraphs[
        pre_sig.subgraph_index].tensors[pre_sig.inputs['tokens']].shape
    self._prefill_batch = pre_tokens_shape[0]
    self._prefill_len = pre_tokens_shape[1]
    if self._prefill_batch > batch_slots:
      raise ValueError(
          f'prefill batch ({self._prefill_batch}) exceeds batch_slots '
          f'({batch_slots}); build the serving graph with '
          'prefill_batch <= batch_slots.')
    self._prefill_device_masks = bool(
        graph.metadata.get('prefill_device_masks'))
    self._prefill_tail_len = int(graph.metadata.get('prefill_tail_len', 0))
    if self._prefill_tail_len and not self._prefill_device_masks:
      raise ValueError('prefill_tail_len requires prefill_device_masks '
                       '(the host mask builder is fixed-T).')
    self._prefill_greedy = 'next_tokens' in pre_sig.outputs
    if self._prefill_greedy and sample_fn is not None:
      raise ValueError(
          'This serving graph was built with prefill_greedy=True (prefill '
          'emits next_tokens, not logits) — a custom sample_fn cannot '
          'run. Build with prefill_greedy=False for host-side sampling.')
    self._head_cols = bool(graph.metadata.get('prefill_head_cols'))
    # Per-request time-to-first-token samples (seconds), appended at each
    # admission.
    self.ttft_log: list = []

    dec_sg = graph.subgraphs[dec_sig.subgraph_index]
    self._cache_dtypes = {}
    kinds = ('k', 'v', 's') if self._kv_group else ('k', 'v')
    for li in range(cfg.num_layers):
      for kind in kinds:
        key = f'layer_{li}_{kind}_cache_in'
        t = dec_sg.tensors[dec_sig.inputs[key]]
        self._cache_dtypes[key] = _CACHE_DTYPES.get(t.dtype, torch.float32)
    self._alloc_caches(self._bucket)
    self._last_tokens = np.zeros((batch_slots, 1), np.int32)
    self._prefill_zero_caches = None

  def _decode_key(self, bucket: int) -> str:
    return f'decode_{bucket}' if self._buckets else 'decode'

  def _scatter_body(self, new_rows: dict, slot_ids: torch.Tensor,
                    valid: torch.Tensor) -> None:
    """Write a prefilled group's cache rows into the slot pool, in place:
    cache[slot_ids] = where(valid, rows, cache[slot_ids]). slot_ids is
    always prefill_batch long; a partial group is padded with distinct
    spare slots whose `valid` is False, which write back their own
    content. With int4-group pools the float rows (all S of them, as the
    reference) are quantized first: packed K and V codes and the bf16
    sidecar."""
    group = self._kv_group
    bp = slot_ids.shape[0]
    for li in range(self.cfg.num_layers):
      rows = {}
      for kind in ('k', 'v'):
        key = f'layer_{li}_{kind}_cache_in'
        sp = self._caches[key].shape[2]
        rows[key] = new_rows[key][:bp, :, :sp, :]
      if group:
        k_key, v_key = f'layer_{li}_k_cache_in', f'layer_{li}_v_cache_in'
        kp, ks, km = attention.quantize_k_rows_int4_asym(rows[k_key], group)
        vp, vs = attention.quantize_v_rows_int4_group(rows[v_key], group)
        rows = {k_key: kp, v_key: vp, f'layer_{li}_s_cache_in':
                attention.build_kv_sidecar_group(ks, km, vs)}
      for key, new in rows.items():
        cache = self._caches[key]
        cur = cache[slot_ids]
        cache[slot_ids] = torch.where(valid[:, None, None, None],
                                      new.to(cache.dtype), cur)

  def _prefill_inputs(self, tok_mat: torch.Tensor, cols: np.ndarray,
                      start: int, span: int) -> dict:
    """Token, position, cache-position and head-column inputs of one
    prefill pass over columns [start, start + span) of the group."""
    dev, bp = self.device, self._prefill_batch
    inputs = {
        'tokens': tok_mat[:, start:start + span],
        'positions': (torch.arange(span, dtype=torch.int32, device=dev)
                      + start).expand(bp, span),
        'cache_pos': torch.tensor([0, 0, start, 0], dtype=torch.int32,
                                  device=dev),
    }
    if self._head_cols:
      # The in-graph head gathers ONE row per request; intermediate chunks
      # compute a 1-row head on garbage and it is ignored.
      inputs['head_cols'] = torch.as_tensor(
          np.clip(cols, 0, span - 1).reshape(bp, 1), device=dev)
    return inputs

  def _passes(self, num_chunks: int, tail: bool) -> list:
    """(start, span, signature key) of each prefill pass of a plan."""
    t = self._prefill_len
    passes = [(c * t, t, 'prefill') for c in range(num_chunks)]
    if tail:
      passes.append((num_chunks * t, self._prefill_tail_len, 'prefill_tail'))
    return passes

  def _prefill_chain(self, num_chunks: int, tail: bool,
                     tok_mat: torch.Tensor, cols: np.ndarray,
                     slot_ids: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """A whole admission group with device masks: every chunk pass, the
    slot-pool scatter and the first-token gather, with no host sync.
    Returns the group's first tokens (or last-row logits) on the device."""
    chunk_caches = self.prefill_zero_caches()
    out = None
    for start, span, sig_key in self._passes(num_chunks, tail):
      inputs = self._prefill_inputs(tok_mat, cols, start, span)
      inputs.update(chunk_caches)
      out = self._executor(inputs, sig_key)
      chunk_caches = {
          f'layer_{li}_{kind}_cache_in': out[f'layer_{li}_{kind}_cache']
          for li in range(self.cfg.num_layers) for kind in ('k', 'v')
      }
    self._scatter_body(chunk_caches, slot_ids, valid)
    return self._first_of(out, cols)

  def _first_of(self, out: dict, cols: np.ndarray) -> torch.Tensor:
    """Each row's first token (or logits row) from the final pass."""
    out_key = 'next_tokens' if self._prefill_greedy else 'logits'
    if self._head_cols:
      return out[out_key][:, 0]
    rows_idx = torch.arange(self._prefill_batch, device=self.device)
    return out[out_key][rows_idx, torch.as_tensor(cols, device=self.device)
                        .to(torch.int64)]

  def _is_sidecar(self, key: str) -> bool:
    return bool(self._kv_group) and key.split('_')[2] == 's'

  def _cache_shape(self, key: str, bucket: int):
    """A pool's shape: [B, NK, S, H], or with int4-group pools [B, NK, S,
    H/2] and the sidecar [B, NK, 3 * H / group, S] (S last)."""
    cfg = self.cfg
    if self._is_sidecar(key):
      return (self.batch_slots, cfg.num_kv_heads,
              3 * (cfg.head_dim // self._kv_group), bucket)
    h = cfg.head_dim // 2 if self._kv_group else cfg.head_dim
    return (self.batch_slots, cfg.num_kv_heads, bucket, h)

  def prefill_zero_caches(self) -> dict:
    """Zero cache inputs shaped and typed from the PREFILL signature's
    tensors (made once; the executor never writes its inputs)."""
    if self._prefill_zero_caches is None:
      sig = self.graph.signature_by_key('prefill')
      sg = self.graph.subgraphs[sig.subgraph_index]
      self._prefill_zero_caches = {}
      for name, tid in sig.inputs.items():
        if not name.endswith('_cache_in'):
          continue
        t = sg.tensors[tid]
        dt = torch.int8 if t.dtype == 'int8' else torch.float32
        self._prefill_zero_caches[name] = torch.zeros(
            tuple(t.shape), dtype=dt, device=self.device)
    return self._prefill_zero_caches

  def _alloc_caches(self, bucket: int) -> None:
    self._caches = {
        key: torch.zeros(self._cache_shape(key, bucket), dtype=dtype,
                         device=self.device)
        for key, dtype in self._cache_dtypes.items()
    }
    self._bucket = bucket

  def _grow_bucket(self, need_len: int) -> None:
    """Pad the cache pool to the smallest bucket covering need_len."""
    if not self._buckets:
      return
    target = next((s for s in self._buckets if s >= need_len),
                  self._buckets[-1])
    if target > self._bucket:
      pad = target - self._bucket
      # S is the pools' third axis and the sidecar's last.
      self._caches = {
          key: torch.nn.functional.pad(
              v, (0, pad) if self._is_sidecar(key) else (0, 0, 0, pad))
          for key, v in self._caches.items()}
      self._bucket = target
      self.metrics['bucket_switches'] += 1

  def _fit_bucket(self, need_len: int) -> None:
    """Grow (pad) or reset the cache pool to cover need_len positions."""
    if not self._buckets:
      return
    target = next((s for s in self._buckets if s >= need_len),
                  self._buckets[-1])
    if target > self._bucket:
      self._grow_bucket(need_len)
    elif target < self._bucket and not any(
        s.active for s in self._slots):
      # Idle: shrink back for the next burst (contents are dead).
      self._alloc_caches(target)
      self.metrics['bucket_switches'] += 1

  def _restart_idle_pool(self) -> None:
    """Pool idle with work queued: restart in the smallest bucket."""
    if (self._buckets and self._queue
        and not any(s.active for s in self._slots)
        and self._bucket != self._buckets[0]):
      self._alloc_caches(self._buckets[0])
      self.metrics['bucket_switches'] += 1

  # -- public API -----------------------------------------------------------

  def max_prompt_len(self) -> int:
    """Longest admissible prompt: whole prefill chunks that fit the cache."""
    S, T = self.cfg.max_seq_len, self._prefill_len
    return S if S % T == 0 else (S // T) * T

  def submit(self, prompt, max_new_tokens: int = 16,
             timeout_s: Optional[float] = None) -> int:
    now = time.monotonic()
    prompt = np.asarray(prompt, np.int32)
    if prompt.size > self.max_prompt_len():
      # A prompt that cannot fit the KV cache is a caller error, not a
      # truncation.
      raise ValueError(
          f'prompt of {prompt.size} tokens exceeds the maximum admissible '
          f'length {self.max_prompt_len()} '
          f'(max_seq_len={self.cfg.max_seq_len}, '
          f'prefill chunk={self._prefill_len}).')
    timeout_s = timeout_s if timeout_s is not None else self._default_timeout
    req = Request(self._next_id, prompt,
                  max_new_tokens, submitted_at=now,
                  deadline=(now + timeout_s) if timeout_s is not None else None)
    self._next_id += 1
    self._queue.append(req)
    self._plan_buckets = None
    return req.request_id

  def cancel(self, request_id: int) -> bool:
    """Cancel a queued or running request; returns whether it was found."""
    for req in list(self._queue):
      if req.request_id == request_id:
        self._queue.remove(req)
        self._plan_buckets = None
        self._finish(req, 'cancelled')
        return True
    for slot in self._slots:
      if slot.active and slot.request.request_id == request_id:
        self._finish(slot.request, 'cancelled')
        slot.request = None
        return True
    return False

  def stats(self) -> dict:
    """Metrics snapshot plus live queue/slot state and derived latencies."""
    done = max(self.metrics['requests_completed'], 1)
    first = max(self.metrics['prefills'], 1)
    return {
        **self.metrics,
        'queue_depth': len(self._queue),
        'slots_active': sum(1 for s in self._slots if s.active),
        'slots_total': self.batch_slots,
        'mean_ttft_s': self.metrics['ttft_sum_s'] / first,
        'mean_request_latency_s': self.metrics['latency_sum_s'] / done,
    }

  def has_work(self) -> bool:
    return bool(self._queue) or any(s.active for s in self._slots)

  def step(self) -> dict:
    """Admit waiting requests, run one batched decode tick.

    Returns {request_id: newly generated token} for this tick.
    """
    self._expire()
    self._restart_idle_pool()
    self._admit()
    active = [i for i, s in enumerate(self._slots) if s.active]
    if not active:
      return {}
    self._fit_bucket(max(self._slots[i].pos for i in active) + 1)
    out = self._executor({**self._decode_inputs(), **self._caches},
                         self._decode_key(self._bucket))
    for key in self._cache_dtypes:
      self._caches[key] = out[key[:-3]]
    if self._device_greedy:
      tokens = out['next_tokens'].cpu().numpy()  # [B, 1] int32
      logits = None
    else:
      logits = out['logits'].to(torch.float32).cpu().numpy()  # [B, 1, V]
    self.metrics['decode_ticks'] += 1
    emitted = {}
    for i in active:
      slot = self._slots[i]
      token = (int(tokens[i, 0]) if logits is None
               else self._sample(logits[i, 0]))
      slot.request.generated.append(token)
      emitted[slot.request.request_id] = token
      self._last_tokens[i, 0] = token
      slot.pos += 1
      self.metrics['tokens_generated'] += 1
      if (
          len(slot.request.generated) >= slot.request.max_new_tokens
          or slot.pos >= self.cfg.max_seq_len
          or (self._eos is not None and token == self._eos)
      ):
        self._finish(slot.request, 'done')
        slot.request = None
        self.metrics['requests_completed'] += 1
    return emitted

  def step_chunk(self, n: int) -> dict:
    """Admit, then run n decode ticks with one host sync.

    The sampled token feeds the next tick on the device, so the host
    syncs once per n tokens. Requires a graph built with greedy_head=True
    and device_masks=True; otherwise it runs n plain step() calls. Slots
    that finish inside the chunk have their surplus tokens discarded
    (their cache writes are masked out by position for any future
    occupant).

    Returns {request_id: [tokens emitted this chunk]}.
    """
    if n <= 1 or not (
        self._device_greedy
        and self.graph.metadata.get('decode_device_masks')):
      merged: dict = {}
      for _ in range(n):
        for rid, tok in self.step().items():
          merged.setdefault(rid, []).append(tok)
      return merged
    self._expire()
    self._restart_idle_pool()
    # Deferred-fetch admission: newly admitted slots join THIS chunk; the
    # wave's first tokens stay on the device (merged into the token input
    # below) and come back with the chunk's fetch.
    pending = self._admit(defer_fetch=True) or []
    active = [i for i, s in enumerate(self._slots) if s.active]
    if not active:
      return {}
    self._fit_bucket(max(self._slots[i].pos for i in active) + n)
    inputs = self._decode_inputs()
    tokens0 = torch.as_tensor(inputs['tokens'], device=self.device)
    positions0 = torch.as_tensor(inputs['positions'], device=self.device)
    for _, (first, ids, valid) in pending:
      tokens0 = self._merge_first(tokens0, first, ids, valid)
    toks = self._run_chunk(self._bucket, n, tokens0, positions0)
    if pending:
      fetched = torch.cat(
          [toks.reshape(-1)] + [first.to(torch.int32).reshape(-1)
                                for _, (first, _, _) in pending]).cpu()
      self._resolve_admissions(
          pending, fetched[toks.numel():].reshape(len(pending), -1).numpy())
      toks = fetched[:toks.numel()].reshape(toks.shape).numpy()
    else:
      toks = toks.cpu().numpy()  # [n, B, 1] int32
    self.metrics['decode_ticks'] += n
    emitted: dict = {}
    for i in active:
      slot = self._slots[i]
      for step_i in range(n):
        if slot.request is None:
          break
        token = int(toks[step_i, i, 0])
        slot.request.generated.append(token)
        emitted.setdefault(slot.request.request_id, []).append(token)
        self._last_tokens[i, 0] = token
        slot.pos += 1
        self.metrics['tokens_generated'] += 1
        if (len(slot.request.generated) >= slot.request.max_new_tokens
            or slot.pos >= self.cfg.max_seq_len
            or (self._eos is not None and token == self._eos)):
          self._finish(slot.request, 'done')
          slot.request = None
          self.metrics['requests_completed'] += 1
    return emitted

  def _run_chunk(self, bucket: int, n: int, tokens: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """n decode ticks, each tick's tokens feeding the next on the device;
    no host sync. Returns the tokens [n, B, 1] int32 on the device."""
    sig_key = self._decode_key(bucket)
    toks = []
    for _ in range(n):
      out = self._executor({'tokens': tokens, 'positions': positions,
                            **self._caches}, sig_key)
      for key in self._cache_dtypes:
        self._caches[key] = out[key[:-3]]
      tokens = out['next_tokens'].to(torch.int32)
      positions = torch.clamp_max(positions + 1, bucket - 1)
      toks.append(tokens)
    return torch.stack(toks)

  def run_to_completion(self, max_ticks: int = 10000) -> None:
    for _ in range(max_ticks):
      if not self.has_work():
        return
      self.step()

  # -- internals ------------------------------------------------------------

  def _finish(self, req: Request, status: str) -> None:
    req.status = status
    req.done = True
    req.finished_at = time.monotonic()
    self.metrics['latency_sum_s'] += req.finished_at - req.submitted_at
    if status == 'cancelled':
      self.metrics['requests_cancelled'] += 1
    elif status == 'timeout':
      self.metrics['requests_timeout'] += 1

  def _expire(self) -> None:
    """Time out queued and running requests past their deadline."""
    now = time.monotonic()
    for req in [r for r in self._queue
                if r.deadline is not None and now > r.deadline]:
      self._queue.remove(req)
      self._plan_buckets = None
      self._finish(req, 'timeout')
    for slot in self._slots:
      if (slot.active and slot.request.deadline is not None
          and now > slot.request.deadline):
        self._finish(slot.request, 'timeout')
        slot.request = None

  def _plan_of(self, req: Request) -> tuple:
    """(full chunks, tail pass?) of a prompt."""
    full, rem = divmod(req.prompt.size, self._prefill_len)
    if rem == 0 and full > 0:
      return (full, False)
    if self._prefill_tail_len and 0 < rem <= self._prefill_tail_len:
      # The final partial chunk pads only to the short tail program.
      return (full, True)
    return (full + 1, False)

  def _admit(self, defer_fetch: bool = False):
    """Admit queued requests into free slots.

    Admissions are grouped by prefill chunk plan and prefilled up to
    prefill_batch requests per pass; every group's first-token fetch is
    deferred to ONE host sync at the end of the wave (or, with
    defer_fetch, to the fetch of the chunk that follows).
    """
    if not self._queue:
      return
    free = [i for i, s in enumerate(self._slots) if not s.active]
    if not free:
      return
    cap = len(free)
    Bp = self._prefill_batch
    if self._admit_budget_groups:
      cap = min(cap, self._admit_budget_groups * Bp)
    plan_of = self._plan_of

    # Plan-aware selection: full groups, oldest plan first; the remaining
    # capacity in as few partial groups as possible, the oldest waiter's
    # plan first, then the largest leftover. An aged request (waited past
    # starvation_age_s) goes first, with its plan's group.
    if self._plan_buckets is None:
      buckets: dict = {}
      for req in self._queue:  # deque iteration preserves FIFO order
        buckets.setdefault(plan_of(req), []).append(req)
      self._plan_buckets = buckets
    buckets = self._plan_buckets
    chosen: list = []
    oldest = self._queue[0]
    if (self._starvation_age_s is not None
        and time.monotonic() - oldest.submitted_at
        > self._starvation_age_s):
      b = buckets[plan_of(oldest)]
      take = min(len(b), Bp, cap)
      chosen.extend(b[:take])
      del b[:take]
    for plan in sorted(
        (p for p in buckets if buckets[p]),
        key=lambda p: buckets[p][0].request_id):
      b = buckets[plan]
      while len(b) >= Bp and len(chosen) + Bp <= cap:
        chosen.extend(b[:Bp])
        del b[:Bp]
    oldest_id = min(r.request_id for r in self._queue)
    leftover = sorted(
        (p for p in buckets if buckets[p]),
        key=lambda p: (buckets[p][0].request_id != oldest_id,
                       -len(buckets[p])))
    for plan in leftover:
      if len(chosen) >= cap:
        break
      b = buckets[plan]
      take = min(len(b), cap - len(chosen))
      chosen.extend(b[:take])
      del b[:take]
    if not chosen:
      return
    for plan in [p for p, b in buckets.items() if not b]:
      del buckets[plan]
    chosen_ids = set(id(r) for r in chosen)
    self._queue = collections.deque(
        r for r in self._queue if id(r) not in chosen_ids)
    by_plan: dict = {}
    for si, req in zip(free, chosen):
      by_plan.setdefault(plan_of(req), []).append((si, req))
    pending = []
    for plan in sorted(by_plan):
      group = by_plan[plan]
      for g0 in range(0, len(group), Bp):
        part = group[g0:g0 + Bp]
        pending.append((part, self._prefill_group(part, *plan)))
    if defer_fetch and self._prefill_greedy:
      # Deferred resolution (step_chunk): the slots are occupied now and
      # join this chunk's decode; the first-token values stay on the
      # device and resolve with the chunk's fetch.
      for slot_reqs, _ in pending:
        for slot_idx, req in slot_reqs:
          slot = self._slots[slot_idx]
          slot.request = req
          slot.pos = req.prompt.size
          req.status = 'running'
          self._last_tokens[slot_idx, 0] = 0  # value arrives at resolve
      return pending
    self._finalize_admissions(pending)
    return []

  def _prefill_group(self, slot_reqs, num_chunks: int,
                     tail: bool = False):
    """Prefill up to prefill_batch requests in one batched pass per chunk.

    All rows share the chunk start (requests are grouped by chunk plan),
    so the DUS cache write position is one (4,) vector for the group.
    Chunked prompts thread each pass's output caches into the next pass.
    With `tail`, the final partial chunk runs the short 'prefill_tail'
    program. Returns (first tokens or last-row logits on the device, slot
    ids, valid flags); the host sync happens once per admission wave.
    """
    T, Bp = self._prefill_len, self._prefill_batch
    tail_len = self._prefill_tail_len if tail else 0
    n = len(slot_reqs)
    self.metrics['prefill_groups'] += 1
    self.metrics['prefill_pad_rows'] += Bp - n
    total_cap = num_chunks * T + tail_len
    tok_np = np.zeros((Bp, total_cap), np.int32)
    for r, (_, req) in enumerate(slot_reqs):
      tok_np[r, :req.prompt.size] = req.prompt
    tok_mat = torch.as_tensor(tok_np, device=self.device)
    # Each row's first-token position within the FINAL chunk.
    last_start = num_chunks * T if tail else (num_chunks - 1) * T
    cols = np.zeros(Bp, np.int32)
    for r, (_, req) in enumerate(slot_reqs):
      cols[r] = (req.prompt.size - 1) - last_start
    group_ids = [si for si, _ in slot_reqs]
    if n < Bp:
      spares = [i for i in range(self.batch_slots) if i not in group_ids]
      group_ids = group_ids + spares[:Bp - n]
    valid_np = np.zeros(Bp, bool)
    valid_np[:n] = True
    slot_ids = torch.as_tensor(np.asarray(group_ids, np.int64),
                               device=self.device)
    valid = torch.as_tensor(valid_np, device=self.device)
    ids_arr = np.asarray(group_ids, np.int32)
    # The pool must hold every prompt row before the rows are written.
    self._grow_bucket(max(req.prompt.size for _, req in slot_reqs) + 1)
    if self._prefill_device_masks:
      first = self._prefill_chain(num_chunks, tail, tok_mat, cols, slot_ids,
                                  valid)
      return first, ids_arr, valid_np
    chunk_caches = self.prefill_zero_caches()
    out = None
    for start, span, sig_key in self._passes(num_chunks, tail):
      inputs = self._prefill_inputs(tok_mat, cols, start, span)
      inputs['mask'] = self._host_prefill_mask(slot_reqs, start)
      inputs.update(chunk_caches)
      out = self._executor(inputs, sig_key)
      chunk_caches = {
          f'layer_{li}_{kind}_cache_in': out[f'layer_{li}_{kind}_cache']
          for li in range(self.cfg.num_layers) for kind in ('k', 'v')
      }
    self._scatter_body(chunk_caches, slot_ids, valid)
    return self._first_of(out, cols), ids_arr, valid_np

  def _host_prefill_mask(self, slot_reqs, start: int) -> np.ndarray:
    """Host-built additive mask for graphs without prefill device masks:
    causal over positions, with each row's padded-key columns hidden."""
    cfg, T, Bp = self.cfg, self._prefill_len, self._prefill_batch
    G = cfg.num_query_heads // cfg.num_kv_heads
    S = cfg.max_seq_len
    mask = np.full((Bp, 1, G * T, S), -1e9, np.float32)
    for t in range(T):
      limit = start + t + 1
      for g in range(G):
        mask[:, :, g * T + t, :limit] = 0.0
    for r, (_, req) in enumerate(slot_reqs):
      if req.prompt.size < start + T:
        # Hide padded-key columns even from padded rows (garbage K values
        # must not leak into softmax numerics).
        mask[r, :, :, req.prompt.size:start + T] = -1e9
    return mask

  def _merge_first(self, tokens: torch.Tensor, first: torch.Tensor,
                   slot_ids: np.ndarray, valid: np.ndarray) -> torch.Tensor:
    """Scatter one admission group's first tokens into the chunk's [B, 1]
    token input, on the device. Padded rows carry distinct spare slot ids
    with valid=False and write the slot's current token back."""
    ids = torch.as_tensor(slot_ids.astype(np.int64), device=self.device)
    keep = torch.as_tensor(valid, device=self.device)
    cur = tokens[ids, 0]
    tokens = tokens.clone()
    tokens[ids, 0] = torch.where(keep, first.to(torch.int32), cur)
    return tokens

  def _resolve_admissions(self, pending, fetched) -> None:
    """Deferred-fetch bookkeeping: the admitted slots already decoded in
    the chunk that just ran; record their first tokens. Requests done at
    prefill discard the chunk's surplus tokens like mid-chunk
    completions."""
    for (slot_reqs, _), arr in zip(pending, fetched):
      for r, (slot_idx, req) in enumerate(slot_reqs):
        slot = self._slots[slot_idx]
        if slot.request is not req:  # cancelled/expired before resolve
          continue
        first_token = int(arr[r])
        req.generated.append(first_token)
        req.first_token_at = time.monotonic()
        ttft = req.first_token_at - req.submitted_at
        self.metrics['ttft_sum_s'] += ttft
        self.ttft_log.append(ttft)
        self.metrics['prefills'] += 1
        self.metrics['tokens_generated'] += 1
        self._last_tokens[slot_idx, 0] = first_token
        if (len(req.generated) >= req.max_new_tokens
            or req.prompt.size >= self.cfg.max_seq_len
            or (self._eos is not None and first_token == self._eos)):
          self._finish(req, 'done')
          slot.request = None
          self.metrics['requests_completed'] += 1

  def _finalize_admissions(self, pending) -> None:
    """One host sync for the whole admission wave, then bookkeeping."""
    if not pending:
      return
    fetched = torch.stack([arr for _, (arr, _, _) in pending]).cpu()
    if not self._prefill_greedy:
      fetched = fetched.to(torch.float32)
    fetched = fetched.numpy()
    for (slot_reqs, _), arr in zip(pending, fetched):
      for r, (slot_idx, req) in enumerate(slot_reqs):
        first_token = (int(arr[r]) if self._prefill_greedy
                       else self._sample(arr[r]))
        req.generated.append(first_token)
        req.status = 'running'
        req.first_token_at = time.monotonic()
        ttft = req.first_token_at - req.submitted_at
        self.metrics['ttft_sum_s'] += ttft
        self.ttft_log.append(ttft)
        self.metrics['prefills'] += 1
        self.metrics['tokens_generated'] += 1
        slot = self._slots[slot_idx]
        slot.request = req
        slot.pos = req.prompt.size
        self._last_tokens[slot_idx, 0] = first_token
        if (len(req.generated) >= req.max_new_tokens
            or slot.pos >= self.cfg.max_seq_len
            or (self._eos is not None and first_token == self._eos)):
          # Done at prefill: satisfied (or the cache is full) before any
          # decode tick.
          self._finish(req, 'done')
          slot.request = None
          self.metrics['requests_completed'] += 1

  def _decode_inputs(self) -> dict:
    cfg = self.cfg
    B, S = self.batch_slots, self._bucket
    G = cfg.num_query_heads // cfg.num_kv_heads
    positions = np.zeros((B, 1), np.int32)
    for i, slot in enumerate(self._slots):
      if slot.active:
        positions[i, 0] = slot.pos
    inputs = {
        'tokens': self._last_tokens.copy(),
        'positions': positions,
    }
    if self.graph.metadata.get('decode_device_masks'):
      # Mask and one-hot derive from positions in the graph: only 2 tiny
      # int32 arrays cross to the device per tick.
      return inputs
    onehot = np.zeros((B, 1, S, 1), np.float32)
    mask = np.full((B, 1, G, S), -1e9, np.float32)
    for i, slot in enumerate(self._slots):
      if not slot.active:
        continue
      onehot[i, 0, slot.pos, 0] = 1.0
      mask[i, :, :, :slot.pos + 1] = 0.0
    inputs['mask'] = mask
    inputs['cache_onehot'] = onehot
    return inputs
