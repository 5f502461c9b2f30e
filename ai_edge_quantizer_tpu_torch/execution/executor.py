"""Graph executor of the port: runs a Graph IR signature op by op in torch.

Port of `ai_edge_quantizer_tpu/execution/executor.py`, the parts the
Gemma int4 decode step runs: constant loading, the DEQUANTIZE alias,
`prepare_serving_weights`, `_run_signature` / `_eval_op` /
`_dequant_view` / `_store_outputs`, the int8 DYNAMIC_UPDATE_SLICE fast
path, the packed int4 DRQ FC, and three fusions with their dispatch:
stale-cache attention with the cache write outside the kernel, the GeGLU
MLP and the greedy head. The block, norm, QKV, attention-epilogue and
MoE fusions, capture mode, the calibration runners and the SRQ integer
paths are not ported yet.

Differences from the JAX executor:
  * Options are constructor arguments, not environment variables, with
    the same meanings: `int4_drq` (AEQT_INT4_DRQ), `attn_lengths`
    (AEQT_ATTN_LENGTHS), `attn_writeback` (AEQT_ATTN_WRITEBACK=1 with
    AEQT_ATTN_WRITEBACK_MODE; None turns it off), `mlp_fusion` and `mlp_bf`
    (AEQT_MLP_FUSION, AEQT_MLP_BF), `head_fusion` (AEQT_HEAD_FUSION).
    Defaults are the values bench.py sets, with the decode block off.
  * PyTorch runs eagerly: there is no jit, and a step makes no host sync
    (scales that are IR constants stay Python floats).
  * Where the JAX executor asks "is the backend a TPU" before a Pallas
    kernel, the port asks nothing: every ported kernel's wrapper launches
    its CUDA kernel for a CUDA tensor and runs its plain version for a CPU
    tensor, so the CPU tests run the same dispatch as the card. The
    Mosaic tiling gates (head dim and cache length multiples of 128) are
    replaced by what each CUDA kernel takes.
  * On CUDA, an op whose JAX path would reach a Pallas kernel that is not
    ported yet raises NotImplementedError naming that kernel; it never
    runs as plain torch on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ai_edge_quantizer_tpu_torch.execution import quant_arith
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.kernels import head as head_lib
from ai_edge_quantizer_tpu_torch.kernels import mlp as mlp_lib
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import qmatmul as qmm
from ai_edge_quantizer_tpu_torch.ops import impl as ops_impl


# Operand positions that carry graph structure (shapes, axes, strides,
# split counts) rather than data; see _eval_op.
_STRUCTURAL_OPERANDS = {
    'RESHAPE': (1,),
    'TRANSPOSE': (1,),
    'SLICE': (1, 2),
    'BROADCAST_TO': (1,),
    'SUM': (1,),
    'REDUCE_MIN': (1,),
}


def _unported(kernel: str):
  return NotImplementedError(
      f'The Pallas kernel {kernel} is not ported to CUDA yet; this op '
      'would run it on the card.')


def _to_device(value, device) -> torch.Tensor:
  if isinstance(value, torch.Tensor):
    return value.to(device)
  return torch.as_tensor(np.asarray(value), device=device)


class GraphExecutor:
  """Executes Graph signatures op by op on one torch device."""

  def __init__(self, graph: ir.Graph, device='cuda',
               activation_dtype: str = 'bfloat16',
               use_fused_kernels: bool = True,
               int4_drq: bool = True,
               attn_lengths: bool = True,
               attn_writeback: Optional[str] = 'stale',
               mlp_fusion: bool = True,
               mlp_bf: int = 2048,
               head_fusion: bool = True):
    """activation_dtype: 'bfloat16' (serving mode, the bench's setting) or
    'float32' (bit-faithful to the offline pipeline). attn_writeback:
    'stale', 'splice' or None."""
    self.device = torch.device(device)
    if self.device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError(
          'GraphExecutor: device cuda requested but no CUDA device is '
          "available; pass device='cpu' to run the plain versions.")
    if attn_writeback not in (None, 'stale', 'splice'):
      raise ValueError(f'attn_writeback={attn_writeback!r}')
    self.graph = graph
    self.use_fused_kernels = use_fused_kernels
    self.int4_drq = int4_drq
    self.attn_lengths = attn_lengths
    self.attn_writeback = attn_writeback
    self.mlp_fusion = mlp_fusion
    self.mlp_bf = mlp_bf
    self.head_fusion = head_fusion
    self._act_dtype = quant_arith.STORAGE_TORCH_DTYPES[activation_dtype]
    # Constant tensors, keyed (subgraph_idx, tensor_id), in storage dtype.
    self._weights: dict = {}
    for sg_idx, sg in enumerate(graph.subgraphs):
      for tid, t in enumerate(sg.tensors):
        if t.buffer >= 0 and graph.buffers[t.buffer].data is not None:
          data = np.asarray(graph.buffers[t.buffer].data).reshape(t.shape)
          dtype = quant_arith.storage_dtype_of(t)
          if dtype == torch.int64:
            dtype = torch.int32  # as the JAX executor without x64
          self._weights[(sg_idx, tid)] = torch.as_tensor(
              data, device=self.device).to(dtype)
    # Keys of FC weights converted to packed-int4 serving layout
    # (uint8 [N, K//2], split-half; see kernels/packed_qmatmul.py).
    self._packed_int4_keys: set = set()
    self._packed_pad_n: dict = {}  # key -> true N (packed weight N-padded)
    self._packed_scale: dict = {}  # key -> padded per-channel scale
    self._packed_block_size: dict = {}  # key -> block size (blockwise int4)
    self._mlp_fusions: dict = {}
    self._mlp_skip: set = set()
    self._head_fusions: dict = {}
    self._head_skip: set = set()
    # Weight-only fusion: FC consuming the DEQUANTIZE of a constant integer
    # weight reads the integer tensor directly.
    self._dequant_alias: dict = {}
    self._find_dequant_aliases()
    self._attn_fusions: dict = {}
    self._attn_skip: set = set()
    # Per-channel IR params as device tensors, copied once.
    self._const_cache: dict = {}
    if use_fused_kernels:
      for sg_idx, sg in enumerate(graph.subgraphs):
        self._find_attention_fusions(sg_idx, sg)

  def load_weights(self, weights: dict) -> None:
    """Replace the weight dict {(sg_idx, tid): tensor} (e.g. from
    models.gemma.device_materialize_quantized), on this device."""
    self._weights = {k: v.to(self.device) for k, v in weights.items()}
    self._find_dequant_aliases()

  def _find_dequant_aliases(self) -> None:
    self._dequant_alias = {}
    for sg_idx, sg in enumerate(self.graph.subgraphs):
      for op in sg.ops:
        if op.opcode != 'DEQUANTIZE' or not op.inputs or not op.outputs:
          continue
        src = sg.tensors[op.inputs[0]]
        if (
            src.quantization is not None
            and src.dtype in ('int2', 'int4', 'int8')
            and (sg_idx, op.inputs[0]) in self._weights
        ):
          self._dequant_alias[(sg_idx, op.outputs[0])] = op.inputs[0]

  # -- fusion finders (pure IR pattern matching, as in the JAX executor) ---

  def _find_attention_fusions(self, sg_idx: int, sg: ir.Subgraph) -> None:
    """Producer-chasing match of BMM->MUL->ADD->SOFTMAX->BMM over int8
    caches (DEQUANTIZE ops inserted by the rewrite are looked through)."""
    ops = sg.ops
    producer_of = {}
    for i, o in enumerate(ops):
      for tid in o.outputs:
        producer_of[tid] = i

    def consumers_of(tid):
      return [i for i, o in enumerate(ops) if tid in o.inputs]

    def int8_per_tensor_cache(tid):
      t = sg.tensors[tid]
      q = t.quantization
      return (
          t.dtype == 'int8' and q is not None and q.block_size == 0
          and np.asarray(q.scale).size == 1
          and np.asarray(q.zero_point).size == 1
          and len(t.shape) == 4
      )

    def cache_source(tid):
      p = producer_of.get(tid)
      if p is not None and ops[p].opcode == 'DEQUANTIZE':
        src = ops[p].inputs[0]
        if int8_per_tensor_cache(src):
          return src
      if int8_per_tensor_cache(tid):
        return tid
      return None

    for sm_idx, sm in enumerate(ops):
      if sm.opcode != 'SOFTMAX':
        continue
      add_idx = producer_of.get(sm.inputs[0])
      if add_idx is None or ops[add_idx].opcode != 'ADD':
        continue
      add = ops[add_idx]
      mul_idx = producer_of.get(add.inputs[0])
      if mul_idx is None or ops[mul_idx].opcode != 'MUL':
        continue
      mul = ops[mul_idx]
      bmm1_idx = producer_of.get(mul.inputs[0])
      if bmm1_idx is None or ops[bmm1_idx].opcode != 'BATCH_MATMUL':
        continue
      bmm1 = ops[bmm1_idx]
      if not bmm1.attrs.get('adj_y'):
        continue
      sm_consumers = consumers_of(sm.outputs[0])
      if len(sm_consumers) != 1:
        continue
      bmm2_idx = sm_consumers[0]
      bmm2 = ops[bmm2_idx]
      if (
          bmm2.opcode != 'BATCH_MATMUL' or bmm2.attrs.get('adj_y')
          or bmm2.inputs[0] != sm.outputs[0]
      ):
        continue
      k_tid = cache_source(bmm1.inputs[1])
      v_tid = cache_source(bmm2.inputs[1])
      if k_tid is None or v_tid is None:
        continue
      q_tid = bmm1.inputs[0]
      if len(sg.tensors[q_tid].shape) != 4:
        continue
      scale_t = sg.tensors[mul.inputs[1]]
      scale_data = (
          self.graph.buffers[scale_t.buffer].data
          if scale_t.buffer >= 0 else None)
      if scale_data is None or np.asarray(scale_data).size != 1:
        continue
      mask_tid = add.inputs[1]
      chain_outs = [bmm1.outputs[0], mul.outputs[0], add.outputs[0],
                    sm.outputs[0]]
      if any(len(consumers_of(t)) != 1 or t in sg.outputs
             for t in chain_outs):
        continue
      if any(sg.tensors[t].quantization is not None for t in chain_outs):
        continue
      h = sg.tensors[q_tid].shape[-1]
      fusion = {
          'q': q_tid, 'k': k_tid, 'v': v_tid, 'mask': mask_tid,
          'out': bmm2.outputs[0],
          'k_scale_factor': float(np.asarray(scale_data).reshape(())) *
          float(h) ** 0.5,
      }
      self._attn_fusions[(sg_idx, bmm2_idx)] = fusion
      skip = [bmm1_idx, mul_idx, add_idx, sm_idx]

      def match_cache_dus(cache_tid, chain_idx=(bmm1_idx, bmm2_idx)):
        """The per-step KV row write folds into the attention dispatch
        when the cache tensor is produced by a one-row same-params DUS
        whose pre-update value dies there."""
        p = producer_of.get(cache_tid)
        if p is None or ops[p].opcode != 'DYNAMIC_UPDATE_SLICE':
          return None
        dus = ops[p]
        if len(dus.inputs) < 3:
          return None
        operand_tid, update_tid, starts_tid = dus.inputs[:3]
        if not self._same_int_params(sg, operand_tid, update_tid,
                                     cache_tid):
          return None
        osh = sg.tensors[operand_tid].shape
        ush = sg.tensors[update_tid].shape
        if (len(osh) != 4 or len(ush) != 4 or ush[2] != 1
            or [ush[0], ush[1], ush[3]] != [osh[0], osh[1], osh[3]]):
          return None
        if not self._sole_consumer(sg, operand_tid, dus):
          return None
        extra = []
        for ci in consumers_of(cache_tid):
          if ci in chain_idx:
            continue
          if (ops[ci].opcode == 'DEQUANTIZE'
              and ops[ci].outputs[0] not in sg.outputs
              and all(cj in chain_idx
                      for cj in consumers_of(ops[ci].outputs[0]))):
            extra.append(ci)
            continue
          return None
        return p, extra, {
            'operand': operand_tid, 'update': update_tid,
            'starts': starts_tid, 'out': cache_tid,
        }

      if self.attn_writeback is not None:
        k_wb = match_cache_dus(k_tid)
        v_wb = match_cache_dus(v_tid)
        if k_wb is not None and v_wb is not None:
          fusion['writeback'] = {'k': k_wb[2], 'v': v_wb[2]}
          skip += [k_wb[0], v_wb[0]] + k_wb[1] + v_wb[1]
      for j in skip:
        self._attn_skip.add((sg_idx, j))

  def prepare_serving_weights(self, min_weight_params: int = 2**21) -> None:
    """Convert eligible int4 FC weights to the packed serving layout.

    Symmetric per-channel int4 FC weights with N % 128 == 0 and at least
    `min_weight_params` elements; each buffer packs once and every
    (sg, tid) view of it shares the packed tensor. N pads to a multiple of
    512 unless N % 256 == 0 and N < 65536 (the JAX executor's rule).
    """
    packed_by_buffer: dict = {}
    for sg_idx, sg in enumerate(self.graph.subgraphs):
      fc_weight_tids = {
          op.inputs[1] for op in sg.ops
          if op.opcode == 'FULLY_CONNECTED' and len(op.inputs) > 1
          and op.inputs[1] >= 0
      }
      for tid in fc_weight_tids:
        key = (sg_idx, tid)
        t = sg.tensors[tid]
        if key not in self._weights or key in self._packed_int4_keys:
          continue
        if t.buffer >= 0 and t.buffer in packed_by_buffer:
          packed, scale_arr, pad_n, bs = packed_by_buffer[t.buffer]
          self._weights[key] = packed
          self._packed_scale[key] = scale_arr
          if pad_n is not None:
            self._packed_pad_n[key] = pad_n
          if bs:
            self._packed_block_size[key] = bs
          self._packed_int4_keys.add(key)
          continue
        q = t.quantization
        blockwise_ok = (
            q is not None and q.block_size > 0
            and q.block_size % 128 == 0
            and (t.shape[-1] // q.block_size) % 2 == 0
            and (t.shape[-1] // 2) % q.block_size == 0
        )
        if (
            t.dtype != 'int4' or q is None
            or not (q.block_size == 0 or blockwise_ok)
            or not np.all(np.asarray(q.zero_point) == 0)
            or t.shape[-1] % 2 != 0
            or t.shape[0] % 128 != 0
            or t.num_elements < min_weight_params
        ):
          continue
        packed = packed_qmatmul.pack_int4_split(self._weights[key])
        n = int(t.shape[0])
        if q.block_size > 0:
          nb = int(t.shape[-1]) // q.block_size
          scale = np.asarray(q.scale, np.float32).reshape(n, nb)
          self._packed_block_size[key] = int(q.block_size)
        else:
          scale = np.asarray(q.scale, np.float32).reshape(-1)
        if n % 256 == 0 and n < 65536:
          n_pad = n
        else:
          n_pad = -(-n // 512) * 512
        if n_pad != n:
          packed = torch.nn.functional.pad(packed, (0, 0, 0, n_pad - n))
          pad_spec = ((0, n_pad - n),) + ((0, 0),) * (scale.ndim - 1)
          scale = np.pad(scale, pad_spec)
          self._packed_pad_n[key] = n
        self._weights[key] = packed
        self._packed_scale[key] = torch.tensor(scale, device=self.device)
        self._packed_int4_keys.add(key)
        if t.buffer >= 0:
          packed_by_buffer[t.buffer] = (
              packed, self._packed_scale[key],
              self._packed_pad_n.get(key),
              self._packed_block_size.get(key, 0))
    self._find_mlp_fusions()
    self._find_head_fusions()

  def _sig_out_tids(self) -> set:
    return {(s.subgraph_index, tid)
            for s in self.graph.signatures for tid in s.outputs.values()}

  def _find_mlp_fusions(self) -> None:
    """Fuse the GeGLU FFN chain into one mlp_int4_packed call.

    Patterns (models/gemma.py, both layouts):
      A. FULLY_CONNECTED(gate_up) -> SLICE(gate), SLICE(up)
           -> GELU(gate) -> MUL(gelu, up) -> FULLY_CONNECTED(down)
      B. FULLY_CONNECTED(gate), FULLY_CONNECTED(up) on the same input
           -> GELU(gate) -> MUL(gelu, up) -> FULLY_CONNECTED(down)
    All weights packed channelwise int4 without N padding. The down weight
    is re-packed into the group-split layout under the synthetic tensor id
    -1000 - tid (it replaces the canonical packed form).
    """
    self._mlp_fusions = {}
    self._mlp_skip = set()
    if not self.mlp_fusion:
      return
    bf = self.mlp_bf
    grouped_cache: dict = {}
    concat_cache: dict = {}
    sig_out_tids = self._sig_out_tids()
    for sg_idx, sg in enumerate(self.graph.subgraphs):
      cons: dict = {}
      for oi, o in enumerate(sg.ops):
        for t in o.inputs:
          cons.setdefault(t, []).append((oi, o))
      protected = set(sg.outputs) | {
          tid for (si, tid) in sig_out_tids if si == sg_idx}

      def packed_channelwise(tid, sg_idx=sg_idx):
        key = (sg_idx, tid)
        return (key in self._packed_int4_keys
                and key not in self._packed_block_size
                and self._packed_pad_n.get(key) is None)

      def plain_fc(o):
        return (o.opcode == 'FULLY_CONNECTED' and len(o.inputs) > 1
                and (len(o.inputs) < 3 or o.inputs[2] < 0)
                and o.attrs.get('fused_activation', 'NONE') == 'NONE')

      def grouped_down(wd_key, grouped_key, f):
        """Ensure the grouped down weight exists; False if it cannot."""
        wd_packed = self._weights.get(wd_key)
        if wd_packed is None and grouped_key not in self._weights:
          return False
        if wd_packed is not None and int(wd_packed.shape[1]) * 2 != f:
          return False
        return True

      def make_grouped(wd_key, grouped_key):
        if grouped_key not in self._weights:
          wd_packed = self._weights[wd_key]
          gk = (id(wd_packed), bf)
          if gk not in grouped_cache:
            grouped_cache[gk] = mlp_lib.pack_int4_split_grouped(
                packed_qmatmul.unpack_int4_split(wd_packed), bf)
          self._weights[grouped_key] = grouped_cache[gk]
          del self._weights[wd_key]

      for gu_idx, gu_op in enumerate(sg.ops):
        if not plain_fc(gu_op) or not packed_channelwise(gu_op.inputs[1]):
          continue
        wgu_key = (sg_idx, gu_op.inputs[1])
        wgu = self._weights.get(wgu_key)
        if wgu is None:
          continue
        two_f = int(wgu.shape[0])
        f = two_f // 2
        if f % bf or f // bf < 2:
          continue
        gu_out = gu_op.outputs[0]
        slices = cons.get(gu_out, [])
        if gu_out in protected or len(slices) != 2 or any(
            o.opcode != 'SLICE' for _, o in slices):
          continue
        gate_e = up_e = None
        for oi, o in slices:
          begin = list(o.attrs.get('begin', []))
          if begin and all(b == 0 for b in begin):
            gate_e = (oi, o)
          elif (begin and begin[-1] == f
                and all(b == 0 for b in begin[:-1])):
            up_e = (oi, o)
        if gate_e is None or up_e is None:
          continue
        gate_tid = gate_e[1].outputs[0]
        up_tid = up_e[1].outputs[0]
        if (sg.tensors[gate_tid].shape[-1] != f
            or sg.tensors[up_tid].shape[-1] != f):
          continue
        gcons = cons.get(gate_tid, [])
        if (len(gcons) != 1 or gcons[0][1].opcode != 'GELU'
            or not bool(gcons[0][1].attrs.get('approximate', True))):
          continue
        gelu_idx, gelu_op = gcons[0]
        gact_tid = gelu_op.outputs[0]
        mcons = cons.get(gact_tid, [])
        if len(mcons) != 1 or mcons[0][1].opcode != 'MUL':
          continue
        mul_idx, mul_op = mcons[0]
        if (set(mul_op.inputs) != {gact_tid, up_tid}
            or len(cons.get(up_tid, [])) != 1):
          continue
        prod_tid = mul_op.outputs[0]
        pcons = cons.get(prod_tid, [])
        if len(pcons) != 1 or not plain_fc(pcons[0][1]):
          continue
        down_idx, down_op = pcons[0]
        if (down_op.inputs[0] != prod_tid
            or not packed_channelwise(down_op.inputs[1])):
          continue
        wd_key = (sg_idx, down_op.inputs[1])
        grouped_tid = -1000 - down_op.inputs[1]
        grouped_key = (sg_idx, grouped_tid)
        if not grouped_down(wd_key, grouped_key, f):
          continue
        if any(t in protected for t in
               (gate_tid, up_tid, gact_tid, prod_tid)):
          continue
        make_grouped(wd_key, grouped_key)
        self._mlp_fusions[(sg_idx, gu_idx)] = {
            'x': gu_op.inputs[0],
            'wgu_key': wgu_key,
            'wd_key': wd_key,
            'wd_grouped_tid': grouped_tid,
            'out': down_op.outputs[0],
            'bf': bf,
            'act': 'gelu',
        }
        for oi in (gate_e[0], up_e[0], gelu_idx, mul_idx, down_idx):
          self._mlp_skip.add((sg_idx, oi))

      # Pattern B: separate gate / up projections on the same input.
      prods: dict = {}
      for oi, o in enumerate(sg.ops):
        for t in o.outputs:
          prods[t] = (oi, o)
      for gelu_idx, gelu_op in enumerate(sg.ops):
        if (sg_idx, gelu_idx) in self._mlp_skip:
          continue
        if (gelu_op.opcode != 'GELU'
            or not bool(gelu_op.attrs.get('approximate', True))):
          continue
        gate_tid = gelu_op.inputs[0]
        ge = prods.get(gate_tid)
        if (ge is None or not plain_fc(ge[1])
            or not packed_channelwise(ge[1].inputs[1])
            or len(cons.get(gate_tid, [])) != 1):
          continue
        gate_idx, gate_op = ge
        gact_tid = gelu_op.outputs[0]
        mcons = cons.get(gact_tid, [])
        if len(mcons) != 1 or mcons[0][1].opcode != 'MUL':
          continue
        mul_idx, mul_op = mcons[0]
        others = [t for t in mul_op.inputs if t != gact_tid]
        if len(others) != 1:
          continue
        up_tid = others[0]
        ue = prods.get(up_tid)
        if (ue is None or not plain_fc(ue[1])
            or not packed_channelwise(ue[1].inputs[1])
            or ue[1].inputs[0] != gate_op.inputs[0]
            or len(cons.get(up_tid, [])) != 1):
          continue
        up_idx, up_op = ue
        f = sg.tensors[gate_tid].shape[-1]
        if (sg.tensors[up_tid].shape[-1] != f or f % bf or f // bf < 2):
          continue
        prod_tid = mul_op.outputs[0]
        pcons = cons.get(prod_tid, [])
        if len(pcons) != 1 or not plain_fc(pcons[0][1]):
          continue
        down_idx, down_op = pcons[0]
        if (down_op.inputs[0] != prod_tid
            or not packed_channelwise(down_op.inputs[1])):
          continue
        if any(t in protected for t in
               (gate_tid, up_tid, gact_tid, prod_tid)):
          continue
        gw_key = (sg_idx, gate_op.inputs[1])
        uw_key = (sg_idx, up_op.inputs[1])
        if gw_key == uw_key:
          continue
        wd_key = (sg_idx, down_op.inputs[1])
        synth_tid = -2000 - gate_op.inputs[1]
        synth_key = (sg_idx, synth_tid)
        grouped_tid = -1000 - down_op.inputs[1]
        grouped_key = (sg_idx, grouped_tid)
        gw, uw = self._weights.get(gw_key), self._weights.get(uw_key)
        if gw is None or uw is None:
          if synth_key not in self._weights:
            continue
        elif gw.shape != uw.shape or int(gw.shape[0]) != f:
          continue
        if not grouped_down(wd_key, grouped_key, f):
          continue
        if synth_key not in self._weights:
          ck = (id(gw), id(uw))
          if ck not in concat_cache:
            concat_cache[ck] = (
                torch.cat([gw, uw], dim=0),
                torch.cat([self._packed_scale[gw_key],
                           self._packed_scale[uw_key]]))
          self._weights[synth_key], self._packed_scale[synth_key] = (
              concat_cache[ck])
          del self._weights[gw_key]
          del self._weights[uw_key]
        make_grouped(wd_key, grouped_key)
        first_idx = min(gate_idx, up_idx)
        self._mlp_fusions[(sg_idx, first_idx)] = {
            'x': gate_op.inputs[0],
            'wgu_key': synth_key,
            'wgu_split': (gw_key[1], uw_key[1], f),
            'wd_key': wd_key,
            'wd_grouped_tid': grouped_tid,
            'out': down_op.outputs[0],
            'bf': bf,
            'act': 'gelu',
        }
        for oi in (gate_idx, up_idx, gelu_idx, mul_idx, down_idx):
          if oi != first_idx:
            self._mlp_skip.add((sg_idx, oi))

  def _find_head_fusions(self) -> None:
    """Fuse FC(logits) -> ARG_MAX into one head_argmax call: a plain FC
    whose weight is channelwise packed int4 or symmetric per-channel
    int8, consumed only by ARG_MAX over the last axis."""
    self._head_fusions = {}
    self._head_skip = set()
    if not self.head_fusion:
      return
    sig_out_tids = self._sig_out_tids()
    for sg_idx, sg in enumerate(self.graph.subgraphs):
      cons: dict = {}
      for oi, o in enumerate(sg.ops):
        for t in o.inputs:
          cons.setdefault(t, []).append((oi, o))
      protected = set(sg.outputs) | {
          tid for (si, tid) in sig_out_tids if si == sg_idx}
      for fc_idx, fc_op in enumerate(sg.ops):
        if (fc_op.opcode != 'FULLY_CONNECTED' or len(fc_op.inputs) < 2
            or fc_op.inputs[1] < 0
            or (len(fc_op.inputs) > 2 and fc_op.inputs[2] >= 0)
            or fc_op.attrs.get('fused_activation', 'NONE') != 'NONE'):
          continue
        out_tid = fc_op.outputs[0]
        if out_tid in protected:
          continue
        consumers = cons.get(out_tid, [])
        if len(consumers) != 1 or consumers[0][1].opcode != 'ARG_MAX':
          continue
        am_idx, am_op = consumers[0]
        rank = len(sg.tensors[out_tid].shape)
        axis = int(am_op.attrs.get('axis', -1))
        if axis not in (-1, rank - 1):
          continue
        w_tid = fc_op.inputs[1]
        key = (sg_idx, w_tid)
        if key in self._packed_int4_keys:
          if key in self._packed_block_size:
            continue
          info = {'packed': True, 'true_n': self._packed_pad_n.get(key)}
        else:
          w_t = sg.tensors[w_tid]
          q = w_t.quantization
          if (w_t.dtype != 'int8' or q is None or q.block_size
              or not np.all(np.asarray(q.zero_point) == 0)
              or np.asarray(q.scale).size != sg.tensors[w_tid].shape[0]):
            continue
          info = {'packed': False, 'true_n': None,
                  'scale': torch.tensor(
                      np.asarray(q.scale, np.float32).reshape(-1),
                      device=self.device)}
        info.update(x=fc_op.inputs[0], w_tid=w_tid, out=am_op.outputs[0])
        self._head_fusions[(sg_idx, fc_idx)] = info
        self._head_skip.add((sg_idx, am_idx))

  # -- public API -----------------------------------------------------------

  def __call__(self, inputs: dict,
               signature_key: str = 'serving_default') -> dict:
    """Run one signature: {user input name: array} -> {output name:
    tensor on this device}. Nothing is copied back to the host."""
    sig = self.graph.signature_by_key(signature_key)
    return self._run_signature(sig.subgraph_index, signature_key,
                               self._weights, inputs)

  # -- evaluation -----------------------------------------------------------

  def _run_signature(self, sg_idx: int, signature_key: str, weights: dict,
                     inputs: dict) -> dict:
    sig = self.graph.signature_by_key(signature_key)
    sg = self.graph.subgraphs[sg_idx]
    env: dict = {}
    for (w_sg, w_tid), arr in weights.items():
      if w_sg == sg_idx:
        env[w_tid] = arr
    for user_name, tid in sig.inputs.items():
      if user_name not in inputs:
        raise ValueError(
            f'Missing input {user_name!r} for signature {signature_key!r}; '
            f'expected {sorted(sig.inputs)}.')
      t = sg.tensors[tid]
      val = _to_device(inputs[user_name], self.device)
      # Auto-quantize float inputs fed to a quantized input tensor.
      if t.quantization is not None and val.is_floating_point():
        val = quant_arith.quantize(
            val, t.quantization, quant_arith.storage_dtype_of(t))
      elif t.dtype == 'float32' and val.dtype != self._act_dtype:
        val = val.to(self._act_dtype)
      env[tid] = val

    for op_idx, op in enumerate(sg.ops):
      key = (sg_idx, op_idx)
      fusion = self._attn_fusions.get(key)
      if fusion is not None:
        self._eval_fused_attention(sg_idx, sg, fusion, env)
        continue
      mlp = self._mlp_fusions.get(key)
      if mlp is not None:
        self._eval_fused_mlp(sg_idx, sg, mlp, env)
        continue
      head = self._head_fusions.get(key)
      if head is not None:
        self._eval_fused_head(sg_idx, sg, head, env)
        continue
      if (key in self._attn_skip or key in self._mlp_skip
          or key in self._head_skip):
        continue  # folded into a fused call
      self._eval_op(sg_idx, sg, op, env)
    return {name: env[tid] for name, tid in sig.outputs.items()}

  def _dequant_view(self, sg: ir.Subgraph, tid: int, env: dict):
    t = sg.tensors[tid]
    val = env[tid]
    if t.quantization is not None and not val.is_floating_point():
      return quant_arith.dequantize(val, t.quantization,
                                    out_dtype=self._act_dtype)
    return val

  def _eval_op(self, sg_idx: int, sg: ir.Subgraph, op: ir.Op,
               env: dict) -> None:
    ctx = ops_impl.OpContext(op=op, subgraph=sg, graph=self.graph)
    opcode = op.opcode

    if opcode in ('QUANTIZE', 'DEQUANTIZE'):
      val = self._dequant_view(sg, op.inputs[0], env)
      self._store_outputs(sg, op, (val,), env)
      return

    if (
        self.use_fused_kernels
        and opcode == 'FULLY_CONNECTED'
        and len(op.inputs) > 1
        and (sg_idx, op.inputs[1]) in self._dequant_alias
    ):
      op = ir.Op(
          opcode=op.opcode,
          inputs=[op.inputs[0],
                  self._dequant_alias[(sg_idx, op.inputs[1])]]
          + list(op.inputs[2:]),
          outputs=op.outputs, attrs=op.attrs)
      self._eval_quantized_fc(sg_idx, sg, op, env, weight_only=True)
      return

    if (
        self.use_fused_kernels
        and opcode == 'FULLY_CONNECTED'
        and self._fc_weight_is_integer(sg, op)
    ):
      self._eval_quantized_fc(sg_idx, sg, op, env)
      return

    if (
        self.use_fused_kernels
        and opcode == 'EMBEDDING_LOOKUP'
        and len(op.inputs) > 1
        and sg.tensors[op.inputs[1]].quantization is not None
        and sg.tensors[op.inputs[1]].quantization.block_size == 0
        and sg.tensors[op.inputs[1]].quantization.quantized_dimension
        in (0, None)
    ):
      # Gather int rows first, dequantize only the gathered rows.
      ids = env[op.inputs[0]].to(torch.int64)
      table_t = sg.tensors[op.inputs[1]]
      rows = env[op.inputs[1]][ids]
      q = table_t.quantization
      scale = np.asarray(q.scale, np.float32).reshape(-1)
      zp = np.asarray(q.zero_point).reshape(-1).astype(np.int32)
      if scale.size == 1:
        out = (rows.to(torch.float32) - int(zp[0])) * float(scale[0])
      else:
        scale_t = self._const(('emb_scale', sg_idx, op.inputs[1]), scale)
        zp_t = self._const(('emb_zp', sg_idx, op.inputs[1]), zp)
        out = (rows.to(torch.float32) - zp_t[ids][..., None]) * \
            scale_t[ids][..., None]
      self._store_outputs(sg, op, (out,), env)
      return

    if (
        self.use_fused_kernels
        and opcode == 'DYNAMIC_UPDATE_SLICE'
        and len(op.inputs) >= 3
        and self._same_int_params(sg, op.inputs[0], op.inputs[1],
                                  op.outputs[0])
    ):
      # int8 cache update: splice integers directly, no dequant/requant.
      operand = env[op.inputs[0]]
      env[op.outputs[0]] = ops_impl.dynamic_update_slice(
          operand, env[op.inputs[1]], env[op.inputs[2]])
      return

    impl_fn = ops_impl.OPS.get(opcode)
    if impl_fn is None:
      raise NotImplementedError(f'No executor impl for op {opcode!r}.')
    structural = _STRUCTURAL_OPERANDS.get(opcode, ())
    args = []
    for pos, tid in enumerate(op.inputs):
      if tid < 0:
        continue  # absent optional operand (e.g. bias)
      t = sg.tensors[tid]
      if pos in structural and t.buffer >= 0 and \
          self.graph.buffers[t.buffer].data is not None:
        args.append(np.asarray(
            self.graph.buffers[t.buffer].data).reshape(t.shape))
      else:
        args.append(self._dequant_view(sg, tid, env))
    result = impl_fn(ctx, *args)
    if not isinstance(result, tuple):
      result = (result,)
    self._store_outputs(sg, op, result, env)

  def _const(self, key, array: np.ndarray) -> torch.Tensor:
    """A constant derived from IR params, copied to the device once."""
    if key not in self._const_cache:
      self._const_cache[key] = torch.tensor(array, device=self.device)
    return self._const_cache[key]

  def _store_outputs(self, sg: ir.Subgraph, op: ir.Op, values: tuple,
                     env: dict) -> None:
    for tid, val in zip(op.outputs, values):
      t = sg.tensors[tid]
      if t.quantization is not None:
        if val.is_floating_point():
          val = quant_arith.quantize(
              val, t.quantization, quant_arith.storage_dtype_of(t))
      elif t.dtype == 'float32' and val.dtype != self._act_dtype:
        val = val.to(self._act_dtype)
      env[tid] = val

  def _sole_consumer(self, sg: ir.Subgraph, tid: int, op: ir.Op) -> bool:
    """True if `op` is the only consumer of `tid` (and it's no output)."""
    if tid in sg.outputs:
      return False
    count = 0
    for o in sg.ops:
      count += o.inputs.count(tid)
      if count > 1:
        return False
    return count == 1

  def _same_int_params(self, sg: ir.Subgraph, *tids) -> bool:
    """All tensors int-typed with identical quantization params."""
    infos = []
    for tid in tids:
      if tid < 0:
        return False
      t = sg.tensors[tid]
      if t.quantization is None or not t.dtype.startswith('int'):
        return False
      infos.append(t.quantization)
    first = infos[0]
    return all(
        np.array_equal(np.asarray(q.scale), np.asarray(first.scale))
        and np.array_equal(np.asarray(q.zero_point),
                           np.asarray(first.zero_point))
        and q.num_bits == first.num_bits
        for q in infos[1:]
    )

  # -- fused dispatch -------------------------------------------------------

  def _write_caches(self, wb: dict, env: dict) -> None:
    """The skipped cache DUS ops, run outside the attention."""
    for side in ('k', 'v'):
      info = wb[side]
      env[info['out']] = ops_impl.dynamic_update_slice(
          env[info['operand']], env[info['update']], env[info['starts']])

  def _eval_fused_attention(self, sg_idx: int, sg: ir.Subgraph,
                            fusion: dict, env: dict) -> None:
    """One fused int8-cache attention call for a matched chain."""
    q_val = self._dequant_view(sg, fusion['q'], env)
    mask = self._dequant_view(sg, fusion['mask'], env)
    k_info = sg.tensors[fusion['k']].quantization
    v_info = sg.tensors[fusion['v']].quantization
    k_scale = float(np.asarray(k_info.scale).reshape(())) * \
        fusion['k_scale_factor']
    v_scale = float(np.asarray(v_info.scale).reshape(()))
    zp_k = float(np.asarray(k_info.zero_point).reshape(()))
    zp_v = float(np.asarray(v_info.zero_point).reshape(()))
    on_cuda = self.device.type == 'cuda'
    decode_shaped = q_val.shape[2] < 32
    wb = fusion.get('writeback')
    if wb is not None:
      wb_common = self.attn_lengths and decode_shaped
      if wb_common and self.attn_writeback == 'stale':
        # Stale-cache mode: attention reads the pre-write cache plus the
        # new row as an inline softmax column; the cache write runs
        # outside the kernel, consumed only by the signature outputs.
        lengths = torch.sum((mask[:, 0, 0, :] > -1e8).to(torch.int32),
                            dim=-1, dtype=torch.int32)
        ctx = attention.decode_attention_int8_lengths_stale(
            q_val.contiguous(), env[wb['k']['operand']],
            env[wb['v']['operand']], k_scale, v_scale, lengths,
            env[wb['k']['update']].to(torch.int8).contiguous(),
            env[wb['v']['update']].to(torch.int8).contiguous(),
            k_zero_point=zp_k, v_zero_point=zp_v, compute='f32',
            out_dtype=self._act_dtype)
        self._write_caches(wb, env)
        out_op = ir.Op(opcode='BATCH_MATMUL', inputs=[],
                       outputs=[fusion['out']])
        self._store_outputs(sg, out_op, (ctx,), env)
        return
      if on_cuda and wb_common and self.attn_writeback == 'splice':
        raise _unported('pallas_attention.decode_attention_int8_lengths_'
                        'writeback')
      # Fallback: materialize the skipped cache DUS, then proceed unfused.
      self._write_caches(wb, env)
    k_q = env[fusion['k']]
    v_q = env[fusion['v']]
    if on_cuda:
      # The JAX executor sends every other shape of this chain to a
      # Pallas kernel on its accelerator.
      if not decode_shaped:
        raise _unported('pallas_attention.flash_attention_int8_masked')
      if self.attn_lengths:
        raise _unported('pallas_attention.decode_attention_int8_lengths')
      raise _unported('pallas_attention.decode_attention_int8_masked')
    # Plain twin with the same numerics (zp corrections in closed form).
    qf = q_val.to(torch.float32)
    scores = torch.matmul(qf, k_q.to(torch.float32).transpose(-1, -2))
    scores = scores - zp_k * torch.sum(qf, dim=-1, keepdim=True)
    scores = scores * (k_scale / (q_val.shape[-1] ** 0.5))
    scores = scores + mask.to(torch.float32)
    probs = torch.softmax(scores, dim=-1)
    ctx = (torch.matmul(probs, v_q.to(torch.float32)) - zp_v) * v_scale
    out_op = ir.Op(opcode='BATCH_MATMUL', inputs=[], outputs=[fusion['out']])
    self._store_outputs(sg, out_op, (ctx,), env)

  def _eval_fused_mlp(self, sg_idx: int, sg: ir.Subgraph,
                      fusion: dict, env: dict) -> None:
    """One mlp_int4_packed call for a matched GeGLU chain."""
    x = self._dequant_view(sg, fusion['x'], env)
    y = mlp_lib.mlp_int4_packed(
        x,
        env[fusion['wgu_key'][1]],
        self._packed_scale[fusion['wgu_key']],
        env[fusion['wd_grouped_tid']],
        self._packed_scale[fusion['wd_key']],
        act=fusion['act'], drq=self.int4_drq, bf=fusion['bf'])
    out_op = ir.Op(opcode='FULLY_CONNECTED', inputs=[],
                   outputs=[fusion['out']])
    self._store_outputs(sg, out_op, (y,), env)

  def _eval_fused_head(self, sg_idx: int, sg: ir.Subgraph,
                       fusion: dict, env: dict) -> None:
    """One matmul+argmax call for a matched greedy-head chain."""
    x = self._dequant_view(sg, fusion['x'], env)
    w = env[fusion['w_tid']]
    if fusion['packed']:
      scale = self._packed_scale[(sg_idx, fusion['w_tid'])]
      # The unfused packed FC's compute mode, so greedy tokens agree.
      drq = self.int4_drq and w.shape[1] * 2 <= 8192
    else:
      scale = fusion['scale']
      drq = True  # int8 DRQ semantics
    ids = head_lib.head_argmax(x, w, scale, packed=fusion['packed'],
                               true_n=fusion['true_n'], drq=drq)
    out_op = ir.Op(opcode='ARG_MAX', inputs=[], outputs=[fusion['out']])
    self._store_outputs(sg, out_op, (ids,), env)

  # -- quantized FULLY_CONNECTED fast paths ---------------------------------

  def _fc_weight_is_integer(self, sg: ir.Subgraph, op: ir.Op) -> bool:
    w_tid = op.inputs[1]
    if w_tid < 0:
      return False
    w = sg.tensors[w_tid]
    return w.quantization is not None and w.dtype in (
        'int2', 'int4', 'int8')

  def _eval_quantized_fc(self, sg_idx: int, sg: ir.Subgraph, op: ir.Op,
                         env: dict, weight_only: bool = False) -> None:
    x_t = sg.tensors[op.inputs[0]]
    w_t = sg.tensors[op.inputs[1]]
    b_tid = op.inputs[2] if len(op.inputs) > 2 else -1
    w_q = env[op.inputs[1]]
    q = w_t.quantization
    bias = None
    if b_tid >= 0:
      bias = self._dequant_view(sg, b_tid, env)
    on_cuda = self.device.type == 'cuda'

    key = (sg_idx, op.inputs[1])
    if key in self._packed_int4_keys:
      true_n = self._packed_pad_n.get(key)
      x_f = self._dequant_view(sg, op.inputs[0], env)
      if self._packed_block_size.get(key, 0):
        raise _unported('pallas_qmatmul.qmatmul_pallas_int4_packed_'
                        'blockwise')
      if self.int4_drq and w_q.shape[1] * 2 <= 8192:
        y = packed_qmatmul.qmatmul_int4_packed_drq(
            x_f, w_q, self._packed_scale[key],
            bias=None if true_n is not None else bias)
      elif self.int4_drq:
        raise _unported('pallas_qmatmul.qmatmul_pallas_int4_packed_drq_'
                        'kblock')
      else:
        raise _unported('pallas_qmatmul.qmatmul_pallas_int4_packed')
      if true_n is not None:
        y = y[..., :true_n]
        if bias is not None:
          y = y + bias
      y = ops_impl.fused_activation(
          y, op.attrs.get('fused_activation', 'NONE'))
      self._store_outputs(sg, op, (y,), env)
      return

    x_val = env[op.inputs[0]]
    symmetric = bool(np.all(np.asarray(q.zero_point) == 0))
    n, k = w_q.shape[0], w_q.shape[-1]
    scale = self._const(('fc_scale', sg_idx, op.inputs[1]),
                        np.asarray(q.scale, np.float32))
    zero_point = None if symmetric else self._const(
        ('fc_zp', sg_idx, op.inputs[1]), np.asarray(q.zero_point))
    if x_t.quantization is not None:
      raise NotImplementedError(
          'Static-range (integer activation) FULLY_CONNECTED is not ported '
          'yet.')
    # The JAX package's Pallas gates (kernels/qmatmul.py): on its
    # accelerator these shapes reach a kernel that is not ported yet.
    aligned = k % 256 == 0 and n % 128 == 0
    if weight_only:
      y = qmm.qmatmul_ref(x_val, w_q, scale, zero_point=zero_point,
                          bias=bias, block_size=q.block_size)
    elif symmetric and q.block_size == 0:
      if on_cuda and aligned and w_q.dtype == torch.int8:
        raise _unported('pallas_qmatmul.qmatmul_pallas_int8_drq')
      y = qmm.drq_matmul_ref(x_val, w_q, scale, bias=bias)
    else:
      if on_cuda and aligned and zero_point is None:
        raise _unported('pallas_qmatmul.qmatmul_pallas')
      y = qmm.qmatmul_ref(x_val, w_q, scale, zero_point=zero_point,
                          bias=bias, block_size=q.block_size)
    y = ops_impl.fused_activation(
        y, op.attrs.get('fused_activation', 'NONE'))
    self._store_outputs(sg, op, (y,), env)
