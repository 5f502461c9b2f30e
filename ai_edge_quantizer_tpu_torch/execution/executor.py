"""Graph executor of the port: runs a Graph IR signature op by op in torch.

Port of `ai_edge_quantizer_tpu/execution/executor.py`, the parts the
Gemma int4 decode step runs: constant loading, the DEQUANTIZE alias,
`prepare_serving_weights`, `_run_signature` / `_eval_op` /
`_dequant_view` / `_store_outputs`, the int8 DYNAMIC_UPDATE_SLICE fast
path (with the opt-in in-place row write), the packed int4 FCs (DRQ,
K-blocked DRQ, weight-only, blockwise), the unpacked integer FCs (the JAX
dispatchers `drq_matmul` and `qmatmul`, kernels/qmatmul.py, with their
Pallas gates), and seven fusions with their dispatch:
int8-cache attention (the stale-cache kernel with the cache write outside
it, or the splice kernel with the write inside it; the lengths, the
live-prefix or the additive-mask kernel at decode; the flash kernel at
prefill), the GeGLU
MLP, the greedy head, the decode block (MLP(l-1) + norms + QKV(l) +
RoPE + attention(l) in one kernel), the norm fusion (an RMS_NORM folded
into the packed FCs it feeds) and the two attention-block fusions (the
norm + QKV + RoPE prologue, and the attention's out projection and
residual add as its epilogue). The int4-group KV cache needs no
fusion: its INT4G_ATTENTION ops run through `_eval_op` (ops/impl.py),
whose uint8 pools and bf16 sidecar pass `_run_signature` and
`_store_outputs` uncast, as in the JAX executor; no attention or block
unit matches such a graph. The public runners are ported too:
`signature_runner` (with capture mode, which keeps every tensor and runs
each fused unit op by op unless `serving_fastpaths` keeps the fused
kernels) and `stats_runner` (min, max and GPTQ Hessians reduced on the
device), which the calibrator and the model validator drive, and the
static-range (SRQ) integer paths: the FC's int8 x int8 product through
`qmatmul.srq_matmul` (its scaled-accumulator fallback for other
activations) and `_try_srq_int_bmm`. The MoE fusion, control flow and
the SRQ convolution are not ported yet.

Differences from the JAX executor:
  * Options are constructor arguments, not environment variables, with
    the same meanings: `int4_drq` (AEQT_INT4_DRQ), `attn_lengths`
    (AEQT_ATTN_LENGTHS), `attn_writeback` (AEQT_ATTN_WRITEBACK=1 with
    AEQT_ATTN_WRITEBACK_MODE; None turns it off), `mlp_fusion` and `mlp_bf`
    (AEQT_MLP_FUSION, AEQT_MLP_BF), `head_fusion` (AEQT_HEAD_FUSION),
    `decode_block` (AEQT_DECODE_BLOCK), `attn_dynlen` (AEQT_ATTN_DYNLEN),
    `cache_write_inplace` (AEQT_CACHE_WRITE_PALLAS), `norm_fusion`
    (AEQT_NORM_FUSION), `attn_block` (AEQT_ATTN_BLOCK), `attn_qkv` and
    `attn_oproj` (AEQT_ATTN_QKV, AEQT_ATTN_OPROJ: the attention block's two
    halves, on by default as there), `attn_compute` (AEQT_ATTN_COMPUTE:
    'f32', 'bf16' or 'int8', the decode attentions' arithmetic; see
    below), `srq_int` (AEQT_SRQ_INT: the SRQ integer paths). Defaults are
    the
    values bench.py sets (attn_dynlen, cache_write_inplace, norm_fusion and
    attn_block off, as bench.py leaves them);
    `JAX_DEFAULT_OPTIONS` holds the JAX executor's own defaults (every
    AEQT_* variable unset), the mode examples/serve_gemma.py serves in.
  * Donation. The JAX executor donates the cache pools to the kernels that
    alias them (bench.py and DecodeServer donate their pools). Here the
    splice attention (`attn_writeback='splice'`) and the in-place row
    write (`cache_write_inplace`) write the new rows into the step's input
    pool tensors, and the signature's output pools are those same tensors:
    a caller that needs the inputs unchanged passes copies. With both off
    no input is written (the decode block writes into copies of the pools
    and every other cache write is functional).
  * PyTorch runs eagerly: there is no jit, and a step makes no host sync
    (scales that are IR constants stay Python floats).
  * The runners return numpy arrays on the host, as the JAX runners'
    `jax.device_get` does; a bfloat16 tensor comes back as float32 (numpy
    has no bfloat16), which holds every bfloat16 value exactly.
  * Where the JAX executor asks "is the backend a TPU" before a Pallas
    kernel, the port asks nothing: every ported kernel's wrapper launches
    its CUDA kernel for a CUDA tensor and runs its plain version for a CPU
    tensor, so the CPU tests run the same dispatch as the card. The
    Mosaic tiling gates (head dim and cache length multiples of 128) are
    replaced by what each CUDA kernel takes.
  * `attn_compute` reaches the decode attentions as AEQT_ATTN_COMPUTE
    does there. Every decode-attention route takes the mode, with a CUDA
    body in each of the three: the stale, lengths, splice (writeback),
    masked and out-projection-epilogue attentions and the decode block's
    attention. The flash (prefill), live-prefix and twin routes take no
    mode, as in the JAX executor. Off a TPU the JAX executor runs the
    stale, lengths and masked attentions on its f32 XLA twin whatever the
    mode (and the splice route not at all: it writes by DUS and attends
    with the twin), and the decode block and the epilogue in interpret
    mode in the mode; the port runs every route in the mode on both
    devices.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ai_edge_quantizer_tpu_torch.execution import quant_arith
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.kernels import attention
from ai_edge_quantizer_tpu_torch.kernels import block as block_lib
from ai_edge_quantizer_tpu_torch.kernels import cache as cache_lib
from ai_edge_quantizer_tpu_torch.kernels import head as head_lib
from ai_edge_quantizer_tpu_torch.kernels import mlp as mlp_lib
from ai_edge_quantizer_tpu_torch.kernels import packed_qmatmul
from ai_edge_quantizer_tpu_torch.kernels import qkv as qkv_lib
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


def _prefix_lengths(mask: torch.Tensor) -> torch.Tensor:
  """Visible-prefix length of each row of a prefix-form decode mask
  [B, 1, rows, S] (0 visible, -1e9 hidden), int32 [B]."""
  return torch.sum((mask[:, 0, 0, :] > -1e8).to(torch.int32), dim=-1,
                   dtype=torch.int32)


# The JAX executor's options when no AEQT_* variable is set (its default
# serving mode), as GraphExecutor keyword arguments; the other options'
# defaults are the JAX executor's already (mlp_fusion AEQT_MLP_FUSION=1,
# executor.py:768; head_fusion AEQT_HEAD_FUSION=1, :1013).
JAX_DEFAULT_OPTIONS = dict(
    int4_drq=False,        # AEQT_INT4_DRQ=0: executor.py:2120, 2137, 2234
    attn_lengths=False,    # AEQT_ATTN_LENGTHS=0: executor.py:2056
    attn_writeback=None,   # AEQT_ATTN_WRITEBACK=0: executor.py:276
    mlp_bf=512,            # AEQT_MLP_BF=512: executor.py:771
    decode_block=False,    # AEQT_DECODE_BLOCK=0: executor.py:391
)


def attention_route(h: int, s: int, rows: int, attn_lengths: bool,
                    attn_dynlen: bool = False) -> str:
  """Which attention an unfolded int8-cache chain runs, on either device:
  'flash', 'lengths', 'dynlen', 'masked' or 'twin' (the JAX executor's
  dispatch, executor.py `_eval_fused_attention`: Pallas only for H and S
  multiples of 128, prefill-shaped from 32 grouped query rows; at decode
  AEQT_ATTN_LENGTHS first, then AEQT_ATTN_DYNLEN, :2056-2083)."""
  if h % 128 or s % 128:
    return 'twin'
  if rows >= 32:
    return 'flash'
  if attn_lengths:
    return 'lengths'
  return 'dynlen' if attn_dynlen else 'masked'


def _to_device(value, device) -> torch.Tensor:
  """A tensor on `device`. A read-only array (a buffer that
  `serialize.load_graph` maps from its file) is copied into memory of its
  own first: torch would otherwise share it, warn, and could write into
  the map."""
  if isinstance(value, torch.Tensor):
    return value.to(device)
  arr = np.asarray(value)
  if not arr.flags.writeable:
    arr = np.array(arr)
  return torch.as_tensor(arr, device=device)


@contextlib.contextmanager
def full_f32_matmul():
  """Within it, float32 matmuls on a CUDA device run in full float32, not
  TF32, whatever the process set (the JAX package's Precision.HIGHEST)."""
  saved = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = saved


def _to_host(tensors: dict) -> dict:
  """{name: tensor} -> {name: numpy array} (bfloat16 as float32)."""
  out = {}
  for name, t in tensors.items():
    t = t.detach()
    if t.dtype == torch.bfloat16:
      t = t.to(torch.float32)
    out[name] = t.cpu().numpy()
  return out


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
               head_fusion: bool = True,
               decode_block: bool = True,
               attn_dynlen: bool = False,
               cache_write_inplace: bool = False,
               norm_fusion: bool = False,
               attn_block: bool = False,
               attn_qkv: bool = True,
               attn_oproj: bool = True,
               attn_compute: str = 'f32',
               srq_int: bool = True):
    """activation_dtype: 'bfloat16' (serving mode, the bench's setting) or
    'float32' (bit-faithful to the offline pipeline). attn_writeback:
    'stale', 'splice' or None. decode_block: fuse each matched
    MLP(l-1)+QKV(l)+attention(l) unit into one kernel (needs
    attn_writeback). attn_dynlen: decode attention reads only the live
    prefix (with attn_lengths off). cache_write_inplace: an int8 cache
    row write whose input nothing else reads goes into that input's
    storage. The splice attention and cache_write_inplace write into the
    step's input pools (see Donation above). norm_fusion: an RMS_NORM whose
    output feeds only packed channelwise FCs folds into each of them.
    attn_block: the norm + QKV + RoPE prologue (with attn_qkv) and the
    attention + out-projection + residual epilogue (with attn_oproj) each
    run as one fused call where they match. attn_compute: 'f32', 'bf16' or
    'int8', the decode attentions' compute mode. srq_int: static-range FCs
    and batch matmuls over int8 activations contract in integers (off: the
    FC dequantizes its activation first, the batch matmul runs as a float
    op)."""
    self.device = torch.device(device)
    if self.device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError(
          'GraphExecutor: device cuda requested but no CUDA device is '
          "available; pass device='cpu' to run the plain versions.")
    if attn_writeback not in (None, 'stale', 'splice'):
      raise ValueError(f'attn_writeback={attn_writeback!r}')
    if attn_compute not in attention.COMPUTE_MODES:
      raise ValueError(f'attn_compute={attn_compute!r}')
    self.graph = graph
    self.use_fused_kernels = use_fused_kernels
    self.int4_drq = int4_drq
    self.attn_lengths = attn_lengths
    self.attn_writeback = attn_writeback
    self.mlp_fusion = mlp_fusion
    self.mlp_bf = mlp_bf
    self.head_fusion = head_fusion
    self.decode_block = decode_block
    self.attn_dynlen = attn_dynlen
    self.cache_write_inplace = cache_write_inplace
    self.norm_fusion = norm_fusion
    self.attn_block = attn_block
    self.attn_qkv = attn_qkv
    self.attn_oproj = attn_oproj
    self.attn_compute = attn_compute
    self.srq_int = srq_int
    self._act_dtype = quant_arith.STORAGE_TORCH_DTYPES[activation_dtype]
    # Constant tensors, keyed (subgraph_idx, tensor_id), in storage dtype;
    # the tensors that alias one buffer (the signatures of a multi-
    # signature model) share one device copy.
    self._weights: dict = {}
    loaded: dict = {}
    for sg_idx, sg in enumerate(graph.subgraphs):
      for tid, t in enumerate(sg.tensors):
        if t.buffer >= 0 and graph.buffers[t.buffer].data is not None:
          dtype = quant_arith.storage_dtype_of(t)
          if dtype == torch.int64:
            dtype = torch.int32  # as the JAX executor without x64
          key = (t.buffer, t.shape, dtype)
          if key not in loaded:
            data = np.asarray(graph.buffers[t.buffer].data).reshape(t.shape)
            loaded[key] = _to_device(data, self.device).to(dtype)
          self._weights[(sg_idx, tid)] = loaded[key]
    # Keys of FC weights converted to packed-int4 serving layout
    # (uint8 [N, K//2], split-half; see kernels/packed_qmatmul.py).
    self._packed_int4_keys: set = set()
    self._packed_pad_n: dict = {}  # key -> true N (packed weight N-padded)
    self._packed_scale: dict = {}  # key -> padded per-channel scale
    self._packed_block_size: dict = {}  # key -> block size (blockwise int4)
    # RMS_NORM -> packed-FC fusion: (sg, norm output tid) -> info.
    self._norm_fusions: dict = {}
    self._norm_skip: set = set()
    # Attention-block prologue (norm + QKV + RoPE): (sg, norm op idx) -> info.
    self._qkv_fusions: dict = {}
    self._qkv_skip: set = set()
    self._mlp_fusions: dict = {}
    self._mlp_skip: set = set()
    self._head_fusions: dict = {}
    self._head_skip: set = set()
    # Decode-block units (_find_block_fusions): (sg, first op idx) -> info.
    self._block_fusions: dict = {}
    self._block_skip: set = set()
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
    self._find_norm_fusions()
    self._find_mlp_fusions()
    self._find_head_fusions()
    self._find_qkv_fusions()
    self._find_attn_epilogues()
    self._find_block_fusions()

  def _sig_out_tids(self) -> set:
    return {(s.subgraph_index, tid)
            for s in self.graph.signatures for tid in s.outputs.values()}

  def _find_norm_fusions(self) -> None:
    """RMS_NORM ops whose output feeds only packed channelwise FCs (and is
    no subgraph or signature output), with a constant gamma, fold into
    each consuming FC's `qmatmul_int4_packed_rmsnorm` call; the norm op is
    skipped (the JAX executor's `_find_norm_fusions`, AEQT_NORM_FUSION)."""
    self._norm_fusions = {}
    self._norm_skip = set()
    if not self.norm_fusion:
      return
    sig_out_tids = self._sig_out_tids()
    for sg_idx, sg in enumerate(self.graph.subgraphs):
      for op_idx, op in enumerate(sg.ops):
        if op.opcode != 'RMS_NORM' or len(op.inputs) < 2 or not op.outputs:
          continue
        out_tid = op.outputs[0]
        if out_tid in sg.outputs or (sg_idx, out_tid) in sig_out_tids:
          continue
        gamma_tid = op.inputs[1]
        g_t = sg.tensors[gamma_tid]
        if g_t.buffer < 0 or self.graph.buffers[g_t.buffer].data is None:
          if (sg_idx, gamma_tid) not in self._weights:
            continue
        consumers = [o for o in sg.ops if out_tid in o.inputs]
        if not consumers or not all(
            o.opcode == 'FULLY_CONNECTED'
            and o.inputs and o.inputs[0] == out_tid
            and len(o.inputs) > 1
            and (sg_idx, o.inputs[1]) in self._packed_int4_keys
            and (sg_idx, o.inputs[1]) not in self._packed_block_size
            for o in consumers
        ):
          continue
        self._norm_fusions[(sg_idx, out_tid)] = {
            'x': op.inputs[0],
            'gamma': gamma_tid,
            'eps': float(op.attrs.get('epsilon', 1e-6)),
        }
        self._norm_skip.add((sg_idx, op_idx))

  def _find_mlp_fusions(self) -> None:
    """Fuse the GeGLU FFN chain into one mlp_int4_packed call.

    Patterns (models/gemma.py, both layouts):
      A. FULLY_CONNECTED(gate_up) -> SLICE(gate), SLICE(up)
           -> GELU(gate) -> MUL(gelu, up) -> FULLY_CONNECTED(down)
      B. FULLY_CONNECTED(gate), FULLY_CONNECTED(up) on the same input
           -> GELU(gate) -> MUL(gelu, up) -> FULLY_CONNECTED(down)
    All weights packed channelwise int4 without N padding, and the chain's
    input no norm-fused tensor (only the packed FC re-applies a skipped
    norm). The down weight is re-packed into the group-split layout under
    the synthetic tensor id -1000 - tid (it replaces the canonical packed
    form).
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

      def norm_fused_input(tid, sg_idx=sg_idx):
        return (sg_idx, tid) in self._norm_fusions

      for gu_idx, gu_op in enumerate(sg.ops):
        if not plain_fc(gu_op) or not packed_channelwise(gu_op.inputs[1]):
          continue
        if norm_fused_input(gu_op.inputs[0]):
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
        if norm_fused_input(gate_op.inputs[0]):
          continue
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
    int8, consumed only by ARG_MAX over the last axis, whose input is no
    norm-fused tensor."""
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
        if (sg_idx, fc_op.inputs[0]) in self._norm_fusions:
          continue  # only the plain FC kernel re-applies a skipped norm
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

  def _find_qkv_fusions(self) -> None:
    """The decode layer's prologue as one `qkv.qkv_rope` call (the JAX
    executor's `_find_qkv_fusions`, AEQT_ATTN_BLOCK with AEQT_ATTN_QKV).

    Matches RMS_NORM -> FC(packed channelwise int4 fused QKV, no N padding)
    -> SLICE x3 -> {q: RESHAPE -> ROPE -> TRANSPOSE -> RESHAPE, k: RESHAPE
    -> ROPE -> TRANSPOSE, v: RESHAPE -> TRANSPOSE} at T = 1, each link the
    single float consumer of an unprotected tensor. Keyed at the norm op;
    the chain's other ops are skipped. The JAX executor's TPU gate on head
    and byte-column widths becomes what the CUDA kernel takes (it raises
    for any other shape).
    """
    self._qkv_fusions = {}
    self._qkv_skip = set()
    if not (self.attn_block and self.attn_qkv):
      return
    sig_out_tids = self._sig_out_tids()
    for sg_idx, sg in enumerate(self.graph.subgraphs):
      cons: dict = {}
      for oi, o in enumerate(sg.ops):
        for t in o.inputs:
          cons.setdefault(t, []).append((oi, o))
      protected = set(sg.outputs) | {
          tid for (si, tid) in sig_out_tids if si == sg_idx}

      def link(tid, opcode, sg=sg, cons=cons, protected=protected):
        """Single unprotected float consumer of `tid` with `opcode`."""
        users = cons.get(tid, [])
        if (tid in protected or len(users) != 1
            or users[0][1].opcode != opcode
            or sg.tensors[tid].quantization is not None):
          return None
        return users[0]

      for norm_idx, norm in enumerate(sg.ops):
        if norm.opcode != 'RMS_NORM' or len(norm.inputs) < 2:
          continue
        got = link(norm.outputs[0], 'FULLY_CONNECTED')
        if got is None:
          continue
        fc_idx, fc = got
        if (fc.inputs[0] != norm.outputs[0] or len(fc.inputs) < 2
            or fc.inputs[1] < 0
            or (len(fc.inputs) > 2 and fc.inputs[2] >= 0)
            or fc.attrs.get('fused_activation', 'NONE') != 'NONE'):
          continue
        key = (sg_idx, fc.inputs[1])
        if (key not in self._packed_int4_keys
            or key in self._packed_block_size
            or key in self._packed_pad_n):
          continue
        qkv_tid = fc.outputs[0]
        users = cons.get(qkv_tid, [])
        if (qkv_tid in protected or len(users) != 3
            or any(o.opcode != 'SLICE' for _, o in users)):
          continue
        by_begin = sorted(users, key=lambda u: u[1].attrs['begin'][-1])
        (qs_idx, qs), (ks_idx, ks), (vs_idx, vs) = by_begin

        got = link(qs.outputs[0], 'RESHAPE')
        if got is None:
          continue
        qr_idx, qr = got
        new_shape = qr.attrs.get('new_shape')
        if not new_shape or len(new_shape) != 4 or new_shape[1] != 1:
          continue
        _, _, nq, h = new_shape
        got = link(qr.outputs[0], 'ROPE')
        if got is None:
          continue
        qrope_idx, qrope = got
        got = link(qrope.outputs[0], 'TRANSPOSE')
        if got is None or got[1].attrs.get('perm') != [0, 2, 1, 3]:
          continue
        qt_idx, qt_op = got
        got = link(qt_op.outputs[0], 'RESHAPE')
        if got is None:
          continue
        qg_idx, qg = got

        got = link(ks.outputs[0], 'RESHAPE')
        if got is None:
          continue
        kr_idx, kr = got
        got = link(kr.outputs[0], 'ROPE')
        if got is None:
          continue
        krope_idx, krope = got
        if (krope.inputs[1] != qrope.inputs[1]
            or krope.attrs.get('rope_base') != qrope.attrs.get('rope_base')):
          continue
        got = link(krope.outputs[0], 'TRANSPOSE')
        if got is None or got[1].attrs.get('perm') != [0, 2, 1, 3]:
          continue
        kt_idx, kt_op = got

        got = link(vs.outputs[0], 'RESHAPE')
        if got is None:
          continue
        vr_idx, vr = got
        got = link(vr.outputs[0], 'TRANSPOSE')
        if got is None or got[1].attrs.get('perm') != [0, 2, 1, 3]:
          continue
        vt_idx, vt_op = got

        qkv_n = int(sg.tensors[fc.inputs[1]].shape[0])
        if qkv_n * h == 0 or qkv_n % h:
          continue
        nk = (qkv_n // h - nq) // 2
        if nk < 1 or (nq + 2 * nk) * h != qkv_n:
          continue
        self._qkv_fusions[(sg_idx, norm_idx)] = {
            'x': norm.inputs[0], 'gamma': norm.inputs[1],
            'w_tid': fc.inputs[1], 'positions': qrope.inputs[1],
            'rope_base': float(qrope.attrs.get('rope_base', 10000.0)),
            'eps': float(norm.attrs.get('epsilon', 1e-6)),
            'nq': nq, 'nk': nk, 'h': h,
            'q_out': qg.outputs[0], 'k_out': kt_op.outputs[0],
            'v_out': vt_op.outputs[0],
        }
        for oi in (fc_idx, qs_idx, ks_idx, vs_idx, qr_idx, qrope_idx,
                   qt_idx, qg_idx, kr_idx, krope_idx, kt_idx, vr_idx,
                   vt_idx):
          self._qkv_skip.add((sg_idx, oi))

  def _find_attn_epilogues(self) -> None:
    """Extend matched attention fusions with the out projection and the
    residual add, run as one `attention.decode_attention_oproj` call (the
    JAX executor's `_find_attn_epilogues`, AEQT_ATTN_BLOCK with
    AEQT_ATTN_OPROJ).

    ctx -> RESHAPE -> TRANSPOSE(0, 2, 1, 3) -> RESHAPE -> FC(packed
    channelwise int4, no N padding, no bias) -> ADD(residual), each link
    the single float consumer of an unprotected tensor, on an attention
    with one KV head. Kept from the JAX executor, so that both find the
    same units: its VMEM-feasibility gate (two [min(8, B), S, H] int8
    cache blocks within 13 MiB) and its even-G gate, both unconditional
    there. Its TPU gate on H, D, G*H/2 and S becomes what the CUDA kernel
    takes (it raises for any other shape). Like the JAX finder it does not
    ask that T be 1: a prefill-shaped attention can match.
    """
    if not (self.attn_block and self.attn_oproj):
      return
    sig_out_tids = self._sig_out_tids()
    for (sg_idx, bmm2_idx), fusion in list(self._attn_fusions.items()):
      if 'epilogue' in fusion:
        continue
      sg = self.graph.subgraphs[sg_idx]
      cons: dict = {}
      for oi, o in enumerate(sg.ops):
        for t in o.inputs:
          cons.setdefault(t, []).append((oi, o))
      protected = set(sg.outputs) | {
          tid for (si, tid) in sig_out_tids if si == sg_idx}

      def link(tid, opcode, sg=sg, cons=cons, protected=protected):
        users = cons.get(tid, [])
        if (tid in protected or len(users) != 1
            or users[0][1].opcode != opcode
            or sg.tensors[tid].quantization is not None):
          return None
        return users[0]

      q_shape = sg.tensors[fusion['q']].shape
      if len(q_shape) != 4 or q_shape[1] != 1:
        continue  # MQA only (NK == 1)
      b_dim, _, g, h_dim = q_shape
      s_dim = sg.tensors[fusion['k']].shape[2]
      if 2 * (2 * min(8, b_dim) * s_dim * h_dim) > 13 * 2**20:
        continue
      if g % 2:
        continue
      got = link(fusion['out'], 'RESHAPE')
      if got is None:
        continue
      r1_idx, r1 = got
      got = link(r1.outputs[0], 'TRANSPOSE')
      if got is None or got[1].attrs.get('perm') != [0, 2, 1, 3]:
        continue
      t_idx, t_op = got
      got = link(t_op.outputs[0], 'RESHAPE')
      if got is None:
        continue
      r2_idx, r2 = got
      got = link(r2.outputs[0], 'FULLY_CONNECTED')
      if got is None:
        continue
      fc_idx, fc = got
      if (fc.inputs[0] != r2.outputs[0] or len(fc.inputs) < 2
          or fc.inputs[1] < 0
          or (len(fc.inputs) > 2 and fc.inputs[2] >= 0)
          or fc.attrs.get('fused_activation', 'NONE') != 'NONE'):
        continue
      key = (sg_idx, fc.inputs[1])
      if (key not in self._packed_int4_keys
          or key in self._packed_block_size
          or key in self._packed_pad_n):
        continue
      got = link(fc.outputs[0], 'ADD')
      if got is None:
        continue
      add_idx, add = got
      others = [t for t in add.inputs if t != fc.outputs[0]]
      if len(others) != 1:
        continue
      fusion['epilogue'] = {
          'wo_tid': fc.inputs[1], 'x_res': others[0], 'y': add.outputs[0]}
      for oi in (r1_idx, t_idx, r2_idx, fc_idx, add_idx):
        self._attn_skip.add((sg_idx, oi))

  def _find_block_fusions(self) -> None:
    """Merge MLP(l-1)+norms+QKV(l)+RoPE+attention(l) units into one
    `block.fused_mlp_qkv_attention` call per layer (the JAX executor's
    `_find_block_fusions`, the same units on the same conditions).

    A unit is an attention fusion with its cache writes folded in
    (attn_writeback), no out-projection epilogue and one KV head, whose q,
    k and v chains lead back to
    one packed QKV FC behind an RMS_NORM, whose input is the ADD of a
    residual and an unsplit MLP fusion's output, that MLP's input being an
    RMS_NORM of the same residual; all four cache tensors carry
    quantization params. Runs after the MLP and head finders; the absorbed
    MLP and attention fusions are removed, and so are the folded norms'
    norm fusions.
    """
    self._block_fusions = {}
    self._block_skip = set()
    if not self.decode_block:
      return
    for (sg_idx, bmm2_idx), attn in list(self._attn_fusions.items()):
      wb = attn.get('writeback')
      if wb is None or attn.get('epilogue') is not None:
        continue
      sg = self.graph.subgraphs[sg_idx]
      ops = sg.ops
      q_tid = attn['q']
      if sg.tensors[q_tid].shape[1] != 1:  # NK == 1 only
        continue

      def producer(tid, sg=sg, ops=ops):
        p = ir.tensor_producer(sg, tid)
        return (p, ops[p]) if p >= 0 else (None, None)

      def walk(tid, opcodes, producer=producer):
        """Walk producers back through `opcodes`; returns (ops, final)."""
        seen = []
        for code in opcodes:
          p, op = producer(tid)
          if op is None or op.opcode != code:
            return None, None
          seen.append(p)
          tid = op.inputs[0]
        return seen, tid

      # q chain: q_grouped <- RESHAPE <- TRANSPOSE <- ROPE <- RESHAPE <-
      # SLICE(qkv) <- FC(xn2, wqkv).
      q_ops, q4_tid = walk(q_tid, ('RESHAPE', 'TRANSPOSE'))
      if q_ops is None:
        continue
      rope_idx, rope_op = producer(q4_tid)
      if rope_op is None or rope_op.opcode != 'ROPE':
        continue
      positions_tid = rope_op.inputs[1]
      rope_base = float((rope_op.attrs or {}).get('rope_base', 10000.0))
      slice_ops, qkv_tid = walk(rope_op.inputs[0], ('RESHAPE', 'SLICE'))
      if slice_ops is None:
        continue
      fc_idx, fc_op = producer(qkv_tid)
      if fc_op is None or fc_op.opcode != 'FULLY_CONNECTED':
        continue
      wqkv_key = (sg_idx, fc_op.inputs[1])
      if wqkv_key not in self._packed_int4_keys:
        continue
      norm_idx, norm_op = producer(fc_op.inputs[0])
      if norm_op is None or norm_op.opcode != 'RMS_NORM':
        continue
      g2_tid = norm_op.inputs[1]
      x_ffn_tid = norm_op.inputs[0]

      # k chain: wb update <- TRANSPOSE <- ROPE <- RESHAPE <- SLICE(qkv)
      k_ops, k4_tid = walk(wb['k']['update'], ('TRANSPOSE',))
      if k_ops is None:
        continue
      krope_idx, krope_op = producer(k4_tid)
      if krope_op is None or krope_op.opcode != 'ROPE':
        continue
      kslice_ops, k_src = walk(krope_op.inputs[0], ('RESHAPE', 'SLICE'))
      if kslice_ops is None or k_src != qkv_tid:
        continue
      # v chain: TRANSPOSE <- RESHAPE <- SLICE(qkv)
      v_ops, v_src = walk(wb['v']['update'],
                          ('TRANSPOSE', 'RESHAPE', 'SLICE'))
      if v_ops is None or v_src != qkv_tid:
        continue

      # The FFN residual of l-1: x_ffn = ADD(x_res, mlp_down_out).
      add_idx, add_op = producer(x_ffn_tid)
      if add_op is None or add_op.opcode != 'ADD':
        continue
      mlp = mlp_key = x_res_tid = None
      for cand_res, cand_down in (add_op.inputs[:2],
                                  add_op.inputs[:2][::-1]):
        for key, info in self._mlp_fusions.items():
          if key[0] == sg_idx and info['out'] == cand_down:
            mlp, mlp_key, x_res_tid = info, key, cand_res
            break
        if mlp is not None:
          break
      if mlp is None or mlp.get('wgu_split') is not None:
        continue
      # mlp['x'] is the pre-FFN-norm output; fold the norm in.
      n1_idx, n1_op = producer(mlp['x'])
      if (n1_op is None or n1_op.opcode != 'RMS_NORM'
          or n1_op.inputs[0] != x_res_tid):
        continue

      k_info = sg.tensors[attn['k']].quantization
      v_info = sg.tensors[attn['v']].quantization
      ku_info = sg.tensors[wb['k']['update']].quantization
      vu_info = sg.tensors[wb['v']['update']].quantization
      if any(i is None for i in (k_info, v_info, ku_info, vu_info)):
        continue

      def scalar(values):
        return float(np.asarray(values).reshape(()))

      first_idx = min(n1_idx, mlp_key[1])
      self._block_fusions[(sg_idx, first_idx)] = {
          'x_res': x_res_tid,
          'g1': n1_op.inputs[1],
          'eps': float((n1_op.attrs or {}).get('epsilon', 1e-6)),
          'mlp': mlp,
          'g2': g2_tid,
          'wqkv_key': wqkv_key,
          'positions': positions_tid,
          'rope_base': rope_base,
          'nq': sg.tensors[q_tid].shape[2],
          'head_dim': sg.tensors[q_tid].shape[3],
          'x_ffn_out': x_ffn_tid,
          'ctx_out': attn['out'],
          'mask': attn['mask'],
          'wb': wb,
          'k_scale_eff': scalar(k_info.scale) * attn['k_scale_factor'],
          'v_scale': scalar(v_info.scale),
          'zp_k': scalar(k_info.zero_point),
          'zp_v': scalar(v_info.zero_point),
          'kq_scale': scalar(ku_info.scale),
          'vq_scale': scalar(vu_info.scale),
      }
      # Ops absorbed into the unit. The attention chain's own ops are in
      # _attn_skip already and the MLP's interior ops stay in _mlp_skip;
      # the MLP fusion's key op (its gate/up FC) is skipped here.
      unit_ops = ([n1_idx, add_idx, norm_idx, fc_idx, rope_idx, krope_idx,
                   bmm2_idx]
                  + q_ops + slice_ops + k_ops + kslice_ops + v_ops)
      for oi in unit_ops:
        self._block_skip.add((sg_idx, oi))
      self._block_skip.add(mlp_key)
      del self._mlp_fusions[mlp_key]
      del self._attn_fusions[(sg_idx, bmm2_idx)]
      # The folded norms must not re-engage their own fusions.
      self._norm_skip.discard((sg_idx, n1_idx))
      self._norm_skip.discard((sg_idx, norm_idx))
      self._norm_fusions.pop((sg_idx, fc_op.inputs[0]), None)
      self._norm_fusions.pop((sg_idx, mlp['x']), None)

  # -- public API -----------------------------------------------------------

  def signature_runner(self, signature_key: str = 'serving_default',
                       capture_all: bool = False,
                       serving_fastpaths: bool = False):
    """A callable(inputs: dict) -> dict of outputs (or all tensors), as
    numpy arrays on the host.

    capture_all works with packed serving weights: packed int4 FC weights
    are returned as their unpacked true-shape int8 view, so the dual-model
    validator can assert per-tensor error bounds on the exact production
    configuration. serving_fastpaths additionally keeps the fused kernels
    engaged under capture (their internal intermediates are simply absent
    from the capture dict)."""
    sig = self.graph.signature_by_key(signature_key)

    def runner(inputs: dict) -> dict:
      return _to_host(self._run_signature(
          sig.subgraph_index, signature_key, self._weights, inputs,
          capture_all=capture_all, serving_fastpaths=serving_fastpaths))

    return runner

  def __call__(self, inputs: dict,
               signature_key: str = 'serving_default') -> dict:
    """Run one signature: {user input name: array} -> {output name:
    tensor on this device}. Nothing is copied back to the host."""
    sig = self.graph.signature_by_key(signature_key)
    return self._run_signature(sig.subgraph_index, signature_key,
                               self._weights, inputs)

  def stats_runner(self, signature_key: str = 'serving_default',
                   hessian_tensor_names=()):
    """On-device calibration statistics: callable(inputs) -> {name: qsv}.

    min/max (and, for names in `hessian_tensor_names`, the GPTQ Hessian
    2/n * X^T X) are reduced on the device in the forward pass, so only
    the statistics cross to the host instead of every intermediate
    tensor."""
    sig = self.graph.signature_by_key(signature_key)
    hessians = tuple(sorted(hessian_tensor_names))

    def runner(inputs: dict) -> dict:
      return self._run_signature_stats(sig.subgraph_index, signature_key,
                                       hessians, self._weights, inputs)

    return runner

  def _run_signature_stats(self, sg_idx: int, signature_key: str,
                           hessian_names: tuple, weights: dict,
                           inputs: dict) -> dict:
    # Valid-range mask mirrors host-side calibration (min_max.py): values
    # outside +-3e38 (inf/overflow) are excluded unless nothing survives.
    lo, hi = -3e38, 3e38
    all_tensors = self._run_signature(sg_idx, signature_key, weights, inputs,
                                      capture_all=True)
    sg = self.graph.subgraphs[sg_idx]
    const_names = {
        t.name for t in sg.tensors
        if t.buffer >= 0 and self.graph.buffers[t.buffer].data is not None
    }
    names, ndims, extremes, hessian = [], [], [], {}
    for name, v in all_tensors.items():
      if name in const_names or not v.is_floating_point():
        continue
      v32 = v.to(torch.float32)
      mask = (v32 > lo) & (v32 < hi)
      any_valid = torch.any(mask)
      inf = torch.full((), float('inf'), device=v32.device)
      vmin = torch.where(any_valid, torch.amin(torch.where(mask, v32, inf)),
                         torch.amin(v32))
      vmax = torch.where(any_valid, torch.amax(torch.where(mask, v32, -inf)),
                         torch.amax(v32))
      names.append(name)
      ndims.append(v.dim())
      extremes.append(torch.stack([vmin, vmax]))
      if name in hessian_names:
        x = v32.reshape(-1, v32.shape[-1])
        n = v.shape[0]  # leading dim = sample count (gptq.calibrate parity)
        with full_f32_matmul():
          hessian[name] = ((2.0 / n) * (x.T @ x), n)
    stats = {}
    if not names:
      return stats
    # One copy to the host for every tensor's min and max.
    extremes = torch.stack(extremes).cpu().numpy()
    for name, ndim, (vmin, vmax) in zip(names, ndims, extremes):
      shape1 = (1,) * ndim
      entry = {'min': vmin.reshape(shape1), 'max': vmax.reshape(shape1)}
      if name in hessian:
        h, n = hessian[name]
        entry['hessian'] = h.cpu().numpy()
        entry['num_samples'] = np.asarray(n, np.int32)
      stats[name] = entry
    return stats

  # -- evaluation -----------------------------------------------------------

  def _run_signature(self, sg_idx: int, signature_key: str, weights: dict,
                     inputs: dict, capture_all: bool = False,
                     serving_fastpaths: bool = False) -> dict:
    sig = self.graph.signature_by_key(signature_key)
    sg = self.graph.subgraphs[sg_idx]
    env: dict = {}
    for (w_sg, w_tid), arr in weights.items():
      if w_sg == sg_idx:
        env[w_tid] = arr
    if capture_all:
      # MLP-fused down weights live only in the grouped kernel layout;
      # rebuild the canonical packed view so the unrolled chain and the
      # validator's per-tensor capture still see the weight.
      for (f_sg, _), info in self._mlp_fusions.items():
        if f_sg != sg_idx:
          continue
        wd_tid = info['wd_key'][1]
        if wd_tid not in env:
          env[wd_tid] = packed_qmatmul.pack_int4_split(
              mlp_lib.unpack_int4_split_grouped(
                  env[info['wd_grouped_tid']], info['bf']))
        split = info.get('wgu_split')
        if split is not None:
          g_tid, u_tid, f = split
          synth = env[info['wgu_key'][1]]
          if g_tid not in env:
            env[g_tid] = synth[:f]
          if u_tid not in env:
            env[u_tid] = synth[f:]
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

    # capture_all keeps every intermediate visible (fusions unrolled)
    # unless serving_fastpaths pins the fused kernels.
    fused = not capture_all or serving_fastpaths
    for op_idx, op in enumerate(sg.ops):
      key = (sg_idx, op_idx)
      if fused:
        block = self._block_fusions.get(key)
        if block is not None:
          self._eval_fused_block(sg, block, env)
          continue
        if key in self._block_skip:
          continue  # folded into a decode-block unit
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
        # Keyed at its RMS_NORM, so it comes before the norm skip.
        qkv = self._qkv_fusions.get(key)
        if qkv is not None:
          self._eval_fused_qkv(sg_idx, sg, qkv, env)
          continue
        if (key in self._attn_skip or key in self._mlp_skip
            or key in self._head_skip or key in self._qkv_skip
            or key in self._norm_skip):
          continue  # folded into a fused call
      self._eval_op(sg_idx, sg, op, env)

    if capture_all:
      out = {}
      for tid, t in enumerate(sg.tensors):
        if tid not in env:
          continue
        val = env[tid]
        key = (sg_idx, tid)
        if key in self._packed_int4_keys:
          # Unpacked true-shape int8 view so packed serving weights stay
          # validator-visible per tensor.
          val = packed_qmatmul.unpack_int4_split(val)
          true_n = self._packed_pad_n.get(key)
          if true_n is not None:
            val = val[:true_n]
        out[t.name] = val
      return out
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
      update = env[op.inputs[1]]
      if (
          self.cache_write_inplace
          and update.dim() == operand.dim()
          and cache_lib.supports(tuple(operand.shape), tuple(update.shape),
                                 operand.dtype)
          and self._sole_consumer(sg, op.inputs[0], op)
      ):
        # AEQT_CACHE_WRITE_PALLAS: the row goes into the operand's own
        # storage; nothing else reads the pre-update value, so the input
        # pool is donated and becomes the output.
        env[op.outputs[0]] = cache_lib.dus_row_inplace(
            operand, update, env[op.inputs[2]])
        return
      env[op.outputs[0]] = ops_impl.dynamic_update_slice(
          operand, update, env[op.inputs[2]])
      return

    if (
        self.use_fused_kernels
        and opcode == 'BATCH_MATMUL'
        and self.srq_int
        and self._try_srq_int_bmm(sg, op, env)
    ):
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

  def _try_srq_int_bmm(self, sg: ir.Subgraph, op: ir.Op,
                       env: dict) -> bool:
    """Integer SRQ batched matmul (SRQ attention score/context matmuls).

    Both operands are int8 activations with per-tensor params; the zero
    points expand in closed form through runtime row/column sums:

      (A - za)(B - zb) = AB - za*colsum(B) - zb*rowsum(A) + K*za*zb

    so the contraction stays int8 x int8 -> int32 (exact, as
    `qmatmul.int_bmm_exact` computes it)."""
    a_tid, b_tid = op.inputs[0], op.inputs[1]
    if a_tid < 0 or b_tid < 0:
      return False
    a_t, b_t = sg.tensors[a_tid], sg.tensors[b_tid]
    aq, bq = a_t.quantization, b_t.quantization
    a, b = env.get(a_tid), env.get(b_tid)
    if (
        aq is None or bq is None or a is None or b is None
        or a.dtype != torch.int8 or b.dtype != torch.int8
        or np.asarray(aq.scale).size != 1 or np.asarray(bq.scale).size != 1
    ):
      return False
    if op.attrs.get('adj_x', False):
      a = a.transpose(-1, -2)
    if op.attrs.get('adj_y', False):
      b = b.transpose(-1, -2)
    k = a.shape[-1]
    za = int(np.asarray(aq.zero_point).reshape(()))
    zb = int(np.asarray(bq.zero_point).reshape(()))
    acc = qmm.int_bmm_exact(a, b)
    if zb:
      acc = acc - zb * torch.sum(a.to(torch.int32), dim=-1, keepdim=True,
                                 dtype=torch.int32)
    if za:
      acc = acc - za * torch.sum(b.to(torch.int32), dim=-2, keepdim=True,
                                 dtype=torch.int32)
    if za and zb:
      acc = acc + k * za * zb
    s_ab = (float(np.asarray(aq.scale).reshape(()))
            * float(np.asarray(bq.scale).reshape(())))
    y = acc.to(torch.float32) * torch.full((), s_ab, dtype=torch.float32,
                                           device=acc.device)
    self._store_outputs(sg, op, (y,), env)
    return True

  def _fc_params(self, sg_idx: int, w_tid: int, q) -> tuple:
    """(scale, zero point or None if symmetric) of an FC weight as device
    tensors, made once: a blockwise zero point has N * K / bs entries (16M
    for the Gemma head), too many to test for zeros at every call."""
    key = ('fc_params', sg_idx, w_tid)
    if key not in self._const_cache:
      zp = np.asarray(q.zero_point)
      self._const_cache[key] = (
          torch.tensor(np.asarray(q.scale, np.float32), device=self.device),
          None if not np.any(zp) else torch.tensor(zp, device=self.device))
    return self._const_cache[key]

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
    """One fused int8-cache attention call for a matched chain.

    Dispatch (the JAX executor's `_eval_fused_attention`), the same on
    both devices:
      * decode-shaped (< 32 grouped query rows) with the cache write
        folded in and `attn_lengths`: the stale kernel (`attn_writeback`
        'stale'), or with 'splice' and S % 32 == 0 the splice kernel,
        which writes the new rows into the input pools and returns them;
      * head dim H or cache length S not a multiple of 128 (the JAX
        executor's Mosaic gate): the plain twin, as the JAX executor runs
        its XLA twin there;
      * otherwise prefill-shaped (>= 32 rows): `flash_attention_int8_masked`;
      * otherwise decode-shaped with `attn_lengths`:
        `decode_attention_int8_lengths`;
      * otherwise decode-shaped with `attn_dynlen`:
        `decode_attention_int8_dynlen`;
      * otherwise (decode-shaped without `attn_lengths`, the JAX
        executor's default): `decode_attention_int8_masked`.
    A shape that passes the gate but that a CUDA kernel does not take
    raises in its wrapper; nothing falls back to the twin on the card.
    Every decode route (stale, splice, epilogue, lengths, masked) runs in
    `attn_compute`; the flash, live-prefix and twin routes take no mode.
    """
    q_val = self._dequant_view(sg, fusion['q'], env)
    mask = self._dequant_view(sg, fusion['mask'], env)
    k_info = sg.tensors[fusion['k']].quantization
    v_info = sg.tensors[fusion['v']].quantization
    k_scale = float(np.asarray(k_info.scale).reshape(())) * \
        fusion['k_scale_factor']
    v_scale = float(np.asarray(v_info.scale).reshape(()))
    zp_k = float(np.asarray(k_info.zero_point).reshape(()))
    zp_v = float(np.asarray(v_info.zero_point).reshape(()))
    decode_shaped = q_val.shape[2] < 32
    wb = fusion.get('writeback')
    ep = fusion.get('epilogue')
    if wb is not None:
      wb_common = self.attn_lengths and decode_shaped and ep is None
      if wb_common and self.attn_writeback == 'stale':
        # Stale-cache mode: attention reads the pre-write cache plus the
        # new row as an inline softmax column; the cache write runs
        # outside the kernel, consumed only by the signature outputs.
        ctx = attention.decode_attention_int8_lengths_stale(
            q_val.contiguous(), env[wb['k']['operand']],
            env[wb['v']['operand']], k_scale, v_scale,
            _prefix_lengths(mask),
            env[wb['k']['update']].to(torch.int8).contiguous(),
            env[wb['v']['update']].to(torch.int8).contiguous(),
            k_zero_point=zp_k, v_zero_point=zp_v,
            compute=self.attn_compute, out_dtype=self._act_dtype)
        self._write_caches(wb, env)
        out_op = ir.Op(opcode='BATCH_MATMUL', inputs=[],
                       outputs=[fusion['out']])
        self._store_outputs(sg, out_op, (ctx,), env)
        return
      s_wb = env[wb['k']['operand']].shape[2]
      if (wb_common and self.attn_writeback == 'splice'
          and s_wb % attention.WRITEBACK_TILE == 0):
        # Splice mode: the kernel attends over the caches with row pos
        # replaced by the new rows and writes them in (the JAX executor's
        # donated, aliased caches): the step's input pools are its outputs.
        ctx, k_out, v_out = attention.decode_attention_int8_lengths_writeback(
            q_val.contiguous(), env[wb['k']['operand']],
            env[wb['v']['operand']], k_scale, v_scale,
            _prefix_lengths(mask),
            env[wb['k']['update']].to(torch.int8).contiguous(),
            env[wb['v']['update']].to(torch.int8).contiguous(),
            env[wb['k']['starts']][2], k_zero_point=zp_k, v_zero_point=zp_v,
            compute=self.attn_compute, out_dtype=self._act_dtype)
        env[wb['k']['out']] = k_out
        env[wb['v']['out']] = v_out
        out_op = ir.Op(opcode='BATCH_MATMUL', inputs=[],
                       outputs=[fusion['out']])
        self._store_outputs(sg, out_op, (ctx,), env)
        return
      # Fallback: materialize the skipped cache DUS, then proceed unfused.
      self._write_caches(wb, env)
    k_q = env[fusion['k']]
    v_q = env[fusion['v']]
    if ep is not None:
      # The attention-block epilogue: its out projection and residual ops
      # were skipped at match time, so it runs whatever the shape, over the
      # written caches, with lengths from the prefix-form mask. DRQ on the
      # unfused packed FC's gate, so that both agree.
      wo = env[ep['wo_tid']]
      y = attention.decode_attention_oproj(
          q_val, k_q, v_q, k_scale, v_scale, _prefix_lengths(mask),
          self._dequant_view(sg, ep['x_res'], env), wo,
          self._packed_scale[(sg_idx, ep['wo_tid'])], k_zero_point=zp_k,
          v_zero_point=zp_v, compute=self.attn_compute,
          drq=self.int4_drq and wo.shape[1] * 2 <= 8192)
      out_op = ir.Op(opcode='ADD', inputs=[], outputs=[ep['y']])
      self._store_outputs(sg, out_op, (y,), env)
      return
    h_dim = q_val.shape[-1]
    route = attention_route(h_dim, k_q.shape[2], q_val.shape[2],
                            self.attn_lengths, self.attn_dynlen)
    if route == 'flash':
      # Prefill-shaped (R = G * T rows): S-blocked online softmax, so the
      # [R, S] score matrix never materializes.
      ctx = attention.flash_attention_int8_masked(
          q_val, k_q, v_q, k_scale, v_scale, mask,
          k_zero_point=zp_k, v_zero_point=zp_v)
    elif route == 'lengths':
      # Prefix-visibility serving mode: the mask is prefix-form by the
      # serving contract, so per-row lengths replace it.
      ctx = attention.decode_attention_int8_lengths(
          q_val, k_q, v_q, k_scale, v_scale, _prefix_lengths(mask),
          k_zero_point=zp_k, v_zero_point=zp_v, compute=self.attn_compute,
          out_dtype=self._act_dtype)
    elif route == 'dynlen':
      # Live-prefix reads: lengths from the prefix-form mask, the kernel
      # stops each row block at its longest row.
      ctx = attention.decode_attention_int8_dynlen(
          q_val, k_q, v_q, k_scale, v_scale, _prefix_lengths(mask),
          k_zero_point=zp_k, v_zero_point=zp_v)
    elif route == 'masked':
      # The additive mask as the graph gives it (no prefix assumed).
      ctx = attention.decode_attention_int8_masked(
          q_val, k_q, v_q, k_scale, v_scale, mask,
          k_zero_point=zp_k, v_zero_point=zp_v, compute=self.attn_compute)
    else:
      # Plain twin with the same numerics (zp corrections in closed form):
      # the JAX executor's XLA twin, for the shapes its gate keeps off
      # Mosaic.
      qf = q_val.to(torch.float32)
      scores = torch.matmul(qf, k_q.to(torch.float32).transpose(-1, -2))
      scores = scores - zp_k * torch.sum(qf, dim=-1, keepdim=True)
      scores = scores * (k_scale / (h_dim ** 0.5))
      scores = scores + mask.to(torch.float32)
      probs = torch.softmax(scores, dim=-1)
      ctx = (torch.matmul(probs, v_q.to(torch.float32)) - zp_v) * v_scale
    out_op = ir.Op(opcode='BATCH_MATMUL', inputs=[], outputs=[fusion['out']])
    self._store_outputs(sg, out_op, (ctx,), env)

  def _eval_fused_block(self, sg: ir.Subgraph, fusion: dict,
                        env: dict) -> None:
    """One fused MLP+QKV+attention call for a matched unit (the JAX
    executor's `_eval_fused_block`). Lengths come from the prefix-form
    mask, cos and sin of the rows' positions are formed on the device, and
    the write position is the cache update's start on the sequence axis
    (its other starts are 0 in the decode graph). The kernel writes the new
    rows into copies of the pools, so the step's inputs stay unchanged."""
    x_res = self._dequant_view(sg, fusion['x_res'], env)
    b = x_res.shape[0]
    h = fusion['head_dim']
    mask = self._dequant_view(sg, fusion['mask'], env)
    freqs = ops_impl.rope_freqs(fusion['rope_base'], h // 2, self.device)
    ang = env[fusion['positions']][:, 0, None].to(torch.float32) * freqs
    mlp = fusion['mlp']
    wb = fusion['wb']
    k_pool = env[wb['k']['operand']].clone()
    v_pool = env[wb['v']['operand']].clone()
    s = k_pool.shape[2]
    ctx, x_ffn, _, _ = block_lib.fused_mlp_qkv_attention(
        x_res.reshape(b, -1).to(torch.float32),
        self._dequant_view(sg, fusion['g1'], env).reshape(-1),
        env[mlp['wgu_key'][1]],
        self._packed_scale[mlp['wgu_key']],
        env[mlp['wd_grouped_tid']],
        self._packed_scale[mlp['wd_key']],
        self._dequant_view(sg, fusion['g2'], env).reshape(-1),
        env[fusion['wqkv_key'][1]],
        self._packed_scale[fusion['wqkv_key']],
        torch.cos(ang), torch.sin(ang),
        k_pool.view(b, s, h), v_pool.view(b, s, h), _prefix_lengths(mask),
        env[wb['k']['starts']][2],
        fusion['k_scale_eff'], fusion['v_scale'],
        fusion['kq_scale'], fusion['vq_scale'], fusion['nq'],
        k_zero_point=fusion['zp_k'], v_zero_point=fusion['zp_v'],
        act=mlp['act'], eps=fusion['eps'], bf=mlp['bf'],
        compute=self.attn_compute)
    # The unit's four graph tensors, stored as the outputs of one op: the
    # residual stream (f32, cast to the activation dtype), the attention
    # context and the two pools (int8 codes, stored as they are).
    outs = (fusion['x_ffn_out'], fusion['ctx_out'], wb['k']['out'],
            wb['v']['out'])
    values = (x_ffn, ctx, k_pool, v_pool)
    self._store_outputs(
        sg, ir.Op(opcode='FUSED_BLOCK', inputs=[], outputs=list(outs)),
        tuple(v.reshape(sg.tensors[t].shape) for t, v in zip(outs, values)),
        env)

  def _eval_fused_qkv(self, sg_idx: int, sg: ir.Subgraph, fusion: dict,
                      env: dict) -> None:
    """One norm + QKV + RoPE call for a matched prologue: cos and sin of
    the rows' positions formed on this device, DRQ on the unfused packed
    FC's gate; q, k and v stored under the chain's last tensors."""
    w = env[fusion['w_tid']]
    h = fusion['h']
    cos, sin = qkv_lib.rope_cos_sin(env[fusion['positions']], h,
                                    fusion['rope_base'])
    q, k, v = qkv_lib.qkv_rope(
        self._dequant_view(sg, fusion['x'], env),
        self._dequant_view(sg, fusion['gamma'], env), w,
        self._packed_scale[(sg_idx, fusion['w_tid'])], cos, sin,
        nq=fusion['nq'], nk=fusion['nk'], h=h, eps=fusion['eps'],
        drq=self.int4_drq and w.shape[1] * 2 <= 8192)
    for tid, val in ((fusion['q_out'], q), (fusion['k_out'], k),
                     (fusion['v_out'], v)):
      out_op = ir.Op(opcode='RESHAPE', inputs=[], outputs=[tid])
      self._store_outputs(sg, out_op, (val.reshape(sg.tensors[tid].shape),),
                          env)

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
    scale, drq = self.head_mode(sg_idx, fusion, w)
    ids = head_lib.head_argmax(x, w, scale, packed=fusion['packed'],
                               true_n=fusion['true_n'], drq=drq)
    out_op = ir.Op(opcode='ARG_MAX', inputs=[], outputs=[fusion['out']])
    self._store_outputs(sg, out_op, (ids,), env)

  def head_mode(self, sg_idx: int, fusion: dict, w) -> tuple:
    """(scale, drq) of a fused greedy head over its weight w: a packed
    head takes the unfused packed FC's compute mode, so greedy tokens
    agree; an int8 one has DRQ semantics."""
    if fusion['packed']:
      return (self._packed_scale[(sg_idx, fusion['w_tid'])],
              self.int4_drq and w.shape[1] * 2 <= 8192)
    return fusion['scale'], True

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
    key = (sg_idx, op.inputs[1])
    if key in self._packed_int4_keys:
      true_n = self._packed_pad_n.get(key)
      norm = self._norm_fusions.get((sg_idx, op.inputs[0]))
      # The JAX executor's route: a norm-fused input (weight-only whatever
      # int4_drq says), then blockwise, DRQ with K <= 8192, DRQ K-blocked,
      # weight-only.
      bs = self._packed_block_size.get(key, 0)
      if norm is not None and not bs:
        y = packed_qmatmul.qmatmul_int4_packed_rmsnorm(
            self._dequant_view(sg, norm['x'], env),
            self._dequant_view(sg, norm['gamma'], env), w_q,
            self._packed_scale[key],
            bias=None if true_n is not None else bias, eps=norm['eps'])
      else:
        if bs:
          fn = packed_qmatmul.qmatmul_int4_packed_blockwise
        elif self.int4_drq and w_q.shape[1] * 2 <= 8192:
          fn = packed_qmatmul.qmatmul_int4_packed_drq
        elif self.int4_drq:
          fn = packed_qmatmul.qmatmul_int4_packed_drq_kblock
        else:
          fn = packed_qmatmul.qmatmul_int4_packed
        y = fn(self._dequant_view(sg, op.inputs[0], env), w_q,
               self._packed_scale[key],
               bias=None if true_n is not None else bias)
      if true_n is not None:
        y = y[..., :true_n]
        if bias is not None:
          y = y + bias
      y = ops_impl.fused_activation(
          y, op.attrs.get('fused_activation', 'NONE'))
      self._store_outputs(sg, op, (y,), env)
      return

    x_val = env[op.inputs[0]]
    scale, zero_point = self._fc_params(sg_idx, op.inputs[1], q)
    symmetric = zero_point is None
    if x_t.quantization is None:
      if weight_only:
        # Float math against the dequantized weights, never a kernel (the
        # JAX executor's prefer_pallas=False).
        y = qmm.qmatmul_ref(x_val, w_q, scale, zero_point=zero_point,
                            bias=bias, block_size=q.block_size)
      elif symmetric and q.block_size == 0:
        # DRQ: the activation quantized per row on the device.
        y = qmm.drq_matmul(x_val, w_q, scale, bias=bias)
      else:
        y = qmm.qmatmul(x_val, w_q, scale, zero_point=zero_point, bias=bias,
                        block_size=q.block_size)
    else:
      # SRQ: integer activation.
      xq = x_t.quantization
      if (
          symmetric and q.block_size == 0
          and x_val.dtype == torch.int8 and w_q.dtype == torch.int8
          and np.asarray(xq.scale).size == 1
          and self.srq_int
      ):
        # int8 x int8 -> int32, the zero point folded through the weight
        # row sums (the reference's QS8 semantics).
        y = qmm.srq_matmul(
            x_val, np.asarray(xq.scale).reshape(()),
            np.asarray(xq.zero_point).reshape(()), w_q, scale, bias=bias)
      else:
        # Scaled-accumulator fallback (int16 acts, blockwise, asym w).
        x_f = quant_arith.dequantize(x_val, xq)
        y = qmm.qmatmul(x_f, w_q, scale, zero_point=zero_point, bias=bias,
                        block_size=q.block_size)
    y = ops_impl.fused_activation(
        y, op.attrs.get('fused_activation', 'NONE'))
    self._store_outputs(sg, op, (y,), env)
