"""Dual-model numerical validator.

Runs the float reference and the quantized target with every tensor
captured, compares the dequantized views of every shared tensor (or outputs
only) per signature, and averages over samples. Results classify into
input/output/constant/intermediate buckets and export to JSON (including a
Model-Explorer-style color-threshold dump).

Parity: reference `model_validator.py`.

Port of `ai_edge_quantizer_tpu/execution/model_validator.py`. Both models
run in the port's `GraphExecutor` on one torch device (`device`, the card
unless the caller asks for 'cpu'), each fresh executor with float32
activations and the JAX executor's default options, as the JAX
validator's run; the metrics are the same numpy functions
(`validation_utils`) over the captured tensors on the host.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional

import numpy as np

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.uniform import quant_numerics as qn
from ai_edge_quantizer_tpu_torch.execution import executor as executor_lib
from ai_edge_quantizer_tpu_torch.execution import validation_utils
from ai_edge_quantizer_tpu_torch.graph import ir


@dataclasses.dataclass
class SingleSignatureComparisonResult:
  """Per-signature metric values, bucketed by tensor role."""

  error_metric: str
  input_tensors: dict
  output_tensors: dict
  constant_tensors: dict
  intermediate_tensors: dict

  def all_tensors(self) -> dict:
    out: dict = {}
    for bucket in (self.input_tensors, self.output_tensors,
                   self.constant_tensors, self.intermediate_tensors):
      out.update(bucket)
    return out


class ComparisonResult:
  """Whole-model comparison across signatures."""

  def __init__(self, reference_graph: ir.Graph, target_graph: ir.Graph):
    self._reference_graph = reference_graph
    self._target_graph = target_graph
    self._signature_results: dict = {}

  def add_new_signature_results(
      self,
      error_metric: str,
      comparison_results: dict,
      signature_key: str,
  ) -> None:
    if signature_key in self._signature_results:
      raise ValueError(f'Signature {signature_key} already has results.')
    sig = self._target_graph.signature_by_key(signature_key)
    sg = self._target_graph.subgraphs[sig.subgraph_index]
    input_names = {sg.tensors[t].name for t in sg.inputs}
    # Graph outputs, resolved through rewrite-inserted QUANTIZE /
    # DEQUANTIZE tails: the quantized model's output tensor is often
    # `X_dequant` (absent from the float model), while `X` — the tensor
    # actually compared — would otherwise land in the intermediate
    # bucket and leave output_tensors empty (ref model_validator buckets
    # by the signature-visible output, model_validator.py:97-158).
    producer_of = {}
    for o in sg.ops:
      for tid in o.outputs:
        producer_of[tid] = o
    output_names = set()
    for t in sg.outputs:
      output_names.add(sg.tensors[t].name)
      seen = 0
      while seen < 8:  # bounded walk through inserted (de)quant tails
        op = producer_of.get(t)
        if op is None or op.opcode not in ('QUANTIZE', 'DEQUANTIZE'):
          break
        t = op.inputs[0]
        output_names.add(sg.tensors[t].name)
        seen += 1
    constants = {
        t.name for t in sg.tensors
        if t.buffer >= 0
        and self._target_graph.buffers[t.buffer].data is not None
    }
    buckets = SingleSignatureComparisonResult(
        error_metric=error_metric, input_tensors={}, output_tensors={},
        constant_tensors={}, intermediate_tensors={})
    for name, value in comparison_results.items():
      if name in input_names:
        buckets.input_tensors[name] = value
      elif name in output_names:
        buckets.output_tensors[name] = value
      elif name in constants:
        buckets.constant_tensors[name] = value
      else:
        buckets.intermediate_tensors[name] = value
    self._signature_results[signature_key] = buckets

  def get_signature_comparison_result(
      self, signature_key: str = 'serving_default'
  ) -> SingleSignatureComparisonResult:
    return self._signature_results[signature_key]

  def get_all_tensor_results(self) -> dict:
    out: dict = {}
    for res in self._signature_results.values():
      out.update(res.all_tensors())
    return out

  def available_signature_keys(self) -> list:
    return list(self._signature_results)

  def get_model_size_reduction(self) -> tuple:
    """(bytes reduced, fraction reduced)."""
    ref_bits = self._reference_graph.total_constant_bits()
    tgt_bits = self._target_graph.total_constant_bits()
    reduction = (ref_bits - tgt_bits) / 8
    return reduction, reduction * 8 / max(ref_bits, 1)

  def save(self, save_folder: str, model_name: str) -> None:
    result = {
        sig: {
            'error_metric': res.error_metric,
            'input_tensors': res.input_tensors,
            'output_tensors': res.output_tensors,
            'constant_tensors': res.constant_tensors,
            'intermediate_tensors': res.intermediate_tensors,
        }
        for sig, res in self._signature_results.items()
    }
    reduction_bytes, reduction_frac = self.get_model_size_reduction()
    result['reduced_size_bytes'] = reduction_bytes
    result['reduced_size_percentage'] = reduction_frac * 100
    with open(f'{save_folder}/{model_name}_comparison_result.json', 'w') as f:
      json.dump(result, f, indent=2, default=float)
    color_json = create_json_for_model_explorer(
        self, list(self.get_all_tensor_results().values()))
    with open(
        f'{save_folder}/{model_name}_comparison_result_me_input.json', 'w'
    ) as f:
      f.write(color_json)


def create_json_for_model_explorer(result: ComparisonResult,
                                   thresholds: list) -> str:
  """Color-threshold JSON for visual per-tensor diffing."""
  data = result.get_all_tensor_results()
  values = [float(v) for v in thresholds] if thresholds else [0.0]
  lo, hi = min(values), max(values)
  steps = np.linspace(lo, hi, num=5) if hi > lo else [lo]
  gradient = [
      {'stop': float(s), 'bgColor': color}
      for s, color in zip(
          steps, ['#00ff00', '#aaff00', '#ffff00', '#ffaa00', '#ff0000'])
  ]
  return json.dumps({
      'results': {k: float(v) for k, v in data.items()},
      'thresholds': gradient,
  })


def _dequantized_view(graph: ir.Graph, sg: ir.Subgraph, name_to_tid: dict,
                      name: str, value: np.ndarray) -> np.ndarray:
  t = sg.tensors[name_to_tid[name]]
  if t.quantization is None:
    return np.asarray(value)
  q = t.quantization
  params = qtyping.UniformQuantParams(
      num_bits=q.num_bits, quantized_dimension=q.quantized_dimension,
      scale=np.asarray(q.scale), zero_point=np.asarray(q.zero_point),
      block_size=q.block_size)
  return qn.dequantize_array(np.asarray(value), params)


def compare_model(
    reference_graph: ir.Graph,
    target_graph: ir.Graph,
    signature_test_data: dict,
    error_metric: str = 'mse',
    compare_fn: Optional[Callable] = None,
    compare_outputs_only: bool = False,
    target_executor: Optional['executor_lib.GraphExecutor'] = None,
    use_serving_paths: bool = False,
    device='cuda',
) -> ComparisonResult:
  """Compare target (quantized) vs reference (float) model numerically.

  signature_test_data: {signature_key: [ {input_name: array}, ... ]}.

  target_executor: validate a pre-configured executor (e.g. after
  prepare_serving_weights()) instead of a fresh one — the packed serving
  configuration stays per-tensor validator-visible (packed weights are
  captured as their unpacked int8 view). use_serving_paths keeps the
  fused serving kernels engaged during capture. device: where the
  reference model (and the target, without target_executor) runs.
  """
  compare_fn = compare_fn or validation_utils.get_validation_func(error_metric)

  def fresh(graph):
    return executor_lib.GraphExecutor(
        graph, device=device, activation_dtype='float32',
        **executor_lib.JAX_DEFAULT_OPTIONS)

  ref_exec = fresh(reference_graph)
  tgt_exec = target_executor or fresh(target_graph)
  result = ComparisonResult(reference_graph, target_graph)

  for signature_key, samples in signature_test_data.items():
    ref_runner = ref_exec.signature_runner(
        signature_key, capture_all=not compare_outputs_only)
    tgt_runner = tgt_exec.signature_runner(
        signature_key, capture_all=not compare_outputs_only,
        serving_fastpaths=use_serving_paths)
    ref_sig = reference_graph.signature_by_key(signature_key)
    tgt_sig = target_graph.signature_by_key(signature_key)
    ref_sg = reference_graph.subgraphs[ref_sig.subgraph_index]
    tgt_sg = target_graph.subgraphs[tgt_sig.subgraph_index]
    ref_ids = {t.name: i for i, t in enumerate(ref_sg.tensors)}
    tgt_ids = {t.name: i for i, t in enumerate(tgt_sg.tensors)}

    accumulated: dict = {}
    count = 0
    for sample in samples:
      ref_out = ref_runner(sample)
      tgt_out = tgt_runner(sample)
      if compare_outputs_only:
        # Key by tensor name (signature outputs map user names -> tensors).
        ref_out = {
            ref_sg.tensors[ref_sig.outputs[k]].name: v
            for k, v in ref_out.items()
        }
        tgt_out = {
            tgt_sg.tensors[tgt_sig.outputs[k]].name: v
            for k, v in tgt_out.items()
        }
      shared = set(ref_out) & set(tgt_out)
      for name in shared:
        ref_val = _dequantized_view(reference_graph, ref_sg, ref_ids, name,
                                    ref_out[name])
        tgt_val = _dequantized_view(target_graph, tgt_sg, tgt_ids, name,
                                    tgt_out[name])
        if ref_val.size != tgt_val.size:
          continue
        accumulated[name] = accumulated.get(name, 0.0) + float(
            compare_fn(tgt_val, ref_val))
      count += 1
    averaged = {k: v / max(count, 1) for k, v in accumulated.items()}
    result.add_new_signature_results(error_metric, averaged, signature_key)
  return result
