"""Calibrator: the CALIBRATE pass.

Runs the float model on sample data with every tensor captured, then
sweeps each op, dispatching its algorithm's calibration function and
merging QSVs (EMA by default). Results are JSON-serializable and
resumable.

Parity: reference `calibrator.py` (`_PreserveAllTensorsCalibrator` flow).

Port of `ai_edge_quantizer_tpu/pipeline/calibrator.py`. The float model
runs in the port's `GraphExecutor` on one torch device (`device`, the card
unless the caller asks for 'cpu') with float32 activations and the JAX
executor's default options (`executor.JAX_DEFAULT_OPTIONS`), as the JAX
calibrator's executor runs. In 'capture' mode every tensor comes back to
the host; 'device_stats' reduces min, max and GPTQ Hessians on the device
(`GraphExecutor.stats_runner`) and brings back only those. A signature
whose plan reaches a composite's side-effect subgraph falls back to
capture in the JAX package; the port runs no composite yet (the executor
raises for STABLEHLO_COMPOSITE), so such a model does not calibrate.
"""

from __future__ import annotations


from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms import manager as algorithm_manager
from ai_edge_quantizer_tpu_torch.algorithms.registry import AlgorithmName
from ai_edge_quantizer_tpu_torch.execution import executor as executor_lib
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.recipe import recipe_manager as rm
from ai_edge_quantizer_tpu_torch.utils import calibration_utils


class Calibrator:
  """Collects per-tensor quantization statistics from sample data."""

  def __init__(self, float_graph: ir.Graph, mode: str = 'capture',
               device='cuda'):
    """mode: 'capture' (host-side per-tensor contents, the reference's
    preserve_all_tensors analog) or 'device_stats' (min/max + GPTQ
    Hessians reduced on device in the forward pass — the profiler-based
    calibrator analog, ref calibrator.py:590-686; only the statistics
    cross to the host). device: the torch device the model runs on."""
    if mode not in ('capture', 'device_stats', 'inference_only'):
      raise ValueError(f'Unknown calibration mode {mode!r}.')
    self._graph = float_graph
    self._mode = mode
    if not ir.is_float_model(float_graph):
      # Match the reference: partially-quantized models calibrate fine (the
      # executor runs them and captures dequantized tensor views); only the
      # still-float tensors' QSVs will feed re-quantization.
      import warnings
      warnings.warn(
          'Calibrating a partially quantized model; existing quantized '
          'tensors will remain unchanged.')
    self._executor = executor_lib.GraphExecutor(
        float_graph, device=device, activation_dtype='float32',
        **executor_lib.JAX_DEFAULT_OPTIONS)
    self._model_qsvs: dict = {}
    self._initialized_ops: set = set()
    self._num_samples: int = 0

  # -- public API -----------------------------------------------------------

  def calibrate(
      self,
      calibration_dataset: dict,
      model_recipe_manager: rm.RecipeManager,
  ) -> None:
    """calibration_dataset: {signature_key: iterable of {input_name: array}}."""
    if self._mode == 'inference_only':
      # Parity: reference _InferenceOnlyCalibrator (calibrator.py:454-481)
      # — an inference backend only; calibration is a hard error.
      raise NotImplementedError(
          'inference_only mode does not support calibration.')
    op_plans = {
        key: self._plan_for_signature(key, model_recipe_manager)
        for key in calibration_dataset
    }
    for signature_key, samples in calibration_dataset.items():
      plan = op_plans[signature_key]
      sig = self._graph.signature_by_key(signature_key)
      # device_stats covers only the signature's own subgraph; composite
      # side-effect subgraph tensors are invisible to the stats program,
      # so such signatures fall back to capture mode (correctness over
      # transfer savings).
      use_device_stats = self._mode == 'device_stats' and all(
          sg_idx == sig.subgraph_index for sg_idx, *_ in plan)
      from ai_edge_quantizer_tpu_torch.utils import progress_utils
      try:
        n_samples = len(samples)
      except TypeError:
        n_samples = 0
      bar = progress_utils.ProgressBar(
          n_samples, description=f'Calibrating {signature_key}',
          disappear_on_finish=True)
      if use_device_stats:
        runner = self._executor.stats_runner(
            signature_key,
            hessian_tensor_names=self._hessian_names(plan))
        for sample in samples:
          stats = runner(sample)
          self._calibrate_step_stats(plan, stats)
          self._num_samples += 1
          bar.update_single_step()
        bar.close()
        continue
      runner = self._executor.signature_runner(
          signature_key, capture_all=True)
      for sample in samples:
        tensor_content_map = runner(sample)
        self._calibrate_step(plan, tensor_content_map)
        self._num_samples += 1
        bar.update_single_step()
      bar.close()

  def get_model_qsvs(self) -> dict:
    return self._model_qsvs

  def get_num_samples_calibrated(self) -> int:
    return self._num_samples

  def reset_model_qsvs(self) -> None:
    """Parity: reference calibrator.py:348-352."""
    self._model_qsvs = {}
    self._initialized_ops = set()
    self._num_samples = 0

  def load_model_qsvs(self, qsvs) -> None:
    """Load previous QSVs from a dict or a saved-calibration JSON path.

    A path restores the `num_samples_calibrated` resume metadata so a
    resumed run's saved count keeps accumulating (parity: reference
    calibrator.py:354-369).
    """
    if isinstance(qsvs, str):
      self._model_qsvs, metadata = (
          calibration_utils.load_qsvs_from_json(qsvs))
      self._num_samples = int(metadata.get('num_samples_calibrated', 0))
    else:
      self._model_qsvs = dict(qsvs)
    # Treat all previously known ops as initialized.
    self._initialized_ops = set()

  def save_calibration_result(self, path: str,
                              extra_metadata: dict | None = None) -> None:
    calibration_utils.save_qsvs_to_json(
        self._model_qsvs, path, num_samples=self._num_samples,
        extra_metadata=extra_metadata)

  def signature_runner(self, signature_key: str,
                       model_recipe_manager: rm.RecipeManager):
    """A drop-in inference runner that calibrates as a side effect.

    Use inside an existing evaluation harness: call it like a normal model
    and QSVs accumulate with every invocation (the analog of the
    reference's CalibrationInterpreter / CalibrationSignatureRunner,
    calibrator.py:72-188).
    """
    plan = self._plan_for_signature(signature_key, model_recipe_manager)
    capture_runner = self._executor.signature_runner(
        signature_key, capture_all=True)
    sig = self._graph.signature_by_key(signature_key)
    sg = self._graph.subgraphs[sig.subgraph_index]

    def run(inputs: dict) -> dict:
      tensor_content_map = capture_runner(inputs)
      self._calibrate_step(plan, tensor_content_map)
      self._num_samples += 1
      return {
          name: tensor_content_map[sg.tensors[tid].name]
          for name, tid in sig.outputs.items()
      }

    return run

  # -- internals ------------------------------------------------------------

  def _plan_for_signature(
      self, signature_key: str, model_recipe_manager: rm.RecipeManager
  ) -> list:
    """Resolve per-op (algorithm, config) once per signature."""
    sig = self._graph.signature_by_key(signature_key)
    sg_indices = [sig.subgraph_index]
    plan = []
    seen = set()
    while sg_indices:
      sg_idx = sg_indices.pop(0)
      if sg_idx in seen:
        continue
      seen.add(sg_idx)
      sg = self._graph.subgraphs[sg_idx]
      # Real ops first, then virtual INPUT/OUTPUT ops — the reference
      # appends IOOperators during calibration (ref calibrator.py:440-443)
      # so even subgraph inputs no real op consumes get QSVs (e.g. the
      # dead cache inputs in toy_model_with_kv_cache_multi_signature).
      work_items = [(op_id, op) for op_id, op in enumerate(sg.ops)]
      work_items.append((qtyping.VIRTUAL_INPUT_OP_ID, ir.Op(
          opcode=qtyping.OpName.INPUT.value, inputs=[],
          outputs=list(sg.inputs))))
      work_items.append((qtyping.VIRTUAL_INPUT_OP_ID, ir.Op(
          opcode=qtyping.OpName.OUTPUT.value, inputs=list(sg.outputs),
          outputs=[])))
      for op_id, op in work_items:
        try:
          op_key = qtyping.OpName(op.opcode)
        except ValueError:
          continue
        if op_key in (qtyping.OpName.QUANTIZE, qtyping.OpName.DEQUANTIZE):
          continue
        scope = ir.get_op_scope(sg, op)
        algorithm_name, op_quant_config = (
            model_recipe_manager.get_quantization_configs(op_key, scope)
        )
        if algorithm_name == AlgorithmName.NO_QUANTIZE:
          continue
        try:
          algorithm_manager.get_quantization_func(
              algorithm_name, op_key, qtyping.QuantizeMode.CALIBRATE)
        except ValueError:
          # The resolved algorithm has no calibration binding for this op
          # (e.g. GPTQ admitted via skip_checks resolving for a virtual
          # INPUT op): skip, same as the recipe layer's silent-skip rule.
          continue
        # Composite side-effect subgraphs calibrate too.
        sg_indices.extend(op.side_effect_subgraphs)
        plan.append((sg_idx, op_id, op, op_key, algorithm_name,
                     op_quant_config))
    return plan

  def _hessian_names(self, plan: list) -> set:
    """Activation tensors needing on-device GPTQ Hessians (FC inputs)."""
    names = set()
    for sg_idx, op_id, op, op_key, algorithm_name, _ in plan:
      if algorithm_name != AlgorithmName.GPTQ:
        continue
      sg = self._graph.subgraphs[sg_idx]
      # gptq.calibrate collects inputs AND outputs (Hessians for both).
      for tid in list(op.inputs) + list(op.outputs):
        if tid < 0:
          continue
        t = sg.tensors[tid]
        is_const = (t.buffer >= 0
                    and self._graph.buffers[t.buffer].data is not None)
        if not is_const and t.dtype == 'float32':
          names.add(t.name)
    return names

  def _calibrate_step_stats(self, plan: list, stats: dict) -> None:
    """Merge on-device QSV stats per planned op (device_stats mode)."""
    from ai_edge_quantizer_tpu_torch.algorithms.uniform import op_library

    for sg_idx, op_id, op, op_key, algorithm_name, op_quant_config in plan:
      sg = self._graph.subgraphs[sg_idx]
      self._maybe_init_op(sg_idx, op_id, op, op_key, algorithm_name,
                          op_quant_config)
      spec = op_library.OP_SPECS.get(op_key)
      in_ignore = set(spec.inputs_to_ignore) if spec else set()
      out_ignore = set(spec.outputs_to_ignore) if spec else set()
      op_qsvs: dict = {}
      for pos, tid in enumerate(op.inputs):
        if tid >= 0 and pos not in in_ignore:
          name = sg.tensors[tid].name
          if name in stats:
            op_qsvs[name] = stats[name]
      for pos, tid in enumerate(op.outputs):
        if tid >= 0 and pos not in out_ignore:
          name = sg.tensors[tid].name
          if name in stats:
            op_qsvs[name] = stats[name]
      update_fn = algorithm_manager.get_update_qsv_fn(algorithm_name, op_key)
      for name, new_qsv in op_qsvs.items():
        # Hessians ride only on GPTQ-planned consumers.
        if algorithm_name != AlgorithmName.GPTQ and 'hessian' in new_qsv:
          new_qsv = {k: v for k, v in new_qsv.items()
                     if k not in ('hessian', 'num_samples')}
        elif 'num_samples' in new_qsv:
          new_qsv = dict(new_qsv)
          new_qsv['num_samples'] = int(new_qsv['num_samples'])
        old = self._model_qsvs.get(name)
        if old is None or not old:
          self._model_qsvs[name] = new_qsv
        else:
          self._model_qsvs[name] = update_fn(old, new_qsv)

  def _maybe_init_op(self, sg_idx: int, op_id: int, op, op_key,
                     algorithm_name, op_quant_config) -> None:
    op_token = (sg_idx, op_id, op_key)
    if op_token in self._initialized_ops:
      return
    sg = self._graph.subgraphs[sg_idx]
    graph_info = qtyping.GraphInfo(subgraph=sg, buffers=self._graph.buffers)
    op_info = qtyping.OpInfo(
        op=op, op_name=op_key, subgraph_op_index=op_id,
        op_quant_config=op_quant_config)
    init_fn = algorithm_manager.get_init_qsv_fn(algorithm_name, op_key)
    if init_fn is not None:
      for name, qsv in init_fn(op_info, graph_info).items():
        self._model_qsvs.setdefault(name, qsv)
    self._initialized_ops.add(op_token)

  def _calibrate_step(self, plan: list, tensor_content_map: dict) -> None:
    for sg_idx, op_id, op, op_key, algorithm_name, op_quant_config in plan:
      sg = self._graph.subgraphs[sg_idx]
      graph_info = qtyping.GraphInfo(
          subgraph=sg, buffers=self._graph.buffers)
      op_info = qtyping.OpInfo(
          op=op, op_name=op_key, subgraph_op_index=op_id,
          op_quant_config=op_quant_config)
      # One-time QSV init (weight min/max etc.).
      self._maybe_init_op(sg_idx, op_id, op, op_key, algorithm_name,
                          op_quant_config)
      calib_fn = algorithm_manager.get_quantization_func(
          algorithm_name, op_key, qtyping.QuantizeMode.CALIBRATE)
      op_qsvs = calib_fn(op, graph_info, tensor_content_map)
      update_fn = algorithm_manager.get_update_qsv_fn(algorithm_name, op_key)
      for name, new_qsv in op_qsvs.items():
        old = self._model_qsvs.get(name)
        if old is None or not old:
          self._model_qsvs[name] = new_qsv
        else:
          self._model_qsvs[name] = update_fn(old, new_qsv)
