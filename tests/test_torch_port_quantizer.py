"""The port's Quantizer (recipe -> params -> rewrite -> .aeqg) against the
JAX package's, on the CPU.

Each case quantizes one float graph with one min-max recipe on both sides:
the graphs of tests/fixtures.py (carried to the port's IR field by field)
and the 2-layer MQA decoder at D 256 of the slice tests, built by each
side's builder from one seed as a serving graph with the int8 KV stamp.
The quantized graphs must be equal in every op, tensor, dtype, buffer byte
and quantization parameter bit; the `.aeqg` files they write must be equal
byte for byte, and each package must load the other's file.
"""

import os
import re
import sys

import ml_dtypes
import numpy as np
import pytest

import torch

import fixtures
from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu.graph import serialize as jax_serialize
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.recipe import recipe_utils as jax_recipe_utils
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch.algorithms import manager as algorithm_manager
from ai_edge_quantizer_tpu_torch.algorithms.uniform import quant_numerics
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.graph import ir
from ai_edge_quantizer_tpu_torch.graph import serialize
from ai_edge_quantizer_tpu_torch.graph import tflite_import
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.recipe import recipe_utils
from ai_edge_quantizer_tpu_torch.utils import progress_utils

from test_torch_port_slice import MQA

RECIPES = ('dynamic_wi8_afp32', 'dynamic_legacy_wi8_afp32',
           'dynamic_wi4_afp32', 'dynamic_wi4_afp32_b32',
           'dynamic_wi4_afp32_b64', 'dynamic_wi2_afp32',
           'default_af32w8float', 'default_af32w4float', 'gemma_mixed48',
           'gemma_mixed48_b32', 'gemma_mixed48_b64', 'gemma_mixed48_hr',
           'dynamic_wi4_afp32_hadamard', 'dynamic_wi8_afp32_hadamard',
           'dynamic_wi4_afp32_decomposed_hadamard',
           'dynamic_wi8_afp32_decomposed_hadamard', 'default_fp16')
FIXTURES = ('two_layer_mlp', 'single_fc', 'conv_fc_mnist',
            'shared_weight_two_fc', 'shared_buffer_two_tensors')


def to_port_graph(jgraph):
  """A JAX-package graph as the port's IR, field by field (buffers
  copied)."""
  def quant(q):
    return None if q is None else ir.QuantizationInfo(
        scale=np.array(q.scale), zero_point=np.array(q.zero_point),
        quantized_dimension=q.quantized_dimension, num_bits=q.num_bits,
        block_size=q.block_size)
  return ir.Graph(
      subgraphs=[ir.Subgraph(
          name=sg.name, inputs=list(sg.inputs), outputs=list(sg.outputs),
          tensors=[ir.Tensor(name=t.name, shape=t.shape, dtype=t.dtype,
                             buffer=t.buffer, quantization=quant(
                                 t.quantization)) for t in sg.tensors],
          ops=[ir.Op(opcode=o.opcode, inputs=list(o.inputs),
                     outputs=list(o.outputs), attrs=dict(o.attrs),
                     side_effect_subgraphs=list(o.side_effect_subgraphs))
               for o in sg.ops]) for sg in jgraph.subgraphs],
      buffers=[ir.Buffer(data=None if b.data is None else np.array(b.data))
               for b in jgraph.buffers],
      signatures=[ir.SignatureDef(
          signature_key=s.signature_key, subgraph_index=s.subgraph_index,
          inputs=dict(s.inputs), outputs=dict(s.outputs))
                  for s in jgraph.signatures],
      metadata=dict(jgraph.metadata))


def _array(a):
  a = np.asarray(a)
  return (str(a.dtype), a.shape, a.tobytes())


def graph_record(graph):
  """Every field of a graph, arrays as (dtype, shape, bytes)."""
  subgraphs = []
  for sg in graph.subgraphs:
    tensors = []
    for t in sg.tensors:
      q = t.quantization
      tensors.append((t.name, t.shape, t.dtype, t.buffer, None if q is None
                      else (_array(q.scale), _array(q.zero_point),
                            q.quantized_dimension, q.num_bits,
                            q.block_size)))
    ops = [(o.opcode, list(o.inputs), list(o.outputs), repr(o.attrs),
            list(o.side_effect_subgraphs)) for o in sg.ops]
    subgraphs.append((sg.name, tensors, ops, list(sg.inputs),
                      list(sg.outputs)))
  sigs = [(s.signature_key, s.subgraph_index, dict(s.inputs),
           dict(s.outputs)) for s in graph.signatures]
  buffers = [None if b.data is None else _array(b.data)
             for b in graph.buffers]
  return subgraphs, sigs, buffers, repr(graph.metadata)


def _decoder(mod):
  cfg = mod.DecoderConfig(**MQA)
  graph = mod.build_serving_decoder(
      cfg, batch_slots=4, prefill_len=16, prefill_batch=2,
      prefill_tail_len=8, device_masks=True, fused_projections=True,
      greedy_head=True, prefill_device_masks=True, prefill_greedy=True,
      prefill_head_cols=True)
  mod.stamp_int8_kv_cache(graph)
  return graph


def _float_pair(model):
  """(JAX graph, port graph) of one float model."""
  if model == 'mqa_decoder':
    jgraph, tgraph = _decoder(jax_gemma), _decoder(gemma)
    # Both builders draw the weights from one seed; were they to differ,
    # the JAX side's buffers would be carried across.
    assert graph_record(tgraph) == graph_record(to_port_graph(jgraph))
    return jgraph, tgraph
  jgraph = getattr(fixtures, model)()
  return jgraph, to_port_graph(jgraph)


@pytest.fixture(scope='module')
def aeqg_dir(tmp_path_factory):
  return tmp_path_factory.mktemp('aeqg')


@pytest.mark.parametrize('model', FIXTURES + ('mqa_decoder',))
@pytest.mark.parametrize('recipe', RECIPES)
def test_quantized_graph_and_aeqg_match_jax(recipe, model, aeqg_dir):
  jgraph, tgraph = _float_pair(model)
  try:
    jresult = JaxQuantizer(jgraph, recipe).quantize()
  except Exception as e:  # the port must refuse it the same way
    with pytest.raises(type(e), match=re.escape(str(e)[:60])):
      Quantizer(tgraph, recipe).quantize()
    return
  tresult = Quantizer(tgraph, recipe).quantize()
  assert tresult.recipe == jresult.recipe
  want = graph_record(jresult.quantized_model)
  assert graph_record(tresult.quantized_model) == want
  # The float input graphs are left as they were.
  assert graph_record(tgraph) == graph_record(to_port_graph(jgraph))

  jpath = str(aeqg_dir / f'{recipe}_{model}_jax.aeqg')
  tpath = str(aeqg_dir / f'{recipe}_{model}_port.aeqg')
  jresult.export_model(jpath)
  tresult.export_model(tpath)
  with open(jpath, 'rb') as fj, open(tpath, 'rb') as ft:
    assert ft.read() == fj.read()
  # Each package loads the other's file as the JAX package loads its own
  # (the format stores a 0-d buffer as shape (1,), in both packages).
  loaded = graph_record(jax_serialize.load_graph(jpath))
  assert graph_record(serialize.load_graph(jpath)) == loaded
  assert graph_record(serialize.load_graph(jpath, zero_copy=False)) == loaded
  assert graph_record(jax_serialize.load_graph(tpath)) == loaded


def test_save_writes_model_and_recipe(tmp_path, monkeypatch):
  jgraph, tgraph = _float_pair('two_layer_mlp')
  JaxQuantizer(jgraph, 'gemma_mixed48').quantize().save(
      str(tmp_path / 'jax'), 'm')
  result = Quantizer(tgraph, 'gemma_mixed48').quantize()
  result.save(str(tmp_path / 'port'), 'm')
  for name in ('m.aeqg', 'm_recipe.json'):
    with open(tmp_path / 'jax' / name, 'rb') as fj, open(
        tmp_path / 'port' / name, 'rb') as ft:
      assert ft.read() == fj.read(), name
  with pytest.raises(FileExistsError):
    result.save(str(tmp_path / 'port'), 'm')
  # A graph loaded from a path or from bytes.
  path = str(tmp_path / 'port' / 'm.aeqg')
  with open(path, 'rb') as f:
    data = f.read()
  for source in (path, data):
    assert graph_record(Quantizer(source).float_model) == graph_record(
        result.quantized_model)
  # A .tflite path and TFLite bytes go to the port's TFLite importer
  # (held against the JAX package's in tests/test_torch_port_tflite.py).
  seen = []
  monkeypatch.setattr(tflite_import, 'load_tflite',
                      lambda model: seen.append(model) or 'imported')
  assert serialize.load_model('model.tflite') == 'imported'
  assert serialize.load_model(b'\0\0\0\0TFL3') == 'imported'
  assert seen == ['model.tflite', b'\0\0\0\0TFL3']


def test_named_recipes_resolve_as_in_jax():
  stock = [f[:-len('_recipe.json')] for f in os.listdir(os.path.join(
      os.path.dirname(recipe_utils.__file__), 'recipes'))
           if f.endswith('_recipe.json')]
  names = set(RECIPES) | set(stock) | {'default_a8w8', 'default_fp16'}
  for name in sorted(names) + ['gemma_mixed48_recipe',
                               'dynamic_wi8_afp32_recipe.json']:
    assert recipe_utils.resolve_recipe(name) == \
        jax_recipe_utils.resolve_recipe(name), name
  assert recipe_utils.resolve_recipe_mapping('gemma_mixed48_b32') == \
      jax_recipe_utils.resolve_recipe_mapping('gemma_mixed48_b32')


@pytest.mark.parametrize('recipe', ['default_a8w8', 'default_a16w8'])
def test_static_recipe_needs_calibration(recipe):
  """A static recipe refuses to quantize without QSVs, as in the JAX
  package; `calibrate` (on the CPU here) gives the JAX package's QSVs:
  the input's exactly, the FC output's within 1e-5 (XLA's CPU dot sums in
  another order); from the same QSVs the quantized graphs are equal."""
  jgraph, tgraph = _float_pair('single_fc')
  jq, tq = JaxQuantizer(jgraph, recipe), Quantizer(tgraph, recipe)
  assert tq.need_calibration and jq.need_calibration
  with pytest.raises(RuntimeError, match='QSVs'):
    jq.quantize()
  with pytest.raises(RuntimeError, match='QSVs'):
    tq.quantize()
  data = {'serving_default': [
      {'x': np.random.default_rng(i).normal(size=(2, 64)).astype(np.float32)}
      for i in range(2)]}
  want, got = jq.calibrate(data), tq.calibrate(data, device='cpu')
  assert set(got) == set(want)
  for name, qsv in want.items():
    assert set(got[name]) == set(qsv)
    for field, v in qsv.items():
      if name == 'x':
        np.testing.assert_array_equal(got[name][field], v)
      else:
        np.testing.assert_allclose(got[name][field], v, rtol=1e-5)
  assert graph_record(tq.quantize(want).quantized_model) == graph_record(
      to_port_graph(jq.quantize(want).quantized_model))
  assert not Quantizer(tgraph, 'dynamic_wi8_afp32').need_calibration
  assert Quantizer(tgraph, 'dynamic_wi8_afp32').calibrate({}) == {}


@pytest.mark.parametrize('recipe,module', [
    ('dynamic_wi4_afp32_gptq_octav', 'gptq.py|octav.py')])
def test_unported_algorithms_raise(recipe, module):
  """No algorithm module is left unported: the GPTQ recipe, once refused
  for want of `module`, now needs calibration as in the JAX package, and
  from the same QSVs quantizes to the JAX package's graph."""
  assert not any(re.search(module, m)
                 for m in algorithm_manager.UNPORTED_ALGORITHMS.values())
  jgraph, tgraph = _float_pair('single_fc')
  jq, tq = JaxQuantizer(jgraph, recipe), Quantizer(tgraph, recipe)
  with pytest.raises(RuntimeError, match='QSVs'):
    tq.quantize()
  data = {'serving_default': [
      {'x': np.random.default_rng(3).normal(size=(2, 64)).astype(
          np.float32)}]}
  qsvs = jq.calibrate(data)
  assert graph_record(tq.quantize(qsvs).quantized_model) == graph_record(
      to_port_graph(jq.quantize(qsvs).quantized_model))


def test_validate_is_not_ported():
  """validate() needs a quantized model, as in the JAX package, then
  gives the JAX package's per-tensor metrics (on the CPU here; the float
  sums' orders move an mse by far less than METRIC_RTOL)."""
  jgraph, tgraph = _float_pair('single_fc')
  jq = JaxQuantizer(jgraph, 'dynamic_wi8_afp32')
  qt = Quantizer(tgraph, 'dynamic_wi8_afp32')
  with pytest.raises(ValueError, match='No quantized model'):
    qt.validate(device='cpu')
  jq.quantize()
  qt.quantize()
  want = jq.validate(num_samples=2)
  got = qt.validate(num_samples=2, device='cpu')
  for key in want.available_signature_keys():
    w = want.get_signature_comparison_result(key).all_tensors()
    g = got.get_signature_comparison_result(key).all_tensors()
    assert set(g) == set(w)
    for name, v in w.items():
      assert np.isclose(g[name], v, rtol=1e-2, atol=1e-12), name


def test_load_config_policy_matches_jax():
  """A policy file merged into the default policy, as the JAX package
  merges it: both quantizers give the same graph after it."""
  policy = os.path.join(os.path.dirname(recipe_utils.__file__), 'policies',
                        'strict_fc_int4_policy.json')
  records = []
  for q_cls, graph in zip((JaxQuantizer, Quantizer),
                          _float_pair('two_layer_mlp')):
    qt = q_cls(graph, 'gemma_mixed48')
    try:
      qt.load_config_policy(policy)
      records.append(graph_record(qt.quantize().quantized_model))
    finally:
      qt.load_config_policy('{}')
  assert records[1] == records[0]


def test_fp16_grid_rounding_matches_ml_dtypes():
  """f32 -> bf16 -> fp16 through torch equals ml_dtypes bit for bit: every
  bf16 value (every second rounding, fp16 subnormals and overflow past
  65504 included), f32 values half way between two bf16 values (ties to
  even), and random scales of every magnitude."""
  every_bf16 = (np.arange(2**16, dtype=np.uint32) << 16).view(np.float32)
  every_bf16 = every_bf16[np.isfinite(every_bf16)]
  rng = np.random.default_rng(0)
  ties = ((rng.integers(0, 2**15, 4096, dtype=np.uint32) << 16)
          | np.uint32(0x8000)).view(np.float32)
  ties = ties[np.isfinite(ties)]
  scales = np.exp2(rng.uniform(-30, 20, 4096)).astype(np.float32)
  for values in (every_bf16, ties, scales, np.float32(65280.0),
                 np.float32(70000.0), np.zeros((3, 0), np.float32)):
    want = np.asarray(values).astype(ml_dtypes.bfloat16).astype(np.float16)
    got = quant_numerics.round_to_fp16_grid(values)
    assert got.dtype == np.float16 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize('num_bits', [4, 2])
def test_subbyte_packing_matches_jax(num_bits):
  """The port's faster pack and unpack write and read the JAX package's
  bytes, at every length modulo the values a byte holds."""
  from ai_edge_quantizer_tpu.algorithms.uniform import quant_numerics as jqn
  rng = np.random.default_rng(num_bits)
  half = 1 << (num_bits - 1)
  for n in (0, 1, 2, 3, 5, 1001, 4096):
    a = rng.integers(-half, half, n).astype(np.int8)
    packed = quant_numerics.pack_subbyte(a, num_bits)
    want = jqn.pack_subbyte(a, num_bits)
    assert packed.dtype == want.dtype and packed.tobytes() == want.tobytes()
    got = quant_numerics.unpack_subbyte(want, num_bits, n)
    assert got.dtype == np.int8 and got.tolist() == a.tolist()


def test_progress_bar_turns_off_without_tqdm(monkeypatch):
  monkeypatch.setitem(sys.modules, 'tqdm', None)  # import tqdm fails
  with progress_utils.ProgressBar(1000, 'steps') as bar:
    assert bar._bar is None
    bar.update_single_step()


def test_executor_loads_a_mapped_graph_without_copies_into_the_map(
    tmp_path, recwarn):
  """Buffers of a zero-copy load are read-only views of the file: the
  executor copies them to its device without a warning and never writes
  into the map; one buffer is loaded once, whatever aliases it."""
  _, tgraph = _float_pair('mqa_decoder')
  result = Quantizer(tgraph, 'gemma_mixed48').quantize()
  path = str(tmp_path / 'm.aeqg')
  result.export_model(path)
  loaded = serialize.load_graph(path)
  datas = [b.data for b in loaded.buffers if b.data is not None]
  assert any(not d.flags.writeable for d in datas)
  before = [d.copy() for d in datas]
  ex = executor.GraphExecutor(loaded, device='cpu')
  assert not [w for w in recwarn if 'writable' in str(w.message)]
  for key, value in ex._weights.items():
    value.add_(0)  # a write lands in the executor's own memory
  assert all(np.array_equal(a, b) for a, b in zip(datas, before))
  by_buffer = {}
  for (sg_idx, tid), value in ex._weights.items():
    t = loaded.subgraphs[sg_idx].tensors[tid]
    by_buffer.setdefault((t.buffer, t.dtype), set()).add(id(value))
  assert all(len(ids) == 1 for ids in by_buffer.values())
  assert len(by_buffer) < len(ex._weights)  # signatures share buffers
