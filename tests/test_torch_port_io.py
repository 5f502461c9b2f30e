"""The port's I/O modules and CLI against the JAX package's, on the CPU:
`graph/litertlm.py` (the bytes it writes), `models/bundles.py` (`.aeqb`
files each package reads from the other, `quantize_bundle`), `cli.py`
(`--device cpu`: the same files as the JAX CLI's from `.aeqg`, `.aeqb` and
`.litertlm` inputs; `--help` in a clean process without jax),
`graph/checkpoint.py` (a round trip; `shardings` refused),
`graph/torch_import.py` (the same IR from the same module) and
`utils/native_packing.py` (the C++ packer's bytes, and `.aeqg` files the
same with and without it). The graphs are the JAX tests' (tests/fixtures.py,
JAX's `_toy_bundle`), carried to the port's IR field by field.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn

import fixtures
import test_litertlm as jax_litertlm_tests
from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu import cli as jax_cli
from ai_edge_quantizer_tpu.graph import checkpoint as jax_checkpoint
from ai_edge_quantizer_tpu.graph import litertlm as jax_litertlm
from ai_edge_quantizer_tpu.graph import serialize as jax_serialize
from ai_edge_quantizer_tpu.graph import torch_import as jax_torch_import
from ai_edge_quantizer_tpu.models import bundles as jax_bundles
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.recipe import recipe as jax_recipe_presets
from ai_edge_quantizer_tpu_torch import Quantizer, cli
from ai_edge_quantizer_tpu_torch.algorithms.uniform import quant_numerics as qn
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.graph import checkpoint
from ai_edge_quantizer_tpu_torch.graph import litertlm
from ai_edge_quantizer_tpu_torch.graph import serialize
from ai_edge_quantizer_tpu_torch.graph import torch_import
from ai_edge_quantizer_tpu_torch.models import bundles
from ai_edge_quantizer_tpu_torch.recipe import recipe as recipe_presets
from ai_edge_quantizer_tpu_torch.utils import native_packing

from test_torch_port_imports import ROOT, _clean_env
from test_torch_port_quantizer import graph_record, to_port_graph

JAX_OPTS = dict(activation_dtype='float32', **executor.JAX_DEFAULT_OPTIONS)


def _read(path):
  with open(path, 'rb') as f:
    return f.read()


# -- .litertlm -----------------------------------------------------------------


def _sections(mod):
  """tests/test_litertlm.py's sections and metadata, for one package."""
  return ([(b'tokenizer-bytes' * 100, mod.SECTION_GENERIC_BINARY,
            {'model_type': 'tokenizer', 'vocab': 32000}),
           (b'MDLB' + bytes(range(256)) * 10, mod.SECTION_TFLITE_MODEL,
            {'model_type': 'tf_lite_prefill_decode'}),
           (b'three', 1, {})],
          {'Authors': 'aeqt'})


def test_write_litertlm_bytes_match_jax(tmp_path):
  """The same sections give the same file; the port reads it back; a
  re-serialization with an override (a payload over one block) gives the
  JAX package's bytes too."""
  paths = {}
  for name, mod in (('jax', jax_litertlm), ('port', litertlm)):
    secs, meta = _sections(mod)
    paths[name] = str(tmp_path / f'{name}.litertlm')
    n = mod.write_litertlm(paths[name], secs, system_metadata=meta)
    assert n == os.path.getsize(paths[name])
  assert _read(paths['port']) == _read(paths['jax'])
  f = litertlm.LiteRTLMFile(paths['port'])
  assert f.version == (litertlm.MAJOR_VERSION, litertlm.MINOR_VERSION,
                       litertlm.PATCH_VERSION)
  assert f.get_system_metadata() == {'Authors': 'aeqt'}
  assert f.get_section_metadata(0) == {'model_type': 'tokenizer',
                                       'vocab': 32000}
  assert f.get_model_type(1) == 'tf_lite_prefill_decode'
  assert f.get_model_type(2) is None
  secs, _ = _sections(litertlm)
  assert [f.get_section_buffer(i) for i in range(3)] == [s[0] for s in secs]
  assert all(s.begin_offset % litertlm.BLOCK_SIZE == 0 for s in f.sections)
  new = np.random.default_rng(0).integers(
      0, 256, litertlm.BLOCK_SIZE + 123).astype(np.uint8).tobytes()
  f.serialize(str(tmp_path / 'port2.litertlm'), {1: new})
  jax_litertlm.LiteRTLMFile(paths['jax']).serialize(
      str(tmp_path / 'jax2.litertlm'), {1: new})
  assert _read(tmp_path / 'port2.litertlm') == _read(tmp_path /
                                                     'jax2.litertlm')
  g = litertlm.LiteRTLMFile(str(tmp_path / 'port2.litertlm'))
  assert g.get_section_buffer(1) == new and g.get_model_type(1) == \
      'tf_lite_prefill_decode'
  bad = tmp_path / 'junk.litertlm'
  bad.write_bytes(b'NOTLM---' + b'\x00' * 100)
  with pytest.raises(ValueError, match='not a LiteRT-LM'):
    litertlm.LiteRTLMFile(str(bad))


# -- .aeqb bundles ---------------------------------------------------------------


def _toy_bundle(mod, gemma_mod, to_graph=lambda g: g):
  """tests/test_cli_and_bundles.py's `_toy_bundle` in one package."""
  cfg = gemma_mod.TOY_DECODER
  return mod.Bundle(sections=[
      mod.BundleSection(name='embedder', model_type='embedder',
                        graph=to_graph(fixtures.single_fc(seed=9))),
      mod.BundleSection(name='lm', model_type='decode', graph=to_graph(
          jax_gemma.build_decoder(cfg, batch=1, prefill_len=4))),
  ], metadata={'family': 'toy'})


def _bundle_pair():
  return (_toy_bundle(jax_bundles, jax_gemma),
          _toy_bundle(bundles, jax_gemma, to_port_graph))


def _assert_same_bundle(got, want):
  """A port bundle and a JAX one: the same sections, graphs and
  metadata."""
  assert got.metadata == want.metadata
  assert [(s.name, s.model_type) for s in got.sections] == [
      (s.name, s.model_type) for s in want.sections]
  for gs, ws in zip(got.sections, want.sections):
    assert graph_record(gs.graph) == graph_record(to_port_graph(ws.graph))


def test_aeqb_files_cross_between_packages(tmp_path):
  """The port's `.aeqb` has the JAX package's bytes; each package loads
  the other's file to the same bundle."""
  jb, tb = _bundle_pair()
  jb.save(str(tmp_path / 'jax.aeqb'))
  tb.save(str(tmp_path / 'port.aeqb'))
  assert _read(tmp_path / 'port.aeqb') == _read(tmp_path / 'jax.aeqb')
  want = jax_bundles.Bundle.load(str(tmp_path / 'jax.aeqb'))
  _assert_same_bundle(bundles.Bundle.load(str(tmp_path / 'jax.aeqb')), want)
  _assert_same_bundle(bundles.Bundle.load(str(tmp_path / 'port.aeqb')),
                      jax_bundles.Bundle.load(str(tmp_path / 'port.aeqb')))
  assert bundles.Bundle.load(str(tmp_path / 'port.aeqb')).section_by_name(
      'lm').model_type == 'decode'
  with pytest.raises(KeyError):
    tb.section_by_name('absent')


def test_quantize_bundle_matches_jax():
  """Per model type: int4 for 'decode', the 'default' int8 for the rest;
  a mapping without the type and without 'default' leaves it float."""
  jb, tb = _bundle_pair()
  jq = jax_bundles.quantize_bundle(jb, {
      'decode': jax_recipe_presets.dynamic_wi4_afp32(),
      'default': jax_recipe_presets.dynamic_wi8_afp32()})
  tq = bundles.quantize_bundle(tb, {
      'decode': recipe_presets.dynamic_wi4_afp32(),
      'default': recipe_presets.dynamic_wi8_afp32()}, device='cpu')
  _assert_same_bundle(tq, jq)
  emb = tq.section_by_name('embedder').graph
  assert emb.main_subgraph().tensor_by_name('fc/w').dtype == 'int8'
  assert any(t.dtype == 'int4' for sg in tq.section_by_name('lm').graph
             .subgraphs for t in sg.tensors)
  kept = bundles.quantize_bundle(tb, {'other': []}, device='cpu')
  assert kept.sections[0].graph is tb.sections[0].graph


# -- the CLI ---------------------------------------------------------------------


def _run_both(tmp_path, name, graph_or_path, extra=(), suffix='.aeqg'):
  """Runs both CLIs on one input file; the two output directories."""
  if isinstance(graph_or_path, str):
    src = graph_or_path
  else:
    src = str(tmp_path / f'{name}{suffix}')
    jax_serialize.save_graph(graph_or_path, src)
  outs = {}
  for pkg, main, device in (('jax', jax_cli.main, ()),
                            ('port', cli.main, ('--device', 'cpu'))):
    outs[pkg] = str(tmp_path / f'out_{pkg}')
    assert main(['--model_file', src, '--output_dir', outs[pkg], *extra,
                 *device]) == 0
  return outs


def test_cli_aeqg_with_validate_matches_jax(tmp_path, capsys):
  """dynamic_wi8_afp32 with --validate: the same .aeqg and recipe bytes,
  the same size reduction, every compared tensor's mse within 1e-5 of the
  JAX CLI's (the metric sums in float64 over arrays that match to the
  last bits)."""
  outs = _run_both(tmp_path, 'model', fixtures.two_layer_mlp(),
                   ('--recipe', 'dynamic_wi8_afp32', '--validate'))
  for name in ('model.aeqg', 'model_recipe.json'):
    assert _read(os.path.join(outs['port'], name)) == _read(
        os.path.join(outs['jax'], name)), name
  got, want = ({k: v for k, v in json.loads(_read(os.path.join(
      outs[pkg], 'model_comparison_result.json'))).items()}
               for pkg in ('port', 'jax'))
  assert set(got) == set(want)
  assert got['reduced_size_percentage'] == want['reduced_size_percentage'] > 60
  for sig in [k for k in want if isinstance(want[k], dict)]:
    for bucket, values in want[sig].items():
      if isinstance(values, dict):
        assert set(got[sig][bucket]) == set(values), (sig, bucket)
        for tname, v in values.items():
          assert abs(got[sig][bucket][tname] - v) <= 1e-5 * max(abs(v),
                                                                 1e-3), tname
  assert 'Size reduction' in capsys.readouterr().out
  g2 = serialize.load_graph(os.path.join(outs['port'], 'model.aeqg'))
  assert g2.main_subgraph().tensor_by_name('dense1/w').dtype == 'int8'


def test_cli_json_recipe_matches_jax(tmp_path):
  """tests/test_cli_and_bundles.py's int4 channelwise recipe file: the
  same bytes out."""
  recipe = [{
      'regex': '.*', 'operation': 'FULLY_CONNECTED',
      'algorithm_key': 'min_max_uniform_quantize',
      'op_config': {
          'weight_tensor_config': {
              'num_bits': 4, 'symmetric': True,
              'granularity': 'CHANNELWISE', 'dtype': 'INT'},
          'compute_precision': 'INTEGER',
          'explicit_dequantize': False,
      },
  }]
  path = tmp_path / 'r.json'
  path.write_text(json.dumps(recipe))
  outs = _run_both(tmp_path, 'm', fixtures.single_fc(),
                   ('--recipe', str(path)))
  got = _read(os.path.join(outs['port'], 'm.aeqg'))
  assert got == _read(os.path.join(outs['jax'], 'm.aeqg'))
  g2 = serialize.load_graph(os.path.join(outs['port'], 'm.aeqg'))
  assert g2.main_subgraph().tensor_by_name('fc/w').dtype == 'int4'


def test_cli_static_recipe_with_random_calibration(tmp_path, capsys):
  """default_a8w8 calibrated on 4 random samples in each CLI (the port's
  on the CPU): the same graph but for the activation scales, whose
  calibration ranges come from float matmuls summed in another order
  (within 1e-5 of each other, zero points within one step)."""
  outs = _run_both(tmp_path, 'm', fixtures.two_layer_mlp(),
                   ('--recipe', 'default_a8w8', '--calibration_samples',
                    '4'))
  assert 'requires calibration' in capsys.readouterr().err
  got = serialize.load_graph(os.path.join(outs['port'], 'm.aeqg'))
  want = to_port_graph(jax_serialize.load_graph(
      os.path.join(outs['jax'], 'm.aeqg')))
  sg_got, sg_want = got.main_subgraph(), want.main_subgraph()
  assert [(t.name, t.shape, t.dtype) for t in sg_got.tensors] == [
      (t.name, t.shape, t.dtype) for t in sg_want.tensors]
  assert all(t.dtype.startswith('int') for t in sg_got.tensors)
  for tg, tw in zip(sg_got.tensors, sg_want.tensors):
    if tg.buffer >= 0 and got.buffers[tg.buffer].data is not None:
      np.testing.assert_array_equal(got.buffers[tg.buffer].data,
                                    want.buffers[tw.buffer].data)
    qg, qw = tg.quantization, tw.quantization
    np.testing.assert_allclose(qg.scale, qw.scale, rtol=1e-5, err_msg=tg.name)
    assert np.max(np.abs(np.asarray(qg.zero_point, np.int64)
                         - np.asarray(qw.zero_point, np.int64))) <= 1


def test_cli_bundle_matches_jax(tmp_path):
  """An `.aeqb` through both CLIs: the same bundle file."""
  jb, _ = _bundle_pair()
  src = str(tmp_path / 'model.aeqb')
  jb.save(src)
  outs = _run_both(tmp_path, 'model', src, ('--recipe', 'dynamic_wi8_afp32'))
  got = os.path.join(outs['port'], 'model.aeqb')
  assert _read(got) == _read(os.path.join(outs['jax'], 'model.aeqb'))
  assert bundles.Bundle.load(got).section_by_name(
      'embedder').graph.main_subgraph().tensor_by_name(
          'fc/w').dtype == 'int8'


def test_cli_litertlm_matches_jax(tmp_path):
  """A `.litertlm` of a tokenizer and a TFLite section (tensorflow makes
  it, as in tests/test_litertlm.py) through both CLIs: the same file, the
  tokenizer byte for byte, the model section an `.aeqg`."""
  model = jax_litertlm_tests._make_tflite_bytes()  # skips without TF
  src = str(tmp_path / 'model.litertlm')
  litertlm.write_litertlm(src, [
      (b'sp-tokenizer' * 50, litertlm.SECTION_GENERIC_BINARY,
       {'model_type': 'tokenizer'}),
      (model, litertlm.SECTION_TFLITE_MODEL,
       {'model_type': 'tf_lite_prefill_decode'}),
  ], system_metadata={'Authors': 'test'})
  outs = _run_both(tmp_path, 'model', src, ('--recipe', 'dynamic_wi8_afp32'))
  got = os.path.join(outs['port'], 'model.litertlm')
  assert _read(got) == _read(os.path.join(outs['jax'], 'model.litertlm'))
  f = litertlm.LiteRTLMFile(got)
  assert f.get_section_buffer(0) == b'sp-tokenizer' * 50
  assert f.get_section_buffer(1)[:4] == b'AEQG'
  # Written next to its input, it takes another name.
  assert cli.main(['--model_file', src, '--recipe', 'dynamic_wi8_afp32',
                   '--device', 'cpu']) == 0
  assert os.path.exists(str(tmp_path / 'model_quantized.litertlm'))


def test_cli_help_in_a_clean_process():
  """`python -m ai_edge_quantizer_tpu_torch.cli --help` lists the JAX
  CLI's flags and --device, and imports neither jax nor the JAX package."""
  code = (
      'import runpy, sys\n'
      'sys.argv = ["aeqt-torch", "--help"]\n'
      'try:\n'
      '  runpy.run_module("ai_edge_quantizer_tpu_torch.cli",'
      ' run_name="__main__")\n'
      'except SystemExit as e:\n'
      '  assert e.code == 0, e.code\n'
      'bad = sorted(m for m in sys.modules if m in ("jax", "ml_dtypes", '
      '"ai_edge_quantizer_tpu", "orbax", "tensorflow") or m.startswith(('
      '"jax.", "ml_dtypes.", "ai_edge_quantizer_tpu.", "orbax.", '
      '"tensorflow.")))\n'
      'assert not bad, bad\n')
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=300)
  assert out.returncode == 0, out.stderr + out.stdout
  flags = {a for action in jax_cli.build_arg_parser()._actions
           for a in action.option_strings}
  for flag in flags | {'--device'}:
    assert flag in out.stdout, flag
  assert cli.build_arg_parser().parse_args(
      ['--model_file', 'm', '--recipe', 'r']).device == 'cuda'


# -- serving checkpoints -----------------------------------------------------------


def test_checkpoint_round_trip(tmp_path):
  """An executor's weight dict (a quantized graph's, with a tensor that
  aliases another's storage and a bfloat16 one) comes back equal: keys,
  dtypes and values, with the JAX module's flat keys; shared storage
  stays shared. `shardings` (mesh placement) is refused."""
  graph = to_port_graph(JaxQuantizer(fixtures.two_layer_mlp(),
                                     'dynamic_wi8_afp32').quantize()
                        .quantized_model)
  ex = executor.GraphExecutor(graph, device='cpu')
  weights = dict(ex._weights)
  first = next(iter(weights))
  weights[(7, 1)] = weights[first]
  weights[(7, 2)] = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
  assert set(checkpoint._flatten(weights)) == set(
      jax_checkpoint._flatten(weights))
  path = str(tmp_path / 'ckpt')
  checkpoint.save_serving_weights(weights, path)
  checkpoint.save_serving_weights(weights, path)  # replaces it
  restored = checkpoint.load_serving_weights(path, device='cpu')
  assert set(restored) == set(weights)
  for key, value in weights.items():
    assert restored[key].dtype == value.dtype, key
    assert torch.equal(restored[key], value), key
  assert restored[(7, 1)].untyped_storage().data_ptr() == \
      restored[first].untyped_storage().data_ptr()
  with pytest.raises(NotImplementedError, match='parallel/'):
    checkpoint.load_serving_weights(path, shardings={first: object()},
                                    device='cpu')
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='cuda'):
      checkpoint.load_serving_weights(path)


# -- torch import ------------------------------------------------------------------


def _torch_modules():
  """tests/test_torch_import.py's four modules: (module, input shape,
  tolerances)."""
  torch.manual_seed(0)
  mlp = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Dropout(0.5),
                      nn.Linear(32, 8), nn.Softmax(dim=-1)).eval()
  torch.manual_seed(1)
  cnn = nn.Sequential(
      nn.Conv2d(3, 8, 3, stride=2, padding=1), nn.ReLU(),
      nn.Conv2d(8, 8, 3, stride=1, padding=0, groups=8), nn.ReLU6(),
      nn.Flatten(), nn.Linear(8 * 6 * 6, 10)).eval()
  torch.manual_seed(2)
  silu = nn.Sequential(
      nn.Conv2d(1, 4, 3, padding=1), nn.SiLU(), nn.AvgPool2d(2),
      nn.Flatten(), nn.Linear(4 * 4 * 4, 5)).eval()
  torch.manual_seed(3)
  gelu = nn.Sequential(nn.Linear(64, 128), nn.GELU(),
                       nn.Linear(128, 16)).eval()
  return {'mlp': (mlp, (2, 16), dict(rtol=1e-4, atol=1e-5)),
          'cnn': (cnn, (1, 16, 16, 3), dict(rtol=1e-3, atol=1e-4)),
          'silu_pool': (silu, (2, 8, 8, 1), dict(rtol=1e-3, atol=1e-4)),
          'gelu': (gelu, (4, 64), dict(rtol=1e-3, atol=1e-4))}


@pytest.mark.parametrize('name', ['mlp', 'cnn', 'silu_pool', 'gelu'])
def test_convert_torch_module_matches_jax(name):
  """The same IR as the JAX converter's; the port's executor gives the
  module's output (NCHW input transposed, as the JAX test does); the
  Quantizer quantizes it as the JAX package's does."""
  module, shape, tol = _torch_modules()[name]
  got = torch_import.convert_torch_module(module, shape)
  want = jax_torch_import.convert_torch_module(module, shape)
  assert graph_record(got) == graph_record(to_port_graph(want))
  x = np.random.default_rng(len(name)).standard_normal(shape).astype(
      np.float32)
  sig = got.signatures[0]
  out = executor.GraphExecutor(got, device='cpu', **JAX_OPTS)(
      {list(sig.inputs)[0]: x})
  tx = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)) if len(shape) == 4
                        else x)
  with torch.no_grad():
    ref = module(tx).numpy()
  np.testing.assert_allclose(next(iter(out.values())).numpy(), ref, **tol)
  jq = JaxQuantizer(want, 'dynamic_wi8_afp32').quantize().quantized_model
  tq = Quantizer(got, 'dynamic_wi8_afp32').quantize().quantized_model
  assert graph_record(tq) == graph_record(to_port_graph(jq))


def test_convert_torch_module_refuses_what_jax_refuses():
  for mod in (torch_import, jax_torch_import):
    with pytest.raises(NotImplementedError):
      mod.convert_torch_module(nn.Sequential(nn.LSTM(4, 4)), (1, 4))


# -- the C++ sub-byte packer ---------------------------------------------------------


@pytest.mark.parametrize('bits', [4, 2])
def test_native_packer_bytes_match_numpy(bits):
  """Built from native/src/packing.cc into the port's build directory:
  the bytes of quant_numerics' packer, odd sizes included, and back."""
  assert native_packing.packer() == 'native'
  assert native_packing.LIB_PATH.parent == ROOT / \
      'ai_edge_quantizer_tpu_torch' / 'kernels' / '_build'
  rng = np.random.default_rng(bits)
  lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
  for n in (1, 2, 3, 5, 4096, 4097):
    data = rng.integers(lo, hi, n).astype(np.int8)
    packed = native_packing.pack_subbyte(data, bits)
    np.testing.assert_array_equal(packed, qn.pack_subbyte(data, bits))
    np.testing.assert_array_equal(
        native_packing.unpack_subbyte(packed, bits, n), data)
  with pytest.raises(ValueError, match='sub-byte'):
    native_packing.pack_subbyte(np.zeros(4, np.int8), 3)


@pytest.mark.parametrize('recipe', ['dynamic_wi4_afp32', 'dynamic_wi2_afp32'])
def test_aeqg_bytes_same_with_and_without_the_native_packer(recipe, tmp_path,
                                                            monkeypatch):
  """A graph with int4 or int2 weights saves to the same `.aeqg` with the
  C++ packer and with numpy, the JAX package's bytes; both load back."""
  jgraph = fixtures.two_layer_mlp()
  jq = JaxQuantizer(jgraph, recipe).quantize().quantized_model
  tq = Quantizer(to_port_graph(jgraph), recipe).quantize().quantized_model
  jax_serialize.save_graph(jq, str(tmp_path / 'jax.aeqg'))
  serialize.save_graph(tq, str(tmp_path / 'native.aeqg'))
  native_load = graph_record(serialize.load_graph(str(tmp_path /
                                                      'native.aeqg')))
  monkeypatch.setattr(serialize, '_native', lambda: None)
  serialize.save_graph(tq, str(tmp_path / 'numpy.aeqg'))
  data = {n: _read(tmp_path / f'{n}.aeqg') for n in ('jax', 'native',
                                                     'numpy')}
  assert data['native'] == data['numpy'] == data['jax']
  assert graph_record(serialize.load_graph(str(tmp_path / 'numpy.aeqg'))) \
      == native_load
  assert any(t.dtype in ('int4', 'int2') for sg in tq.subgraphs
             for t in sg.tensors)
