"""The port's TFLite import (`graph/tflite_import.py`) and the TFLite
sections of a `.litertlm`, against the JAX package on the CPU.

The models are those of tests/test_tflite_import.py and
tests/test_litertlm.py, converted by tensorflow once for the module: a
dense MLP, a strided conv net, a WHILE loop and an IF. Both packages'
`load_tflite` give the same IR (opcodes, attributes, tensors, buffers,
quantization, signatures and side-effect subgraphs), from a path and from
bytes; the port's executor gives TF's numbers within the JAX tests'
tolerances; the port's Quantizer takes a `.tflite` path and quantizes it as
the JAX package's does; a `.litertlm` with a TFLite section goes through
both packages' `quantize_litertlm` to the same file. Needs tensorflow for
the schema, as the JAX package's tests do; the H100 host has none.
"""

import os

import numpy as np
import pytest

tf = pytest.importorskip('tensorflow')

from ai_edge_quantizer_tpu.graph import litertlm as jax_litertlm  # noqa: E402
from ai_edge_quantizer_tpu.graph import tflite_import as jax_tflite  # noqa: E402
from ai_edge_quantizer_tpu.models import bundles as jax_bundles  # noqa: E402
from ai_edge_quantizer_tpu.recipe import recipe_utils as jax_recipe_utils  # noqa: E402
from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer  # noqa: E402
from ai_edge_quantizer_tpu_torch import Quantizer  # noqa: E402
from ai_edge_quantizer_tpu_torch.execution import executor  # noqa: E402
from ai_edge_quantizer_tpu_torch.graph import litertlm  # noqa: E402
from ai_edge_quantizer_tpu_torch.graph import serialize  # noqa: E402
from ai_edge_quantizer_tpu_torch.graph import tflite_import  # noqa: E402
from ai_edge_quantizer_tpu_torch.models import bundles  # noqa: E402
from ai_edge_quantizer_tpu_torch.recipe import recipe_utils  # noqa: E402

from test_torch_port_quantizer import graph_record, to_port_graph  # noqa: E402

JAX_OPTS = dict(activation_dtype='float32', **executor.JAX_DEFAULT_OPTIONS)


def _convert(module):
  conv = tf.lite.TFLiteConverter.from_concrete_functions(
      [module.__call__.get_concrete_function()], module)
  return conv.convert()


def _models():
  """name -> (tf module, input shape, tolerances of the JAX test)."""
  rng = np.random.default_rng(0)

  class Mlp(tf.Module):

    def __init__(self):
      self.w1 = tf.constant(rng.normal(size=(16, 32)).astype(np.float32) * .3)
      self.b1 = tf.constant(rng.normal(size=(32,)).astype(np.float32) * .1)
      self.w2 = tf.constant(rng.normal(size=(32, 8)).astype(np.float32) * .3)

    @tf.function(input_signature=[tf.TensorSpec((1, 16), tf.float32)])
    def __call__(self, x):
      h = tf.nn.relu(tf.matmul(x, self.w1) + self.b1)
      return tf.matmul(h, self.w2)

  class Cnn(tf.Module):

    def __init__(self):
      self.k1 = tf.constant(
          (rng.standard_normal((3, 3, 1, 8)) * 0.3).astype(np.float32))
      self.b1 = tf.constant(
          (rng.standard_normal(8) * 0.1).astype(np.float32))
      self.w = tf.constant(
          (rng.standard_normal((14 * 14 * 8, 10)) * 0.05).astype(np.float32))

    @tf.function(input_signature=[tf.TensorSpec((1, 28, 28, 1), tf.float32)])
    def __call__(self, x):
      h = tf.nn.relu(
          tf.nn.conv2d(x, self.k1, strides=2, padding='SAME') + self.b1)
      h = tf.reshape(h, (1, -1))
      return tf.nn.softmax(tf.matmul(h, self.w))

  class Loop(tf.Module):

    @tf.function(input_signature=[tf.TensorSpec((1, 8), tf.float32)])
    def __call__(self, x):
      i0 = tf.constant(0)
      cond = lambda i, v: i < 3
      body = lambda i, v: (i + 1, v * 1.5 + 0.25)
      _, out = tf.while_loop(cond, body, (i0, x))
      return out

  class Branchy(tf.Module):

    @tf.function(input_signature=[tf.TensorSpec((1, 4), tf.float32)])
    def __call__(self, x):
      return tf.cond(tf.reduce_sum(x) > 0,
                     lambda: x * 2.0, lambda: x - 1.0)

  return {'mlp': (Mlp(), (1, 16), dict(atol=1e-5)),
          'cnn': (Cnn(), (1, 28, 28, 1), dict(atol=1e-5)),
          'while': (Loop(), (1, 8), dict(rtol=1e-5, atol=1e-5)),
          'if': (Branchy(), (1, 4), dict(rtol=1e-5))}


@pytest.fixture(scope='module')
def models(tmp_path_factory):
  """name -> (tf module, .tflite path, input shape, tolerances)."""
  root = tmp_path_factory.mktemp('tflite')
  out = {}
  for name, (module, shape, tol) in _models().items():
    path = root / f'{name}.tflite'
    path.write_bytes(_convert(module))
    out[name] = (module, str(path), shape, tol)
  return out


NAMES = ('mlp', 'cnn', 'while', 'if')


@pytest.mark.parametrize('name', NAMES)
def test_load_tflite_matches_jax(models, name):
  _, path, _, _ = models[name]
  want = graph_record(to_port_graph(jax_tflite.load_tflite(path)))
  with open(path, 'rb') as f:
    data = f.read()
  for source in (path, data):
    assert graph_record(tflite_import.load_tflite(source)) == want
  # serialize.load_model dispatches both to the importer.
  assert graph_record(serialize.load_model(path)) == want
  assert graph_record(serialize.load_model(data)) == want
  graph = tflite_import.load_tflite(path)
  opcodes = {op.opcode for sg in graph.subgraphs for op in sg.ops}
  if name in ('while', 'if'):
    op = next(op for sg in graph.subgraphs for op in sg.ops
              if op.opcode == name.upper())
    assert len(op.side_effect_subgraphs) == 2
  else:
    assert opcodes <= {'FULLY_CONNECTED', 'CONV_2D', 'RESHAPE', 'SOFTMAX'}


@pytest.mark.parametrize('name', NAMES)
def test_executor_matches_tf(models, name):
  """The imported graph in the port's executor gives TF's output (the IF
  with each branch taken)."""
  module, path, shape, tol = models[name]
  graph = tflite_import.load_tflite(path)
  sig = graph.signatures[0]
  runner = executor.GraphExecutor(graph, device='cpu', **JAX_OPTS) \
      .signature_runner(sig.signature_key)
  rng = np.random.default_rng(1)
  feeds = [rng.standard_normal(shape).astype(np.float32)]
  if name == 'if':
    feeds = [np.full(shape, sign, np.float32) for sign in (1.0, -1.0)]
  for x in feeds:
    out = runner({list(sig.inputs)[0]: x})
    want = module(tf.constant(x)).numpy()
    got = next(v for v in out.values()
               if v.dtype == np.float32 and v.shape == want.shape)
    np.testing.assert_allclose(got, want, **tol)


def test_quantizer_takes_a_tflite_path(models):
  """Quantizer(path): the same quantized graph as the JAX package's, and
  validate() on the CPU keeps the outputs within the JAX test's 1e-2."""
  _, path, _, _ = models['mlp']
  want = JaxQuantizer(path, 'dynamic_wi8_afp32').quantize().quantized_model
  qt = Quantizer(path, 'dynamic_wi8_afp32')
  got = qt.quantize().quantized_model
  assert graph_record(got) == graph_record(to_port_graph(want))
  assert 'int8' in {t.dtype for sg in got.subgraphs for t in sg.tensors}
  r = qt.validate(num_samples=2, device='cpu') \
      .get_signature_comparison_result('serving_default')
  assert r.output_tensors and all(v < 1e-2 for v in r.output_tensors.values())


def test_litertlm_tflite_section_quantizes_as_in_jax(models, tmp_path):
  """A `.litertlm` of a tokenizer and a TFLite section, written by the
  port: both packages' quantize_litertlm report the same and write the
  same bytes; the sections' graphs load equal in both; a mapping without
  the model type leaves the TFLite section as it was."""
  _, path, _, _ = models['mlp']
  with open(path, 'rb') as f:
    model = f.read()
  src = str(tmp_path / 'model.litertlm')
  litertlm.write_litertlm(src, [
      (b'sp-tokenizer' * 50, litertlm.SECTION_GENERIC_BINARY,
       {'model_type': 'tokenizer'}),
      (model, litertlm.SECTION_TFLITE_MODEL,
       {'model_type': 'tf_lite_prefill_decode'}),
  ], system_metadata={'Authors': 'test'})
  outs = {}
  for pkg, bundles_mod, mapping in (
      ('jax', jax_bundles,
       jax_recipe_utils.resolve_recipe_mapping('dynamic_wi8_afp32')),
      ('port', bundles,
       recipe_utils.resolve_recipe_mapping('dynamic_wi8_afp32'))):
    out = str(tmp_path / f'{pkg}.litertlm')
    kwargs = {'device': 'cpu'} if pkg == 'port' else {}
    report = bundles_mod.quantize_litertlm(src, out, mapping, **kwargs)
    assert report == [(1, 'tf_lite_prefill_decode', True)]
    with open(out, 'rb') as f:
      outs[pkg] = f.read()
  assert outs['port'] == outs['jax']
  got = bundles.bundle_from_litertlm(str(tmp_path / 'port.litertlm'))
  want = jax_bundles.bundle_from_litertlm(str(tmp_path / 'jax.litertlm'))
  assert got.metadata == want.metadata
  assert [graph_record(s.graph) for s in got.sections] == [
      graph_record(to_port_graph(s.graph)) for s in want.sections]
  lm = litertlm.LiteRTLMFile(str(tmp_path / 'port.litertlm'))
  assert lm.get_section_metadata(1)['aeqt_format'] == 'aeqg'
  assert lm.read_model(1) is None  # no longer a TFLite section
  # The float file's TFLite section reads through the port's importer.
  assert graph_record(litertlm.LiteRTLMFile(src).read_model(1)) == \
      graph_record(to_port_graph(
          jax_litertlm.LiteRTLMFile(src).read_model(1)))
  floats = bundles.bundle_from_litertlm(src)
  assert graph_record(floats.sections[0].graph) == graph_record(
      to_port_graph(jax_bundles.bundle_from_litertlm(src).sections[0].graph))
  keep = str(tmp_path / 'keep.litertlm')
  assert bundles.quantize_litertlm(src, keep, {'other': []}, device='cpu') \
      == [(1, 'tf_lite_prefill_decode', False)]
  assert litertlm.LiteRTLMFile(keep).get_section_buffer(1) == model
  assert os.path.getsize(keep) == os.path.getsize(src)
