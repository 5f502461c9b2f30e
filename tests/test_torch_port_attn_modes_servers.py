"""The port's default-mode DecodeServer in the bf16 and int8 compute
modes against the JAX server, on the CPU (split from the former
test_torch_port_attn_modes.py; its kernel cases are in
test_torch_port_attn_modes_kernels.py).

The JAX executor runs #17 on its f32 XLA twin whatever the mode off a TPU
(executor.py:2047): the port's server in each mode gives the JAX server's
tokens with #17 held to f32, and run in the mode its contexts differ from
f32 on the same inputs by more than nothing and at most MODE_VS_F32.
"""

import os

import pytest
import torch

from ai_edge_quantizer_tpu import Quantizer as JaxQuantizer
from ai_edge_quantizer_tpu.models import gemma as jax_gemma
from ai_edge_quantizer_tpu.parallel import batching as jax_batching
from ai_edge_quantizer_tpu_torch import Quantizer
from ai_edge_quantizer_tpu_torch.execution import executor
from ai_edge_quantizer_tpu_torch.models import gemma
from ai_edge_quantizer_tpu_torch.parallel import batching

from test_torch_port_attn_compute import MODE_VS_F32, MODES
from test_torch_port_attn_modes_kernels import _record
from test_torch_port_default_mode import DEFAULT_CFG, _quantized
from test_torch_port_serving import SLOTS, _finished, _serve, _trace
from test_torch_port_serving import _track


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  """One torch thread for this file: under parallel test workers, torch's
  default of a thread a core oversubscribes the cores."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def default_jax_server():
  """The JAX DecodeServer with no AEQT_* variable set over serve_gemma's
  quantization of the toy serving graph (F 1024, so the MLP fuses), and
  the port's quantization of the same graph; one JAX server for both
  modes (it runs #17 at f32 off a TPU whatever AEQT_ATTN_COMPUTE says)."""
  with pytest.MonkeyPatch.context() as mp:
    for var in [v for v in os.environ if v.startswith('AEQT_')]:
      mp.delenv(var)
    jcfg = jax_gemma.DecoderConfig(**DEFAULT_CFG)
    tcfg = gemma.DecoderConfig(**DEFAULT_CFG)
    jserver = jax_batching.DecodeServer(
        _quantized(jax_gemma, JaxQuantizer, jcfg), jcfg, SLOTS,
        pack_weights=True, activation_dtype='float32', starvation_age_s=None)
    jserver._executor.prepare_serving_weights(min_weight_params=0)
    _track(jserver)
    yield jserver, _quantized(gemma, Quantizer, tcfg), tcfg


def _default_port_server(graph, cfg, mode):
  server = batching.DecodeServer(
      graph, cfg, SLOTS, pack_weights=True, activation_dtype='float32',
      device='cpu', starvation_age_s=None,
      executor_options={**executor.JAX_DEFAULT_OPTIONS, 'attn_compute': mode})
  server._executor.prepare_serving_weights(min_weight_params=0)
  _track(server)
  return server


@pytest.mark.parametrize('mode', MODES)
def test_default_mode_server_matches_jax_with_masked_at_f32(
    mode, default_jax_server, monkeypatch):
  """The port's default-mode server in the mode, its ticks' masked
  attention held to f32 (the JAX executor's twin off a TPU): the JAX
  server's tokens. The executor asked for the mode at every call."""
  jserver, graph, cfg = default_jax_server
  tserver = _default_port_server(graph, cfg, mode)
  assert tserver._executor.attn_compute == mode
  rec = _record(monkeypatch, 'decode_attention_int8_masked', as_jax=True)
  trace = _trace(cfg, seed=len(mode))
  jids = _serve(jserver, trace, 0)
  tids = _serve(tserver, trace, 0)
  assert rec.modes and set(rec.modes) == {mode}
  got, want = _finished(tserver, tids), _finished(jserver, jids)
  assert [got[r] for r in tids] == [want[r] for r in jids]
  for rid, (_, n) in zip(tids, trace):
    assert got[rid][0] == 'done' and len(got[rid][1]) == n


@pytest.mark.parametrize('mode', MODES)
def test_default_mode_server_ticks_differ_from_f32_within_bound(
    mode, default_jax_server, monkeypatch):
  """The named difference: the ticks' masked attention runs in the mode,
  one call a layer a tick; on its inputs its context differs from f32 by
  more than nothing and at most MODE_VS_F32. Every request ends done with
  its tokens in range."""
  _, graph, cfg = default_jax_server
  tserver = _default_port_server(graph, cfg, mode)
  rec = _record(monkeypatch, 'decode_attention_int8_masked', as_jax=False)
  trace = _trace(cfg, seed=5)
  tids = _serve(tserver, trace, 4)
  got = _finished(tserver, tids)
  for rid, (_, n) in zip(tids, trace):
    status, tokens = got[rid]
    assert status == 'done' and len(tokens) == n
    assert min(tokens) >= 0 and max(tokens) < cfg.vocab_size
  assert len(rec.pairs) == cfg.num_layers * tserver.metrics['decode_ticks']
  diff = rec.largest_rel_diff()
  assert 0 < diff <= MODE_VS_F32[mode], diff
