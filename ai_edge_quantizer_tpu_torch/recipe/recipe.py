"""Canonical recipe presets.

Naming scheme (parity with reference `recipe.py`): mode prefix
(dynamic/static/weightonly via default_*), weight bits `wi<N>`, activation
`a<type>`; suffixes `_b<block>` for blockwise and `_hadamard` for rotation
variants. Each factory returns a JSON-serializable recipe (list of dicts).

A copy of `ai_edge_quantizer_tpu/recipe/recipe.py`: the port keeps its own
so that it never imports the JAX package.
"""

from __future__ import annotations

from typing import Optional

from ai_edge_quantizer_tpu_torch import qtyping
from ai_edge_quantizer_tpu_torch.algorithms.registry import AlgorithmName

_G = qtyping.QuantGranularity


def _entry(
    *,
    regex: str = '.*',
    operation: str = '*',
    algorithm_key: str = AlgorithmName.MIN_MAX_UNIFORM_QUANT,
    weight_bits: Optional[int] = None,
    weight_symmetric: bool = True,
    weight_granularity: _G = _G.CHANNELWISE,
    act_bits: Optional[int] = None,
    act_symmetric: bool = False,
    compute_precision: str = 'INTEGER',
    explicit_dequantize: bool = False,
    min_weight_elements: int = 0,
    algorithm_params: Optional[dict] = None,
) -> dict:
  op_config: dict = {
      'compute_precision': compute_precision,
      'explicit_dequantize': explicit_dequantize,
      'skip_checks': False,
      'min_weight_elements': min_weight_elements,
  }
  if weight_bits is not None:
    op_config['weight_tensor_config'] = {
        'num_bits': weight_bits,
        'symmetric': weight_symmetric,
        'granularity': weight_granularity.value,
        'dtype': 'INT',
    }
  if act_bits is not None:
    op_config['activation_tensor_config'] = {
        'num_bits': act_bits,
        'symmetric': act_symmetric,
        'granularity': 'TENSORWISE',
        'dtype': 'INT',
    }
  if algorithm_params is not None:
    op_config['algorithm_params'] = algorithm_params
  return {
      'regex': regex,
      'operation': operation,
      'algorithm_key': str(algorithm_key.value if hasattr(
          algorithm_key, 'value') else algorithm_key),
      'op_config': op_config,
  }


# -- dynamic ---------------------------------------------------------------


def dynamic_wi8_afp32() -> list:
  """int8 weights, runtime activation quantization."""
  return [_entry(weight_bits=8)]


def dynamic_legacy_wi8_afp32() -> list:
  """Legacy converter behavior: skip small (<1024 element) weights."""
  return [_entry(weight_bits=8, min_weight_elements=1024)]


def dynamic_wi4_afp32() -> list:
  return [_entry(weight_bits=4)]


def _blockwise_granularity(block_size: int) -> _G:
  return qtyping.granularity_from_block_size(block_size)


def dynamic_wi4_afp32_b32() -> list:
  return [_entry(weight_bits=4, weight_granularity=_G.BLOCKWISE_32,
                 operation='FULLY_CONNECTED')]


def dynamic_wi4_afp32_b64() -> list:
  return [_entry(weight_bits=4, weight_granularity=_G.BLOCKWISE_64,
                 operation='FULLY_CONNECTED')]


def dynamic_wi2_afp32() -> list:
  return [_entry(weight_bits=2, operation='FULLY_CONNECTED')]


def dynamic_wi8_afp32_hadamard() -> list:
  return [_entry(weight_bits=8, operation='FULLY_CONNECTED',
                 algorithm_key=AlgorithmName.HADAMARD_ROTATION)]


def dynamic_wi4_afp32_hadamard() -> list:
  return [_entry(weight_bits=4, operation='FULLY_CONNECTED',
                 algorithm_key=AlgorithmName.HADAMARD_ROTATION)]


def dynamic_wi8_afp32_decomposed_hadamard() -> list:
  return [_entry(weight_bits=8, operation='FULLY_CONNECTED',
                 algorithm_key=AlgorithmName.DECOMPOSED_HADAMARD_ROTATION)]


def dynamic_wi4_afp32_decomposed_hadamard() -> list:
  return [_entry(weight_bits=4, operation='FULLY_CONNECTED',
                 algorithm_key=AlgorithmName.DECOMPOSED_HADAMARD_ROTATION)]


# -- static ----------------------------------------------------------------


def default_a8w8() -> list:
  """Full int8 static-range quantization (asymmetric int8 activations)."""
  return [_entry(weight_bits=8, act_bits=8, act_symmetric=False)]


def default_a16w8() -> list:
  """int16 (symmetric) activations, int8 weights."""
  return [_entry(weight_bits=8, act_bits=16, act_symmetric=True)]


# -- weight-only (explicit dequantize, float compute) ----------------------


def default_af32w8float() -> list:
  return [_entry(weight_bits=8, compute_precision='FLOAT',
                 explicit_dequantize=True)]


def default_af32w4float() -> list:
  return [_entry(weight_bits=4, compute_precision='FLOAT',
                 explicit_dequantize=True)]


# -- fp16 casting ----------------------------------------------------------


def default_fp16() -> list:
  return [{
      'regex': '.*',
      'operation': '*',
      'algorithm_key': str(AlgorithmName.FLOAT_CASTING.value),
      'op_config': {
          'weight_tensor_config': {
              'num_bits': 16,
              'symmetric': True,
              'granularity': 'TENSORWISE',
              'dtype': 'FLOAT',
          },
          'compute_precision': 'FLOAT',
          'explicit_dequantize': True,
          'skip_checks': False,
          'min_weight_elements': 0,
      },
  }]


# -- GenAI (LLM bundle) per-model-type recipe maps -------------------------


def gemma_mixed48() -> list:
  """Gemma-style mix: 4-bit FC everywhere, 8-bit in the attention blocks."""
  return [
      _entry(weight_bits=4, operation='FULLY_CONNECTED'),
      _entry(regex='.*attn.*', weight_bits=8, operation='FULLY_CONNECTED'),
      _entry(weight_bits=8, operation='EMBEDDING_LOOKUP'),
  ]


def gemma_mixed48_b32() -> list:
  return [
      _entry(weight_bits=4, operation='FULLY_CONNECTED',
             weight_granularity=_G.BLOCKWISE_32),
      _entry(regex='.*attn.*', weight_bits=8, operation='FULLY_CONNECTED'),
      _entry(weight_bits=8, operation='EMBEDDING_LOOKUP'),
  ]


def gemma_mixed48_b64() -> list:
  """Blockwise-64 variant (parity: reference gemma4_mixed48_b64,
  recipe.py:380-397)."""
  return [
      _entry(weight_bits=4, operation='FULLY_CONNECTED',
             weight_granularity=_G.BLOCKWISE_64),
      _entry(regex='.*attn.*', weight_bits=8, operation='FULLY_CONNECTED'),
      _entry(weight_bits=8, operation='EMBEDDING_LOOKUP'),
  ]


def gemma_mixed48_hr() -> list:
  """Hadamard-rotation variant for the 4-bit FCs (parity: reference
  gemma4_mixed48_hr, recipe.py:343-361; 'hr' uses the decomposed rotation
  so stock runtimes execute it)."""
  return [
      _entry(weight_bits=4, operation='FULLY_CONNECTED',
             algorithm_key=AlgorithmName.DECOMPOSED_HADAMARD_ROTATION),
      _entry(regex='.*attn.*', weight_bits=8, operation='FULLY_CONNECTED'),
      _entry(weight_bits=8, operation='EMBEDDING_LOOKUP'),
  ]


def _mixed48_embedder(bits: int = 8, granularity: _G = _G.CHANNELWISE,
                      algorithm_key=AlgorithmName.MIN_MAX_UNIFORM_QUANT):
  return [_entry(weight_bits=bits, weight_granularity=granularity,
                 operation='EMBEDDING_LOOKUP', algorithm_key=algorithm_key)]


# Per-model-type recipe maps for multi-program GenAI bundles: keys are
# program model types (embedder / prefill / decode ...), 'default' is the
# fallback (parity: reference gemma4_mixed48{,_hr,_b32,_b64} maps,
# recipe.py:321-397).
LITERTLM_RECIPE_MAPPINGS: dict = {
    'gemma_mixed48': {
        'default': gemma_mixed48,
        'embedder': _mixed48_embedder,
    },
    'gemma_mixed48_hr': {
        'default': gemma_mixed48_hr,
        'embedder': lambda: _mixed48_embedder(
            algorithm_key=AlgorithmName.DECOMPOSED_HADAMARD_ROTATION),
    },
    'gemma_mixed48_b32': {
        'default': gemma_mixed48_b32,
        'embedder': _mixed48_embedder,
    },
    'gemma_mixed48_b64': {
        'default': gemma_mixed48_b64,
        'embedder': _mixed48_embedder,
    },
}


# Registry used by recipe_utils.resolve_recipe for by-name resolution.
NAMED_RECIPES: dict = {
    name: fn
    for name, fn in list(globals().items())
    if callable(fn) and not name.startswith('_') and name not in (
        'AlgorithmName', 'Optional', 'Any')
    and getattr(fn, '__module__', None) == __name__
}
