"""Recipe resolution: by preset name, JSON file path, or literal list.

Parity: reference `utils/recipe_utils.py` (named-recipe resolution over
`recipe.py` functions + `recipes/*.json` by filename stem, and per-model-type
recipe-mapping resolution for GenAI bundles).

A copy of `ai_edge_quantizer_tpu/recipe/recipe_utils.py`: the port keeps its
own so that it never imports the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Union

from ai_edge_quantizer_tpu_torch.recipe import recipe as recipe_presets

_STOCK_RECIPE_DIR = os.path.join(os.path.dirname(__file__), 'recipes')


def _stock_recipe_names() -> dict:
  out = {}
  if os.path.isdir(_STOCK_RECIPE_DIR):
    for fname in os.listdir(_STOCK_RECIPE_DIR):
      if fname.endswith('.json'):
        stem = fname[:-len('.json')]
        if stem.endswith('_recipe'):
          stem = stem[:-len('_recipe')]
        out[stem] = os.path.join(_STOCK_RECIPE_DIR, fname)
  return out


def resolve_recipe(name_or_path_or_list: Union[str, list]) -> list:
  """Resolve a recipe given a preset name, JSON path, or literal recipe."""
  spec = name_or_path_or_list
  if isinstance(spec, list):
    return spec
  if not isinstance(spec, str):
    raise ValueError(f'Cannot resolve recipe from {type(spec)}.')
  # Normalize '<name>_recipe' / '<name>_recipe.json' spellings.
  norm = spec
  if norm.endswith('.json') and not os.path.exists(norm):
    norm = norm[:-len('.json')]
  if norm.endswith('_recipe'):
    norm = norm[:-len('_recipe')]
  # 1. preset function name.
  fn = recipe_presets.NAMED_RECIPES.get(spec) or \
      recipe_presets.NAMED_RECIPES.get(norm)
  if fn is not None:
    return fn()
  # 2. stock recipe JSON by stem.
  stock = _stock_recipe_names()
  for key in (spec, norm):
    if key in stock:
      with open(stock[key]) as f:
        loaded = json.load(f)
      if isinstance(loaded, dict):
        # A mapping file: its 'default' recipe acts as the plain recipe.
        return resolve_recipe(loaded.get('default', []))
      return loaded
  # 3. filesystem path (same mapping-file handling as the stem branch).
  if os.path.exists(spec):
    with open(spec) as f:
      loaded = json.load(f)
    if isinstance(loaded, dict):
      return resolve_recipe(loaded.get('default', []))
    return loaded
  raise ValueError(
      f'Unknown recipe {spec!r}: not a preset '
      f'({sorted(recipe_presets.NAMED_RECIPES)[:12]}...), stock recipe '
      f'({sorted(stock)}), or file path.')


def resolve_recipe_mapping(name_or_path: Union[str, dict]) -> dict:
  """Resolve a per-model-type recipe mapping for multi-program bundles.

  Returns {model_type: recipe list}; 'default' key is the fallback.
  """
  spec = name_or_path
  if isinstance(spec, dict):
    return {k: resolve_recipe(v) for k, v in spec.items()}
  mapping = recipe_presets.LITERTLM_RECIPE_MAPPINGS.get(spec)
  if mapping is not None:
    return {
        k: v() if callable(v) else resolve_recipe(v)
        for k, v in mapping.items()
    }
  if isinstance(spec, str) and os.path.exists(spec):
    with open(spec) as f:
      loaded = json.load(f)
    if isinstance(loaded, dict):
      return {k: resolve_recipe(v) for k, v in loaded.items()}
    return {'default': loaded}
  # A plain recipe acts as the default for every model type.
  return {'default': resolve_recipe(spec)}
