"""Constrained-op discovery: which ops carry scale-propagation constraints.

The reference derives these lists by invoking every materialize function
against a mock op (constrained_ops_utils.py); here the per-op table IS the
single source of truth, so discovery is a table read.

A copy of `ai_edge_quantizer_tpu/utils/constrained_ops_utils.py` over the
port's `algorithms/uniform` tables.
"""

from __future__ import annotations

from ai_edge_quantizer_tpu_torch.algorithms.uniform import engine
from ai_edge_quantizer_tpu_torch.algorithms.uniform import op_library

OpQuantConstraint = engine.OpQuantConstraint


def get_constrained_op_list(constraint: OpQuantConstraint) -> list:
  """All op names materialized under `constraint`."""
  out = []
  for op_name, spec in op_library.OP_SPECS.items():
    if constraint == OpQuantConstraint.FIXED_OUTPUT_SCALE:
      if spec.kind == 'fixed_output':
        out.append(op_name)
    elif spec.kind == 'standard' and spec.constraint == constraint:
      out.append(op_name)
    elif spec.kind == 'sum' and \
        constraint == OpQuantConstraint.SAME_AS_INPUT_SCALE:
      # SUM is input-constrained for every activation width except 8 bit.
      out.append(op_name)
  return out
