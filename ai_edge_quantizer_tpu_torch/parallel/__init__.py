"""Part of the PyTorch port (ai_edge_quantizer_tpu_torch): serving."""
