"""LM serving: quantized weights, sampling and the batch-barrier engine."""
