"""Quantized serving: packed store, fused top-K and two-stage scorers,
result cache, delta refresh, engine, eval."""
