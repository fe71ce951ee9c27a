"""Quantized serving: packed store, fused top-K scorer, engine, eval."""
