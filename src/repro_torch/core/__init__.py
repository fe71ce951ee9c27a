"""Quantization containers and the chunk-interleaved bit-pack."""
