"""Mesh layouts, collectives and row-sharded tables of the multi-rank path."""
