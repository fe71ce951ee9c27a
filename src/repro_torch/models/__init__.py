"""KG models (KGAT) and their initializers."""
