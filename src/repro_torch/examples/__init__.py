"""Runnable examples of the port (ports of ``examples/``):
``python -m repro_torch.examples.quickstart``, ``.train_kgnn`` and
``.train_lm``; each runs on the card unless given ``--device cpu``."""
