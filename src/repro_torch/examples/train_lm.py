"""Train a small decoder LM with block-level ACT (port of
``examples/train_lm.py``): TinyKG's quantizer applied to each transformer
block's saved input, the block recomputed in the backward, on a learnable
synthetic language, with AdamW, decoupled weight decay and global-norm
clipping, through the port's trainer.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        [--steps 150] [--bits 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import torch

from repro_torch.core.policy import schedule_from_cli, schedule_label
from repro_torch.data.csr import lookup_plan
from repro_torch.data.synthetic import lm_batches
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.train import train_model
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import adamw
from repro_torch.training.step import ModelStep, enter_or_null, trainable

BATCH, SEQ, NOISE = 16, 64, 0.05


def lm_step(cfg, dev) -> ModelStep:
    """The example's next-token step on ``lm_batches`` (5% noise)."""
    def init(seed: int = 0):
        return trainable(tf.init_params(cfg, seed=seed, device=dev))

    def loss(params, batch, *, ctx=None):
        with enter_or_null(ctx):
            return tf.lm_loss(params, batch, cfg)

    def batches():
        for b in lm_batches(vocab=cfg.vocab, batch=BATCH, seq=SEQ, seed=0,
                            noise=NOISE):
            yield {"tokens": torch.from_numpy(b["tokens"]).to(dev),
                   "lookup": lookup_plan(b["tokens"][:, :-1], cfg.vocab,
                                         dev)}

    return ModelStep(arch="train_lm example", family="lm", cfg=cfg,
                     init=init, loss=loss, batches=batches, lr=1e-3,
                     data={"device": dev})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = tf.TransformerConfig(
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=4, d_head=16,
        d_ff=512, vocab=257, q_chunk=32, kv_chunk=32)
    step = lm_step(cfg, dev)
    params = step.init(0)
    n = sum(t.numel() for v in params.values()
            for t in (v if isinstance(v, list) else [v]))
    print(f"LM: {n / 1e6:.2f}M params, schedule "
          f"{schedule_label(None, args.bits)}, device {dev}", flush=True)
    res = train_model(step, params, schedule_from_cli(None, args.bits),
                      args.steps,
                      opt=adamw(1e-3, weight_decay=0.01, clip_norm=1.0),
                      log=lambda msg: None)
    losses = [r["loss"] for r in res["steps"]]
    for i, v in enumerate(losses):
        if i % 25 == 0 or i == len(losses) - 1:
            print(f"step {i:4d}: loss {v:.4f}")
    # the affine-bigram language has 5% noise -> loss floor ~ 0.05 ln(257)
    print(f"done (floor ~ {NOISE * math.log(cfg.vocab) + 0.2:.2f} nats for "
          f"the 5%-noise synthetic language)")
    return {"losses": losses}


if __name__ == "__main__":
    main()
