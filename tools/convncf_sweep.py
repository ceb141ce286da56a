#!/usr/bin/env python3
"""ConvNCF on config 1's data and protocol under a sweep of learning rate
and l2, on one CUDA card.

    python3 tools/convncf_sweep.py [LR:L2 ...] [--epochs N] [--eval-every N] [--seeds S,...]

Each LR:L2 pair (default: config 1's 0.1:0.03, then 0.1:0, 0.05:0,
0.1:0.003, 0.02:0) trains ``mf_bpr_ml100k()`` with ``model.name="convncf"``
(d=64, 32 channels), that learning rate and ``model.l2_reg`` for N epochs
(default 20) through ``trainer.run``, at each ``train.seed`` of ``--seeds``
(default the config's), and prints each epoch's loss, the recall@20 of each
eval and the largest |w| of the readout. A loss held at ln 2 with every
item's score tied (recall@20 0.0087 on the stand-in) marks a conv stack
collapsed to one score.
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tfrec_tpu_torch import zoo_configs  # noqa: E402
from tfrec_tpu_torch.train.trainer import run  # noqa: E402

DEFAULT = ("0.1:0.03", "0.1:0", "0.05:0", "0.1:0.003", "0.02:0")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("pairs", nargs="*", default=list(DEFAULT))
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--eval-every", type=int, default=5)
    parser.add_argument("--seeds", default="")
    args = parser.parse_args()
    base = zoo_configs.mf_bpr_ml100k()
    seeds = [int(s) for s in args.seeds.split(",") if s] or [base.train.seed]
    for pair in args.pairs:
        for seed in seeds:
            lr, l2 = (float(x) for x in pair.split(":"))
            cfg = base.replace(
                run_name="convncf_sweep", model=dataclasses.replace(base.model, name="convncf", l2_reg=l2),
                optim=dataclasses.replace(base.optim, learning_rate=lr),
                train=dataclasses.replace(base.train, epochs=args.epochs, eval_every_epochs=args.eval_every,
                                          eval_user_batch=64, seed=seed))
            sweep_one(cfg, lr, l2, seed)
    return 0


def sweep_one(cfg, lr: float, l2: float, seed: int) -> None:
    t0 = time.perf_counter()
    trainer, hist = run(cfg, quiet=True)
    print(f"convncf lr {lr} l2 {l2} seed {seed}: losses {[round(h['loss'], 4) for h in hist]}; recall@20 "
          f"{[round(h['recall@20'], 4) for h in hist if 'recall@20' in h]}; "
          f"{time.perf_counter() - t0:.1f} s; max |w| {trainer.state['dense']['w'].abs().max().item():.4f}",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
