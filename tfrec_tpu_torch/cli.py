"""Command line: ``python -m tfrec_tpu_torch.cli --config <name> [k=v ...]``,
the counterpart of ``tfrec_tpu/cli.py``.

Picks a zoo config by name (``zoo_configs.ZOO``; ``--list_configs`` lists
them), reads its data from ``--data_path`` (a MovieLens rating file or a
Criteo TSV; without one, the seeded stand-in), applies dotted
``section.field=value`` overrides (values read by ``ast.literal_eval``,
``true``/``false`` in any case as bools, anything else as a string), trains
and evaluates, and prints the last history record as one JSON line. It
runs on the card unless given ``--device cpu``.

Multi-process start-up takes the reference's variables: with
``JAX_COORDINATOR=host:port`` (rank 0's address), ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID`` set, each process joins one ``torch.distributed`` group
(``parallel.mesh.init_distributed``; ``--backend``: NCCL on a card a rank,
gloo on the CPU, ``gloo`` by name for ranks that share one card) and the
trainer takes the mesh path: D x T ranks for ``mesh.table_axis_size=T``
(with ``mesh.table_sharding=col`` for column-sharded tables). Every rank
prints the last record.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys


def parse_overrides(pairs):
    """``["section.field=value", ...]`` -> ``{"section.field": value}``."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"override {pair!r} is not of the form section.field=value")
        key, raw = pair.split("=", 1)
        low = raw.strip().lower()
        if low in ("true", "false"):
            # literal_eval takes only True/False, and the string "false"
            # would be truthy.
            out[key] = low == "true"
            continue
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw  # a bare string
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tfrec_tpu_torch", description="Recommender training on an NVIDIA GPU")
    parser.add_argument("--config", default="mf_bpr_ml100k",
                        help="zoo config name (see tfrec_tpu_torch.zoo_configs.ZOO)")
    parser.add_argument("--data_path", default=None,
                        help="dataset path (MovieLens UIRT / Criteo TSV)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="train on the card (default) or on the CPU")
    parser.add_argument("--backend", default="auto", choices=("auto", "nccl", "gloo"),
                        help="the process group's backend under JAX_COORDINATOR (auto: NCCL on "
                             "the card, gloo on the CPU)")
    parser.add_argument("--list_configs", action="store_true")
    parser.add_argument("overrides", nargs="*",
                        help="dotted config overrides, e.g. train.batch_size=4096 model.embed_dim=128")
    args = parser.parse_args(argv)

    from tfrec_tpu_torch.zoo_configs import ZOO

    if args.list_configs:
        for name in ZOO:
            print(name)
        return 0
    if args.config not in ZOO:
        raise SystemExit(f"unknown config {args.config!r}; options: {sorted(ZOO)}")
    from tfrec_tpu_torch.configs import with_overrides
    from tfrec_tpu_torch.train.trainer import run

    cfg = ZOO[args.config](args.data_path)
    if args.overrides:
        cfg = with_overrides(cfg, parse_overrides(args.overrides))
    ranks = os.environ.get("JAX_COORDINATOR")
    if ranks:
        import torch.distributed as dist

        from tfrec_tpu_torch.parallel.mesh import init_distributed

        init_distributed(f"tcp://{ranks}", int(os.environ.get("JAX_NUM_PROCESSES", "1")),
                         int(os.environ.get("JAX_PROCESS_ID", "0")), backend=args.backend,
                         device=args.device)
    try:
        _, history = run(cfg, device=args.device)
    finally:
        if ranks:
            dist.destroy_process_group()
    if history:
        print(json.dumps(history[-1], default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
