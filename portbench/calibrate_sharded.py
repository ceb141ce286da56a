#!/usr/bin/env python3
"""The readings that a sharded training cell's correctness limits are set
from, on as many cards as the cell takes, one run of its ranks a seed (no
measured window):

- the program: the port's first steps against the plain reference, as a run
  reads them;
- the control: the reference with every product's operands in TF32, the
  precision below the configuration's float32, in the program's place;
- the fault "the last id of each bag of the widest field dropped": the
  float32 reference so, in the program's place;
- for the record, the program, the float32 reference and the control each
  against the same steps taken in float64.

    python3 portbench/calibrate_sharded.py --workload <name> --seeds 1 2 3 ...

One JSON line a seed and role on standard output, each with ``correct``: the
role's numbers judged against the cell's limits (``harness.judge``), as a run
at the cell's own size judges them; the program must pass and both controls
fail. (``calibrate.py`` reads the one-card runners by name, ``train`` and
``serve``, and not this one.)
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, run  # noqa: E402,F401  (run sets the build and kernel caches' paths)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate_sharded: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        t = time.perf_counter()
        outcome = cell.runner.run(cell, seed=seed, seconds=0.0, trace=False, device="cuda", t_start=t,
                                  controls=True)
        for role in ("program", "control_tf32", "fault_dropped_id"):
            correct, _ = harness.judge(outcome.readings[role], cell.limits)
            row = {"workload": cell.name, "seed": seed, "role": role, "correct": correct,
                   "numbers": outcome.readings[role]}
            if role == "program":
                row["losses"] = outcome.readings["losses"]
                row["loss_gaps"] = outcome.readings["loss_gaps"]
            if role in outcome.readings["worst_leaves"]:
                row["worst_leaves"] = outcome.readings["worst_leaves"][role]
            print(json.dumps({**row, "seconds": round(time.perf_counter() - t, 3)}), flush=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "role": "against_float64",
                          "numbers": outcome.readings["against_float64"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
