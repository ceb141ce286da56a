#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size, many seeds in one process:

- the program: the port's compared numbers, as a run reads them (training:
  its first steps against the reference; serving: the sampled requests'
  logits, each served once, against the reference);
- the control: the reference with every product's operands in TF32, the
  precision below the configuration's float32, put in the program's place;
- training's fault "half of the batch left out, the mean taken over the
  rest": the float32 reference on each batch's first half, in the
  program's place. (A state left unchanged reads 1 by the change's measure
  and needs no run.)

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 ...

One JSON line a seed and role on standard output; the first
``CONTROL_SEEDS`` seeds also read the control and the fault.
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

from portbench import harness  # noqa: E402

CONTROL_SEEDS = 3


def train_readings(cell, seed: int, device: str, with_controls: bool) -> list:
    from portbench.runners import train as drv
    from portbench.runners.common import release

    prog = drv.Program(cell, seed, device)
    first = drv.first_steps(prog, cell, seed)
    del prog
    release(device)
    ref = drv.reference_readings(cell, seed, first, device)
    rows = [{"role": "program", "numbers": drv.compare(first, ref), "losses": first["losses"]}]
    if with_controls:
        tf32 = drv.reference_readings(cell, seed, first, device, precision="tf32")
        rows.append({"role": "control_tf32", "numbers": drv.compare(tf32, ref)})
        half = drv.reference_readings(cell, seed, first, device, keep_rows=cell.traffic["batch"] // 2)
        rows.append({"role": "fault_half_batch", "numbers": drv.compare(half, ref)})
    return rows


def serve_readings(cell, seed: int, device: str, with_controls: bool) -> list:
    from portbench.runners import serve as drv
    from portbench.runners.common import release

    prog = drv.Program(cell, seed, device)
    for k in range(cell.traffic["warm_calls"]):
        prog.call(k)
    keys = drv.sample(seed, prog.pool_size, cell.traffic["compared_calls"])
    served = {k: prog.call(k) for k in keys}
    requests = {k: (prog.cat[k], prog.dense[k]) for k in keys}
    del prog
    release(device)
    ref = drv.reference_logits(cell, seed, requests, device)
    rows = [{"role": "program", "numbers": {"logit_gap": drv.logit_gap(served, ref)}}]
    if with_controls:
        tf32 = drv.reference_logits(cell, seed, requests, device, "tf32")
        tf32 = {k: v.cpu().numpy() for k, v in tf32.items()}
        rows.append({"role": "control_tf32", "numbers": {"logit_gap": drv.logit_gap(tf32, ref)}})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = train_readings if cell.traffic["runner"] == "train" else serve_readings
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        for row in readings(cell, seed, "cuda", i < CONTROL_SEEDS):
            print(json.dumps({"workload": cell.name, "seed": seed, **row,
                              "seconds": round(time.perf_counter() - t, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
