#!/usr/bin/env python3
"""Run one cell of the benchmark of tfrec_tpu_torch once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with as many NVIDIA cards as the
cell asks for. Set-up makes the weights and the traffic from ``--seed`` on the
card and warms up every shape the cell uses; the window then runs for
``--seconds``; after it the port's outputs are compared with the plain
reference. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each compared number beside its limit.
Without CUDA, or with fewer cards than the cell needs, it exits non-zero and
prints no result; so it does when a module of JAX or of the JAX package
``tfrec_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()


def _process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (Linux: from
    /proc, to 10 ms); elsewhere this module's first line."""
    try:
        import os

        with open("/proc/self/stat") as f:
            started_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - started_ticks / os.sysconf("SC_CLK_TCK")
        return _T0 - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return _T0


T_START = _process_start()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache at a fixed path inside the checkout. The
# port's nvcc kernels build into build/tfrec_tpu_torch/ by themselves.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def execute(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: str,
            describe, t_start: float) -> int:
    """Everything of a run after the look for a card: the runner's set-up,
    window and check, the metrics, the import check and the result line.
    ``describe(memory_peak_bytes)`` gives the result's ``device``."""
    outcome = cell.runner.run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                              t_start=t_start)
    metrics = harness.read_metrics(cell.per_layer if trace else cell.end_to_end, outcome.ctx)
    info = describe(outcome.memory_peak_bytes)
    if trace:
        info["busy_s"] = outcome.ctx.trace.busy_s
        info["window_s"] = outcome.ctx.trace.window_s
    correct, compared = harness.judge(outcome.numbers, cell.limits)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    harness.print_result(correct, outcome.attempted, outcome.failed, metrics, info, compared,
                         outcome.ctx.trace.breakdown if trace else None)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    # The configurations are float32: no TF32 in cuBLAS or cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   lambda peak: harness.device_info(torch, cell.chips, peak), T_START)


if __name__ == "__main__":
    sys.exit(main())
