"""What the runners hand to the metric readers and to ``run.py``."""

from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench.trace import TraceSummary

TRACE_SECONDS = 2.0  # the traced window, after the measured one
MIN_TRACE_UNITS = 3


@dataclasses.dataclass
class Context:
    """What a run measured, for ``metrics/<name>.py`` to read."""

    kind: str  # the runner: "train" or "serve"
    cfg: dict
    traffic: dict
    family: object  # families/<family>.py
    setup_s: float
    window_s: float  # the measured window, host clock, closed by a synchronize
    units: int  # steps or calls completed in it
    rows_per_unit: int
    enqueue_s: List[float] = dataclasses.field(default_factory=list)  # train: host time in each step call
    latency_s: List[float] = dataclasses.field(default_factory=list)  # serve: call to logits on the host
    window_peak_bytes: int = 0  # torch.cuda.max_memory_allocated over the window
    trace: Optional[TraceSummary] = None


@dataclasses.dataclass
class Outcome:
    ctx: Context
    numbers: Dict[str, float]  # compared numbers, by name
    attempted: int
    failed: int
    memory_peak_bytes: int


class Phases:
    """Set-up's phases, each closed by a synchronize, for standard error."""

    def __init__(self, device: str):
        self.device, self.marks = device, [("start", now())]

    def mark(self, name: str) -> None:
        sync(self.device)
        self.marks.append((name, now()))

    def report(self, t_start: float) -> None:
        parts = [f"imports and start {self.marks[0][1] - t_start:.3f} s"]
        parts += [f"{name} {t - t0:.3f} s" for (_, t0), (name, t) in zip(self.marks, self.marks[1:])]
        print("setup: " + "; ".join(parts), file=sys.stderr)


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device: str) -> int:
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def reset_peak(device: str) -> None:
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def release(device: str) -> None:
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def now() -> float:
    return time.perf_counter()


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves=None) -> Dict[str, float]:
    """Each leaf's |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = list(ref) if leaves is None else list(leaves)
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def distinct_per_column(cat: torch.Tensor) -> List[int]:
    """Distinct ids of each column of [rows, F] ids."""
    s = torch.sort(cat, dim=0).values
    return (1 + (s[1:] != s[:-1]).sum(dim=0)).tolist()
