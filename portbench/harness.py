"""What every cell's run shares: the manifest and the files a cell names,
the card's description, the end-of-run import check, the metric readers and
the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. It names a
configuration (its ``file``, a JSON of sizes, whose ``family`` names
``families/<family>.py`` and ``reference/<family>.py``) and a traffic mix
(``traffic/<traffic>.json``, whose ``runner`` names ``runners/<runner>.py``);
its correctness limits are ``limits/<workload>.json``. Every metric is read by
``metrics/<metric>.py``. Nothing here names a cell, a configuration or a
metric: a later cell adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
MANIFEST = ROOT / "BENCHMARK.json"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tfrec_tpu")


def load_manifest() -> dict:
    return read_json(MANIFEST)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload entry and what its names lead to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Optional[dict]

    @property
    def family(self) -> ModuleType:
        return importlib.import_module(f"portbench.families.{self.config['family']}")

    @property
    def reference(self) -> ModuleType:
        return importlib.import_module(f"portbench.reference.{self.config['family']}")

    @property
    def runner(self) -> ModuleType:
        return importlib.import_module(f"portbench.runners.{self.traffic['runner']}")


def metric_applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str) -> Cell:
    manifest = load_manifest()
    entries = {w["name"]: w for w in manifest["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(entries)}")
    w = entries[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    limits_path = PKG / "limits" / f"{workload}.json"
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=read_json(ROOT / configs[w["config"]]["file"]),
        traffic=read_json(PKG / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if metric_applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if metric_applies(m, workload)],
        limits=read_json(limits_path) if limits_path.exists() else None,
    )


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py`` (names may hold dots, so loaded by path)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metrics(entries: List[dict], ctx: Any) -> Dict[str, dict]:
    """Each metric's reader over ``ctx``; a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is, whole, one of the JAX
    package's or JAX's own (``tfrec_tpu_torch`` is not ``tfrec_tpu``)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi``, or None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def device_info(torch, count: int, memory_peak_bytes: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": int(memory_peak_bytes),
        "power_limit_w": power_limit_w(),
    }


def judge(numbers: Dict[str, float], limits: Optional[dict]) -> tuple[bool, Dict[str, dict]]:
    """Each compared number beside its limit; correct where every number is
    finite and at or under its limit (no limits file: not correct)."""
    compared = {}
    ok = limits is not None
    for name, value in numbers.items():
        limit = None if limits is None else limits.get(name)
        compared[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, compared


def print_result(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                 compared: Dict[str, dict], breakdown: Optional[dict] = None) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output, ``compared`` its last key."""
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
