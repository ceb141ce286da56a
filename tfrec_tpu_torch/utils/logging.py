"""Structured run logging: stdout + JSONL metric stream. A copy of
``tfrec_tpu.utils.logging.MetricLogger``; a test holds the two equal
record for record.

Every record is one JSON object ({"step", "epoch", "wall_s", ...metrics}),
so benchmark tooling can parse runs mechanically.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, IO


class MetricLogger:
    def __init__(
        self,
        run_name: str = "run",
        out_dir: str | None = None,
        quiet: bool = False,
        tensorboard: bool = True,
    ):
        self.run_name = run_name
        self.quiet = quiet
        self.t0 = time.monotonic()
        self._fh: IO[str] | None = None
        self._tb = None
        self._step = 0
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(os.path.join(out_dir, f"{run_name}.metrics.jsonl"), "a")
            if tensorboard:
                try:  # optional: torch's pure-python TB writer
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(
                        os.path.join(out_dir, "tb", run_name)
                    )
                except Exception:
                    self._tb = None

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("wall_s", round(time.monotonic() - self.t0, 3))
        line = json.dumps(record, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._tb is not None:
            step = int(record.get("epoch", self._step))
            for key, val in record.items():
                if isinstance(val, (int, float)) and key not in ("epoch",):
                    try:
                        self._tb.add_scalar(key, float(val), step)
                    except Exception:
                        pass
            self._tb.flush()
        self._step += 1
        if not self.quiet:
            print(f"[{self.run_name}] {line}", file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
