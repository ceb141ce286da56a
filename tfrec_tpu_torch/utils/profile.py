"""Profiling hooks: the counterpart of ``tfrec_tpu/utils/profile.py`` on
``torch.profiler``.

- ``StepProfiler``: traces the steps of ``train.profile_steps = (start,
  stop)``; it starts at the first step with ``start <= step < stop`` and
  stops at the first with ``step >= stop`` (the counter may advance by
  ``steps_per_dispatch``), then writes a Chrome trace
  (``trace_<start>_<stop>.json``) into ``out_dir``, by default
  ``tfrec_trace`` under the temporary directory (the reference's
  ``/tmp/tfrec_trace`` where ``TMPDIR`` is unset). The card's kernels are
  in it where CUDA is available.
- ``span``: a named range in the trace (``record_function``) while a
  profiler records, else one shared no-op context: an unguarded
  ``record_function`` costs microseconds even with no profiler running,
  the guard a fraction of one. The program's layers open ``tfrec.*`` spans
  (``train/step.TrainStepBuilder.step``, ``serve.Recommender.predict_ctr``),
  and the trainer a ``train_step`` span a dispatch. They are the profiler's
  own ranges, on its clock, in the same trace as the card's activity.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch

_OFF = contextlib.nullcontext()


def default_trace_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "tfrec_trace")


class StepProfiler:
    """Starts and stops a ``torch.profiler`` trace as the step counter
    crosses the window; safe to call every step, a no-op outside it."""

    def __init__(self, window: tuple[int, int] | None, out_dir: str | None = None):
        self.window = None if window is None else tuple(int(s) for s in window)
        self.out_dir = out_dir or default_trace_dir()
        self.path: str | None = None  # the last trace written
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def step(self, step_idx: int) -> None:
        if self.window is None:
            return
        start, stop = self.window
        if self._prof is None and start <= step_idx < stop:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and step_idx >= stop:
            self.close()

    def close(self) -> None:
        """Stops an open trace and writes it."""
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        start, stop = self.window
        self.path = os.path.join(self.out_dir, f"trace_{start}_{stop}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records;
    otherwise a shared ``nullcontext``."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
