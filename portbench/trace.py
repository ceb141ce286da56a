"""The traced window: ``torch.profiler`` with CUDA activity over it, reduced
to device busy time, kernel time by name and the idle gaps by what the
host was doing.

The window is one harness range (``WINDOW_RANGE``) around the traced steps
or calls, closed by a synchronize, so every device operation the window
enqueued lies inside it. Device busy time is the union of the device's
kernel, copy and set intervals; an idle gap is a stretch of the window in
which none runs, named by the innermost host range open at its middle on
the thread that drove the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

WINDOW_RANGE = "portbench.window"
TOP = 10
NAME_CHARS = 160


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float, int]]  # (name, seconds, count), every device op
    idle_gaps: List[Tuple[str, float]]  # (host range, seconds), largest first
    units: List[int]  # pool entries the window ran, in order
    distinct: Dict[int, List[int]]  # pool entry -> distinct ids of each table
    ids: Dict[int, List[int]]  # pool entry -> ids of each table

    def kernel_seconds(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """Summed time and count of the device ops whose names match any of
        ``patterns`` (regular expressions, searched)."""
        rx = re.compile("|".join(f"(?:{p})" for p in patterns))
        secs, count = 0.0, 0
        for name, s, n in self.device_ops:
            if rx.search(name):
                secs += s
                count += n
        return secs, count

    @property
    def breakdown(self) -> dict:
        ops = sorted(self.device_ops, key=lambda x: -x[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s, _ in ops],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in self.idle_gaps[:TOP]]}


@contextlib.contextmanager
def profiled(torch):
    """A profiler over the block: the host's ranges and the card's activity."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def _raw_events(prof):
    """(name, is_device, start_ns, end_ns, thread) of every event. A host
    range's mirror on the device's timeline (a ``gpu_user_annotation``,
    which bears the range's name) is no device operation and is left out:
    no kernel, copy or set is named as a host event is."""
    out = []
    for e in prof.profiler.kineto_results.events():
        is_device = str(e.device_type()).split(".")[-1] == "CUDA"
        start = e.start_ns()
        out.append((e.name(), is_device, start, start + e.duration_ns(), e.start_thread_id()))
    host_names = {n for n, d, *_ in out if not d}
    return [e for e in out if not (e[1] and e[0] in host_names)]


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _gaps(busy: List[Tuple[int, int]], w0: int, w1: int) -> List[Tuple[int, int]]:
    out, t = [], w0
    for a, b in busy:
        if a > t:
            out.append((t, min(a, w1)))
        t = max(t, b)
        if t >= w1:
            break
    if t < w1:
        out.append((t, w1))
    return [(a, b) for a, b in out if b > a]


def _name_gaps(gaps, host_events) -> Dict[str, int]:
    """Each gap's nanoseconds by the innermost host range open at its
    middle (a sweep over properly nested ranges of one thread)."""
    host_events = sorted(host_events, key=lambda e: (e[0], -e[1]))
    totals: Dict[str, int] = defaultdict(int)
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for a, b in sorted(gaps):
        mid = (a + b) // 2
        while i < len(host_events) and host_events[i][0] <= mid:
            s, e, name = host_events[i]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        totals[stack[-1][2] if stack else "(no host range)"] += b - a
    return totals


def summarize(prof, units: List[int]) -> TraceSummary:
    events = _raw_events(prof)
    windows = [e for e in events if not e[1] and e[0] == WINDOW_RANGE]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW_RANGE} ranges, not 1")
    _, _, w0, w1, thread = windows[0]
    device = [(s, e, n) for n, d, s, e, _ in events if d and e > s]
    if not device:
        raise RuntimeError("the trace holds no device operation: the card's activity was not traced")
    busy = _union((max(s, w0), min(e, w1)) for s, e, _ in device if e > w0 and s < w1)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, e, n in device:
        by_name[n][0] += (e - s) * 1e-9
        by_name[n][1] += 1
    idle: List[Tuple[str, float]] = []
    try:
        host = [(s, e, n) for n, d, s, e, t in events
                if not d and t == thread and n != WINDOW_RANGE and e > s]
        named = _name_gaps(_gaps(busy, w0, w1), host)
        idle = sorted(((n, ns * 1e-9) for n, ns in named.items()), key=lambda x: -x[1])
    except Exception as exc:  # the breakdown is advice; the metrics do not read it
        print(f"portbench: idle gaps not named: {exc!r}", file=sys.stderr)
    return TraceSummary(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(b - a for a, b in busy) * 1e-9,
        device_ops=[(n, v[0], int(v[1])) for n, v in by_name.items()],
        idle_gaps=idle,
        units=units,
        distinct={},
        ids={},
    )

