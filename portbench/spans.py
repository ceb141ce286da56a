#!/usr/bin/env python3
"""The traced window by the program's own spans: the ``tfrec.*`` ranges that
``tfrec_tpu_torch.utils.profile.span`` opens while a profiler records
(``TrainStepBuilder.step``: ``tfrec.step`` around ``tfrec.lookup``,
``.forward``, ``.backward``, ``.dense_update``, ``.combine``,
``.sparse_update``; ``Recommender.predict_ctr``: ``tfrec.serve.predict_ctr``
around ``.serve.inputs``, ``tfrec.lookup``, ``tfrec.forward``,
``.serve.outputs``). It reads the profiler's kineto events of the same
traced window that ``trace.summarize`` reads.

- Device time: each device op in the window belongs to the runtime call that
  launched it (the same ``correlation_id()``), and so to the innermost
  ``tfrec.*`` span open at that call on the launching thread. Autograd's device thread
  launches the backward with no such span open; an op launched from a
  thread with none falls back to the innermost ``tfrec.*`` span open at that
  moment on the thread that drove the window. An op counts in the self time
  of that span, and in the busy time (the union of the ops' intervals) of
  it and of every span around it.
- Idle: each device-idle gap, as ``trace._gaps`` cuts the window, is shared
  among the ``tfrec.*`` spans innermost on the window's thread during it, each
  its overlap; aten ops do not count. (A gap that runs from the end of one
  call into the next would flip, by its middle, between their spans from run
  to run.)
- Syncs: the blocking runtime calls of ``SYNC_CALLS``, by the rule of
  device time.

Each span's row gives, per step or call: how often it opened, its host
time, its self device time, its busy time, its idle time and its syncs.
``read(name, ctx)`` reads the per-layer metrics of ``METRICS`` from the
table at ``ctx.trace.spans``, and returns None where there is none.

    python3 portbench/spans.py --workload W --seed N [--seconds S]

runs a cell once with its traced window, as ``run.py --trace 1`` does, and
prints the table to standard error, then one JSON line: the steps or calls
a second of the untraced and of the traced window, the metrics, and the
share of the root span's busy time that its children's self time covers.
It needs a CUDA card, and exits 2 without one.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

if __name__ == "__main__":  # as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import trace  # noqa: E402

PREFIX = "tfrec."
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                        "cudaMemcpy"})
NO_SPAN = "(no tfrec span)"
ROOTS = ("tfrec.step", "tfrec.serve.predict_ctr")
ENTRY_SPANS = ("tfrec.serve.predict_ctr", "tfrec.serve.inputs", "tfrec.serve.outputs")


@dataclasses.dataclass
class Row:
    parent: str  # the enclosing tfrec span's name, "" at the top
    count: int = 0
    host_ns: int = 0
    self_ns: int = 0  # device ops whose innermost span this is
    busy_ns: int = 0  # the union of every op launched inside it, at any depth
    idle_ns: int = 0
    syncs: int = 0  # blocking runtime calls whose innermost span this is
    syncs_inside: int = 0  # ... inside it, at any depth


@dataclasses.dataclass
class SpanTable:
    units: int  # steps or calls in the window
    rows: Dict[str, Row]  # by span name, in order of first opening; NO_SPAN last
    sync_ops: Dict[Tuple[str, str], int]  # (span, innermost host op of the call) -> blocking calls

    def per_unit(self, name: str, field: str, scale: float = 1.0) -> Optional[float]:
        row = self.rows.get(name)
        if row is None or self.units <= 0:
            return None
        return getattr(row, field) * scale / self.units

    def coverage(self, root: str) -> Optional[float]:
        """The self device time of ``root``'s child spans over the busy
        time of the ops launched inside ``root``."""
        row = self.rows.get(root)
        if row is None or row.busy_ns <= 0:
            return None
        return sum(r.self_ns for r in self.rows.values() if r.parent == root) / row.busy_ns


def _idle_ms(table: SpanTable) -> Optional[float]:
    if ENTRY_SPANS[0] not in table.rows:
        return None
    return sum(table.per_unit(n, "idle_ns", 1e-6) or 0.0 for n in ENTRY_SPANS)


# name -> (the kind of cell it reads, its reading of a table)
METRICS = {
    "combine_device_ms.train": ("train", lambda t: t.per_unit("tfrec.combine", "self_ns", 1e-6)),
    "dense_update_device_ms.train": ("train", lambda t: t.per_unit("tfrec.dense_update", "self_ns", 1e-6)),
    "host_syncs_per_step.train": ("train", lambda t: t.per_unit("tfrec.step", "syncs_inside")),
    "entry_idle_ms.serve": ("serve", _idle_ms),
}


def read(name: str, ctx) -> Optional[float]:
    """The metric ``name`` of a run's context, or None: another kind of
    cell, no trace, no span table, or no such span in it."""
    kind, fn = METRICS[name]
    table = getattr(ctx.trace, "spans", None) if ctx.kind == kind and ctx.trace is not None else None
    return None if table is None else fn(table)


# ---- the reduction ----

Event = Tuple[str, bool, int, int, int, int]  # name, device, start, end, thread, correlation


def _events(prof) -> List[Event]:
    """Every kineto event, host ranges' mirrors on the device's timeline left
    out as ``trace._raw_events`` leaves them out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        is_device = str(e.device_type()).split(".")[-1] == "CUDA"
        start = e.start_ns()
        out.append((e.name(), is_device, start, start + e.duration_ns(), e.start_thread_id(),
                    e.correlation_id()))
    host = {e[0] for e in out if not e[1]}
    return [e for e in out if not (e[1] and e[0] in host)]


def _is_call(name: str) -> bool:
    """A CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernel``)."""
    return name.startswith("cu")


def _is_span(name: str) -> bool:
    return name.startswith(PREFIX)


def _is_host_op(name: str) -> bool:
    return not _is_call(name) and name != trace.WINDOW_RANGE


_FOREVER = 1 << 62


def _overlaps(gaps: Sequence[Tuple[int, int]], segments: Sequence[Tuple[int, int, Optional[int]]]):
    """(span or None, ns) of each piece of each gap (ascending, disjoint)
    over ``segments`` (ascending, covering all time)."""
    i = 0
    for a, b in gaps:
        while segments[i][1] <= a:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < b:
            s, e, k = segments[j]
            yield k, min(b, e) - max(a, s)
            j += 1


class _Spans:
    """The host ranges of the window that ``keep`` names (the tfrec spans
    by default), with their parents, and each thread's time cut where its
    innermost range changes."""

    def __init__(self, events: Sequence[Event], w0: int, w1: int, keep=_is_span):
        by_thread: Dict[int, list] = defaultdict(list)
        for name, dev, s, e, t, _ in events:
            if not dev and keep(name) and w0 <= s < w1 and e > s:
                by_thread[t].append((s, e, name))
        self.names: List[str] = []
        self.parent: List[Optional[int]] = []
        self.start: List[int] = []
        self.host_ns: List[int] = []
        self.cuts: Dict[int, List[Tuple[int, int, Optional[int]]]] = {}
        self.cut_starts: Dict[int, List[int]] = {}
        for t, ranges in by_thread.items():
            ranges.sort(key=lambda x: (x[0], -x[1]))  # properly nested: a parent before its children
            cut: List[Tuple[int, int, Optional[int]]] = []
            stack: List[int] = []  # indices into self.names
            now = -_FOREVER

            def emit(upto: int) -> None:
                nonlocal now
                if upto > now:
                    cut.append((now, upto, stack[-1] if stack else None))
                    now = upto

            for s, e, name in ranges:
                while stack and self.start[stack[-1]] + self.host_ns[stack[-1]] <= s:
                    emit(self.start[stack[-1]] + self.host_ns[stack[-1]])
                    stack.pop()
                emit(s)
                self.parent.append(stack[-1] if stack else None)
                stack.append(len(self.names))
                self.names.append(name)
                self.start.append(s)
                self.host_ns.append(e - s)
            while stack:
                emit(self.start[stack[-1]] + self.host_ns[stack[-1]])
                stack.pop()
            emit(_FOREVER)
            self.cuts[t] = cut
            self.cut_starts[t] = [a for a, _, _ in cut]

    def segments(self, thread: int) -> List[Tuple[int, int, Optional[int]]]:
        """(start, end, innermost range or None) of the thread, ascending,
        from -inf to inf."""
        return self.cuts.get(thread, [(-_FOREVER, _FOREVER, None)])

    def locate(self, queries: Sequence[Tuple[int, int]]) -> List[Optional[int]]:
        """The innermost range open at each (thread, time), start <= time <
        end, or None."""
        return [self.cuts[t][bisect.bisect_right(self.cut_starts[t], at) - 1][2] if t in self.cuts else None
                for t, at in queries]

    def locate_or_fallback(self, queries: Sequence[Tuple[int, int]], thread: int) -> List[Optional[int]]:
        """``locate``, falling back to ``thread`` (the window's) at the same
        moment for a call from another thread that no span holds."""
        found = self.locate(queries)
        again = [q for q, k in enumerate(found) if k is None and queries[q][0] != thread]
        for q, k in zip(again, self.locate([(thread, queries[q][1]) for q in again])):
            found[q] = k
        return found

    def chain(self, k: int) -> List[str]:
        """The names of span ``k`` and of every span around it, each once."""
        names: List[str] = []
        while k is not None:
            if self.names[k] not in names:
                names.append(self.names[k])
            k = self.parent[k]
        return names


def reduce_events(events: Sequence[Event], units: int) -> SpanTable:
    windows = [e for e in events if not e[1] and e[0] == trace.WINDOW_RANGE]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {trace.WINDOW_RANGE} ranges, not 1")
    _, _, w0, w1, window_thread, _ = windows[0]
    spans = _Spans(events, w0, w1)
    rows: Dict[str, Row] = {}

    def row(k: Optional[int]) -> Row:
        name = NO_SPAN if k is None else spans.names[k]
        if name not in rows:
            parent = None if k is None else spans.parent[k]
            rows[name] = Row(parent="" if parent is None else spans.names[parent])
        return rows[name]

    for k in sorted(range(len(spans.names)), key=lambda k: spans.start[k]):
        r = row(k)
        r.count += 1
        r.host_ns += spans.host_ns[k]

    calls = {c: (t, s) for n, d, s, _, t, c in events if not d and c and _is_call(n)}
    ops = [(max(s, w0), min(e, w1), calls.get(c)) for _, d, s, e, _, c in events
           if d and e > s and e > w0 and s < w1]
    launched = [op for op in ops if op[2] is not None]
    where = spans.locate_or_fallback([op[2] for op in launched], window_thread)
    intervals: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for (a, b, _), k in zip(launched, where):
        row(k).self_ns += b - a
        for name in ([NO_SPAN] if k is None else spans.chain(k)):
            intervals[name].append((a, b))
    for a, b, _ in (op for op in ops if op[2] is None):
        row(None).self_ns += b - a
        intervals[NO_SPAN].append((a, b))
    for name, iv in intervals.items():
        rows[name].busy_ns = sum(b - a for a, b in trace._union(iv))

    busy = trace._union((a, b) for a, b, _ in ops)
    for k, ns in _overlaps(trace._gaps(busy, w0, w1), spans.segments(window_thread)):
        row(k).idle_ns += ns

    syncs = [(t, s) for n, d, s, _, t, _ in events if not d and n in SYNC_CALLS and w0 <= s < w1]
    host_ops = _Spans(events, w0, w1, keep=_is_host_op)
    sync_ops: Dict[Tuple[str, str], int] = defaultdict(int)
    for k, op in zip(spans.locate_or_fallback(syncs, window_thread), host_ops.locate(syncs)):
        row(k).syncs += 1
        for name in ([NO_SPAN] if k is None else spans.chain(k)):
            rows[name].syncs_inside += 1
        sync_ops[(NO_SPAN if k is None else spans.names[k], "-" if op is None else host_ops.names[op])] += 1
    if NO_SPAN in rows:
        rows[NO_SPAN] = rows.pop(NO_SPAN)
    return SpanTable(units=units, rows=rows, sync_ops=dict(sync_ops))


def reduce(prof, units: int) -> SpanTable:
    """The span table of a profiler's traced window of ``units`` steps or calls."""
    return reduce_events(_events(prof), units)


def format_table(table: SpanTable) -> str:
    head = (f"{'span (per step or call, ' + str(table.units) + ' in the window)':<44} {'n':>6} "
            f"{'host ms':>9} {'self dev ms':>11} {'busy ms':>9} {'idle ms':>9} {'syncs':>7}")
    lines, u = [head], max(table.units, 1)
    for name, r in table.rows.items():
        depth, p = 0, r.parent
        while p:
            depth, p = depth + 1, table.rows[p].parent
        lines.append(f"{'  ' * depth + name:<44} {r.count / u:>6.2f} {r.host_ns * 1e-6 / u:>9.4f} "
                     f"{r.self_ns * 1e-6 / u:>11.4f} {r.busy_ns * 1e-6 / u:>9.4f} "
                     f"{r.idle_ns * 1e-6 / u:>9.4f} {r.syncs / u:>7.2f}")
    for (name, op), n in sorted(table.sync_ops.items(), key=lambda x: -x[1]):
        lines.append(f"blocking calls in {name} under {op}: {n / u:.2f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    import json

    from portbench import harness, run  # run sets the build and kernel caches' paths

    p = argparse.ArgumentParser(description="One traced run of a cell, by the program's spans.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The runner's summary of its traced window, with the span table beside
    # it (``TraceSummary.spans``), from the same profiler.
    runner, summarize = cell.runner, cell.runner.summarize

    def summarize_with_spans(prof, units):
        summary = summarize(prof, units)
        summary.spans = reduce(prof, len(units))
        return summary

    runner.summarize = summarize_with_spans
    try:
        outcome = runner.run(cell, seed=args.seed, seconds=args.seconds, trace=True, device="cuda",
                             t_start=run.T_START)
    finally:
        runner.summarize = summarize
    ctx = outcome.ctx
    table = ctx.trace.spans
    print(format_table(table), file=sys.stderr)
    correct, _ = harness.judge(outcome.numbers, cell.limits)
    untraced = ctx.units / ctx.window_s
    traced = len(ctx.trace.units) / ctx.trace.window_s
    root = next((r for r in ROOTS if r in table.rows), None)
    result = {"workload": args.workload, "seed": args.seed, "correct": correct,
              "device": torch.cuda.get_device_name(0), "power_limit_w": harness.power_limit_w(),
              "untraced_per_s": untraced, "traced_per_s": traced, "traced_over_untraced": traced / untraced,
              "busy_s": ctx.trace.busy_s, "window_s": ctx.trace.window_s,
              "coverage": None if root is None else table.coverage(root),
              "metrics": {n: v for n in METRICS if (v := read(n, ctx)) is not None}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
