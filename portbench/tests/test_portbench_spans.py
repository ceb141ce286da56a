"""The reduction by the program's spans, on a stand-in of the profiler's events."""

from types import SimpleNamespace

import pytest

from portbench import spans, trace
from portbench.trace import TraceSummary

WINDOW_THREAD, AUTOGRAD = 1, 2


class _Event:
    def __init__(self, name, device, start, end, thread=WINDOW_THREAD, corr=0):
        self._e = (name, device, start, end, thread, corr)

    def name(self):
        return self._e[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._e[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._e[2]

    def duration_ns(self):
        return self._e[3] - self._e[2]

    def start_thread_id(self):
        return self._e[4]

    def correlation_id(self):
        return self._e[5]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


def _host(name, start, end, thread=WINDOW_THREAD, corr=0):
    return _Event(name, False, start, end, thread, corr)


def _kernel(start, end, corr=0):
    return _Event(f"kernel_{start}", True, start, end, corr=corr)


TRAIN_EVENTS = [
    _host(trace.WINDOW_RANGE, 0, 10000),
    _host("portbench.step", 0, 9000),
    _host("tfrec.step", 100, 8000),
    _Event("tfrec.step", True, 150, 7900),  # the range's mirror on the device: not an op
    _host("tfrec.lookup", 100, 1000),
    _host("aten::index", 200, 900),  # open at the first gap's middle: does not count
    _host("cudaLaunchKernel", 300, 310, corr=11),
    _kernel(400, 1400, corr=11),
    _host("tfrec.forward", 1000, 3000),
    _host("aten::mm", 1500, 1550, corr=99),
    _host("cuLaunchKernel", 1510, 1520, corr=13),  # a CUDA API call, as cuBLAS makes
    _kernel(1600, 2600, corr=13),
    _host("tfrec.backward", 3000, 5000),
    _host("autograd::engine::evaluate_function", 3400, 3700, thread=AUTOGRAD),
    _host("cudaLaunchKernel", 3500, 3510, thread=AUTOGRAD, corr=12),
    _kernel(3600, 4600, corr=12),  # from autograd's thread: the window thread's span
    _host("tfrec.dense_update", 5000, 6000),
    _host("cudaLaunchKernel", 5100, 5110, corr=15),
    _kernel(5200, 5500, corr=15),
    _host("tfrec.combine", 6000, 7000),
    _host("cudaLaunchKernel", 6100, 6110, corr=14),
    _kernel(6200, 6900, corr=14),
    _host("cudaStreamSynchronize", 6500, 6950),
    _host("cudaMemcpyAsync", 6960, 6970, corr=17),  # not a blocking call
    _host("tfrec.sparse_update", 7000, 8000),
    _host("cudaLaunchKernel", 7100, 7110, corr=16),
    _kernel(7200, 7800, corr=16),
    _kernel(8500, 8600),  # nothing says who launched it
    _host("cudaStreamSynchronize", 8700, 8950),  # the harness's, outside every span
]


def _table():
    return spans.reduce(_prof(TRAIN_EVENTS), units=1)


def test_device_ops_by_correlation_and_the_window_threads_fallback():
    rows = _table().rows
    assert list(rows) == ["tfrec.step", "tfrec.lookup", "tfrec.forward", "tfrec.backward",
                          "tfrec.dense_update", "tfrec.combine", "tfrec.sparse_update", spans.NO_SPAN]
    self_ns = {n: r.self_ns for n, r in rows.items()}
    assert self_ns == {"tfrec.step": 0, "tfrec.lookup": 1000, "tfrec.forward": 1000, "tfrec.backward": 1000,
                       "tfrec.dense_update": 300, "tfrec.combine": 700, "tfrec.sparse_update": 600,
                       spans.NO_SPAN: 100}
    assert rows["tfrec.step"].busy_ns == 4600 and rows["tfrec.combine"].busy_ns == 700
    assert {r.parent for n, r in rows.items() if n not in ("tfrec.step", spans.NO_SPAN)} == {"tfrec.step"}
    assert (rows["tfrec.step"].count, rows["tfrec.step"].host_ns) == (1, 7900)
    assert _table().coverage("tfrec.step") == pytest.approx(1.0)


def test_idle_gaps_shared_by_the_innermost_spans_even_under_an_aten_op():
    idle = {n: r.idle_ns for n, r in _table().rows.items()}
    # [0, 400): no span to 100, then the lookup (aten::index open from 200);
    # [1400, 1600) forward; [2600, 3600) forward 400, backward 600;
    # [4600, 5200) backward 400, dense update 200; [5500, 6200) dense update
    # 500, combine 200; [6900, 7200) combine 100, sparse update 200;
    # [7800, 8500) sparse update 200, no span 500; [8600, 10000) no span.
    assert idle == {"tfrec.step": 0, "tfrec.lookup": 300, "tfrec.forward": 600, "tfrec.backward": 1000,
                    "tfrec.dense_update": 700, "tfrec.combine": 300, "tfrec.sparse_update": 400,
                    spans.NO_SPAN: 2000}


def test_blocking_calls_counted_by_their_span():
    rows = _table().rows
    assert rows["tfrec.combine"].syncs == 1 and rows["tfrec.step"].syncs_inside == 1
    assert rows[spans.NO_SPAN].syncs == 1 and rows["tfrec.sparse_update"].syncs == 0
    assert _table().sync_ops == {("tfrec.combine", "tfrec.combine"): 1, (spans.NO_SPAN, "portbench.step"): 1}


def _serve_table():
    return spans.reduce(_prof([
        _host(trace.WINDOW_RANGE, 0, 1000),
        _host("tfrec.serve.predict_ctr", 0, 1000),
        _host("tfrec.serve.inputs", 0, 200),
        _host("cudaMemcpyAsync", 50, 60, corr=21),
        _Event("Memcpy HtoD (Pageable -> Device)", True, 100, 150, corr=21),
        _host("tfrec.lookup", 200, 400),
        _host("tfrec.forward", 400, 800),
        _host("cudaLaunchKernel", 420, 430, corr=22),
        _kernel(450, 750, corr=22),
        _host("tfrec.serve.outputs", 800, 1000),
        _host("cudaMemcpyAsync", 850, 860, corr=23),
        _Event("Memcpy DtoH (Device -> Pageable)", True, 860, 900, corr=23),
        _host("cudaStreamSynchronize", 860, 905),
    ]), units=1)


def _ctx(kind, table):
    summary = TraceSummary(window_s=1.0, busy_s=0.5, device_ops=[("k", 0.5, 1)], idle_gaps=[], units=[0],
                           distinct={}, ids={})
    if table is not None:
        summary.spans = table
    return SimpleNamespace(kind=kind, trace=summary)


def test_metrics_read_their_own_kind_of_cell_only():
    train, serve = _table(), _serve_table()
    got = {n: spans.read(n, _ctx("train", train)) for n in spans.METRICS}
    assert got == {"combine_device_ms.train": pytest.approx(700e-6),
                   "dense_update_device_ms.train": pytest.approx(300e-6),
                   "host_syncs_per_step.train": 1.0, "entry_idle_ms.serve": None}
    # Inputs [0, 100) and [150, 200); outputs [800, 860) and [900, 1000).
    got = {n: spans.read(n, _ctx("serve", serve)) for n in spans.METRICS}
    assert got == {"combine_device_ms.train": None, "dense_update_device_ms.train": None,
                   "host_syncs_per_step.train": None, "entry_idle_ms.serve": pytest.approx(310e-6)}
    assert serve.rows["tfrec.serve.outputs"].syncs == 1
    # Crossed over, with no table (a harness that hands none over), no trace.
    assert spans.read("entry_idle_ms.serve", _ctx("serve", train)) is None
    assert spans.read("combine_device_ms.train", _ctx("train", serve)) is None
    assert all(spans.read(n, _ctx(k, None)) is None for n, (k, _) in spans.METRICS.items())
    assert spans.read("combine_device_ms.train", SimpleNamespace(kind="train", trace=None)) is None


def test_innermost_span_of_nested_ranges():
    ranges = [(0, 100), (10, 40), (20, 30), (50, 90)]
    events = [(f"tfrec.{i}", False, s, e, WINDOW_THREAD, 0) for i, (s, e) in enumerate(ranges)]
    index = spans._Spans(events, 0, 100)
    times = [-5, 0, 15, 25, 30, 45, 60, 95, 100]
    assert index.locate([(WINDOW_THREAD, t) for t in times]) == [None, 0, 1, 2, 1, 0, 3, 0, None]
    assert index.locate([(AUTOGRAD, 15)]) == [None] and index.parent == [None, 0, 1, 0]
    cut = index.segments(WINDOW_THREAD)
    assert [(a, b, k) for a, b, k in cut[1:-1]] == [(0, 10, 0), (10, 20, 1), (20, 30, 2), (30, 40, 1),
                                                    (40, 50, 0), (50, 90, 3), (90, 100, 0)]
    assert cut[0][1:] == (0, None) and cut[-1][0] == 100 and cut[-1][2] is None


def test_table_prints_every_span_indented_under_its_parent():
    text = spans.format_table(_table()).splitlines()
    assert len(text) == 1 + 8 + 2
    assert text[1].startswith("tfrec.step ") and text[2].startswith("  tfrec.lookup ")
    assert text[8].startswith(spans.NO_SPAN)
    assert text[9] == "blocking calls in tfrec.combine under tfrec.combine: 1.00"


def test_one_window_wanted():
    with pytest.raises(RuntimeError, match="ranges"):
        spans.reduce(_prof([_kernel(0, 1)]), units=1)
