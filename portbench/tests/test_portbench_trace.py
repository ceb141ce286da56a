"""The traced window's reduction, on a stand-in of the profiler's events."""

from types import SimpleNamespace

import pytest

from portbench import trace


class _Event:
    def __init__(self, name, device, start, end, thread=1):
        self._e = (name, device, start, end, thread)

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


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


def test_summarize_busy_gaps_and_kernels():
    events = [
        _Event(trace.WINDOW_RANGE, False, 0, 1000),
        _Event("portbench.step", False, 0, 600),
        _Event("portbench.step", True, 10, 590),  # the range's mirror on the device: not an op
        _Event("aten::mm", False, 50, 120),
        _Event("cudaStreamSynchronize", False, 700, 900),
        _Event("void gather_rows_kernel<4>(Launch)", True, 100, 300),
        _Event("sgemm", True, 250, 400),  # overlaps the gather: counted once in busy
        _Event("Memcpy HtoD", True, 500, 550),
        _Event("other thread", False, 0, 1000, thread=2),
    ]
    t = trace.summarize(_prof(events), [3, 4])
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx(350e-9)  # [100, 400] and [500, 550]
    assert sorted(n for n, _, _ in t.device_ops) == ["Memcpy HtoD", "sgemm", "void gather_rows_kernel<4>(Launch)"]
    assert t.kernel_seconds([r"\bgather_rows_kernel\b"]) == (pytest.approx(200e-9), 1)
    gaps = dict(t.idle_gaps)
    # [0, 100) mid 50: aten::mm; [400, 500) and [550, 1000): the step, then the sync.
    assert gaps == {"aten::mm": pytest.approx(100e-9), "portbench.step": pytest.approx(100e-9),
                    "cudaStreamSynchronize": pytest.approx(450e-9)}
    assert [n for n, _ in t.breakdown["device_ops"]][0] == "void gather_rows_kernel<4>(Launch)"


def test_summarize_wants_one_window_and_device_work():
    with pytest.raises(RuntimeError, match="ranges"):
        trace.summarize(_prof([_Event("x", True, 0, 1)]), [])
    with pytest.raises(RuntimeError, match="no device operation"):
        trace.summarize(_prof([_Event(trace.WINDOW_RANGE, False, 0, 10)]), [])
