"""The reduction of the traced window (``hhe_bench.trace``): a check copy's
device operations are left out by the host operation that launched them,
even where the device's clock strays from the host's, and the busy time
never passes the window's."""

import types

import pytest
import torch
from torch.autograd import DeviceType

from hhe_bench.trace import Trace

MS = 1_000_000  # ns


class Event:
    """The parts of a profiler event that ``Trace`` reads."""

    def __init__(self, name, cpu, start, end, corr=0, link=0):
        self._name, self._cpu, self._start, self._end = name, cpu, start, end
        self._corr, self._link = corr, link

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CPU if self._cpu else DeviceType.CUDA

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._link


def profile_of(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def window_with_check_copy(copy_start_ms):
    """A 10 ms window: a request's kernel over [1, 4) ms launched by a host
    operation, a check copy's span over [4, 8) ms whose copy the device
    stamps from ``copy_start_ms`` on, a host event with no correlation id
    inside that span, and a kernel with no host operation (a graph's) over
    [8.5, 9.5) ms."""
    return [
        Event("window", True, 0, 10 * MS, corr=1),
        Event("eval", True, MS // 2, 4 * MS, corr=2),
        Event("aten::add", True, MS // 2, MS, corr=5),
        Event("kernel_a", False, MS, 4 * MS, link=5),
        Event("check_copy", True, 4 * MS, 8 * MS, corr=6),
        Event("aten::copy_", True, 4 * MS + MS // 10, 8 * MS - MS // 10, corr=7),
        Event("cudaMemcpyAsync", True, 4 * MS + MS // 5, 8 * MS - MS // 5, corr=99, link=7),
        Event("Memcpy DtoH (Device -> Pageable)", False, copy_start_ms * MS,
              (copy_start_ms + 3.9) * MS, link=7),
        Event("<python function>", True, 5 * MS, 6 * MS),  # no correlation id
        Event("kernel_b", False, 8 * MS + MS // 2, 9 * MS + MS // 2),
    ]


@pytest.mark.parametrize("copy_start_ms", [4.2, 3.9], ids=["clocks_agree", "device_clock_early"])
def test_check_copy_left_out_by_its_launch(copy_start_ms):
    tr = Trace(profile_of(window_with_check_copy(copy_start_ms)))
    assert tr.window_s == pytest.approx(6e-3)
    assert tr.busy_s == pytest.approx(4e-3)
    assert [name for name, _ in tr.device_ops()] == ["kernel_a", "kernel_b"]
    assert sum(v for _, v in tr.idle_gaps()) == pytest.approx(2e-3)


def test_busy_never_passes_the_window():
    """Device time that the trace puts inside a check copy's span, whatever
    launched it, is not the window's."""
    events = window_with_check_copy(4.2)
    events.append(Event("kernel_c", False, 3 * MS, 6 * MS))  # no host operation of its own
    tr = Trace(profile_of(events))
    assert tr.busy_s == pytest.approx(4e-3) and tr.busy_s <= tr.window_s


def test_reads_a_real_profile():
    """The profiler's own events carry what ``Trace`` reads (on the CPU: no
    device operation, so nothing busy)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof, record_function("window"):
        with record_function("eval"):
            torch.ones(64).add_(1)
        with record_function("check_copy"):
            torch.ones(64).clone()
    tr = Trace(prof)
    assert tr.window_s > 0 and tr.busy_s == 0 and tr.device_ops() == []
    assert len(tr.spans["eval"]) == 1 and len(tr.paused) == 1
