"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics read: the device's operations, the benchmark's spans and
the host operations, as intervals on the profiler's clock (ns)."""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

# the benchmark's record_function names
SPANS = ("window", "fetch", "upload", "decompose", "eval", "check_copy")
TOP = 10  # entries of each breakdown list

Interval = Tuple[int, int]


def _ns(ev) -> Tuple[int, int]:
    """(start, end) of a profiler event in ns (older torch has only us)."""
    if hasattr(ev, "start_ns"):
        return ev.start_ns(), ev.start_ns() + ev.duration_ns()
    return 1000 * ev.start_us(), 1000 * (ev.start_us() + ev.duration_us())


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged: List[Interval], s: int, e: int) -> int:
    """ns of [s, e] that the disjoint sorted intervals ``merged`` cover."""
    i = max(0, bisect.bisect_right(merged, (s, s)) - 1)
    ns = 0
    while i < len(merged) and merged[i][0] < e:
        ns += max(0, min(e, merged[i][1]) - max(s, merged[i][0]))
        i += 1
    return ns


def gaps(merged: List[Interval], s: int, e: int) -> List[Interval]:
    out, cur = [], s
    for a, b in merged:
        if b <= s or a >= e:
            continue
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < e:
        out.append((cur, e))
    return out


class Trace:
    """The profiler's events of one traced window.

    ``device``: (name, start, end) of every device operation (kernels,
    copies, sets); ``spans``: the benchmark's spans by name; ``host``:
    (start, end, name) of every host event, spans included; ``start`` and
    ``end``: the "window" span's.  The "check_copy" spans, in which picked
    answers are copied to the host for the check, are not the window's:
    their time and their device operations are left out.  A device
    operation is a check copy's where the host operation that launched it
    started inside a "check_copy" span: the device's clock, converted to
    the host's, may stray by a millisecond and more, so the operation's own
    start cannot tell.  Device time that still falls inside a "check_copy"
    span is not the window's either (``busy_s``)."""

    def __init__(self, prof, spans=SPANS):
        from torch.autograd import DeviceType

        self.device: List[Tuple[str, int, int]] = []
        self.spans: Dict[str, List[Interval]] = collections.defaultdict(list)
        self.host: List[Tuple[int, int, str]] = []
        launched_at: Dict[int, int] = {}  # a host operation's correlation id -> its start
        links: List[int] = []  # of each device operation: the correlation id of its host operation
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            start, end = _ns(ev)
            if ev.device_type() == DeviceType.CPU:
                self.host.append((start, end, name))
                if name in spans:
                    self.spans[name].append((start, end))
                if ev.linked_correlation_id() == 0 and ev.correlation_id() > 0:  # the host's own
                    launched_at[ev.correlation_id()] = start
            elif name not in spans:  # a span's range on the device is no operation
                self.device.append((name, start, end))
                links.append(ev.linked_correlation_id())
        (self.start, self.end), = self.spans.pop("window")
        self.paused = union(self.spans.pop("check_copy", []))
        at = [launched_at.get(link, d[1]) for d, link in zip(self.device, links)]
        self.device = [d for d, a in zip(self.device, at) if not covered(self.paused, a, a + 1)]
        self.busy = union([(s, e) for _, s, e in self.device])

    @property
    def window_s(self) -> float:
        return (self.end - self.start - covered(self.paused, self.start, self.end)) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds of the window, less its "check_copy" spans, in which an
        operation ran on the device: at most ``window_s``."""
        ns = covered(self.busy, self.start, self.end)
        for s, e in self.paused:
            s, e = max(s, self.start), min(e, self.end)
            if s < e:
                ns -= covered(self.busy, s, e)
        return ns / 1e9

    def device_ms(self, keep) -> float:
        """ms of the device operations whose name ``keep`` accepts."""
        return sum(e - s for name, s, e in self.device if keep(name)) / 1e6

    def device_ops(self) -> List[list]:
        """The TOP device operations by their summed seconds."""
        tot = collections.Counter()
        for name, s, e in self.device:
            tot[name[:160]] += (e - s) / 1e9
        return [[n, v] for n, v in tot.most_common(TOP)]

    def idle_gaps(self, spans=("fetch", "upload", "decompose", "eval")) -> List[list]:
        """Seconds with no device operation, by what the host was doing: the
        benchmark's span and the innermost host operation open at the gap's
        start; the TOP labels by their summed seconds."""
        ops = sorted(h for h in self.host if h[2] not in SPANS)
        starts = [h[0] for h in ops]
        outer = sorted((s, e, name) for name in spans for s, e in self.spans.get(name, ()))
        outer_starts = [s for s, _, _ in outer]
        tot = collections.Counter()
        for gs, ge in gaps(union(self.busy + self.paused), self.start, self.end):
            j = bisect.bisect_right(outer_starts, gs) - 1
            span = outer[j][2] if j >= 0 and outer[j][1] >= gs else "between requests"
            i = bisect.bisect_right(starts, gs)
            inner = next((name for s, e, name in reversed(ops[max(0, i - 64):i]) if e >= gs),
                         "host code")
            tot[f"{span}: {inner}"] += (ge - gs) / 1e9
        return [[n, v] for n, v in tot.most_common(TOP)]
