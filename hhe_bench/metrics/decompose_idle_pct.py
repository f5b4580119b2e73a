"""Share of the "decompose" spans' time in which no operation ran on the
device (profiler trace)."""

from hhe_bench.trace import covered


def read(run):
    spans = run.trace.spans.get("decompose") if run.trace else None
    if not spans:
        return None
    total = sum(e - s for s, e in spans)
    busy = sum(covered(run.trace.busy, s, e) for s, e in spans)
    return 100.0 * (total - busy) / total
