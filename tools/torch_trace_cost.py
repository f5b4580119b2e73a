"""What the port's tracing (``hhe_tpu_torch.utils.trace``) costs on one card,
and which program span holds each idle gap of a traced request, for one
cell of BENCHMARK.json.

    python3 tools/torch_trace_cost.py --workload ecg_1fc.b64 [--seed N] [--requests R]
        [--rounds 3] [--out FILE]

The cell is built as ``hhe_bench``'s harness builds it (its ``Harness``,
the configuration's entry, a pool of requests under fresh nonces), warmed
up with ``harness.WARMUP`` requests, and then, in ``--rounds`` rounds that
take the modes in turn, ``--requests`` requests a mode, each timed on the
host clock to its synchronised result (the median a mode):

- ``off``: no profiler, no layer synchronise (the timed run's requests);
- ``off_synced``: no profiler, each layer ended by a synchronise (the
  traced run's requests without the profiler);
- ``profiled``: under ``torch.profiler`` (CPU and CUDA activity), layer
  synchronises, the program's spans on;
- ``profiled_bare``: the same with ``trace.span`` returning its no-op, so
  that ``profiled`` - ``profiled_bare`` is what the program's spans cost
  while a profiler records.

Also, with tracing off: the span calls a request makes (by name) and the
host cost of one (the least of ``LOOPS`` loops of ``CALLS`` calls of
``with trace.span(...)``); and from the last round's profile, reduced by
``hhe_bench.trace.Trace``: the idle gaps by the benchmark's label (span:
innermost host operation) and by the chain of program spans open at each
gap's start, with ``trace.counts()`` of that round over its requests.

Prints one JSON line (and appends it to ``--out``).  Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CALLS = 100_000
LOOPS = 5
MODES = ("off", "off_synced", "profiled", "profiled_bare")
TOP = 16


def off_span_us(trace) -> float:
    """Host microseconds of one ``with trace.span(...)`` with no profiler
    recording, the least of LOOPS loops."""
    best = float("inf")
    for _ in range(LOOPS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            with trace.span("hhe.cost"):
                pass
        best = min(best, (time.perf_counter() - t0) / CALLS * 1e6)
    return best


def program_gaps(tr, requests: int) -> dict:
    """Seconds a request of the window's idle gaps: by the benchmark's own
    label (its span: the innermost host operation open at the gap's start),
    by that label with the chain of program spans open at the gap's start,
    and by the chain of program spans open over each part of the gap
    (outermost first; the time a gap spends under each innermost span)."""
    from hhe_bench.trace import gaps, union

    spans = sorted((s, e, n) for s, e, n in tr.host if n.startswith("hhe."))
    at_start, over_time = collections.Counter(), collections.Counter()

    def chain(a, b):
        return " > ".join(n for s, e, n in spans if s <= a and b <= e) or "(no program span)"

    labels = iter(_labels(tr))
    for gs, ge in gaps(union(tr.busy + tr.paused), tr.start, tr.end):
        at_start[f"{next(labels)} @ {chain(gs, gs)}"] += (ge - gs) / 1e9 / requests
        cuts = sorted({gs, ge} | {t for s, e, _ in spans for t in (s, e) if gs < t < ge})
        for a, b in zip(cuts, cuts[1:]):
            over_time[chain(a, b)] += (b - a) / 1e9 / requests
    return {"by_label": [[n, v / requests] for n, v in tr.idle_gaps()],
            "by_label_at_start": at_start.most_common(TOP),
            "by_program_span_over_time": over_time.most_common(TOP)}


def _labels(tr):
    """Each gap's label as ``Trace.idle_gaps`` gives it, in order."""
    import bisect

    from hhe_bench.trace import SPANS, gaps, union

    ops = sorted(h for h in tr.host if h[2] not in SPANS)
    starts = [h[0] for h in ops]
    outer = sorted((s, e, n) for n in ("fetch", "decompose", "eval") for s, e in tr.spans.get(n, ()))
    outer_starts = [s for s, _, _ in outer]
    for gs, _ in gaps(union(tr.busy + tr.paused), tr.start, tr.end):
        j = bisect.bisect_right(outer_starts, gs) - 1
        span = outer[j][2] if j >= 0 and outer[j][1] >= gs else "between requests"
        i = bisect.bisect_right(starts, gs)
        inner = next((n for s, e, n in reversed(ops[max(0, i - 64):i]) if e >= gs), "host code")
        yield f"{span}: {inner}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from hhe_bench import harness
    from hhe_bench.trace import Trace
    from hhe_tpu_torch.utils import trace

    loaded = harness.load_cell(args.workload)
    h = harness.Harness(loaded, args.seed, "cuda")
    entry = importlib.import_module(f"hhe_bench.entries.{h.config['entry']}").Entry(h)
    count = harness.WARMUP + 1 + args.rounds * len(MODES) * args.requests
    pool = harness.Pool(h, count, int(h.rng.integers(0, harness.NONCE_SPACE)))
    nullspan = lambda name: contextlib.nullcontext()  # noqa: E731

    def request(span, sync_layers):
        _, nonce, sym = pool.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        entry.request(nonce, sym, span, sync_layers)
        return time.perf_counter() - t0

    for _ in range(harness.WARMUP):
        request(nullspan, False)

    calls = collections.Counter()
    real_span = trace.span

    def counting(name):
        calls[name] += 1
        return real_span(name)

    trace.span = counting
    request(nullspan, False)
    trace.span = real_span

    times = {m: [] for m in MODES}
    last = None
    for _ in range(args.rounds):
        for mode in MODES:
            if mode.startswith("off"):
                times[mode] += [request(nullspan, mode == "off_synced") for _ in range(args.requests)]
                continue
            if mode == "profiled_bare":
                trace.span = lambda name: trace.OFF
            try:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    with record_function("window"):
                        times[mode] += [request(record_function, True) for _ in range(args.requests)]
            finally:
                trace.span = real_span
            if mode == "profiled":
                last = (prof, trace.counts())
    prof, counts = last
    tr = Trace(prof)
    med = {m: statistics.median(v) * 1e3 for m, v in times.items()}
    out = {
        "workload": args.workload, "seed": args.seed, "card": harness.card(),
        "requests_per_mode": len(times["off"]),
        "request_ms_median": med,
        "request_ms_quartiles": {m: [q * 1e3 for q in statistics.quantiles(v, n=4)] for m, v in times.items()},
        "profiler_cost_pct": 100 * (med["profiled"] / med["off_synced"] - 1),
        "spans_cost_profiled_pct": 100 * (med["profiled"] / med["profiled_bare"] - 1),
        "span_calls_per_request": sum(calls.values()), "span_calls": dict(calls.most_common()),
        "off_span_us": off_span_us(trace),
        "counts_per_request": {k: v / args.requests for k, v in sorted(counts.items())},
        "traced_window": {"busy_s": tr.busy_s, "window_s": tr.window_s,
                          **program_gaps(tr, args.requests)},
    }
    out["off_cost_per_request_us"] = out["span_calls_per_request"] * out["off_span_us"]
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    entry.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
