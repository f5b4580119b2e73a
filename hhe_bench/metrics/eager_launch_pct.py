"""Share of the traced window's K1-K6 launches made eagerly, outside a
graph replay: 100 x (launches - replayed) / launches, both the growth of
the program's counters over the window (``hhe_tpu_torch.utils.trace.counts``:
``ntt_kernels.LAUNCHES``, ``mod_kernels.LAUNCHES``, and ``graphs.REPLAYED``,
the launches replays credit to them).  None where the program has no such
counter."""

LAUNCHES = ("ntt_kernels.LAUNCHES.", "mod_kernels.LAUNCHES.")


def read(run):
    if run.trace is None:
        return None
    try:
        from hhe_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counts()
    launches = sum(v for k, v in counts.items() if k.startswith(LAUNCHES))
    replayed = sum(v for k, v in counts.items() if k.startswith("graphs.REPLAYED."))
    return 100.0 * (launches - replayed) / launches if launches > 0 else None
