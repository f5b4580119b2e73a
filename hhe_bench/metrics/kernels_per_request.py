"""Launches of the port's kernels (K1-K6) a request in the traced window:
the growth of ``ntt_kernels.LAUNCHES`` and ``mod_kernels.LAUNCHES``, which
a graph replay credits with the launches its capture made."""


def read(run):
    if run.trace is None or not run.requests:
        return None
    return run.launches / run.requests
