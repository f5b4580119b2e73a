"""Bytes a request hands from the host to the card through the program's
upload funnel (``ntt.UPLOADS``, read as its growth over the traced window
by ``hhe_tpu_torch.utils.trace.counts``), in MB of 2^20 bytes.  None where
the program has no such counter."""


def read(run):
    if run.trace is None or not run.requests:
        return None
    try:
        from hhe_tpu_torch.utils import trace
    except ImportError:
        return None
    n = trace.counts().get("ntt.UPLOADS.bytes")
    return n / run.requests / 2**20 if n else None
