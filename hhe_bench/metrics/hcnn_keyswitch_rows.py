"""Ciphertext rows the HCNN key-switches a request (rotations and
relinearisations): the growth of the program's ``heconv.KEYSWITCH_ROWS``
over the traced window, by ``hhe_tpu_torch.utils.trace.counts``, over the
window's requests.  None where the program has no such counter."""

PREFIX = "heconv.KEYSWITCH_ROWS."


def read(run):
    if run.trace is None or not run.requests:
        return None
    try:
        from hhe_tpu_torch.utils import trace
    except ImportError:
        return None
    n = sum(v for k, v in trace.counts().items() if k.startswith(PREFIX))
    return n / run.requests if n else None
