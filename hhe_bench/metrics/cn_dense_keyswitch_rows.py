"""Ciphertext rows CryptoNets' hidden dense layer key-switches a request:
the rotations of its log-depth rotate-sum, the growth of the program's
``heconv.KEYSWITCH_ROWS.dense`` over the traced window, by
``hhe_tpu_torch.utils.trace.counts``, over the window's requests (hidden x
log2(N/2), 1,300 at 100 neurons and N=16384).  It falls where the neurons
are packed before the rotate-sum.  None where the program has no such
counter."""

NAME = "heconv.KEYSWITCH_ROWS.dense"


def read(run):
    if run.trace is None or not run.requests:
        return None
    try:
        from hhe_tpu_torch.utils import trace
    except ImportError:
        return None
    n = trace.counts().get(NAME, 0)
    return n / run.requests if n else None
