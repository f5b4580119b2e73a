"""Host time a request spends on the transcipher's round material: the
program's ``hhe.transcipher.first_rows`` and ``hhe.transcipher.round_constants``
spans of the traced window (SHAKE, the encode, the scaling and their
uploads), summed over the window's requests.  None where the program has
no such span."""

NAMES = ("hhe.transcipher.first_rows", "hhe.transcipher.round_constants")


def read(run):
    if run.trace is None or not run.requests:
        return None
    ns = sum(e - s for s, e, name in run.trace.host if name in NAMES)
    return ns / run.requests / 1e6 if ns else None
