"""Host time a request spends inside the program's
``hhe.csp_eval_cryptonets`` span in the traced window: issuing CryptoNets'
evaluation (on the card the replay of its graph unit: the input copy, the
launch, the output clone), before the request's synchronise.  Against
``eval_ms`` it says whether the host or the card paces a request.  None
where the program has no such span."""

NAME = "hhe.csp_eval_cryptonets"


def read(run):
    if run.trace is None or not run.requests:
        return None
    ns = sum(e - s for s, e, name in run.trace.host if name == NAME)
    return ns / run.requests / 1e6 if ns else None
