"""Records of all requests completed in the window over the window's
seconds (host clock, the window ending at the last completion)."""


def read(run):
    if not run.requests:
        return None
    return run.requests * run.records_per_request / run.window_s
