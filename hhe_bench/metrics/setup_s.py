"""Seconds from the start of the process to the start of the window:
imports, kernel builds, keys, inputs, the request pool and the warm-up
requests that capture every graph unit (host clock)."""


def read(run):
    return run.setup_s
