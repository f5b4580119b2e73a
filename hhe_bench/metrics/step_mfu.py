"""The whole request's share of the card's int32 multiply rate: a fixed
count of int32 multiplies a request (``counts/<cell>.json``, counted once
on the card by the frozen ``ShapeRecorder``: NTT butterflies and Montgomery
products at 3 each) times the requests of the traced window, over the
window's seconds at ``frozen.INT32_MUL_PER_S``."""

import json

from hhe_bench import frozen


def read(run):
    path = run.root / "hhe_bench" / "counts" / f"{run.cell['name']}.json"
    if run.trace is None or not run.requests or not path.exists():
        return None
    mults = json.loads(path.read_text())["int32_mults_per_request"]
    return 100.0 * mults * run.requests / (run.trace.window_s * frozen.INT32_MUL_PER_S)
