"""Mean of the "decompose" spans of the traced window: ``csp_decompose``,
ended by a synchronise in the traced run."""


def read(run):
    spans = run.trace.spans.get("decompose") if run.trace else None
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) / 1e6
