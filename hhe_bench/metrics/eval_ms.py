"""Mean of the "eval" spans of the traced window: the model's evaluation
(``csp_eval_1fc`` / ``csp_eval_2fc``) and the synchronise that ends the
request."""


def read(run):
    spans = run.trace.spans.get("eval") if run.trace else None
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) / 1e6
