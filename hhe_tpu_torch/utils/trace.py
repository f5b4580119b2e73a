"""Spans and window-scoped counters inside the port, on for exactly as long
as a ``torch.profiler`` session records.

Tracing has no switch of its own: run the CSP (or any caller) under
``torch.profiler.profile`` and the spans appear in its trace; outside one
they cost a flag check each.

- ``span(name)``: a context manager around one step of a layer.  With no
  profiler recording it returns one shared no-op object and allocates
  nothing.  With one recording it opens a FUNCTION-scope record function
  (``torch._C._profiler._RecordFunctionFast``), which the profiler reports
  as a host operation (``cpu_op``) with its start, end and enclosing span.
  It is never a user annotation (``torch.profiler.record_function``): for
  a user annotation the profiler also emits a device-side range from the
  first to the last kernel launched inside it, and a reader of the trace
  that counts device events as device work would then see the card busy
  across the very host gaps the span is there to name.
- Names are fixed strings that start with ``hhe.``; none holds a nonce or a
  shape, so that the trace sums them by name.  Nesting gives each span its
  parent; the entry's span (``hhe.csp_decompose``, ``hhe.csp_eval_1fc``,
  ``hhe.csp_eval_2fc``, ``hhe.csp_eval_hcnn``, ``hhe.csp_eval_cryptonets``)
  gives the request.
- Counters: the port's counter dicts, counted always (a dict increment) in
  their own modules: K1-K6's launch counts (``graphs.COUNTERS``), the
  graph units' replays, captures and replayed launches, the PASTA block
  expansions, the blocks whose round constants were made on the device or
  on the host, the host-to-device uploads, and the HCNN's and CryptoNets'
  key-switched ciphertext rows and contractions by stage.  ``counts()`` gives each one's
  growth over the last traced stretch: from the first span that saw a
  profiler recording to the first span (or ``counts()``) that saw it stop,
  or to now while it records.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

OFF = contextlib.nullcontext()  # the span while no profiler records

_on = False  # a profiler was recording at the last look
_start: Optional[Dict[str, int]] = None  # the counters when tracing last turned on
_end: Optional[Dict[str, int]] = None  # ... and when it last turned off


def span(name: str):
    """A span named ``name`` (see the module) for a ``with`` statement."""
    if not _profiler_enabled():
        if _on:
            _turned(False)
        return OFF
    if not _on:
        _turned(True)
    return _RecordFunctionFast(name)


def _registry() -> Dict[str, dict]:
    """The counter dicts by the names ``counts()`` gives them."""
    from ..ops import heconv, mod_kernels, ntt, ntt_kernels, pasta, transcipher
    from . import graphs

    return {"ntt_kernels.LAUNCHES": ntt_kernels.LAUNCHES,
            "mod_kernels.LAUNCHES": mod_kernels.LAUNCHES,
            "mod_kernels.FORM_LAUNCHES": mod_kernels.FORM_LAUNCHES,
            "mod_kernels.OP_LAUNCHES": mod_kernels.OP_LAUNCHES,
            "mod_kernels.DOWN_LAUNCHES": mod_kernels.DOWN_LAUNCHES,
            "graphs.REPLAYS": graphs.REPLAYS,
            "graphs.CAPTURES": graphs.CAPTURES,
            "graphs.REPLAYED": graphs.REPLAYED,
            "pasta.EXPANSIONS": pasta.EXPANSIONS,
            "transcipher.RC_BLOCKS": transcipher.RC_BLOCKS,
            "ntt.UPLOADS": ntt.UPLOADS,
            "heconv.KEYSWITCH_ROWS": heconv.KEYSWITCH_ROWS,
            "heconv.CONTRACTIONS": heconv.CONTRACTIONS}


def _snapshot() -> Dict[str, int]:
    return {f"{name}.{k}": v for name, d in _registry().items() for k, v in list(d.items())}


def _turned(on: bool):
    global _on, _start, _end
    if on:
        _start, _end = _snapshot(), None
    else:
        _end = _snapshot()
    _on = on


def counts() -> Dict[str, int]:
    """Growth of every registered counter over the last traced stretch, by
    ``<module>.<dict>.<key>`` (``ntt_kernels.LAUNCHES.ntt_fwd``,
    ``ntt.UPLOADS.bytes``); counters that did not move are left out, and
    before any traced stretch the dict is empty."""
    if _on and not _profiler_enabled():
        _turned(False)
    if _start is None:
        return {}
    end = _end if _end is not None else _snapshot()
    return {k: v - _start.get(k, 0) for k, v in end.items() if v != _start.get(k, 0)}
