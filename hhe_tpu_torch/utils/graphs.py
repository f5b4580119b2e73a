"""The port's ``jax.jit``: a unit of the main path captured once per layout
as a CUDA graph and replayed as one launch.

The JAX package compiles its hot units with ``jax.jit`` into one device
dispatch each: the transcipher's round-material expansion, keystream,
seeded keystream and finish (``hhe_tpu.ops.transcipher``), the 1FC
evaluation (``hhe_tpu.workloads.hhe_inference.csp_eval_1fc``) and the CSP's
per-ciphertext evaluation (``hhe_tpu.parties.csp.CSP._jit_eval``).  Run
eagerly, each is hundreds of small kernels whose host dispatch outlasts
their device time.  The counterpart of a fixed-shape ``jax.jit`` program on
a GPU is a captured CUDA graph: ``jit(fn, name, owner)`` returns a callable
that does this.  The port's units: ``expand``, ``keystream``,
``keystream_seeded`` and ``finish`` (``ops.transcipher.Transcipher``),
``eval_1fc`` (``workloads.hhe_inference.csp_eval_1fc``, which the parties'
CSP runs too), ``eval_hcnn``, the HCNN's whole evaluation of one image
(``workloads.he_conv.csp_eval_hcnn``), and ``eval_cryptonets``, CryptoNets'
(``workloads.he_conv.csp_eval_cryptonets``).

- Arguments.  Every positional argument that is a tensor is an input: its
  values are copied on each call into a static buffer that the graph reads
  (a strided view is fine).  Every other argument -- keys, dicts of keys, a
  ciphertext, a tuple of tables, a model's plaintexts, an int -- is a
  constant that the graph reads by address: it is part of the entry's key
  by identity, and the entry holds it, so that its id is not reused while
  the entry lives.
  ``fn`` returns a tensor or a tuple of two or more tensors.
- Entries.  One per layout: the inputs' shapes, dtypes and device and the
  constants' identities, as a new shape re-traces a ``jax.jit``.  At most
  ``MAX_ENTRIES`` a callable; the least recently used goes, and its graph
  with it.
- First call of a layout.  ``fn`` runs eagerly on the caller's tensors (the
  warm-up: it builds the kernels, sets their attributes and fills the
  wrappers' plan caches) and its result is returned.  Then ``fn`` is
  captured on static copies of the inputs, allocated outside the capture,
  into the owner's pool, in ``thread_local`` capture mode (the CSP serves
  gRPC threads, and other CUDA work may run in the process).  The wrappers
  count the launches they capture, and ``ops.heconv`` the HCNN's (and
  CryptoNets') key-switched rows and contractions (its counters join ``COUNTERS`` at its import): that
  growth of ``COUNTERS`` is taken back out of them and kept with the entry.
- Later calls.  The inputs are copied into the static buffers, the graph
  replays, the kept growth is added to ``COUNTERS`` (so that the launch
  counts of a path are those of an eager run), ``REPLAYS[name]`` counts the
  replay, and the static outputs are returned as clones: the next replay
  rewrites them.
- Memory.  All graphs of one owner (a ``Context``) share one pool.  A pool
  hands the memory one graph frees during its capture to the next capture,
  so one graph's replay may overwrite another's static outputs; each call
  clones its outputs right after its replay, on the same stream, and the
  graphs of one pool must replay in turn on one stream, as every caller of
  the port does (the CSP's handlers hold its device lock and run on the
  default stream).  A pool's memory returns to the card once every graph
  in it is gone.
- Routing.  Inputs on the backend's device type (CUDA) take the graph; a
  CPU tensor runs ``fn`` itself and creates no entry.  A capture or replay
  that fails raises: nothing falls back to the eager body on the card.
- Tracing.  A replay (input copies, replay, output clones) is the span
  ``hhe.graph.<name>``, a layout's first call and capture
  ``hhe.graph.capture.<name>`` (``utils.trace``); ``REPLAYED[name]`` sums
  the launches that replays credit to ``COUNTERS``.

``BACKEND`` does the capture and the replay; the CPU tests put a stand-in
there that reruns ``fn`` on the static buffers.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops import mod_kernels, ntt_kernels
from . import trace

MAX_ENTRIES = 8  # layouts kept per callable
# the counts a replay credits, as the wrappers would have counted its launches
# (``ops.heconv`` and the benchmark's shape recorder append theirs)
COUNTERS: List[dict] = [ntt_kernels.LAUNCHES, mod_kernels.LAUNCHES, mod_kernels.FORM_LAUNCHES,
                        mod_kernels.OP_LAUNCHES, mod_kernels.DOWN_LAUNCHES]
REPLAYS: Dict[str, int] = collections.Counter()  # by unit name
CAPTURES: Dict[str, int] = collections.Counter()
REPLAYED: Dict[str, int] = collections.Counter()  # K1-K6 launches credited by replays, by unit name


class CudaGraphs:
    """Captures with ``torch.cuda.graph`` into a pool shared per owner."""

    device_type = "cuda"

    def new_pool(self):
        return torch.cuda.graph_pool_handle()

    def capture(self, body: Callable[[], Tuple[torch.Tensor, ...]], pool):
        """(graph, static outputs) of ``body`` captured into ``pool``."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            outs = body()
        return graph, outs

    def replay(self, graph):
        graph.replay()


BACKEND = CudaGraphs()


def pool(owner):
    """The graph pool of ``owner`` (a ``Context``), made at first use."""
    handle = getattr(owner, "_graph_pool", None)
    if handle is None:
        handle = owner._graph_pool = BACKEND.new_pool()
    return handle


class Entry:
    """One captured layout: the graph, its static inputs and outputs, the
    constants it reads by address, the counts its capture added to each of
    ``COUNTERS``, the capture's seconds and the replays so far."""

    def __init__(self, graph, static_in, static_out, consts, counted, capture_s):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.consts = consts
        self.counted = counted
        self.capture_s = capture_s
        self.replays = 0

    @property
    def kernels(self) -> int:
        """Launches of the port's kernels inside the graph (``ntt_kernels``'
        and ``mod_kernels``' own counts, not K4's by form or K5's by op)."""
        return sum(self.counted[0].values()) + sum(self.counted[1].values())


def _growth(counters, before) -> List[dict]:
    return [{k: v - b.get(k, 0) for k, v in c.items() if v != b.get(k, 0)}
            for c, b in zip(counters, before)]


def _credit(counters, counted, sign: int = 1):
    for c, d in zip(counters, counted):
        for k, v in d.items():
            c[k] = c.get(k, 0) + sign * v


def _key(args) -> tuple:
    return tuple((tuple(a.shape), a.dtype, a.device) if isinstance(a, torch.Tensor) else id(a)
                 for a in args)


def _tuple(out) -> Tuple[torch.Tensor, ...]:
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


class Jit:
    """``fn`` with its captured layouts (see the module)."""

    def __init__(self, fn: Callable, name: str, owner):
        self.fn = fn
        self.name = name
        self.owner = owner
        self.entries: "collections.OrderedDict[tuple, Entry]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._span = f"hhe.graph.{name}"
        self._capture_span = f"hhe.graph.capture.{name}"

    def __call__(self, *args):
        first = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if first is None or first.device.type != BACKEND.device_type:
            return self.fn(*args)
        key = _key(args)
        with self._lock:
            entry = self.entries.get(key)
            if entry is None:
                with trace.span(self._capture_span):
                    out = self.fn(*args)
                    self._capture(key, args)
                return out
            with trace.span(self._span):
                self.entries.move_to_end(key)
                for buf, a in zip(entry.static_in, (a for a in args if isinstance(a, torch.Tensor))):
                    buf.copy_(a)
                BACKEND.replay(entry.graph)
                _credit(COUNTERS, entry.counted)
                entry.replays += 1
                REPLAYS[self.name] += 1
                REPLAYED[self.name] += entry.kernels
                outs = tuple(o.clone() for o in entry.static_out)
        return outs[0] if len(outs) == 1 else outs

    def _capture(self, key, args):
        static_in = [a.clone(memory_format=torch.contiguous_format)
                     for a in args if isinstance(a, torch.Tensor)]
        it = iter(static_in)
        call_args = tuple(next(it) if isinstance(a, torch.Tensor) else a for a in args)
        counters = list(COUNTERS)
        before = [dict(c) for c in counters]
        t0 = time.perf_counter()
        try:
            graph, outs = BACKEND.capture(lambda: _tuple(self.fn(*call_args)), pool(self.owner))
        finally:  # what the wrappers counted was captured, not launched
            counted = _growth(counters, before)
            _credit(counters, counted, -1)
        consts = [a for a in args if not isinstance(a, torch.Tensor)]
        self.entries[key] = Entry(graph, static_in, outs, consts, counted,
                                  time.perf_counter() - t0)
        CAPTURES[self.name] += 1
        while len(self.entries) > MAX_ENTRIES:
            self.entries.popitem(last=False)

    def entry(self, *args) -> Optional[Entry]:
        """The entry of the layout of ``args``, if captured."""
        return self.entries.get(_key(args))


def jit(fn: Callable, name: str, owner) -> Jit:
    """``fn`` as a unit captured per layout into ``owner``'s graph pool and
    replayed (the module says how); ``name`` keys ``REPLAYS``."""
    return Jit(fn, name, owner)


def reset_counts():
    REPLAYS.clear()
    CAPTURES.clear()
    REPLAYED.clear()
