"""``hhe_tpu_torch.utils.trace`` -- the port's spans and window-scoped
counters -- on the CPU, on the ECG request path of the benchmark's
``csp_1fc`` entry (``csp_decompose``, then ``csp_eval_1fc`` without the
sum) at N=2048 / 4 limbs, with the graph units under the stand-in capture
backend of ``tests/test_torch_graphs.py`` (a replay reruns the body):

- with no profiler recording, ``span`` is one shared no-op object and a
  request leaves ``counts()`` as it was;
- under ``torch.profiler`` (CPU activity) every span of the path appears,
  each a ``cpu_op`` and never a user annotation, nested as the layers are,
  with one SHAKE expansion a block, and no host encode or scaling under
  the round material's spans (the round constants are made on the device);
- ``ntt.UPLOADS`` counts the request's bytes exactly, from the shapes: the
  SHAKE words of every block in one upload, then the records;
- MNIST's seven blocks: one upload of their words, their round constants
  made on the device (``transcipher.RC_BLOCKS``);
- ``counts()`` holds the traced request's counts alone, not a warm-up's;
- the benchmark's readers ``round_material_ms``, ``upload_mb`` and
  ``eager_launch_pct`` read their values from a ``Run`` built on the
  profile through ``hhe_bench.trace.Trace``, and return None on a program
  without spans or counters;
- ``metrics.Timer`` times on the monotonic clock and opens
  ``hhe.party.<name>``."""

import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hhe_bench import harness
from hhe_bench import trace as bench_trace
from hhe_bench.metrics import eager_launch_pct, round_material_ms, upload_mb
from hhe_tpu_torch.ops import bfv, helin, ntt, transcipher
from hhe_tpu_torch.ops.bfv import Ciphertext
from hhe_tpu_torch.utils import graphs, metrics, trace
from hhe_tpu_torch.workloads import hhe_inference as wk
from tests.test_torch_graphs import Rerun, _affine

PARAMS = dict(n=2048, data_limbs=4, seed=11)  # test_torch_graphs.py's stack
RECORDS = 3
NONCES = (2**40 + 101, 2**40 + 102, 2**40 + 103)  # warm-up, traced, untraced: cold SHAKE caches
PATH_SPANS = {
    "hhe.csp_decompose", "hhe.transcipher.first_rows", "hhe.pasta.shake",
    "hhe.transcipher.round_constants", "hhe.upload",
    "hhe.graph.expand", "hhe.graph.keystream", "hhe.graph.finish",
    "hhe.csp_eval_1fc", "hhe.graph.eval_1fc",
    "hhe.eval.multiply", "hhe.eval.square", "hhe.eval.relinearize", "hhe.eval.galois",
}


def inside(spans, inner, outer):
    """(start, end) of each ``inner`` span that lies inside an ``outer`` one."""
    return [(s, e) for n, s, e, _ in spans if n == inner
            and any(os <= s and e <= oe for on, os, oe, _ in spans if on == outer)]


def no_host_encode(spans):
    """No host encode or scaling under the round material's spans."""
    return not any(inside(spans, inner, outer)
                   for inner in ("hhe.bfv.encode", "hhe.bfv.scale")
                   for outer in ("hhe.transcipher.first_rows", "hhe.transcipher.round_constants"))


def _events(prof):
    """(name, start, end, event) of the profile's program spans, by start."""
    return sorted(((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev)
                   for ev in prof.profiler.kineto_results.events() if ev.name().startswith("hhe.")),
                  key=lambda x: x[1])


@pytest.fixture(scope="module")
def ecg():
    """A warm-up request (captures every unit), a traced one and an untraced
    one, with what each left in ``counts()`` and the profile."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    backend, graphs.BACKEND = graphs.BACKEND, Rerun()
    try:
        st = wk.build_stack(bfv.BFVParams(**PARAMS), input_len=transcipher.T, device="cpu",
                            device_keygen=True)
        rng = np.random.default_rng(5)
        enc_key = st.tc.encrypt_key(st.pk, rng.integers(0, st.ctx.t, 256))
        w = rng.integers(-508, 509, transcipher.T)
        wct = Ciphertext(helin.encrypt_weight(st.ctx, st.pk, w[None])[0].data[:, None])

        def request(nonce):
            sym = rng.integers(0, st.ctx.t, (RECORDS, transcipher.T)).astype(np.uint64)
            data = wk.csp_decompose(st, enc_key, sym, nonce=nonce)
            return wk.csp_eval_1fc(st, data, wct, do_sum=False)

        request(NONCES[0])
        with profile(activities=[ProfilerActivity.CPU]) as prof, record_function("window"):
            request(NONCES[1])
        traced = trace.counts()
        offs = [trace.span(name) for name in ("hhe.a", "hhe.b")]
        request(NONCES[2])
        yield dict(prof=prof, traced=traced, offs=offs, after=trace.counts(), ctx=st.ctx,
                   k=st.ctx.k, n=st.ctx.n)
    finally:
        graphs.BACKEND = backend
        torch.set_num_threads(threads)


def test_off_span_is_one_shared_noop_and_a_request_leaves_counts(ecg):
    a, b = ecg["offs"]
    assert a is b is trace.OFF is trace.span("hhe.c")
    with trace.span("hhe.d") as x:
        assert x is None
    assert ecg["after"] == ecg["traced"]


def test_path_spans_are_host_ops_nested_by_layer(ecg):
    spans = _events(ecg["prof"])
    names = {name for name, *_ in spans}
    assert PATH_SPANS <= names, PATH_SPANS - names
    assert not names & set(bench_trace.SPANS)
    for name, _, _, ev in spans:
        assert ev.activity_type() == "cpu_op" and not ev.is_user_annotation(), name
        assert str(NONCES[1]) not in name
    # one SHAKE expansion for the request's one block; the round constants
    # read the first rows' cache entry
    assert [name for name, *_ in spans].count("hhe.pasta.shake") == 1

    assert inside(spans, "hhe.upload", "hhe.transcipher.round_constants")
    assert inside(spans, "hhe.transcipher.round_constants", "hhe.csp_decompose")
    assert inside(spans, "hhe.pasta.shake", "hhe.transcipher.first_rows")
    assert no_host_encode(spans)
    assert inside(spans, "hhe.graph.keystream", "hhe.csp_decompose")
    assert inside(spans, "hhe.graph.eval_1fc", "hhe.csp_eval_1fc")
    assert not inside(spans, "hhe.graph.eval_1fc", "hhe.csp_decompose")


def test_uploads_count_the_request_bytes_exactly(ecg):
    t = transcipher.T
    words, records = 16 * t * 4, RECORDS * t * 4  # first rows and round-constant words
    assert ecg["traced"]["ntt.UPLOADS.bytes"] == words + records
    assert ecg["traced"]["ntt.UPLOADS.calls"] == 2
    assert ecg["traced"]["transcipher.RC_BLOCKS.device"] == 1
    assert "transcipher.RC_BLOCKS.host" not in ecg["traced"]


def test_counts_hold_the_traced_request_alone(ecg):
    got = ecg["traced"]
    assert {k: v for k, v in got.items() if k.startswith("graphs.REPLAYS.")} == {
        "graphs.REPLAYS.expand": 1, "graphs.REPLAYS.keystream": 1,
        "graphs.REPLAYS.finish": 1, "graphs.REPLAYS.eval_1fc": 1}
    assert not any(k.startswith("graphs.CAPTURES.") for k in got)  # the warm-up's
    assert sum(v for k, v in got.items() if k.startswith("pasta.EXPANSIONS.")) == 1


def test_readers_read_the_profile(ecg):
    prof = ecg["prof"]
    run = harness.Run(trace=bench_trace.Trace(prof), requests=1)
    want = sum(e - s for name, s, e, _ in _events(prof)
               if name in ("hhe.transcipher.first_rows", "hhe.transcipher.round_constants"))
    assert want > 0 and round_material_ms.read(run) == pytest.approx(want / 1e6)
    assert upload_mb.read(run) == ecg["traced"]["ntt.UPLOADS.bytes"] / 2**20
    assert eager_launch_pct.read(run) is None  # the CPU launches no K1-K6
    # two requests' share
    run2 = harness.Run(trace=run.trace, requests=2)
    assert round_material_ms.read(run2) == pytest.approx(want / 2e6)


def test_tail_mask_is_a_span_holding_its_upload(ecg):
    """A record longer than a block ends in a masked block: the mask is
    encoded and uploaded on each request (``csp_decompose``)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        helin.make_mask(ecg["ctx"], 16)
    got = trace.counts()
    spans = _events(prof)
    assert [n for n, *_ in spans] == ["hhe.helin.make_mask", "hhe.upload"]
    (_, s0, e0, _), (_, s1, e1, _) = spans
    assert s0 <= s1 and e1 <= e0
    assert got["ntt.UPLOADS.bytes"] == ecg["k"] * ecg["n"] * 4 and got["ntt.UPLOADS.calls"] == 1


def test_eager_launch_pct_reads_replayed_against_eager(monkeypatch):
    monkeypatch.setattr(graphs, "BACKEND", Rerun())
    unit = graphs.jit(_affine, "affine", types.SimpleNamespace())
    x, w = torch.arange(12).reshape(3, 4), torch.ones(3, 4, dtype=torch.int64)
    unit(x, w, 2)  # the capture, before the window
    with profile(activities=[ProfilerActivity.CPU]) as prof, record_function("window"):
        unit(x, w, 2)  # the first replay's span starts the window's counts
        unit(x, w, 2)
        _affine(x, w, 2)  # an eager call: two launches outside a replay
    got = trace.counts()
    assert got["graphs.REPLAYED.affine"] == 4 and got["mod_kernels.LAUNCHES.mont_mul"] == 3
    run = harness.Run(trace=bench_trace.Trace(prof), requests=1)
    assert eager_launch_pct.read(run) == pytest.approx(100 * 2 / 6)
    assert round_material_ms.read(run) is None  # no round material in this window


def test_readers_return_none_without_the_program_counters(ecg, monkeypatch):
    """The parent of this change has no ``utils.trace``: the counter readers
    leave their metric out, as the span reader does on a trace with no
    program span."""
    import hhe_tpu_torch.utils

    monkeypatch.delattr(hhe_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "hhe_tpu_torch.utils.trace", None)
    run = harness.Run(trace=bench_trace.Trace(ecg["prof"]), requests=1)
    assert upload_mb.read(run) is None and eager_launch_pct.read(run) is None
    assert upload_mb.read(harness.Run(trace=None, requests=1)) is None
    assert round_material_ms.read(harness.Run(trace=None, requests=1)) is None


def test_timer_phase_is_a_party_span_on_the_monotonic_clock(monkeypatch):
    timer = metrics.Timer()
    monkeypatch.setattr(metrics, "time", types.SimpleNamespace(perf_counter=time.perf_counter))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("csp"):
            torch.ones(4).sum()
    with timer.phase("csp"):
        pass
    assert [n for n, *_ in _events(prof)] == ["hhe.party.csp"]
    assert timer.phases["csp"] > 0 and set(timer.report_ms()) == {"csp"}


def test_upload_funnel_keeps_dtype_and_bits():
    a = np.array([[0, 1, 2**31, 2**32 - 1]], np.uint64)
    before = dict(ntt.UPLOADS)
    x = ntt.u32_to_torch(a, "cpu")
    assert x.dtype == torch.int32 and ntt.u32_to_numpy(x).tolist() == a.tolist()
    y = ntt.upload(np.arange(6, dtype=np.int64).reshape(2, 3)[:, ::2], "cpu")
    assert y.dtype == torch.int64 and y.tolist() == [[0, 2], [3, 5]]
    assert ntt.UPLOADS["calls"] - before["calls"] == 2
    assert ntt.UPLOADS["bytes"] - before["bytes"] == 16 + 32


def test_mnist_blocks_words_cross_in_one_upload(monkeypatch):
    """(Last in the file: it leaves its own stretch in ``counts()``.)
    MNIST's record of 784 words (7 blocks, the tail masked, flattened)
    at N=1024 / 4 limbs: the 7 blocks' SHAKE words cross in one upload,
    before the records' 7 and the tail mask's; every block's round
    constants are made on the device; no host encode or scaling under the
    round material's spans.  The keystream unit is a stand-in (the host
    side is what is checked; test_torch_transcipher.py holds the seeded
    keystream against the JAX package)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        st = wk.build_stack(bfv.BFVParams(n=1024, data_limbs=4, seed=11), input_len=784,
                            device="cpu", device_keygen=True)
        rng = np.random.default_rng(6)
        enc_key = st.tc.encrypt_key(st.pk, rng.integers(0, st.ctx.t, 256))
        seen = []

        def keystream(key_data, words, keys):
            seen.append(tuple(words.shape))
            return key_data
        monkeypatch.setattr(st.tc, "_jit_keystream_seeded", keystream)
        sym = rng.integers(0, st.ctx.t, (2, 784)).astype(np.uint64)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            wk.csp_decompose(st, enc_key, sym, nonce=2**40 + 104)
        got = trace.counts()
    finally:
        torch.set_num_threads(threads)
    t, k, n = transcipher.T, st.ctx.k, st.ctx.n
    assert seen == [(16, t)] * 7
    assert got["transcipher.RC_BLOCKS.device"] == 7 and "transcipher.RC_BLOCKS.host" not in got
    assert got["pasta.EXPANSIONS.native"] + got.get("pasta.EXPANSIONS.python", 0) == 7
    assert got["ntt.UPLOADS.calls"] == 1 + 7 + 1
    assert got["ntt.UPLOADS.bytes"] == 7 * 16 * t * 4 + 2 * 784 * 4 + k * n * 4
    spans = _events(prof)
    words = inside(spans, "hhe.upload", "hhe.transcipher.round_constants")
    assert len(words) == 1 and words[0][1] < min(s for name, s, *_ in spans
                                                 if name == "hhe.helin.make_mask")
    assert no_host_encode(spans)
