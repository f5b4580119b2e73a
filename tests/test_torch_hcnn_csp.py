"""The HCNN on the CSP's path (``he_conv.prepare_hcnn`` / ``csp_eval_hcnn``)
on the CPU at N=2048, 13 limbs and its own 47-bit t, ``conv_plain_t(2048)``:
the model's layers (conv 1->5, 5x5 stride 2 on a 28x28 image, square, conv
5->C2, square, the channel-major flatten, fc -> 10) with 8 second-layer
channels where the model has 50 (each channel is one more row of the same
batched tensors; 50 take three minutes on the CPU), seeded 2-bit weights in
[-2, 1] and an image of levels 0..3, 80% zeros; one evaluation, traced
under ``torch.profiler``, shared by every case:

- every one of the 1024 slots of row 0 of each class equals the plain
  reference's logit (``hhe_bench/reference/hcnn.py``), centred mod t;
- that reference equals ``heconv.hcnn_forward_int``, and at the worst case
  (every pixel 3, every weight -2) Python's integers;
- ``heconv.KEYSWITCH_ROWS`` grows by the rows the specs key-switch;
- the spans ``hhe.csp_eval_hcnn`` and ``hhe.hcnn.*`` appear in the profile,
  nested in the request's, and ``trace.counts()`` gives the counters; in
  it ``heconv.CONTRACTIONS`` grows by the contractions (K4 launches on a
  card) and terms the specs imply.

On a card (``cuda``; it skips without one) at the cell's size, N=16384, 13
limbs, the 47-bit t and the model's 50 second-layer channels: the replays of
``csp_eval_hcnn``'s ``eval_hcnn`` graph unit equal the eager body bit for
bit and credit the counters one eager evaluation grows.  The module imports
no JAX: on a card, ``pytest --noconftest -m cuda``."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hhe_bench.reference import hcnn as ref_hcnn
from hhe_tpu_torch.ops import bfv, heconv, mod_kernels, ntt_kernels
from hhe_tpu_torch.ops.bfv import Ciphertext
from hhe_tpu_torch.utils import graphs, trace
from hhe_tpu_torch.workloads import he_conv
from hhe_tpu_torch.workloads.hhe_inference import HHEStack

N, LIMBS, IMG, C1, C2, CLASSES = 2048, 13, 28, 5, 8, 10


def centred(v, t):
    v = v % t
    return np.where(v > t // 2, v - t, v)


def draw(seed):
    """Seeded 2-bit weights k1, k2, fc and one image [1, 28, 28]."""
    rng = np.random.default_rng(seed)
    k1 = rng.integers(-2, 2, (C1, 1, 5, 5))
    k2 = rng.integers(-2, 2, (C2, C1, 5, 5))
    fc = rng.integers(-2, 2, (CLASSES, C2 * 4 * 4))
    x = rng.integers(0, 4, (1, IMG, IMG)) * (rng.random((1, IMG, IMG)) >= 0.8)
    return k1, k2, fc, x


@pytest.fixture(scope="module")
def hcnn():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ctx = bfv.Context(bfv.BFVParams(n=N, t=he_conv.conv_plain_t(N), data_limbs=LIMBS, seed=5),
                          device="cpu")
        k1, k2, fc, x = draw(51)
        specs = he_conv.hcnn_specs(k1, k2, IMG)
        sk = ctx.keygen_secret()
        pk = ctx.keygen_public(sk)
        rk, gks = ctx.keygen_eval_keys_device(sk, heconv.conv_galois_elts(ctx, specs, IMG),
                                              include_relin=True, seed=5)
        stack = HHEStack(ctx, sk, pk, rk, gks, None)
        model = he_conv.prepare_hcnn(ctx, k1, k2, fc, IMG)
        ct = Ciphertext(ctx.encrypt(pk, ctx.encode(x.reshape(-1))).data[:, None])  # [2, 1, k, N]
        before = dict(heconv.KEYSWITCH_ROWS)
        before_c = dict(heconv.CONTRACTIONS)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = he_conv.csp_eval_hcnn(stack, ct, model)
        counts = trace.counts()
        grew = {k: v - before.get(k, 0) for k, v in heconv.KEYSWITCH_ROWS.items()}
        grew_c = {k: v - before_c.get(k, 0) for k, v in heconv.CONTRACTIONS.items()
                  if v != before_c.get(k, 0)}
        m = ctx.decrypt_batch(sk, out)  # [classes, N] mod t
        slots = ctx.decode_signed_batch(m)[:, : N // 2]
        yield dict(ctx=ctx, specs=specs, weights=(k1, k2, fc), x=x, out=out, slots=slots,
                   prof=prof, counts=counts, grew=grew, grew_c=grew_c)
    finally:
        torch.set_num_threads(threads)


def test_logits_match_the_plain_reference_in_every_slot(hcnn):
    t = hcnn["ctx"].t
    k1, k2, fc = (torch.as_tensor(w) for w in hcnn["weights"])
    want = ref_hcnn.logits(torch.as_tensor(hcnn["x"]), k1, k2, fc).numpy()  # [classes]
    assert tuple(hcnn["out"].data.shape) == (2, CLASSES, LIMBS, N)
    got = np.asarray(hcnn["slots"])
    assert got.shape == (CLASSES, N // 2)
    assert np.array_equal(got, np.broadcast_to(centred(want, t)[:, None], got.shape))


def test_reference_matches_the_integer_model_and_python_integers():
    for seed in (52, 53):
        k1, k2, fc, x = draw(seed)
        want = heconv.hcnn_forward_int(x, k1, k2, fc)
        got = ref_hcnn.logits(*(torch.as_tensor(a) for a in (x, k1, k2, fc)))
        assert np.array_equal(got.numpy(), want)
    # the worst case at the model's widths (50 second-layer channels): every
    # pixel 3, every weight -2, in Python's integers
    a = 25 * 3 * -2  # conv 1 at every position
    b = C1 * 25 * (a * a) * -2  # conv 2
    worst = 50 * 16 * (b * b) * -2
    assert abs(worst) < 5.1e16 < 2**63
    got = ref_hcnn.logits(torch.full((1, IMG, IMG), 3), torch.full((C1, 1, 5, 5), -2),
                          torch.full((50, C1, 5, 5), -2), torch.full((CLASSES, 50 * 16), -2))
    assert got.tolist() == [worst] * CLASSES


def test_keyswitch_rows_follow_the_specs(hcnn):
    spec1, spec2 = hcnn["specs"]
    taps = [s.kernel.shape[2] * s.kernel.shape[3] for s in (spec1, spec2)]
    want = {"conv": (taps[0] - 1) * spec1.in_shape[0] + (taps[1] - 1) * spec2.in_shape[0],
            "square": spec1.kernel.shape[0] + spec2.kernel.shape[0],
            "fc": CLASSES * int(math.log2(N // 2))}
    assert hcnn["grew"] == want
    # at the model's widths and N=16384: 24 + 120 + 5 + 50 + 130 = 329


def test_spans_and_counter_in_the_trace(hcnn):
    events = sorted(((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
                     for ev in hcnn["prof"].profiler.kineto_results.events()
                     if ev.name().startswith("hhe.")), key=lambda e: e[1])
    names = [n for n, _, _ in events]
    (_, s0, e0), = [e for e in events if e[0] == "hhe.csp_eval_hcnn"]
    assert [n for n in names if n.startswith("hhe.hcnn.")] == [
        "hhe.hcnn.conv", "hhe.hcnn.square", "hhe.hcnn.conv", "hhe.hcnn.square", "hhe.hcnn.fc"]
    assert all(s0 <= s and e <= e0 for n, s, e in events if n.startswith("hhe.hcnn."))
    got = {k: v for k, v in hcnn["counts"].items() if k.startswith("heconv.KEYSWITCH_ROWS.")}
    assert got == {f"heconv.KEYSWITCH_ROWS.{k}": v for k, v in hcnn["grew"].items()}
    # one request's contractions: a launch a group of taps (conv) or channels
    # (FC), each summing the group's terms
    spec1, spec2 = hcnn["specs"]
    want = {}
    for stage, count, per in (("conv1", 25, spec1.in_shape[0]), ("conv2", 25, spec2.in_shape[0]),
                              ("fc", C2, 1)):
        want[f"{stage}.launches"] = count // heconv.group_size(count, per)
        want[f"{stage}.terms"] = count * per
    assert want == {"conv1.launches": 1, "conv1.terms": 25, "conv2.launches": 5, "conv2.terms": 125,
                    "fc.launches": 1, "fc.terms": C2}
    assert hcnn["grew_c"] == want
    got = {k: v for k, v in hcnn["counts"].items() if k.startswith("heconv.CONTRACTIONS.")}
    assert got == {f"heconv.CONTRACTIONS.{k}": v for k, v in want.items()}
    # at the model's widths (50 second-layer channels): 1 + 5 + 2 launches,
    # 25 + 125 + 50 terms


def _counts():
    """The launch counters and the HCNN's, by name."""
    named = {"ntt": ntt_kernels.LAUNCHES, "mod": mod_kernels.LAUNCHES,
             "rows": heconv.KEYSWITCH_ROWS, "contractions": heconv.CONTRACTIONS}
    return {(n, k): v for n, c in named.items() for k, v in c.items()}


def _grew(before):
    return {k: v - before.get(k, 0) for k, v in _counts().items() if v != before.get(k, 0)}


@pytest.mark.cuda
def test_eval_hcnn_graph_matches_body_on_cuda():
    """``csp_eval_hcnn`` at the cell's size: its first call captures the
    ``eval_hcnn`` unit; two replays, on other images, equal the eager body
    bit for bit, the first replay's result unchanged by the second, and they
    credit the launch counters and the HCNN's exactly what two eager
    evaluations grow (329 rows key-switched each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, c2 = 16384, 50
    ctx = bfv.Context(bfv.BFVParams(n=n, t=he_conv.conv_plain_t(n), data_limbs=LIMBS, seed=7),
                      device="cuda")
    rng = np.random.default_rng(71)
    k1 = rng.integers(-2, 2, (C1, 1, 5, 5))
    k2 = rng.integers(-2, 2, (c2, C1, 5, 5))
    fc = rng.integers(-2, 2, (CLASSES, c2 * 4 * 4))
    sk = ctx.keygen_secret()
    pk = ctx.keygen_public(sk)
    elts = heconv.conv_galois_elts(ctx, he_conv.hcnn_specs(k1, k2, IMG), IMG)
    rk, gks = ctx.keygen_eval_keys_device(sk, elts, include_relin=True, seed=7)
    stack = HHEStack(ctx, sk, pk, rk, gks, None)
    model = he_conv.prepare_hcnn(ctx, k1, k2, fc, IMG)
    cts = [Ciphertext(ctx.encrypt(pk, ctx.encode(
        rng.integers(0, 4, IMG * IMG) * (rng.random(IMG * IMG) >= 0.8))).data[:, None])
        for _ in range(3)]
    graphs.reset_counts()
    he_conv.csp_eval_hcnn(stack, cts[0], model)  # the body, then the capture
    unit = stack._jit_hcnn
    before = _counts()
    want = [unit.fn(ct.data, model, rk, gks) for ct in cts[1:]]  # two eager evaluations
    eager = _grew(before)
    assert sum(v for (c, _), v in eager.items() if c == "rows") == 2 * 329
    before = _counts()
    got = [he_conv.csp_eval_hcnn(stack, ct, model).data for ct in cts[1:]]  # two replays
    torch.cuda.synchronize()
    assert _grew(before) == eager
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and not torch.equal(got[0], got[1])
    assert graphs.REPLAYS["eval_hcnn"] == 2 and graphs.CAPTURES["eval_hcnn"] == 1
    assert graphs.REPLAYED["eval_hcnn"] == sum(v for (c, _), v in eager.items() if c in ("ntt", "mod"))
