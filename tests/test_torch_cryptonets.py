"""CryptoNets' MNIST network on the CSP's path (``he_conv.prepare_cryptonets``
/ ``csp_eval_cryptonets``) on the CPU at N=2048, 13 limbs and its own 47-bit
t, ``conv_plain_t(2048)``: the network's layers (the 28x28 image padded to
29x29 below and right, conv 1->5 5x5 stride 2, square, the channel-major
flatten, dense 845->hidden, square, dense hidden->10) with 8 hidden neurons
where the network has 100 (each neuron is one more row of the same batched
tensors), seeded weights in [-2, 1] and two images of levels 0..3, 80%
zeros; the evaluations, traced under ``torch.profiler``, shared by the
first cases:

- every one of the 1024 slots of row 0 of each class equals the plain
  reference's logit (``hhe_bench/reference/cryptonets.py``), centred mod t,
  for both images;
- ``heconv.KEYSWITCH_ROWS`` and ``CONTRACTIONS`` grow by what the layers
  imply (the dense layer's rotate-sum: hidden x log2(N/2) rows), and
  ``trace.counts()`` gives them; the spans ``hhe.csp_eval_cryptonets`` and
  ``hhe.hcnn.*`` appear, nested in it.

At the plaintext level (N=2048, 2 limbs): each tap's padded conv
plaintexts decode to that tap's weight on the output slots whose input lies
in the image and 0 where it lies in the pad, and summed over the rotated
image they give ``reference/hcnn.conv`` on the padded image; without a pad,
the HCNN's plaintexts, bit for bit as one mask for every tap gave them.
``he_scalar_fc`` equals the per-class fc2 form ``csp_eval_2fc`` ran before
it took the layer, on rows and on a batch of rows, and at the cells' sizes
takes K4's table form (the rows read once for the ten classes).  The module imports no JAX."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hhe_bench.reference import cryptonets as ref_cryptonets
from hhe_bench.reference import hcnn as ref_hcnn
from hhe_tpu_torch.ops import bfv, heconv, mod_kernels, ntt
from hhe_tpu_torch.ops.bfv import Ciphertext
from hhe_tpu_torch.ops.modular import mont_mul, neg_mod, tree_add_mod
from hhe_tpu_torch.utils import trace
from hhe_tpu_torch.workloads import he_conv
from hhe_tpu_torch.workloads.hhe_inference import HHEStack, _fc2_scalar_consts

N, LIMBS, IMG, C1, HIDDEN, CLASSES = 2048, 13, 28, 5, 8, 10
DENSE_IN = C1 * 13 * 13  # 845


def centred(v, t):
    v = v % t
    return np.where(v > t // 2, v - t, v)


def draw(seed, images=2):
    """Seeded weights k1, dense, out in [-2, 1] and images [images, 1, 28, 28]."""
    rng = np.random.default_rng(seed)
    k1 = rng.integers(-2, 2, (C1, 1, 5, 5))
    dense = rng.integers(-2, 2, (HIDDEN, DENSE_IN))
    out = rng.integers(-2, 2, (CLASSES, HIDDEN))
    x = rng.integers(0, 4, (images, 1, IMG, IMG)) * (rng.random((images, 1, IMG, IMG)) >= 0.8)
    return k1, dense, out, x


@pytest.fixture(scope="module")
def cryptonets():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ctx = bfv.Context(bfv.BFVParams(n=N, t=he_conv.conv_plain_t(N), data_limbs=LIMBS, seed=6),
                          device="cpu")
        k1, dense, out, x = draw(61)
        spec = he_conv.cryptonets_spec(k1, IMG)
        sk = ctx.keygen_secret()
        pk = ctx.keygen_public(sk)
        rk, gks = ctx.keygen_eval_keys_device(sk, heconv.conv_galois_elts(ctx, [spec], IMG),
                                              include_relin=True, seed=6)
        stack = HHEStack(ctx, sk, pk, rk, gks, None)
        model = he_conv.prepare_cryptonets(ctx, k1, dense, out, IMG)
        cts = [Ciphertext(ctx.encrypt(pk, ctx.encode(img.reshape(-1))).data[:, None]) for img in x]
        before = dict(heconv.KEYSWITCH_ROWS)
        before_c = dict(heconv.CONTRACTIONS)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            outs = [he_conv.csp_eval_cryptonets(stack, ct, model) for ct in cts]
        counts = trace.counts()
        grew = {k: v - before.get(k, 0) for k, v in heconv.KEYSWITCH_ROWS.items()
                if v != before.get(k, 0)}
        grew_c = {k: v - before_c.get(k, 0) for k, v in heconv.CONTRACTIONS.items()
                  if v != before_c.get(k, 0)}
        slots = [ctx.decode_signed_batch(ctx.decrypt_batch(sk, o))[:, : N // 2] for o in outs]
        yield dict(ctx=ctx, spec=spec, weights=(k1, dense, out), x=x, outs=outs, slots=slots,
                   prof=prof, counts=counts, grew=grew, grew_c=grew_c)
    finally:
        torch.set_num_threads(threads)


def test_logits_match_the_plain_reference_in_every_slot(cryptonets):
    t = cryptonets["ctx"].t
    k1, dense, out = (torch.as_tensor(w) for w in cryptonets["weights"])
    want = ref_cryptonets.logits(torch.as_tensor(cryptonets["x"]), k1, dense, out).numpy()
    assert want.shape == (2, CLASSES) and not np.array_equal(want[0], want[1])
    for o, got, w in zip(cryptonets["outs"], cryptonets["slots"], want):
        assert tuple(o.data.shape) == (2, CLASSES, LIMBS, N)
        got = np.asarray(got)
        assert got.shape == (CLASSES, N // 2)
        assert np.array_equal(got, np.broadcast_to(centred(w, t)[:, None], got.shape))


def test_counters_and_spans_follow_the_layers(cryptonets):
    images = 2
    assert heconv.conv_out_shape(cryptonets["spec"]) == (C1, 13, 13)
    want = {"conv": 24, "square": C1 + HIDDEN, "dense": HIDDEN * int(math.log2(N // 2))}
    assert cryptonets["grew"] == {k: images * v for k, v in want.items()}
    # at the network's widths and N=16384: 24 + 5 + 100 + 100 x 13 = 1,429
    want_c = {"conv1.launches": 1, "conv1.terms": 25, "dense.launches": 1, "dense.terms": C1,
              "out.launches": 1, "out.terms": HIDDEN}
    assert cryptonets["grew_c"] == {k: images * v for k, v in want_c.items()}
    counts = cryptonets["counts"]
    assert {k: v for k, v in counts.items() if k.startswith("heconv.KEYSWITCH_ROWS.")} == {
        f"heconv.KEYSWITCH_ROWS.{k}": images * v for k, v in want.items()}
    assert {k: v for k, v in counts.items() if k.startswith("heconv.CONTRACTIONS.")} == {
        f"heconv.CONTRACTIONS.{k}": images * v for k, v in want_c.items()}
    events = sorted(((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
                     for ev in cryptonets["prof"].profiler.kineto_results.events()
                     if ev.name().startswith("hhe.")), key=lambda e: e[1])
    outer = [(s, e) for n, s, e in events if n == "hhe.csp_eval_cryptonets"]
    assert len(outer) == images
    layers = ["hhe.hcnn.conv", "hhe.hcnn.square", "hhe.hcnn.fc", "hhe.hcnn.square",
              "hhe.hcnn.scalar_fc"]
    for s0, e0 in outer:
        assert [n for n, s, e in events if n.startswith("hhe.hcnn.") and s0 <= s and e <= e0] == layers


def _decoded(ctx, pts):
    """NTT + Montgomery plaintexts [..., k, N] -> their slot values [..., N/2]
    centred mod t: out of the Montgomery form, the inverse NTT, the
    coefficients (below t) from their residues mod q_0 q_1, then decoded."""
    tb = ctx.tb_q
    polys = ntt.ntt_inv(mont_mul(pts, 1, tb.q, tb.qinv_neg), tb).to(torch.int64).numpy()
    q0, q1 = ctx.q_moduli[:2]
    r0, r1 = polys[..., 0, :].astype(object), polys[..., 1, :].astype(object)
    coef = (r0 + q0 * ((r1 - r0) * pow(q0, -1, q1) % q1)).astype(np.uint64)
    lead = coef.shape[:-1]
    slots = ctx.decode_signed_batch(coef.reshape(-1, ctx.n)).reshape(*lead, ctx.n)
    return slots[..., : ctx.n // 2]


@pytest.fixture(scope="module")
def plain_ctx():
    return bfv.Context(bfv.BFVParams(n=N, t=he_conv.conv_plain_t(N), data_limbs=2, seed=8),
                       device="cpu")


def test_padded_conv_plaintexts_mask_each_tap(plain_ctx):
    ctx = plain_ctx
    k1, _, _, x = draw(62, images=1)
    spec = he_conv.cryptonets_spec(k1, IMG)
    got = _decoded(ctx, heconv.conv_plaintexts(ctx, spec, IMG))  # [taps, 1, C1, N/2]
    out_slots = np.array([(oy * IMG + ox) * 2 for oy in range(13) for ox in range(13)])
    for tap in range(25):
        j, i = divmod(tap, 5)
        inside = np.array([2 * oy + j < IMG and 2 * ox + i < IMG for oy in range(13) for ox in range(13)])
        assert inside.sum() == (12 if j == 4 else 13) * (12 if i == 4 else 13)  # the last taps read the pad
        want = np.zeros((C1, N // 2), np.int64)
        want[:, out_slots[inside]] = k1[:, 0, j, i, None]
        assert np.array_equal(got[tap, 0], want), tap
    # the plaintexts over the rotated image's slots give the reference's conv
    # of the padded image at every output slot, and 0 elsewhere
    flat = np.zeros(N // 2, np.int64)
    flat[: IMG * IMG] = x.reshape(-1)
    conv = sum(got[tap, 0] * np.roll(flat, -off)
               for tap, off in enumerate(heconv.conv_tap_offsets(spec, IMG)))
    padded = torch.zeros((1, IMG + 1, IMG + 1), dtype=torch.int64)
    padded[:, :IMG, :IMG] = torch.as_tensor(x[0])
    want = ref_hcnn.conv(padded, torch.as_tensor(k1), 2).numpy().reshape(C1, -1)
    assert np.array_equal(conv[:, out_slots], want)
    rest = np.ones(N // 2, bool)
    rest[out_slots] = False
    assert not conv[:, rest].any()


def test_unpadded_conv_plaintexts_are_the_hcnns(plain_ctx):
    """Without a pad every tap has the one mask of the output positions:
    the plaintexts are those that one encoded mask gave every tap."""
    ctx = plain_ctx
    rng = np.random.default_rng(63)
    k1 = rng.integers(-2, 2, (C1, 1, 5, 5))
    k2 = rng.integers(-2, 2, (3, C1, 5, 5))
    for spec in he_conv.hcnn_specs(k1, k2, IMG):
        _, oh, ow = heconv.conv_out_shape(spec)
        g = spec.grid_stride * spec.stride
        mask = np.zeros(ctx.n // 2, np.int64)
        mask[[(oy * IMG + ox) * g for oy in range(oh) for ox in range(ow)]] = 1
        enc = ctx.encode(mask).data[None]
        co, ci, kh, kw = spec.kernel.shape
        want = torch.stack([heconv._plain_for_mul(ctx, heconv._weighted_polys(
            ctx, enc, np.asarray(spec.kernel)[:, :, j, i].T.reshape(-1, 1))).reshape(ci, co, ctx.k, ctx.n)
            for j in range(kh) for i in range(kw)])
        assert torch.equal(heconv.conv_plaintexts(ctx, spec, IMG), want)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["rows", "batch_of_rows"])
def test_scalar_fc_equals_the_eager_fc2_form(plain_ctx, lead):
    """``he_scalar_fc`` on rows [2, R, k, N] (CryptoNets' last layer) and
    on a batch of them [2, B, R, k, N] (the 2FC's fc2) equals the per-class
    form the 2FC ran before it: a Montgomery |w| product per class, negated
    where w < 0, and a tree sum over the rows; and the integers."""
    ctx = plain_ctx
    tb = ctx.tb_q
    gen = torch.Generator().manual_seed(64)
    rows = (torch.randint(0, 1 << 62, (2, *lead, HIDDEN, ctx.k, ctx.n), generator=gen) % tb.q).to(torch.int32)
    w = np.random.default_rng(64).integers(-300, 300, (CLASSES, HIDDEN))
    model = he_conv.prepare_cryptonets(ctx, np.ones((C1, 1, 5, 5), np.int64),
                                       np.ones((HIDDEN, DENSE_IN), np.int64), w, IMG)
    assert tuple(model.out_mont.shape) == (HIDDEN, CLASSES, ctx.k, 1)
    got = heconv.he_scalar_fc(ctx, Ciphertext(rows), model.out_mont, model.out_neg).data
    mont, neg = _fc2_scalar_consts(ctx, w.T)
    assert torch.equal(model.out_mont, mont) and torch.equal(model.out_neg, neg)
    sq = rows if lead else rows[:, None]  # [2, B, R, k, N]
    want = []
    for c in range(CLASSES):
        term = mont_mul(sq, mont[:, c], tb.q, tb.qinv_neg)
        term = torch.where(neg[:, c], neg_mod(term, tb.q), term)
        want.append(tree_add_mod(term, tb.q, axis=2)[:, :, 0])
    want = torch.stack(want, dim=2)
    want = want if lead else want[:, 0]
    assert got.dtype == rows.dtype and torch.equal(got, want)
    # and the integers: sum_r w[c, r] rows_r mod q_i
    w_b = torch.as_tensor(w)[:, :, None, None]
    want_int = (w_b * rows.unsqueeze(-4).to(torch.int64)).sum(-3) % tb.q
    assert torch.equal(got.to(torch.int64), want_int)


@pytest.mark.parametrize("rows_shape,k", [((2, 100), 13), ((2, 4, 32), 16)], ids=["cryptonets", "mnist_2fc"])
def test_scalar_fc_plans_the_table_form_at_the_cells_size(rows_shape, k):
    """At the cells' sizes (CryptoNets' 100 rows; the 2FC's batch of 4 and
    row chunk of 32) the contraction takes K4's table form: the rows read
    once for the ten classes."""
    meta = dict(device="meta")
    rows = torch.empty((*rows_shape, k, 16384), dtype=torch.int32, **meta)[..., None, :, :]
    w = torch.empty((rows_shape[-1], CLASSES, k, 1), dtype=torch.int64, **meta)
    q = torch.empty((k, 1), dtype=torch.int64, **meta)
    p = mod_kernels.plan(rows, w, q, q, -4)
    assert p.form == "table" and p.order[0] == 0 and p.sizes[0] == CLASSES and p.terms == rows_shape[-1]
    assert mod_kernels.fan_smem(p.form, p.terms, p.sizes[0], p.threads) <= mod_kernels.SMEM_MAX
