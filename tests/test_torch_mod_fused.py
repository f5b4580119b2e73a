"""K5's gather, sum and centred lift and K6's addends
(``hhe_tpu_torch/csrc/modarith.cu``): the PyTorch passes around the two
kernels taken into their launches.

On the CPU: each new mode's plain version (``modular.gather_mod_plain`` /
``sum_mod_plain``, ``rns.center_lift_plain``, ``bfv_eval.mod_down_plain``
with addends) against the JAX expressions it replaces -- ``jnp.take`` +
``neg_mod`` + ``jnp.where`` (a galois permutation, the BSGS rotations and
giantsteps), chains of ``add_mod`` (the giantstep sums), BEHZ's two
``jnp.where`` lifts, ``mod_down`` + ``add_mod`` + ``jnp.stack`` (after a
key-switch) -- at every site's layout and dtype mix; ``apply_galois``,
``relinearize``, ``Transcipher._matmul_bsgs`` and
``helin.encrypted_vec_sum_log`` against the JAX package at (N=1024, 13
limbs) and (2048, 4); the launch plans (``mod_kernels.elem_plan`` /
``down_plan``) replayed in numpy u32 with the kernels' arithmetic, a limb
view's rows among them; CPU tensors never reaching the kernels; and the
wrappers' refusals.  Inputs come from numpy seeds; every comparison is
exact (tolerance zero).  On a card, ``chip_smoke.py``'s phase 2 holds each
mode against its plain version."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import bfv_eval as jev
from hhe_tpu.ops import helin as jhelin
from hhe_tpu.ops import modular as jmod
from hhe_tpu.ops import rns as jrns
from hhe_tpu.ops import transcipher as jtr
from hhe_tpu_torch import convert
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import bfv_eval as tev
from hhe_tpu_torch.ops import helin as thelin
from hhe_tpu_torch.ops import mod_kernels
from hhe_tpu_torch.ops import modular as tmod
from hhe_tpu_torch.ops import rns as trns
from hhe_tpu_torch.ops import transcipher as ttr

CPU = torch.device("cpu")
M32 = np.uint64(0xFFFFFFFF)
SIZES = ((1024, 13), (2048, 4))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test worker (the suite runs several on one CPU)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def u32(x):
    return (x.numpy().astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


def same(t, j):
    return np.array_equal(u32(t), np.asarray(j).astype(np.uint32))


def residues(rng, shape, q, dtype=torch.int32):
    """Values below each row's q (q a [.., 1] int64 column or an int), with 0
    and q - 1 planted."""
    bound = np.broadcast_to(np.asarray(q.numpy() if isinstance(q, torch.Tensor) else q, np.uint64), shape)
    v = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % bound).astype(np.int64)
    flat, bflat = v.reshape(-1), np.ascontiguousarray(bound).reshape(-1)
    flat[::7] = 0
    flat[3::11] = bflat[3::11].astype(np.int64) - 1
    return torch.from_numpy(v).to(dtype)


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"n{s[0]}k{s[1]}")
def stacks(request):
    """The JAX and port contexts at (N, k), the relinearisation key and
    the galois keys of the BSGS transcipher and the log-depth vec-sum (made
    by the JAX package, carried to the port), and both transciphers."""
    n, k = request.param
    params = dict(n=n, data_limbs=k, seed=5)
    jc = jbfv.Context(jbfv.BFVParams(**params))
    tc = tbfv.Context(tbfv.BFVParams(**params), device="cpu")
    sk = jc.keygen_secret()
    rk = jc.keygen_relin(sk)
    elts = sorted(set(jtr.galois_elts(jc, True)) | set(jhelin.vec_sum_galois_elts(jc)))
    gks = jc.keygen_galois(sk, elts)
    trk, tgks = convert.kswitch_key(rk, CPU), convert.galois_keys(gks, CPU)
    return dict(jc=jc, tc=tc, rk=rk, gks=gks, trk=trk, tgks=tgks,
                jt=jtr.Transcipher(jc, rk, gks), tt=ttr.Transcipher(tc, trk, tgks))


def both(rng, shape, q):
    """(port int32 tensor, JAX uint32 array) of the same residues."""
    t = residues(rng, shape, q)
    return t, jnp.asarray(u32(t))


# ---------------------------------------------------------------------------
# The four entry points against the JAX package
# ---------------------------------------------------------------------------


def test_apply_galois_matches_jax(stacks):
    """apply_galois (a signed gather of c1, the key-switch, K6 adding the
    permuted c0), with and without ``plus``, one ciphertext and a batch."""
    jc, tc = stacks["jc"], stacks["tc"]
    rng = np.random.default_rng(1)
    for shape in ((2, tc.k, tc.n), (2, 2, tc.k, tc.n)):
        t, j = both(rng, shape, tc.tb_q.q)
        tp, jp = both(rng, shape, tc.tb_q.q)
        for step in (-1, 1, 0):
            g = tc.galois_elt_from_step(step)
            if g not in stacks["gks"]:
                continue
            want = jev.apply_galois(jc, jbfv.Ciphertext(j), g, stacks["gks"][g])
            got = tev.apply_galois(tc, tbfv.Ciphertext(t), g, stacks["tgks"][g])
            assert same(got.data, want.data), (shape, step)
            want = jev.add(jc, jbfv.Ciphertext(jp), want)
            got = tev.apply_galois(tc, tbfv.Ciphertext(t), g, stacks["tgks"][g], plus=tbfv.Ciphertext(tp))
            assert same(got.data, want.data), (shape, step, "plus")


def test_relinearize_matches_jax(stacks):
    """relinearize (K6 adding c0 and c1 to d0 and d1), with ``plus`` and
    with a digit chunk."""
    jc, tc = stacks["jc"], stacks["tc"]
    rng = np.random.default_rng(2)
    for shape in ((3, tc.k, tc.n), (3, 2, tc.k, tc.n)):
        t, j = both(rng, shape, tc.tb_q.q)
        tp, jp = both(rng, (2, *shape[1:]), tc.tb_q.q)
        want = jev.relinearize(jc, jbfv.Ciphertext(j), stacks["rk"])
        assert same(tev.relinearize(tc, tbfv.Ciphertext(t), stacks["trk"]).data, want.data)
        got = tev.relinearize(tc, tbfv.Ciphertext(t), stacks["trk"], digit_chunk=3,
                              plus=tbfv.Ciphertext(tp))
        assert same(got.data, jev.add(jc, jbfv.Ciphertext(jp), want).data)


def test_matmul_bsgs_matches_jax(stacks):
    """Transcipher._matmul_bsgs (K5 gathers and giantstep sums, K6 with the
    iq, p0 and inner_g addends) on random state and round material."""
    jc, tc, jt, tt = stacks["jc"], stacks["tc"], stacks["jt"], stacks["tt"]
    assert tt.use_bsgs and jt.use_bsgs and not jt.use_mxu_galois
    rng = np.random.default_rng(3)
    st, jst = both(rng, (2, tc.k, tc.n), tc.tb_q.q)
    mqp, jmqp = both(rng, (ttr.T, tc.k + 1, tc.n), tc.tb_qp.q)
    got = tt._matmul_bsgs(tbfv.Ciphertext(st), (mqp[:, : tc.k], mqp), tt._keys())
    want = jt._matmul_bsgs(jbfv.Ciphertext(jst), (jmqp[:, : jc.k], jmqp), jt._keys())
    assert same(got.data, want.data)


def test_vec_sum_log_matches_jax(stacks):
    """helin.encrypted_vec_sum_log: each rotation's running sum added in
    its K6 launch."""
    jc, tc = stacks["jc"], stacks["tc"]
    rng = np.random.default_rng(4)
    t, j = both(rng, (2, tc.k, tc.n), tc.tb_q.q)
    got = thelin.encrypted_vec_sum_log(tc, tbfv.Ciphertext(t), stacks["tgks"])
    want = jhelin.encrypted_vec_sum_log(jc, jbfv.Ciphertext(j), stacks["gks"])
    assert same(got.data, want.data)


# ---------------------------------------------------------------------------
# Each plain mode against the JAX expression it replaces, at each site
# ---------------------------------------------------------------------------


def take(x, src):
    return jnp.take(x, jnp.asarray(src), axis=-1)


def test_signed_gather_matches_jax(stacks):
    """gather_mod_plain against jnp.take + neg_mod + jnp.where: a galois
    permutation of one ciphertext's c1 and of a batch's (int32 index, bool
    mask), rot_f0's fan-out and the babystep results (per-row tables), a
    limb view's rows (the view's q)."""
    tc = stacks["tc"]
    rng = np.random.default_rng(5)
    q = tc.tb_q.q
    jq = jnp.asarray(u32(q))
    g = tc.galois_elt_from_step(-1)
    src, sign = tc.galois_perm_device(g)
    assert src.dtype == torch.int32 and sign.dtype == torch.bool
    jsrc, jsign = tc.galois_perm(g)
    for shape in ((tc.k, tc.n), (2, tc.k, tc.n)):
        t, j = both(rng, shape, q)
        want = jnp.where(jnp.asarray(jsign), jmod.neg_mod(take(j, jsrc), jq), take(j, jsrc))
        assert same(tmod.gather_mod_plain(t, src, q, sign), want)
    rows = slice(4, 8) if tc.k > 8 else slice(1, 3)  # a limb view's rows
    view, jview = both(rng, (rows.stop - rows.start, tc.n), q[rows])
    want = jnp.where(jnp.asarray(jsign), jmod.neg_mod(take(jview, jsrc), jnp.asarray(u32(q[rows]))),
                     take(jview, jsrc))
    assert same(tmod.gather_mod_plain(view, src, q[rows], sign), want)
    tt = stacks["tt"]
    srcs = tt.baby_srcs.numpy()
    f0, jf0 = both(rng, (tc.k, tc.n), q)
    want = jax.vmap(take, (None, 0))(jf0, srcs)
    assert same(tmod.gather_mod_plain(f0[None], tt._baby_idx[0]), want)
    b, jb = both(rng, (2, srcs.shape[0] - 1, tc.k + 1, tc.n), tc.tb_qp.q)
    want = jnp.stack([jax.vmap(take)(jb[c], srcs[1:]) for c in range(2)])
    assert same(tmod.gather_mod_plain(b, tt._baby_idx[1]), want)


def test_sums_match_jax(stacks):
    """sum_mod_plain against the JAX package's add_mod chains: the
    giantsteps' signed, gathered inner_g (over q) and the giantstep
    contraction results (over q and P), and a plain axis against
    tree_add_mod."""
    tc, tt = stacks["tc"], stacks["tt"]
    rng = np.random.default_rng(6)
    q, qp = tc.tb_q.q, tc.tb_qp.q
    jq, jqp = jnp.asarray(u32(q)), jnp.asarray(u32(qp))
    csrc, csign = tt.giant_csrc.numpy(), tt.giant_csign.numpy()
    g1 = csrc.shape[0]
    inner, jinner = both(rng, (g1, tc.k, tc.n), q)
    p0 = jax.vmap(take)(jinner, csrc)
    p0 = jnp.where(jnp.asarray(csign)[:, None, :], jmod.neg_mod(p0, jq), p0)
    want = p0[0]
    for g in range(1, g1):
        want = jmod.add_mod(want, p0[g], jq)
    _, csrc_idx, csign_idx = tt._giant_idx
    assert same(tmod.sum_mod_plain(inner, q, 0, csrc_idx, csign_idx), want)
    g01, jg01 = both(rng, (2, g1, tc.k + 1, tc.n), qp)
    nsrc = tt.giant_nsrc.numpy()
    hg = [jax.vmap(take)(jg01[c], nsrc) for c in range(2)]
    want = []
    for c in range(2):
        acc = hg[c][0]
        for g in range(1, g1):
            acc = jmod.add_mod(acc, hg[c][g], jqp)
        want.append(acc)
    assert same(tmod.sum_mod_plain(g01, qp, 1, tt._giant_idx[0]), jnp.stack(want))
    assert same(tmod.sum_mod_plain(g01, qp, 1), jmod.tree_add_mod(jg01, jqp, axis=1)[:, 0])


def test_center_lifts_match_jax(stacks):
    """center_lift_plain against BEHZ's two jnp.where: alpha mod m_sk to
    every q (``_bsk_to_q``) and r mod m_tilde to every Bsk modulus
    (``_to_bsk``), int32 as the port passes them and int64 too."""
    tc = stacks["tc"]
    ec = tev.eval_consts(tc)
    rng = np.random.default_rng(7)
    msk = ec.fbc_b_to_q_msk.c_q[-1:]
    alpha, jalpha = both(rng, (2, 2, 1, tc.n), msk)
    jq = jnp.asarray(u32(ec.q))
    a1 = jrns.reduce_u32(jalpha, jq)
    want = jnp.where(jalpha > ec.msk_half, jmod.sub_mod(a1, jnp.asarray(u32(ec.msk_mod_q)), jq), a1)
    assert same(trns.center_lift_plain(alpha, ec.msk_mod_q, ec.q, ec.msk_half), want)
    mt = tc.m_tilde
    r = residues(rng, (2, 1, tc.n), mt)
    jr = jnp.asarray(u32(r))[..., None, :]
    jbq = jnp.asarray(u32(ec.bq))
    want = jnp.where(jr < np.uint32(mt // 2), jr, jr + (jbq - np.uint32(mt)))
    for dtype in (torch.int32, torch.int64):
        got = trns.center_lift_plain(r.to(dtype)[..., None, :], mt, ec.bq, mt // 2 - 1)
        assert got.dtype == dtype and same(got, want)


def test_mod_down_addends_match_jax(stacks):
    """mod_down_plain with addends against the JAX package's mod_down,
    add_mod and jnp.stack: apply_galois' (a gathered, signed c0 for row 0,
    a running sum for both), relinearize's c0 / c1, the BSGS's inner_g
    (iq + mod_down) and its output (p0 for row 0, strided inner_g rows),
    written into a caller's slice where given."""
    jc, tc = stacks["jc"], stacks["tc"]
    rng = np.random.default_rng(8)
    q, qp = tc.tb_q.q, tc.tb_qp.q
    jq = jnp.asarray(u32(q))
    g = tc.galois_elt_from_step(1)
    src, sign = tc.galois_perm_device(g)
    jsrc, jsign = tc.galois_perm(g)
    c, jcc = both(rng, (2, 2, tc.k + 1, tc.n), qp)
    x, jx = both(rng, (2, 2, tc.k, tc.n), q)
    s, js = both(rng, (2, 2, tc.k, tc.n), q)
    d = jnp.stack([jev.mod_down(jc, jcc[0]), jev.mod_down(jc, jcc[1])])
    perm0 = jnp.where(jnp.asarray(jsign), jmod.neg_mod(take(jx[0], jsrc), jq), take(jx[0], jsrc))
    want = jnp.stack([jmod.add_mod(jmod.add_mod(perm0, d[0], jq), js[0], jq), jmod.add_mod(d[1], js[1], jq)])
    got = tev.mod_down(tc, c, (mod_kernels.Addend(x[:1], src, sign), s))
    assert same(got, want)
    want = jnp.stack([jmod.add_mod(jx[0], d[0], jq), jmod.add_mod(jx[1], d[1], jq)])
    out = torch.empty((3, 2, 2, tc.k, tc.n), dtype=torch.int32)
    assert tev.mod_down(tc, c, (x,), out=out[1]) is out[1] or same(out[1], want)
    assert same(out[1], want)
    inner, jinner = both(rng, (2, 4, tc.k, tc.n), q)
    p0, jp0 = both(rng, (tc.k, tc.n), q)
    c1, jc1 = both(rng, (2, tc.k + 1, tc.n), qp)
    d1 = [jev.mod_down(jc, jc1[i]) for i in range(2)]
    want = jnp.stack([jmod.add_mod(jmod.add_mod(jinner[0, 0], jp0, jq), d1[0], jq),
                      jmod.add_mod(jinner[1, 0], d1[1], jq)])
    assert same(tev.mod_down(tc, c1, (p0[None], inner[:, 0])), want)


# ---------------------------------------------------------------------------
# The launch plans replayed in numpy u32
# ---------------------------------------------------------------------------


def storage_words(x):
    n = x.untyped_storage().nbytes() // x.element_size()
    flat = torch.as_strided(x, (n,), (1,), 0).numpy()
    return flat.astype(np.int64).astype(np.uint64) & M32, x.storage_offset()


def grid_offsets(base, sizes, strides):
    idx = np.full(sizes, base, np.int64)
    for d, (n, st) in enumerate(zip(sizes, strides)):
        shape = [1] * len(sizes)
        shape[d] = n
        idx = idx + (np.arange(n) * st).reshape(shape)
    return idx


def u32_op(op, a, b, q, h=0):
    if op == "add":
        s = (a + b) & M32
        return np.where(s >= q, s - q, s)
    if op == "gather":
        return a
    r = a
    for _ in range(3):
        r = np.where(r >= q, r - q, r)
    if op == "center":
        sub = np.where(r >= b, r - b, (r + q - b) & M32)
        r = np.where(a > np.uint64(h), sub, r)
    return r


def neg_u32(x, q):
    return np.where(x == 0, x, (q - x) & M32)


def emulate_elem(p: mod_kernels.Plan, op: str, dtype) -> torch.Tensor:
    """What mod_elem_kernel writes for plan `p`: each operand read through
    its strides over the collapsed sizes (and the terms' axis, its rstride),
    a through the index times its innermost stride where gathered, negated
    mod q where the mask is set, the terms summed exactly and reduced once,
    else the op in u32; each word stored at the output's strides."""
    terms = p.terms
    sizes = (terms, *p.sizes)

    def vals(o, inner_by=None):
        x, scalar, st, rst = p.operands[o]
        if x is None:
            return np.full(sizes, scalar, np.uint64)
        words, base = storage_words(x)
        if inner_by is None:
            return words[grid_offsets(base, sizes, (rst, *st))]
        off = grid_offsets(base, sizes, (rst, *st[:-1], 0)) + inner_by.astype(np.int64) * st[-1]
        return words[off]

    b, q = vals(1), vals(2)
    idx = vals(4) if p.operands[4][0] is not None else None
    a = vals(0, idx)
    if p.operands[5][0] is not None:
        a = np.where(vals(5) != 0, neg_u32(a, q), a)
    if terms > 1:
        res = (b[0] + a.sum(axis=0)) % q[0]
    else:
        res = u32_op(op, a[0], b[0], q[0], p.operands[3][1])
    out = np.zeros(int(np.prod(p.shape)), np.uint64)
    out[grid_offsets(0, p.sizes, p.ostrides).reshape(-1)] = res.reshape(-1)
    out = out.reshape(p.shape)
    if dtype == torch.int64:
        return torch.from_numpy(out.astype(np.int64))
    return torch.from_numpy(out.astype(np.uint32).view(np.int32))


def elem_cases(tc, tt, rng):
    """{name: (mode, plan arguments, plain call)} at each site's layout."""
    q, qp = tc.tb_q.q, tc.tb_qp.q
    src, sign = tc.galois_perm_device(tc.galois_elt_from_step(-1))
    one = residues(rng, (2, tc.k, tc.n), q)
    bat = residues(rng, (2, 3, tc.k, tc.n), q)
    b = residues(rng, (2, tt.n1 - 1, tc.k + 1, tc.n), qp)
    inner = residues(rng, (2, tt.n2, tc.k, tc.n), q)
    g01 = residues(rng, (2, tt.n2 - 1, tc.k + 1, tc.n), qp)
    ec = tev.eval_consts(tc)
    alpha = residues(rng, (2, 3, 1, tc.n), ec.fbc_b_to_q_msk.c_q[-1:])
    r = residues(rng, (3, 1, 1, tc.n), tc.m_tilde)
    unaligned = residues(rng, (tc.k, tc.n + 1), q)[:, 1:]
    baby, giant = tt._baby_idx, tt._giant_idx
    return {
        "gather c1, one ciphertext": ("gather", (one[1], 0, q, 0, src, sign, None),
                                      lambda: tmod.gather_mod_plain(one[1], src, q, sign)),
        "gather c1, a batch": ("gather", (bat[1], 0, q, 0, src, sign, None),
                               lambda: tmod.gather_mod_plain(bat[1], src, q, sign)),
        "gather, rot_f0": ("gather", (one[0][None], 0, 0, 0, baby[0], None, None),
                           lambda: tmod.gather_mod_plain(one[0][None], baby[0])),
        "gather, babystep results": ("gather", (b, 0, 0, 0, baby[1], None, None),
                                     lambda: tmod.gather_mod_plain(b, baby[1])),
        "gather, a limb view's rows": ("gather", (one[1, 4:8] if tc.k > 8 else one[1, 1:3], 0,
                                                  q[4:8] if tc.k > 8 else q[1:3], 0, src, sign, None),
                                       lambda: tmod.gather_mod_plain(
                                           one[1, 4:8] if tc.k > 8 else one[1, 1:3], src,
                                           q[4:8] if tc.k > 8 else q[1:3], sign)),
        "gather, unaligned": ("gather", (unaligned, 0, q, 0, src, sign, None),
                              lambda: tmod.gather_mod_plain(unaligned, src, q, sign)),
        "sum, signed giantsteps": ("sum", (inner[0, 1:], 0, q, 0, giant[1], giant[2], 0),
                                   lambda: tmod.sum_mod_plain(inner[0, 1:], q, 0, giant[1], giant[2])),
        "sum, giantstep contractions": ("sum", (g01, 0, qp, 0, giant[0], None, 1),
                                        lambda: tmod.sum_mod_plain(g01, qp, 1, giant[0])),
        "sum, a plain axis": ("sum", (g01, 0, qp, 0, None, None, 1),
                              lambda: tmod.sum_mod_plain(g01, qp, 1)),
        "center, alpha to q": ("center", (alpha, ec.msk_mod_q, ec.q, ec.msk_half, None, None, None),
                               lambda: trns.center_lift_plain(alpha, ec.msk_mod_q, ec.q, ec.msk_half)),
        "center, r to Bsk": ("center", (r, tc.m_tilde, ec.bq, tc.m_tilde // 2 - 1, None, None, None),
                             lambda: trns.center_lift_plain(r, tc.m_tilde, ec.bq, tc.m_tilde // 2 - 1)),
    }


@pytest.fixture(scope="module")
def small():
    """A (1024, 13) port context and a transcipher on random keys of the
    right shapes (the index tables need no real keys)."""
    tc = tbfv.Context(tbfv.BFVParams(n=1024, data_limbs=13, seed=5), device="cpu")
    rng = np.random.default_rng(20)
    elts = ttr.galois_elts(tc, True)
    key = tbfv.KSwitchKey(residues(rng, (2, tc.k, tc.k + 1, tc.n), tc.tb_qp.q))
    tt = ttr.Transcipher(tc, key, {g: key for g in elts})
    return tc, tt


ELEM_CASES = ("gather c1, one ciphertext", "gather c1, a batch", "gather, rot_f0",
              "gather, babystep results", "gather, a limb view's rows", "gather, unaligned",
              "sum, signed giantsteps", "sum, giantstep contractions", "sum, a plain axis",
              "center, alpha to q", "center, r to Bsk")


@pytest.mark.parametrize("name", ELEM_CASES)
def test_elem_plan_replays_plain(small, name):
    """K5's plan of each new mode (the fan-out first, an index never merged
    across rows, a sum's terms on their rstrides, the blocks that share the
    fan-out) replayed in numpy u32 equals the plain version."""
    tc, tt = small
    mode, args, plain = elem_cases(tc, tt, np.random.default_rng(ELEM_CASES.index(name)))[name]
    p = mod_kernels.elem_plan(*args)
    assert len(p.sizes) == mod_kernels.MAX_DIMS and 1 <= p.zsplit <= p.sizes[0]
    want = plain()
    assert torch.equal(emulate_elem(p, mode, args[0].dtype), want)
    if mode == "gather" and name != "gather, unaligned":
        assert mod_kernels._vector_operands(p) is not None


def test_gather_fan_out_keeps_the_index(small):
    """A galois permutation of one ciphertext's limbs walks the limbs in
    one thread (the index and mask broadcast over them: read once), split
    over enough blocks to fill the card; rot_f0's fan-out walks the
    rotations with f0 read once."""
    tc, tt = small
    q = tc.tb_q.q
    src, sign = tc.galois_perm_device(tc.galois_elt_from_step(-1))
    x = torch.zeros((tc.k, 16384), dtype=torch.int32)
    s16 = torch.zeros(16384, dtype=torch.int32)
    p = mod_kernels.elem_plan(x, 0, q, 0, s16, torch.zeros(16384, dtype=torch.bool))
    assert p.sizes[0] == tc.k and p.operands[4][2][0] == 0 and p.operands[0][2][0] == 16384
    assert p.threads == 64 and p.zsplit == tc.k
    p = mod_kernels.elem_plan(x[None, :, :1024], 0, 0, 0, tt._baby_idx[0], None)
    assert p.sizes[0] == tt.n1 and p.operands[0][2][0] == 0


def emulate_down(p: mod_kernels.DownPlan, c: torch.Tensor) -> torch.Tensor:
    """What mod_down_kernel writes for plan `p`, addends included: c read
    through its strides, the kernel's u32 arithmetic and REDC, then each
    addend (through its index and mask where gathered) added mod q to the
    leading rows it covers."""
    words, base = storage_words(c)
    lead, k, n = p.lead_sizes, p.k, p.inner
    x = words[grid_offsets(base, (*lead, k + 1, n), (*p.lead_strides, p.limb_stride, p.inner_stride))]
    cols = []
    for col, st in zip(p.cols, p.col_strides):
        w, b0 = storage_words(col)
        cols.append(w[grid_offsets(b0, (k, 1), (st, 0))])
    q, qinv, pm, pinv = cols
    xp = x[..., k : k + 1, :]
    a1 = u32_op("reduce", xp, None, q)
    fix = np.where(xp > np.uint64(p.p_half), np.where(a1 >= pm, a1 - pm, (a1 + q - pm) & M32), a1)
    cv = x[..., :k, :]
    d = np.where(cv >= fix, cv - fix, (cv + q - fix) & M32)
    ab = d * pinv
    lo = ab & M32
    m = (lo * qinv) & M32
    t = (ab >> np.uint64(32)) + ((m * q) >> np.uint64(32)) + (lo != 0).astype(np.uint64)
    out = np.where(t >= q, t - q, t).reshape(-1, k, n)
    for ax, idx, sign, ist, lst, covered, lst_lead in p.adds:
        aw, ab0 = storage_words(ax)
        inner = np.arange(n) if idx is None else idx.numpy().astype(np.int64)
        rows = grid_offsets(ab0, lead, lst_lead).reshape(-1)
        for r in range(covered):
            v = aw[rows[r] + np.arange(k)[:, None] * lst + inner[None, :] * ist]
            if sign is not None:
                v = np.where(sign.numpy()[None, :], neg_u32(v, q), v)
            out[r] = u32_op("add", out[r], v, q)
    out = out.reshape(p.shape)
    if c.dtype == torch.int64:
        return torch.from_numpy(out.astype(np.int64))
    return torch.from_numpy(out.astype(np.uint32).view(np.int32))


def down_cases(tc, rng):
    """{name: (c, columns, addends)} of K6's addend sites."""
    ec = tev.eval_consts(tc)
    cols = (ec.q, ec.qi, ec.p_mod_q, ec.p_inv_mont)
    q, qp = tc.tb_q.q, tc.tb_qp.q
    src, sign = tc.galois_perm_device(tc.galois_elt_from_step(3))
    one, bat = residues(rng, (2, tc.k, tc.n), q), residues(rng, (2, 3, tc.k, tc.n), q)
    inner = residues(rng, (2, 4, tc.k, tc.n), q)
    c1, cb = residues(rng, (2, tc.k + 1, tc.n), qp), residues(rng, (2, 3, tc.k + 1, tc.n), qp)
    view_c = torch.cat([c1[:, 4:8], c1[:, -1:]], 1)
    return {
        "apply_galois, one ciphertext, plus": (c1, cols, (mod_kernels.Addend(one[:1], src, sign), one)),
        "apply_galois, a batch": (cb, cols, (mod_kernels.Addend(bat[:1], src, sign),)),
        "relinearize, a batch, plus": (cb, cols, (bat, bat)),
        "bsgs inner_g": (residues(rng, (2, 4, tc.k + 1, tc.n), qp), cols, (inner,)),
        "bsgs output": (c1, cols, (inner[0, 0][None], inner[:, 0])),
        "a limb view's rows": (view_c, tuple(x[4:8] for x in cols),
                               (mod_kernels.Addend(one[:1, 4:8], src, sign), one[:, 4:8])),
        "int64 c, one row's addend": (c1.long(), cols, (one[1:2],)),
        "unaligned": (residues(rng, (2, tc.k + 1, tc.n + 1), qp)[..., 1:], cols,
                      (residues(rng, (2, tc.k, tc.n + 1), q)[..., 1:],)),
    }


DOWN_CASES = ("apply_galois, one ciphertext, plus", "apply_galois, a batch", "relinearize, a batch, plus",
              "bsgs inner_g", "bsgs output", "a limb view's rows", "int64 c, one row's addend", "unaligned")


@pytest.mark.parametrize("name", DOWN_CASES)
def test_down_plan_with_addends_replays_plain(small, name):
    """K6's plan with addends (c and the addends collapsed together, the
    rows each covers, a gathered one's index and mask) replayed in numpy
    u32 equals mod_down_plain with the same addends."""
    tc, _ = small
    c, cols, adds = down_cases(tc, np.random.default_rng(30 + DOWN_CASES.index(name)))[name]
    ec = tev.eval_consts(tc)
    p = mod_kernels.down_plan(c, *cols, ec.p_half, adds)
    assert len(p.adds) == len(adds) and 1 <= p.zsplit <= p.k
    assert p.vec == (name != "unaligned")
    want = tev.mod_down_plain(c, *cols, ec.p_half, adds=adds)
    assert torch.equal(emulate_down(p, c), want)


# ---------------------------------------------------------------------------
# Routing and refusals
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions(small, monkeypatch):
    """gather_mod / sum_mod / center_lift / mod_down with addends and the
    out= forms of mont_mul / mont_mac / add_mod on CPU tensors never reach
    mod_kernels, and equal their plain versions."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the modular kernels")

    for name in ("_run", "mod_gather", "mod_sum", "mod_center", "mod_down"):
        monkeypatch.setattr(mod_kernels, name, refuse)
    tc, tt = small
    rng = np.random.default_rng(40)
    for name, (_, args, plain) in elem_cases(tc, tt, rng).items():
        a, b, q, half, idx, sign, dim = args
        if name.startswith("gather"):
            got = tmod.gather_mod(a, idx, q if sign is not None else None, sign)
        elif name.startswith("sum"):
            got = tmod.sum_mod(a, q, dim, idx, sign)
        else:
            got = trns.center_lift(a, b, q, half)
        assert torch.equal(got, plain())
    ec = tev.eval_consts(tc)
    for c, cols, adds in down_cases(tc, rng).values():
        if cols[0] is ec.q:
            assert torch.equal(tev.mod_down(tc, c, adds), tev.mod_down_plain(c, *cols, ec.p_half, adds=adds))
    q = tc.tb_q.q
    x, y = residues(rng, (2, tc.k, tc.n), q), residues(rng, (2, tc.k, tc.n), q)
    out = torch.empty((3, 2, tc.k, tc.n), dtype=torch.int32)
    assert tmod.add_mod(x, y, q, out=out[1]) is not None and torch.equal(out[1], tmod.add_mod_plain(x, y, q))
    qi = tc.tb_q.qinv_neg
    tmod.mont_mul(x, y, q, qi, out=out[0])
    assert torch.equal(out[0], tmod.mont_mul_plain(x, y, q, qi))
    tmod.mont_mac(x[:, None], y[None], q, qi, 0, out=out[2])
    assert torch.equal(out[2], tmod.mont_mac_plain(x[:, None], y[None], q, qi, 0))


def refusal_cases(tc):
    q = tc.tb_q.q
    ec = tev.eval_consts(tc)
    cols = (ec.q, ec.qi, ec.p_mod_q, ec.p_inv_mont, ec.p_half)
    x = torch.zeros((2, tc.k, tc.n), dtype=torch.int32)
    c = torch.zeros((2, tc.k + 1, tc.n), dtype=torch.int32)
    src, sign = tc.galois_perm_device(tc.galois_elt_from_step(-1))
    bad = src.clone()
    bad[5] = tc.n
    neg = src.clone()
    neg[0] = -1
    buf = torch.zeros((2, tc.k, 2 * tc.n), dtype=torch.int32)
    return {
        "an index at N": (lambda: mod_kernels.mod_gather(x, bad, q, sign), ValueError, "outside"),
        "a negative index": (lambda: mod_kernels.mod_sum(x, q, 0, neg), ValueError, "outside"),
        "an int64 index": (lambda: mod_kernels.mod_gather(x, src.long()), TypeError, "int32"),
        "an int32 mask": (lambda: mod_kernels.mod_gather(x, src, q, sign.int()), TypeError, "bool"),
        "a signed gather without q": (lambda: mod_kernels.mod_gather(x, src, None, sign), ValueError, "q"),
        "an index of another row length": (lambda: mod_kernels.mod_gather(x, src[:-4]), ValueError,
                                           "index rows"),
        "a gathered addend's index out of range": (lambda: mod_kernels.mod_down(
            c, *cols, adds=(mod_kernels.Addend(x[:1], bad, sign),)), ValueError, "outside"),
        "an addend of the wrong shape": (lambda: mod_kernels.mod_down(c, *cols, adds=(x[..., :-1],)),
                                         ValueError, "does not match"),
        "an addend with more rows": (lambda: mod_kernels.mod_down(
            c, *cols, adds=(torch.zeros((3, tc.k, tc.n), dtype=torch.int32),)), ValueError, "more rows"),
        "three addends": (lambda: mod_kernels.mod_down(c, *cols, adds=(x, x, x)), ValueError, "at most"),
        "a float addend": (lambda: mod_kernels.mod_down(c, *cols, adds=(x.float(),)), TypeError, "int32"),
        "an out slice that is not contiguous": (lambda: mod_kernels.mod_down(c, *cols, out=buf[..., ::2]),
                                                ValueError, "contiguous"),
        "a K5 out slice that is not contiguous": (lambda: mod_kernels.mod_elem(
            "add", x, x, q, out=buf[..., ::2]), ValueError, "contiguous"),
        "an out of another shape": (lambda: mod_kernels.mont_mul(
            x, x, q, tc.tb_q.qinv_neg, out=torch.zeros((tc.k + 1, tc.n), dtype=torch.int32)), ValueError,
            "is not"),
        "a mask without an index": (lambda: mod_kernels.mod_sum(x, q, 0, None, sign), ValueError,
                                    "comes with an index"),
        "a CPU tensor": (lambda: mod_kernels.mod_gather(x, src, q, sign), ValueError, "CUDA"),
        "a center op without its threshold as an int": (lambda: mod_kernels.mod_center(
            x, 1, q, -1), ValueError, "u32"),
    }


REFUSALS = ("an index at N", "a negative index", "an int64 index", "an int32 mask", "a signed gather without q",
            "an index of another row length", "a gathered addend's index out of range",
            "an addend of the wrong shape", "an addend with more rows", "three addends", "a float addend",
            "an out slice that is not contiguous", "a K5 out slice that is not contiguous",
            "an out of another shape", "a mask without an index", "a CPU tensor",
            "a center op without its threshold as an int")


@pytest.mark.parametrize("what", REFUSALS)
def test_wrappers_refuse(small, what):
    """The new modes' wrappers raise on what the kernels do not take -- an
    index outside [0, N), a non-int32 index, a wrong addend, an output
    slice that is not contiguous, a CPU tensor -- and launch nothing;
    nothing falls back to a plain version."""
    tc, _ = small
    call, err, match = refusal_cases(tc)[what]
    before = (dict(mod_kernels.LAUNCHES), dict(mod_kernels.OP_LAUNCHES), dict(mod_kernels.DOWN_LAUNCHES))
    with pytest.raises(err, match=match):
        call()
    assert (mod_kernels.LAUNCHES, mod_kernels.OP_LAUNCHES, mod_kernels.DOWN_LAUNCHES) == before


def test_index_range_checked_once_a_tensor(small, monkeypatch):
    """An index table's range is read back once per tensor and version
    (a device constant is checked at its first use, never inside a graph
    capture), and again after it is written to."""
    tc, _ = small
    reads = []
    orig = torch.aminmax
    monkeypatch.setattr(torch, "aminmax", lambda x: reads.append(1) or orig(x))
    src = torch.arange(tc.n, dtype=torch.int32)
    for _ in range(3):
        mod_kernels._index_in_range(src, tc.n)
    assert len(reads) == 1
    src[0] = 0
    mod_kernels._index_in_range(src, tc.n)
    assert len(reads) == 2
    src[1] = tc.n
    with pytest.raises(ValueError, match="outside"):
        mod_kernels._index_in_range(src, tc.n)


def test_bsgs_and_galois_index_tables_are_int32(small):
    """The galois and BSGS index tables live on the device as int32 (half
    the index bytes of int64), with the views the gathers read kept once."""
    tc, tt = small
    src, sign = tc.galois_perm_device(tc.galois_elt_from_step(-1))
    assert src.dtype == torch.int32 and sign.dtype == torch.bool
    assert tc.galois_perm_device(tc.galois_elt_from_step(-1))[0] is src
    for t in (tt.baby_srcs, tt.giant_nsrc, tt.giant_csrc):
        assert t.dtype == torch.int32
    keys = tt._keys()
    assert keys[4][1:] == tt._baby_idx and keys[5][1:] == tt._giant_idx
    assert tt._keys() is keys
