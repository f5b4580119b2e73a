"""The modular elementwise kernel (K5 ``mod_elem``: add / sub / neg and the
three-subtract reduction) and the mod-down kernel (K6 ``mod_down``),
``hhe_tpu_torch/csrc/modarith.cu``, and their plain versions.

On the CPU: ``add_mod_plain`` / ``sub_mod_plain`` / ``neg_mod_plain`` /
``reduce_u32_plain`` against the JAX package's ``add_mod`` / ``sub_mod`` /
``neg_mod`` / ``reduce_u32`` bit for bit at the broadcast pattern and dtype
mix of every site that calls them; the one-call digit decomposition
(``_digits``, ``hoist_digits``) and ``mod_down`` against the JAX package's
on a test context; the launch plans (``mod_kernels.elem_plan`` /
``down_plan``) replayed in numpy u32 with the kernels' arithmetic; CPU
tensors never reaching the kernels; the wrappers' refusals; and every
operand of every site on the test stacks inside [0, 2^31) (and, for sub
and neg, below its row's q), where the kernels' u32 reading and the plain
versions' int64 arithmetic agree.  On a card (``cuda`` marker): each
kernel against its plain version.  Inputs come from numpy seeds; every
comparison is exact (tolerance zero)."""

import collections
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import bfv_eval as jev
from hhe_tpu.ops import modular as jmod
from hhe_tpu.ops import primes as jprimes
from hhe_tpu.ops import rns as jrns
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import bfv_eval as tev
from hhe_tpu_torch.ops import mod_kernels, rns
from hhe_tpu_torch.ops import modular as tmod

N = 256
K = 3
M32 = np.uint64(0xFFFFFFFF)
U31 = 1 << 31


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test worker (the suite runs several on one CPU)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def moduli(k, bits=30, n=N):
    return [int(q) for q in jprimes.ntt_primes(n, bits, k)]


def column(mods):
    return torch.tensor(mods, dtype=torch.int64).reshape(-1, 1)


def residues(rng, shape, q, top=None, dtype=torch.int32):
    """Values below each row's q (below `top` if given, one bound for all),
    with 0 and the bound - 1 planted."""
    bound = np.broadcast_to(np.asarray(q.numpy() if top is None else top, np.uint64), shape)
    v = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % bound).astype(np.int64)
    flat, bflat = v.reshape(-1), np.ascontiguousarray(bound).reshape(-1)
    flat[::7] = 0
    flat[3::11] = bflat[3::11].astype(np.int64) - 1
    return torch.from_numpy(v).to(dtype)


def case(name, rng):
    """(op, a, b, q) at one site's broadcast pattern and dtype mix (b None
    for neg and reduce)."""
    q = column(moduli(K))
    qp = column(moduli(K + 1))
    if name == "add ciphertexts":  # bfv_eval.add / relinearize: [2, B, k, N] + [2, B, k, N]
        return "add", residues(rng, (2, 2, K, N), q), residues(rng, (2, 2, K, N), q), q
    if name == "add_plain":  # [B, k, N] + a plaintext [k, N]
        return "add", residues(rng, (2, K, N), q), residues(rng, (K, N), q), q
    if name == "add finish int64 fix":  # _finish_impl: [B, k, N] + int64 [B, 1, N] (fix < 2^19)
        return "add", residues(rng, (2, K, N), q), residues(rng, (2, 1, N), q, 1 << 19, torch.int64), q
    if name == "add broadcast a":  # _finish_impl: neg(ks[0])[None] [1, k, N] + [B, k, N]
        return "add", residues(rng, (1, K, N), q), residues(rng, (3, K, N), q), q
    if name == "add mod t":  # the round-material recurrence: [8, T] + [8, T] mod t ([1])
        t = torch.tensor([65537], dtype=torch.int64)
        return "add", residues(rng, (8, 128), t), residues(rng, (8, 128), t), t
    if name == "add over q and P":  # a digit chunk's accumulation, int32 over k + 1 moduli
        return "add", residues(rng, (2, 2, K + 1, N), qp), residues(rng, (2, 2, K + 1, N), qp), qp
    if name == "add int64 a":  # an int64 first operand: the output stays int64
        return "add", residues(rng, (2, K, N), q, dtype=torch.int64), residues(rng, (2, K, N), q), q
    if name == "add strided views":  # tree_add_mod's halves: narrowed, non-contiguous
        t = residues(rng, (2, 4, K, N), q)
        return "add", t.narrow(1, 0, 2), t.narrow(1, 2, 2), q
    if name == "add unaligned":  # rows that start off the 16-byte grid
        return "add", residues(rng, (2, K, N + 1), q)[..., 1:], residues(rng, (K, N), q), q
    if name == "sub ciphertexts":  # bfv_eval.sub, the fast floor: [.., k, N] - [.., k, N]
        return "sub", residues(rng, (2, 2, K, N), q), residues(rng, (2, 2, K, N), q), q
    if name == "sub view minus product":  # _bsk_to_q: y[..., :-1, :] (a view) - corr
        y = residues(rng, (2, K + 1, N), qp)
        return "sub", y[..., :-1, :], residues(rng, (2, K, N), q), q
    if name == "sub one modulus":  # _bsk_to_q: [.., 1, N] - [.., 1, N] mod m_sk ([1, 1])
        m = column(moduli(1, 31))
        return "sub", residues(rng, (2, 1, N), m), residues(rng, (2, 1, N), m), m
    if name == "sub keygen":  # payload [kd, k+1, N] - [kd, k+1, N] over q and P
        return "sub", residues(rng, (K, K + 1, N), qp), residues(rng, (K, K + 1, N), qp), qp
    if name == "neg":  # bfv_eval.negate / apply_galois: [2, k, N]
        return "neg", residues(rng, (2, K, N), q), None, q
    if name == "neg view":  # rows [1:] of a [n2, k, N] tensor, a view
        return "neg", residues(rng, (4, K, N), q)[1:], None, q
    if name == "reduce digits":  # _digits: poly[..., s:e, None, :] against q and P [k+1, 1]
        return "reduce", residues(rng, (2, K, N), q)[..., :, None, :], None, qp
    if name == "reduce digits chunk":  # a keyswitch digit chunk: limbs 1..2 only
        return "reduce", residues(rng, (2, K, N), q)[..., 1:3, None, :], None, qp
    if name == "reduce lift mod t":  # Transcipher._expand_round_mats: polys mod t [4, T, 1, N] to q and P
        t = torch.tensor([[65537]], dtype=torch.int64)
        return "reduce", residues(rng, (4, 2, 1, N), t), None, qp
    if name == "reduce to 2^31 - 1":  # any value below 2^31, three subtracts
        return "reduce", residues(rng, (2, 1, N), q, U31), None, q
    if name == "reduce msk alpha":  # _bsk_to_q: alpha [.., 1, N] mod m_sk to every q
        return "reduce", residues(rng, (2, 1, N), column(moduli(1, 31))), None, q
    raise KeyError(name)


CASES = ("add ciphertexts", "add_plain", "add finish int64 fix", "add broadcast a", "add mod t",
         "add over q and P", "add int64 a", "add strided views", "add unaligned", "sub ciphertexts",
         "sub view minus product", "sub one modulus", "sub keygen", "neg", "neg view",
         "reduce digits", "reduce digits chunk", "reduce lift mod t", "reduce to 2^31 - 1",
         "reduce msk alpha")
PLAINS = {"add": tmod.add_mod_plain, "sub": tmod.sub_mod_plain,
          "neg": lambda a, b, q: tmod.neg_mod_plain(a, q),
          "reduce": lambda a, b, q: rns.reduce_u32_plain(a, q)}
DISPATCH = {"add": tmod.add_mod, "sub": tmod.sub_mod, "neg": lambda a, b, q: tmod.neg_mod(a, q),
            "reduce": lambda a, b, q: rns.reduce_u32(a, q)}


def u32(x):
    return (x.numpy().astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax(name):
    """add_mod_plain / sub_mod_plain / neg_mod_plain / reduce_u32_plain equal
    hhe_tpu's add_mod / sub_mod / neg_mod / reduce_u32 on u32 arrays, in a's
    dtype."""
    op, a, b, q = case(name, np.random.default_rng(CASES.index(name)))
    ja, jq = jnp.asarray(u32(a)), jnp.asarray(u32(q))
    if op == "add":
        want = jmod.add_mod(ja, jnp.asarray(u32(b)), jq)
    elif op == "sub":
        want = jmod.sub_mod(ja, jnp.asarray(u32(b)), jq)
    elif op == "neg":
        want = jmod.neg_mod(ja, jq)
    else:
        want = jrns.reduce_u32(ja, jq)
    got = PLAINS[op](a, b, q)
    assert got.dtype == a.dtype
    assert np.array_equal(u32(got), np.asarray(want))


def storage_words(x):
    """x's whole storage as u64 words (u32 bits), and x's offset there."""
    n = x.untyped_storage().nbytes() // x.element_size()
    flat = torch.as_strided(x, (n,), (1,), 0).numpy()
    return flat.astype(np.int64).astype(np.uint64) & M32, x.storage_offset()


def strided(words, base, sizes, strides):
    """The u64 words at base + sum(i_d * strides[d]) over the index grid of `sizes`."""
    idx = np.full(sizes, base, np.int64)
    for d, (n, st) in enumerate(zip(sizes, strides)):
        shape = [1] * len(sizes)
        shape[d] = n
        idx = idx + (np.arange(n) * st).reshape(shape)
    return words[idx]


def u32_elem(op, a, b, q):
    """csrc/modarith.cu mod_elem on u64 arrays of u32 values, wrapping at 2^32."""
    if op == "add":
        s = (a + b) & M32
        return np.where(s >= q, s - q, s)
    if op == "sub":
        return np.where(a >= b, a - b, (a + q - b) & M32)
    if op == "neg":
        return np.where(a == 0, a, (q - a) & M32)
    r = a
    for _ in range(3):
        r = np.where(r >= q, r - q, r)
    return r


def emulate_elem(p: mod_kernels.Plan, op: str, dtype) -> torch.Tensor:
    """What mod_elem_kernel writes for plan `p`: every operand read through
    its strides over the collapsed sizes (a scalar where it has no tensor),
    the op in u32, each word stored at the output's strides (the fan-out,
    dimension 0, at ostrides[0])."""
    vals = []
    for x, scalar, st, _ in p.operands[:3]:
        if x is None:
            vals.append(np.full(p.sizes, scalar, np.uint64))
        else:
            words, base = storage_words(x)
            vals.append(strided(words, base, p.sizes, st))
    res = u32_elem(op, *vals)
    out = np.zeros(int(np.prod(p.shape)), np.uint64)
    out[strided(np.arange(out.size), 0, p.sizes, p.ostrides).reshape(-1)] = res.reshape(-1)
    out = out.reshape(p.shape)
    if dtype == torch.int64:
        return torch.from_numpy(out.astype(np.int64))
    return torch.from_numpy(out.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("name", CASES)
def test_elem_plan_replays_plain(name):
    """K5's layout (collapsed sizes, the fan-out first, strides of 0 for
    broadcast operands, the output's strides) replayed with the kernel's
    u32 arithmetic gives the plain version's bits, in MAX_DIMS dimensions."""
    op, a, b, q = case(name, np.random.default_rng(100 + CASES.index(name)))
    p = mod_kernels.elem_plan(a, 0 if b is None else b, q)
    assert len(p.sizes) == len(p.ostrides) == mod_kernels.MAX_DIMS
    assert p.form == "general" and p.terms == 1 and p.threads in (64, 128, 256)
    for x, _, _, _ in p.operands:  # broadcast operands are never materialised
        assert x is None or any(x is y for y in (a, b, q))
    assert torch.equal(emulate_elem(p, op, a.dtype), PLAINS[op](a, b, q))


@pytest.mark.parametrize("name", ["reduce digits", "reduce digits chunk", "reduce lift mod t",
                                  "reduce msk alpha", "add ciphertexts"])
def test_elem_plan_fans_out_over_the_moduli(name):
    """A reduction of one limb to every modulus walks the moduli in one
    thread (the fan-out, dimension 0: a read once, q varying along it);
    a layout without a broadcast axis has a fan-out of 1."""
    op, a, b, q = case(name, np.random.default_rng(5))
    p = mod_kernels.elem_plan(a, 0 if b is None else b, q)
    st_a, st_q = p.operands[0][2], p.operands[2][2]
    if op == "reduce":
        assert p.sizes[0] == q.shape[0] and st_a[0] == 0 and st_q[0] == 1
    else:
        assert p.sizes[0] == 1
    assert mod_kernels._vector_operands(p) is not None  # rows of N words, 16-byte groups


def emulate_down(p: mod_kernels.DownPlan, c: torch.Tensor) -> torch.Tensor:
    """What mod_down_kernel writes for plan `p`: c read through its leading,
    limb and innermost strides, the P row once, every limb's constants from
    its column strides, the kernel's u32 arithmetic and REDC."""
    words, base = storage_words(c)
    lead = p.lead_sizes
    cst = p.lead_strides
    sizes = (*lead, p.k + 1, p.inner)
    x = strided(words, base, sizes, (*cst, p.limb_stride, p.inner_stride))
    cols = []
    for col, st in zip(p.cols, p.col_strides):
        w, b0 = storage_words(col)
        cols.append(strided(w, b0, (p.k, 1), (st, 0)))
    q, qinv, pm, pinv = cols
    xp = x[..., p.k : p.k + 1, :]
    a1 = u32_elem("reduce", xp, None, q)
    fix = np.where(xp > np.uint64(p.p_half), u32_elem("sub", a1, pm, q), a1)
    d = u32_elem("sub", x[..., : p.k, :], fix, q)
    ab = d * pinv
    lo = ab & M32
    m = (lo * qinv) & M32
    t = (ab >> np.uint64(32)) + ((m * q) >> np.uint64(32)) + (lo != 0).astype(np.uint64)
    out = np.where(t >= q, t - q, t).reshape(p.shape)
    if c.dtype == torch.int64:
        return torch.from_numpy(out.astype(np.int64))
    return torch.from_numpy(out.astype(np.uint32).view(np.int32))


@pytest.fixture(scope="module")
def ctxs():
    """The JAX and port contexts at (N=1024, 13 limbs)."""
    params = dict(n=1024, data_limbs=13, seed=5)
    return jbfv.Context(jbfv.BFVParams(**params)), tbfv.Context(tbfv.BFVParams(**params), device="cpu")


def down_case(name, ctx, rng):
    """(c, the [k, 1] constant columns, p_half) of a mod_down site: a batch
    [2, B, k+1, N], one ciphertext, the BSGS sums, a view's rows of the
    constants (the limb split's), an int64 c, and rows off the 16-byte grid."""
    ec = tev.eval_consts(ctx)
    cols = (ec.q, ec.qi, ec.p_mod_q, ec.p_inv_mont)
    qp = ctx.tb_qp.q
    k, n = ctx.k, ctx.n
    if name == "batch":
        return residues(rng, (2, 3, k + 1, n), qp), cols, ec.p_half
    if name == "one ciphertext":
        return residues(rng, (2, k + 1, n), qp), cols, ec.p_half
    if name == "bsgs sum":
        return residues(rng, (k + 1, n), qp), cols, ec.p_half
    if name == "view rows":  # limbs 4..7 of 13 and P: c [.., 5, N], columns [4:8]
        c = residues(rng, (2, k + 1, n), qp)
        return torch.cat([c[:, 4:8], c[:, -1:]], 1), tuple(x[4:8] for x in cols), ec.p_half
    if name == "int64 c":
        return residues(rng, (2, k + 1, n), qp, dtype=torch.int64), cols, ec.p_half
    if name == "unaligned":
        return residues(rng, (2, k + 1, n + 1), qp)[..., 1:], cols, ec.p_half
    raise KeyError(name)


DOWN_CASES = ("batch", "one ciphertext", "bsgs sum", "view rows", "int64 c", "unaligned")


@pytest.mark.parametrize("name", DOWN_CASES)
def test_down_plan_replays_plain(ctxs, name):
    """K6's layout replayed in numpy u32 equals mod_down_plain's bits (the
    plain version on the same constants), c's dtype kept."""
    ctx = ctxs[1]
    c, cols, p_half = down_case(name, ctx, np.random.default_rng(DOWN_CASES.index(name)))
    p = mod_kernels.down_plan(c, *cols, p_half)
    assert p.shape == (*c.shape[:-2], c.shape[-2] - 1, c.shape[-1])
    assert p.vec == (name != "unaligned")
    assert 1 <= p.zsplit <= p.k
    want = tev.mod_down_plain(c, *cols, p_half)
    assert want.dtype == c.dtype
    assert torch.equal(emulate_down(p, c), want)


def test_down_plan_splits_limbs_for_few_rows(ctxs):
    """One ciphertext's mod-down at N = 16384 gives 2 rows of 16384 words:
    64-thread blocks and the limbs split over the grid's third axis, one
    limb a block (128 blocks of words, FILL_BLOCKS to fill the card); a
    batch of 64 needs neither."""
    ctx = ctxs[1]
    ec = tev.eval_consts(ctx)
    cols = (ec.q, ec.qi, ec.p_mod_q, ec.p_inv_mont)
    one = torch.zeros((2, ctx.k + 1, 16384), dtype=torch.int32)
    p = mod_kernels.down_plan(one, *cols, ec.p_half)
    assert p.threads == 64 and p.zsplit == ctx.k and p.lead_sizes[-1] == 2
    assert 128 * p.zsplit <= mod_kernels.FILL_BLOCKS
    big = torch.zeros((2, 64, ctx.k + 1, 16384), dtype=torch.int32)
    p = mod_kernels.down_plan(big, *cols, ec.p_half)
    assert p.threads == 256 and p.zsplit == 1 and p.lead_sizes[-1] == 128


def test_mod_down_matches_jax(ctxs):
    """bfv_eval.mod_down (on the CPU: mod_down_plain) equals hhe_tpu's
    mod_down on [2, B, k+1, N] and on one polynomial."""
    jc, tc = ctxs
    rng = np.random.default_rng(11)
    for shape in ((2, 2, tc.k + 1, tc.n), (tc.k + 1, tc.n)):
        c = residues(rng, shape, tc.tb_qp.q)
        got = tev.mod_down(tc, c)
        want = jev.mod_down(jc, jnp.asarray(u32(c)))
        assert got.dtype == torch.int32 and np.array_equal(u32(got), np.asarray(want))


def test_digits_one_call_match_jax(ctxs):
    """_digits is one reduce_u32 over [..., d, k+1, N], equal to the stack
    of per-limb reductions it replaces, and hoist_digits equals hhe_tpu's
    (the JAX package stacks per-limb reductions, then the NTT)."""
    jc, tc = ctxs
    rng = np.random.default_rng(12)
    poly = residues(rng, (2, tc.k, tc.n), tc.tb_q.q)
    pq = tc.tb_qp.q
    for start, stop in ((0, tc.k), (4, 8)):
        got = tev._digits(tc, poly, start, stop)
        want = torch.stack([rns.reduce_u32_plain(poly[..., j : j + 1, :], pq)
                            for j in range(start, stop)], dim=-3)
        assert got.shape == (2, stop - start, tc.k + 1, tc.n) and torch.equal(got, want)
    got = tev.hoist_digits(tc, poly)
    want = jev.hoist_digits(jc, jnp.asarray(u32(poly)))
    assert np.array_equal(u32(got), np.asarray(want))


def test_cpu_tensors_take_the_plain_versions(ctxs, monkeypatch):
    """add_mod / sub_mod / neg_mod / reduce_u32 / tree_add_mod / mod_down on
    CPU tensors never reach mod_kernels."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the modular kernels")

    for name in ("_run", "mod_elem", "mod_down"):
        monkeypatch.setattr(mod_kernels, name, refuse)
    rng = np.random.default_rng(7)
    for name in CASES:
        op, a, b, q = case(name, rng)
        assert torch.equal(DISPATCH[op](a, b, q), PLAINS[op](a, b, q))
    q = column(moduli(K))
    t = residues(rng, (2, 5, K, N), q)
    assert torch.equal(tmod.tree_add_mod(t, q, axis=1), tmod.tree_add_mod_plain(t, q, axis=1))
    tc = ctxs[1]
    c = residues(rng, (2, tc.k + 1, tc.n), tc.tb_qp.q)
    ec = tev.eval_consts(tc)
    assert torch.equal(tev.mod_down(tc, c),
                       tev.mod_down_plain(c, ec.q, ec.qi, ec.p_mod_q, ec.p_inv_mont, ec.p_half))


def test_plain_versions_stay_plain(monkeypatch):
    """The NTT stage loop and mont_mac_plain call the plain add / sub and a
    plain tree: on the card they stay plain PyTorch, so a kernel is held
    against a plain version and not against itself."""
    from hhe_tpu_torch.ops import ntt

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version reached a dispatching function")

    for name in ("add_mod", "sub_mod", "neg_mod", "tree_add_mod", "mont_mul", "mont_mac"):
        monkeypatch.setattr(tmod, name, refuse)
    rng = np.random.default_rng(8)
    qs = moduli(K)
    tb = ntt.build_tables(tuple(qs), N, torch.device("cpu"))
    x = residues(rng, (2, K, N), column(qs))
    assert torch.equal(ntt.ntt_inv_plain(ntt.ntt_fwd_plain(x, tb), tb), x)
    qc, qi = column(qs), torch.tensor([int(jmod.mont_constants(m)[0]) for m in qs]).reshape(-1, 1)
    tmod.mont_mac_plain(x[:, None], x[None], qc, qi, 0)


REFUSALS = {
    "cpu tensor": ("add", lambda a, b, q: (a, b, q), ValueError),
    "float a": ("add", lambda a, b, q: (a.float(), b, q), TypeError),
    "int16 b": ("sub", lambda a, b, q: (a, b.to(torch.int16), q), TypeError),
    "shapes that do not broadcast": ("add", lambda a, b, q: (a, b[..., :2], q), ValueError),
    "q beyond u32": ("reduce", lambda a, b, q: (a, 0, 1 << 32), ValueError),
    "negative b": ("add", lambda a, b, q: (a, -1, q), ValueError),
    "a not a tensor": ("neg", lambda a, b, q: (3, 0, q), TypeError),
    "more dimensions than collapse to six": ("add", lambda a, b, q: (
        a.new_zeros((2, 3, 2, 3, 2, 3, 2, K, N)).permute(1, 0, 3, 2, 5, 4, 6, 7, 8), b, q),
        ValueError),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_elem_wrapper_refuses(what):
    """K5's wrappers raise on what the kernel does not take, a CPU tensor
    included; nothing falls back to the plain version."""
    rng = np.random.default_rng(9)
    q = column(moduli(K))
    a, b = residues(rng, (2, K, N), q), residues(rng, (K, N), q)
    op, make, err = REFUSALS[what]
    before = dict(mod_kernels.LAUNCHES)
    with pytest.raises(err):
        mod_kernels.mod_elem(op, *make(a, b, q))
    assert mod_kernels.LAUNCHES == before


DOWN_REFUSALS = {
    "cpu tensor": (lambda c, cols, ph: (c, *cols, ph), ValueError),
    "float c": (lambda c, cols, ph: (c.float(), *cols, ph), TypeError),
    "a constant of another length": (lambda c, cols, ph: (c, cols[0][:-1], *cols[1:], ph), ValueError),
    "a float constant": (lambda c, cols, ph: (c, cols[0], cols[1].double(), *cols[2:], ph), TypeError),
    "a constant as an int": (lambda c, cols, ph: (c, 5, *cols[1:], ph), TypeError),
    "p_half beyond u32": (lambda c, cols, ph: (c, *cols, 1 << 32), ValueError),
    "no data limb": (lambda c, cols, ph: (c[..., -1:, :], *(x[:0] for x in cols), ph), ValueError),
    "more leading dimensions than collapse to four": (lambda c, cols, ph: (
        c.new_zeros((2, 3, 2, 3, 2, c.shape[-2], c.shape[-1])).permute(1, 0, 3, 2, 4, 5, 6),
        *cols, ph), ValueError),
}


@pytest.mark.parametrize("what", sorted(DOWN_REFUSALS))
def test_mod_down_wrapper_refuses(ctxs, what):
    """K6's wrapper raises on what the kernel does not take."""
    ctx = ctxs[1]
    c, cols, p_half = down_case("one ciphertext", ctx, np.random.default_rng(10))
    make, err = DOWN_REFUSALS[what]
    before = dict(mod_kernels.LAUNCHES)
    with pytest.raises(err):
        mod_kernels.mod_down(*make(c, cols, p_half))
    assert mod_kernels.LAUNCHES == before


# ---------------------------------------------------------------------------
# Every operand of every site on the test stacks lies in [0, 2^31)
# ---------------------------------------------------------------------------

SITE_FUNCS = ("add_mod", "sub_mod", "neg_mod", "reduce_u32", "mod_down", "gather_mod", "sum_mod",
              "center_lift")
# where each function lives, and the position of q among its arguments
# for the "below q" check (of the operands a signed read negates)
SITE_HOME = {"reduce_u32": "rns", "center_lift": "rns", "mod_down": "tev"}


def _site():
    """file:line of the first caller outside the modular layer."""
    f = sys._getframe(2)
    while f.f_code.co_filename.endswith(("ops/modular.py", "ops/rns.py")) and \
            f.f_code.co_name in ("_tree_add", "tree_add_mod", "fbc_from_digits"):
        f = f.f_back
    name = f.f_code.co_filename.split("hhe_tpu_torch/")[-1]
    return f"{name}:{f.f_lineno}"


@pytest.fixture(scope="module")
def site_operands():
    """{site: [(function, min, max, dtypes, below q)]} of every call of the
    functions K5 / K6 take on the card (below q: for sub_mod and neg_mod,
    whether each tensor operand lies below its row's q; for a signed
    gather_mod / sum_mod, whether a does; for mod_down, whether each addend
    does; else None), over the port's paths on a (2048, 4) stack:
    device-form keygen, decompose (keystream, finish), the ECG FC with its
    sum, a 2FC chunk (its logits' tree), a multi-class FC with its bias,
    decrypt."""
    from hhe_tpu_torch.ops import helin, pasta, transcipher
    from hhe_tpu_torch.workloads import hhe_inference as wk

    seen = collections.defaultdict(list)
    mp = pytest.MonkeyPatch()
    mods = [tmod, rns, tev, transcipher, wk, tbfv, helin]
    for fname in SITE_FUNCS:
        orig = getattr({"rns": rns, "tev": tev}.get(SITE_HOME.get(fname), tmod), fname)

        def rec(*args, _orig=orig, _fname=fname, **kw):
            ts = [x for x in args if isinstance(x, torch.Tensor) and x.dtype != torch.bool]
            adds = [mod_kernels.addend(x).x for x in kw.get("adds", ())]
            if _fname == "mod_down":
                ts = [args[1]] + adds
            ints = [int(x) for x in args if isinstance(x, int) and not isinstance(x, bool)]
            below = None
            if _fname in ("sub_mod", "neg_mod"):
                *xs, q = args
                below = all(bool(torch.lt(x, q).all()) for x in xs if isinstance(x, torch.Tensor))
            elif _fname in ("gather_mod", "sum_mod") and len(args) > 3 and args[-1] is not None:
                a, q = args[0], args[2 if _fname == "gather_mod" else 1]
                below = bool(torch.lt(a, q).all())
            elif _fname == "mod_down" and adds:
                q = tev.eval_consts(args[0]).q
                below = all(bool(torch.lt(x, q).all()) for x in adds)
            seen[_site()].append((_fname, min([int(t.min()) for t in ts if t.numel()] + ints),
                                  max([int(t.max()) for t in ts if t.numel()] + ints),
                                  tuple(str(t.dtype) for t in ts), below))
            return _orig(*args, **kw)

        for mod in mods:
            if getattr(mod, fname, None) is orig:
                mp.setattr(mod, fname, rec)
    try:
        st = wk.build_stack(tbfv.BFVParams(n=2048, data_limbs=4, seed=11), input_len=128, device="cpu")
        ctx = st.ctx
        ctx.keygen_eval_keys_device(st.sk, [ctx.galois_elt_from_step(1)], include_relin=True, seed=2)
        key = pasta.get_fixed_symmetric_key()
        enc_key = st.tc.encrypt_key(st.pk, key)
        rng = np.random.default_rng(3)
        x = rng.integers(0, 64, (2, transcipher.T))
        sym = pasta.Pasta(key, ctx.t).encrypt(x.astype(np.uint64), nonce=7)
        data = wk.csp_decompose(st, enc_key, sym, nonce=7)
        w = ctx.encrypt(st.pk, ctx.encode(rng.integers(-3, 4, ctx.n)))
        prod = wk.csp_eval_1fc(st, data, tbfv.Ciphertext(w.data[:, None]), do_sum=True)
        ctx.decrypt_batch(st.sk, prod)
        rows = torch.stack([w.data, w.data], dim=1)  # [2, R=2, k, N]
        w2_mont, w2_neg = wk._fc2_scalar_consts(ctx, np.array([[1, -2], [-1, 3]]))
        wk._2fc_chunk(st, data.data, rows, w2_mont, w2_neg)
        bias = ctx.plain_for_add_batch(ctx.encode_batch(rng.integers(0, 5, (2, ctx.n))))
        wk._fc_multi(st, data.data, rows, bias)
    finally:
        mp.undo()
    return seen


def test_every_site_operand_below_2_31(site_operands):
    """On the test stacks every tensor operand (and Python int) that
    add_mod / sub_mod / neg_mod / reduce_u32 / mod_down are given lies in
    [0, 2^31): there the kernels' u32 reading of an int32 or int64 and the
    plain versions' int64 arithmetic agree bit for bit for add and reduce
    (sub and neg also need their operands below q: the test below).  Each
    site of the port's paths is reached."""
    bad = {site: calls for site, calls in site_operands.items()
           if any(lo < 0 or hi >= U31 for _, lo, hi, _, _ in calls)}
    assert not bad
    files = collections.Counter(site.split(":")[0] for site in site_operands)
    for path in ("ops/bfv_eval.py", "ops/transcipher.py", "ops/bfv.py", "workloads/hhe_inference.py"):
        assert files[path] > 0, (path, sorted(site_operands))
    funcs = {fn for calls in site_operands.values() for fn, *_ in calls}
    assert funcs == set(SITE_FUNCS)


def test_sub_neg_operands_below_q(site_operands):
    """On the test stacks sub_mod's a and b and neg_mod's a lie below their
    row's q at every site: there K5's u32 a + q - b and q - a equal the plain
    versions' int64 results (for b > a + q or a > q the plain versions go
    negative where K5 wraps mod 2^32, so [0, 2^31) alone is not enough);
    so do the operands a signed gather or sum negates and K6's addends
    (added as add_mod adds)."""
    fns = ("sub_mod", "neg_mod", "gather_mod", "sum_mod", "mod_down")
    below = {site: [b for fn, *_, b in calls if fn in fns and b is not None]
             for site, calls in site_operands.items()}
    below = {site: flags for site, flags in below.items() if flags}
    assert {fn for calls in site_operands.values() for fn, *_ in calls} >= {"sub_mod", "neg_mod"}
    assert sum(map(len, below.values())) > 0
    assert all(all(flags) for flags in below.values()), \
        {site: flags.count(False) for site, flags in below.items() if not all(flags)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_elem_kernel_matches_plain_on_cuda(name):
    """On a card: K5 equals its plain version at every site's pattern, one
    launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    op, a, b, q = case(name, np.random.default_rng(200 + CASES.index(name)))
    a, q = a.cuda(), q.cuda()
    b = None if b is None else b.cuda()
    want = PLAINS[op](a, b, q)
    before = mod_kernels.LAUNCHES["mod_elem"]
    got = DISPATCH[op](a, b, q)
    torch.cuda.synchronize()
    assert mod_kernels.LAUNCHES["mod_elem"] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", DOWN_CASES)
def test_mod_down_kernel_matches_plain_on_cuda(ctxs, name):
    """On a card: K6 equals the plain mod-down at every site's layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    c, cols, p_half = down_case(name, ctxs[1], np.random.default_rng(300 + DOWN_CASES.index(name)))
    c, cols = c.cuda(), tuple(x.cuda() for x in cols)
    before = mod_kernels.LAUNCHES["mod_down"]
    got = mod_kernels.mod_down(c, *cols, p_half)
    torch.cuda.synchronize()
    assert mod_kernels.LAUNCHES["mod_down"] == before + 1
    assert torch.equal(got, tev.mod_down_plain(c, *cols, p_half))
