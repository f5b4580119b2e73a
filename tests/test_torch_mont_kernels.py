"""The Montgomery kernels (K3 ``mont_mul`` / ``mont_mul_lazy``, K4
``mont_mac``, ``hhe_tpu_torch/csrc/modarith.cu``) and their plain versions.

On the CPU: the plain versions against the JAX package's ``mont_mul`` /
``mont_mul_lazy`` / ``tree_add_mod(mont_mul(...))`` bit for bit, at the
broadcast pattern of every site that calls them; the kernels' launch layout
(``mod_kernels.plan``) replayed in numpy with the kernel's own arithmetic,
K4's fan-out forms block by block (the shared tile, the fan-out, the
Montgomery or Shoup terms and the one reduction an output word); the form
and fan-out ``plan`` picks at each site; CPU tensors never reaching the
kernels; the wrappers' refusals.  On a card (``cuda`` marker): each kernel
and each K4 form against its plain version at the same sites.
Inputs come from numpy seeds; every comparison is exact (tolerance zero)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.ops import modular as jmod
from hhe_tpu.ops import primes as jprimes
from hhe_tpu_torch.ops import mod_kernels, rns
from hhe_tpu_torch.ops import modular as tmod

N = 256
K = 3  # data limbs: the key-switch sites run over k + 1 moduli (q and P), kd = k digits
M32 = np.uint64(0xFFFFFFFF)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test worker (the suite runs several on one CPU)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def moduli(k, bits=30, n=N):
    return [int(q) for q in jprimes.ntt_primes(n, bits, k)]


def column(mods, axis_from_end=2):
    """q and qinv_neg as int64 columns [k, 1, ...] (1s up to ``axis_from_end``)."""
    shape = (len(mods),) + (1,) * (axis_from_end - 1)
    qi = [int(jmod.mont_constants(q)[0]) for q in mods]
    return (torch.tensor(mods, dtype=torch.int64).reshape(shape),
            torch.tensor(qi, dtype=torch.int64).reshape(shape))


def residues(rng, shape, q_col, lazy=False):
    """int32 residues below each row's q (below 2q if lazy), with 0 and
    q - 1 (2q - 1) planted."""
    top = q_col.numpy().astype(np.uint64) * np.uint64(2 if lazy else 1)
    top = np.broadcast_to(top, shape)
    v = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % top).astype(np.int64)
    flat, tflat = v.reshape(-1), np.ascontiguousarray(top).reshape(-1)
    flat[:: 7] = 0
    flat[3:: 11] = tflat[3:: 11].astype(np.int64) - 1
    return torch.from_numpy(v.astype(np.int32))


def case(name, rng):
    """(a, b, q, qinv_neg, dim, lazy) at one site's broadcast pattern."""
    kd, kp = K, K + 1
    if name in ("mont_mul", "mont_mul_lazy"):  # mod_down's [.., k, N] x [k, 1]
        q, qi = column(moduli(K))
        # a from the lazy range [0, 2q) (a lazy NTT's output) for both forms
        lazy = name == "mont_mul_lazy"
        return residues(rng, (2, K, N), q, True), residues(rng, (K, 1), q), q, qi, None, lazy
    if name == "multiply_plain":  # [2, B, k, N] x [k, N]
        q, qi = column(moduli(K))
        return residues(rng, (2, 3, K, N), q), residues(rng, (K, N), q), q, qi, None, False
    if name == "from_mont":  # Python-int b
        q, qi = column(moduli(K))
        return residues(rng, (2, K, N), q), 1, q, qi, None, False
    if name == "to_bsk_int64":  # int64 a, 31-bit moduli
        q, qi = column(moduli(K + 1, 31))
        return residues(rng, (2, K + 1, N), q).to(torch.int64), residues(rng, (K + 1, 1), q), q, qi, None, False
    if name == "hoisted_ks":  # [B, kd, k+1, N] x [kd, k+1, N], reduce -3
        q, qi = column(moduli(kp))
        return residues(rng, (2, kd, kp, N), q), residues(rng, (kd, kp, N), q), q, qi, -3, False
    if name == "digit_chunk":  # one chunk of digits against a row slice of the key
        q, qi = column(moduli(kp))
        key = residues(rng, (kd, kp, N), q)
        return residues(rng, (2, 2, kp, N), q), key[1:3], q, qi, -3, False
    if name == "bsgs_contract":  # [k+1, kd, N] (a transposed view) x [n1-1, k+1, kd, N], reduce -2
        q, qi = column(moduli(kp), 3)
        fd = residues(rng, (kd, kp, N), q.reshape(kp, 1))
        return fd.transpose(-3, -2), residues(rng, (5, kp, kd, N), q), q, qi, -2, False
    if name == "bsgs_contract_pair":  # the same against the stacked k0/k1 [2, n1-1, k+1, kd, N]
        q, qi = column(moduli(kp), 3)
        fd = residues(rng, (kd, kp, N), q.reshape(kp, 1))
        return fd.transpose(-3, -2), residues(rng, (2, 5, kp, kd, N), q), q, qi, -2, False
    if name in ("ks_pair", "ks_pair_unaligned"):  # [B, kd, k+1, N] x the pair [2, 1, kd, k+1, N]
        q, qi = column(moduli(kp))
        a = residues(rng, (3, kd, kp, N + 1), q)
        a = a[..., 1:] if name == "ks_pair_unaligned" else a[..., :N].contiguous()
        return a, residues(rng, (2, 1, kd, kp, N), q), q, qi, -3, False
    if name == "ks_pair_one":  # one ciphertext's [kd, k+1, N] x the pair [2, kd, k+1, N]
        q, qi = column(moduli(kp))
        return residues(rng, (kd, kp, N), q), residues(rng, (2, kd, kp, N), q), q, qi, -3, False
    if name == "bsgs_giant_pair":  # H0/H1 [2, 1, n1-1, k+1, N] x a view [n2, 1:, k+1, N], reduce 2
        q, qi = column(moduli(kp))
        dqp = residues(rng, (3, 4, kp, N), q)
        h = residues(rng, (3, 2, kp, N), q).transpose(0, 1)  # a transposed view
        return h[:, None], dqp[:, 1:], q, qi, 2, False
    if name in ("bsgs_plain_q", "bsgs_plain_q32"):  # [1, n1, k, N] x [n2, n1, k, N], reduce 1
        q, qi = column(moduli(K))
        n1 = 4 if name == "bsgs_plain_q" else 32  # the path's n1: too many terms to stage
        return residues(rng, (1, n1, K, N), q), residues(rng, (3, n1, K, N), q), q, qi, 1, False
    if name == "bsgs_plain_qp":  # [1, n1-1, k+1, N] x a view [n2, 1:, k+1, N], reduce 1
        q, qi = column(moduli(kp))
        dqp = residues(rng, (3, 4, kp, N), q)
        return residues(rng, (1, 3, kp, N), q), dqp[:, 1:], q, qi, 1, False
    if name in ("fbc", "fbc_q_msk"):  # tmp[..., ka, None, N] x m_mont[ka, kc, None], moduli c_q, reduce -3
        # q -> Bsk (kc > ka), or B -> q ∪ {m_sk} (_bsk_to_q's joined conversion)
        ka, kc = (K, K + 2) if name == "fbc" else (K + 1, K + 1)
        dst = moduli(kc, 31) if name == "fbc" else moduli(K) + moduli(1, 31)
        q, qi = column(dst)
        src = moduli(ka) if name == "fbc" else moduli(ka, 31)  # digits mod q, or mod B's 31-bit primes
        tmp = residues(rng, (4, 16, ka, N), column(src)[0])  # 64 rows: the table form
        m = residues(rng, (ka, kc), q.reshape(1, kc)).to(torch.int64)
        return tmp[..., None, :], m[:, :, None], q, qi, -3, False
    raise KeyError(name)


K3_CASES = ("mont_mul", "mont_mul_lazy", "multiply_plain", "from_mont", "to_bsk_int64")
K4_CASES = ("hoisted_ks", "digit_chunk", "bsgs_contract", "bsgs_plain_q", "bsgs_plain_qp", "fbc",
            "bsgs_contract_pair", "ks_pair", "ks_pair_unaligned", "ks_pair_one", "bsgs_giant_pair",
            "fbc_q_msk", "bsgs_plain_q32")
CASES = K3_CASES + K4_CASES
# the K4 form and fan-out (F, the shared operand's index in (a, b)) plan picks at each site
FORMS = {
    "hoisted_ks": ("fanout", 2, 1), "digit_chunk": ("fanout", 2, 1),
    "bsgs_contract": ("fanout", 5, 0), "bsgs_plain_q": ("fanout", 3, 0),
    "bsgs_plain_qp": ("fanout", 3, 0), "fbc": ("table", K + 2, 0),
    # a batch of 3 against the pair: the pair staged (it requests fewer bytes
    # than the batch staged for the two keys)
    "bsgs_contract_pair": ("fanout", 10, 0), "ks_pair": ("fanout", 3, 1),
    "ks_pair_unaligned": ("fanout", 3, 1), "ks_pair_one": ("fanout", 2, 0),
    "bsgs_giant_pair": ("fanout", 3, 0), "fbc_q_msk": ("table", K + 1, 0),
    "bsgs_plain_q32": ("fanout_regs", 3, 0),
}


def plain(a, b, q, qi, dim, lazy):
    if dim is not None:
        return tmod.mont_mac_plain(a, b, q, qi, dim)
    return (tmod.mont_mul_lazy_plain if lazy else tmod.mont_mul_plain)(a, b, q, qi)


def u32(x):
    if isinstance(x, int):
        return np.uint32(x)
    return (x.numpy().astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax(name):
    """mont_mul_plain / mont_mul_lazy_plain / mont_mac_plain equal
    hhe_tpu.ops.modular's mont_mul / mont_mul_lazy / tree_add_mod(mont_mul)."""
    a, b, q, qi, dim, lazy = case(name, np.random.default_rng(CASES.index(name)))
    ja, jb, jq, jqi = (jnp.asarray(u32(x)) for x in (a, b, q, qi))
    if dim is None:
        want = (jmod.mont_mul_lazy if lazy else jmod.mont_mul)(ja, jb, jq, jqi)
    else:
        want = jnp.take(jmod.tree_add_mod(jmod.mont_mul(ja, jb, jq, jqi), jq, axis=dim), 0, axis=dim)
    got = plain(a, b, q, qi, dim, lazy)
    assert got.dtype == a.dtype
    assert np.array_equal(u32(got), np.asarray(want))


def emulate(p: mod_kernels.Plan, lazy: bool, dtype) -> torch.Tensor:
    """What csrc/modarith.cu computes from a launch plan, in numpy u64 (u32
    bits of every operand): the general form (and K3) by ``emulate_general``,
    K4's fan-out forms by ``emulate_fan``."""
    if p.form == "general":
        acc = emulate_general(p, lazy)
    else:
        assert not lazy
        acc = emulate_fan(p)
    acc = acc.reshape(p.shape)
    if dtype == torch.int64:
        return torch.from_numpy(acc.astype(np.int64))
    return torch.from_numpy(acc.astype(np.uint32).view(np.int32))


def emulate_general(p: mod_kernels.Plan, lazy: bool) -> np.ndarray:
    """Each operand read through its strides, REDC per term, the sum folded
    below 2q after each term, one final reduction unless lazy."""
    size = p.sizes + (p.terms,)
    vals = []
    for x, scalar, st, rst in p.operands:
        if x is None:
            vals.append(np.full(size, scalar, np.uint64))
        else:
            v = torch.as_strided(x, size, st + (rst,), x.storage_offset()).numpy()
            vals.append(v.astype(np.int64).astype(np.uint64) & M32)
    a, b, q, qi = vals
    ab = a * b
    lo = ab & M32
    m = (lo * qi) & M32
    t = (ab >> np.uint64(32)) + ((m * q) >> np.uint64(32)) + (lo != 0).astype(np.uint64)
    q = q[..., 0]
    acc = t[..., 0]
    for d in range(1, p.terms):
        acc = acc + t[..., d]
        acc = np.where(acc >= 2 * q, acc - 2 * q, acc)
    if not lazy:
        acc = np.where(acc >= q, acc - q, acc)
    return acc


def storage_words(x):
    """Operand x's whole storage as u64 words (u32 bits), and its offset there."""
    if x is None:
        return None, 0
    n = x.untyped_storage().nbytes() // x.element_size()
    flat = torch.as_strided(x, (n,), (1,), 0).numpy()
    return flat.astype(np.int64).astype(np.uint64) & M32, x.storage_offset()


def mod_q(x, q):
    """csrc/modarith.cu mod_q: x mod q for u64 x from a double-precision
    quotient (truncated), then corrected."""
    quo = np.floor(x.astype(np.float64) * (1.0 / np.float64(q))).astype(np.uint64)
    r = (x - quo * np.uint64(q)).view(np.int64)
    while (r < 0).any() or (r >= q).any():
        r = np.where(r < 0, r + q, np.where(r >= q, r - q, r))
    return r.astype(np.uint64)


def emulate_fan(p: mod_kernels.Plan) -> np.ndarray:
    """The fan-out kernels block by block, in their order (rows fastest):
    the block's row offsets from dimensions MAX_DIMS - 2 .. 1, its tile of S
    (operand 0) for every term, then for each of the F outputs of dimension
    0 the terms against W (operand 1) summed exactly and reduced once:
    hi(ab) - hi(mq) + q with m = lo(ab) q^-1, the u64 sum reduced by a
    quotient in double precision and its correction (fanout, fanout_regs);
    or Shoup's S w - floor(S w' / 2^32) q in [0, 2q) from w = W mod q and
    w' = floor(w 2^32 / q), the u64 sum reduced by one REDC (table)."""
    sizes, ostr, terms = p.sizes, p.ostrides, p.terms
    F, inner, md = sizes[0], sizes[-1], mod_kernels.MAX_DIMS
    v = 4 if mod_kernels._vector_operands(p) is not None else 1
    tstride = p.threads * v
    tiles, rows = -(-inner // tstride), int(np.prod(sizes[1:-1]))
    words = [storage_words(x) for x, _, _, _ in p.operands]

    def read(o, idx):
        flat, base = words[o]
        if flat is None:
            return np.full(np.shape(idx), p.operands[o][1], np.uint64)
        return flat[base + np.asarray(idx)]

    st = [st for _, _, st, _ in p.operands]
    rst = [r for _, _, _, r in p.operands]
    out = np.zeros(int(np.prod(p.shape)), np.uint64)
    t = np.arange(terms)[:, None]
    for blk in range(rows * tiles):
        row, j0 = blk % rows, (blk // rows) * tstride
        off, ooff, r = [0] * 4, 0, row
        for d in range(md - 2, 0, -1):
            if sizes[d] > 1:
                c, r = r % sizes[d], r // sizes[d]
                off = [o + c * s[d] for o, s in zip(off, st)]
                ooff += c * ostr[d]
        j = np.arange(j0, min(j0 + tstride, inner))[None, :]
        s = read(0, off[0] + j * st[0][-1] + t * rst[0])  # [terms, words]: the staged tile
        for f in range(F):
            q = int(read(2, off[2] + f * st[2][0]))
            qi = int(read(3, off[3] + f * st[3][0]))
            if p.form == "table":  # Shoup terms from w = W mod q, REDC of the u64 sum
                w = read(1, off[1] + f * st[1][0] + t * rst[1]) % np.uint64(q)  # [terms, 1]
                wp = (w << np.uint64(32)) // np.uint64(q)
                term = (s * w - ((s * wp) >> np.uint64(32)) * np.uint64(q)) & M32
                acc = term.sum(axis=0, dtype=np.uint64)
                m = (acc * np.uint64(qi)) & M32
                res = (acc + m * np.uint64(q)) >> np.uint64(32)
                res = np.where(res >= q, res - np.uint64(q), res)
            else:
                qpos = (-qi) & 0xFFFFFFFF
                wv = read(1, off[1] + f * st[1][0] + j * st[1][-1] + t * rst[1])
                ab = s * wv
                m = ((ab & M32) * np.uint64(qpos)) & M32
                term = (ab >> np.uint64(32)) + np.uint64(q) - ((m * np.uint64(q)) >> np.uint64(32))
                res = mod_q(term.sum(axis=0, dtype=np.uint64), q)
            out[ooff + f * ostr[0] + j[0]] = res
    return out


@pytest.mark.parametrize("name", CASES)
def test_launch_plan_replays_plain(name):
    """The kernels' layout (collapsed sizes, strides of 0 for broadcast
    operands, the reduction's strides) replayed with the kernel's arithmetic
    gives the plain version's bits, in at most MAX_DIMS dimensions; a K4
    layout in its fan-out form and in the general form alike."""
    a, b, q, qi, dim, lazy = case(name, np.random.default_rng(100 + CASES.index(name)))
    want = plain(a, b, q, qi, dim, lazy)
    for fan_out in (True, False) if dim is not None else (True,):
        p = mod_kernels.plan(a, b, q, qi, dim, fan_out)
        assert len(p.sizes) == len(p.ostrides) == mod_kernels.MAX_DIMS
        assert (p.form == "general") == (dim is None or not fan_out)
        for x, _, _, _ in p.operands:  # broadcast operands are never materialised
            assert x is None or any(x is y for y in (a, b, q, qi))
        assert torch.equal(emulate(p, lazy, a.dtype), want)


@pytest.mark.parametrize("name", K4_CASES)
def test_plan_picks_fan_out(name):
    """At each K4 site, plan takes the fan-out form (table where the
    streamed operand is a constant per word row, a base conversion's) over
    the expected axis, with the expected operand staged (kernel operand 0);
    the rows that the streamed operand is broadcast over run fastest."""
    a, b, q, qi, dim, _ = case(name, np.random.default_rng(300 + K4_CASES.index(name)))
    form, fan, shared = FORMS[name]
    p = mod_kernels.plan(a, b, q, qi, dim)
    assert (p.form, p.sizes[0], p.order) == (form, fan, (shared, 1 - shared, 2, 3))
    st_s, st_w = p.operands[0][2], p.operands[1][2]
    assert st_s[0] == 0 and st_w[0] != 0
    rows = [d for d in range(1, mod_kernels.MAX_DIMS - 1) if p.sizes[d] > 1]
    flags = [st_w[d] == 0 for d in rows]
    assert flags == sorted(flags)  # W-broadcast rows last: fastest


def test_launch_shape_by_size():
    """A block's threads leave a launch at least two blocks an SM where the
    output allows (one ciphertext's key-switch pair at N = 16384: 128
    threads, 448 blocks), within 48 KB of shared memory where a fan-out
    allows; the smallest blocks where nothing does (N = 256); a table-form
    launch of fewer than TABLE_MIN_BLOCKS blocks takes the general form."""
    def blocks(p):
        rows = np.prod(p.sizes[1:-1] if p.form != "general" else p.sizes[:-1])
        words = 4 if p.form != "general" else 8
        return rows * -(-p.sizes[-1] // (p.threads * words))

    q, qi = column(moduli(14, n=16384))
    one = torch.zeros((13, 14, 16384), dtype=torch.int32)
    pair = torch.zeros((2, 13, 14, 16384), dtype=torch.int32)
    p = mod_kernels.plan(one, pair, q, qi, -3)
    assert (p.form, p.threads, blocks(p)) == ("fanout", 128, 448)
    assert mod_kernels.fan_smem(p.form, p.terms, p.sizes[0], p.threads) <= mod_kernels.SMEM_BUDGET
    p = mod_kernels.plan(one, pair[0], q, qi, -3)  # one key alone: the general form
    assert (p.form, p.threads, blocks(p)) == ("general", 64, 448)
    p = mod_kernels.plan(*case("ks_pair_one", np.random.default_rng(1))[:4], -3)
    assert (p.form, p.threads) == ("fanout", 64) and blocks(p) < mod_kernels.MIN_BLOCKS
    # a conversion of one ciphertext: the table form at N = 16384 (128
    # blocks), the general form at N = 1024 (8 blocks)
    for n, form in ((16384, "table"), (1024, "general")):
        qc, qci = column(moduli(15, 31, n=n))
        digits = torch.zeros((2, 13, 1, n), dtype=torch.int32)
        assert mod_kernels.plan(digits, torch.zeros((13, 15, 1), dtype=torch.int64), qc, qci, -3).form == form
    # the 58-limb chain's terms: a pair keeps its sums in registers; a wider
    # fan-out stages them past the budget, within what a block may have
    deep = torch.zeros((58, 59, 64), dtype=torch.int32)
    qd, qdi = column(moduli(59, n=64))
    p = mod_kernels.plan(deep, deep.expand(2, 58, 59, 64).contiguous(), qd, qdi, -3)
    assert p.form == "fanout_regs" and p.threads == 64 and mod_kernels.fan_smem(p.form, 58, 2, 64) == 0
    wide = torch.zeros((2, 5, 59, 58, 64), dtype=torch.int32)
    p = mod_kernels.plan(deep.transpose(0, 1), wide, qd[:, None], qdi[:, None], -2)
    assert p.form == "fanout" and p.sizes[0] == 10 and p.threads == 64
    assert mod_kernels.SMEM_BUDGET < mod_kernels.fan_smem(p.form, 58, 10, 64) <= mod_kernels.SMEM_MAX


def test_plan_collapses_and_broadcasts():
    """A [2, 3, k, N] x [k, 1] product collapses to rows of N with the
    batch axes merged; a Python-int b is a scalar; the reduction's strides."""
    q, qi = column(moduli(K))
    a = torch.zeros((2, 3, K, N), dtype=torch.int32)
    p = mod_kernels.plan(a, 1, q, qi)
    assert p.sizes == (1, 1, 1, 6, K, N)
    assert p.shape == (2, 3, K, N) and p.terms == 1
    assert p.operands[1][0] is None and p.operands[1][1] == 1
    key = torch.zeros((K, K + 1, N), dtype=torch.int32)
    qp, qpi = column(moduli(K + 1))
    batch = torch.zeros((2, K, K + 1, N), dtype=torch.int32)
    p = mod_kernels.plan(batch, key, qp, qpi, -3, fan_out=False)
    assert p.shape == (2, K + 1, N) and p.terms == K and p.form == "general"
    assert p.operands[0][3] == (K + 1) * N and p.operands[1][3] == (K + 1) * N
    assert p.sizes == (1, 1, 1, 2, K + 1, N)
    assert p.operands[1][2][-3] == 0  # the key is broadcast over the batch
    assert mod_kernels._vector_operands(p) == (0, 1)  # a and the key run along N
    # the fan-out form: the key (kernel operand 0) staged, the batch its fan-out
    p = mod_kernels.plan(batch, key, qp, qpi, -3)
    assert p.form == "fanout" and p.order == (1, 0, 2, 3) and p.sizes == (2, 1, 1, 1, K + 1, N)
    assert p.operands[0][2][0] == 0 and p.operands[1][2][0] == K * (K + 1) * N
    assert p.ostrides == ((K + 1) * N, 0, 0, 0, N, 1)


def test_vector_path_needs_groups_of_four():
    """The kernel's 16-byte path takes a layout only where every operand
    that runs along the innermost axis does so contiguously in groups of
    four words; a row of odd length or a stride of 2 takes the word path."""
    q, qi = column(moduli(K))
    a = torch.zeros((2, K, N), dtype=torch.int32)
    assert mod_kernels._vector_operands(mod_kernels.plan(a, 1, q, qi)) == (0,)
    assert mod_kernels._vector_operands(mod_kernels.plan(a[..., :-1], 1, q, qi)) is None
    assert mod_kernels._vector_operands(mod_kernels.plan(a[..., ::2], 1, q, qi)) is None
    wide = torch.zeros((2, K, N + 1), dtype=torch.int32)[..., 1:]  # outer strides of N + 1
    assert mod_kernels._vector_operands(mod_kernels.plan(wide, 1, q, qi)) is None


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """modular.mont_mul / mont_mul_lazy / mont_mac and rns.fbc_from_digits
    on CPU tensors never reach mod_kernels."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the Montgomery kernels")

    monkeypatch.setattr(mod_kernels, "_run", refuse)
    rng = np.random.default_rng(7)
    for name in CASES:
        a, b, q, qi, dim, lazy = case(name, rng)
        if dim is not None:
            got = tmod.mont_mac(a, b, q, qi, dim)
        else:
            got = (tmod.mont_mul_lazy if lazy else tmod.mont_mul)(a, b, q, qi)
        assert torch.equal(got, plain(a, b, q, qi, dim, lazy))
    src = rns.RnsBase(moduli(K))
    f = rns.build_fbc(src, moduli(K + 2, 31), torch.device("cpu"))
    tmp = residues(rng, (2, K, N), column(moduli(K))[0])
    whole = rns.fbc_from_digits(tmp, f, chunk=K)
    for chunk in (1, 2):
        assert torch.equal(rns.fbc_from_digits(tmp, f, chunk=chunk), whole)


REFUSALS = {
    "cpu tensor": (lambda a, b, q, qi: (a, b, q, qi, None), ValueError),
    "float a": (lambda a, b, q, qi: (a.float(), b, q, qi, None), TypeError),
    "int16 b": (lambda a, b, q, qi: (a, b.to(torch.int16), q, qi, None), TypeError),
    "shapes that do not broadcast": (lambda a, b, q, qi: (a, b[:2], q, qi, None), ValueError),
    "b beyond u32": (lambda a, b, q, qi: (a, 1 << 32, q, qi, None), ValueError),
    "negative scalar q": (lambda a, b, q, qi: (a, b, -5, qi, None), ValueError),
    "bool b": (lambda a, b, q, qi: (a, True, q, qi, None), TypeError),
    "float scalar": (lambda a, b, q, qi: (a, 1.0, q, qi, None), TypeError),
    "a not a tensor": (lambda a, b, q, qi: (3, b, q, qi, None), TypeError),
    "moduli varying along the reduction": (lambda a, b, q, qi: (a, b, q, qi, -2), ValueError),
    "reduction axis out of range": (lambda a, b, q, qi: (a, b, q, qi, 3), ValueError),
    "more dimensions than collapse to six": (lambda a, b, q, qi: (
        a.new_zeros((2, 3, 2, 3, 2, 3, 2, K, N)).permute(1, 0, 3, 2, 5, 4, 6, 7, 8), b, q, qi, None),
        ValueError),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_wrappers_refuse(what):
    """The K3 / K4 wrappers raise on what the kernels do not take, a CPU
    tensor included; nothing falls back to the plain version."""
    rng = np.random.default_rng(9)
    q, qi = column(moduli(K))
    a, b = residues(rng, (2, K, N), q), residues(rng, (K, 1), q)
    make, err = REFUSALS[what]
    args = make(a, b, q, qi)
    before = dict(mod_kernels.LAUNCHES)
    with pytest.raises(err):
        if args[-1] is None:
            mod_kernels.mont_mul(*args[:-1])
        else:
            mod_kernels.mont_mac(*args)
    with pytest.raises(err):
        mod_kernels.mont_mul_lazy(*args[:-1]) if args[-1] is None else mod_kernels.mont_mac(*args)
    assert mod_kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernels_match_plain_on_cuda(name):
    """On a card: K3 and K4 equal their plain versions at every site's
    pattern, and each call launches its kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    a, b, q, qi, dim, lazy = case(name, np.random.default_rng(200 + CASES.index(name)))
    dev = torch.device("cuda")
    a, b, q, qi = (x.to(dev) if isinstance(x, torch.Tensor) else x for x in (a, b, q, qi))
    want = plain(a, b, q, qi, dim, lazy)
    kname = "mont_mac" if dim is not None else "mont_mul"
    before, forms = mod_kernels.LAUNCHES[kname], dict(mod_kernels.FORM_LAUNCHES)
    if dim is not None:
        got = tmod.mont_mac(a, b, q, qi, dim)
    else:
        got = (tmod.mont_mul_lazy if lazy else tmod.mont_mul)(a, b, q, qi)
    torch.cuda.synchronize()
    assert mod_kernels.LAUNCHES[kname] == before + 1
    assert torch.equal(got, want)
    if dim is not None:  # K4's fan-out form, then the general form on the same layout
        form = FORMS[name][0]
        assert mod_kernels.FORM_LAUNCHES[form] == forms[form] + 1
        assert torch.equal(mod_kernels.mont_mac(a, b, q, qi, dim, fan_out=False), want)
        assert mod_kernels.FORM_LAUNCHES["general"] == forms["general"] + 1


def test_call_sites_contract_pairs_in_one_call(monkeypatch):
    """A key-switch contracts its digits with k0 and k1 in one mont_mac call
    against the stacked [2, kd, k+1, N] key (a digit chunk against the
    pair's rows likewise), and BEHZ's Bsk -> q conversion goes to q and m_sk
    through one joined conversion: no conversion to q or m_sk alone is
    left.  On the CPU these calls reach the plain version; on the card each
    contraction is one K4 launch."""
    from hhe_tpu_torch.ops import bfv as tbfv
    from hhe_tpu_torch.ops import bfv_eval as tev

    contractions, conversions = [], []

    def contract(a, b, q, qi, dim, _fn=tev.mont_mac):
        contractions.append((tuple(torch.broadcast_shapes(a.shape, b.shape)), dim))
        return _fn(a, b, q, qi, dim)

    def convert(tmp, f, chunk=4, _fn=rns.fbc_from_digits):
        conversions.append(f.c_q.shape[0])
        return _fn(tmp, f, chunk)

    ctx = tbfv.Context(tbfv.BFVParams(n=1024, data_limbs=3, seed=3), device="cpu")
    sk = ctx.keygen_secret()
    rk = ctx.keygen_relin(sk)
    g = ctx.galois_elt_from_step(1)
    gks = ctx.keygen_galois(sk, [g])
    assert rk.k1.data_ptr() == rk.k0.data_ptr() + rk.k0.numel() * rk.k0.element_size()
    ct = ctx.encrypt(ctx.keygen_public(sk), ctx.encode(np.arange(ctx.n) % 17))
    monkeypatch.setattr(tev, "mont_mac", contract)
    monkeypatch.setattr(rns, "fbc_from_digits", convert)
    kd, kp, n = ctx.k, ctx.k + 1, ctx.n
    tev.rotate_rows(ctx, ct, 1, gks)
    assert contractions == [((2, kd, kp, n), -3)]
    tev.relinearize(ctx, tev.square(ctx, ct), rk, digit_chunk=2)
    assert contractions[1:] == [((2, 2, kp, n), -3), ((2, 1, kp, n), -3)]
    bsk = len(ctx.base_bsk.moduli)
    assert sorted(conversions) == sorted([bsk] * 3 + [ctx.k + 1])  # two _to_bsk, the fast floor; q + m_sk
