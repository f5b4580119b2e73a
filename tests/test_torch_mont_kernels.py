"""The Montgomery kernels (K3 ``mont_mul`` / ``mont_mul_lazy``, K4
``mont_mac``, ``hhe_tpu_torch/csrc/modarith.cu``) and their plain versions.

On the CPU: the plain versions against the JAX package's ``mont_mul`` /
``mont_mul_lazy`` / ``tree_add_mod(mont_mul(...))`` bit for bit, at the
broadcast pattern of every site that calls them; the kernels' launch layout
(``mod_kernels.plan``) replayed in numpy with the kernel's own arithmetic;
CPU tensors never reaching the kernels; the wrappers' refusals.  On a card
(``cuda`` marker): each kernel against its plain version at the same sites.
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
    if name == "bsgs_plain_q":  # [1, n1, k, N] x [n2, n1, k, N], reduce 1
        q, qi = column(moduli(K))
        return residues(rng, (1, 4, K, N), q), residues(rng, (3, 4, K, N), q), q, qi, 1, False
    if name == "bsgs_plain_qp":  # [1, n1-1, k+1, N] x a view [n2, 1:, k+1, N], reduce 1
        q, qi = column(moduli(kp))
        dqp = residues(rng, (3, 4, kp, N), q)
        return residues(rng, (1, 3, kp, N), q), dqp[:, 1:], q, qi, 1, False
    if name == "fbc":  # tmp[..., ka, None, N] x m_mont[ka, kc, None], moduli c_q, reduce -3
        ka, kc = K, K + 2
        q, qi = column(moduli(kc, 31))
        tmp = residues(rng, (3, ka, N), column(moduli(ka))[0])
        m = residues(rng, (ka, kc), q.reshape(1, kc))
        return tmp[..., None, :], m[:, :, None], q, qi, -3, False
    raise KeyError(name)


K3_CASES = ("mont_mul", "mont_mul_lazy", "multiply_plain", "from_mont", "to_bsk_int64")
K4_CASES = ("hoisted_ks", "digit_chunk", "bsgs_contract", "bsgs_plain_q", "bsgs_plain_qp", "fbc")
CASES = K3_CASES + K4_CASES


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
    """What csrc/modarith.cu computes from a launch plan, in numpy u64:
    each operand read through its strides (u32 bits), REDC per term, the sum
    folded below 2q after each term, one final reduction unless lazy."""
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
    acc = acc.reshape(p.shape)
    if dtype == torch.int64:
        return torch.from_numpy(acc.astype(np.int64))
    return torch.from_numpy(acc.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("name", CASES)
def test_launch_plan_replays_plain(name):
    """The kernels' layout (collapsed sizes, strides of 0 for broadcast
    operands, the reduction's strides) replayed with the kernel's arithmetic
    gives the plain version's bits, in at most MAX_DIMS dimensions."""
    a, b, q, qi, dim, lazy = case(name, np.random.default_rng(100 + CASES.index(name)))
    p = mod_kernels.plan(a, b, q, qi, dim)
    assert len(p.sizes) == mod_kernels.MAX_DIMS
    for x, _, _, _ in p.operands:  # broadcast operands are never materialised
        assert x is None or any(x is y for y in (a, b, q, qi))
    assert torch.equal(emulate(p, lazy, a.dtype), plain(a, b, q, qi, dim, lazy))


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
    p = mod_kernels.plan(torch.zeros((2, K, K + 1, N), dtype=torch.int32), key, qp, qpi, -3)
    assert p.shape == (2, K + 1, N) and p.terms == K
    assert p.operands[0][3] == (K + 1) * N and p.operands[1][3] == (K + 1) * N
    assert p.operands[1][2][-3] == 0  # the key is broadcast over the batch
    assert mod_kernels._vector_operands(p) == (0, 1)  # a and the key run along N


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
    before = mod_kernels.LAUNCHES[kname]
    if dim is not None:
        got = tmod.mont_mac(a, b, q, qi, dim)
    else:
        got = (tmod.mont_mul_lazy if lazy else tmod.mont_mul)(a, b, q, qi)
    torch.cuda.synchronize()
    assert mod_kernels.LAUNCHES[kname] == before + 1
    assert torch.equal(got, want)
