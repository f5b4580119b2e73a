"""The port's modular arithmetic and NTT against the JAX package, bit for bit.

Inputs come from numpy seeds and go through both packages on the CPU; every
comparison is ``np.array_equal`` (tolerance zero).  The JAX NTT runs both as
its XLA stage loop and as the Pallas kernels in interpret mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.ops import modular as jmod
from hhe_tpu.ops import ntt as jntt
from hhe_tpu.ops import ntt_pallas
from hhe_tpu.ops import primes as jprimes
from hhe_tpu_torch.ops import modular as tmod
from hhe_tpu_torch.ops import ntt as tntt
from hhe_tpu_torch.ops import ntt_kernels, primes as tprimes

CPU = torch.device("cpu")
# 17-bit t, the 30-bit data-limb width and the 31-bit BEHZ width
PRIMES = [65537, jprimes.ntt_primes(2048, 30, 1)[0], 2147352577]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test workers on one CPU; one intra-op thread
    per worker keeps them from oversubscribing it (measured 3x slower wall
    time with torch's default thread count)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rand_u32(rng, shape, q):
    return rng.integers(0, q, size=shape, dtype=np.uint64).astype(np.uint32)


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def n32(t):
    return t.to(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("q", PRIMES)
def test_mont_mul_and_lazy_match_jax(q):
    rng = np.random.default_rng(0)
    a = rand_u32(rng, (1000,), q)
    b = rand_u32(rng, (1000,), q)
    qinv_neg, _, r2 = jmod.mont_constants(q)
    b_mont = jmod.to_mont_host(b, q)
    want = np.asarray(jmod.mont_mul(jnp.asarray(a), jnp.asarray(b_mont), np.uint32(q), qinv_neg))
    got = n32(tmod.mont_mul(t32(a), t32(b_mont), q, int(qinv_neg)))
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.uint64), jmod.host.mul_mod(a, b, q))
    # lazy form on values up to 4q (when 4q fits 32 bits): same [0, 2q) bits
    wide = rng.integers(0, min(4 * q, 1 << 32), 1000, dtype=np.uint64).astype(np.uint32)
    if q < (1 << 30):
        want = np.asarray(
            jmod.mont_mul_lazy(jnp.asarray(wide), jnp.asarray(b_mont), np.uint32(q), qinv_neg)
        )
        got = tmod.mont_mul_lazy(
            torch.from_numpy(wide.astype(np.int64)), t32(b_mont), q, int(qinv_neg)
        ).numpy()
        assert np.array_equal(got.astype(np.uint32), want)
    # to/from Montgomery
    am = np.asarray(jmod.to_mont(jnp.asarray(a), r2, np.uint32(q), qinv_neg))
    assert np.array_equal(n32(tmod.to_mont(t32(a), int(r2), q, int(qinv_neg))), am)
    back = np.asarray(jmod.from_mont(jnp.asarray(am), np.uint32(q), qinv_neg))
    assert np.array_equal(n32(tmod.from_mont(t32(am), q, int(qinv_neg))), back)
    assert np.array_equal(back, a)


@pytest.mark.parametrize("q", PRIMES)
def test_add_sub_neg_tree_match_jax(q):
    rng = np.random.default_rng(2)
    a = rand_u32(rng, (257,), q)
    b = rand_u32(rng, (257,), q)
    ja, jb, qq = jnp.asarray(a), jnp.asarray(b), np.uint32(q)
    for jf, tf in ((jmod.add_mod, tmod.add_mod), (jmod.sub_mod, tmod.sub_mod)):
        assert np.array_equal(n32(tf(t32(a), t32(b), q)), np.asarray(jf(ja, jb, qq)))
    assert np.array_equal(n32(tmod.neg_mod(t32(a), q)), np.asarray(jmod.neg_mod(ja, qq)))
    a[:5] = 0  # the zero case of neg_mod
    assert np.array_equal(n32(tmod.neg_mod(t32(a), q)), np.asarray(jmod.neg_mod(jnp.asarray(a), qq)))
    # tree sum over an odd-sized axis (padded to a power of two)
    for name in ("mul_mod", "add_mod", "sub_mod"):  # the numpy golden models
        assert np.array_equal(getattr(tmod.host, name)(a, b, q), getattr(jmod.host, name)(a, b, q))
    assert tmod.host.pow_mod(3, q - 2, q) == jmod.host.pow_mod(3, q - 2, q)
    stack = rand_u32(rng, (3, 7, 64), q)
    want = np.asarray(jmod.tree_add_mod(jnp.asarray(stack), qq, axis=1))
    assert np.array_equal(n32(tmod.tree_add_mod(t32(stack), q, axis=1)), want)


def test_primes_and_tables_match_jax():
    for n, bits, k in ((256, 30, 3), (2048, 31, 2), (16, 29, 1)):
        mods = jprimes.ntt_primes(n, bits, k)
        assert tprimes.ntt_primes(n, bits, k) == mods
        jt = jntt.build_tables(mods, n)
        tt = tntt.build_tables(mods, n, CPU)
        for field in ("q", "qinv_neg", "r2", "psi_br", "ipsi_br", "ninv"):
            assert np.array_equal(
                getattr(tt, field).numpy().astype(np.uint32), np.asarray(getattr(jt, field))
            ), field
        if n >= 128:  # the Pallas tables need a multiple of 128 lanes
            assert tt.lazy == ntt_pallas._build(mods, n, False).lazy


@pytest.mark.parametrize("n,bits", [(256, 30), (2048, 30), (2048, 31)])
def test_plain_ntt_matches_xla_and_pallas(n, bits):
    """The plain NTT == the JAX stage loop == the Pallas kernels (interpret
    mode), forward and inverse, with a batch dimension; 30-bit moduli take
    the Pallas kernels' lazy form, 31-bit the eager one."""
    mods = jprimes.ntt_primes(n, bits, 2)
    jt = jntt.build_tables(mods, n)
    tt = tntt.build_tables(mods, n, CPU)
    rng = np.random.default_rng(8)
    x = np.stack(
        [np.stack([rng.integers(0, m, n) for m in mods]) for _ in range(3)]
    ).astype(np.uint32)  # [3, k, n]
    f_xla = np.asarray(jntt._ntt_fwd_xla(jnp.asarray(x), jt))
    f_pl = np.asarray(ntt_pallas.ntt_fwd(jnp.asarray(x), jt, interpret=True))
    f_t = n32(tntt.ntt_fwd(t32(x), tt))
    assert np.array_equal(f_t, f_xla) and np.array_equal(f_t, f_pl)
    i_xla = np.asarray(jntt._ntt_inv_xla(jnp.asarray(f_xla), jt))
    i_pl = np.asarray(ntt_pallas.ntt_inv(jnp.asarray(f_xla), jt, interpret=True))
    i_t = n32(tntt.ntt_inv(t32(f_xla), tt))
    assert np.array_equal(i_t, i_xla) and np.array_equal(i_t, i_pl)
    assert np.array_equal(i_t, x)


def test_plain_ntt_single_limb_t():
    """The finish's and the round-material expansion's transform mod t = 65537."""
    n = 2048
    jt = jntt.build_tables((65537,), n)
    tt = tntt.build_tables((65537,), n, CPU)
    rng = np.random.default_rng(9)
    x = rng.integers(0, 65537, (4, 1, n)).astype(np.uint32)
    assert np.array_equal(
        n32(tntt.ntt_inv(t32(x), tt)),
        np.asarray(ntt_pallas.ntt_inv(jnp.asarray(x), jt, interpret=True)),
    )
    assert np.array_equal(
        n32(tntt.ntt_fwd(t32(x), tt)), np.asarray(jntt._ntt_fwd_xla(jnp.asarray(x), jt))
    )


def test_negacyclic_mul_and_mont_helpers_match_jax():
    n = 128
    mods = jprimes.ntt_primes(n, 30, 2)
    jt = jntt.build_tables(mods, n)
    tt = tntt.build_tables(mods, n, CPU)
    rng = np.random.default_rng(5)
    a = np.stack([rand_u32(rng, (n,), q) for q in mods])
    b = np.stack([rand_u32(rng, (n,), q) for q in mods])
    got = n32(tntt.negacyclic_mul(t32(a), t32(b), tt))
    assert np.array_equal(got, np.asarray(jntt.negacyclic_mul(jnp.asarray(a), jnp.asarray(b), jt)))
    for i, q in enumerate(mods):
        assert np.array_equal(got[i].astype(np.uint64), jntt.negacyclic_mul_host(a[i], b[i], q))
    assert np.array_equal(
        n32(tntt.to_mont(t32(a), tt)), np.asarray(jntt.to_mont(jnp.asarray(a), jt))
    )
    assert np.array_equal(
        n32(tntt.pointwise_mont(t32(a), t32(b), tt)),
        np.asarray(jntt.pointwise_mont(jnp.asarray(a), jnp.asarray(b), jt)),
    )


def _prime_above_2_32(n):
    q = ((1 << 33) // (2 * n)) * 2 * n + 1
    while not tprimes.is_prime(q):
        q += 2 * n
    return q


@pytest.mark.parametrize("q", [65537, 2147352577, "above_2^32"])
def test_host_ntt_matches_jax(q):
    n = 256
    if q == "above_2^32":  # object-dtype bigint path
        q = _prime_above_2_32(n)
    jt = jntt.build_host_tables(q, n)
    tt = tntt.build_host_tables(q, n)
    assert np.array_equal(tt.psi_br, jt.psi_br) and tt.ninv == jt.ninv
    rng = np.random.default_rng(10)
    raw = rng.integers(0, 1 << 62, 2 * n)
    x = np.array([int(v) % q for v in raw], dtype=object).reshape(2, n)
    if q < (1 << 32):
        x = x.astype(np.uint64)
    f = tntt.ntt_fwd_host(x, tt)
    assert np.array_equal(f, jntt.ntt_fwd_host(x, jt))
    assert np.array_equal(tntt.ntt_inv_host(f, tt), jntt.ntt_inv_host(f, jt))
    assert np.array_equal(tntt.ntt_inv_host(f, tt) % q, np.asarray(x) % q)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers take only CUDA tensors: a CPU tensor never reaches a
    kernel, and the dispatcher sends it to the plain version instead."""
    mods = jprimes.ntt_primes(256, 30, 2)
    tt = tntt.build_tables(mods, 256, CPU)
    x = torch.zeros((2, 256), dtype=torch.int32)
    before = dict(ntt_kernels.LAUNCHES)
    for fn in (ntt_kernels.ntt_fwd, ntt_kernels.ntt_inv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, tt)
    assert torch.equal(tntt.ntt_fwd(x, tt), x)  # plain path, zeros stay zeros
    assert ntt_kernels.LAUNCHES == before


def _misaligned(shape):
    """A contiguous int32 tensor whose data starts 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.int32)  # 64-byte aligned
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    return x


@pytest.mark.parametrize(
    "case, err, match",
    [
        ("misaligned", ValueError, "aligned"),
        ("int64", TypeError, "int32"),
        ("strided", ValueError, "contiguous"),
        ("n=16", ValueError, "N = 2"),
        ("n=384", ValueError, "N = 2"),
        ("n=131072", ValueError, "N = 2"),
        ("limbs", ValueError, "tables for"),
        ("parts", ValueError, "tables for"),
    ],
)
def test_kernel_wrappers_refuse_what_kernels_do_not_take(case, err, match):
    """Every limit of the kernels is checked before the device, so each
    refusal shows here on the CPU; nothing launches."""
    mods = jprimes.ntt_primes(256, 30, 2)
    tt = tntt.build_tables(mods, 256, CPU)
    if case == "parts":  # N = 32768 tables whose parts are not cut as the kernels need
        tt = tntt.build_tables(tuple(jprimes.ntt_primes(32768, 30, 2)), 32768, CPU)
        tt = tt._replace(ipsi_parts=tt.ipsi_shoup.view(2, 1, 32768, 2))
    x = {
        "misaligned": lambda: _misaligned((2, 256)),
        "int64": lambda: torch.zeros((2, 256), dtype=torch.int64),
        "strided": lambda: torch.zeros((2, 512), dtype=torch.int32)[:, ::2],
        "n=16": lambda: torch.zeros((2, 16), dtype=torch.int32),
        "n=384": lambda: torch.zeros((2, 384), dtype=torch.int32),
        "n=131072": lambda: torch.zeros((2, 131072), dtype=torch.int32),
        "limbs": lambda: torch.zeros((3, 256), dtype=torch.int32),
        "parts": lambda: torch.zeros((2, 32768), dtype=torch.int32),
    }[case]()
    before = dict(ntt_kernels.LAUNCHES)
    for fn in (ntt_kernels.ntt_fwd, ntt_kernels.ntt_inv):
        with pytest.raises(err, match=match):
            fn(x, tt)
    assert ntt_kernels.LAUNCHES == before


@pytest.mark.parametrize("n,bits,k", [(256, 30, 3), (2048, 31, 2), (16384, 30, 1), (1024, 17, 1)])
def test_shoup_tables_match_exact_integers(n, bits, k):
    """The kernels' Shoup pairs (w, floor(w 2^32 / q)): w is the standard
    value of the Montgomery entry (w 2^32 = entry mod q), checked in Python
    integers; the Montgomery fields stay those of the JAX package.  The
    inverse's pairs for N^-1 and N^-1 * ipsi_br[1] come from ninv and
    ipsi_br[:, 1] in the same way."""
    mods = (65537,) if bits == 17 else tuple(jprimes.ntt_primes(n, bits, k))
    tt = tntt.build_tables(mods, n, CPU)
    jt = jntt.build_tables(mods, n)
    for field in ("psi_br", "ipsi_br", "ninv"):
        assert np.array_equal(
            getattr(tt, field).numpy().astype(np.uint32), np.asarray(getattr(jt, field))
        ), field
    # the inverse's last stage folds N^-1 into its twiddle ipsi_br[1]
    ninv = tt.ninv.numpy().astype(object)[:, 0]
    ninv_w = np.array([int(m) * pow(n, -1, q) % q for m, q in zip(n32(tt.ipsi_br)[:, 1], mods)])
    pairs = (
        (tt.psi_shoup, n32(tt.psi_br)),
        (tt.ipsi_shoup, n32(tt.ipsi_br)),
        (tt.ninv_shoup, np.stack([ninv, ninv_w], 1)),
    )
    for shoup, mont in pairs:
        assert shoup.dtype == torch.int32 and shoup.shape == (*mont.shape, 2)
        sh = n32(shoup).astype(object)
        for i, q in enumerate(mods):
            w, wp = sh[i, ..., 0].ravel(), sh[i, ..., 1].ravel()
            for wv, wpv, mv in zip(w, wp, mont[i].ravel().astype(object)):
                assert wv < q and (wv << 32) % q == mv and wpv == (wv << 32) // q


@pytest.mark.cuda
@pytest.mark.parametrize("logn", range(5, 17))
def test_kernels_match_plain_on_cuda(logn):
    """On a card: both kernels equal their plain versions at every N the
    wrappers take (one kernel instance each, and the top passes above
    N = 16384), for lazy (30-bit), eager (31-bit) and t tables (65537, or
    the large preset's 29-bit t at N = 65536), with fewer 64 KB tiles than
    the card has SMs and with at least four tiles for every block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 1 << logn
    t = 65537 if n <= 32768 else tprimes.ntt_primes(n, 29, 1)[0]
    for bits, k in ((30, 13), (31, 15), (17, 1)):
        mods = (t,) if bits == 17 else tprimes.ntt_primes(n, bits, k)
        tb = tntt.build_tables(mods, n, dev)
        rng = np.random.default_rng(n + bits)
        # rows for 4 tiles a block: a tile holds 16384 / N rows, or 1 / P of one
        for batch in (2, -(-(4 * sms + 3) * tntt.TILE // (n * k))):
            x = torch.from_numpy(
                np.stack([rng.integers(0, m, (batch, n)) for m in mods], 1).astype(np.int32)
            ).to(dev)
            f = tntt.ntt_fwd(x, tb)
            assert torch.equal(f, tntt.ntt_fwd_plain(x, tb))
            assert torch.equal(tntt.ntt_inv(f, tb), tntt.ntt_inv_plain(f, tb))
            assert torch.equal(tntt.ntt_inv(f, tb), x)


@pytest.mark.parametrize("n,q", [(16, 97), (64, 7681), (256, None)])
def test_negacyclic_mul_host_matches_jax_and_ntt(n, q):
    """The O(N^2) schoolbook product equals the JAX package's and the host
    NTT product (``poly_mul_host``), for small primes and a 30-bit one."""
    q = q or jprimes.ntt_primes(n, 30, 1)[0]
    rng = np.random.default_rng(n)
    a = rng.integers(0, q, n).astype(np.uint64)
    b = rng.integers(0, q, n).astype(np.uint64)
    got = tntt.negacyclic_mul_host(a, b, q)
    assert got.dtype == np.uint64
    assert np.array_equal(got, jntt.negacyclic_mul_host(a, b, q))
    assert np.array_equal(got, tntt.poly_mul_host(a, b, q))
