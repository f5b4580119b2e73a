"""The port at the large preset's degrees (N = 32768, 65536) against the JAX
package, on the CPU: the parameters, the plain NTT, the per-part tables of
the kernels that cut a row into 64 KB parts, a plain rendering of that split,
and host keygen / encryption / rotation / decryption at N = 65536.  Every
comparison is ``np.array_equal`` or ``torch.equal`` (tolerance zero)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import bfv_eval as jev
from hhe_tpu.ops import ntt as jntt
from hhe_tpu.ops import ntt_pallas
from hhe_tpu.ops import primes as jprimes
from hhe_tpu_torch import convert
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import bfv_eval as tev
from hhe_tpu_torch.ops import modular as tmod
from hhe_tpu_torch.ops import ntt as tntt

CPU = torch.device("cpu")
T29 = jprimes.ntt_primes(65536, 29, 1)[0]  # the large preset's plaintext modulus


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test workers on one CPU; one intra-op thread
    per worker keeps them from oversubscribing it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t32(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def n32(t):
    return t.to(torch.int32).numpy().view(np.uint32)


def moduli(n, bits):
    """Two 30-bit (lazy) or 31-bit (eager) limbs, or the one-limb t."""
    if bits == "t":
        return (65537,) if n <= 32768 else (T29,)
    return tuple(jprimes.ntt_primes(n, bits, 2))


def test_large_params_and_moduli_match_jax():
    jp, tp = jbfv.large_params(), tbfv.large_params()
    assert (tp.n, tp.t, tp.data_limbs, tp.data_limb_bits) == (jp.n, jp.t, jp.data_limbs, 30)
    assert tp.t == T29 and (tp.t - 1) % (2 * tp.n) == 0
    jc = jbfv.Context(jp)
    tc = tbfv.Context(tp, device="cpu")
    assert tc.k == 58 and tc.q_moduli == jc.q_moduli and tc.p_special == jc.p_special
    assert tc.b_moduli == jc.b_moduli and (tc.m_sk, tc.gamma) == (jc.m_sk, jc.gamma)
    assert tc.tb_q.lazy and not tc.tb_bsk.lazy
    assert tbfv.large_params(data_limbs=16, seed=3) == tbfv.BFVParams(
        n=65536, t=T29, data_limbs=16, seed=3
    )
    assert tbfv.default_context(1024, device="cpu").k == 3


@pytest.mark.parametrize(
    "n,bits", [(32768, 30), (32768, 31), (32768, "t"), (65536, 30), (65536, 31), (65536, "t")]
)
def test_plain_ntt_matches_xla_and_pallas_at_large_n(n, bits):
    """The plain NTT == the JAX stage loop == the Pallas kernels (interpret
    mode), forward and inverse."""
    mods = moduli(n, bits)
    jt = jntt.build_tables(mods, n)
    tt = tntt.build_tables(mods, n, CPU)
    assert np.array_equal(n32(tt.psi_br), np.asarray(jt.psi_br))
    assert np.array_equal(n32(tt.ipsi_br), np.asarray(jt.ipsi_br))
    rng = np.random.default_rng(n + len(mods))
    x = np.stack([rng.integers(0, m, n) for m in mods]).astype(np.uint32)[None]
    f_xla = np.asarray(jntt._ntt_fwd_xla(jnp.asarray(x), jt))
    f_t = n32(tntt.ntt_fwd(t32(x), tt))
    assert np.array_equal(f_t, f_xla)
    i_xla = np.asarray(jntt._ntt_inv_xla(jnp.asarray(f_xla), jt))
    i_t = n32(tntt.ntt_inv(t32(f_xla), tt))
    assert np.array_equal(i_t, i_xla) and np.array_equal(i_t, x)
    if n == 65536 and bits == 30:  # the Pallas kernels take about 4 s a call here
        assert np.array_equal(np.asarray(ntt_pallas.ntt_fwd(jnp.asarray(x), jt, interpret=True)), f_t)
        assert np.array_equal(np.asarray(ntt_pallas.ntt_inv(jnp.asarray(f_xla), jt, interpret=True)), i_t)


@pytest.mark.parametrize("n,bits", [(32768, 31), (65536, 30), (65536, "t"), (16384, 30)])
def test_part_tables_match_exact_integers(n, bits):
    """Entry j in [m', 2m') of part p of the tile kernels' tables is the Shoup
    pair of psi_br[(P + p) m' + j - m'] (ipsi_br for the inverse), computed
    here with Python integers; up to N = 16384 there is one part, psi_shoup."""
    mods = moduli(n, bits)
    tt = tntt.build_tables(mods, n, CPU)
    parts, span = max(1, n // 16384), min(n, 16384)
    assert tt.psi_parts.shape == tt.ipsi_parts.shape == (len(mods), parts, span, 2)
    for table, mont in ((tt.psi_parts, n32(tt.psi_br)), (tt.ipsi_parts, n32(tt.ipsi_br))):
        got = n32(table).astype(object)
        for i, q in enumerate(mods):
            rinv = pow(1 << 32, -1, q)
            for p in range(parts):
                for j in list(range(1, 70)) + list(range(span - 70, span)):
                    m = 1 << (j.bit_length() - 1)
                    w = int(mont[i, (parts + p) * m + j - m]) * rinv % q
                    assert (got[i, p, j, 0], got[i, p, j, 1]) == (w, (w << 32) // q), (i, p, j)
            # every entry, vectorised: the pairs of psi_shoup re-indexed
            pairs = n32(tt.psi_shoup if table is tt.psi_parts else tt.ipsi_shoup)[i]
            assert np.array_equal(n32(table)[i], pairs[tntt.part_index(n, parts)])


def split_fwd(x, tb, parts):
    """The forward NTT as the kernels split it: the stages with fewer than
    `parts` groups over the whole row, then each of the `parts` parts
    transformed alone with its own table (psi_br re-indexed by part)."""
    *lead, k, n = x.shape
    span = n // parts
    q, qi = tb.q[..., None], tb.qinv_neg[..., None]
    psi = tb.psi_br.to(torch.int64)
    y = x.to(torch.int64)
    m = 1
    while m < parts:  # top: twiddles psi_br[m + g]
        yv = y.reshape(*lead, k, m, 2, n // (2 * m))
        v = tmod.mont_mul(yv[..., 1, :], psi[:, m : 2 * m, None], q, qi)
        y = torch.stack([tmod.add_mod(yv[..., 0, :], v, q), tmod.sub_mod(yv[..., 0, :], v, q)], -2)
        y = y.reshape(*lead, k, n)
        m *= 2
    top = y
    tab = psi[:, torch.from_numpy(tntt.part_index(n, parts))]  # [k, P, span]
    q4, qi4 = q[..., None], qi[..., None]
    m = 1
    while m < span:  # each part: twiddles table[p][m' + g']
        yv = y.reshape(*lead, k, parts, m, 2, span // (2 * m))
        v = tmod.mont_mul(yv[..., 1, :], tab[:, :, m : 2 * m, None], q4, qi4)
        y = torch.stack(
            [tmod.add_mod(yv[..., 0, :], v, q4), tmod.sub_mod(yv[..., 0, :], v, q4)], -2
        ).reshape(*lead, k, n)
        m *= 2
    return top.to(torch.int32), y.to(torch.int32)


def split_inv(x, tb, parts):
    """The inverse as the kernels split it: each part alone with its ipsi_br
    table and no N^-1, then the last stages over the whole row, then N^-1."""
    *lead, k, n = x.shape
    span = n // parts
    q, qi = tb.q[..., None], tb.qinv_neg[..., None]
    ipsi = tb.ipsi_br.to(torch.int64)
    tab = ipsi[:, torch.from_numpy(tntt.part_index(n, parts))]
    q4, qi4 = q[..., None], qi[..., None]
    y = x.to(torch.int64)
    h = span // 2
    while h >= 1:
        yv = y.reshape(*lead, k, parts, h, 2, span // (2 * h))
        u, v = yv[..., 0, :], yv[..., 1, :]
        d = tmod.mont_mul(tmod.sub_mod(u, v, q4), tab[:, :, h : 2 * h, None], q4, qi4)
        y = torch.stack([tmod.add_mod(u, v, q4), d], -2).reshape(*lead, k, n)
        h //= 2
    tiles = y
    h = parts // 2
    while h >= 1:
        yv = y.reshape(*lead, k, h, 2, n // (2 * h))
        u, v = yv[..., 0, :], yv[..., 1, :]
        d = tmod.mont_mul(tmod.sub_mod(u, v, q), ipsi[:, h : 2 * h, None], q, qi)
        y = torch.stack([tmod.add_mod(u, v, q), d], -2).reshape(*lead, k, n)
        h //= 2
    out = tmod.mont_mul(y, tb.ninv, tb.q, tb.qinv_neg)
    return tiles.to(torch.int32), out.to(torch.int32)


@pytest.mark.parametrize("n,parts,bits", [(1024, 2, 30), (1024, 4, 31), (32768, 2, 30), (65536, 4, 31)])
def test_split_rendering_equals_plain_ntt(n, parts, bits):
    """Top stages then per-part transforms == the plain stage loop, both
    ways; at N > 16384 the top stages equal ntt_fwd_top_plain /
    ntt_inv_top_plain (the plain versions of the kernels' top passes)."""
    mods = moduli(n, bits)
    tb = tntt.build_tables(mods, n, CPU)
    rng = np.random.default_rng(parts * n)
    x = t32(np.stack([rng.integers(0, m, (2, n)) for m in mods], 1))  # [2, k, n]
    f = tntt.ntt_fwd_plain(x, tb)
    top, got = split_fwd(x, tb, parts)
    assert torch.equal(got, f)
    tiles, back = split_inv(f, tb, parts)
    assert torch.equal(back, tntt.ntt_inv_plain(f, tb)) and torch.equal(back, x)
    if n > 16384:
        assert torch.equal(tntt.ntt_fwd_top_plain(x, tb), top)
        assert torch.equal(tntt.ntt_inv_top_plain(tiles, tb), back)


@pytest.fixture(scope="module")
def large3():
    """Both packages' contexts at N = 65536 with 3 data limbs, same params."""
    params = dict(n=65536, t=T29, data_limbs=3, seed=9)
    return jbfv.Context(jbfv.BFVParams(**params)), tbfv.Context(tbfv.BFVParams(**params), device="cpu")


def test_host_keygen_encrypt_rotate_decrypt_at_65536(large3):
    """Host keygen, encryption and decryption draw for draw equal to the JAX
    package's at N = 65536; rotate_rows by -1 (a hybrid key-switch) gives
    the JAX package's ciphertext and the rolled vector."""
    jc, tc = large3
    jsk, tsk = jc.keygen_secret(), tc.keygen_secret()
    assert np.array_equal(jsk.s_q, tsk.s_q)
    jpk, tpk = jc.keygen_public(jsk), tc.keygen_public(tsk)
    assert np.array_equal(jpk.data, tpk.data)
    g = jc.galois_elt_from_step(-1)
    jg, tg = jc.keygen_galois(jsk, [g]), tc.keygen_galois(tsk, [g])
    assert np.array_equal(convert.to_numpy(tg[g].k0), np.asarray(jg[g].k0))
    v = np.random.default_rng(8).integers(0, tc.t, 300, dtype=np.int64)
    jct, tct = jc.encrypt(jpk, jc.encode(v)), tc.encrypt(tpk, tc.encode(v))
    assert np.array_equal(convert.to_numpy(tct.data), np.asarray(jct.data))
    assert tc.noise_budget(tsk, tct) == jc.noise_budget(jsk, jct) > 40
    assert np.array_equal(tc.decode(tc.decrypt(tsk, tct))[:300], v)
    rot = tev.rotate_rows(tc, tct, -1, tg)
    assert np.array_equal(convert.to_numpy(rot.data), np.asarray(jev.rotate_rows(jc, jct, -1, jg).data))
    half = tc.n // 2
    vv = np.zeros(tc.n, np.uint64)
    vv[:300] = v
    expect = np.roll(vv.reshape(2, half), 1, axis=1).reshape(-1)
    assert np.array_equal(tc.decode(tc.decrypt(tsk, rot)), expect)


def test_decrypt_batch_equals_decrypt_at_65536():
    """At the large preset's t with 9 limbs, k * t >= 2^32 (where the JAX
    package's u32 sum wraps): decrypt_batch equals the exact decrypt."""
    tc = tbfv.Context(tbfv.large_params(data_limbs=9, seed=4), device="cpu")
    assert tc.k * tc.t >= 1 << 32
    sk = tc.keygen_secret()
    pk = tc.keygen_public(sk)
    rng = np.random.default_rng(5)
    cts = [tc.encrypt(pk, tc.encode(rng.integers(0, tc.t, 500))) for _ in range(2)]
    m = tc.decrypt_batch(sk, tbfv.Ciphertext(torch.stack([c.data for c in cts], 1)))
    for i, c in enumerate(cts):
        assert np.array_equal(m[i], tc.decrypt(sk, c).data)
