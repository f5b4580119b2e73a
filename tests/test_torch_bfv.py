"""The port's BFV context and evaluator against the JAX package, array for
array, on the N=2048 / 4-limb context of ``test_bfv.py`` (CPU).

Keys made by one package reach the other through ``hhe_tpu_torch.convert``;
the host keygen and encryption of both packages draw the same numbers from
``np.random.default_rng(seed)`` and are compared directly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import bfv_eval as jev
from hhe_tpu.ops import primes as jprimes
from hhe_tpu_torch import convert
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import bfv_eval as tev

CPU = torch.device("cpu")
PARAMS = dict(n=2048, data_limbs=4, seed=7)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test workers on one CPU; one intra-op thread
    per worker keeps them from oversubscribing it (measured 3x slower wall
    time with torch's default thread count)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def same(t_obj, j_arr):
    """A port tensor/array equals a JAX array bit for bit."""
    return np.array_equal(convert.to_numpy(t_obj), np.asarray(j_arr).astype(np.uint32))


@pytest.fixture(scope="module")
def pair():
    """(JAX ctx, port ctx, JAX keys, port keys, JAX cts, port cts): keys and
    fresh ciphertexts made on the JAX side and carried to the port."""
    jc = jbfv.Context(jbfv.BFVParams(**PARAMS))
    tc = tbfv.Context(tbfv.BFVParams(**PARAMS), device="cpu")
    sk = jc.keygen_secret()
    pk = jc.keygen_public(sk)
    rk = jc.keygen_relin(sk)
    elts = [jc.galois_elt_from_step(s) for s in (1, -3)] + [2 * jc.n - 1]
    gks = jc.keygen_galois(sk, elts)
    rng = np.random.default_rng(1)
    vals = [rng.integers(0, jc.t, jc.n, dtype=np.int64) for _ in range(2)]
    cts = [jc.encrypt(pk, jc.encode(v)) for v in vals]
    jk = dict(sk=sk, pk=pk, rk=rk, gks=gks)
    tk = dict(
        sk=convert.secret_key(sk),
        pk=convert.public_key(pk),
        rk=convert.kswitch_key(rk, CPU),
        gks=convert.galois_keys(gks, CPU),
    )
    return jc, tc, jk, tk, cts, [convert.ciphertext(c, CPU) for c in cts], vals


def test_context_constants_match_jax(pair):
    jc, tc = pair[0], pair[1]
    assert tc.q_moduli == jc.q_moduli and tc.p_special == jc.p_special
    assert tc.b_moduli == jc.b_moduli and (tc.m_sk, tc.gamma) == (jc.m_sk, jc.gamma)
    assert np.array_equal(tc.encoder_map, jc.encoder_map)
    assert np.array_equal(tc.delta_mod_q, jc.delta_mod_q) and tc.q_mod_t == jc.q_mod_t
    assert same(tc.p_inv_mont, jc.p_inv_mont)
    for g in (3, 2 * jc.n - 1, jc.galois_elt_from_step(-5)):
        for a, b in zip(tc.galois_perm(g), jc.galois_perm(g)):
            assert np.array_equal(a, b)
        assert np.array_equal(tev.ntt_galois_src(tc, g), jev.ntt_galois_src(jc, g))
    assert tc.galois_elt_from_step(7) == jc.galois_elt_from_step(7)
    for tb_t, tb_j in ((tc.tb_q, jc.tb_q), (tc.tb_qp, jc.tb_qp), (tc.tb_bsk, jc.tb_bsk)):
        assert same(tb_t.psi_br, tb_j.psi_br) and same(tb_t.ipsi_br, tb_j.ipsi_br)


def test_host_keygen_encrypt_decrypt_identical():
    """Same BFVParams -> the same keys, encryptions and decryptions."""
    jc = jbfv.Context(jbfv.BFVParams(**PARAMS))
    tc = tbfv.Context(tbfv.BFVParams(**PARAMS), device="cpu")
    jsk, tsk = jc.keygen_secret(), tc.keygen_secret()
    assert np.array_equal(jsk.s_small, tsk.s_small) and np.array_equal(jsk.s_q, tsk.s_q)
    jpk, tpk = jc.keygen_public(jsk), tc.keygen_public(tsk)
    assert np.array_equal(jpk.data, tpk.data)
    jrk, trk = jc.keygen_relin(jsk), tc.keygen_relin(tsk)
    assert same(trk.k0, jrk.k0) and same(trk.k1, jrk.k1)
    g = jc.galois_elt_from_step(2)
    jg, tg = jc.keygen_galois(jsk, [g])[g], tc.keygen_galois(tsk, [g])[g]
    assert same(tg.k0, jg.k0) and same(tg.k1, jg.k1)
    v = np.random.default_rng(2).integers(-300, 300, jc.n)
    jct, tct = jc.encrypt(jpk, jc.encode(v)), tc.encrypt(tpk, tc.encode(v))
    assert same(tct.data, jct.data)
    assert np.array_equal(tc.decrypt(tsk, tct).data, jc.decrypt(jsk, jct).data)
    assert np.array_equal(tc.decode_signed(tc.decrypt(tsk, tct)), v)
    assert tc.noise_budget(tsk, tct) == jc.noise_budget(jsk, jct) > 40
    assert same(tc.plain_for_mul(tc.encode(v)), jc.plain_for_mul(jc.encode(v)))
    assert same(tc.plain_for_add(tc.encode(v)), jc.plain_for_add(jc.encode(v)))
    polys = tc.encode_batch(np.stack([v, -v]))
    assert np.array_equal(polys, jc.encode_batch(np.stack([v, -v])))
    assert np.array_equal(tc.decode_signed_batch(polys), np.stack([v, -v]))
    for name in ("plain_for_mul_batch", "plain_for_mul_qp_batch", "plain_for_add_batch"):
        assert same(getattr(tc, name)(polys), getattr(jc, name)(polys)), name


EVAL_OPS = [
    "add_sub_negate_add_plain",
    "multiply_plain",
    "apply_galois",
    "rotate_columns",
    "relinearize",
    "keyswitch_digit_chunk2",
    "multiply",
    "exponentiate",
]


@pytest.mark.parametrize("op", EVAL_OPS)
def test_evaluator_matches_jax(pair, op):
    jc, tc, jk, tk, jcts, tcts, vals = pair
    ja, jb = jcts
    ta, tb = tcts
    pt = jc.encode(vals[1] % 1000)
    if op == "add_sub_negate_add_plain":
        assert same(tev.add(tc, ta, tb).data, jev.add(jc, ja, jb).data)
        assert same(tev.sub(tc, ta, tb).data, jev.sub(jc, ja, jb).data)
        assert same(tev.negate(tc, ta).data, jev.negate(jc, ja).data)
        got = tev.add_plain(tc, ta, tc.plain_for_add(pt))
        assert same(got.data, jev.add_plain(jc, ja, jc.plain_for_add(pt)).data)
    elif op == "multiply_plain":
        got = tev.multiply_plain(tc, ta, tc.plain_for_mul(pt))
        assert same(got.data, jev.multiply_plain(jc, ja, jc.plain_for_mul(pt)).data)
    elif op == "apply_galois":
        for step in (1, -3):
            g = jc.galois_elt_from_step(step)
            got = tev.apply_galois(tc, ta, g, tk["gks"][g])
            assert same(got.data, jev.apply_galois(jc, ja, g, jk["gks"][g]).data), step
        half = jc.n // 2
        out = tc.decode(tc.decrypt(tk["sk"], tev.rotate_rows(tc, ta, 1, tk["gks"])))
        assert np.array_equal(out, np.roll(vals[0].reshape(2, half), -1, axis=1).reshape(-1))
    elif op == "rotate_columns":
        got = tev.rotate_columns(tc, ta, tk["gks"])
        assert same(got.data, jev.rotate_columns(jc, ja, jk["gks"]).data)
    elif op == "relinearize":
        prod = jev.multiply(jc, ja, jb)
        got = tev.relinearize(tc, convert.ciphertext(prod, CPU), tk["rk"])
        assert same(got.data, jev.relinearize(jc, prod, jk["rk"]).data)
    elif op == "keyswitch_digit_chunk2":
        d_t = tev.keyswitch(tc, tb.data[1], tk["rk"], digit_chunk=2)
        d_j = jev.keyswitch(jc, jb.data[1], jk["rk"], digit_chunk=2)
        d_full = tev.keyswitch(tc, tb.data[1], tk["rk"])
        for x, y, z in zip(d_t, d_j, d_full):
            assert same(x, y) and torch.equal(x, z)
    elif op == "multiply":
        got = tev.multiply(tc, ta, tb)
        assert same(got.data, jev.multiply(jc, ja, jb).data)
        assert same(tev.square(tc, ta).data, jev.square(jc, ja).data)
        expect = (vals[0] * vals[1]) % jc.t
        assert np.array_equal(tc.decode(tc.decrypt(tk["sk"], got)), expect)
    elif op == "exponentiate":
        got = tev.exponentiate(tc, ta, 3, tk["rk"])
        assert same(got.data, jev.exponentiate(jc, ja, 3, jk["rk"]).data)


def test_decrypt_batch_equals_decrypt(pair):
    """decrypt_batch == per-sample decrypt + decode, for size-2 and size-3
    ciphertexts, and == the JAX package's decrypt_batch."""
    jc, tc, jk, tk, jcts, tcts, _ = pair
    rng = np.random.default_rng(11)
    cts = [tc.encrypt(tk["pk"], tc.encode(rng.integers(-200, 200, tc.n))) for _ in range(3)]
    batch = tbfv.Ciphertext(torch.stack([c.data for c in cts], dim=1))  # [2, B, k, N]
    m = tc.decrypt_batch(tk["sk"], batch)
    slots = tc.decode_signed_batch(m)
    for i, c in enumerate(cts):
        assert np.array_equal(slots[i], tc.decode_signed(tc.decrypt(tk["sk"], c)))
    jm = jc.decrypt_batch(jk["sk"], jbfv.Ciphertext(jnp.asarray(convert.to_numpy(batch.data))))
    assert np.array_equal(m, jm)
    prod = tev.multiply(
        tc, tbfv.Ciphertext(tcts[0].data[:, None]), tbfv.Ciphertext(tcts[1].data[:, None])
    )
    got = tc.decode_signed_batch(tc.decrypt_batch(tk["sk"], prod))[0]
    ref = tc.decode_signed(tc.decrypt(tk["sk"], tbfv.Ciphertext(prod.data[:, 0])))
    assert np.array_equal(got, ref)


def test_decrypt_batch_large_t_does_not_wrap():
    """With k * t >= 2^32 (a 29-bit t, 9 limbs) the JAX package's u32 sum of
    quotients wraps; the port sums in int64 and equals the exact decrypt."""
    n = 256
    t = jprimes.ntt_primes(n, 29, 1)[0]
    tc = tbfv.Context(tbfv.BFVParams(n=n, t=t, data_limbs=9, seed=3), device="cpu")
    assert tc.k * tc.t >= 1 << 32
    sk = tc.keygen_secret()
    pk = tc.keygen_public(sk)
    rng = np.random.default_rng(4)
    cts = [tc.encrypt(pk, tc.encode(rng.integers(0, t, n))) for _ in range(2)]
    m = tc.decrypt_batch(sk, tbfv.Ciphertext(torch.stack([c.data for c in cts], 1)))
    for i, c in enumerate(cts):
        assert np.array_equal(m[i], tc.decrypt(sk, c).data)


@pytest.fixture(scope="module")
def t47():
    """The HCNN's 47-bit plaintext modulus at N=2048 with 13 limbs: a
    context, its keys, and two fresh ciphertexts of values across [0, t)."""
    from hhe_tpu_torch.workloads.he_conv import conv_plain_t

    tc = tbfv.Context(tbfv.BFVParams(n=2048, t=conv_plain_t(2048), data_limbs=13, seed=5),
                      device="cpu")
    assert tc.t >= 1 << 46
    sk = tc.keygen_secret()
    pk = tc.keygen_public(sk)
    rng = np.random.default_rng(6)
    vals = [rng.integers(0, tc.t, tc.n, dtype=np.int64) for _ in range(2)]
    return tc, sk, [tc.encrypt(pk, tc.encode(v)) for v in vals], vals


def test_decrypt_batch_exact_at_47_bit_t(t47):
    """t u_i outgrows int64 from t = 2^32 on: decrypt_batch splits t and
    equals the exact host decrypt per sample, also for a size-3 product."""
    tc, sk, cts, vals = t47
    m = tc.decrypt_batch(sk, tbfv.Ciphertext(torch.stack([c.data for c in cts], 1)))
    for i, c in enumerate(cts):
        assert np.array_equal(m[i], tc.decrypt(sk, c).data)
        assert np.array_equal(tc.decode_batch(m)[i], vals[i])
    prod = tev.multiply(tc, *(tbfv.Ciphertext(c.data[:, None]) for c in cts))
    got = tc.decrypt_batch(sk, prod)[0]
    assert np.array_equal(got, tc.decrypt(sk, tbfv.Ciphertext(prod.data[:, 0])).data)


def test_plain_for_add_batch_exact_at_47_bit_t(t47):
    """(Q mod t) * m wraps uint64 for t >= 2^32: plain_for_add_batch takes
    scale_plain's exact path and equals it row by row, and a ciphertext
    plus that plaintext decrypts to the sum."""
    tc, sk, cts, vals = t47
    polys = tc.encode_batch(np.stack(vals))
    got = tc.plain_for_add_batch(polys)
    for i in range(len(vals)):
        assert np.array_equal(convert.to_numpy(got[i]), tc.scale_plain(tbfv.Plaintext(polys[i])))
    summed = tev.add_plain(tc, cts[0], got[1])
    assert np.array_equal(tc.decode(tc.decrypt(sk, summed)), (vals[0] + vals[1]) % tc.t)


def test_device_keygen_decrypts():
    """Relin + galois keys from the torch generator decrypt correctly after
    a rotation and a relinearized square."""
    tc = tbfv.Context(tbfv.BFVParams(**PARAMS), device="cpu")
    sk = tc.keygen_secret()
    pk = tc.keygen_public(sk)
    g = tc.galois_elt_from_step(2)
    rk, gks = tc.keygen_eval_keys_device(sk, [g], include_relin=True, seed=9)
    v = np.random.default_rng(20).integers(0, tc.t, tc.n, dtype=np.int64)
    ct = tc.encrypt(pk, tc.encode(v))
    half = tc.n // 2
    out = tc.decode(tc.decrypt(sk, tev.rotate_rows(tc, ct, 2, gks)))
    assert np.array_equal(out, np.roll(v.reshape(2, half), -2, axis=1).reshape(-1) % tc.t)
    sq = tev.relinearize(tc, tev.square(tc, ct), rk)
    assert tc.noise_budget(sk, sq) > 0
    assert np.array_equal(tc.decode(tc.decrypt(sk, sq)), (v * v) % tc.t)


def test_context_needs_cuda_or_explicit_cpu():
    """Entry points run on the card: without one they raise rather than fall
    back, unless the caller asks for the CPU."""
    params = tbfv.BFVParams(n=256, data_limbs=2)
    if torch.cuda.is_available():
        assert tbfv.Context(params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tbfv.Context(params)
    assert tbfv.Context(params, device="cpu").device.type == "cpu"


def test_mod_switch_to_next_matches_jax(pair):
    """As test_bfv.py::test_mod_switch_to_next: after one and after two
    switches the ciphertext is bit-identical to the JAX package's and still
    decrypts to its values, down to one limb; a batched ciphertext switches
    sample by sample; a 1-limb ciphertext cannot switch."""
    jc, tc, jk, tk, jcts, tcts, vals = pair
    ct, jct = tcts[0], jcts[0]
    for level in (1, 2):
        ct, jct = tc.mod_switch_to_next(ct), jc.mod_switch_to_next(jct)
        assert tuple(ct.data.shape) == (2, tc.k - level, tc.n)
        assert ct.data.dtype == torch.int32 and same(ct.data, jct.data)
        assert np.array_equal(tc.decode(tc.decrypt(tk["sk"], ct)), vals[0])
        assert tc.noise_budget(tk["sk"], ct) > 0
    assert torch.equal(tc.mod_switch_to(tcts[0], 2).data, ct.data)
    batch = tbfv.Ciphertext(torch.stack([c.data for c in tcts], dim=1))
    lower = tc.mod_switch_to_next(batch)
    for i, c in enumerate(tcts):
        assert torch.equal(lower.data[:, i], tc.mod_switch_to_next(c).data)
    last = tc.mod_switch_to(ct, tc.k - 3)
    assert last.data.shape[-2] == 1
    assert np.array_equal(tc.decode(tc.decrypt(tk["sk"], last)), vals[0])
    with pytest.raises(ValueError, match="lowest level"):
        tc.mod_switch_to_next(last)
    with pytest.raises(AssertionError):
        jc.mod_switch_to(jct, tc.k - 2)


@pytest.mark.parametrize("levels_from_last", [0, 2, 9])
def test_cipher_size_matches_jax(pair, levels_from_last):
    """As test_bfv.py::test_cipher_size_levels_from_last_semantics: the size
    after switching to 1 + levels_from_last limbs (clamped at the
    ciphertext's own) equals the JAX package's, and so does the size without
    a switch."""
    from hhe_tpu.utils import metrics as jmetrics
    from hhe_tpu_torch.utils import metrics as tmetrics

    jc, tc, _, _, jcts, tcts, _ = pair
    got = tmetrics.cipher_size(tc, tcts[1], mod_switch=True, levels_from_last=levels_from_last)
    want = jmetrics.cipher_size(jc, jcts[1], mod_switch=True, levels_from_last=levels_from_last)
    full = tmetrics.cipher_size(tc, tcts[1])
    assert got == want and full == jmetrics.cipher_size(jc, jcts[1])
    limbs = min(1 + levels_from_last, tc.k)
    assert (got == full) == (limbs == tc.k)
    assert got < full * (limbs + 0.5) / tc.k
