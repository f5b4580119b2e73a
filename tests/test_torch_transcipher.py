"""The port's homomorphic PASTA-3 transcipher against the JAX package, array
for array, on the (N=2048, 4 limbs) stack of ``test_transcipher.py`` (CPU).

The keys are made once by the JAX package and carried to the port, so both
evaluate the same keystream on the same encrypted key.  The round constants
are made on the device from their SHAKE words; ``RC_BLOCKS`` says where
each block's were made."""

import contextlib

import numpy as np
import pytest
import torch

from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import bfv_eval as jev
from hhe_tpu.ops import pasta as jpasta
from hhe_tpu.ops import transcipher as jtr
from hhe_tpu_torch import convert
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import bfv_eval as tev
from hhe_tpu_torch.ops import ntt
from hhe_tpu_torch.ops import pasta as tpasta
from hhe_tpu_torch.ops import transcipher as ttr

CPU = torch.device("cpu")
T = ttr.T


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
    return np.array_equal(convert.to_numpy(t_obj), np.asarray(j_arr).astype(np.uint32))


@contextlib.contextmanager
def rc_blocks():
    """The growth of ``transcipher.RC_BLOCKS`` inside the block."""
    before, grew = dict(ttr.RC_BLOCKS), {}
    yield grew
    grew.update({k: v - before[k] for k, v in ttr.RC_BLOCKS.items()})


@pytest.fixture(scope="module")
def stacks():
    """The JAX make_stack(2048, 4) of test_transcipher.py and the port's
    Transcipher on the same keys, plus the encrypted PASTA key in both."""
    params = dict(n=2048, data_limbs=4, seed=11)
    jc = jbfv.Context(jbfv.BFVParams(**params))
    sk = jc.keygen_secret()
    pk = jc.keygen_public(sk)
    rk = jc.keygen_relin(sk)
    gks = jc.keygen_galois(sk, jtr.galois_elts(jc, True))
    jt = jtr.Transcipher(jc, rk, gks)
    tc = tbfv.Context(tbfv.BFVParams(**params), device="cpu")
    trk, tgks = convert.kswitch_key(rk, CPU), convert.galois_keys(gks, CPU)
    tt = ttr.Transcipher(tc, trk, tgks)
    key = jpasta.get_fixed_symmetric_key()
    jkey = jt.encrypt_key(pk, key)
    tkey = convert.ciphertext(jkey, CPU)
    return dict(jt=jt, tt=tt, sk=convert.secret_key(sk), jkey=jkey, tkey=tkey, key=key,
                jgks=gks, trk=trk, tgks=tgks, jrk=rk)


def test_galois_elts_and_bsgs_keys_match(stacks):
    jt, tt = stacks["jt"], stacks["tt"]
    assert ttr.galois_elts(tt.ctx) == jtr.galois_elts(jt.ctx)
    assert tt.use_bsgs and jt.use_bsgs and not jt.use_mxu_galois
    for name in ("baby_k0", "baby_k1", "baby_srcs", "giant_k0", "giant_k1",
                 "giant_nsrc", "giant_csrc"):
        assert same(getattr(tt, name), getattr(jt, name)), name
    assert np.array_equal(tt.giant_csign.numpy(), np.asarray(jt.giant_csign))
    assert same(tt.feistel_mask, jt.feistel_mask)


def test_expand_round_mats_match(stacks):
    """A block's SHAKE words: the first rows equal the JAX package's, and
    the expand unit's diagonals and round constants equal its expansion and
    its host round constants."""
    jt, tt = stacks["jt"], stacks["tt"]
    words = tt.block_words(jpasta.NONCE, [0, 1])
    assert tuple(words.shape) == (2, 16, T) and words.dtype == torch.int32
    for b in (0, 1):
        jrows = jt.block_first_rows(jpasta.NONCE, b)
        trows = words[b, :8]
        assert same(trows, jrows)
        assert same(tt.block_rcs(jpasta.NONCE, b), jt.block_rcs(jpasta.NONCE, b))
        assert same(tt._expand_round_mats(trows), jt._jit_expand(jrows))
        mats, rcs = tt._jit_expand(words[b])
        assert same(mats, jt._jit_expand(jrows)) and same(rcs, jt.block_rcs(jpasta.NONCE, b))


@pytest.mark.parametrize("nonce,b", [(jpasta.NONCE, 0), (jpasta.NONCE, 5), (2**40 + 17, 0),
                                     (2**31 + 9, 2)])
def test_device_round_constants_match_jax(stacks, nonce, b):
    """The round constants made on the device from their words equal the
    JAX package's host ``block_rcs`` bit for bit, and the port's."""
    jt, tt = stacks["jt"], stacks["tt"]
    got = tt._round_constants(tt.block_words(nonce, [b])[0, 8:])
    assert tuple(got.shape) == (4, tt.ctx.k, tt.ctx.n) and got.dtype == torch.int32
    assert same(got, jt.block_rcs(nonce, b))
    assert torch.equal(got, tt.block_rcs(nonce, b))


class Calls:
    """Counts the calls of the transcipher's kernel wrappers (one kernel
    launch each on the card) while the block runs."""

    NAMES = ("mont_mul", "add_mod", "neg_mod")

    def __init__(self, monkeypatch):
        self.n = {}

        def counted(name, fn):
            def call(*a, **kw):
                self.n[name] = self.n.get(name, 0) + 1
                return fn(*a, **kw)
            return call

        for name in self.NAMES:
            monkeypatch.setattr(ttr, name, counted(name, getattr(ttr, name)))
        monkeypatch.setattr(ttr.ntt, "ntt_inv", counted("ntt_inv", ttr.ntt.ntt_inv))


def test_finish_result_and_launches_unchanged(stacks, monkeypatch):
    """The finish through the shared encode-and-scale equals the JAX
    package's ``_jit_finish`` and calls K2 once, K3 once and K5 four
    times; the round constants take the same K2, K3 and K5 once each."""
    jt, tt = stacks["jt"], stacks["tt"]
    rng = np.random.default_rng(9)
    ks = rng.integers(0, 2**30, (2, tt.ctx.k, tt.ctx.n)).astype(np.uint32)
    ks %= np.asarray(tt.ctx.q_moduli, np.uint32)[:, None]
    chunk = rng.integers(0, tt.ctx.t, (3, 100)).astype(np.uint32)
    calls = Calls(monkeypatch)
    got = tt._finish_impl(torch.from_numpy(ks.view(np.int32)), torch.from_numpy(chunk.view(np.int32)))
    assert calls.n == {"ntt_inv": 1, "mont_mul": 1, "add_mod": 2, "neg_mod": 2}
    assert same(got, jt._jit_finish(ks, chunk))
    calls.n.clear()
    tt._round_constants(tt.block_words(jpasta.NONCE, [0])[0, 8:])
    assert calls.n == {"ntt_inv": 1, "mont_mul": 1, "add_mod": 1}


@pytest.mark.parametrize("use_bsgs", [True, False], ids=["bsgs", "diagonal"])
def test_linear_round_matches(stacks, use_bsgs):
    """One round's matmul + round constants + mix, BSGS and diagonal."""
    jt, tt = stacks["jt"], stacks["tt"]
    if not use_bsgs:
        jt = jtr.Transcipher(jt.ctx, jt.rk, stacks["jgks"], use_bsgs=False)
        tt = ttr.Transcipher(tt.ctx, tt.rk, stacks["tgks"], use_bsgs=False)
    jm, jr = jt.device_block_plaintexts(jpasta.NONCE, 0)
    tm, tr = tt.device_block_plaintexts(jpasta.NONCE, 0)
    jst = jt._matmul(jbfv.Ciphertext(stacks["jkey"].data), jt.round_mats(jm, 0), jt._keys())
    tst = tt._matmul(tbfv.Ciphertext(stacks["tkey"].data), tt.round_mats(tm, 0), tt._keys())
    assert same(tst.data, jst.data)
    jst = jt._mix(jev.add_plain(jt.ctx, jst, jr[0]), jt._keys())
    tst = tt._mix(tev.add_plain(tt.ctx, tst, tr[0]), tt._keys())
    assert same(tst.data, jst.data)
    # and it is PASTA's linear layer on the key
    p = np.uint64(tt.ctx.t)
    key = stacks["key"]
    mats1, mats2, rcs1, rcs2 = tpasta.block_randomness(tt.ctx.t, tpasta.NONCE, 0)
    s1 = (mats1[0] @ key[:T] + rcs1[0]) % p
    s2 = (mats2[0] @ key[T:] + rcs2[0]) % p
    tot = (s1 + s2) % p
    got = tt.ctx.decode(tt.ctx.decrypt(stacks["sk"], tst))
    half = tt.ctx.n // 2
    assert np.array_equal(got[:T], (s1 + tot) % p)
    assert np.array_equal(got[half : half + T], (s2 + tot) % p)


def test_sbox_feistel_matches(stacks):
    jt, tt = stacks["jt"], stacks["tt"]
    jst = jt._sbox_feistel(jbfv.Ciphertext(stacks["jkey"].data), jt._keys())
    tst = tt._sbox_feistel(tbfv.Ciphertext(stacks["tkey"].data), tt._keys())
    assert same(tst.data, jst.data)


def test_keystream_ct_matches(stacks):
    """The full 3-round keystream ciphertext.  (The 4-limb chain has no noise
    budget left after three rounds, in either package, so decryption of the
    keystream is checked on the 13-limb stack of test_torch_workloads.py.)"""
    jt, tt = stacks["jt"], stacks["tt"]
    jks = jt.keystream_ct(stacks["jkey"], jpasta.NONCE, 0)
    tks = tt.keystream_ct(stacks["tkey"], tpasta.NONCE, 0)
    assert same(tks.data, jks.data)
    assert tt.keystream_ct(stacks["tkey"], tpasta.NONCE, 0) is tks  # cached


def test_keystream_ct_host_expansion_matches(stacks):
    """keystream_ct, from the round material made on the device, equals the
    JAX package's keystream built from its host expansion
    (``expand_on_device=False``), and caches the material under (nonce, b)."""
    jt, tt = stacks["jt"], stacks["tt"]
    nonce = tpasta.NONCE + 5
    want = jt.keystream_ct(stacks["jkey"], nonce, 0, expand_on_device=False)
    assert (nonce, 0, True) in jt._pt_cache  # the JAX package's host bundle
    got = tt.keystream_ct(stacks["tkey"], nonce, 0)
    assert (nonce, 0) in tt._pt_cache
    assert same(got.data, want.data)


@pytest.mark.parametrize("use_bsgs", [True, False], ids=["bsgs", "diagonal"])
def test_block_plaintexts_match(stacks, use_bsgs):
    """The device round material (device_block_plaintexts), read through
    round_mats, equals the JAX package's host expansion (block_plaintexts)
    round for round in both modes; its round constants equal the JAX
    package's block_rcs; it is cached under (nonce, b)."""
    jt, tt = stacks["jt"], stacks["tt"]
    if not use_bsgs:
        jt = jtr.Transcipher(jt.ctx, jt.rk, stacks["jgks"], use_bsgs=False)
        tt = ttr.Transcipher(tt.ctx, tt.rk, stacks["tgks"], use_bsgs=False)
    jm, _ = jt.block_plaintexts(jpasta.NONCE, 1)
    tm, tr = tt.device_block_plaintexts(tpasta.NONCE, 1)
    assert tt.device_block_plaintexts(tpasta.NONCE, 1) is tt._pt_cache[(tpasta.NONCE, 1)]
    assert same(tr, jt.block_rcs(jpasta.NONCE, 1))
    for r in range(4):
        want, got = jt.round_mats(jm, r), tt.round_mats(tm, r)
        for w, g in zip(want, got) if use_bsgs else [(want, got)]:
            assert same(g, w), r


def test_keystream_blocks_match(stacks):
    """Two uncached blocks take the seeded path (round material expanded
    inside each evaluation); each equals the JAX package's keystream_ct."""
    jt, tt = stacks["jt"], stacks["tt"]
    nonce = tpasta.NONCE + 3
    uploads = dict(ntt.UPLOADS)
    with rc_blocks() as made:
        tks = tt.keystream_blocks(stacks["tkey"], nonce, [0, 1])
    assert made == {"device": 2, "host": 0}
    # both blocks' SHAKE words in one upload
    assert ntt.UPLOADS["calls"] - uploads["calls"] == 1
    assert ntt.UPLOADS["bytes"] - uploads["bytes"] == 2 * 16 * T * 4
    assert (nonce, 0) not in tt._pt_cache
    for b in (0, 1):
        assert same(tks[b].data, jt.keystream_ct(stacks["jkey"], nonce, b).data), b


def test_decompose_matches(stacks):
    """decompose of a B=2 batch at a fresh nonce equals the JAX package's."""
    jt, tt = stacks["jt"], stacks["tt"]
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (2, T), dtype=np.uint64)
    nonce = tpasta.NONCE + 7
    sym = tpasta.Pasta(stacks["key"], tt.ctx.t).encrypt(x, nonce=nonce)
    jres = jt.decompose(stacks["jkey"], sym, nonce=nonce)
    with rc_blocks() as made:
        tres = tt.decompose(stacks["tkey"], sym, nonce=nonce)
    assert made == {"device": 1, "host": 0}
    assert len(tres) == len(jres) == 1
    assert tuple(tres[0].data.shape) == (2, 2, tt.ctx.k, tt.ctx.n)
    assert same(tres[0].data, jres[0].data)
    one = tt.decompose(stacks["tkey"], sym[0], nonce=nonce)  # unbatched input
    assert torch.equal(one[0].data, tres[0].data[:, 0])


def test_round_constants_path_follows_t(stacks):
    """At t = 65537 a block's round constants are made on the device, equal
    to the host's; a t the device's arithmetic cannot hold builds no
    Transcipher, as no device path can encode there: the 47-bit
    ``conv_plain_t`` (K2 at t wants t below 2^31), and a 31-bit t above twice
    the smallest q_i (one conditional subtract no longer reduces fix < t)."""
    from hhe_tpu_torch.workloads.he_conv import conv_plain_t

    def build(t):
        ctx = tbfv.Context(tbfv.BFVParams(n=256, t=t, data_limbs=3, seed=3), device="cpu")
        sk = ctx.keygen_secret()
        return ctx, lambda: ttr.Transcipher(
            ctx, ctx.keygen_relin(sk), ctx.keygen_galois(sk, ttr.galois_elts(ctx, False)),
            use_bsgs=False)

    tt = stacks["tt"]
    assert tt.ctx.t == 65537
    with rc_blocks() as made:
        _, rcs = tt.device_block_plaintexts(tpasta.NONCE + 11, 1)
    assert made == {"device": 1, "host": 0}
    with rc_blocks() as made:
        assert torch.equal(rcs, tt.block_rcs(tpasta.NONCE + 11, 1))
    assert made == {"device": 0, "host": 1}

    _, make = build(conv_plain_t(256))
    with pytest.raises(ValueError, match="below 2"):
        make()
    ctx, make = build(2147483137)  # prime, 1 mod 512, below 2^31
    assert 2 * min(ctx.q_moduli) < ctx.t < 2**31
    with pytest.raises(ValueError, match="twice the smallest q_i"):
        make()
