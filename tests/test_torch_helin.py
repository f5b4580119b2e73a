"""The port's HE linear-algebra helpers against the JAX package (CPU), on a
small context with the flatten and vec-sum rotation keys."""

import numpy as np
import pytest
import torch

from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import helin as jhelin
from hhe_tpu_torch import convert
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import helin as thelin

CPU = torch.device("cpu")
PARAMS = dict(n=256, data_limbs=3, seed=5)
BLOCK = 16


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


@pytest.fixture(scope="module")
def pair():
    """Both contexts from the same params; every key and ciphertext is made
    by both packages from the same draws and checked equal once."""
    jc = jbfv.Context(jbfv.BFVParams(**PARAMS))
    tc = tbfv.Context(tbfv.BFVParams(**PARAMS), device="cpu")
    keys = []
    for c, h in ((jc, jhelin), (tc, thelin)):
        sk = c.keygen_secret()
        pk = c.keygen_public(sk)
        elts = sorted(
            set(h.flatten_galois_elts(c, 3, BLOCK)) | set(h.vec_sum_galois_elts(c))
            | {c.galois_elt_from_step(-1)}
        )
        keys.append((sk, pk, c.keygen_galois(sk, elts)))
    assert sorted(keys[0][2]) == sorted(keys[1][2])
    return jc, tc, keys[0], keys[1]


def test_weight_and_bias_roundtrip_match(pair):
    jc, tc, (jsk, jpk, _), (tsk, tpk, _) = pair
    rng = np.random.default_rng(0)
    w = rng.integers(-100, 100, (2, 40))
    jw, tw = jhelin.encrypt_weight(jc, jpk, w), thelin.encrypt_weight(tc, tpk, w)
    assert all(same(t.data, j.data) for t, j in zip(tw, jw))
    assert np.array_equal(thelin.decrypt_weight(tc, tsk, tw, 40), w)
    b = np.array([-7, 0, 12])
    jb, tb = jhelin.encrypt_bias(jc, jpk, b), thelin.encrypt_bias(tc, tpk, b)
    assert all(same(t.data, j.data) for t, j in zip(tb, jb))
    assert np.array_equal(thelin.decrypt_bias(tc, tsk, tb), b)


def test_mask_flatten_and_sums_match(pair):
    jc, tc, (jsk, jpk, jg), (tsk, tpk, tg) = pair
    rng = np.random.default_rng(1)
    vals = [rng.integers(0, 50, BLOCK) for _ in range(3)]
    jcts = [jc.encrypt(jpk, jc.encode(v)) for v in vals]
    tcts = [tc.encrypt(tpk, tc.encode(v)) for v in vals]
    assert all(same(t.data, j.data) for t, j in zip(tcts, jcts))

    jm, tm = jhelin.make_mask(jc, 5), thelin.make_mask(tc, 5)
    assert same(tm, jm)
    assert same(thelin.mask(tc, tcts[0], tm).data, jhelin.mask(jc, jcts[0], jm).data)

    flat = thelin.flatten(tc, tcts, tg, BLOCK)
    assert same(flat.data, jhelin.flatten(jc, jcts, jg, BLOCK).data)
    got = tc.decode(tc.decrypt(tsk, flat))[: 3 * BLOCK]
    assert np.array_equal(got, np.concatenate(vals))

    s = thelin.encrypted_vec_sum(tc, tcts[0], tg, BLOCK)
    assert same(s.data, jhelin.encrypted_vec_sum(jc, jcts[0], jg, BLOCK).data)
    assert tc.decode(tc.decrypt(tsk, s))[BLOCK - 1] == vals[0].sum()
    s = thelin.encrypted_vec_sum_log(tc, tcts[0], tg)
    assert same(s.data, jhelin.encrypted_vec_sum_log(jc, jcts[0], jg).data)
    assert (tc.decode(tc.decrypt(tsk, s))[: tc.n // 2] == vals[0].sum()).all()
