"""The port's encrypted ECG pipeline against the JAX package, on the
``stack300`` parameters of ``test_workloads.py`` (N=1024, 13 limbs, seed 42),
built by each package from the same ``BFVParams`` (CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.models import pocketnn as jpk
from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import helin as jhelin
from hhe_tpu.ops import pasta as jpasta
from hhe_tpu.workloads import hhe_inference as jwk
from hhe_tpu_torch import convert
from hhe_tpu_torch.models import pocketnn as tpk
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import transcipher as ttr
from hhe_tpu_torch.utils import checks
from hhe_tpu_torch.workloads import hhe_inference as twk

PARAMS = dict(n=1024, data_limbs=13, seed=42)


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
def stacks():
    jst = jwk.build_stack(jbfv.BFVParams(**PARAMS), input_len=300)
    tst = twk.build_stack(tbfv.BFVParams(**PARAMS), input_len=300, device="cpu")
    return jst, tst


def test_build_stack_keys_match(stacks):
    jst, tst = stacks
    assert np.array_equal(tst.sk.s_q, jst.sk.s_q)
    assert np.array_equal(tst.pk.data, jst.pk.data)
    assert same(tst.rk.k0, jst.rk.k0) and same(tst.rk.k1, jst.rk.k1)
    assert sorted(tst.gks) == sorted(jst.gks)
    g = max(jst.gks)
    assert same(tst.gks[g].k0, jst.gks[g].k0) and same(tst.gks[g].k1, jst.gks[g].k1)
    assert np.array_equal(tst.csp_sk.s_q, jst.csp_sk.s_q)
    with pytest.raises(checks.CheckFailed):
        checks.are_same_he_sk(tst.sk, tst.sk)


def test_hhe_ecg_inference_matches_jax(stacks):
    """The inputs of test_workloads.py::test_hhe_ecg_inference: the decomposed
    batch and the FC product are bit-identical to the JAX package's, and the
    predictions equal the JAX package's and the plaintext model's."""
    jst, tst = stacks
    rng = np.random.default_rng(1)
    w = rng.integers(-2, 3, 128)
    x = rng.integers(0, 64, (2, 128))
    out = twk.hhe_ecg_inference(tst, w, x)

    # the JAX package's pipeline step by step, drawing its randomness in the
    # same order as hhe_ecg_inference does (key encryption, then weights)
    jc = jst.ctx
    key = jpasta.get_fixed_symmetric_key()
    sym = jpasta.Pasta(key, jc.t).encrypt(x.astype(np.uint64))
    enc_key = jst.tc.encrypt_key(jst.pk, key)
    weight_ct = jhelin.encrypt_weight(jc, jst.pk, w[None, :])[0]
    data_ct = jwk.csp_decompose(jst, enc_key, sym)
    assert same(out["data_ct"].data, data_ct.data)
    prod = jwk.csp_eval_1fc(
        jst, data_ct, jbfv.Ciphertext(weight_ct.data[:, None]), do_sum=False
    )
    assert same(out["prod_ct"].data, prod.data)
    jpreds = jwk.analyst_decrypt_sum_sigmoid(jst, prod, 128)
    assert np.array_equal(out["predictions"], jpreds)

    sums = (x.astype(np.int64) * w).sum(1)
    expect = [128 if int(jpk.simple_pocket_sigmoid(int(s))) > 64 else 0 for s in sums]
    assert out["predictions"].tolist() == expect

    # every decomposed sample decrypts to its input, with budget to spare
    tc = tst.ctx
    for i in range(2):
        ct = tbfv.Ciphertext(out["data_ct"].data[:, i])
        assert np.array_equal(tc.decode(tc.decrypt(tst.sk, ct))[: ttr.T], x[i])
        assert tc.noise_budget(tst.sk, ct) >= 40

    # per-round noise telemetry: non-increasing, ending at the keystream's
    tenc = convert.ciphertext(enc_key, "cpu")
    budgets = tst.tc.keystream_round_budgets(tenc, tst.sk)
    assert all(b1 >= b2 for b1, b2 in zip(budgets, budgets[1:])), budgets
    ks = tst.tc.keystream_ct(tenc, jpasta.NONCE, 0)
    assert budgets[-1] == tc.noise_budget(tst.sk, ks) >= 40
    want = jpasta.keystream(key, tc.t, jpasta.NONCE, 0)
    assert np.array_equal(tc.decode(tc.decrypt(tst.sk, ks))[: ttr.T], want)


def test_decrypt_slots_and_sigmoids_match(stacks):
    """The analyst's decrypt paths (batched and per sample) and the integer
    sigmoids equal the JAX package's."""
    jst, tst = stacks
    tc = tst.ctx
    rng = np.random.default_rng(3)
    vals = rng.integers(-400, 400, (3, tc.n))
    cts = [tc.encrypt(tst.pk, tc.encode(v)) for v in vals]
    batch = tbfv.Ciphertext(torch.stack([c.data for c in cts], 1))
    slots = twk._decrypt_signed_slots(tst, batch)
    assert np.array_equal(slots, vals)
    assert np.array_equal(twk._decrypt_signed_slots(tst, cts[0])[0], vals[0])
    raw, preds = twk.analyst_decrypt_slot_sigmoid(tst, batch, 5)
    jbatch = jbfv.Ciphertext(jnp.asarray(convert.to_numpy(batch.data)))
    jraw, jpreds = jwk.analyst_decrypt_slot_sigmoid(jst, jbatch, 5)
    assert np.array_equal(raw, jraw) and np.array_equal(raw, vals[:, 4])
    assert np.array_equal(preds, jpreds)
    s = np.arange(-3000, 3000, 7)
    assert np.array_equal(
        tpk.simple_pocket_sigmoid(s).numpy(), np.asarray(jpk.simple_pocket_sigmoid(s))
    )
    assert np.array_equal(tpk.int_sigmoid(s).numpy(), np.asarray(jpk.int_sigmoid(s)))
