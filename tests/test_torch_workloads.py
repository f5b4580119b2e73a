"""The port's encrypted ECG and SpO2 (1FC) pipelines against the JAX
package, on the ``stack300`` parameters of ``test_workloads.py`` (N=1024,
13 limbs, seed 42), built by each package from the same ``BFVParams`` (CPU);
and ``RunConfig`` / ``Config`` wiring."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.models import pocketnn as jpk
from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import helin as jhelin
from hhe_tpu.ops import pasta as jpasta
from hhe_tpu.ops import transcipher as jtr
from hhe_tpu.utils import config as jconfig
from hhe_tpu.workloads import hhe_inference as jwk
from hhe_tpu_torch import convert
from hhe_tpu_torch.models import pocketnn as tpk
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import helin as thelin
from hhe_tpu_torch.ops import transcipher as ttr
from hhe_tpu_torch.utils import checks
from hhe_tpu_torch.utils.config import Config, HEConfig, RunConfig
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


def test_hhe_1fc_inference_matches_jax(stacks, capsys):
    """The SpO2-style pipeline of test_workloads.py::test_hhe_1fc_inference_parity
    (300 words: three blocks, mask, flatten, ct x ct, log-depth sum): the
    same raw outputs, predictions and message sizes as the JAX package, and
    ciphertexts bit-identical to the JAX package's pipeline run step by
    step on the same draws; with RunConfig's debugging and verbose on, the
    stage noise budgets and the report are printed."""
    jst, tst = stacks
    rng = np.random.default_rng(0)
    w = rng.integers(-3, 4, 300)
    x = rng.integers(0, 32, (2, 300))
    tst.ctx.rng = np.random.default_rng(77)
    run = RunConfig(dry_run=False, debugging=True, verbose=True)
    out = twk.hhe_1fc_inference(tst, w, x, check_parity=True, run=run)
    logs = capsys.readouterr().out  # the debug stages and the experiment report
    assert "noise budget after decomposition+flatten" in logs
    assert "noise budget after encrypted FC + vec_sum" in logs
    assert "EXPERIMENT RESULTS" in logs and "csp time" in logs
    jst.ctx.rng = np.random.default_rng(77)
    jout = jwk.hhe_1fc_inference(jst, w, x, check_parity=True)
    expect_raw = x.astype(np.int64) @ w
    assert np.array_equal(out["raw"], expect_raw) and np.array_equal(out["raw"], jout["raw"])
    assert np.array_equal(out["predictions"], jout["predictions"])
    assert np.array_equal(out["predictions"], (expect_raw > 0).astype(int))
    rep, jrep = out["report"], jout["report"]
    assert rep["communication_mb"] == jrep["communication_mb"]
    assert set(rep["computation_ms"]) == set(jrep["computation_ms"]) == {
        "user", "analyst", "csp", "total"}

    # the pipeline's steps, drawing in hhe_1fc_inference's order in each
    # package: the decomposed batch and the summed product are bit-identical
    jst.ctx.rng = np.random.default_rng(77)
    tst.ctx.rng = np.random.default_rng(77)
    jc, tc = jst.ctx, tst.ctx
    key = jpasta.get_fixed_symmetric_key()
    sym = jpasta.Pasta(key, jc.t).encrypt(x.astype(np.uint64))
    enc_key = jst.tc.encrypt_key(jst.pk, key)
    tenc_key = tst.tc.encrypt_key(tst.pk, key)
    weight_ct = jhelin.encrypt_weight(jc, jst.pk, w[None, :])[0]
    tweight_ct = thelin.encrypt_weight(tc, tst.pk, w[None, :])[0]
    data_ct = jwk.csp_decompose(jst, enc_key, sym)
    tdata_ct = twk.csp_decompose(tst, tenc_key, sym)
    assert same(tdata_ct.data, data_ct.data)
    res = jwk.csp_eval_1fc(jst, data_ct, jbfv.Ciphertext(weight_ct.data[:, None]), do_sum=True)
    tres = twk.csp_eval_1fc(tst, tdata_ct, tbfv.Ciphertext(tweight_ct.data[:, None]), do_sum=True)
    assert same(tres.data, res.data)
    with pytest.raises(ValueError, match="weights"):
        twk.hhe_1fc_inference(tst, w[:-1], x)


def test_run_config_dry_run_and_debugging(stacks, capsys):
    """RunConfig wiring, as test_workloads.py::test_run_config_dry_run_and_debugging:
    dry_run caps the processed samples; debugging prints per-stage noise
    budgets; with dry_run off the whole batch runs and nothing is printed."""
    _, tst = stacks
    rng = np.random.default_rng(5)
    w = rng.integers(-2, 3, 128)
    x = rng.integers(0, 64, (5, 128))
    run = RunConfig(dry_run=True, dry_run_num_samples=2, debugging=True)
    out = twk.hhe_ecg_inference(tst, w, x, run=run)
    assert len(out["predictions"]) == 2
    logs = capsys.readouterr().out
    assert "noise budget after decomposition" in logs
    assert "noise budget after encrypted weight product" in logs

    run = RunConfig(dry_run=False, debugging=False)
    out = twk.hhe_ecg_inference(tst, w, x, run=run)
    assert len(out["predictions"]) == 5
    assert "noise budget" not in capsys.readouterr().out


@pytest.mark.parametrize("n1,n2", [(16, 8), (128, 1)])
def test_build_stack_with_config_matches_jax(n1, n2):
    """build_stack(config=...) takes the HE parameters and the BSGS split
    (16 x 8 is the reference's N1, N2; 128 x 1 has no giantsteps) from the
    config, as the JAX package does: the same keys, and one BSGS linear
    round bit-identical."""
    he = dict(mod_degree=1024, data_modulus_bits=120, bsgs_n1=n1, bsgs_n2=n2)
    jst = jwk.build_stack(input_len=128, seed=4, config=jconfig.Config(he=jconfig.HEConfig(**he)))
    tst = twk.build_stack(input_len=128, seed=4, config=Config(he=HEConfig(**he)), device="cpu")
    assert (tst.ctx.n, tst.ctx.k) == (1024, 4)
    assert (tst.tc.n1, tst.tc.n2, tst.tc.use_bsgs) == (n1, n2, True)
    assert sorted(tst.gks) == sorted(jst.gks)
    assert ttr.galois_elts(tst.ctx, True, n1, n2) == jtr.galois_elts(jst.ctx, True, n1, n2)
    assert same(tst.tc.baby_k0, jst.tc.baby_k0) and same(tst.tc.baby_srcs, jst.tc.baby_srcs)
    if n2 > 1:
        for name in ("giant_k1", "giant_nsrc", "giant_csrc"):
            assert same(getattr(tst.tc, name), getattr(jst.tc, name)), name
    key = jpasta.get_fixed_symmetric_key()
    tkey = tst.tc.encrypt_key(tst.pk, key)
    jkey = jst.tc.encrypt_key(jst.pk, key)
    assert same(tkey.data, jkey.data)
    tm, _ = tst.tc.device_block_plaintexts(jpasta.NONCE, 0)
    jm, _ = jst.tc.device_block_plaintexts(jpasta.NONCE, 0)
    got = tst.tc._matmul(tkey, tst.tc.round_mats(tm, 0), tst.tc._keys())
    want = jst.tc._matmul(jbfv.Ciphertext(jkey.data), jst.tc.round_mats(jm, 0), jst.tc._keys())
    assert same(got.data, want.data)
    with pytest.raises(ValueError, match="BSGS"):
        ttr.Transcipher(tst.ctx, tst.rk, tst.gks, n1=16, n2=4)
