"""The port's 2FC and multi-class FC evaluations through the transcipher,
and its full-dataset ECG run, against the JAX package on the ``stack300``
parameters of ``test_workloads.py`` (N=1024, 13 limbs, seed 42), built by
each package from the same ``BFVParams`` (CPU).  Randomness is drawn in the
same order in both packages, so ciphertexts compare bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.models import loaders as jloaders
from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import helin as jhelin
from hhe_tpu.ops import pasta as jpasta
from hhe_tpu.utils.config import RunConfig as JRunConfig
from hhe_tpu.workloads import hhe_inference as jwk
from hhe_tpu_torch import convert
from hhe_tpu_torch.models import pocketnn as tpk
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import helin as thelin
from hhe_tpu_torch.utils.config import RunConfig
from hhe_tpu_torch.workloads import hhe_inference as twk

PARAMS = dict(n=1024, data_limbs=13, seed=42)
L, R, C = 300, 4, 10  # words per sample (three PASTA blocks), hidden rows, classes


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test worker (see test_torch_workloads.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def same(t_obj, j_arr):
    return np.array_equal(convert.to_numpy(t_obj), np.asarray(j_arr).astype(np.uint32))


def reseed(*stacks, seed=77):
    for st in stacks:
        st.ctx.rng = np.random.default_rng(seed)


def signed(v, t):
    v = v % t
    return np.where(v > t // 2, v - t, v)


@pytest.fixture(scope="module")
def stacks():
    jst = jwk.build_stack(jbfv.BFVParams(**PARAMS), input_len=L)
    tst = twk.build_stack(tbfv.BFVParams(**PARAMS), input_len=L, device="cpu")
    return jst, tst


@pytest.fixture(scope="module")
def decomposed(stacks):
    """Two 2-bit surrogate images of 300 words through the port's
    transcipher (three blocks, mask, flatten), and the same batch as a JAX
    ciphertext."""
    _, tst = stacks
    x = np.random.default_rng(6).integers(0, 5, (2, L))
    key = jpasta.get_fixed_symmetric_key()
    sym = jpasta.Pasta(key, tst.ctx.t).encrypt(x.astype(np.uint64))
    reseed(tst, seed=5)
    tdata = twk.csp_decompose(tst, tst.tc.encrypt_key(tst.pk, key), sym)
    assert tuple(tdata.data.shape) == (2, 2, tst.ctx.k, tst.ctx.n)
    return x, tdata, jbfv.Ciphertext(jnp.asarray(convert.to_numpy(tdata.data)))


def encrypted_rows(stacks, w):
    """The rows of w.T encrypted by each package on the same draws."""
    jst, tst = stacks
    reseed(jst, tst)
    jcts = jhelin.encrypt_weight(jst.ctx, jst.pk, w.T)
    tcts = thelin.encrypt_weight(tst.ctx, tst.pk, w.T)
    assert all(same(t.data, j.data) for t, j in zip(tcts, jcts))
    return jcts, tcts


def check_parity_if_budget(tst, ct, want):
    """Bit identity needs no noise budget; the logits are compared with the
    plaintext model only while the first class ct keeps some."""
    budget = tst.ctx.noise_budget(tst.sk, tbfv.Ciphertext(ct.data[:, 0, 0]))
    if budget > 0:
        assert np.array_equal(twk.decrypt_2fc_logits(tst, ct), want)
    return budget


def test_csp_eval_2fc_through_transcipher(stacks, decomposed):
    """300 -> 4 -> square -> 10 on a decomposed batch: the logits
    ciphertext [2, B, C, k, N] is bit-identical to the JAX package's."""
    jst, tst = stacks
    x, tdata, jdata = decomposed
    rng = np.random.default_rng(8)
    w1 = rng.integers(-2, 2, (L, R))  # 2-bit signed, as the QAT weights
    w2 = rng.integers(-2, 2, (R, C))
    jw1, tw1 = encrypted_rows(stacks, w1)
    got = twk.csp_eval_2fc(tst, tdata, tw1, w2, row_chunk=3)
    want = jwk.csp_eval_2fc(jst, jdata, jw1, w2)
    assert tuple(got.data.shape) == (2, 2, C, tst.ctx.k, tst.ctx.n)
    assert same(got.data, want.data)
    t = tst.ctx.t
    v1 = (x @ w1) % t
    check_parity_if_budget(tst, got, signed((v1 * v1) % t @ w2, t))


def test_csp_eval_fc_multi_through_transcipher(stacks, decomposed):
    """300 -> 10 with bias on a decomposed batch: the class-batched
    ciphertext is bit-identical to the JAX package's and decrypts to the
    plaintext layer's logits mod t."""
    jst, tst = stacks
    x, tdata, jdata = decomposed
    rng = np.random.default_rng(9)
    w = rng.integers(-128, 129, (L, C))
    bias = rng.integers(-128, 129, C)
    jw, tw = encrypted_rows(stacks, w)
    got = twk.csp_eval_fc_multi(tst, tdata, tw, bias)
    want = jwk.csp_eval_fc_multi(jst, jdata, jw, bias)
    assert tuple(got.data.shape) == (2, 2, C, tst.ctx.k, tst.ctx.n)
    assert same(got.data, want.data)
    assert check_parity_if_budget(tst, got, signed(x @ w + bias, tst.ctx.t)) > 0


def test_hhe_ecg_full_inference_matches_jax(stacks, tmp_path, monkeypatch):
    """The full-dataset ECG run, sized from a 13,245-row label file and
    capped by RunConfig's dry run at 3 samples in chunks of 2 (one padded
    row): the same predictions, agreement 1.0, sample count and message
    sizes as the JAX function on the same files."""
    jst, tst = stacks
    rng = np.random.default_rng(12)
    wcsv = str(tmp_path / "fc1_weight_50epochs_bz4.csv")
    tpk.save_csv_matrix(wcsv, rng.integers(-508, 509, (128, 1)))
    np.savetxt(tmp_path / "mitbih_bin_y_test.csv", rng.integers(0, 2, 13245), fmt="%d")
    orig = jloaders.load_mitbih_labels
    monkeypatch.setattr(
        jloaders, "load_mitbih_labels",
        lambda split="test", balanced=False, root=None: orig(split, balanced, str(tmp_path)),
    )
    reseed(jst, tst)
    out = twk.hhe_ecg_full_inference(
        tst, wcsv, batch=2, run=RunConfig(dry_run=True, dry_run_num_samples=3),
        labels_root=str(tmp_path),
    )
    jout = jwk.hhe_ecg_full_inference(
        jst, wcsv, batch=2, run=JRunConfig(dry_run=True, dry_run_num_samples=3)
    )
    assert out["agreement"] == jout["agreement"] == 1.0
    assert np.array_equal(out["predictions"], jout["predictions"])
    assert len(out["predictions"]) == 3
    rep, jrep = out["report"], jout["report"]
    assert rep["samples"] == jrep["samples"] == 3
    assert rep["communication_mb"] == jrep["communication_mb"]
    assert rep["label_accuracy"] == jrep["label_accuracy"]
    assert set(rep["computation_ms"]) == {"user", "analyst", "csp", "total"}
    assert "not meaningful" in rep["label_accuracy_note"]
