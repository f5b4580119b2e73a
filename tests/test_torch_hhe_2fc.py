"""The port's MNIST 2FC and FashionMNIST FC workloads against the JAX package
without the transcipher (inputs BFV-encrypted directly), on the N=2048 /
5-limb contexts of ``test_workloads.py`` (CPU): each package builds its
stack from the same ``BFVParams`` and draws its encryption randomness in the
same order, so the ciphertexts, logits and reports compare bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.models import pocketnn as jpk
from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import helin as jhelin
from hhe_tpu.workloads import hhe_inference as jwk
from hhe_tpu_torch import convert
from hhe_tpu_torch.models import pocketnn as tpk
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import helin as thelin
from hhe_tpu_torch.workloads import hhe_inference as twk

PARAMS_2FC = dict(n=2048, data_limbs=5, seed=3)  # test_workloads.py::test_hhe_2fc_inference
PARAMS_FMNIST = dict(n=2048, data_limbs=5, seed=7)  # ::test_hhe_fmnist_shipped_weights
RNG_SEED = 77  # both contexts' encryption randomness, reset before each run


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test worker (see test_torch_workloads.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def same(t_obj, j_arr):
    return np.array_equal(convert.to_numpy(t_obj), np.asarray(j_arr).astype(np.uint32))


def reseed(*stacks):
    for st in stacks:
        st.ctx.rng = np.random.default_rng(RNG_SEED)


@pytest.fixture(scope="module")
def net():
    """784 -> 8 -> 10 weights and two sparse binary inputs, drawn as
    test_workloads.py::test_hhe_2fc_inference draws them (R = 8 here)."""
    rng = np.random.default_rng(2)
    in_dim, R = 784, 8
    w1 = rng.integers(-1, 2, (in_dim, R)) * (rng.random((in_dim, R)) < 0.05)
    w2 = rng.integers(-2, 3, (R, 10))
    x = (rng.random((2, in_dim)) < 0.1).astype(np.int64)
    return w1, w2, x


@pytest.fixture(scope="module")
def stacks():
    jst = jwk.build_stack(jbfv.BFVParams(**PARAMS_2FC), input_len=128)
    tst = twk.build_stack(tbfv.BFVParams(**PARAMS_2FC), input_len=128, device="cpu")
    return jst, tst


@pytest.fixture(scope="module")
def direct(stacks, net):
    """The encrypted weight rows and inputs, drawn in hhe_2fc_inference's
    order by each package, the JAX package's logits ciphertext and the
    port's (one pass)."""
    jst, tst = stacks
    w1, w2, x = net
    reseed(jst, tst)
    jw1 = jhelin.encrypt_weight(jst.ctx, jst.pk, w1.T)
    jdata = jbfv.Ciphertext(
        jnp.asarray(np.stack([np.asarray(jst.ctx.encrypt(jst.pk, jst.ctx.encode(s)).data)
                              for s in x], axis=1))
    )
    tw1 = thelin.encrypt_weight(tst.ctx, tst.pk, w1.T)
    tdata = twk._encrypt_samples(tst, x)
    assert same(tdata.data, jdata.data)
    assert all(same(t.data, j.data) for t, j in zip(tw1, jw1))
    return tw1, tdata, jwk.csp_eval_2fc(jst, jdata, jw1, w2), twk.csp_eval_2fc(tst, tdata, tw1, w2)


def plain_logits(x, w1, w2, t):
    v1 = (x @ w1) % t
    out = ((v1 * v1) % t @ w2) % t
    return np.where(out > t // 2, out - t, out)


@pytest.mark.parametrize(
    "chunks", [{}, {"row_chunk": 3}, {"digit_chunk": 2}], ids=["one_pass", "row_chunk3", "digit_chunk2"]
)
def test_csp_eval_2fc_bit_identical(stacks, net, direct, chunks):
    """csp_eval_2fc's logits ciphertext [2, B, C, k, N] equals the JAX
    package's, in one pass and with the rows (8 = 3 + 3 + 2) or the
    key-switch digits in chunks; and it decrypts to the plaintext network's
    logits mod t."""
    _, tst = stacks
    w1, w2, x = net
    tw1, tdata, jlogits, one_pass = direct
    got = twk.csp_eval_2fc(tst, tdata, tw1, w2, **chunks) if chunks else one_pass
    assert tuple(got.data.shape) == (2, 2, 10, tst.ctx.k, tst.ctx.n)
    assert same(got.data, jlogits.data)
    logits = twk.decrypt_2fc_logits(tst, got)
    assert np.array_equal(logits, plain_logits(x, w1, w2, tst.ctx.t))


def test_hhe_2fc_inference_matches_jax(stacks, net):
    """hhe_2fc_inference without the transcipher, its rows in chunks of 5:
    the same logits and predictions as the JAX package, equal to the
    plaintext network mod t, and the accuracy against labels."""
    jst, tst = stacks
    w1, w2, x = net
    reseed(jst, tst)
    labels = plain_logits(x, w1, w2, tst.ctx.t).argmax(1)
    labels[1] = (labels[1] + 1) % 10
    out = twk.hhe_2fc_inference(
        tst, w1, w2, x, labels=labels, via_transcipher=False, check_parity=True, row_chunk=5
    )
    jout = jwk.hhe_2fc_inference(jst, w1, w2, x, via_transcipher=False, check_parity=True)
    assert np.array_equal(out["logits"], jout["logits"])
    assert np.array_equal(out["predictions"], jout["predictions"])
    assert np.array_equal(out["logits"], plain_logits(x, w1, w2, tst.ctx.t))
    assert np.array_equal(out["predictions"], out["logits"].argmax(1))
    assert out["accuracy"] == 0.5


def test_decrypt_2fc_logits_branches_agree(stacks, net, direct):
    """decrypt_2fc_logits' batched branch (one decrypt_batch over the (B, C)
    grid) and its per-ciphertext branch (taken below the full level, here
    after one mod_switch_to_next) give the same logits; so does an
    unbatched [2, C, k, N] ciphertext."""
    _, tst = stacks
    w1, w2, x = net
    logits_ct = direct[3]
    batched = twk.decrypt_2fc_logits(tst, logits_ct)
    lower = tst.ctx.mod_switch_to_next(logits_ct)
    assert lower.data.shape[-2] == tst.ctx.k - 1
    assert np.array_equal(twk.decrypt_2fc_logits(tst, lower), batched)
    one = twk.decrypt_2fc_logits(tst, tbfv.Ciphertext(logits_ct.data[:, 1]))
    assert np.array_equal(one, batched[1:])
    assert np.array_equal(batched, plain_logits(x, w1, w2, tst.ctx.t))


def test_fc2_scalar_consts_match_jax(stacks):
    """The vectorised Montgomery |w2| and sign mask equal the JAX package's
    per-entry loop."""
    jst, tst = stacks
    w2 = np.random.default_rng(4).integers(-3, 4, (6, 10))
    w2[0, 0] = 0
    mont, neg = twk._fc2_scalar_consts(tst.ctx, w2)
    jmont, jneg = jwk._fc2_scalar_consts(jst.ctx, w2)
    assert tuple(mont.shape) == (6, 10, tst.ctx.k, 1)
    assert same(mont, jmont)
    assert np.array_equal(neg.numpy(), np.asarray(jneg))


def test_hhe_fmnist_1fc_inference_matches_jax(tmp_path, monkeypatch):
    """hhe_fmnist_1fc_inference without the transcipher on 784 x 10
    surrogate weights and biases in the clamp-128 range, written as the
    reference's CSVs: the same logits, predictions and message sizes as the
    JAX function pointed at the same files, and the hard parity held."""
    rng = np.random.default_rng(11)
    w = rng.integers(-128, 129, (784, 10))
    b = rng.integers(-128, 129, (1, 10))
    wcsv, bcsv = str(tmp_path / "fc1_weight.csv"), str(tmp_path / "fc1_bias.csv")
    tpk.save_csv_matrix(wcsv, w)
    tpk.save_csv_matrix(bcsv, b)
    monkeypatch.setattr(jwk, "FMNIST_WEIGHT_CSV", wcsv)
    monkeypatch.setattr(jwk, "FMNIST_BIAS_CSV", bcsv)
    jst = jwk.build_stack(jbfv.BFVParams(**PARAMS_FMNIST), input_len=784)
    tst = twk.build_stack(tbfv.BFVParams(**PARAMS_FMNIST), input_len=784, device="cpu")
    reseed(jst, tst)
    out = twk.hhe_fmnist_1fc_inference(
        tst, batch=2, via_transcipher=False, check_parity=True, weight_csv=wcsv, bias_csv=bcsv
    )
    jout = jwk.hhe_fmnist_1fc_inference(jst, batch=2, via_transcipher=False, check_parity=True)
    assert out["logits"].shape == (2, 10)
    assert np.array_equal(out["logits"], jout["logits"])
    assert np.array_equal(out["predictions"], jout["predictions"])
    rep, jrep = out["report"], jout["report"]
    assert rep["communication_mb"] == jrep["communication_mb"]
    assert set(rep["computation_ms"]) == set(jrep["computation_ms"]) == {
        "user", "analyst", "csp", "total"}
    x = np.random.default_rng(0).integers(0, 5, (2, 784))  # the function's surrogate inputs
    t = tst.ctx.t
    want = (x @ w + b[0]) % t
    assert np.array_equal(out["logits"], np.where(want > t // 2, want - t, want))
    np.testing.assert_array_equal(jpk.read_csv_matrix(wcsv), w)
    with pytest.raises(ValueError, match="784 x 10"):
        twk.hhe_fmnist_1fc_inference(tst, batch=1, via_transcipher=False,
                                     weight_csv=bcsv, bias_csv=bcsv)
