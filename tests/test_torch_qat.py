"""The port's QAT trainers (``hhe_tpu_torch.workloads.qat``) against
``hhe_tpu.workloads.qat`` on the CPU: on the same numpy-seeded tiny data
both run the same torch models, draws and steps, so the integer weights,
both accuracies and the exported CSVs are identical; without a card the
port's default device raises.  No test reads the reference's assets."""

import numpy as np
import pytest
import torch

from hhe_tpu.workloads import qat as jqat
from hhe_tpu_torch.workloads import qat as tqat


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test worker (see test_torch_workloads.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def split(x, y, n_train):
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def hcnn_data():
    """128 images of 2-bit levels 0..3 (the HCNN's input scaling), 10 classes."""
    rng = np.random.default_rng(31)
    return split(rng.integers(0, 4, (128, 1, 28, 28)), rng.integers(0, 10, 128), 96)


def fc2_data():
    """160 rows of 784 2-bit inputs 0..4, 10 classes."""
    rng = np.random.default_rng(32)
    return split(rng.integers(0, 5, (160, 784)), rng.integers(0, 10, 160), 128)


def spo2_data():
    """200 rows of 300 5-bit SpO2 values, ~30% positive labels."""
    rng = np.random.default_rng(33)
    return split(rng.integers(0, 32, (200, 300)), (rng.random(200) < 0.3).astype(np.int64), 150)


# (trainer, data, keyword arguments, result fields, exported files)
TRAINERS = {
    "hcnn": ("train_quant_hcnn", hcnn_data, dict(c1=2, c2=3, epochs=2, batch=32),
             ("k1_int", "k2_int", "fc_int"), ("_conv1.csv", "_conv2.csv", "_fc.csv")),
    "2fc": ("train_quant_2fc", fc2_data, dict(hidden=16, epochs=3, batch=32),
            ("w1_int", "w2_int"), ("_fc1.csv", "_fc2.csv")),
    "spo2": ("train_quant_spo2_1fc", spo2_data, dict(epochs=4, batch=32),
             ("w_int",), (".csv",)),
}


@pytest.mark.parametrize("which", sorted(TRAINERS))
def test_trainer_matches_jax(which, tmp_path):
    name, data, kw, fields, files = TRAINERS[which]
    args = data()
    out = {}
    for pkg, mod, extra in (("jax", jqat, {}), ("port", tqat, {"device": "cpu"})):
        prefix = str(tmp_path / pkg / "w")
        (tmp_path / pkg).mkdir()
        export = {"export_path": prefix + ".csv"} if which == "spo2" else {"export_prefix": prefix}
        out[pkg] = getattr(mod, name)(*args, **kw, **export, **extra)
    got, want = out["port"], out["jax"]
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == np.int64 and np.array_equal(a, b), f
    assert np.abs(getattr(got, fields[0])).max() == 1  # 2-bit ternary, not all zero
    assert (got.float_acc, got.int_acc) == (want.float_acc, want.int_acc)
    for suffix in files:
        assert (tmp_path / "port" / f"w{suffix}").read_bytes() == (
            tmp_path / "jax" / f"w{suffix}").read_bytes(), suffix


@pytest.mark.parametrize("which", sorted(TRAINERS))
def test_trainer_defaults_to_cuda(which):
    """Without device=, a trainer asks for CUDA and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    name, data, kw, _, _ = TRAINERS[which]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(tqat, name)(*data(), **kw)
