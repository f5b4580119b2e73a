"""The port's float baselines and accuracy report
(``hhe_tpu_torch.workloads.float_baseline``) against
``hhe_tpu.workloads.float_baseline`` on the CPU, on numpy-seeded surrogates
of the reference's files in a temporary tree (SIESTA-layout recordings, the
SpO2 1FC and MNIST 2FC weight CSVs, MNIST t10k idx files); the JAX
functions are pointed at the same files with monkeypatch.  Integer columns
are exact; float results agree within the tolerances stated below."""

import functools
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhe_tpu.models import loaders as jloaders
from hhe_tpu.models import pocketnn as jpk
from hhe_tpu.workloads import float_baseline as jfb
from hhe_tpu_torch import convert
from hhe_tpu_torch.models import pocketnn as tpk
from hhe_tpu_torch.workloads import float_baseline as tfb

SIESTA = os.path.join("data", "Harpocrates_recordingwise_SIESTA_4percent")
MNIST = os.path.join("data", "mnist", "MNIST", "raw")
MNIST_IMAGES = 3000  # the float split keeps the last 2,000 for test


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test worker (see test_torch_workloads.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def write_reference_tree(root):
    """Surrogates at the published shapes: four patients' 300-value 5-bit
    SpO2 rows (one label file a row short), the SpO2 1FC weights in [-3, 3],
    the MNIST 2FC weights in [-2, 1], and MNIST_IMAGES t10k images."""
    rng = np.random.default_rng(70)
    os.makedirs(os.path.join(root, SIESTA))
    w = rng.integers(-3, 4, 300)
    for i, n in enumerate((40, 25, 31, 18)):
        x = rng.integers(0, 32, (n, 300))
        y = (x @ w + rng.integers(-20, 21, n) > 0).astype(int)  # learnable, not separable
        stem = os.path.join(root, SIESTA, f"c0001{i:02d}")
        np.savetxt(stem + "_data.txt", x, fmt="%d", delimiter=",")
        np.savetxt(stem + "_binaryoutput.txt", y[: n - (i == 2)], fmt="%d")
    for rel, arr in ((tfb.SPO2_WEIGHTS, w.reshape(-1, 1)),
                     (tfb.MNIST_FC1_WEIGHTS, rng.integers(-2, 2, (784, 128))),
                     (tfb.MNIST_FC2_WEIGHTS, rng.integers(-2, 2, (128, 10)))):
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        tpk.save_csv_matrix(os.path.join(root, rel), arr)
    os.makedirs(os.path.join(root, MNIST))
    labels = rng.integers(0, 10, MNIST_IMAGES)
    # class-dependent brightness in one band of rows, so there is signal
    images = rng.integers(0, 200, (MNIST_IMAGES, 784))
    images[np.arange(MNIST_IMAGES)[:, None], labels[:, None] * 78 + np.arange(56)] = 255
    with open(os.path.join(root, MNIST, "t10k-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, MNIST_IMAGES, 28, 28) + images.astype(np.uint8).tobytes())
    with open(os.path.join(root, MNIST, "t10k-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, MNIST_IMAGES) + labels.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("reference"))
    write_reference_tree(path)
    return path


@pytest.fixture
def jax_at(root, monkeypatch):
    """Point the JAX package's absolute paths at the surrogate tree."""
    load_siesta = jfb.load_siesta
    monkeypatch.setattr(jfb, "load_siesta", functools.partial(
        lambda root_, limit_patients=None: load_siesta(root_, limit_patients),
        os.path.join(root, SIESTA)))
    read_csv = jpk.read_csv_matrix
    monkeypatch.setattr(jpk, "read_csv_matrix", lambda path: read_csv(
        os.path.join(root, str(path)[str(path).index("weights/"):])))
    load_mnist = jloaders.load_mnist_test
    monkeypatch.setattr(jloaders, "load_mnist_test", lambda limit=None, quantize=True:
                        load_mnist(os.path.join(root, MNIST), limit, quantize))
    return root


@pytest.mark.parametrize("limit", [None, 2])
def test_load_siesta_matches_jax(root, limit):
    x, y = tfb.load_siesta(os.path.join(root, SIESTA), limit_patients=limit)
    jx, jy = jfb.load_siesta(os.path.join(root, SIESTA), limit_patients=limit)
    assert x.shape[1] == 300 and len(x) == (113 if limit is None else 65)
    assert np.array_equal(x, jx) and np.array_equal(y, jy) and y.dtype == jy.dtype
    with pytest.raises(FileNotFoundError):
        tfb.load_siesta(os.path.join(root, "missing"))


def test_train_float_spo2_matches_jax(jax_at):
    """400 full-batch Adam steps from zero weights: within 1e-4 of optax's
    (the tie-exact loss; the measured largest difference is printed), and
    the same accuracies."""
    got = tfb.train_float_spo2(limit_patients=None, root=os.path.join(jax_at, SIESTA),
                               device="cpu")
    want = jfb.train_float_spo2(limit_patients=None)
    diff = max(float(np.abs(g.numpy() - np.asarray(w)).max()) for g, w in zip(got.params, want.params))
    print(f"float SpO2: largest weight difference {diff:.3g}, "
          f"largest weight {float(np.abs(np.asarray(want.params[0])).max()):.3g}")
    assert diff <= 1e-4
    assert (got.train_acc, got.test_acc) == (want.train_acc, want.test_acc)
    assert got.train_acc > 0.6


def test_fit_float_mnist_2fc_from_jax_init_matches_jax(jax_at):
    """Both packages from JAX's initial draw (PRNGKey(0), x 0.05), 248
    Adam steps of batch 16: weights within 1e-4 (the measured largest
    difference is printed), test accuracies within 0.5%."""
    kw = dict(epochs=4, batch=16, lr=1e-3, train_limit=1000, seed=0)
    want = jfb.train_float_mnist_2fc(hidden=32, **kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    init = (jax.random.normal(k1, (784, 32)) * 0.05, jnp.zeros((32,)),
            jax.random.normal(k2, (32, 10)) * 0.05, jnp.zeros((10,)))
    got = tfb.fit_float_mnist_2fc(convert.float_params(init, "cpu"),
                                  root=os.path.join(jax_at, MNIST), **kw)
    diffs = [float(np.abs(g.numpy() - np.asarray(w)).max()) for g, w in zip(got.params, want.params)]
    print(f"float MNIST 2FC: largest differences {diffs}")
    assert max(diffs) <= 1e-4
    assert abs(got.test_acc - want.test_acc) <= 0.005
    assert want.test_acc > 0.5  # it learned the surrogate's signal


def test_init_float_mnist_2fc_draws():
    a = tfb.init_float_mnist_2fc(hidden=16, seed=3, device="cpu")
    b = tfb.init_float_mnist_2fc(hidden=16, seed=3, device="cpu")
    assert [t.shape for t in a] == [(784, 16), (16,), (16, 10), (10,)]
    assert all(torch.equal(s, t) for s, t in zip(a, b))
    assert 0.04 < float(a[0].std()) < 0.06 and not a[1].any() and not a[3].any()


def test_integer_accuracies_match_jax(jax_at):
    got = tfb.spo2_integer_accuracy(
        None, os.path.join(jax_at, tfb.SPO2_WEIGHTS), os.path.join(jax_at, SIESTA), device="cpu")
    assert got == jfb.spo2_integer_accuracy(limit_patients=None) and got > 0.5
    got = tfb.mnist_integer_accuracy(
        500, os.path.join(jax_at, tfb.MNIST_FC1_WEIGHTS),
        os.path.join(jax_at, tfb.MNIST_FC2_WEIGHTS), os.path.join(jax_at, MNIST), device="cpu")
    assert got == jfb.mnist_integer_accuracy(limit=500)


def test_accuracy_parity_report_on_cpu(jax_at):
    """The report at N=1024 / 13 limbs on one encrypted sample: the
    encrypted column passed its hard parity check, and the integer columns
    are JAX's integer functions."""
    rep = tfb.accuracy_parity_report(limit_patients=3, mnist_limit=400, encrypted_samples=1,
                                     reference_root=jax_at, device="cpu")
    assert rep["spo2_1fc"]["integer"] == jfb.spo2_integer_accuracy(limit_patients=3)
    assert rep["mnist_2fc"]["integer"] == jfb.mnist_integer_accuracy(limit=400)
    for model in ("spo2_1fc", "mnist_2fc"):
        assert rep[model]["encrypted"] == rep[model]["integer"]
        assert 0.0 <= rep[model]["float"] <= 1.0
    assert rep["spo2_1fc"]["encrypted_parity_checked_samples"] == 1.0


@pytest.mark.parametrize("call", [
    lambda r: tfb.train_float_spo2(root=os.path.join(r, SIESTA)),
    lambda r: tfb.train_float_mnist_2fc(root=os.path.join(r, MNIST)),
    lambda r: tfb.init_float_mnist_2fc(),
    lambda r: tfb.spo2_integer_accuracy(root=os.path.join(r, SIESTA)),
    lambda r: tfb.mnist_integer_accuracy(root=os.path.join(r, MNIST)),
    lambda r: tfb.accuracy_parity_report(reference_root=r),
], ids=["train_float_spo2", "train_float_mnist_2fc", "init_float_mnist_2fc",
        "spo2_integer_accuracy", "mnist_integer_accuracy", "accuracy_parity_report"])
def test_defaults_to_cuda(root, call):
    """Without device=, every function asks for CUDA and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is legitimately CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        call(root)
