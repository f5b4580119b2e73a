"""The port's encrypted HCNN workload (``hhe_tpu_torch.workloads.he_conv``)
on the CPU at its own 47-bit plaintext modulus, ``conv_plain_t(2048)``, with
13 limbs:

- ``test_heconv.py``'s small HCNN through both packages' heconv with JAX host
  keys carried across, every stage bit-identical (the 31-bit run is in
  ``test_torch_heconv.py``);
- ``he_mnist_conv_inference`` end to end on surrogate MNIST idx files
  (numpy-seeded images in 0-255 and labels) with the HCNN's 5 first-layer
  channels, 4 second-layer ones and given ternary weights: exact logit
  parity with the integer model, noise budget left, the report;
- its CUDA default."""

import os
import struct

import numpy as np
import pytest
import torch

from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import heconv as tconv
from hhe_tpu_torch.workloads import he_conv, qat
from tests.test_torch_heconv import check_hcnn_stages, contexts

N = 2048


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads: the suite runs several test workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_hcnn_stages_match_jax_47_bit():
    check_hcnn_stages(*contexts(he_conv.conv_plain_t(N), 13))


def write_mnist_idx(root, images, labels):
    """The MNIST test split's two idx files (``loaders.load_mnist_test``)."""
    with open(os.path.join(root, "t10k-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, len(images), 28, 28))
        f.write(np.asarray(images, np.uint8).tobytes())
    with open(os.path.join(root, "t10k-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + np.asarray(labels, np.uint8).tobytes())


@pytest.fixture(scope="module")
def mnist_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mnist")
    rng = np.random.default_rng(40)
    write_mnist_idx(root, rng.integers(0, 256, (8, 784)), rng.integers(0, 10, 8))
    return str(root)


def test_workload_exact_logit_parity(mnist_root):
    rng = np.random.default_rng(41)
    weights = qat.QATConvResult(
        rng.integers(-1, 2, (5, 1, 5, 5)), rng.integers(-1, 2, (4, 5, 5, 5)),
        rng.integers(-1, 2, (10, 4 * 16)), float_acc=0.0, int_acc=0.0)
    rep = he_conv.he_mnist_conv_inference(
        n_images=1, train_subset=4, n=N, data_limbs=13, qat=weights, verbose=False,
        device="cpu", mnist_root=mnist_root)
    assert rep.he_matches_int and rep.n_images == 1
    assert rep.noise_left > 0 and rep.noise_left == rep.stage_budgets["fc"]
    budgets = [rep.stage_budgets[s] for s in he_conv.STAGES]
    assert budgets == sorted(budgets, reverse=True) and budgets[-1] < budgets[0]
    ctx = tbfv.Context(tbfv.BFVParams(n=N, t=he_conv.conv_plain_t(N), data_limbs=13),
                       device="cpu")
    specs = [tconv.ConvSpec(weights.k1_int, (1, 28, 28), 2, 1),
             tconv.ConvSpec(weights.k2_int, (5, 12, 12), 2, 2)]
    assert rep.galois_keys == len(tconv.conv_galois_elts(ctx, specs, 28))
    assert rep.qat_s == 0.0
    for key in ("keygen_s", "prep_s", "encrypt_s", "eval_s", "decrypt_s"):
        assert getattr(rep, key) > 0.0, key


def test_workload_defaults_to_cuda(mnist_root):
    """Without device=, the workload asks for CUDA and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        he_conv.he_mnist_conv_inference(n_images=1, train_subset=4, n=N, verbose=False,
                                        mnist_root=mnist_root)
