"""The port's rotation-conv HCNN (``hhe_tpu_torch.ops.heconv``) against
``hhe_tpu.ops.heconv``, array for array, on the CPU:

- ``test_heconv.py``'s small HCNN at N=2048 with a 31-bit t and 11 limbs,
  host keys made by the JAX package and carried across: the plaintexts, each
  stage's ciphertext (conv1, square, conv2, square, FC + rotate-sum) and the
  decrypted logits (the 47-bit run of the same check is in
  ``test_torch_he_conv.py``, beside the workload that uses that t);
- the conv and FC plaintexts of the HCNN's 5x5 stride-2 layers on the
  28-wide grid at the 47-bit ``conv_plain_t(2048)``, which the port forms
  by linearity from one encoded mask;
- the tap offsets, Galois elements, integer golden model and
  ``conv_plain_t``."""

import numpy as np
import pytest
import torch

from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import heconv as jconv
from hhe_tpu.ops import primes as jprimes
from hhe_tpu.workloads import he_conv as jhe_conv
from hhe_tpu_torch import convert
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import heconv as tconv
from hhe_tpu_torch.workloads import he_conv as the_conv

CPU = torch.device("cpu")
N = 2048


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test worker (see test_torch_workloads.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def same(t_obj, j_arr):
    return np.array_equal(convert.to_numpy(t_obj), np.asarray(j_arr).astype(np.uint32))


def contexts(t, limbs, seed=7):
    params = dict(n=N, t=t, data_limbs=limbs, seed=seed)
    return jbfv.Context(jbfv.BFVParams(**params)), tbfv.Context(
        tbfv.BFVParams(**params), device="cpu")


def small_hcnn():
    """``test_heconv.py::test_hcnn_encrypted_parity``'s model and image:
    conv1 1->2 and conv2 2->3, 3x3 stride 2, on an 8x8 image; 3 -> 2 FC."""
    rng = np.random.default_rng(3)
    k1 = rng.integers(-2, 2, (2, 1, 3, 3))
    k2 = rng.integers(-2, 2, (3, 2, 3, 3))
    fc = rng.integers(-2, 2, (2, 3))
    x = rng.integers(0, 4, (1, 8, 8))
    return k1, k2, fc, x


STAGES = ("conv1", "square1", "conv2", "square2", "fc")


def run_stages(pkg, ctx, ct, specs, pts, fc_pts, gks, rk):
    """The HCNN's stages through package `pkg`'s heconv: one ciphertext each."""
    w = 8
    a = pkg.he_conv2d(ctx, ct, specs[0], pts[0], gks, w)
    b = pkg.he_square(ctx, a, rk)
    c = pkg.he_conv2d(ctx, b, specs[1], pts[1], gks, w)
    d = pkg.he_square(ctx, c, rk)
    return [a, b, c, d, pkg.he_fc_from_conv(ctx, d, fc_pts, gks)]


def check_hcnn_stages(jc, tc):
    """Run the small HCNN through both packages with the JAX package's host
    keys and ciphertext; every plaintext and stage must be bit-identical,
    and the port's logits must decrypt to the integer model's."""
    k1, k2, fc, x = small_hcnn()
    w = x.shape[-1]
    sk = jc.keygen_secret()
    pk = jc.keygen_public(sk)
    jspecs = [jconv.ConvSpec(k1, (1, 8, 8), 2, 1), jconv.ConvSpec(k2, (2, 3, 3), 2, 2)]
    tspecs = [tconv.ConvSpec(*s) for s in jspecs]
    elts = jconv.conv_galois_elts(jc, jspecs, w)
    assert tconv.conv_galois_elts(tc, tspecs, w) == elts
    gks, rk = jc.keygen_galois(sk, elts), jc.keygen_relin(sk)
    tgks, trk = convert.galois_keys(gks, CPU), convert.kswitch_key(rk, CPU)
    jct = jc.encrypt(pk, jc.encode(x.reshape(-1)))
    jct = jbfv.Ciphertext(jct.data[:, None])
    tct = convert.ciphertext(jct, CPU)

    jpts = [jconv.conv_plaintexts(jc, s, w) for s in jspecs]
    tpts = [tconv.conv_plaintexts(tc, s, w) for s in tspecs]
    jfc, tfc = jconv.fc_plaintexts(jc, fc, jspecs[1], w), tconv.fc_plaintexts(tc, fc, tspecs[1], w)
    for i, (a, b) in enumerate(zip(tpts + [tfc], jpts + [jfc])):
        assert a.dtype == torch.int32 and tuple(a.shape) == b.shape and same(a, b), i

    jstages = run_stages(jconv, jc, jct, jspecs, jpts, jfc, gks, rk)
    tstages = run_stages(tconv, tc, tct, tspecs, tpts, tfc, tgks, trk)
    for name, a, b in zip(STAGES, tstages, jstages):
        assert same(a.data, b.data), name
    tct = tstages[-1]

    got = tc.decode_signed_batch(tc.decrypt_batch(convert.secret_key(sk), tct))[:, 0]
    assert np.array_equal(got, jconv.hcnn_forward_int(x, k1, k2, fc))
    assert tc.noise_budget(convert.secret_key(sk), tbfv.Ciphertext(tct.data[:, 0])) > 0


def test_hcnn_stages_match_jax_31_bit():
    """test_heconv.py's context: a 31-bit NTT-friendly t, 11 limbs."""
    check_hcnn_stages(*contexts(jprimes.ntt_primes(N, 31, 1)[0], 11))


@pytest.fixture(scope="module")
def t47():
    """The HCNN's 47-bit t at N=2048 with 13 limbs, both packages."""
    t = the_conv.conv_plain_t(N)
    assert t.bit_length() == 47
    return contexts(t, 13)


def mnist_specs(pkg, rng, c1=2, c2=3):
    """The HCNN's layers on the 28-wide grid: 5x5 stride-2 convs 1 -> c1
    (28x28 -> 12x12) and c1 -> c2 (12x12 -> 4x4 on the stride-2 grid)."""
    k1 = rng.integers(-2, 2, (c1, 1, 5, 5))
    k2 = rng.integers(-2, 2, (c2, c1, 5, 5))
    return pkg.ConvSpec(k1, (1, 28, 28), 2, 1), pkg.ConvSpec(k2, (c1, 12, 12), 2, 2)


def test_mnist_plaintexts_match_jax_47_bit(t47):
    """conv_plaintexts of both 5x5 stride-2 layers and fc_plaintexts of a
    10-class FC over the 4x4 output, at the 47-bit t: equal to the JAX
    package's per-row encodes, array for array."""
    jc, tc = t47
    jspecs = mnist_specs(jconv, np.random.default_rng(4))
    tspecs = mnist_specs(tconv, np.random.default_rng(4))
    fc = np.random.default_rng(5).integers(-2, 2, (10, 3 * 16))
    for js, ts in zip(jspecs, tspecs):
        assert same(tconv.conv_plaintexts(tc, ts, 28), jconv.conv_plaintexts(jc, js, 28))
    assert same(tconv.fc_plaintexts(tc, fc, tspecs[1], 28),
                jconv.fc_plaintexts(jc, fc, jspecs[1], 28))


def test_weights_past_int64_raise(t47):
    """The int64 products need |w| t < 2^63: at a 47-bit t a weight of
    2^16 raises instead of wrapping (the JAX package's per-row host encode
    takes it: a documented departure)."""
    _, tc = t47
    spec = mnist_specs(tconv, np.random.default_rng(4))[0]
    kernel = spec.kernel.copy()
    kernel[0, 0, 2, 2] = 1 << 16
    with pytest.raises(ValueError, match="overflow int64"):
        tconv.conv_plaintexts(tc, spec._replace(kernel=kernel), 28)
    fc = np.zeros((10, 2 * 144), np.int64)
    fc[3, 7] = -(1 << 16)
    with pytest.raises(ValueError, match="overflow int64"):
        tconv.fc_plaintexts(tc, fc, spec, 28)


@pytest.mark.parametrize("n", [2048, 16384])
def test_conv_plain_t_matches_jax(n):
    t = the_conv.conv_plain_t(n)
    assert t == jhe_conv.conv_plain_t(n) and (t - 1) % (2 * n) == 0 and t.bit_length() == 47


def test_offsets_elts_and_integer_model_match_jax(t47):
    """conv_tap_offsets and conv_galois_elts of the MNIST layers,
    conv2d_int and hcnn_forward_int on a 0-3 image with 5 and 4 channels."""
    jc, tc = t47
    rng = np.random.default_rng(6)
    jspecs = mnist_specs(jconv, rng, 5, 4)
    tspecs = [tconv.ConvSpec(*s) for s in jspecs]
    for js, ts in zip(jspecs, tspecs):
        assert tconv.conv_tap_offsets(ts, 28) == jconv.conv_tap_offsets(js, 28)
        assert tconv.conv_out_shape(ts) == jconv.conv_out_shape(js)
    assert tconv.conv_galois_elts(tc, tspecs, 28) == jconv.conv_galois_elts(jc, jspecs, 28)
    x = rng.integers(0, 4, (1, 28, 28))
    k1, k2 = jspecs[0].kernel, jspecs[1].kernel
    fc = rng.integers(-1, 2, (10, 4 * 16))
    assert np.array_equal(tconv.conv2d_int(x, k1, 2), jconv.conv2d_int(x, k1, 2))
    got = tconv.hcnn_forward_int(x, k1, k2, fc)
    assert got.dtype == np.int64 and np.array_equal(got, jconv.hcnn_forward_int(x, k1, k2, fc))
