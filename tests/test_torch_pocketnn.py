"""The port's integer network (``hhe_tpu_torch.models.pocketnn``) against
``hhe_tpu.models.pocketnn`` on the CPU, on numpy-seeded inputs, bit for bit:
truncating division (zero divisors too), the nine activations with their
grad-inverses over the whole int32 range, ``floor_isqrt``, the wrapping
int32 product, batch norm (with the compiled reference's golden vectors),
the initial draws, the training step in every mode, the losses and the
integer convolution."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhe_tpu.models import pocketnn as jpk
from hhe_tpu_torch import convert
from hhe_tpu_torch.models import pocketnn as tpk

INT_MIN = -(2**31)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test worker (see test_torch_workloads.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t32(a):
    return torch.as_tensor(np.asarray(a).astype(np.int32))


def same(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return got.shape == want.shape and np.array_equal(got, want)


def full_range(rng, n):
    return rng.integers(INT_MIN + 1, 2**31, n, dtype=np.int64)


def test_div_trunc_matches_jax_with_zero_divisors():
    rng = np.random.default_rng(0)
    a = np.concatenate([full_range(rng, 400), [0, 1, -1, 7, -7, 2**31 - 1, INT_MIN + 1]])
    b = np.concatenate([rng.integers(-50, 51, 200), full_range(rng, 200), [0] * 7])
    assert (b == 0).sum() >= 7
    aj, bj = jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32)
    assert same(tpk.div_trunc(t32(a), t32(b)), jpk.div_trunc(aj, bj))
    for d in (0, 1, -1, 2, -2, 10, -1000, 1 << 8, 256 * 784):
        assert same(tpk.div_trunc(t32(a), d), jpk.div_trunc(aj, d)), d
    assert same(tpk.div_trunc(t32([5, -5, 0]), 0), [0, 0, 0])


def activation_inputs(fan_in):
    """Full-range values, and every joint ±2 in the activations' own units
    (x / 256 / fan_in for the sigmoid and tanh, the raw value elsewhere)."""
    rng = np.random.default_rng(1)
    joints = [-127, -74, -31, 32, 75, 128, 0, -32767, 32767, 127, -1, 1, 9, -9, 11, -11]
    near = np.asarray([j + d for j in joints for d in range(-2, 3)], np.int64)
    scaled = np.concatenate([near * s + e for s in (256, 256 * fan_in) for e in (-1, 0, 1)])
    x = np.concatenate([full_range(rng, 2000), near, scaled, [INT_MIN + 1, 2**31 - 1]])
    x = x[(x > INT_MIN) & (x < 2**31)]
    return x[: len(x) // 8 * 8].reshape(-1, 8)


@pytest.mark.parametrize("name", sorted(jpk.ACTIVATIONS))
@pytest.mark.parametrize("fan_in", [3, 784])
def test_activation_matches_jax(name, fan_in):
    x = activation_inputs(fan_in)
    out_t, gi_t = tpk.ACTIVATIONS[name](t32(x), tpk.K_BIT, fan_in)
    out_j, gi_j = jpk.ACTIVATIONS[name](jnp.asarray(x, jnp.int32), jpk.K_BIT, fan_in)
    assert out_t.dtype == torch.int32 and gi_t.dtype == torch.int32
    assert same(out_t, out_j) and same(gi_t, gi_j)


def test_simple_pocket_sigmoid_matches_jax():
    x = activation_inputs(1)
    assert same(tpk.simple_pocket_sigmoid(t32(x)), jpk.simple_pocket_sigmoid(x))


def test_floor_isqrt_matches_jax():
    v = [0, 1, 2, 3, 4, 15, 16, 17, 2**30, 2**31 - 1]
    assert tpk.floor_isqrt(t32(v)).tolist() == [math.isqrt(x) for x in v]
    rng = np.random.default_rng(2)
    x = np.concatenate([v, [-1, -5, INT_MIN + 1, INT_MIN], full_range(rng, 3000),
                        [s * s + d for s in range(46330, 46341) for d in (-1, 0, 1)]])
    x = x[x < 2**31]
    assert same(tpk.floor_isqrt(t32(x)), jpk.floor_isqrt(jnp.asarray(x, jnp.int32)))


@pytest.mark.parametrize("shape", [(20, 784, 100), (784, 20, 100), (1, 20, 100), (7, 3000, 5)])
def test_int32_matmul_wraps_like_jax(shape):
    m, k, n = shape
    rng = np.random.default_rng(k)
    a = full_range(rng, m * k).reshape(m, k)
    b = full_range(rng, k * n).reshape(k, n)
    a[0, :4] = [INT_MIN + 1, 2**31 - 1, 0, -1]
    got = tpk.int32_matmul(t32(a), t32(b))
    want = (a @ b).astype(np.int32)  # int64 wraps mod 2^64, so mod 2^32 is exact
    assert got.dtype == torch.int32 and same(got, want)
    assert same(got, jnp.asarray(a, jnp.int32) @ jnp.asarray(b, jnp.int32))


def test_int32_matmul_rejects_k_past_2_21():
    a = torch.zeros((1, 1 << 21), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^21"):
        tpk.int32_matmul(a, a.T)
    tpk.int32_matmul(a[:, 1:], a[:, 1:].T)  # K = 2^21 - 1 is fine


def test_batch_norm_golden_vectors():
    """The compiled reference's batch-norm forward and three training steps
    (the vectors of test_pocketnn.py::test_batch_norm_bit_exact_vs_reference)."""
    N, IN, OUT, LRINV = 5, 6, 4, 10
    x = np.array([[((r * 11 + c * 5) % 19) - 9 for c in range(IN)] for r in range(N)])
    w0 = np.array([[((r * 7 + c * 13) % 21) - 10 for c in range(OUT)] for r in range(IN)])
    target = np.array([[((r + c) % 2) * 100 for c in range(OUT)] for r in range(N)])
    specs = [tpk.FCSpec(IN, OUT, "pocket_tanh", use_dfa=True, use_bn=True)]
    model, specs = tpk.mlp_init(0, specs, device="cpu")
    model = tpk.MLP((model.params[0]._replace(weight=t32(w0)),))
    out0, _ = tpk.mlp_forward(model, specs, t32(x))
    assert out0.tolist() == np.zeros((N, OUT)).tolist()
    for _ in range(3):
        model, _ = tpk.dfa_train_step(model, specs, t32(x), t32(target), lr_inv=LRINV)
    out3, _ = tpk.mlp_forward(model, specs, t32(x))
    assert out3.tolist() == [
        [-58, 127, -10, -114],
        [-60, -127, -10, 127],
        [-60, 127, -10, -108],
        [127, -52, 86, 26],
        [-127, -87, -67, 50],
    ]
    assert model.params[0].weight.tolist() == [
        [-127, 128, -127, -127],
        [128, 128, 128, -127],
        [128, -127, 128, 128],
        [-127, -127, -127, 128],
        [-127, 128, -127, -127],
        [128, 128, 128, -127],
    ]
    assert model.params[0].gamma.tolist() == [[-1829, -2418, -356, -1111]]
    assert model.params[0].beta.tolist() == [[31, 46, 49, 45]]


def test_batch_normalize_wrapped_sums_match_jax():
    """Large inputs, so the int32 mean and variance sums wrap."""
    rng = np.random.default_rng(3)
    inter = rng.integers(-(2**29), 2**29, (16, 6))
    gamma, beta = rng.integers(-50, 50, (1, 6)), rng.integers(-50, 50, (1, 6))
    jj = [jnp.asarray(a, jnp.int32) for a in (inter, gamma, beta)]
    out_t, (xh_t, sd_t) = tpk.batch_normalize(t32(inter), t32(gamma), t32(beta))
    out_j, (xh_j, sd_j) = jpk.batch_normalize(*jj)
    assert same(out_t, out_j) and same(xh_t, xh_j) and same(sd_t, sd_j)


def assert_same_mlp(got, want):
    assert len(got.params) == len(want.params)
    for p, q in zip(got.params, want.params):
        for field in jpk.FCParams._fields:
            a, b = getattr(p, field), getattr(q, field)
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.dtype == torch.int32 and same(a, b), field


@pytest.mark.parametrize("he_init", [False, True])
def test_mlp_init_draws_match_jax(he_init):
    specs = [jpk.FCSpec(30, 12, "pocket_tanh"), jpk.FCSpec(12, 8, "pocket_tanh", use_bn=True),
             jpk.FCSpec(8, 4, "pocket_sigmoid", use_dfa=False)]
    tspecs = [tpk.FCSpec(**vars(s)) for s in specs]
    jm, _ = jpk.mlp_init(5, specs, he_init=he_init)
    tm, _ = tpk.mlp_init(5, tspecs, he_init=he_init, device="cpu")
    assert_same_mlp(tm, jm)
    p = tpk.fc_init(np.random.default_rng(9), tspecs[0], 4, he_init, device="cpu")
    q = jpk.fc_init(np.random.default_rng(9), specs[0], 4, he_init)
    assert_same_mlp(tpk.MLP((p,)), jpk.MLP((q,)))
    assert_same_mlp(convert.mlp(jm, "cpu"), jm)


# name -> (layers as (in, out, actv, use_dfa, use_bn), he_init, lr_inv, x range, y scale)
STACKS = {
    "dfa": ([(24, 16, "pocket_tanh", True, False), (16, 10, "pocket_tanh", True, False),
             (10, 3, "pocket_tanh", True, False)], True, 100, 256, 15),
    "backprop": ([(16, 8, "pocket_tanh", False, False), (8, 1, "pocket_sigmoid", False, False)],
                 True, 50, 40, 128),
    "batch_norm": ([(12, 6, "pocket_tanh", True, True), (6, 3, "pocket_tanh", True, True)],
                   True, 10, 20, 100),
    "mixed": ([(20, 10, "pocket_relu8bit", True, False), (10, 8, "plu", False, True),
               (8, 6, "pocket_leakyrelu", False, False), (6, 4, "pocket_softmax", True, False)],
              True, 30, 60, 127),
    "square_from_zero": ([(30, 12, "pocket_tanh", True, False), (12, 1, "square", True, False)],
                         False, 50, 32, 128),
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_dfa_train_step_matches_jax(stack):
    layers, he_init, lr_inv, x_hi, y_scale = STACKS[stack]
    jspecs = [jpk.FCSpec(i, o, a, d, bn) for i, o, a, d, bn in layers]
    tspecs = [tpk.FCSpec(i, o, a, d, bn) for i, o, a, d, bn in layers]
    jm, jspecs = jpk.mlp_init(7, jspecs, he_init=he_init)
    tm, tspecs = tpk.mlp_init(7, tspecs, he_init=he_init, device="cpu")
    rng = np.random.default_rng(11)
    n_out = layers[-1][1]
    for step in range(6):
        x = rng.integers(0 if stack == "dfa" else -x_hi, x_hi, (8, layers[0][0]))
        y = rng.integers(0, 2, (8, n_out)) * y_scale
        jm, jloss = jpk.dfa_train_step(jm, jspecs, jnp.asarray(x, jnp.int32),
                                       jnp.asarray(y, jnp.int32), lr_inv)
        tm, tloss = tpk.dfa_train_step(tm, tspecs, t32(x), t32(y), lr_inv)
        assert tloss.dtype == torch.int32 and int(tloss) == int(jloss), step
        assert_same_mlp(tm, jm)
    moved = [int((p.weight != 0).sum()) for p in tm.params]
    if stack == "square_from_zero":
        # grad_inv = 2x = 0 at the zero output layer: its deltas are 0 and it
        # never leaves zero, in both packages (ROADMAP F14)
        assert moved[-1] == 0 and moved[0] > 0
    else:
        assert min(moved) > 0


def test_losses_match_jax():
    rng = np.random.default_rng(12)
    y = rng.integers(-200, 200, (16, 10))
    y_hat = rng.integers(-(2**20), 2**20, (16, 10))
    jy, jyh = jnp.asarray(y, jnp.int32), jnp.asarray(y_hat, jnp.int32)
    big = rng.integers(-(2**31) + 1, 2**31, (16, 10))  # d * d wraps
    assert int(tpk.batch_l2_loss(t32(y), t32(y_hat))) == int(jpk.batch_l2_loss(jy, jyh))
    assert int(tpk.batch_l2_loss(t32(y), t32(big))) == int(
        jpk.batch_l2_loss(jy, jnp.asarray(big, jnp.int32)))
    assert same(tpk.batch_l2_loss_delta(t32(y), t32(y_hat)), jpk.batch_l2_loss_delta(jy, jyh))
    onehot = np.zeros((16, 10), np.int64)
    onehot[np.arange(16), rng.integers(0, 10, 16)] = jpk.INT_MAX
    jo = jnp.asarray(onehot, jnp.int32)
    # terms below 2^24 / 16: every float32 partial sum is exact, so equal
    small = rng.integers(jpk.INT_MAX - 2**19, jpk.INT_MAX, (16, 10))
    got = tpk.batch_pocket_cross_loss(t32(onehot), t32(small))
    want = jpk.batch_pocket_cross_loss(jo, jnp.asarray(small, jnp.int32))
    assert got.dtype == torch.float32 and float(got) == float(want)
    # terms near 2^32: XLA and torch add the 16 float32 terms in different
    # orders, so each is within 15 roundings (ulps of the total) of the exact sum
    for yh in (y_hat, big):
        got = tpk.batch_pocket_cross_loss(t32(onehot), t32(yh))
        want = jpk.batch_pocket_cross_loss(jo, jnp.asarray(yh, jnp.int32))
        exact = float(np.where(onehot == jpk.INT_MAX,
                               (jpk.INT_MAX - yh.astype(np.int32)).astype(np.float32), 0).sum())
        ulp = float(np.spacing(np.float32(abs(exact))))
        assert got.dtype == torch.float32
        assert abs(float(got) - exact) <= 15 * ulp and abs(float(want) - exact) <= 15 * ulp
    assert same(tpk.batch_pocket_cross_loss_delta(t32(onehot), t32(y_hat)),
                jpk.batch_pocket_cross_loss_delta(jo, jyh))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_int_matches_jax(stride):
    rng = np.random.default_rng(13)
    x = rng.integers(-8, 9, (2, 3, 13, 11))
    k = rng.integers(-4, 5, (5, 3, 3, 3))
    want = jpk.conv2d_int_jax(jnp.asarray(x), jnp.asarray(k), stride)
    assert same(tpk.conv2d_int(t32(x), t32(k), stride), want)
    big = full_range(rng, x.size).reshape(x.shape)  # products and sums wrap
    want = jpk.conv2d_int_jax(jnp.asarray(big, jnp.int32), jnp.asarray(k), stride)
    assert same(tpk.conv2d_int(t32(big), t32(k), stride), want)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_forward_with_jax_kernel(stride):
    rng = np.random.default_rng(14)
    for actv in ("square", "pocket_tanh"):
        spec = jpk.ConvSpec(in_ch=2, out_ch=3, ksize=5, stride=stride, actv=actv)
        kern = jpk.conv_init(jax.random.PRNGKey(stride), spec)
        x = rng.integers(0, 256, (2, 2, 28, 28))
        out_j, gi_j = jpk.conv_forward(kern, jnp.asarray(x, jnp.int32), spec)
        out_t, gi_t = tpk.conv_forward(t32(kern), t32(x), tpk.ConvSpec(*spec))
        assert same(out_t, out_j) and same(gi_t, gi_j), actv


def test_conv_init_draws_from_the_generator():
    spec = tpk.ConvSpec(in_ch=1, out_ch=5, ksize=5, stride=2)
    a = tpk.conv_init(torch.Generator().manual_seed(3), spec)
    b = tpk.conv_init(torch.Generator().manual_seed(3), spec, bound=2)
    assert a.shape == (5, 1, 5, 5) and a.dtype == torch.int32 and torch.equal(a, b)
    assert int(a.min()) >= -2 and int(a.max()) <= 2 and len(a.unique()) == 5


def test_mlp_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is legitimately CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpk.mlp_init(0, [tpk.FCSpec(4, 2)])
