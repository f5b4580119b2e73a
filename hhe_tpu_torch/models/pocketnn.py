"""Integer-only neural network layer — the PocketNN equivalent, on int32
tensors; counterpart of ``hhe_tpu.models.pocketnn``.

Reference: the vendored PocketNN (``libs/pocketnn/``).  Plain functions on
int32 tensors with C-style truncating division and the JAX package's int32
wraparound (sums and products wrap mod 2^32, as XLA's int32 ops do):

- activations with their piecewise integer formulas and inverse-gradient
  outputs (``libs/pocketnn/src/pktnn_actv.cpp:115-491``)
- FC forward = x @ W + b then activation; weights clamped to [-127, 128]
  (``libs/pocketnn/src/pktnn_fc.cpp:136-171``), integer batch norm
  (``pktnn_fc.cpp:345-427``)
- DFA / backprop backward: deltas = loss_delta @ B / grad_inv with a fixed
  random feedback matrix, integer SGD update ``W += (x^T @ deltas) / (-lr_inv)``
  with truncating division and clamping (``pktnn_fc.cpp:241-343``)
- L2 / pocket-cross losses (``libs/pocketnn/src/pktnn_loss.cpp``)
- integer sigmoids used by the HHE pipeline: ``simple_pocket_sigmoid``
  (reference ``src/util/utils.cpp:56-76``) and ``int_sigmoid``
  (``src/util/utils.h:94-100``)
- weight CSV IO (``matrix.h:134-159``) and a valid integer convolution.

Every matrix product is ``int32_matmul``: exact, wrapped to int32, the same
code on every device (CUDA has no integer GEMM past int8).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.bfv import resolve_device

I32 = torch.int32

K_BIT = 8  # reference pktnn_consts.h:5
UNSIGNED_4BIT_MAX = 15  # reference pktnn_consts.h:11
PKT_MAX = 127
PKT_MIN = -127
SHRT_MAX = 32767
INT_MAX = 2**31 - 1


def div_trunc(a: torch.Tensor, b) -> torch.Tensor:
    """C-style integer division (truncate toward zero); b may be a tensor or
    an int.  A zero divisor gives 0, as the JAX package's
    sign(a)·(|a| // |b|)·sign(b) does."""
    if not isinstance(b, torch.Tensor):
        if b == 0:
            return torch.zeros_like(a)
        q = torch.div(torch.abs(a), abs(b), rounding_mode="floor")
        return (torch.sign(a) * q * (1 if b > 0 else -1)).to(a.dtype)
    safe = torch.where(b == 0, torch.ones_like(b), torch.abs(b))
    q = torch.div(torch.abs(a), safe, rounding_mode="floor")
    return (torch.sign(a) * q * torch.sign(b)).to(a.dtype)


def div_trunc_np(a, b):
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    return np.sign(a) * (np.abs(a) // np.abs(b)) * np.sign(b)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 mod 2^32 (two's complement)."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(I32)


def int32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for int32 tensors, wrapped to int32 as XLA's int32 dot wraps,
    exact for every input.  Each operand splits into 16-bit digits
    (x = x_hi·2^16 + x_lo, x_lo in [0, 2^16)); lo·lo, hi·lo and lo·hi are
    float64 products whose terms are below 2^32 in magnitude, so their sums
    are exact integers while K < 2^21; hi·hi vanishes mod 2^32."""
    k = a.shape[-1]
    if k >= 1 << 21:
        raise ValueError(f"int32_matmul is exact for K < 2^21, got K = {k}")
    a, b = a.to(I32), b.to(I32)
    f64 = torch.float64
    a_lo, a_hi = (a & 0xFFFF).to(f64), (a >> 16).to(f64)
    b_lo, b_hi = (b & 0xFFFF).to(f64), (b >> 16).to(f64)
    low = torch.matmul(a_lo, b_lo).to(torch.int64)
    mid = (torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)).to(torch.int64)
    return _wrap32(low + ((mid & 0xFFFF) << 16))


# ---------------------------------------------------------------------------
# Activations: each returns (out, grad_inv), both int32
# ---------------------------------------------------------------------------


def _piecewise(x, joints, fns, grads, ymin, ymax):
    """fns[i] on [joints[i], joints[i+1]) with grad_inv grads[i+1]; ymin
    (grads[0]) below joints[0], ymax (grads[-1]) from joints[-1]."""
    out = torch.full_like(x, ymin)
    gi = torch.full_like(x, grads[0])
    conds = [x < j for j in joints]
    for i, fn in enumerate(fns):
        seg = (~conds[i]) & conds[i + 1]
        out = torch.where(seg, fn(x), out)
        gi = torch.where(seg, grads[i + 1], gi)
    top = ~conds[-1]
    out = torch.where(top, ymax, out)
    gi = torch.where(top, grads[-1], gi)
    return out, gi


_JOINTS = (-127, -74, -31, 32, 75, 128)
_SLOPES_INV = (PKT_MAX, 8, 2, 1, 2, 8, PKT_MAX)
_SIGMOID_FNS = (
    lambda v: div_trunc(v, 8) + 20,
    lambda v: div_trunc(v, 2) + 48,
    lambda v: v + 64,
    lambda v: div_trunc(v, 2) + 80,
    lambda v: div_trunc(v, 8) + 108,
)


def pocket_sigmoid(x, k=K_BIT, fan_in=0):
    """Reference pktactv::pocketSigmoid (pktnn_actv.cpp:115-198)."""
    xs = div_trunc(x, 1 << k)
    return _piecewise(xs, _JOINTS, _SIGMOID_FNS, _SLOPES_INV, 1, PKT_MAX)


def pocket_tanh(x, k=K_BIT, fan_in=1):
    """Reference pktactv::pocketTanh (divisor includes the fan-in)."""
    xs = div_trunc(x, (1 << k) * max(fan_in, 1))
    fns = [
        lambda v: div_trunc(v, 4) - 88,
        lambda v: v - 32,
        lambda v: 2 * v,
        lambda v: v + 32,
        lambda v: div_trunc(v, 4) + 88,
    ]
    return _piecewise(xs, _JOINTS, fns, _SLOPES_INV, PKT_MIN, PKT_MAX)


def rescale(x, k=K_BIT, fan_in=0):
    return div_trunc(x, 1 << k), torch.ones_like(x)


def pocket_relu8bit(x, k=K_BIT, fan_in=0):
    out = torch.clamp(x, 0, PKT_MAX)
    gi = torch.where((x < 0) | (x > PKT_MAX), INT_MAX, torch.ones_like(x))
    return out, gi


def pocket_leakyrelu(x, k=K_BIT, fan_in=0):
    mx = SHRT_MAX
    out = torch.where(x < 0, div_trunc(x, 5), x)
    out = torch.clamp(out, -mx, mx)
    inner = torch.where(x < 0, 5, torch.ones_like(x))
    gi = torch.where((x < -mx) | (x >= mx), INT_MAX, inner)
    return out, gi


def plu(x, k=K_BIT, fan_in=0):
    """PLU(x) = max[a(x+c)-c, min{a(x-c)+c, x}] with 1/a=10, c=1 (pktnn_actv.cpp plu)."""
    c = 1
    thres_max = div_trunc(x + c, 10) - c
    thres_min = div_trunc(x - c, 10) + c
    v = torch.minimum(x, thres_min)
    v = torch.maximum(v, thres_max)
    out = torch.clamp(v, PKT_MIN, PKT_MAX)
    safe = torch.where(v == 0, torch.ones_like(v), v)
    gi = torch.where((v < PKT_MIN) | (v > PKT_MAX), PKT_MAX, div_trunc(x, safe))
    return out, gi


def pocket_softmax(x, k=K_BIT, fan_in=0):
    """Rowwise integer softmax: clamp nonpositives to 0, rescale rows to sum
    ~INT_MAX (reference pktactv::pocketSoftmax, pktnn_actv.cpp:283-330)."""
    pos = torch.clamp(x, min=0)
    row_sum = torch.clamp(pos.sum(dim=-1, keepdim=True, dtype=I32), min=1)
    scale = div_trunc(torch.full_like(row_sum, INT_MAX), row_sum)
    out = pos * scale
    gi = torch.where(out == 0, INT_MAX, torch.ones_like(x))
    return out, gi


def as_is(x, k=K_BIT, fan_in=0):
    return x, torch.ones_like(x)


def square(x, k=K_BIT, fan_in=0):
    return x * x, 2 * x


ACTIVATIONS = {
    "pocket_sigmoid": pocket_sigmoid,
    "pocket_tanh": pocket_tanh,
    "rescale": rescale,
    "pocket_relu8bit": pocket_relu8bit,
    "pocket_leakyrelu": pocket_leakyrelu,
    "plu": plu,
    "pocket_softmax": pocket_softmax,
    "as_is": as_is,
    "square": square,
}


def simple_pocket_sigmoid(x) -> torch.Tensor:
    """7-segment integer sigmoid used at analyst decrypt time
    (reference src/util/utils.cpp:56-76); ints or arrays."""
    x = torch.as_tensor(x).to(I32)
    return _piecewise(x, _JOINTS, _SIGMOID_FNS, _SLOPES_INV, 1, PKT_MAX)[0]


def int_sigmoid(x) -> torch.Tensor:
    """Step function: 0 for x <= 0, else 1."""
    x = torch.as_tensor(x)
    return (x > 0).to(I32)


# ---------------------------------------------------------------------------
# Fully-connected layer (functional)
# ---------------------------------------------------------------------------


class FCParams(NamedTuple):
    weight: torch.Tensor  # [in, out] int32
    bias: torch.Tensor  # [1, out] int32
    dfa: Optional[torch.Tensor] = None  # [n_classes, out] int32 feedback
    gamma: Optional[torch.Tensor] = None  # [1, out] int32 (batch-norm scale)
    beta: Optional[torch.Tensor] = None  # [1, out] int32 (batch-norm shift)


@dataclasses.dataclass(frozen=True)
class FCSpec:
    in_dim: int
    out_dim: int
    actv: str = "pocket_tanh"
    use_dfa: bool = True
    use_bn: bool = False  # reference pktfc::useBatchNormalization (pktnn_fc.cpp:119-127)


def fc_init(
    rng: np.random.Generator,
    spec: FCSpec,
    n_classes: int,
    he_init: bool = False,
    device=None,
) -> FCParams:
    """The JAX package's numpy draws, in its order, as int32 tensors on
    `device` (None: CUDA)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    if he_init:
        # reference pktfc::initHeWeightBias (pktnn_fc.cpp:89-110)
        rng_w = int(np.sqrt(12 * SHRT_MAX // (spec.in_dim + spec.out_dim)))
        w = t(rng.integers(-rng_w, rng_w + 1, (spec.in_dim, spec.out_dim)))
        b = t(rng.integers(-rng_w, rng_w + 1, (1, spec.out_dim)))
    else:
        w = torch.zeros((spec.in_dim, spec.out_dim), dtype=I32, device=dev)
        b = torch.zeros((1, spec.out_dim), dtype=I32, device=dev)
    dfa = None
    if spec.use_dfa:
        # He-style integer range (reference pktnn_fc.cpp:72-81)
        rng_range = int(np.sqrt(12 * SHRT_MAX // (spec.in_dim + spec.out_dim)))
        dfa = t(rng.integers(-rng_range, rng_range + 1, (n_classes, spec.out_dim)))
    gamma = beta = None
    if spec.use_bn:
        # reference lazily inits gamma=1, beta=0 on first forward (pktnn_fc.cpp:403-411)
        gamma = torch.ones((1, spec.out_dim), dtype=I32, device=dev)
        beta = torch.zeros((1, spec.out_dim), dtype=I32, device=dev)
    return FCParams(w, b, dfa, gamma, beta)


def floor_isqrt(x: torch.Tensor) -> torch.Tensor:
    """Elementwise floor(sqrt(x)) for int32, 0 for x <= 0 (reference
    pktmat::floorSqrt used by squareRootOf, pktnn_mat.cpp:929-944; a wrapped
    variance can be negative): a float32 estimate, then exact repairs in
    int64, where (s + 1)^2 cannot overflow."""
    x = torch.clamp(x, min=0)
    s = torch.floor(torch.sqrt(x.to(torch.float32))).to(torch.int64)
    xl = x.to(torch.int64)
    for _ in range(2):
        s = torch.where((s + 1) * (s + 1) <= xl, s + 1, s)  # round-down repair
        s = torch.where(s * s > xl, s - 1, s)  # round-up repair
    return s.to(x.dtype)


class BNCache(NamedTuple):
    standardized: torch.Tensor  # [B, out] x_hat (pktnn_fc.cpp:387-400)
    stdev_eps: torch.Tensor  # [1, out] floorSqrt(var), 0 -> 1


def batch_normalize(inter: torch.Tensor, gamma, beta):
    """Integer batch-norm over a minibatch (reference
    pktfc::batchNormalization, pktnn_fc.cpp:345-427): truncating-division
    mean/variance over int32 sums that wrap, floor-sqrt stdev with eps->1,
    x_hat scaled by PKT_MAX=127, then gamma*x_hat + beta.  Returns
    (bn_out, BNCache)."""
    n_items = inter.shape[0]
    mean = div_trunc(inter.sum(dim=0, keepdim=True, dtype=I32), n_items)
    devi = inter - mean
    var = div_trunc((devi * devi).sum(dim=0, keepdim=True, dtype=I32), n_items)
    stdev = floor_isqrt(var)
    stdev = torch.where(stdev == 0, torch.ones_like(stdev), stdev)
    xhat = div_trunc(PKT_MAX * devi, stdev)
    return gamma * xhat + beta, BNCache(xhat, stdev)


def fc_forward(params: FCParams, x: torch.Tensor, spec: FCSpec):
    """out = actv(x @ W + b); returns (out, grad_inv, BNCache or None).
    x int32 [B, in].  With use_bn the bias is NOT added — the reference
    normalizes x @ W and feeds gamma*x_hat+beta to the activation
    (pktnn_fc.cpp:136-153)."""
    if spec.use_bn:
        inter = int32_matmul(x, params.weight)
        bn, cache = batch_normalize(inter, params.gamma, params.beta)
        out, gi = ACTIVATIONS[spec.actv](bn, K_BIT, spec.in_dim)
        return out, gi, cache
    inter = int32_matmul(x, params.weight) + params.bias
    out, gi = ACTIVATIONS[spec.actv](inter, K_BIT, spec.in_dim)
    return out, gi, None


# ---------------------------------------------------------------------------
# Losses (reference pktnn_loss.cpp)
# ---------------------------------------------------------------------------


def batch_l2_loss(y, y_hat):
    d = y_hat - y
    return div_trunc(d * d, 2).sum(dtype=I32)


def batch_l2_loss_delta(y, y_hat):
    return y_hat - y


def batch_pocket_cross_loss(y_onehot_intmax, y_hat):
    """Reference batchPocketCrossLoss: sum of (INT_MAX - y_hat) at one-hot
    positions marked INT_MAX (pktnn_loss.cpp:74-88).  A float32 accumulator,
    as the JAX package's float64 request gives float32 without x64."""
    mask = y_onehot_intmax == INT_MAX
    terms = (INT_MAX - y_hat.to(I32)).to(torch.float32)
    return torch.where(mask, terms, 0.0).sum()


def batch_pocket_cross_loss_delta(y_onehot_intmax, y_hat):
    """Reference batchPocketCrossLossDelta: -1 at one-hot positions."""
    return torch.where(y_onehot_intmax == INT_MAX, -1, 0).to(I32)


# ---------------------------------------------------------------------------
# DFA training step over a stack of FC layers
# ---------------------------------------------------------------------------


class MLP(NamedTuple):
    params: Tuple[FCParams, ...]


def mlp_init(
    seed: int, specs: Sequence[FCSpec], he_init: bool = False, device=None
) -> Tuple[MLP, Tuple[FCSpec, ...]]:
    rng = np.random.default_rng(seed)
    n_classes = specs[-1].out_dim
    return (
        MLP(tuple(fc_init(rng, s, n_classes, he_init, device) for s in specs)),
        tuple(specs),
    )


def mlp_forward(model: MLP, specs, x):
    """Returns (final_out, per-layer (input, out, grad_inv, BNCache) caches)."""
    caches = []
    h = x
    for p, s in zip(model.params, specs):
        out, gi, bn = fc_forward(p, h, s)
        caches.append((h, out, gi, bn))
        h = out
    return h, caches


def dfa_train_step(
    model: MLP, specs, x, y, lr_inv: int, lo: int = -127, hi: int = 128
) -> Tuple[MLP, torch.Tensor]:
    """One integer-DFA minibatch update (reference pktfc::backward +
    computeDeltas, pktnn_fc.cpp:180-343). x [B,in] int32, y [B,n_classes].
    Returns the new model (fresh tensors: `model` is left as it was) and the
    int32 L2 loss."""
    y_hat, caches = mlp_forward(model, specs, x)
    loss_delta = batch_l2_loss_delta(y, y_hat)  # [B, n_classes]
    n_layers = len(model.params)
    n_items = x.shape[0]
    # deltas, last layer backwards (BP layers need the next layer's deltas:
    # reference computeDeltas, pktnn_fc.cpp:241-343)
    deltas_list = [None] * n_layers
    bn_grads = [None] * n_layers  # (dGamma, dBeta) for BN layers
    for li in range(n_layers - 1, -1, -1):
        p, s = model.params[li], specs[li]
        gi = caches[li][2]
        if s.use_bn:
            # BN branch (pktnn_fc.cpp:244-302): upstream gradient is vanilla
            # BP from the next layer even in DFA mode
            if li == n_layers - 1:
                d_bn = div_trunc(loss_delta, gi)
            else:
                nxt = model.params[li + 1].weight
                d_bn = div_trunc(int32_matmul(deltas_list[li + 1], nxt.T), gi)
            xhat, stdev = caches[li][3]
            d_gamma = (d_bn * xhat).sum(dim=0, keepdim=True, dtype=I32)
            d_beta = d_bn.sum(dim=0, keepdim=True, dtype=I32)
            bn_grads[li] = (d_gamma, d_beta)
            gamma_stdev = div_trunc(p.gamma, stdev)  # (1, out)
            deltas_list[li] = div_trunc(
                (-d_gamma * xhat + d_bn * n_items - d_beta) * gamma_stdev,
                n_items,
            )
        elif li == n_layers - 1:
            deltas_list[li] = div_trunc(loss_delta, gi)
        elif s.use_dfa:
            deltas_list[li] = div_trunc(int32_matmul(loss_delta, p.dfa), gi)
        else:  # vanilla backprop through the next layer's weights
            nxt = model.params[li + 1].weight
            deltas_list[li] = div_trunc(int32_matmul(deltas_list[li + 1], nxt.T), gi)
    new_params = []
    for li, (p, s) in enumerate(zip(model.params, specs)):
        x_in = caches[li][0]
        deltas = deltas_list[li]
        wu = div_trunc(int32_matmul(x_in.T, deltas), -lr_inv)
        if s.use_bn:
            # gamma/beta updated instead of the bias; no clamp on them
            # (pktnn_fc.cpp:209-217)
            d_gamma, d_beta = bn_grads[li]
            new_params.append(
                FCParams(
                    torch.clamp(p.weight + wu, lo, hi),
                    p.bias,
                    p.dfa,
                    p.gamma + div_trunc(d_gamma, -lr_inv),
                    p.beta + div_trunc(d_beta, -lr_inv),
                )
            )
            continue
        ones = torch.ones((1, x_in.shape[0]), dtype=I32, device=x_in.device)
        bu = div_trunc(int32_matmul(ones, deltas), -lr_inv)
        new_params.append(
            FCParams(
                torch.clamp(p.weight + wu, lo, hi),
                torch.clamp(p.bias + bu, lo, hi),
                p.dfa,
            )
        )
    loss = batch_l2_loss(y, y_hat)
    return MLP(tuple(new_params)), loss


# ---------------------------------------------------------------------------
# Weight CSV IO (compatible with reference weights/ assets, matrix.h:134-159)
# ---------------------------------------------------------------------------


def read_csv_matrix(path) -> np.ndarray:
    """Integer matrix from a reference weight CSV (trailing commas allowed)."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [v for v in line.strip().split(",") if v.strip() != ""]
            if vals:
                rows.append([int(float(v)) for v in vals])
    return np.asarray(rows, np.int64)


def save_csv_matrix(path, mat: np.ndarray):
    """Write a matrix in the reference's CSV layout (a comma after every value)."""
    mat = np.asarray(mat)
    with open(path, "w") as f:
        for row in np.atleast_2d(mat):
            f.write(",".join(str(int(v)) for v in row) + ",\n")


# ---------------------------------------------------------------------------
# Integer convolution (reference pktmat3d conv scaffolding,
# libs/pocketnn/.../pktnn_mat3d — 3D int matrices + valid-window products;
# never used by a reference workload, provided for completeness)
# ---------------------------------------------------------------------------


class ConvSpec(NamedTuple):
    """Integer conv layer: kernel [out_ch, in_ch, k, k], valid padding."""

    in_ch: int
    out_ch: int
    ksize: int
    stride: int = 1
    actv: str = "as_is"


def conv_init(generator: torch.Generator, spec: ConvSpec, bound: int = 2) -> torch.Tensor:
    """Small random integer kernels in [-bound, bound] from `generator`, on
    its device (the JAX package draws from ``jax.random``; these draws are
    the port's own)."""
    return torch.randint(
        -bound,
        bound + 1,
        (spec.out_ch, spec.in_ch, spec.ksize, spec.ksize),
        generator=generator,
        dtype=I32,
        device=generator.device,
    )


def conv2d_int(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """Exact int32 valid conv, wrapping as int32: x [B, Ci, H, W], kernel
    [Co, Ci, Kh, Kw] -> [B, Co, OH, OW].  im2col by ``Tensor.unfold``, then
    one ``int32_matmul``."""
    co, ci, kh, kw = kernel.shape
    cols = x.to(I32).unfold(2, kh, stride).unfold(3, kw, stride)  # [B, Ci, OH, OW, Kh, Kw]
    b, _, oh, ow = cols.shape[:4]
    cols = cols.permute(0, 2, 3, 1, 4, 5).reshape(b * oh * ow, ci * kh * kw)
    out = int32_matmul(cols, kernel.to(I32).reshape(co, -1).T)  # [B*OH*OW, Co]
    return out.reshape(b, oh, ow, co).permute(0, 3, 1, 2)


def conv_forward(kernel: torch.Tensor, x: torch.Tensor, spec: ConvSpec):
    """actv(conv(x, kernel)) with the PocketNN activation table; returns
    (out, grad_inv) like fc_forward."""
    inter = conv2d_int(x, kernel, spec.stride)
    fan_in = spec.in_ch * spec.ksize * spec.ksize
    return ACTIVATIONS[spec.actv](inter, K_BIT, fan_in)
