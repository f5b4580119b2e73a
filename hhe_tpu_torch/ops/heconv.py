"""Encrypted convolution, the rotation-conv HCNN path — counterpart of
``hhe_tpu.ops.heconv``.

Evaluates the QAT HCNN of the reference's pure-HE MNIST speed test
(``qat/src/speedtest_he_mnist_works.py:277-357`` ``rotation_conv``, Pyfhel,
BFV n=16384, t_bits=47):

    conv(1->5, 5x5, stride 2) -> square -> conv(5->50, 5x5, stride 2)
    -> flatten -> square -> fc(800->10)

- The image is packed row-major in slots; each kernel tap is one Galois
  rotation of the encrypted input, shared by every channel.
- Stride-s outputs stay on the input's slot grid (the reference's
  "data_stride" dilation), so the next layer scales its tap offsets.
- Channels are batched ciphertext tensors ``[size, C, k, N]``.  A layer's
  taps go through the forward NTT in groups, and each group contracts over
  (tap, in-channel) against its plaintexts in one ``mont_mac`` (K4 on the
  card), every output channel at once; one ``sum_mod`` (K5) adds the
  groups, and one inverse NTT ends the layer.
- The FC scatters each class's weights to the slots where the flattened conv
  output lives: the channel contraction in ``mont_mac`` groups as the
  conv's, and one log-depth rotate-sum for all classes.

The weighted-mask plaintexts are the JAX package's, array for array, formed
another way.  The batch encoder is linear mod t, so ``encode(mask * w) =
(w * encode(mask)) mod t``: one host encode per conv layer (and one per
output slot for the FC) instead of one per (tap, in-channel, out-channel)
row, whose exact object-dtype arithmetic at the HCNN's 47-bit t would take
minutes.  The rows are then formed in int64 on the context's device, reduced
mod each q_i and taken to the NTT + Montgomery domain by ``ntt.ntt_fwd``.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils import trace
from . import bfv_eval, helin, mod_kernels, ntt
from .bfv import Ciphertext, Context, KSwitchKey
from .modular import mont_mac, sum_mod

I64 = torch.int64

# ciphertext rows key-switched, by stage: a rotation or relinearisation of a
# ciphertext [2, C, k, N] counts C rows ("conv": the taps' rotations,
# "square": the relinearisations, "fc": the rotate-sum's rotations)
KEYSWITCH_ROWS: collections.Counter = collections.Counter()
# the contractions (K4 launches on the card) and the terms they summed, by
# stage: "<stage>.launches", "<stage>.terms" ("conv1", "conv2", "fc"; "conv"
# for a conv layer given no stage name)
CONTRACTIONS: collections.Counter = collections.Counter()


def _rows(ct: Ciphertext) -> int:
    return math.prod(ct.data.shape[1:-2])


def group_size(count: int, per: int) -> int:
    """How many of a contraction's ``count`` items (a conv layer's taps of
    ``per`` in-channel terms each, or the FC's channels, ``per`` 1) one
    ``mont_mac`` sums: the most, dividing ``count``, whose terms' staged tile
    fits a 64-thread fan-out block in ``mod_kernels.SMEM_BUDGET``, which
    leaves several blocks an SM and the loads in flight that the HBM rate
    needs.  A ``sum_mod`` adds the groups."""
    fits = [d for d in range(1, count + 1) if count % d == 0
            and mod_kernels.fan_smem("fanout", d * per, 0, 64) <= mod_kernels.SMEM_BUDGET]
    return max(fits, default=1)


def _contract(stage: str, a, b, tb, dim: int, out: torch.Tensor):
    """``out`` = the sum over axis ``dim`` of mont_mul(a, b) mod q."""
    mont_mac(a, b, tb.q, tb.qinv_neg, dim, out=out)
    CONTRACTIONS[f"{stage}.launches"] += 1
    CONTRACTIONS[f"{stage}.terms"] += a.shape[dim]


def _sum_groups(acc: torch.Tensor, tb) -> torch.Tensor:
    """The groups' partial contractions [G, ...] added mod q."""
    return acc[0] if len(acc) == 1 else sum_mod(acc, tb.q, 0)


class ConvSpec(NamedTuple):
    """One conv layer on the slot grid.

    in_shape: (Ci, H, W) logical input dims; grid_stride: dilation of the
    input on the slot grid (1 for the raw image, product of previous strides
    after).  Channels are batched ciphertext tensors [size, Ci, k, N], so
    taps are purely spatial and one rotation serves every channel."""

    kernel: np.ndarray  # [Co, Ci, Kh, Kw] int
    in_shape: Tuple[int, int, int]
    stride: int
    grid_stride: int


def conv_out_shape(spec: ConvSpec) -> Tuple[int, int, int]:
    ci, h, w = spec.in_shape
    co, _, kh, kw = spec.kernel.shape
    return (co, (h - kh) // spec.stride + 1, (w - kw) // spec.stride + 1)


def conv_tap_offsets(spec: ConvSpec, img_w: int) -> List[int]:
    """Slot rotation offset of each spatial (j, i) kernel tap."""
    _, _, kh, kw = spec.kernel.shape
    g = spec.grid_stride
    return [(j * img_w + i) * g for j in range(kh) for i in range(kw)]


def conv_galois_elts(ctx: Context, specs: Sequence[ConvSpec], img_w: int) -> List[int]:
    """All Galois elements the encrypted HCNN needs (conv taps + log-sum)."""
    elts = set()
    for spec in specs:
        for off in conv_tap_offsets(spec, img_w):
            if off:
                elts.add(ctx.galois_elt_from_step(off))
    for g in helin.vec_sum_galois_elts(ctx):
        elts.add(g)
    return sorted(elts)


def _valid_mask(spec: ConvSpec, img_w: int, n_slots: int) -> np.ndarray:
    """1 at the slot of each (oy, ox) output position (input-grid coords)."""
    _, oh, ow = conv_out_shape(spec)
    g = spec.grid_stride * spec.stride
    m = np.zeros(n_slots, np.int64)
    for oy in range(oh):
        for ox in range(ow):
            m[(oy * img_w + ox) * g] = 1
    return m


def _weighted_polys(ctx: Context, basis: np.ndarray, weights: np.ndarray) -> torch.Tensor:
    """Plaintext polys of sum_u weights[:, u] * (the slot vector that
    encodes to basis[u]), by linearity: [R, N] int64 mod t on the context's
    device.  basis: [U, N] encoded polys mod t; weights: [R, U] ints with
    |w| t < 2^63, so that each product is exact in int64."""
    w = np.asarray(weights, np.int64)
    if int(np.abs(w).max(initial=0)) >= (1 << 63) // ctx.t:
        raise ValueError(f"weights up to {int(np.abs(w).max())} overflow int64 against t={ctx.t}")
    dev = ctx.device
    e = torch.from_numpy(np.asarray(basis, np.uint64).astype(np.int64)).to(dev)
    wt = torch.from_numpy(w).to(dev)
    acc = torch.zeros((w.shape[0], ctx.n), dtype=I64, device=dev)
    for u in range(w.shape[1]):
        acc = (acc + wt[:, u, None] * e[u]) % ctx.t
    return acc


def _plain_for_mul(ctx: Context, polys: torch.Tensor) -> torch.Tensor:
    """[..., N] int64 plaintext polys mod t -> [..., k, N] int32 NTT +
    Montgomery form over q (``Context.plain_for_mul_batch``'s values), on
    the context's device."""
    tb = ctx.tb_q
    return ntt.to_mont(ntt.ntt_fwd(polys[..., None, :] % tb.q, tb), tb)


def conv_plaintexts(ctx: Context, spec: ConvSpec, img_w: int) -> torch.Tensor:
    """Weight-and-validity-masked plaintexts per (spatial tap, in-channel,
    out-channel): [taps, Ci, Co, k, N] NTT+Mont — one fused multiply per tap.
    Built one tap at a time from the one encoded mask."""
    co, ci_n, kh, kw = spec.kernel.shape
    enc_mask = ctx.encode(_valid_mask(spec, img_w, ctx.n // 2)).data[None]
    kernel = np.asarray(spec.kernel, np.int64)
    out = torch.empty((kh * kw, ci_n, co, ctx.k, ctx.n), dtype=torch.int32, device=ctx.device)
    for j in range(kh):
        for i in range(kw):
            w = kernel[:, :, j, i].T.reshape(-1, 1)  # rows (ci, o), as the JAX package's
            out[j * kw + i] = _plain_for_mul(ctx, _weighted_polys(ctx, enc_mask, w)).reshape(
                ci_n, co, ctx.k, ctx.n)
    return out


def he_conv2d(
    ctx: Context,
    ct: Ciphertext,
    spec: ConvSpec,
    pts: torch.Tensor,
    gks: Dict[int, KSwitchKey],
    img_w: int,
    stage: str = "conv",
) -> Ciphertext:
    """Rotation-based encrypted conv (reference rotation_conv,
    ``speedtest_he_mnist_works.py:277-357``).

    ct: [size, Ci, k, N] (channel-batched; wrap a single packed image as
    Ci = 1).  One batched rotation per spatial tap serves every channel.
    Returns [size, Co, k, N] — output channels batched in one tensor.  The
    taps go in groups of ``group_size``: a group's rotations, stacked
    [size, T, Ci, k, N], take one forward NTT and contract over (tap,
    in-channel) against its plaintexts [T, Ci, Co, k, N] in one
    ``mont_mac``; ``sum_mod`` adds the groups.  Both sum the canonical
    products exactly and reduce once: the JAX package's add_mod chain, value
    for value.  ``stage`` names the layer in ``CONTRACTIONS``."""
    tb = ctx.tb_q
    offs = conv_tap_offsets(spec, img_w)
    size, ci, *kn = ct.data.shape
    taps = group_size(len(offs), ci)
    with trace.span("hhe.hcnn.conv"):
        acc = torch.empty((len(offs) // taps, size, pts.shape[2], *kn), dtype=torch.int32,
                          device=ct.data.device)
        for g in range(len(acc)):
            rots = []
            for off in offs[g * taps:(g + 1) * taps]:
                if off:
                    rots.append(bfv_eval.rotate_rows(ctx, ct, off, gks).data)
                    KEYSWITCH_ROWS["conv"] += _rows(ct)
                else:
                    rots.append(ct.data)
            f = ntt.ntt_fwd(torch.stack(rots, 1), tb).view(size, taps * ci, 1, *kn)
            _contract(stage, f, pts[g * taps:(g + 1) * taps].flatten(0, 1), tb, 1, acc[g])
        return Ciphertext(ntt.ntt_inv(_sum_groups(acc, tb), tb))


def he_square(ctx: Context, ct: Ciphertext, rk: KSwitchKey) -> Ciphertext:
    """Square + relinearize; works on channel-batched tensors [size, Co, k, N]."""
    with trace.span("hhe.hcnn.square"):
        KEYSWITCH_ROWS["square"] += _rows(ct)
        return bfv_eval.relinearize(ctx, bfv_eval.square(ctx, ct), rk)


def fc_plaintexts(
    ctx: Context, weight: np.ndarray, spec_last: ConvSpec, img_w: int
) -> torch.Tensor:
    """Scatter each FC class-weight vector to the slots where the flattened
    conv output lives: [classes, Co, k, N] NTT+Mont.  Each (class, channel)
    row combines the encodes of the oh * ow slot unit vectors."""
    co, oh, ow = conv_out_shape(spec_last)
    g = spec_last.grid_stride * spec_last.stride
    classes = weight.shape[0]
    assert weight.shape[1] == co * oh * ow, (weight.shape, co, oh, ow)
    units = np.zeros((oh * ow, ctx.n // 2), np.int64)
    for oy in range(oh):
        for ox in range(ow):
            units[oy * ow + ox, (oy * img_w + ox) * g] = 1
    w = np.asarray(weight, np.int64).reshape(classes * co, oh * ow)
    polys = _weighted_polys(ctx, ctx.encode_batch(units), w)
    return _plain_for_mul(ctx, polys).reshape(classes, co, ctx.k, ctx.n)


def he_fc_from_conv(
    ctx: Context,
    ct: Ciphertext,
    fc_pts: torch.Tensor,
    gks: Dict[int, KSwitchKey],
) -> Ciphertext:
    """FC over the channel-batched conv output without repacking.

    ct: [size, Co, k, N]; fc_pts: [classes, Co, k, N].  Returns a
    class-batched ciphertext [size, classes, k, N]; after the log-depth
    rotate-sum every slot of row 0 holds the class logit.  The channels
    contract in ``mont_mac`` groups of ``group_size`` as a conv's taps."""
    tb = ctx.tb_q
    with trace.span("hhe.hcnn.fc"):
        f = ntt.ntt_fwd(ct.data, tb)[:, None]  # [size, 1, Co, k, N]
        size, _, co, *kn = f.shape
        per = group_size(co, 1)
        acc = torch.empty((co // per, size, fc_pts.shape[0], *kn), dtype=torch.int32, device=f.device)
        for g in range(len(acc)):
            _contract("fc", f[:, :, g * per:(g + 1) * per], fc_pts[:, g * per:(g + 1) * per], tb, 2,
                      acc[g])
        summed = Ciphertext(ntt.ntt_inv(_sum_groups(acc, tb), tb))  # [size, classes, k, N]
        KEYSWITCH_ROWS["fc"] += _rows(summed) * int(math.log2(ctx.n // 2))  # the rotate-sum's
        return helin.encrypted_vec_sum_log(ctx, summed, gks)


# ---------------------------------------------------------------------------
# Plaintext integer golden model (matches the QAT integer forward exactly)
# ---------------------------------------------------------------------------


def conv2d_int(x: np.ndarray, kernel: np.ndarray, stride: int) -> np.ndarray:
    """Integer conv, no padding: x [Ci, H, W], kernel [Co, Ci, Kh, Kw]."""
    ci, h, w = x.shape
    co, _, kh, kw = kernel.shape
    oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
    out = np.zeros((co, oh, ow), np.int64)
    for oy in range(oh):
        for ox in range(ow):
            patch = x[:, oy * stride : oy * stride + kh, ox * stride : ox * stride + kw]
            out[:, oy, ox] = np.tensordot(kernel, patch, axes=([1, 2, 3], [0, 1, 2]))
    return out


def hcnn_forward_int(
    x: np.ndarray, k1: np.ndarray, k2: np.ndarray, fc: np.ndarray
) -> np.ndarray:
    """Integer HCNN forward (conv-square-conv-square-fc), the parity target."""
    a = conv2d_int(x, k1, 2)
    a = a * a
    b = conv2d_int(a, k2, 2)
    b = (b * b).reshape(-1)
    return fc @ b
