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
- Channels are batched ciphertext tensors ``[size, C, k, N]``: every output
  channel is one broadcast product per tap, the taps accumulate in the NTT
  domain, and one inverse NTT ends the layer.
- The FC scatters each class's weights to the slots where the flattened conv
  output lives: one batched product, a channel sum and one log-depth
  rotate-sum for all classes.

The weighted-mask plaintexts are the JAX package's, array for array, formed
another way.  The batch encoder is linear mod t, so ``encode(mask * w) =
(w * encode(mask)) mod t``: one host encode per conv layer (and one per
output slot for the FC) instead of one per (tap, in-channel, out-channel)
row, whose exact object-dtype arithmetic at the HCNN's 47-bit t would take
minutes.  The rows are then formed in int64 on the context's device, reduced
mod each q_i and taken to the NTT + Montgomery domain by ``ntt.ntt_fwd``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import bfv_eval, helin, ntt
from .bfv import Ciphertext, Context, KSwitchKey
from .modular import mont_mul

I64 = torch.int64


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
) -> Ciphertext:
    """Rotation-based encrypted conv (reference rotation_conv,
    ``speedtest_he_mnist_works.py:277-357``).

    ct: [size, Ci, k, N] (channel-batched; wrap a single packed image as
    Ci = 1).  One batched rotation per spatial tap serves every channel.
    Returns [size, Co, k, N] — output channels batched in one tensor.  The
    NTT-domain accumulator sums canonical residues in int64 (25 taps x Ci
    terms below 2^31 each) and reduces once: the JAX package's add_mod
    chain, value for value."""
    tb = ctx.tb_q
    acc = None  # NTT-domain accumulator [size, Co, k, N], int64
    for t_i, off in enumerate(conv_tap_offsets(spec, img_w)):
        rot = ct if off == 0 else bfv_eval.rotate_rows(ctx, ct, off, gks)
        f = ntt.ntt_fwd(rot.data, tb)  # [size, Ci, k, N]
        g = mont_mul(f[:, :, None], pts[t_i][None], tb.q, tb.qinv_neg).sum(1, dtype=I64)
        acc = g if acc is None else acc + g
    return Ciphertext(ntt.ntt_inv(acc % tb.q, tb))


def he_square(ctx: Context, ct: Ciphertext, rk: KSwitchKey) -> Ciphertext:
    """Square + relinearize; works on channel-batched tensors [size, Co, k, N]."""
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
    rotate-sum every slot of row 0 holds the class logit."""
    tb = ctx.tb_q
    f = ntt.ntt_fwd(ct.data, tb)  # [size, Co, k, N]
    s = mont_mul(f[:, None], fc_pts[None], tb.q, tb.qinv_neg).sum(2, dtype=I64)
    summed = Ciphertext(ntt.ntt_inv(s % tb.q, tb))  # [size, classes, k, N]
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
