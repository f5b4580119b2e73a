"""The HCNN's plain forward pass in integers: the reference's pure-HE MNIST
model (harpocrates-project, ``qat/src/speedtest_he_mnist_works.py:277-357``;
the QAT ``MNISTConvQuantModel``)

    conv(1->C1, K x K, stride s) -> square -> conv(C1->C2, K x K, stride s)
    -> flatten channel-major -> square -> fc(C2 oh ow -> classes)

with no padding and no bias, on images of 2-bit pixels and 2-bit weights.

A departure from a float32 reference: this is an integer model, and the
check is exact parity of its logits mod t, as the reference's own
(``speedtest:470-520``, ``hhe_pktnn_examples.cpp:692-699``).  So it
computes in int64, exactly, with elementwise products and sums: a conv is
the sum over its K^2 taps of the strided slice [..., Ci, oh, ow] times the
tap's [Co, Ci] weights, summed over Ci (no matmul: CUDA has none in int64).
At the benchmark's widths the largest logit is below 5.1e16 < 2^63 (every
pixel 3, every weight -2: 150, 22,500, 5,625,000 and 800 x 2 x 5,625,000^2),
so no sum wraps.  Runs on whichever device its inputs are on.
"""

from __future__ import annotations

import torch

I64 = torch.int64


def conv(x: torch.Tensor, k: torch.Tensor, stride: int) -> torch.Tensor:
    """x [..., Ci, H, W], k [Co, Ci, K, K] -> [..., Co, oh, ow]."""
    co, ci, kh, kw = k.shape
    h, w = x.shape[-2:]
    oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
    x, k = x.to(I64), k.to(I64)
    out = torch.zeros((*x.shape[:-3], co, oh, ow), dtype=I64, device=x.device)
    for j in range(kh):
        for i in range(kw):
            patch = x[..., j:j + stride * (oh - 1) + 1:stride, i:i + stride * (ow - 1) + 1:stride]
            out += (k[:, :, j, i, None, None] * patch[..., None, :, :, :]).sum(-3)
    return out


def logits(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor, fc: torch.Tensor,
           stride: int = 2) -> torch.Tensor:
    """Images x [..., 1, H, W], k1 [C1, 1, K, K], k2 [C2, C1, K, K], fc
    [classes, C2 oh ow] -> the integer logits [..., classes]."""
    a = conv(x, k1, stride)
    b = conv(a * a, k2, stride)
    b = (b * b).flatten(-3)
    return (fc.to(I64) * b[..., None, :]).sum(-1)
