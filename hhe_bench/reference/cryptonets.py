"""CryptoNets' MNIST network's plain forward pass in integers (Gilad-Bachrach,
Dowlin, Laine, Lauter, Naehrig, Wernsing, "CryptoNets: Applying Neural
Networks to Encrypted Data with High Throughput and Accuracy", ICML 2016,
§4.1), its linear layers 3-6 (mean pool, conv, mean pool, FC) folded into
one weighted sum as the paper evaluates it:

    pad H x W to (H+1) x (W+1) below and right -> conv(1->C1, K x K,
    stride s) -> square -> flatten channel-major -> dense(C1 oh ow ->
    hidden) -> square -> dense(hidden -> classes)

with no bias; the final sigmoid is left out, as argmax does not need it.

A departure from a float32 reference: this is an integer model, and the
check is exact parity of its logits mod t, as ``hcnn.py``'s.  So it
computes in int64, exactly, with elementwise products and sums (the conv is
``hcnn.conv``).  At the benchmark's widths (every pixel 3, every weight -2,
5 maps of 5 x 5 taps, 845, 100) the partial values are at most 150, 22,500,
845 x 2 x 22,500 = 3.80e7, its square 1.45e15, and 100 x 2 x 1.45e15 =
2.9e17 < 2^63, so no sum wraps.  Runs on whichever device its inputs are
on.
"""

from __future__ import annotations

import torch

from .hcnn import conv

I64 = torch.int64


def logits(x: torch.Tensor, k1: torch.Tensor, dense: torch.Tensor, out: torch.Tensor,
           stride: int = 2, pad: int = 1) -> torch.Tensor:
    """Images x [..., 1, H, W], k1 [C1, 1, K, K], dense [hidden, C1 oh ow],
    out [classes, hidden] -> the integer logits [..., classes], the images
    padded with ``pad`` rows and columns of zeros below and right."""
    h, w = x.shape[-2:]
    padded = torch.zeros((*x.shape[:-2], h + pad, w + pad), dtype=I64, device=x.device)
    padded[..., :h, :w] = x
    a = conv(padded, k1, stride)
    a = (a * a).flatten(-3)
    b = (dense.to(I64) * a[..., None, :]).sum(-1)
    b = b * b
    return (out.to(I64) * b[..., None, :]).sum(-1)
