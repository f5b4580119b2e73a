"""The encrypted models' plaintext counterparts, in integers mod t.

- ECG 1FC (PocketNN 128 -> 1, the reference's ``hhe_pktnn_ecg_inference``):
  the CSP returns the slot-wise products w_i x_i, which the analyst sums;
  the reference gives those products.
- MNIST 2FC (784 -> R -> square -> 10, ``hhe_pktnn_2fc_inference``):
  ((x W1 mod t)^2 mod t) W2 mod t, the logits.

Both in signed form, (-t/2, t/2].
"""

from __future__ import annotations

import torch

I64 = torch.int64


def signed(v: torch.Tensor, t: int) -> torch.Tensor:
    v = v % t
    return torch.where(v > t // 2, v - t, v)


def ecg_products(x: torch.Tensor, w: torch.Tensor, t: int) -> torch.Tensor:
    """[B, L] records, [L] weights -> [B, L] slot products."""
    return signed(x.to(I64) * w.to(I64), t)


def mnist_logits(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, t: int) -> torch.Tensor:
    """[B, 784] images, [784, R], [R, C] -> [B, C] logits."""
    h = (x.to(I64)[:, :, None] * w1.to(I64)).sum(1) % t
    sq = h * h % t
    return signed((sq[:, :, None] * w2.to(I64)).sum(1), t)
