"""Integer sigmoids and weight CSV IO of the HHE pipeline — the part of
``hhe_tpu.models.pocketnn`` that the encrypted workloads need:
``simple_pocket_sigmoid`` (reference ``src/util/utils.cpp:56-76``) and
``int_sigmoid`` (``src/util/utils.h:94-100``), on int32 tensors with C-style
truncating division; ``read_csv_matrix`` / ``save_csv_matrix`` for the
reference's weight files (``matrix.h:134-159``).
"""

from __future__ import annotations

import numpy as np
import torch

PKT_MAX = 127

_JOINTS = (-127, -74, -31, 32, 75, 128)


def div_trunc(a: torch.Tensor, b) -> torch.Tensor:
    """C-style integer division (truncate toward zero)."""
    return torch.div(a, b, rounding_mode="trunc").to(a.dtype)


def _piecewise(x, joints, fns, ymin, ymax):
    """fns[i] on [joints[i], joints[i+1]); ymin below, ymax from joints[-1]."""
    out = torch.full_like(x, ymin)
    conds = [x < j for j in joints]
    for i, fn in enumerate(fns):
        seg = (~conds[i]) & conds[i + 1]
        out = torch.where(seg, fn(x), out)
    return torch.where(~conds[-1], torch.full_like(x, ymax), out)


def simple_pocket_sigmoid(x) -> torch.Tensor:
    """7-segment integer sigmoid used at analyst decrypt time; ints or arrays."""
    x = torch.as_tensor(x).to(torch.int32)
    return _piecewise(
        x,
        _JOINTS,
        [
            lambda v: div_trunc(v, 8) + 20,
            lambda v: div_trunc(v, 2) + 48,
            lambda v: v + 64,
            lambda v: div_trunc(v, 2) + 80,
            lambda v: div_trunc(v, 8) + 108,
        ],
        1,
        PKT_MAX,
    )


def int_sigmoid(x) -> torch.Tensor:
    """Step function: 0 for x <= 0, else 1."""
    x = torch.as_tensor(x)
    return (x > 0).to(torch.int32)


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
