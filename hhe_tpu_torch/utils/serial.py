"""Binary array container — the ``dump_array`` part of
``hhe_tpu.utils.serial``: magic, version, kind tag, shape, raw little-endian
u32/int8 data (the same bytes as the JAX package writes)."""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..ops.ntt import u32_to_numpy

MAGIC = b"HHE1"
_KIND_U32 = 0
_KIND_I8 = 1


def dump_array(arr) -> bytes:
    if isinstance(arr, torch.Tensor):  # residue tensors hold u32 bits
        arr = u32_to_numpy(arr)
    arr = np.asarray(arr)
    if arr.dtype == np.int8:
        kind, data = _KIND_I8, arr.astype(np.int8)
    else:
        kind, data = _KIND_U32, arr.astype(np.uint32)
    hdr = struct.pack("<4sBB", MAGIC, kind, data.ndim) + struct.pack(
        f"<{data.ndim}I", *data.shape
    )
    return hdr + data.tobytes()
