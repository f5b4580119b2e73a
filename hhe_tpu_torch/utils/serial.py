"""Binary serialization of ciphertexts and keys — the writing half of
``hhe_tpu.utils.serial``: magic, version, kind tag, shape, raw little-endian
u32/int8 data, byte for byte what the JAX package writes (``utils.metrics``
sizes protocol messages with these).  Reading back and the gRPC wire belong
to the parties."""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..ops import bfv
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


def dump_ciphertext(ct: bfv.Ciphertext) -> bytes:
    return dump_array(ct.data)


def dump_public_key(pk: bfv.PublicKey) -> bytes:
    return dump_array(pk.data)


def dump_kswitch(k: bfv.KSwitchKey) -> bytes:
    a = dump_array(k.k0)
    b = dump_array(k.k1)
    return struct.pack("<I", len(a)) + a + b


def dump_galois_keys(gks: dict) -> bytes:
    out = [struct.pack("<I", len(gks))]
    for g, k in sorted(gks.items()):
        kb = dump_kswitch(k)
        out.append(struct.pack("<II", g, len(kb)))
        out.append(kb)
    return b"".join(out)
