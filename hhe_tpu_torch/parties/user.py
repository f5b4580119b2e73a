"""User party — the data owner; counterpart of ``hhe_tpu.parties.user``.

Equivalent of the reference User (``src/examples/User/User.{h,cpp}``,
``UserRPC.cpp``): loads time-series CSV data, PASTA-encrypts it, fetches the
analyst's public key, HE-encrypts the PASTA key once, and submits both to
the CSP.  ``device`` defaults to CUDA and raises without a card; pass
``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..models import pocketnn
from ..ops import bfv, pasta, transcipher
from ..ops.bfv import BFVParams, Context
from ..utils import metrics, serial
from . import rpc
from .gen import hhe_pb2 as pb


class User:
    def __init__(
        self,
        params: Optional[BFVParams] = None,
        data: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        device=None,
    ):
        self.ctx = Context(params or BFVParams(), device=device)
        self.data = data
        self.labels = labels
        self.sym_key = pasta.get_fixed_symmetric_key()  # reference User.cpp:33-36
        self.cipher = pasta.Pasta(self.sym_key, self.ctx.t)
        # experiment-report instrumentation (hhe_pktnn_examples.cpp:352-380)
        self.timer = metrics.Timer()
        self.ledger = metrics.CommLedger()

    @classmethod
    def from_csv(
        cls, data_path: str, label_path: str = "", params=None, device=None
    ) -> "User":
        data = pocketnn.read_csv_matrix(data_path)
        labels = pocketnn.read_csv_matrix(label_path) if label_path else None
        return cls(params, data, labels, device=device)

    def encrypt_data(self, rows: Optional[slice] = None) -> np.ndarray:
        """PASTA-encrypt selected rows with a decrypt self-check (reference
        encryptData, User.cpp:91-117 — which hard-codes rows 1..2; here the
        row range is a parameter defaulting to all rows)."""
        x = np.asarray(self.data, np.uint64)
        if rows is not None:
            x = x[rows]
        enc = self.cipher.encrypt(x)
        if not np.array_equal(self.cipher.decrypt(enc), x % np.uint64(self.ctx.t)):
            raise RuntimeError("symmetric roundtrip failed")
        return enc

    def encrypt_sym_key(self, pk_bytes: bytes) -> bfv.Ciphertext:
        """HE-encrypt the PASTA key under the analyst's public key (reference
        encryptSymmetricKey, User.cpp:122-138 / pastahelper.cpp:355-377)."""
        pk = serial.load_public_key(pk_bytes)
        half = self.ctx.n // 2
        vec = np.zeros(half + transcipher.T, np.int64)
        vec[: transcipher.T] = self.sym_key[: transcipher.T]
        vec[half : half + transcipher.T] = self.sym_key[transcipher.T :]
        return self.ctx.encrypt(pk, self.ctx.encode(vec))

    def submit(
        self,
        analyst_address: str,
        csp_address: str,
        patient_id: str,
        rows: Optional[slice] = None,
    ):
        """Full flow (reference UserRPC.cpp:63-94): fetch pk, encrypt key +
        data, push to CSP with analystid routing metadata."""
        aclient = rpc.analyst_client(analyst_address)
        pk_msg = aclient.call("getPublicKey", pb.Empty())
        aclient.close()

        with self.timer.phase("user"):
            enc_key = self.encrypt_sym_key(pk_msg.data)
            enc_data = self.encrypt_data(rows)

        cclient = rpc.csp_client(csp_address)
        md = (("analystid", analyst_address),)
        key_msg = pb.EncSymmetricKeysMsg()
        b = serial.dump_ciphertext(enc_key)
        key_msg.key.append(pb.CiphertextMsg(data=b, length=len(b)))
        cclient.call("addEncryptedKeys", key_msg, metadata=md)

        data_msg = pb.EncSymmetricDataMsg(patientID=patient_id)
        for row in enc_data:
            data_msg.record.append(
                pb.EncSymmetricDataRecord(value=[int(v) for v in row])
            )
        # sender-side metering: HE-encrypted key + PASTA payload
        # (reference sym_enc_data_size, pastahelper.cpp:399-411)
        self.ledger.add(
            "user-csp",
            metrics.size_mb(b) + metrics.sym_enc_data_size(enc_data),
        )
        cclient.call("addEncryptedData", data_msg, metadata=md)
        cclient.close()


def patient_id_from_path(path: str) -> str:
    """'c000101_data.txt' -> 'c000101' (reference UserRPC.cpp:50-58)."""
    base = os.path.basename(path)
    return base.split("_")[0]
