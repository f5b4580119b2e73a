"""Analyst party — model owner and result decryptor; counterpart of
``hhe_tpu.parties.analyst``.

Equivalent of the reference Analyst (``src/examples/Analyst/Analyst.{h,cpp}``,
``AnalystRPC.cpp``): generates the HE keys (its own + the evaluation keys
handed to the CSP, including flatten rotations for long inputs — reference
``Analyst.cpp:70-94``), encrypts the model weights, serves
``AnalystService`` (getPublicKey / addEncryptedResult), and decrypts CSP
results into predictions.

Keys come from the context's host keygen (``keygen_secret`` / ``public`` /
``relin`` / ``galois``), which draws what the JAX package draws: the same
``BFVParams`` give the same keys and so the same wire bytes.  ``device``
defaults to CUDA and raises without a card; pass ``device="cpu"`` to run on
the CPU.
"""

from __future__ import annotations

import math
import threading
import uuid as uuidlib
from typing import List, Optional

import numpy as np

from ..models import pocketnn
from ..ops import bfv, helin, transcipher
from ..ops.bfv import BFVParams, Context
from ..utils import metrics, serial
from . import rpc
from .gen import hhe_pb2 as pb


class Analyst:
    def __init__(
        self,
        params: Optional[BFVParams] = None,
        input_len: int = 300,
        seed: int = 0,
        device=None,
    ):
        self.ctx = Context(params or BFVParams(seed=seed), device=device)
        self.input_len = input_len
        self.uuid = str(uuidlib.uuid4())
        self.predictions: List[int] = []
        self.raw_results: List[int] = []
        # experiment-report instrumentation (reference closing block,
        # hhe_pktnn_examples.cpp:352-380): per-party ms + outbound MB
        self.timer = metrics.Timer()
        self.ledger = metrics.CommLedger()
        with self.timer.phase("analyst"):
            self._keygen()

    def _keygen(self):
        """All keys: analyst-held secret + evaluation keys for the CSP
        (reference generateHEKeys, Analyst.cpp:234-249)."""
        ctx = self.ctx
        self.sk = ctx.keygen_secret()
        self.pk = ctx.keygen_public(self.sk)
        self.rk = ctx.keygen_relin(self.sk)
        tc_elts = set(transcipher.galois_elts(ctx))
        tc_elts.update(helin.vec_sum_galois_elts(ctx))
        num_blocks = math.ceil(self.input_len / transcipher.T)
        flat_elts = set(helin.flatten_galois_elts(ctx, num_blocks, transcipher.T))
        self.gks = ctx.keygen_galois(self.sk, sorted(tc_elts | flat_elts))
        self.gk_elts = sorted(tc_elts)
        self.csp_gk_elts = sorted(flat_elts)

    # ------------------------------------------------------------------
    # Model encryption (reference NNModelEncryption, Analyst.cpp:386-441)
    # ------------------------------------------------------------------

    def encrypt_model(self, weight: np.ndarray) -> List[bfv.Ciphertext]:
        """weight [in_dim, out_dim] -> transpose -> one ct per output row,
        with a decrypt self-check."""
        w = np.atleast_2d(np.asarray(weight, np.int64))
        if w.shape[0] == self.input_len:
            w = w.T
        with self.timer.phase("analyst"):
            self.weight_cts = helin.encrypt_weight(self.ctx, self.pk, w)
            back = helin.decrypt_weight(self.ctx, self.sk, self.weight_cts, w.shape[1])
        if not np.array_equal(back, w):
            raise RuntimeError("weight encryption roundtrip failed")
        return self.weight_cts

    def load_and_encrypt_model(self, csv_path: str):
        return self.encrypt_model(pocketnn.read_csv_matrix(csv_path))

    # ------------------------------------------------------------------
    # Serialization for RPC
    # ------------------------------------------------------------------

    def keys_msg(self) -> pb.PublicKeySetMsg:
        def wrap(b: bytes) -> pb.PublicKeyMsg:
            return pb.PublicKeyMsg(data=b, length=len(b))

        gk = {g: self.gks[g] for g in self.gk_elts}
        csp_gk = {g: self.gks[g] for g in self.csp_gk_elts}
        return pb.PublicKeySetMsg(
            pk=wrap(serial.dump_public_key(self.pk)),
            rk=wrap(serial.dump_kswitch(self.rk)),
            gk=wrap(serial.dump_galois_keys(gk)),
            csp_rk=wrap(serial.dump_kswitch(self.rk)),
            csp_gk=wrap(serial.dump_galois_keys(csp_gk)),
            analystUUID=self.uuid,
        )

    def model_msg(self) -> pb.MLModelMsg:
        msg = pb.MLModelMsg()
        for ct in self.weight_cts:
            b = serial.dump_ciphertext(ct)
            msg.weights.append(pb.CiphertextMsg(data=b, length=len(b)))
        return msg

    # ------------------------------------------------------------------
    # Result decryption (reference decryptData, Analyst.cpp:352-381)
    # ------------------------------------------------------------------

    def decrypt_result_bytes(self, data: bytes) -> int:
        with self.timer.phase("analyst"):
            ct = serial.load_ciphertext(data, self.ctx.device)
            dec = self.ctx.decode_signed(self.ctx.decrypt(self.sk, ct))
        raw = int(dec[self.input_len - 1])
        pred = int(pocketnn.int_sigmoid(raw))
        self.raw_results.append(raw)
        self.predictions.append(pred)
        return pred


class AnalystServer:
    """gRPC server for AnalystService + client driving the CSP
    (reference AnalystRPC.cpp:91-152)."""

    def __init__(self, analyst: Analyst, address: str = "localhost:50051"):
        self.analyst = analyst
        self.address = address
        self.results_ready = threading.Event()
        self.server = rpc.serve(
            address,
            rpc.ANALYST_SERVICE,
            rpc.ANALYST_METHODS,
            {
                "getPublicKey": self._get_public_key,
                "addEncryptedResult": self._add_encrypted_result,
            },
        )

    def _get_public_key(self, request, context):
        b = serial.dump_public_key(self.analyst.pk)
        # sender-side metering: each payload is counted once, by its sender
        # (reference he_pk_key_size on the Analyst-Client edge)
        self.analyst.ledger.add("analyst-user", metrics.size_mb(b))
        return pb.PublicKeyMsg(data=b, length=len(b))

    def _add_encrypted_result(self, request, context):
        for ct_msg in request.result:
            self.analyst.decrypt_result_bytes(ct_msg.data)
        self.results_ready.set()
        return pb.Empty()

    def publish_to_csp(self, csp_address: str):
        """addPublicKeys + addMLModel with analystid metadata = own address
        (reference CSPServiceAnalystClient.cpp:6-99)."""
        client = rpc.csp_client(csp_address)
        md = (("analystid", self.address),)
        keys_msg = self.analyst.keys_msg()
        model_msg = self.analyst.model_msg()
        # ByteSize() is len(SerializeToString()) without serializing the
        # ~1.27 GB key set a second time
        self.analyst.ledger.add(
            "analyst-csp",
            keys_msg.ByteSize() / metrics.MB + model_msg.ByteSize() / metrics.MB,
        )
        client.call("addPublicKeys", keys_msg, metadata=md)
        client.call("addMLModel", model_msg, metadata=md)
        client.close()

    def stop(self):
        self.server.stop(grace=None)
