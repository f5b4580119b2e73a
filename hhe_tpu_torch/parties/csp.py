"""CSP party — the compute server running the GPU engine; counterpart of
``hhe_tpu.parties.csp``.

Equivalent of the reference CSP (``src/examples/CSP/CSP.{h,cpp}``,
``CSPRPC.cpp``): multi-analyst state keyed by the ``analystid`` request
metadata, transciphering (decomposition) of user data on arrival,
decomposition-file checkpointing, encrypted model evaluation, and the result
callback to the analyst.  Decomposition and evaluation are the workload's
``hhe_inference.csp_decompose`` and ``csp_eval_1fc`` (with the log-depth
sum) on a stack of the analyst's keys.

Fixes replicated-by-design deficiencies of the reference: per-analyst state
is guarded by a lock and per-request values are not leaked across requests
(the reference's unlocked, never-cleared ``values`` member,
``CSPRPC.h:83`` / ``CSPRPC.cpp:169-174``).

Handlers run on gRPC's worker threads.  Their CUDA work goes to each
thread's current stream, which is the device's default stream unless a
caller sets another, so it stays in order with everything else on the card.
Decomposition and evaluation hold ``device_lock``: the transcipher's
keystream caches and the context's lazily built constants are plain dicts,
and one card runs one request's kernels at a time anyway.  ``device``
defaults to CUDA and raises without a card; pass ``device="cpu"`` to run on
the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from ..ops import bfv, transcipher
from ..ops.bfv import BFVParams, Context
from ..utils import metrics, serial
from ..utils.config import RunConfig
from ..workloads import hhe_inference
from . import rpc
from .gen import hhe_pb2 as pb


@dataclasses.dataclass
class AnalystState:
    uuid: str = ""
    address: str = ""
    # the analyst's public and evaluation keys and a Transcipher on them (no
    # secret key); it holds the 1FC evaluation's graph unit, which reads the
    # keys by address and goes with them
    stack: Optional[hhe_inference.HHEStack] = None
    weight_cts: Optional[List[bfv.Ciphertext]] = None
    enc_key: Optional[bfv.Ciphertext] = None
    # submission length, recorded at addEncryptedData time and used by the
    # evaluate paths (the reference hard-codes 300 at CSPRPC.cpp:196 — a
    # deficiency deliberately not replicated)
    input_len: Optional[int] = None


def check_name(what: str, value: str) -> str:
    """A patient id or analyst UUID from the wire, which becomes part of a
    checkpoint file name in the CSP's workdir: empty, path separators, NUL
    and ``..`` raise ``ValueError`` (DATA_LOSS on the wire)."""
    if not value or any(bad in value for bad in ("/", "\\", "\0", "..")):
        raise ValueError(f"{what} {value!r} cannot name a file in the workdir")
    return value


class CSP:
    def __init__(
        self,
        params: Optional[BFVParams] = None,
        workdir: str = ".",
        run_config: Optional[RunConfig] = None,
        device=None,
    ):
        self.ctx = Context(params or BFVParams(), device=device)
        self.workdir = workdir
        self.run = run_config or RunConfig()
        self.analysts: Dict[str, AnalystState] = {}
        self.uuid_to_id: Dict[str, str] = {}
        self.lock = threading.RLock()
        self.device_lock = threading.Lock()
        # The CSP holds its OWN HE keypair, distinct from every analyst's
        # (reference CSP.cpp:220-230; the protocol check checks.h:58-71
        # asserts the two parties' secret keys differ). It is never used to
        # decrypt analyst data.
        self.sk = self.ctx.keygen_secret()
        self.pk = self.ctx.keygen_public(self.sk)
        # experiment-report instrumentation (hhe_pktnn_examples.cpp:352-380)
        self.timer = metrics.Timer()
        self.ledger = metrics.CommLedger()

    def _log(self, msg: str):
        if self.run.verbose:
            print(f"[CSP] {msg}", flush=True)

    def state(self, analyst_id: str) -> AnalystState:
        with self.lock:
            return self.analysts.setdefault(analyst_id, AnalystState())

    # ------------------------------------------------------------------
    # Key / model / data ingestion (reference CSPRPC.cpp:7-157)
    # ------------------------------------------------------------------

    def add_public_keys(self, analyst_id: str, msg: pb.PublicKeySetMsg):
        uuid = check_name("analystUUID", msg.analystUUID)
        st = self.state(analyst_id)
        dev = self.ctx.device
        with self.lock:
            st.address = analyst_id
            st.uuid = uuid
            pk = serial.load_public_key(msg.pk.data)
            rk = serial.load_kswitch(msg.rk.data, dev)
            gks = serial.load_galois_keys(msg.gk.data, dev)
            gks.update(serial.load_galois_keys(msg.csp_gk.data, dev))
            tc = transcipher.Transcipher(self.ctx, rk, gks)
            st.stack = hhe_inference.HHEStack(self.ctx, None, pk, rk, gks, tc)
            self.uuid_to_id[msg.analystUUID] = analyst_id

    def add_ml_model(self, analyst_id: str, msg: pb.MLModelMsg):
        st = self.state(analyst_id)
        with self.lock:
            st.weight_cts = [
                serial.load_ciphertext(w.data, self.ctx.device) for w in msg.weights
            ]

    def add_encrypted_keys(self, analyst_id: str, msg: pb.EncSymmetricKeysMsg):
        st = self.state(analyst_id)
        with self.lock:
            st.enc_key = serial.load_ciphertext(msg.key[0].data, self.ctx.device)

    def add_encrypted_data(
        self, analyst_id: str, records: np.ndarray, patient_id: str
    ) -> str:
        """Synchronously decompose + checkpoint to file (reference
        CSPRPC.cpp:162-222; file writer CSP.cpp:495-517).  Returns the
        decomposition file path.  The file is the batch's only copy: the
        JAX package also keeps the batch in device memory, which nothing
        reads and nothing frees."""
        check_name("patientID", patient_id)
        st = self.state(analyst_id)
        check_name("analystUUID", st.uuid)
        input_len = records.shape[1]
        self._log(f"decomposing {records.shape[0]} records of length {input_len}")
        with self.device_lock, self.timer.phase("csp"):
            data_ct = hhe_inference.csp_decompose(st.stack, st.enc_key, records)
            cts = hhe_inference.split_batch(data_ct)
            self.ctx.synchronize()
        fname = os.path.join(self.workdir, f"{patient_id}_{st.uuid}.bin")
        with open(fname, "wb") as f:
            f.write(serial.dump_ciphertext_vec(cts))
        with self.lock:
            st.input_len = input_len
        return fname

    # ------------------------------------------------------------------
    # Evaluation (reference CSP.cpp:288-323)
    # ------------------------------------------------------------------

    def evaluate_model(
        self, analyst_id: str, cts: List[bfv.Ciphertext], input_len: Optional[int] = None
    ) -> List[bfv.Ciphertext]:
        st = self.state(analyst_id)
        if input_len is None:
            input_len = st.input_len
        self._log(f"evaluating {len(cts)} cts (input_len={input_len})")
        with self.device_lock, self.timer.phase("csp"):
            out = [hhe_inference.csp_eval_1fc(st.stack, ct, st.weight_cts[0], do_sum=True)
                   for ct in cts]
            self.ctx.synchronize()
        return out


class CSPServer:
    """gRPC server for CSPService (reference CSPRPC.cpp:358-392)."""

    def __init__(self, csp: CSP, address: str = "localhost:50052"):
        self.csp = csp
        self.address = address
        self.server = rpc.serve(
            address,
            rpc.CSP_SERVICE,
            rpc.CSP_METHODS,
            {
                "addPublicKeys": self._add_public_keys,
                "addEncryptedKeys": self._add_encrypted_keys,
                "addEncryptedData": self._add_encrypted_data,
                "addMLModel": self._add_ml_model,
                "evaluateModel": self._evaluate_model,
                "evaluateModelFromFile": self._evaluate_model_from_file,
            },
        )

    @staticmethod
    def _analyst_id(context) -> str:
        """Routing metadata (reference getAnalystId, CSPRPC.cpp:316-327)."""
        for k, v in context.invocation_metadata():
            if k == "analystid":
                return v
        return ""

    def _add_public_keys(self, request, context):
        self.csp.add_public_keys(self._analyst_id(context), request)
        return pb.Empty()

    def _add_ml_model(self, request, context):
        self.csp.add_ml_model(self._analyst_id(context), request)
        return pb.Empty()

    def _add_encrypted_keys(self, request, context):
        self.csp.add_encrypted_keys(self._analyst_id(context), request)
        return pb.Empty()

    def _add_encrypted_data(self, request, context):
        records = np.asarray(
            [list(r.value) for r in request.record], np.uint64
        )
        self.csp.add_encrypted_data(
            self._analyst_id(context), records, request.patientID
        )
        return pb.Empty()

    def _push_results(self, analyst_id: str, results):
        st = self.csp.state(analyst_id)
        client = rpc.analyst_client(st.address)
        msg = pb.CiphertextResult()
        for ct in results:
            b = serial.dump_ciphertext(ct)
            msg.result.append(pb.CiphertextMsg(data=b, length=len(b)))
        # sender-side metering: result cts ride the Analyst-CSP edge
        self.csp.ledger.add(
            "analyst-csp", metrics.size_mb(msg.SerializeToString())
        )
        client.call("addEncryptedResult", msg)
        client.close()

    def _evaluate_model(self, request, context):
        analyst_id = self.csp.uuid_to_id.get(request.analystID, request.analystID)
        cts = []
        for b in request.HHEDecomp:
            cts.extend(serial.load_ciphertext_vec(b, self.csp.ctx.device))
        results = self.csp.evaluate_model(analyst_id, cts)
        self._push_results(analyst_id, results)
        return pb.Empty()

    def _evaluate_model_from_file(self, request, context):
        """Resume from a decomposition checkpoint; the analyst UUID is parsed
        from '<patientID>_<analystUUID>.bin' (reference CSPRPC.cpp:278-310)."""
        fname = request.filename
        base = os.path.basename(fname)
        uuid = base[base.rindex("_") + 1 :].removesuffix(".bin")
        analyst_id = self.csp.uuid_to_id[uuid]
        with open(os.path.join(self.csp.workdir, base), "rb") as f:
            cts = serial.load_ciphertext_vec(f.read(), self.csp.ctx.device)
        results = self.csp.evaluate_model(analyst_id, cts)
        self._push_results(analyst_id, results)
        return pb.Empty()

    def stop(self):
        self.server.stop(grace=None)
