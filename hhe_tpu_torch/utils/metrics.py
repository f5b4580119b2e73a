"""Observability: timing, communication-cost metering, noise tracking —
counterpart of ``hhe_tpu.utils.metrics``.

Reference equivalents: ``utils::print_time`` (utils.cpp:81-86), the MB-size
accounting in ``sealhelper.cpp:279-371`` / ``pastahelper.cpp:399-411``
(he_pk_key_size / he_key_size / he_vec_size / sym_enc_data_size), and the
per-edge communication report in ``hhe_pktnn_examples.cpp:373-380``.  Sizes
are those of ``utils.serial``'s bytes, equal to the JAX package's.  Noise
budgets come from ``Context.noise_budget``; ``cipher_size`` meters a
ciphertext after ``Context.mod_switch_to_next``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, Optional

import numpy as np

from ..ops import bfv
from . import serial, trace

MB = 1024.0 * 1024.0


def size_mb(payload: bytes) -> float:
    return len(payload) / MB


def he_pk_size(pk: bfv.PublicKey) -> float:
    """Public key size in MB (reference he_pk_key_size)."""
    return size_mb(serial.dump_public_key(pk))


def he_key_size(
    rk: Optional[bfv.KSwitchKey] = None, gks: Optional[dict] = None
) -> float:
    """Relin + galois evaluation key sizes in MB (reference he_key_size)."""
    total = 0.0
    if rk is not None:
        total += size_mb(serial.dump_kswitch(rk))
    if gks:
        total += size_mb(serial.dump_galois_keys(gks))
    return total


def he_vec_size(cts: Iterable[bfv.Ciphertext]) -> float:
    """Serialized ciphertext vector size in MB (reference he_vec_size)."""
    return sum(size_mb(serial.dump_ciphertext(ct)) for ct in cts)


def he_vec_size_analytic(ct: bfv.Ciphertext) -> float:
    """Wire size in MB of a (possibly sample-batched [size, B, k, N])
    ciphertext, counting each sample as its own ``dump_ciphertext`` frame,
    from the shape alone (nothing leaves the device).  Equal to
    ``he_vec_size`` over the samples."""
    shape = tuple(ct.data.shape)
    if len(shape) == 3:
        b, per = 1, shape
    else:
        b, per = shape[1], (shape[0],) + shape[2:]
    hdr = 6 + 4 * len(per)  # serial.dump_array: <4sBB> magic/kind/ndim + dims
    return b * (int(np.prod(per)) * 4 + hdr) / MB


def cipher_size(
    ctx: bfv.Context,
    ct: bfv.Ciphertext,
    mod_switch: bool = False,
    levels_from_last: int = 0,
) -> float:
    """Ciphertext size in MB, optionally after switching down the modulus
    chain first (reference SEALZpCipher::get_cipher_size,
    SEAL_Cipher.cpp:363-378).  The reference switches to the last (1-limb)
    level and walks up ``levels_from_last`` levels, so the final limb count
    is ``1 + levels_from_last`` whatever the starting level."""
    if mod_switch:
        target = min(1 + levels_from_last, ct.data.shape[-2])
        while ct.data.shape[-2] > target:
            ct = ctx.mod_switch_to_next(ct)
    return size_mb(serial.dump_ciphertext(ct))


def sym_enc_data_size(records: np.ndarray, bits_per_word: int = 8) -> float:
    """PASTA ciphertext payload size in MB, counting 8 bytes per word as the
    reference's uint64 wire format does (reference sym_enc_data_size,
    pastahelper.cpp:399-411)."""
    return np.asarray(records).size * 8 / MB


class CommLedger:
    """Per-protocol-edge communication cost accumulator (reference
    hhe_pktnn_examples.cpp:373-380 report)."""

    def __init__(self):
        self.edges: Dict[str, float] = {}

    def add(self, edge: str, mb: float):
        self.edges[edge] = self.edges.get(edge, 0.0) + mb

    def report(self) -> Dict[str, float]:
        return dict(self.edges)


class Timer:
    """Accumulating timer per phase on the monotonic clock (reference chrono
    usage).  A phase that ends in device work should synchronise before it
    closes.  Each phase is also the span ``hhe.party.<name>``
    (``utils.trace``)."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with trace.span(f"hhe.party.{name}"):
                yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report_ms(self) -> Dict[str, float]:
        return {k: v * 1e3 for k, v in self.phases.items()}


def merge(timers: Iterable["Timer"] = (), ledgers: Iterable["CommLedger"] = ()):
    """Combine per-party timers/ledgers into one pair for the end-of-run
    experiment report (each party meters its own phases and outbound edges;
    the reference aggregates them in one closing block,
    ``hhe_pktnn_examples.cpp:352-380``)."""
    t, l = Timer(), CommLedger()
    for src in timers:
        for k, v in src.phases.items():
            t.phases[k] = t.phases.get(k, 0.0) + v
    for src in ledgers:
        for k, v in src.edges.items():
            l.add(k, v)
    return t, l


def experiment_report(
    timer: "Timer",
    ledger: "CommLedger",
    accuracy: Optional[float] = None,
    extra: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """The reference's end-of-run experiment report (the closing block of
    every workload, ``hhe_pktnn_examples.cpp:352-380``): accuracy, per-party
    computation cost in ms (Analyst / Client / CSP / Total), and per-edge
    communication cost in MB.

    Returns {"accuracy", "computation_ms": {party: ms, "total": ms},
    "communication_mb": {edge: mb, "total": mb}}."""
    comp = {k: round(v, 2) for k, v in timer.report_ms().items()}
    comp["total"] = round(sum(timer.report_ms().values()), 2)
    comm = {k: round(v, 4) for k, v in ledger.report().items()}
    comm["total"] = round(sum(ledger.report().values()), 4)
    out: Dict[str, object] = {"computation_ms": comp, "communication_mb": comm}
    if accuracy is not None:
        out["accuracy"] = accuracy
    if extra:
        out.update(extra)
    return out


def format_experiment_report(report: Dict[str, object]) -> str:
    """Pretty-print an experiment_report() dict in the reference's style
    (``hhe_pktnn_examples.cpp:352-380``)."""
    lines = ["--------------------- EXPERIMENT RESULTS ---------------------"]
    if "accuracy" in report:
        lines.append(f"Accuracy: {report['accuracy']}")
    lines.append("---- Computation cost ----")
    for k, v in report.get("computation_ms", {}).items():
        lines.append(print_time(f"{k} time", float(v)))
    lines.append("---- Communication cost ----")
    for k, v in report.get("communication_mb", {}).items():
        lines.append(f"{k}: {v} (Mb)")
    return "\n".join(lines)


def print_time(name: str, ms: float) -> str:
    """Format like reference utils::print_time."""
    return f"{name}: {ms:.0f} (ms) = {ms/1e3:.3f} (s) = {ms/6e4:.3f} (min)"


def print_parameters(ctx) -> str:
    """Human-readable context summary (reference sealhelper::print_parameters,
    sealhelper.cpp:46-96). Returns the string and prints it."""
    q_bits = [int(q).bit_length() for q in ctx.q_moduli]
    lines = [
        "/",
        "| Encryption parameters :",
        "|   scheme: BFV (RNS, u32 Montgomery limbs)",
        f"|   poly_modulus_degree: {ctx.n}",
        f"|   coeff_modulus size: {sum(q_bits)} ({' + '.join(map(str, q_bits))}) bits"
        f" + special {int(ctx.p_special).bit_length()} bits",
        f"|   plain_modulus: {ctx.t}",
        f"|   slots: {ctx.n} (2 x {ctx.n // 2} rows/columns)",
        "\\",
    ]
    out = "\n".join(lines)
    print(out)
    return out


def print_noise(ctx, sk, cts, tag: str = "ciphertext") -> list:
    """Noise budgets of one or many ciphertexts (reference
    SEALZpCipher::print_noise, SEAL_Cipher.cpp:71-99)."""
    if isinstance(cts, bfv.Ciphertext):  # NamedTuples iterate over fields
        cts = [cts]
    budgets = [ctx.noise_budget(sk, ct) for ct in cts]
    if len(budgets) == 1:
        print(f"{tag} noise budget: {budgets[0]} bits")
    else:
        print(
            f"{tag} noise budgets: min {min(budgets)} / max {max(budgets)} bits"
            f" over {len(budgets)} cts"
        )
    return budgets
