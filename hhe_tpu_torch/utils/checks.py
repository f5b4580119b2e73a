"""Throw-based assertion helpers (reference ``src/util/checks.h``) —
counterpart of ``hhe_tpu.utils.checks``."""

from __future__ import annotations

from ..ops import bfv
from . import serial


class CheckFailed(RuntimeError):
    pass


def are_same_he_sk(sk1: bfv.SecretKey, sk2: bfv.SecretKey) -> None:
    """Assert two parties' HE secret keys DIFFER (reference
    checks::are_same_he_sk, checks.h:58-71 — serialize and compare; equality
    is the failure)."""
    if serial.dump_array(sk1.s_q) == serial.dump_array(sk2.s_q):
        raise CheckFailed("two parties share the same HE secret key")
