"""Throw-based assertion helpers (reference ``src/util/checks.h``) —
counterpart of ``hhe_tpu.utils.checks``."""

from __future__ import annotations

import numpy as np

from ..ops import bfv
from . import serial


class CheckFailed(RuntimeError):
    pass


def are_same_vectors(a, b, msg: str = "vectors differ") -> None:
    """Reference checks::are_same_vectors (checks.h:12-30)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        raise CheckFailed(msg)


def are_same_matrices(a, b, msg: str = "matrices differ") -> None:
    """Reference checks::are_same_matrices (checks.h:32-56)."""
    are_same_vectors(np.atleast_2d(a), np.atleast_2d(b), msg)


def are_same_he_sk(sk1: bfv.SecretKey, sk2: bfv.SecretKey) -> None:
    """Assert two parties' HE secret keys DIFFER (reference
    checks::are_same_he_sk, checks.h:58-71 — serialize and compare; equality
    is the failure)."""
    if serial.dump_array(sk1.s_q) == serial.dump_array(sk2.s_q):
        raise CheckFailed("two parties share the same HE secret key")
