"""A run whose timed path is broken underneath comes out not correct: the
whole run but the look for a card, on the CPU at a small size (N=1024, 11
limbs, 4 records a request), once for each fault the cells can have, and
once for each fault of the evaluation with the users' BFV uploads.  The
exchange between cards is not among them: every cell runs on one card."""

import pytest
import torch

from hhe_bench import harness

SMALL = {"n": 1024, "data_limbs": 11}
FEW = {"records_per_request": 4, "check_requests": 2}


def broken(fault):
    def patch(h, entry):
        request = entry.request
        q = h.scheme.qcol.to(torch.int32)

        def faulty(nonce, upload, span, sync):
            if fault == "transcipher_other_nonce":  # the answer altered where it is made
                return request(nonce + 1, upload, span, sync)
            data, outs = request(nonce, upload, span, sync)
            out = torch.cat(outs, 1)  # the results in record order
            if fault == "state_unchanged":  # the evaluation returns its input
                out = data.clone()
            elif fault == "half_batch":  # half of the batch left out, filled from the rest
                half = out.shape[1] // 2
                out[:, half:] = out[:, :half]
            elif fault == "output_altered":  # + delta on one coefficient of one record
                delta = h.scheme.delta.to(torch.int32)[:, 0]
                out[0, 0, :, 0] = (out[0, 0, :, 0] + delta) % q[:, 0]
            return data, [out]
        entry.request = faulty
    return patch


@pytest.mark.parametrize("fault", ("state_unchanged", "half_batch", "output_altered",
                                   "transcipher_other_nonce"))
def test_fault_is_not_correct(fault):
    r = harness.run("ecg_1fc.b64", 2**31 + 11, 0.01, False, device="cpu", config_overrides=SMALL,
                    traffic_overrides=FEW, patch=broken(fault))
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("fault", ("state_unchanged", "half_batch", "output_altered"))
def test_fault_is_not_correct_with_bfv_uploads(fault):
    r = harness.run("ecg_1fc.b64", 2**31 + 11, 0.01, False, device="cpu",
                    config_overrides={**SMALL, "upload": "bfv"}, traffic_overrides=FEW,
                    patch=broken(fault))
    assert not r["correct"], (fault, r["checks"])


def test_a_module_of_jax_loaded_after_the_window_gives_no_result(monkeypatch):
    """The look for JAX and the JAX package comes after every import of the
    run: a module loaded once the window has closed (here while the entry
    is released) still stops the run before it returns a result."""
    import sys
    import types

    def patch(h, entry):
        release = entry.release

        def late():
            monkeypatch.setitem(sys.modules, "hhe_tpu", types.ModuleType("hhe_tpu"))
            release()
        entry.release = late

    with pytest.raises(RuntimeError, match="hhe_tpu"):
        harness.run("ecg_1fc.b64", 2**31 + 13, 0.01, False, device="cpu", config_overrides=SMALL,
                    traffic_overrides=FEW, patch=patch)
