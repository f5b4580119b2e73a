"""The CSP's request path for a one-layer FC model with the analyst's sum
(ECG 1FC), as ``hhe_ecg_full_inference`` runs it: for PASTA uploads
``csp_decompose`` (the transcipher) over the request's records, for BFV
uploads the users' ciphertexts copied to the card; then ``csp_eval_1fc``
without the slot sum (ct x ct product and relinearisation) in slices of
``EVAL_BATCH`` records, ending in a synchronise.  The results hold the
slot-wise products w_i x_i."""

from __future__ import annotations

import torch

from hhe_bench.reference import bfv as ref_bfv
from hhe_bench.reference import models

EVAL_BATCH = 64  # hhe_ecg_full_inference's eval_batch: the product's temporaries grow with the batch


class Entry:
    def __init__(self, h):
        from hhe_tpu_torch.ops import bfv, transcipher

        cfg = h.config
        self.words = cfg["input_words"]
        self.pasta = h.upload == "pasta"
        if self.pasta:
            if self.words > transcipher.T:
                raise ValueError("csp_1fc takes one PASTA block a record")
            self.stack = h.program_stack(lambda ctx: transcipher.galois_elts(ctx, True))
        else:
            self.stack = h.program_stack(lambda ctx: ())  # the product needs no rotation
        self.w = torch.as_tensor(h.rng.integers(cfg["weight_low"], cfg["weight_high"], self.words),
                                 device=h.device)
        h.weights = {"w": self.w}
        self.enc_key = h.encrypted_pasta_key() if self.pasta else None
        self.wct = bfv.Ciphertext(h.encrypt_slots(self.w[None]))  # [2, 1, k, N]

    def request(self, nonce, upload, span, sync_layers):
        """``upload``: PASTA ciphertexts [B, L] uint64 under ``nonce``, or BFV
        ciphertexts [2, B, k, N] int32 on the host."""
        from hhe_tpu_torch.ops.bfv import Ciphertext
        from hhe_tpu_torch.workloads import hhe_inference as wk

        ctx = self.stack.ctx
        if self.pasta:
            with span("decompose"):
                dd = wk.csp_decompose(self.stack, self.enc_key, upload, nonce=nonce).data
                if sync_layers:
                    ctx.synchronize()
        else:
            with span("upload"):
                dd = upload.to(ctx.device)
                if sync_layers:
                    ctx.synchronize()
        with span("eval"):
            outs = [wk.csp_eval_1fc(self.stack, Ciphertext(dd[:, e:e + EVAL_BATCH]), self.wct,
                                    do_sum=False).data
                    for e in range(0, dd.shape[1], EVAL_BATCH)]
            ctx.synchronize()
        return dd, outs

    def release(self):
        self.stack = self.enc_key = self.wct = None


def compare(h, x, data, outs, rows: int = 64) -> dict:
    """Records [B, L] against the decrypted data ciphertext [2, B, k, N], and
    the slot products against the decrypted results (slices [2, b, k, N] in
    record order), ``rows`` records at a time on the card."""
    sch, t, words = h.scheme, h.config["t"], h.config["input_words"]
    w = h.weights["w"]
    rec = outw = 0
    share = 0.0
    out = torch.cat(list(outs), 1)  # on the host
    if out.shape[1] != x.shape[0]:
        raise ValueError(f"{out.shape[1]} results for {x.shape[0]} records")
    for b in range(0, x.shape[0], rows):
        xb = x[b:b + rows].to(torch.int64)
        m, _ = sch.decrypt(h.s_dev, data[:, b:b + rows].to(h.device))
        rec += int((sch.slots.decode(m)[:, :words] != xb).sum())
        m, noise = sch.decrypt(h.s_dev, out[:, b:b + rows].to(h.device))
        got = ref_bfv.signed(sch.slots.decode(m)[:, :words], t)
        outw += int((got != models.ecg_products(xb, w, t)).sum())
        share = max(share, float(noise.max()))
    return {"records_wrong": rec, "outputs_wrong": outw, "noise_share": share}
