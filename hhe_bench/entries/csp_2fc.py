"""The CSP's request path for the two-layer model with a square activation
(MNIST 2FC): ``csp_decompose`` (the transcipher over several blocks, the
mask and the flatten), then ``csp_eval_2fc`` (fc1 as batched ct x ct row
products with log-depth rotate-reduce sums, the square, fc2 by scalar
Montgomery products), ending in a synchronise.  The result holds the
logits, one class a ciphertext, in slot 0."""

from __future__ import annotations

import math

import torch

from hhe_bench.reference import bfv as ref_bfv
from hhe_bench.reference import models


class Entry:
    def __init__(self, h):
        from hhe_tpu_torch.ops import bfv, helin, transcipher

        cfg = h.config
        words, hidden, classes = cfg["input_words"], cfg["hidden"], cfg["classes"]
        blocks = math.ceil(words / transcipher.T)

        def elts(ctx):
            return (transcipher.galois_elts(ctx, True)
                    + helin.flatten_galois_elts(ctx, blocks, transcipher.T)
                    + helin.vec_sum_galois_elts(ctx))

        self.stack = h.program_stack(elts)
        self.row_chunk = cfg["row_chunk"]
        w1 = h.rng.integers(cfg["weight_low"], cfg["weight_high"], (words, hidden))
        w2 = h.rng.integers(cfg["weight_low"], cfg["weight_high"], (hidden, classes))
        self.w2 = w2
        h.weights = {"w1": torch.as_tensor(w1, device=h.device), "w2": torch.as_tensor(w2, device=h.device)}
        self.enc_key = h.encrypted_pasta_key()
        rows = h.encrypt_slots(h.weights["w1"].T)  # [2, hidden, k, N]: one ciphertext a hidden row
        self.w1_cts = [bfv.Ciphertext(rows[:, r]) for r in range(hidden)]

    def request(self, nonce, sym, span, sync_layers):
        from hhe_tpu_torch.workloads import hhe_inference as wk

        ctx = self.stack.ctx
        with span("decompose"):
            data = wk.csp_decompose(self.stack, self.enc_key, sym, nonce=nonce)
            if sync_layers:
                ctx.synchronize()
        with span("eval"):
            out = wk.csp_eval_2fc(self.stack, data, self.w1_cts, self.w2, row_chunk=self.row_chunk)
            ctx.synchronize()
        return data.data, [out.data]

    def release(self):
        self.stack = self.enc_key = self.w1_cts = None


def compare(h, x, data, outs) -> dict:
    """Images [B, 784] against the decrypted data ciphertext [2, B, k, N] and
    the logits against slot 0 of the decrypted result [2, B, C, k, N] (the
    one entry of ``outs``)."""
    sch, t, words = h.scheme, h.config["t"], h.config["input_words"]
    x = x.to(torch.int64)
    out, = outs
    data, out = data.to(h.device), out.to(h.device)
    m, _ = sch.decrypt(h.s_dev, data)
    rec = int((sch.slots.decode(m)[:, :words] != x).sum())
    m, noise = sch.decrypt(h.s_dev, out)
    got = ref_bfv.signed(sch.slots.decode(m)[..., 0], t)
    want = models.mnist_logits(x, h.weights["w1"], h.weights["w2"], t)
    return {"records_wrong": rec, "outputs_wrong": int((got != want).sum()),
            "noise_share": float(noise.max())}
