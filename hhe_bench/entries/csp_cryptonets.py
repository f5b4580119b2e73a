"""The CSP's request path for CryptoNets' MNIST network (pad, conv 5x5/2,
square, dense, square, dense), as ``he_conv.csp_eval_cryptonets`` runs it:
the user's BFV ciphertext of one image copied to the card, then the
encrypted network (``cryptonets_stages``: the padded rotation conv, a BEHZ
square, the hidden dense layer and its log-depth rotate-sum, a square, the
integer scalars across the hidden rows), ending in a synchronise.  The
result holds the ten logits, one class a ciphertext, in every slot of its
first row.

The users encrypt as the HCNN's do, as SEAL does (``csp_hcnn.UsersEncryption``,
round(Q m / t)): one image a ciphertext, the image row-major in slots
[0, H W), as LoLa evaluates this network."""

from __future__ import annotations

import math

import torch

from hhe_bench.entries.csp_hcnn import UsersEncryption
from hhe_bench.reference import bfv as ref_bfv
from hhe_bench.reference import cryptonets as ref_cryptonets

I64 = torch.int64


class Entry:
    def __init__(self, h):
        from hhe_tpu_torch.ops import heconv
        from hhe_tpu_torch.workloads import he_conv

        cfg = h.config
        img, stride, pad = cfg["img"], cfg["stride"], cfg["pad"]
        if cfg["input_words"] != img * img:
            raise ValueError("csp_cryptonets takes one img x img image a record")
        h.encrypt_slots = UsersEncryption(h)
        c1, k = cfg["c1"], cfg["kernel"]
        lo, hi = cfg["weight_low"], cfg["weight_high"]
        k1 = h.rng.integers(lo, hi, (c1, 1, k, k))
        spec = he_conv.cryptonets_spec(k1, img, stride, pad)
        dense = h.rng.integers(lo, hi, (cfg["hidden"], math.prod(heconv.conv_out_shape(spec))))
        out = h.rng.integers(lo, hi, (cfg["classes"], cfg["hidden"]))
        h.weights = {"k1": torch.as_tensor(k1, device=h.device),
                     "dense": torch.as_tensor(dense, device=h.device),
                     "out": torch.as_tensor(out, device=h.device)}
        self.stack = h.program_stack(lambda ctx: heconv.conv_galois_elts(ctx, [spec], img))
        self.model = he_conv.prepare_cryptonets(self.stack.ctx, k1, dense, out, img, stride, pad)

    def request(self, nonce, upload, span, sync_layers):
        """``upload``: the image's BFV ciphertext [2, 1, k, N] int32 on the
        host."""
        from hhe_tpu_torch.ops.bfv import Ciphertext
        from hhe_tpu_torch.workloads import he_conv

        ctx = self.stack.ctx
        with span("upload"):
            dd = upload.to(ctx.device)
            if sync_layers:
                ctx.synchronize()
        with span("eval"):
            out = he_conv.csp_eval_cryptonets(self.stack, Ciphertext(dd), self.model).data
            ctx.synchronize()
        return dd, [out]

    def release(self):
        self.stack = self.model = None


def compare(h, x, data, outs) -> dict:
    """The image [1, H W] against the decrypted data ciphertext [2, 1, k, N],
    and every slot of the first row of each class's result [2, classes, k,
    N] (the one entry of ``outs``) against the reference's logit, centred
    mod t."""
    sch, t, img = h.scheme, h.config["t"], h.config["img"]
    x = x.to(I64)
    out, = outs
    m, _ = sch.decrypt(h.s_dev, data.to(h.device))
    rec = int((sch.slots.decode(m)[:, :img * img] != x).sum())
    m, noise = sch.decrypt(h.s_dev, out.to(h.device))
    got = ref_bfv.signed(sch.slots.decode(m)[:, :sch.n // 2], t)  # [classes, N/2]
    w = h.weights
    want = ref_bfv.signed(ref_cryptonets.logits(x.view(-1, 1, img, img), w["k1"], w["dense"], w["out"],
                                                h.config["stride"], h.config["pad"]) % t, t)  # [1, classes]
    return {"records_wrong": rec, "outputs_wrong": int((got != want.view(-1, 1)).sum()),
            "noise_share": float(noise.max())}
