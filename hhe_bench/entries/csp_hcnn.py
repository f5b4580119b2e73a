"""The CSP's request path for the pure-HE HCNN (conv -> square -> conv ->
square -> fc), as ``he_conv.csp_eval_hcnn`` runs it: the user's BFV
ciphertext of one image copied to the card, then the encrypted model
(``hcnn_stages``: rotation convs, BEHZ squares, the FC and its log-depth
rotate-sum), ending in a synchronise.  The result holds the ten logits,
one class a ciphertext, in every slot of its first row.

This configuration's users encrypt as SEAL, the reference's Pyfhel, does:
the plaintext m scaled by round(Q m / t), not floor(Q / t) m.  At a 47-bit
t the difference, (Q mod t) m / t with plaintext coefficients up to t, is
noise of ~35 bits that the HCNN's five products would carry to its end.
So the entry hands the harness the users' encryption (``UsersEncryption``):
the reference's encryption of zero, made in batches, plus round(Q m / t)."""

from __future__ import annotations

import math

import torch

from hhe_bench.reference import bfv as ref_bfv
from hhe_bench.reference import hcnn as ref_hcnn

I64 = torch.int64


class UsersEncryption:
    """Slot values [B, L] -> int32 ciphertexts [2, B, k, N] under the
    benchmark's public key: (z0 + round(Q m / t), z1), (z0, z1) the
    reference's encryption of zero and m the reference's encoding of the
    values.  One call a request, so the work is arranged to take few
    launches: the zeros are encrypted ``BATCH`` rows at a time, and m is
    the sum of the values times the encodings of the L unit slot vectors
    (encoded once), exact in int64 while max(values) L t < 2^63.
    round(Q m / t) = floor(Q / t) m + floor(((Q mod t) m + floor(t/2)) / t);
    the second term a / t, with a up to 2^94, is exact mod each q_i as
    (a - (a mod t)) t^-1, from a mod q_i and a mod t."""

    BATCH = 128

    def __init__(self, h):
        self.h, sch = h, h.scheme
        self.t = t = sch.t
        self.r, self.half = sch.Q % t, t // 2

        def col(f):
            return torch.tensor([f(p) for p in sch.q], dtype=I64, device=sch.device)[:, None]

        self.r_q, self.half_q = col(lambda p: self.r % p), col(lambda p: self.half % p)
        self.t_inv = col(lambda p: pow(t, -1, p))
        self.basis = None  # [L, N]: the encoding of each unit slot vector
        self.zeros = None  # [2, rows, k, N] int32: encryptions of zero not yet handed out

    def encode(self, v: torch.Tensor) -> torch.Tensor:
        """Slot values [B, L] in [0, t) -> plaintext polys [B, N] in [0, t)."""
        sch, width = self.h.scheme, v.shape[-1]
        if self.basis is None:
            self.basis = sch.slots.encode(torch.eye(width, dtype=I64, device=sch.device))
        if int(v.max()) * width * (self.t - 1) >= 1 << 63:
            raise ValueError("slot values too wide for an exact int64 sum of the unit encodings")
        return torch.stack([(row[:, None] * self.basis).sum(0) % self.t for row in v])

    def zero(self, rows: int) -> torch.Tensor:
        sch = self.h.scheme
        if self.zeros is None or self.zeros.shape[1] < rows:
            fresh = sch.encrypt(self.h.pk, torch.zeros((max(rows, self.BATCH), sch.n), dtype=I64,
                                                       device=sch.device), self.h.gen)
            self.zeros = fresh if self.zeros is None else torch.cat((self.zeros, fresh), 1)
        out, self.zeros = self.zeros[:, :rows], self.zeros[:, rows:]
        return out.to(I64)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        sch, t, q = self.h.scheme, self.t, self.h.scheme.qcol
        m = self.encode(values.to(I64) % t)
        ct = self.zero(m.shape[0])
        a_t = (ref_bfv.mulmod(m, self.r, t, t.bit_length()) + self.half) % t
        a_q = (self.r_q * (m[:, None, :] % q) + self.half_q) % q
        scaled = (sch.delta * (m[:, None, :] % q) + (a_q - a_t[:, None, :] % q) % q * self.t_inv) % q
        ct[0] = (ct[0] + scaled) % q
        return ct.to(torch.int32)


class Entry:
    def __init__(self, h):
        from hhe_tpu_torch.ops import heconv
        from hhe_tpu_torch.workloads import he_conv

        cfg = h.config
        img = cfg["img"]
        if cfg["input_words"] != img * img or cfg["stride"] != he_conv.STRIDE:
            raise ValueError("csp_hcnn takes one img x img image a record at the program's stride")
        h.encrypt_slots = UsersEncryption(h)
        c1, c2, k = cfg["c1"], cfg["c2"], cfg["kernel"]
        lo, hi = cfg["weight_low"], cfg["weight_high"]
        k1 = h.rng.integers(lo, hi, (c1, 1, k, k))
        k2 = h.rng.integers(lo, hi, (c2, c1, k, k))
        specs = he_conv.hcnn_specs(k1, k2, img)
        fc = h.rng.integers(lo, hi, (cfg["classes"], math.prod(heconv.conv_out_shape(specs[1]))))
        h.weights = {"k1": torch.as_tensor(k1, device=h.device), "k2": torch.as_tensor(k2, device=h.device),
                     "fc": torch.as_tensor(fc, device=h.device)}
        self.stack = h.program_stack(lambda ctx: heconv.conv_galois_elts(ctx, specs, img))
        self.model = he_conv.prepare_hcnn(self.stack.ctx, k1, k2, fc, img)

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
            out = he_conv.csp_eval_hcnn(self.stack, Ciphertext(dd), self.model).data
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
    want = ref_bfv.signed(ref_hcnn.logits(x.view(-1, 1, img, img), w["k1"], w["k2"], w["fc"],
                                          h.config["stride"]) % t, t)  # [1, classes]
    return {"records_wrong": rec, "outputs_wrong": int((got != want.view(-1, 1)).sum()),
            "noise_share": float(noise.max())}
