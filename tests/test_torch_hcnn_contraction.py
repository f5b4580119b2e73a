"""The HCNN's contractions in ``mont_mac`` groups (``heconv.he_conv2d`` and
``he_fc_from_conv``):

- each layer at the model's widths (conv 1->5 and 5->50, 5x5 taps on the
  28-wide grid, stride 2; the FC over 50 channels to 10 classes) equals,
  word for word, the chain it replaced -- a ``mont_mul`` a tap, an int64
  sum over the in-channels, int64 adds over the taps and one ``% q`` --
  on uniform residues, on the CPU at N=1024 / 3 limbs and on a card at the
  HCNN cell's N=16384 / 13 limbs (skipped without one);
- ``group_size`` at the model's widths, and the K4 plan of each contraction
  layout at the cell's size: the fan-out form over the output channels (the
  FC's classes), the rotations staged, in blocks that leave at least two
  on an SM.

The module imports no JAX: on a card, ``pytest --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from hhe_tpu_torch.ops import bfv, bfv_eval, heconv, helin, mod_kernels, ntt
from hhe_tpu_torch.ops.bfv import Ciphertext
from hhe_tpu_torch.ops.modular import mont_mul

IMG, TAPS, C1, C2, CLASSES = 28, 25, 5, 50, 10
SM_SMEM = 228 * 1024  # an H100 SM's shared memory
BLOCK_RESERVED = 1024  # of it, reserved for each resident block


def old_conv2d(ctx, ct, spec, pts, gks, img_w):
    """The conv's former chain: per tap a broadcast mont_mul over (Ci, Co),
    its int64 sum over Ci, an int64 accumulator over the taps, one % q."""
    tb = ctx.tb_q
    acc = None
    for t_i, off in enumerate(heconv.conv_tap_offsets(spec, img_w)):
        rot = bfv_eval.rotate_rows(ctx, ct, off, gks) if off else ct
        f = ntt.ntt_fwd(rot.data, tb)
        g = mont_mul(f[:, :, None], pts[t_i][None], tb.q, tb.qinv_neg).sum(1, dtype=torch.int64)
        acc = g if acc is None else acc + g
    return Ciphertext(ntt.ntt_inv(acc % tb.q, tb))


def old_fc_from_conv(ctx, ct, fc_pts, gks):
    """The FC's former chain: one broadcast mont_mul, an int64 channel sum,
    % q, then the rotate-sum."""
    tb = ctx.tb_q
    f = ntt.ntt_fwd(ct.data, tb)
    s = mont_mul(f[:, None], fc_pts[None], tb.q, tb.qinv_neg).sum(2, dtype=torch.int64)
    return helin.encrypted_vec_sum_log(ctx, Ciphertext(ntt.ntt_inv(s % tb.q, tb)), gks)


def residues(ctx, shape, gen):
    """Uniform residues below each limb's q, [..., k, N] int32 on ctx's device."""
    x = torch.randint(0, 1 << 62, (*shape, ctx.k, ctx.n), generator=gen, dtype=torch.int64)
    return (x % ctx.tb_q.q.cpu()).to(torch.int32).to(ctx.device)


def specs():
    k1 = np.ones((C1, 1, 5, 5), np.int64)
    k2 = np.ones((C2, C1, 5, 5), np.int64)
    spec1 = heconv.ConvSpec(k1, (1, IMG, IMG), 2, 1)
    return spec1, heconv.ConvSpec(k2, heconv.conv_out_shape(spec1), 2, 2)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("layer", ["conv1", "conv2", "fc"])
def test_contraction_equals_the_int64_chain(layer, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, limbs = (1024, 3) if device == "cpu" else (16384, 13)
    ctx = bfv.Context(bfv.BFVParams(n=n, data_limbs=limbs, seed=11), device=device)
    gen = torch.Generator().manual_seed(1000 + ["conv1", "conv2", "fc"].index(layer))
    sk = ctx.keygen_secret()
    if layer == "fc":
        _, gks = ctx.keygen_eval_keys_device(sk, helin.vec_sum_galois_elts(ctx), include_relin=False,
                                             seed=3)
        ct = Ciphertext(residues(ctx, (2, C2), gen))
        fc_pts = residues(ctx, (CLASSES, C2), gen)
        before = dict(heconv.CONTRACTIONS)
        got = heconv.he_fc_from_conv(ctx, ct, fc_pts, gks)
        want = old_fc_from_conv(ctx, ct, fc_pts, gks)
        groups, terms = 2, C2
    else:
        spec = specs()[layer == "conv2"]
        co, ci = spec.kernel.shape[:2]
        _, gks = ctx.keygen_eval_keys_device(sk, heconv.conv_galois_elts(ctx, [spec], IMG),
                                             include_relin=False, seed=3)
        ct = Ciphertext(residues(ctx, (2, ci), gen))
        pts = residues(ctx, (TAPS, ci, co), gen)
        before = dict(heconv.CONTRACTIONS)
        got = heconv.he_conv2d(ctx, ct, spec, pts, gks, IMG, layer)
        want = old_conv2d(ctx, ct, spec, pts, gks, IMG)
        groups, terms = (1, TAPS) if ci == 1 else (5, TAPS * ci)
    assert got.data.dtype == torch.int32 and torch.equal(got.data, want.data)
    grew = {k: v - before.get(k, 0) for k, v in heconv.CONTRACTIONS.items() if v != before.get(k, 0)}
    assert grew == {f"{layer}.launches": groups, f"{layer}.terms": terms}


def test_group_sizes_at_the_model_widths():
    # conv1: 25 taps of one term; conv2: 25 taps of 5 terms in 5 groups; FC:
    # 50 channels in 2 groups -- 25 terms a launch each time
    assert heconv.group_size(TAPS, 1) == TAPS
    assert heconv.group_size(TAPS, C1) == 5
    assert heconv.group_size(C2, 1) == 25
    assert heconv.group_size(7, 100) == 1  # no group fits: one item a launch


def layouts(k=13, n=16384):
    """(name, a, b, dim, fan-out) of each contraction he_conv2d and
    he_fc_from_conv pass to mont_mac at the cell's size, as meta tensors."""
    meta = dict(dtype=torch.int32, device="meta")
    out = []
    for name, ci, co in (("conv1", 1, C1), ("conv2", C1, C2)):
        t = heconv.group_size(TAPS, ci)
        f = torch.empty((2, t, ci, k, n), **meta).view(2, t * ci, 1, k, n)
        pts = torch.empty((TAPS, ci, co, k, n), **meta)[:t].flatten(0, 1)
        out.append((name, f, pts, 1, co))
    per = heconv.group_size(C2, 1)
    f = torch.empty((2, C2, k, n), **meta)[:, None]
    fc = torch.empty((CLASSES, C2, k, n), **meta)
    out.append(("fc", f[:, :, per:2 * per], fc[:, per:2 * per], 2, CLASSES))
    return out


@pytest.mark.parametrize("name", ["conv1", "conv2", "fc"])
def test_contraction_plans_a_fan_out_with_two_blocks_an_sm(name):
    _, a, b, dim, fan = [x for x in layouts() if x[0] == name][0]
    q = torch.empty((13, 1), dtype=torch.int64, device="meta")
    p = mod_kernels.plan(a, b, q, q, dim)
    assert p.form == "fanout" and p.order[0] == 0 and p.sizes[0] == fan  # the rotations staged
    assert p.terms == a.shape[dim] == 25
    smem = mod_kernels.fan_smem(p.form, p.terms, p.sizes[0], p.threads)
    assert 2 * (smem + BLOCK_RESERVED) <= SM_SMEM, (p.threads, smem)
