"""The HCNN's cell, ``hcnn_conv.bfv_b1``, through the harness.

On the CPU at N=2048 and its own 47-bit t, ``conv_plain_t(2048)``, with 8
second-layer channels where the model has 50 (each channel is one more row
of the same batched tensors; 50 take minutes a request on the CPU), one
request checked:

- the users' encryption (``csp_hcnn.UsersEncryption``) is the
  reference's encryption of zero plus round(Q m / t), against Python's
  integers, and decrypts to its slots with far less noise than the
  reference's floor(Q / t) m;
- at the configuration's 13 data limbs the run is correct, 0 wrong;
- the control, two data limbs fewer (11), is not correct.  N=2048 grows
  less noise than N=16384: a sound run there reads ``noise_share`` ~2e-12,
  39 bits to spare, so one limb fewer (30 bits) still decrypts every
  logit; two fewer do not.

On a card, at the cell's own size on three seeds with one limb fewer (12),
the control prints the numbers that set the limit's upper reading
(PERF.md):

    python -m pytest hhe_bench/tests/test_hhe_bench_hcnn.py -m cuda -p no:xdist -o addopts="" -s
"""

import json
import types

import numpy as np
import pytest
import torch

from hhe_bench import harness
from hhe_bench.entries import csp_hcnn
from hhe_bench.reference import bfv as ref_bfv
from hhe_tpu_torch.workloads.he_conv import conv_plain_t

CELL = "hcnn_conv.bfv_b1"
SMALL = {"n": 2048, "t": conv_plain_t(2048), "data_limbs": 13, "c2": 8}
FEW = {"check_requests": 1}
CONTROL_LIMBS = 11


def test_users_encryption_is_the_reference_zero_plus_round_q_m_over_t():
    n, t = 1024, conv_plain_t(1024)
    sch = ref_bfv.Scheme(n, t, 30, 4, "cpu")
    s = torch.as_tensor(sch.secret_key(np.random.default_rng(3)), dtype=torch.int64)
    pk = sch.public_key(s, torch.Generator().manual_seed(4))
    v = torch.as_tensor(np.random.default_rng(5).integers(0, 4, (2, 784)))
    enc = csp_hcnn.UsersEncryption(types.SimpleNamespace(scheme=sch, pk=pk,
                                                         gen=torch.Generator().manual_seed(6)))
    got = torch.cat([enc(v[:1]), enc(v[1:])], 1).to(torch.int64)  # two requests, one batch of zeros
    zeros = torch.zeros((enc.BATCH, n), dtype=torch.int64)
    zero = sch.encrypt(pk, zeros, torch.Generator().manual_seed(6))[:, :2].to(torch.int64)
    assert torch.equal(got[1], zero[1])
    m = sch.slots.encode(v).numpy().reshape(-1)
    for i, q in enumerate(sch.q):
        want = [(2 * sch.Q * int(c) + t) // (2 * t) % q for c in m]  # round(Q m / t) mod q
        assert ((got[0, :, i] - zero[0, :, i]) % q).reshape(-1).tolist() == want
    dec, share = sch.decrypt(s, got)
    assert torch.equal(sch.slots.decode(dec)[:, :784], v)
    floor = sch.encrypt(pk, sch.slots.encode(v), torch.Generator().manual_seed(6))
    assert float(share.max()) < float(sch.decrypt(s, floor)[1].max()) / 1000


def test_sound_run_is_correct_at_small_size():
    r = harness.run(CELL, 2**31 + 11, 0.01, False, device="cpu", config_overrides=SMALL,
                    traffic_overrides=FEW)
    assert r["correct"], r["checks"]
    assert r["checks"]["outputs_wrong"]["value"] == 0 and r["checks"]["records_wrong"]["value"] == 0


def test_control_two_limbs_fewer_is_not_correct_at_small_size():
    r = harness.run(CELL, 2**31 + 11, 0.01, False, device="cpu",
                    config_overrides={**SMALL, "data_limbs": CONTROL_LIMBS}, traffic_overrides=FEW)
    assert not r["correct"], r["checks"]


CARD_SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CARD_SEEDS)
def test_control_on_card(card, seed):
    limbs = harness.load_cell(CELL)["config"]["data_limbs"]
    r = harness.run(CELL, seed, 3.0, False, config_overrides={"data_limbs": limbs - 1})
    print(f"control {CELL} seed {seed} data_limbs {limbs - 1}: {json.dumps(r['checks'])}")
    assert not r["correct"], r["checks"]
