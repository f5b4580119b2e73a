"""CryptoNets' cell, ``cryptonets.bfv_b1``, through the harness.

On the CPU at N=2048 and its own 47-bit t, ``conv_plain_t(2048)``, with 8
hidden neurons where the network has 100 (each neuron is one more row of
the same batched tensors), one request checked:

- the reference (``reference/cryptonets.py``) equals Python's integers at
  the worst case of the network's widths, and pads below and right;
- at the configuration's 13 data limbs the run is correct, 0 wrong;
- the control, two data limbs fewer (11), is not correct.  N=2048 grows
  less noise than N=16384: a sound run there reads ``noise_share`` at the
  reference's floor (~2e-27) and one limb fewer still inside the limit
  (~1.5e-20), where at the cell's size one limb fewer reads ~4e-15.

On a card, at the cell's own size on three seeds with one limb fewer (12),
the control prints the numbers that set the limit's upper reading
(PERF.md), and must not be correct:

    python -m pytest hhe_bench/tests/test_hhe_bench_cryptonets.py -m cuda -p no:xdist -o addopts="" -s
"""

import json

import pytest
import torch

from hhe_bench import harness
from hhe_bench.reference import cryptonets as ref_cryptonets
from hhe_bench.reference import hcnn as ref_hcnn
from hhe_tpu_torch.workloads.he_conv import conv_plain_t

CELL = "cryptonets.bfv_b1"
SMALL = {"n": 2048, "t": conv_plain_t(2048), "data_limbs": 13, "hidden": 8}
FEW = {"check_requests": 1}
CONTROL_LIMBS = 11


def test_reference_worst_case_and_padding():
    # every pixel 3, every weight -2, at the network's widths, in Python's
    # integers: the bound of the reference's docstring, and the exact
    # logits, where the last output row and column see 4 of 5 tap rows or
    # columns of the image and the pad under the fifth
    bound = 100 * 2 * (845 * 2 * (25 * 3 * 2) ** 2) ** 2
    assert bound < 2.9e17 < 2**63
    seen = [min(5, 28 - 2 * o) for o in range(13)]
    b = 5 * sum(-2 * (-6 * r * c) ** 2 for r in seen for c in seen)
    got = ref_cryptonets.logits(torch.full((1, 28, 28), 3), torch.full((5, 1, 5, 5), -2),
                                torch.full((100, 845), -2), torch.full((10, 100), -2))
    assert got.tolist() == [100 * -2 * b * b] * 10 and abs(100 * 2 * b * b) < bound
    # one map: the last output position, (12, 12), reads the pad under the
    # taps of its last row and column, which add nothing
    x = torch.arange(28 * 28).view(1, 28, 28) % 4
    k1 = torch.arange(25).view(1, 1, 5, 5) % 3 - 1
    corner = sum(int(x[0, 24 + j, 24 + i] * k1[0, 0, j, i]) for j in range(4) for i in range(4))
    assert ref_hcnn.conv(x, k1, 2).shape == (1, 12, 12)  # without the pad
    pick = torch.zeros((1, 169), dtype=torch.int64)
    pick[0, 168] = 1
    assert ref_cryptonets.logits(x, k1, torch.eye(169, dtype=torch.int64), pick).tolist() == [corner**4]


def test_sound_run_is_correct_at_small_size():
    r = harness.run(CELL, 2**31 + 13, 0.01, False, device="cpu", config_overrides=SMALL,
                    traffic_overrides=FEW)
    assert r["correct"], r["checks"]
    assert r["checks"]["outputs_wrong"]["value"] == 0 and r["checks"]["records_wrong"]["value"] == 0


def test_control_two_limbs_fewer_is_not_correct_at_small_size():
    r = harness.run(CELL, 2**31 + 13, 0.01, False, device="cpu",
                    config_overrides={**SMALL, "data_limbs": CONTROL_LIMBS}, traffic_overrides=FEW)
    assert not r["correct"], r["checks"]


CARD_SEEDS = (2**31 + 111, 2**31 + 222, 2**31 + 333)


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
