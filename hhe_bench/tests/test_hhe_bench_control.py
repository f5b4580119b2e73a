"""The control of each cell's comparison: the program one step below the
precision the configuration states -- one data limb fewer, 30 bits less
modulus -- must come out not correct.

On the CPU at a size a test run holds (N=1024, ECG at 11 limbs and its
control at 10); on the card at each cell's own size, on three seeds, where
it prints the numbers that set each limit's upper reading (PERF.md):

    python -m pytest hhe_bench/tests/test_hhe_bench_control.py -m cuda -p no:xdist -o addopts="" -s
"""

import json

import pytest
import torch

from hhe_bench import harness

SMALL = {"n": 1024, "data_limbs": 11}
FEW = {"records_per_request": 4, "check_requests": 2}


def test_sound_run_is_correct_at_small_size():
    r = harness.run("ecg_1fc.b64", 2**31 + 7, 0.01, False, device="cpu",
                    config_overrides=SMALL, traffic_overrides=FEW)
    assert r["correct"], r["checks"]


def test_control_one_limb_fewer_is_not_correct_at_small_size():
    r = harness.run("ecg_1fc.b64", 2**31 + 7, 0.01, False, device="cpu",
                    config_overrides={**SMALL, "data_limbs": SMALL["data_limbs"] - 1},
                    traffic_overrides=FEW)
    assert not r["correct"], r["checks"]


CARD_SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cells' own sizes")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CARD_SEEDS)
@pytest.mark.parametrize("cell", ("ecg_1fc.b64", "mnist_2fc.b4", "ecg_1fc.b512"))
def test_control_on_card(card, cell, seed):
    limbs = harness.load_cell(cell)["config"]["data_limbs"]
    r = harness.run(cell, seed, 3.0, False, config_overrides={"data_limbs": limbs - 1})
    print(f"control {cell} seed {seed} data_limbs {limbs - 1}: {json.dumps(r['checks'])}")
    assert not r["correct"], r["checks"]
