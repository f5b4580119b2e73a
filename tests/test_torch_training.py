"""The port's integer-DFA trainers (``hhe_tpu_torch.workloads.training``)
against ``hhe_tpu.workloads.training`` on the CPU: on the same numpy-seeded
data at small widths, every trainer gives JAX's history, best accuracy,
final and epoch-best parameters and checkpoint CSV bytes, bit for bit.
Also the ``RunConfig`` sample limit, ``initial_stats``, the CUDA default and
``convert.mlp``.  No test reads the reference's assets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhe_tpu.models import pocketnn as jpk
from hhe_tpu.utils.config import RunConfig as JRunConfig
from hhe_tpu.workloads import training as jtr
from hhe_tpu_torch import convert
from hhe_tpu_torch.models import pocketnn as tpk
from hhe_tpu_torch.utils.config import RunConfig as TRunConfig
from hhe_tpu_torch.workloads import training as ttr

from .test_torch_pocketnn import assert_same_mlp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test worker (see test_torch_workloads.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def binary_rows(seed, n, width, hi):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, (n, width)), (rng.random(n) < 0.3).astype(np.int64)


def images(seed, n, width):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, width)), rng.integers(0, 10, n)


def spo2_args():
    x, y = binary_rows(40, 48, 60, 32)
    return (x[:40], y[:40], x[40:], y[40:]), dict(epochs=12)  # lr_inv doubles at epoch 10


def ecg_args():
    x, y = binary_rows(41, 60, 32, 64)
    return (x, y), dict(epochs=3)


def square_args():
    x, y = binary_rows(42, 56, 30, 32)
    return (x[:40], y[:40], x[40:], y[40:]), dict(hidden=8, epochs=3)


def mnist_one_args():
    x, y = images(43, 260, 100)
    return (x[:200], y[:200], x[200:], y[200:]), dict(epochs=3)


def mnist_dfa_args():
    x, y = images(44, 260, 64)
    return (x[:200], y[:200], x[200:], y[200:]), dict(dims=(64, 16, 8, 10), epochs=3)


# name -> (arguments, checkpoint files written under save_best_path or None)
TRAINERS = {
    "train_spo2_one_layer": (spo2_args, ("",)),
    "train_ecg_one_layer": (ecg_args, None),
    "train_spo2_square": (square_args, (".fc1.csv", ".fc2.csv")),
    "train_mnist_one_layer": (mnist_one_args, None),
    "train_mnist_dfa": (mnist_dfa_args, None),
}


def run_both(name, tmp_path, **extra):
    make, files = TRAINERS[name]
    args, kw = make()
    out = {}
    for pkg, mod, dev in (("jax", jtr, {}), ("port", ttr, {"device": "cpu"})):
        save = {}
        if files:
            (tmp_path / pkg).mkdir()
            save = {"save_best_path": str(tmp_path / pkg / ("w.csv" if files == ("",) else "w"))}
        run = extra.get("run")
        if run is not None:
            run = (JRunConfig if pkg == "jax" else TRunConfig)(**run)
        out[pkg] = getattr(mod, name)(*args, **kw, **save, run=run, **dev)
    return out["port"], out["jax"], files


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_matches_jax(name, tmp_path):
    got, want, files = run_both(name, tmp_path)
    assert got.history == want.history
    assert got.best_test_acc == want.best_test_acc
    assert got.specs == tuple(tpk.FCSpec(**vars(s)) for s in want.specs)
    assert_same_mlp(got.model, want.model)
    assert_same_mlp(got.best_params, want.best_params)
    for suffix in files or ():
        base = "w.csv" if suffix == "" else "w" + suffix
        assert (tmp_path / "port" / base).read_bytes() == (tmp_path / "jax" / base).read_bytes()
    if name == "train_spo2_square":
        # the square layer stays at zero in both packages (ROADMAP F14), so
        # the output and the loss never move
        assert int((got.model.params[1].weight != 0).sum()) == 0
        assert int((got.model.params[0].weight != 0).sum()) > 0
        assert len({h["loss"] for h in got.history}) == 1
    else:
        assert got.history[-1]["loss"] != got.history[0]["loss"]  # it trained


@pytest.mark.parametrize("name", ["train_ecg_one_layer", "train_mnist_dfa"])
def test_run_config_sample_limit(name, tmp_path):
    """A dry run trains on the first 24 rows in both packages."""
    got, want, _ = run_both(name, tmp_path, run=dict(dry_run=True, dry_run_num_samples=24))
    assert got.history == want.history
    assert_same_mlp(got.model, want.model)
    full, _, _ = run_both(name, tmp_path, run=dict(dry_run=False))
    assert full.history != got.history


def test_initial_stats_matches_jax(capsys):
    x, y = binary_rows(45, 64, 30, 32)
    specs = [jpk.FCSpec(30, 8, "pocket_tanh"), jpk.FCSpec(8, 1, "pocket_sigmoid")]
    jm, jspecs = jpk.mlp_init(3, specs, he_init=True)
    tm, tspecs = tpk.mlp_init(3, [tpk.FCSpec(**vars(s)) for s in specs], he_init=True,
                              device="cpu")
    want = jtr.initial_stats(jm, jspecs, x, y * 128, "train")
    printed_jax = capsys.readouterr().out
    got = ttr.initial_stats(tm, tspecs, x, y * 128, "train")
    assert got == want and capsys.readouterr().out == printed_jax
    assert "Initial train accuracy" in printed_jax


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_defaults_to_cuda(name):
    """Without device=, a trainer asks for CUDA and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is legitimately CUDA")
    args, kw = TRAINERS[name][0]()
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(ttr, name)(*args, **kw)


def test_convert_mlp_round_trips_jax_parameters():
    """JAX's trained parameters carried into the port train on identically,
    and come back as the same arrays."""
    x, y = images(46, 40, 64)
    specs = [jpk.FCSpec(64, 16, "pocket_tanh"), jpk.FCSpec(16, 10, "pocket_tanh", use_bn=True)]
    jm, jspecs = jpk.mlp_init(4, specs, he_init=True)
    yy = np.eye(10, dtype=np.int32)[y] * 15
    jm, _ = jpk.dfa_train_step(jm, jspecs, jnp.asarray(x[:20], jnp.int32),
                               jnp.asarray(yy[:20]), 1000)
    tm = convert.mlp(jm, "cpu")
    assert_same_mlp(tm, jm)
    back = [[None if a is None else a.cpu().numpy() for a in p] for p in tm.params]
    for p, q in zip(back, jm.params):
        for a, b in zip(p, q):
            assert (a is None and b is None) or np.array_equal(a, np.asarray(b))
    tspecs = tuple(tpk.FCSpec(**vars(s)) for s in jspecs)
    jm, jloss = jpk.dfa_train_step(jm, jspecs, jnp.asarray(x[20:], jnp.int32),
                                   jnp.asarray(yy[20:]), 1000)
    tm, tloss = tpk.dfa_train_step(tm, tspecs, torch.as_tensor(x[20:], dtype=torch.int32),
                                   torch.as_tensor(yy[20:]), 1000)
    assert int(tloss) == int(jloss)
    assert_same_mlp(tm, jm)
