"""The port's configuration, serialization and metrics against the JAX
package's (CPU): the same defaults, the same bytes, the same sizes and the
same report text.  Keys and ciphertexts are made by the JAX package on the
``test_utils.py`` context (N=1024, 3 limbs, seed 5) and carried over."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.utils import checks as jchecks
from hhe_tpu.utils import config as jconfig
from hhe_tpu.utils import metrics as jmetrics
from hhe_tpu.utils import serial as jserial
from hhe_tpu.workloads.hhe_inference import _split_batch as j_split_batch
from hhe_tpu_torch import convert
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.utils import checks as tchecks
from hhe_tpu_torch.utils import config as tconfig
from hhe_tpu_torch.utils import metrics as tmetrics
from hhe_tpu_torch.utils import serial as tserial
from hhe_tpu_torch.workloads.hhe_inference import split_batch as t_split_batch

CPU = torch.device("cpu")
PARAMS = dict(n=1024, data_limbs=3, seed=5)


@pytest.fixture(scope="module")
def objs():
    """JAX context and keys, a batched ciphertext, and the port's copies."""
    jc = jbfv.Context(jbfv.BFVParams(**PARAMS))
    sk = jc.keygen_secret()
    pk = jc.keygen_public(sk)
    rk = jc.keygen_relin(sk)
    gks = jc.keygen_galois(sk, [jc.galois_elt_from_step(s) for s in (1, -2)])
    cts = [jc.encrypt(pk, jc.encode(np.arange(50) * i)) for i in range(1, 4)]
    batch = jbfv.Ciphertext(jnp.stack([c.data for c in cts], 1))  # [2, 3, k, N]
    return dict(
        jc=jc, tc=tbfv.Context(tbfv.BFVParams(**PARAMS), device="cpu"),
        sk=sk, pk=pk, rk=rk, gks=gks, ct=cts[0], batch=batch,
        tsk=convert.secret_key(sk), tpk=convert.public_key(pk),
        trk=convert.kswitch_key(rk, CPU), tgks=convert.galois_keys(gks, CPU),
        tct=convert.ciphertext(cts[0], CPU), tbatch=convert.ciphertext(batch, CPU),
    )


@pytest.mark.parametrize("what", ["array_u32", "array_i8", "ciphertext", "batch",
                                  "public_key", "kswitch", "galois_keys"])
def test_dump_bytes_identical(objs, what):
    o = objs
    got, want = {
        "array_u32": (lambda: tserial.dump_array(o["tct"].data),
                      lambda: jserial.dump_array(np.asarray(o["ct"].data))),
        "array_i8": (lambda: tserial.dump_array(o["tsk"].s_small),
                     lambda: jserial.dump_array(o["sk"].s_small)),
        "ciphertext": (lambda: tserial.dump_ciphertext(o["tct"]),
                       lambda: jserial.dump_ciphertext(o["ct"])),
        "batch": (lambda: tserial.dump_ciphertext(o["tbatch"]),
                  lambda: jserial.dump_ciphertext(o["batch"])),
        "public_key": (lambda: tserial.dump_public_key(o["tpk"]),
                       lambda: jserial.dump_public_key(o["pk"])),
        "kswitch": (lambda: tserial.dump_kswitch(o["trk"]), lambda: jserial.dump_kswitch(o["rk"])),
        "galois_keys": (lambda: tserial.dump_galois_keys(o["tgks"]),
                        lambda: jserial.dump_galois_keys(o["gks"])),
    }[what]
    b = got()
    assert isinstance(b, bytes) and b == want()
    if what == "ciphertext":  # and the JAX package reads it back
        assert np.array_equal(np.asarray(jserial.load_ciphertext(b).data), np.asarray(o["ct"].data))


def test_metric_sizes_match_jax(objs):
    """The size functions of test_utils.py::test_metrics, equal to the JAX
    package's to the byte."""
    o = objs
    assert tmetrics.he_pk_size(o["tpk"]) == jmetrics.he_pk_size(o["pk"]) > 0
    assert tmetrics.he_key_size(o["trk"], o["tgks"]) == jmetrics.he_key_size(o["rk"], o["gks"])
    assert tmetrics.he_key_size() == jmetrics.he_key_size() == 0.0
    assert tmetrics.he_vec_size([o["tct"]]) == jmetrics.he_vec_size([o["ct"]]) > 0
    assert tmetrics.he_vec_size(t_split_batch(o["tbatch"])) == jmetrics.he_vec_size(
        j_split_batch(o["batch"])
    )
    sym = np.arange(600, dtype=np.uint64).reshape(2, 300)
    assert tmetrics.sym_enc_data_size(sym) == jmetrics.sym_enc_data_size(sym)


@pytest.mark.parametrize("shape", [(2, 3, 64), (2, 5, 3, 64), (3, 2, 4, 32)])
def test_he_vec_size_analytic(shape):
    """The shape-only meter equals serializing each sample frame, as in
    test_utils.py::test_he_vec_size_analytic_matches_serialized, and the JAX
    package's meter."""
    ct = tbfv.Ciphertext(torch.zeros(shape, dtype=torch.int32))
    jct = jbfv.Ciphertext(jnp.zeros(shape, jnp.uint32))
    got = tmetrics.he_vec_size_analytic(ct)
    assert got == tmetrics.he_vec_size(t_split_batch(ct)) == jmetrics.he_vec_size_analytic(jct)


def test_timer_ledger_merge_and_report_match_jax(capsys):
    """Timer, CommLedger and merge behave as the JAX package's, and the same
    timings and sizes give the same report and the same text."""
    pairs = []
    for mod in (tmetrics, jmetrics):
        ledger = mod.CommLedger()
        ledger.add("analyst-csp", 1.5)
        ledger.add("analyst-csp", 0.5)
        ledger.add("user-csp", 0.25)
        assert ledger.report() == {"analyst-csp": 2.0, "user-csp": 0.25}
        t = mod.Timer()
        with t.phase("user"):
            pass
        assert "user" in t.report_ms()
        t.phases = {"user": 0.0123, "csp": 1.5, "analyst": 0.25}
        t2 = mod.Timer()
        t2.phases = {"csp": 0.5}
        mt, ml = mod.merge([t, t2], [ledger, ledger])
        assert mt.phases == {"user": 0.0123, "csp": 2.0, "analyst": 0.25}
        assert ml.report() == {"analyst-csp": 4.0, "user-csp": 0.5}
        rep = mod.experiment_report(mt, ml, accuracy=0.5, extra={"samples": 3})
        pairs.append((rep, mod.format_experiment_report(rep), mod.print_time("x", 1234.5)))
    assert pairs[0] == pairs[1]
    rep = pairs[0][0]
    assert set(rep) == {"computation_ms", "communication_mb", "accuracy", "samples"}
    assert rep["computation_ms"]["total"] == 2262.3 and rep["communication_mb"]["total"] == 4.5


def test_print_parameters_and_noise_match_jax(objs, capsys):
    o = objs
    assert tmetrics.print_parameters(o["tc"]) == jmetrics.print_parameters(o["jc"])
    capsys.readouterr()
    tb = tmetrics.print_noise(o["tc"], o["tsk"], o["tct"], tag="ct")
    t_out = capsys.readouterr().out
    jb = jmetrics.print_noise(o["jc"], o["sk"], o["ct"], tag="ct")
    assert tb == jb and t_out == capsys.readouterr().out
    many = tmetrics.print_noise(o["tc"], o["tsk"], t_split_batch(o["tbatch"]))
    assert len(many) == 3 and "min" in capsys.readouterr().out


def test_config_matches_jax():
    """Every default of Config equals the JAX package's; HEConfig maps to the
    same BFVParams; RunConfig caps samples only under dry_run."""
    assert dataclasses.asdict(tconfig.DEFAULT) == dataclasses.asdict(jconfig.DEFAULT)
    for he in (tconfig.HEConfig(), tconfig.HEConfig().replace(mod_degree=1024, data_modulus_bits=91)):
        jhe = jconfig.HEConfig(**dataclasses.asdict(he))
        assert dataclasses.asdict(he.to_bfv_params(3)) == dataclasses.asdict(jhe.to_bfv_params(3))
    assert tconfig.HEConfig().to_bfv_params().data_limbs == 13
    for run, n, want in (
        (tconfig.RunConfig(), 10, 2),
        (tconfig.RunConfig(dry_run_num_samples=20), 10, 10),
        (tconfig.RunConfig(dry_run=False), 10, 10),
    ):
        assert run.sample_limit(n) == want
        assert jconfig.RunConfig(**dataclasses.asdict(run)).sample_limit(n) == want
    with pytest.raises(dataclasses.FrozenInstanceError):
        tconfig.DEFAULT.run.dry_run = False


def _write_idx(path, magic, dims, payload, gz):
    import gzip
    import struct

    raw = struct.pack(">" + "I" * (1 + len(dims)), magic, *dims) + payload.tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(raw)
    else:
        path.write_bytes(raw)


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
def test_loaders_read_idx_like_jax(tmp_path, gz):
    """idx3 images and idx1 labels written to a temporary MNIST-layout
    directory, raw or gzipped: both packages' loaders read the same arrays,
    with and without a limit and the 2-bit quantization."""
    from hhe_tpu.models import loaders as jloaders
    from hhe_tpu_torch.models import loaders as tloaders

    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 5, dtype=np.uint8)
    _write_idx(tmp_path / "t10k-images-idx3-ubyte", 2051, (5, 28, 28), images, gz)
    _write_idx(tmp_path / "t10k-labels-idx1-ubyte", 2049, (5,), labels, gz)
    for limit in (None, 3):
        x, y = tloaders.load_mnist_test(str(tmp_path), limit=limit)
        jx, jy = jloaders.load_mnist_test(str(tmp_path), limit=limit)
        n = 5 if limit is None else limit
        assert x.shape == (n, 784) and np.array_equal(x, jx) and np.array_equal(y, jy)
        assert np.array_equal(y, labels[:n]) and x.max() <= 4
    xf, _ = tloaders.load_fmnist_test(str(tmp_path), quantize=False)
    assert np.array_equal(xf, images.reshape(5, 784))
    assert np.array_equal(tloaders.quantize_2bit(xf), jloaders.quantize_2bit(xf))
    with pytest.raises(FileNotFoundError):
        tloaders.load_idx_labels(str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="magic"):
        tloaders.load_idx_labels(str(tmp_path / "t10k-images-idx3-ubyte"))


def test_csv_matrix_and_mitbih_labels_match_jax(tmp_path):
    """save_csv_matrix -> read_csv_matrix round trip in the reference's
    layout (a comma after every value) gives the JAX package's file and
    matrix; the time-series and MIT-BIH label readers equal the JAX
    package's on temporary files."""
    from hhe_tpu.models import loaders as jloaders
    from hhe_tpu.models import pocketnn as jpk
    from hhe_tpu_torch.models import loaders as tloaders
    from hhe_tpu_torch.models import pocketnn as tpk

    mat = np.random.default_rng(4).integers(-508, 509, (7, 10))
    tpk.save_csv_matrix(tmp_path / "t.csv", mat)
    jpk.save_csv_matrix(tmp_path / "j.csv", mat)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    back = tpk.read_csv_matrix(tmp_path / "t.csv")
    assert back.dtype == np.int64 and np.array_equal(back, mat)
    assert np.array_equal(back, jpk.read_csv_matrix(tmp_path / "t.csv"))
    (tmp_path / "f.csv").write_text("1.0, 2,\n\n-3,4.0,\n")
    assert np.array_equal(tloaders.load_time_series_csv(str(tmp_path / "f.csv")), [[1, 2], [-3, 4]])
    assert np.array_equal(tloaders.load_spo2_recording(str(tmp_path / "f.csv")),
                          jloaders.load_spo2_recording(str(tmp_path / "f.csv")))
    lab = np.random.default_rng(5).integers(0, 2, 13245)
    np.savetxt(tmp_path / "mitbih_bin_y_test.csv", lab, fmt="%d")
    np.savetxt(tmp_path / "mitbih_balanced_bin_y_train.csv", lab[:9], fmt="%.1f")
    got = tloaders.load_mitbih_labels("test", root=str(tmp_path))
    assert got.dtype == np.int64 and np.array_equal(got, lab)
    assert np.array_equal(got, jloaders.load_mitbih_labels("test", root=str(tmp_path)))
    bal = tloaders.load_mitbih_labels("train", balanced=True, root=str(tmp_path))
    assert np.array_equal(bal, lab[:9])
    assert tloaders.MITBIH_ROOT.startswith(tloaders.REFERENCE_ROOT)


@pytest.mark.parametrize(
    "fn, a, b",
    [
        ("are_same_vectors", [1, 2, 3], [1, 2, 3]),
        ("are_same_vectors", [1, 2, 3], [1, 2, 4]),
        ("are_same_vectors", [1, 2, 3], [1, 2]),
        ("are_same_vectors", np.zeros(3, np.uint64), np.zeros(3, np.int32)),
        ("are_same_matrices", [[1, 2], [3, 4]], [[1, 2], [3, 4]]),
        ("are_same_matrices", [[1, 2], [3, 4]], [[1, 2], [3, 5]]),
        ("are_same_matrices", [1, 2], [[1, 2]]),
        ("are_same_matrices", [[1, 2]], [[1], [2]]),
    ],
)
def test_are_same_checks_raise_where_jax_does(fn, a, b):
    """are_same_vectors / are_same_matrices raise CheckFailed (with the
    message given) exactly where the JAX package's do."""
    def outcome(mod):
        try:
            getattr(mod, fn)(a, b, msg="differ here")
        except mod.CheckFailed as e:
            return str(e)
        return None

    assert outcome(tchecks) == outcome(jchecks)
