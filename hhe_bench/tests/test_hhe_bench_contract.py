"""BENCHMARK.json and the folder obey the benchmark's contract: legal names
and units, every name resolving to its file, the imports the harness and
the reference may make, a pool that never repeats a nonce, a PASTA pool and
reference that give the bits they gave before BFV uploads came in, a BFV
pool that decrypts to its records, and a run that fails without a card
instead of falling back to the CPU."""

import ast
import hashlib
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hhe_bench import harness
from hhe_bench.reference import pasta as ref_pasta

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(not p.endswith("_torch") and (ROOT / p).is_dir() for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_resolve():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] == f"hhe_bench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (ROOT / "hhe_bench" / "entries" / f"{cfg['entry']}.py").exists()
        assert c["reduced"] == [] and c["name"] in used


def test_workloads_resolve():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["config"] in configs and w["chips"] in (1, 4) and one_line(w["why"])
        assert (ROOT / "hhe_bench" / "traffic" / f"{w['traffic']}.json").exists()


def test_metrics_resolve_and_every_cell_reports_enough():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e_names = {m["name"] for m in e2e}
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e_names and one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "hhe_bench" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in e2e_names
    for cell in cells:
        mine = [m for m in e2e if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in per if cell in m.get("workloads", cells)]
        assert layer and all(cell in [x for x in e2e if x["name"] == m["moves"]][0].get("workloads", cells)
                             for m in layer)
        if "step_mfu" in {m["name"] for m in layer}:
            assert (ROOT / "hhe_bench" / "counts" / f"{cell}.json").exists()


def imports(path: pathlib.Path):
    """Top-level names of every module ``path`` imports (relative imports
    as the package's own)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.add("hhe_bench" if node.level else node.module.split(".")[0])
    return out


def test_no_jax_and_a_reference_apart_from_the_program():
    files = sorted((ROOT / "hhe_bench").rglob("*.py"))
    assert files
    for f in files:
        assert not imports(f) & set(harness.FORBIDDEN), f
    for f in (ROOT / "hhe_bench" / "reference").rglob("*.py"):
        assert "hhe_tpu_torch" not in imports(f), f
    # top-level names are compared whole: the port is not the JAX package
    assert "hhe_tpu_torch" not in harness.FORBIDDEN and "hhe_tpu" in harness.FORBIDDEN


def test_pool_never_repeats_a_nonce_and_decrypts_to_its_records():
    loaded = harness.load_cell("ecg_1fc.b64")
    loaded["config"].update(n=1024, data_limbs=3)
    loaded["traffic"].update(records_per_request=3)
    h = harness.Harness(loaded, 2**31 + 5, "cpu")
    pool = harness.Pool(h, 20, 1000)
    got = [pool.next() for _ in range(25)]  # five past its end, encrypted inline
    nonces = [n for _, n, _ in got]
    assert len(set(nonces)) == len(nonces) == 25 and nonces == list(range(1000, 1025))
    ks = ref_pasta.keystream(h.pasta_key, nonces, 1, h.config["t"], "cpu").numpy()
    for (i, _, sym), k in zip(got, ks):
        assert np.array_equal((sym.astype(np.int64) - k) % h.config["t"], pool.records[i])


# sha256 of what a PASTA pool and the reference make at a small size, taken
# before the harness took BFV uploads and the reference a t up to 2^50: the
# benchmark's keys, the PASTA key, the records, every request's symmetric
# ciphertexts (one past the pool's end, made inline), and the records
# encoded, encrypted and decrypted (plaintexts, noise shares) by the reference
POOL_DIGESTS = {
    "ecg_1fc.b64": ({"n": 1024, "data_limbs": 3}, {"records_per_request": 3},
                    "18c9681b5249e37759416651f44619b5e9ddafabd9e3bf65ac60c697e935640c"),
    "mnist_2fc.b4": ({"n": 1024, "data_limbs": 4, "input_words": 200}, {"records_per_request": 2},
                     "b3783e850bfeb325a71c1c8f0575f3c9750959041ee5c8dcf24aa8730d24b5b2"),
}


@pytest.mark.parametrize("cell", sorted(POOL_DIGESTS))
def test_pasta_pool_and_reference_keep_their_bits(cell):
    config, traffic, want = POOL_DIGESTS[cell]
    loaded = harness.load_cell(cell)
    loaded["config"].update(config)
    loaded["traffic"].update(traffic)
    h = harness.Harness(loaded, 2**31 + 19, "cpu")
    pool = harness.Pool(h, 3, 1000)
    got = [pool.next() for _ in range(4)]
    d = hashlib.sha256()
    for x in (h.s, h.pk.numpy(), h.pasta_key, pool.records, *[u for _, _, u in got]):
        d.update(np.ascontiguousarray(x).tobytes())
    values = torch.as_tensor(pool.records.astype(np.int64)).reshape(-1, pool.records.shape[-1])
    pt = h.scheme.slots.encode(values)
    ct = h.scheme.encrypt(h.pk, pt, h.gen)
    m, share = h.scheme.decrypt(h.s_dev, ct)
    for x in (pt, ct, m, share, h.scheme.slots.decode(m)):
        d.update(np.ascontiguousarray(x.numpy()).tobytes())
    assert d.hexdigest() == want


def test_bfv_pool_decrypts_to_its_records():
    """BFV uploads: int32 [2, B, k, N] on the host, record b of request i in
    slots [0, L) of ciphertext b, one request past the pool's end made
    inline; no PASTA key, and none to encrypt for a transcipher."""
    loaded = harness.load_cell("ecg_1fc.b64")
    loaded["config"].update(n=1024, data_limbs=3, upload="bfv")
    loaded["traffic"].update(records_per_request=3)
    h = harness.Harness(loaded, 2**31 + 23, "cpu")
    pool = harness.Pool(h, 2, 1000)
    got = [pool.next() for _ in range(3)]
    assert [n for _, n, _ in got] == [1000, 1001, 1002] and len(pool.records) == 3
    for i, _, up in got:
        assert up.dtype == torch.int32 and up.device.type == "cpu" and tuple(up.shape) == (2, 3, 3, 1024)
        m, share = h.scheme.decrypt(h.s_dev, up)
        assert torch.equal(h.scheme.slots.decode(m)[:, :128], torch.as_tensor(pool.records[i], dtype=torch.int64))
        assert float(share.max()) < 1e-6
    assert not hasattr(h, "pasta_key")
    with pytest.raises(ValueError, match="bfv uploads"):
        h.encrypted_pasta_key()


def test_run_fails_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "-m", "hhe_bench.run", "--workload", "ecg_1fc.b64",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    if not torch.cuda.is_available():
        assert "needs 1 CUDA card" in p.stderr


@pytest.mark.parametrize("mix", sorted(p.stem for p in (ROOT / "hhe_bench" / "traffic").glob("*.json")))
def test_traffic_files_are_data(mix):
    t = json.loads((ROOT / "hhe_bench" / "traffic" / f"{mix}.json").read_text())
    assert {"records_per_request", "pool_requests_per_s", "check_requests", "trace_seconds"} <= set(t)
