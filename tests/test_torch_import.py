"""The port stands alone: it imports and runs its plain NTT in a process
where JAX cannot be imported, and no file of it imports JAX or hhe_tpu."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hhe_tpu_torch"

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import importlib, pkgutil
import hhe_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hhe_tpu_torch.__path__, "hhe_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"hhe_tpu_torch.ops.heconv", "hhe_tpu_torch.workloads.qat",
        "hhe_tpu_torch.workloads.he_conv", "hhe_tpu_torch.models.pocketnn",
        "hhe_tpu_torch.workloads.training",
        "hhe_tpu_torch.workloads.float_baseline", "hhe_tpu_torch.parallel.mesh",
        "hhe_tpu_torch.parallel.ntt_shard", "hhe_tpu_torch.parallel.limb_shard",
        "hhe_tpu_torch.native"} <= set(names), names
assert not any(m == "hhe_tpu" or m.startswith("hhe_tpu.") for m in sys.modules), "hhe_tpu imported"
import numpy as np, torch
from hhe_tpu_torch.ops import ntt, primes
mods = primes.ntt_primes(256, 30, 2)
tb = ntt.build_tables(mods, 256, torch.device("cpu"))
x = torch.from_numpy(np.stack([np.arange(256) % q for q in mods]).astype(np.int32))
assert torch.equal(ntt.ntt_inv(ntt.ntt_fwd(x, tb), tb), x)
print("OK", len(names))
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 23  # every submodule was imported


FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax\b|hhe_tpu\b(?!_torch))", re.M)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "tools").glob("torch_*.py"))
    + ["chip_smoke.py"],
)
def test_no_jax_or_hhe_tpu_imports(path):
    src = (ROOT / path).read_text()
    found = FORBIDDEN.search(src)
    assert found is None, found.group(0)
