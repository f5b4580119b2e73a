"""Time design variants of the port's CUDA NTT kernels beside the committed ones.

    python3 tools/torch_ntt_variants.py

Each variant is ``hhe_tpu_torch/csrc/ntt.cu`` with one text substitution (a
design choice undone).  All are compiled by nvcc in parallel into
``build/ntt_variants/``, with ptxas' spill report; each kernel is held
against its plain version (``torch.equal``) and timed by CUDA events at the
ECG main path's dominant shapes, in rounds that alternate the order of the
variants.  The last line is one JSON object.  Needs one CUDA card; imports
only ``hhe_tpu_torch``, ``torch`` and the standard library.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DF = "constexpr int DF_BITS = (FWD || LAZY) ? 2 : 3;"
VARIANTS = {
    "committed": [],
    # the same number of tile buffers in both directions
    "two_buffers": [("return fwd ? 2 : 3;", "return 2;")],
    "three_buffers": [("return fwd ? 2 : 3;", "return 3;")],
    # one 8-byte twiddle load per butterfly group, never two pairs at once
    "scalar_twiddles": [("if (p + 1 < P.r && (hi < 0 || p + 1 < DF_BITS)) {", "if (false) {")],
    # every stage over all 16 registers (no depth-first groups)
    "breadth_first": [(DF, "constexpr int DF_BITS = 0;")],
    # groups of 4 registers for the eager inverse too
    "groups_of_4": [(DF, "constexpr int DF_BITS = 2;")],
}
# (kernel, shape, bits of the moduli, limbs): the dominant main-path shapes
CASES = [
    ("ntt_fwd", (64, 13, 14, 16384), 30, 14),
    ("ntt_inv", (3, 64, 15, 16384), 31, 15),
    ("ntt_inv", (3, 64, 13, 16384), 30, 13),
    ("ntt_fwd", (2, 64, 15, 16384), 31, 15),
]
ROUNDS = 8


def build(out_dir: pathlib.Path):
    from hhe_tpu_torch.ops import ntt_kernels

    src = ntt_kernels.SOURCE.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {ntt_kernels.SOURCE}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            ntt_kernels.nvcc_command(cu, out_dir / f"{name}.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libs, spills = {}, {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        report = ntt_kernels.ptxas_report(out)
        spills[name] = [kernel for kernel, info in report.items() if info["spill_bytes"]]
        libs[name] = ntt_kernels.bind(ctypes.CDLL(str(out_dir / f"{name}.so")))
    return libs, spills


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_ntt_variants: no CUDA device")
    from hhe_tpu_torch.ops import ntt, ntt_kernels, primes

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs, spills = build(ROOT / "build" / "ntt_variants")
    for name, spilled in spills.items():
        print(f"{name}: spills in {spilled or 'no kernel'}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = []
    for kern, shape, bits, k in CASES:
        n = shape[-1]
        tb = ntt.build_tables(primes.ntt_primes(n, bits, k), n, dev)
        q = tb.q.reshape(*([1] * (len(shape) - 2)), -1, 1)
        x = (torch.randint(0, 1 << 31, shape, generator=gen, device=dev) % q).to(torch.int32)
        plain = ntt.ntt_fwd_plain if kern == "ntt_fwd" else ntt.ntt_inv_plain
        cases.append((kern, shape, tb, x, torch.empty_like(x), plain(x, tb)))

    times = {name: {f"{c[0]}{list(c[1])}": [] for c in cases} for name in libs}
    names = list(libs)
    for rnd in range(ROUNDS):
        for name in names if rnd % 2 == 0 else names[::-1]:
            for kern, shape, tb, x, y, want in cases:
                fn = lambda: ntt_kernels.launch(libs[name], kern, x, y, tb)  # noqa: E731
                if fn() != 0:
                    raise RuntimeError(f"{name} {kern} launch failed")
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    raise AssertionError(f"{name} {kern} {list(shape)} differs from the plain version")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    fn()
                end.record()
                torch.cuda.synchronize()
                times[name][f"{kern}{list(shape)}"].append(start.elapsed_time(end) / 20)
        print(f"round {rnd} done", flush=True)
    for name, per in times.items():
        print(name + ": " + " | ".join(f"{k} {min(v):.4f}-{max(v):.4f} ms" for k, v in per.items()),
              flush=True)
    print(json.dumps({"card": card, "spills": spills, "ms": times}), flush=True)


if __name__ == "__main__":
    main()
