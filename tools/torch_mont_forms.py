#!/usr/bin/env python
"""K4 (``mont_mac``, ``hhe_tpu_torch/csrc/modarith.cu``) by form, on the card.

Builds the Montgomery kernels, runs ``chip_smoke.check_mont_sites`` (every
K3 site and every K4 form against its plain version at N = 16384 / 13 and
N = 65536 / 17 limbs, aligned and not), then times each K4 site of the
port's paths at full size in the form ``mod_kernels.plan`` picks and in the
general form (the one-pass loop) on the same operands: device time of a CUDA
graph of launches cycling through operand copies that miss the 50 MB L2,
beside the bound (``chip_smoke.mont_bound``).  Each site is first checked
against the plain version (``torch.equal``).  Prints one line a site and
writes them as JSON to ``--out`` if given; the card's name and power limit
come first.

    python3 tools/torch_mont_forms.py [--skip-checks] [--sites NAME ...] [--out FILE]
"""

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hhe_tpu_torch.ops import mod_kernels, primes  # noqa: E402


def sites(gen):
    """name -> (a, b, q, qinv_neg, dim) at the shapes the port's paths give K4."""
    dev = torch.device("cuda")
    out = {}

    def r(shape, qq):
        return cs.mont_residues(shape, qq, gen)

    for n, k, tag in ((16384, 13, ""), (65536, cs.LARGE_KS_LIMBS, " N=65536")):
        kd, kp = k, k + 1
        mods = primes.ntt_primes(n, 30, kp)
        q, qi = cs.mont_columns(mods[:k], dev)
        qp, qpi = cs.mont_columns(mods, dev)
        qpc, qpic = qp[:, None], qpi[:, None]
        out["bsgs contraction k0/k1" + tag] = (
            r((kd, kp, n), qp).transpose(-3, -2), r((2, 31, kp, kd, n), qpc), qpc, qpic, -2)
        out["one ciphertext key-switch k0/k1" + tag] = (
            r((kd, kp, n), qp), r((2, kd, kp, n), qp), qp, qpi, -3)
        if n > 16384:
            continue
        out["bsgs giantstep contraction k0/k1"] = (
            r((3, kd, kp, n), qp).transpose(-3, -2), r((2, 3, kp, kd, n), qpc), qpc, qpic, -2)
        out["bsgs q sum"] = (r((1, 32, k, n), q), r((4, 32, k, n), q), q, qi, 1)
        out["bsgs qp sum H0/H1"] = (r((31, 2, kp, n), qp).transpose(0, 1)[:, None],
                                    r((4, 32, kp, n), qp)[:, 1:], qp, qpi, 2)
        out["relin key-switch B=64 k0/k1"] = (
            r((64, kd, kp, n), qp), r((2, 1, kd, kp, n), qp), qp, qpi, -3)
        bsk, bski = cs.mont_columns(primes.ntt_primes(n, 31, k + 2), dev)
        out["base conversion q -> Bsk B=64"] = (
            r((3, 64, k, n), q)[..., None, :], r((k, k + 2), bsk.reshape(1, -1)).long()[:, :, None],
            bsk, bski, -3)
        qm, qmi = cs.mont_columns(mods[:k] + primes.ntt_primes(n, 31, 1), dev)
        out["base conversion B -> q + m_sk B=64"] = (
            r((3, 64, k + 1, n), bsk[: k + 1])[..., None, :],
            r((k + 1, k + 1), qm.reshape(1, -1)).long()[:, :, None], qm, qmi, -3)
        m2 = primes.ntt_primes(n, 30, 17)  # the 2FC chain: 16 data limbs and P
        q2, q2i = cs.mont_columns(m2, dev)
        out["2FC key-switch k0/k1"] = (
            r((4, 32, 16, 17, n), q2), r((2, 1, 1, 16, 17, n), q2), q2, q2i, -3)
    return out


def copies(x, n):
    """x and n - 1 copies of it with the same shape and strides."""
    if not isinstance(x, torch.Tensor):
        return [x] * n
    out = [x]
    for _ in range(n - 1):
        y = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
        out.append(y.copy_(x))
    return out


def time_site(name, a, b, q, qi, dim):
    p = mod_kernels.plan(a, b, q, qi, dim)
    got = mod_kernels.mont_mac(a, b, q, qi, dim)
    want = cs.mont_plain("mont_mac", a, b, q, qi, dim)
    if not torch.equal(got, want):
        raise AssertionError(f"K4 differs from its plain version at {name}")
    del got, want
    b_ms, b_by = cs.mont_bound(p, a, b, q, qi)
    nbytes = sum(x.element_size() * x.numel() for x in (a, b) if isinstance(x, torch.Tensor))
    n = max(1, min(20, -(-2 * cs.L2_BYTES // max(1, nbytes))))
    pairs = list(zip(copies(a, n), copies(b, n)))
    row = {"site": name, "form": p.form, "threads": p.threads, "fan_out": p.sizes[0],
           "a": list(a.shape), "b": list(b.shape), "dim": dim, "terms": p.terms,
           "bound_ms": b_ms, "bound_by": b_by}
    for form, fan in (("new", True), ("general", False)):
        fn = cs.rotating([lambda x=x, y=y, f=fan: mod_kernels.mont_mac(x, y, q, qi, dim, fan_out=f)
                          for x, y in pairs])
        row[f"{form}_device_ms_cold"] = cs.graph_ms(fn)
    row["share"] = b_ms / row["new_device_ms_cold"]
    row["general_share"] = b_ms / row["general_device_ms_cold"]
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-checks", action="store_true", help="skip chip_smoke's phase-2 site checks")
    ap.add_argument("--sites", nargs="*", help="time only these sites")
    ap.add_argument("--out", help="write the rows as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    mod_kernels.build()
    for line in mod_kernels.BUILD_LOG.get("compiler_output", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    if not args.skip_checks:
        cs.check_mont_sites()
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, ops in sites(gen).items():
        if args.sites and name not in args.sites:
            continue
        row = time_site(name, *ops)
        rows.append(row)
        print(f"{name}: {row['form']} (F={row['fan_out']}, {row['threads']} threads) "
              f"{row['new_device_ms_cold']:.4f} ms on the device, cold "
              f"({row['share']:.0%} of {row['bound_ms']:.4f}, {row['bound_by']}); general form "
              f"{row['general_device_ms_cold']:.4f} ({row['general_share']:.0%})", flush=True)
        del ops
        torch.cuda.empty_cache()
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps({"card": smi, "sites": rows}, indent=1))


if __name__ == "__main__":
    main()
