"""Profile one ECG keystream block and one ciphertext's CSP evaluation of the
PyTorch/CUDA port on one card, for one source tree.

    python3 tools/torch_block_profile.py [--tree DIR] [--label NAME] [--out FILE]

``--tree`` imports ``hhe_tpu_torch`` from DIR (default: this checkout), so
that two trees (a parent and its change, unpacked with ``git archive``) can
be compared on one card in one call, in turns: parent, change, change,
parent.  Each tree builds its kernels into its own ``build/``.

The stack is ``chip_smoke.py``'s phase 3 (N=16384, t=65537, 13 data limbs,
device keygen, seed 1).  Measured, each synchronised:

- ``block_ms``: the least wall time of REPS keystream blocks
  (``Transcipher._keystream_impl`` on expanded round material);
- a block under ``torch.profiler``: ``chip_smoke.profiled`` (this
  checkout's, whichever tree is measured, so that both trees are read by one
  profiler and one kernel-family table), and the busy share of the
  unprofiled ``block_ms``;
- ``ct_eval_ms``: the least wall time of one ciphertext's evaluation on the
  parties' path (``csp_eval_1fc``'s body with ``do_sum=True``: multiply,
  relinearize and the log-depth vector sum, 13 rotations at N=16384), and its kernels, busy ms and
  families under the profiler;
- ``block_graph_ms`` and ``ct_graph_ms``: the same two replayed as
  ``utils.graphs`` units (the block through ``Transcipher._jit_keystream``,
  the ciphertext through a unit of that body), least wall
  time, each with its profile (``block_graph_profile``,
  ``ct_graph_profile``: the replay's kernels, busy ms and families);
- ``decompose_ms``: the least wall time of ``csp_decompose`` on B=64
  random ECG-width samples (128 words) with a fresh nonce a rep (PASTA
  encryption outside), as ``chip_smoke.py`` times it, and
  ``block_rcs_ms``, the host's round constants of a fresh block inside it;
- ``host_us_per_call``: the host's time to dispatch one call (a loop of CALLS
  calls, unsynchronised, the least of REPS loops) of ``modular.add_mod`` on
  one ciphertext's [13, N] rows, ``bfv_eval._digits`` of its 13 limbs to
  the 14 moduli of q and P, and ``bfv_eval.mod_down`` of a key-switch's
  [2, 14, N]: what a call costs the host whether it runs a kernel or plain
  PyTorch passes.

Prints one JSON line (and appends it to ``--out``).  Needs a card: without
one it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

REPS = 5
CALLS = 200
ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_chip_smoke():
    """This checkout's chip_smoke.py as a module, by its path (``--tree``'s
    own copy may be another version)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def least_ms(fn, reps: int = REPS) -> float:
    import torch

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_block_profile: no CUDA device; no result")
    profiled = load_chip_smoke().profiled
    from hhe_tpu_torch.ops import bfv, bfv_eval, helin, modular, pasta
    from hhe_tpu_torch.workloads import hhe_inference as wk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    stack = wk.build_stack(bfv.BFVParams(n=16384, data_limbs=13, seed=1), input_len=128,
                           device_keygen=True, seed=1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ctx, tc = stack.ctx, stack.tc
    enc_key = tc.encrypt_key(stack.pk, pasta.get_fixed_symmetric_key())
    mats_qp, rcs_pt = tc.device_block_plaintexts(pasta.NONCE, 0)
    keys = tc._keys()

    def block():
        return tc._keystream_impl(enc_key.data, mats_qp, rcs_pt, keys)

    block()
    block_ms = least_ms(block)
    prof = profiled(block)

    rng = np.random.default_rng(0)
    ct = ctx.encrypt(stack.pk, ctx.encode(rng.integers(0, 64, ctx.n)))
    wct = ctx.encrypt(stack.pk, ctx.encode(rng.integers(-3, 4, ctx.n)))

    def eval_one():
        prod = bfv_eval.relinearize(ctx, bfv_eval.multiply(ctx, ct, wct), stack.rk)
        return helin.encrypted_vec_sum_log(ctx, prod, stack.gks)

    eval_one()
    ct_ms = least_ms(eval_one)
    ct_prof = profiled(eval_one)

    from hhe_tpu_torch.utils import graphs

    def block_graph():
        return tc._jit_keystream(enc_key.data, mats_qp, rcs_pt, keys)

    def ct_body(dd, w, rk, gks):
        prod = bfv_eval.relinearize(ctx, bfv_eval.multiply(ctx, bfv.Ciphertext(dd), w), rk)
        return helin.encrypted_vec_sum_log(ctx, prod, gks).data

    ct_unit = graphs.jit(ct_body, "csp_eval", ctx)

    def ct_graph():
        return ct_unit(ct.data, wct, stack.rk, stack.gks)

    replayed = {}
    for name, fn in (("block", block_graph), ("ct", ct_graph)):
        fn()
        fn()
        replayed[name] = (least_ms(fn), profiled(fn))

    cipher = pasta.Pasta(pasta.get_fixed_symmetric_key(), ctx.t)
    x = rng.integers(0, 1 << 10, (64, 128)).astype(np.uint64)
    nonces = iter(range(60_000, 60_100))

    def fresh(fn):
        nonce = next(nonces)
        sym = cipher.encrypt(x, nonce=nonce)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(sym, nonce)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    fresh(lambda sym, nonce: wk.csp_decompose(stack, enc_key, sym, nonce=nonce))
    decompose_ms = min(fresh(lambda sym, nonce: wk.csp_decompose(stack, enc_key, sym, nonce=nonce))
                       for _ in range(REPS))
    rcs_ms = min(fresh(lambda sym, nonce: tc.block_rcs(nonce, 0)) for _ in range(REPS))

    q = ctx.tb_q.q
    row = ct.data[0]  # [13, N]
    poly_qp = torch.cat([row, row[:1]])  # [14, N]: a coefficient row over q and P
    pair = torch.stack([poly_qp, poly_qp])
    dispatched = {"add_mod": lambda: modular.add_mod(row, row, q),
                  "digits": lambda: bfv_eval._digits(ctx, row, 0, ctx.k),
                  "mod_down": lambda: bfv_eval.mod_down(ctx, pair)}
    host_us = {}
    for name, fn in dispatched.items():
        fn()
        best = float("inf")
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            best = min(best, (time.perf_counter() - t0) / CALLS * 1e6)
        host_us[name] = best
    torch.cuda.synchronize()
    out = {
        "label": args.label, "tree": args.tree, "card": card, "torch": torch.__version__,
        "setup_s": setup_s, "block_ms": block_ms, "block_profile": prof,
        "busy_share_of_block_ms": prof["busy_ms"] / block_ms,
        "ct_eval_ms": ct_ms, "ct_eval_profile": {k: ct_prof[k] for k in ("kernels", "busy_ms", "by_family")},
        **{f"{name}_graph_ms": ms for name, (ms, _) in replayed.items()},
        "decompose_ms": decompose_ms, "block_rcs_ms": rcs_ms,
        **{f"{name}_graph_profile": {k: p[k] for k in ("kernels", "busy_ms", "by_family")}
           for name, (_, p) in replayed.items()},
        "host_us_per_call": host_us,
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
