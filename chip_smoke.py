"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure propagates and the exit code is nonzero):

0. device: the card's name and power limit, torch's CUDA version, nvcc;
1. build: compile the NTT kernels from ``hhe_tpu_torch/csrc``;
2. kernels: each kernel against its plain PyTorch version (``torch.equal``)
   for 30-bit (lazy) and 31-bit (eager) moduli and t = 65537 at every
   N = 2^8 ... 2^14 (each a kernel instance of its own), with fewer 64 KB
   tiles than the card has SMs and with at least four tiles a block, and
   inv(fwd(x)) == x;
3. main path: ``build_stack`` at the production BFV parameters (N=16384,
   13 x 30-bit limbs, device keygen), then ``hhe_ecg_inference`` on B=64
   samples.  Predictions must equal the plaintext model's, one decomposed
   sample must decrypt to its input with >= 40 bits of noise budget, and
   both kernels must have launched during the run.  Then the timings:
   decompose at B=64 with a fresh nonce per rep (PASTA encryption outside the
   timed region), one keystream block, the FC product, the batched decrypt;
4. kernels at the main path's shapes: every shape the run gave each kernel,
   on random residues, against the plain version (``torch.equal``), timed
   per call from Python (``ms``) and on the device alone
   (``device_ms``, a CUDA graph of launches), each beside its bound;
5. profile: one keystream block under ``torch.profiler``, device busy time
   by kernel;
6. one JSON line with every kernel's launches, error, time, plain time and
   bound, per shape and over the whole main path, then the device line last.

Imports only ``hhe_tpu_torch``, ``torch``, ``numpy`` and the standard library.
"""

from __future__ import annotations

import collections
import json
import subprocess
import time

import numpy as np

# H100 SXM peaks: HBM rate (NVIDIA data sheet), and 32-bit integer multiplies
# at 132 SMs x 64 INT32 lanes x 1.98 GHz (Hopper architecture white paper):
# a quarter of the 67 TFLOP/s float32 rate, which counts an FMA as two flops
# on 128 lanes per SM.
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9

B = 64  # samples per decompose, the JAX package's headline batch
REPS = 3


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, by CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no result")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from hhe_tpu_torch.ops import ntt_kernels

    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {ntt_kernels.nvcc_path()}")
    return smi


def phase_build():
    """Compile the kernels and show ptxas' registers and spills per kernel;
    a kernel that spills fails the build phase."""
    from hhe_tpu_torch.ops import ntt_kernels

    t0 = time.perf_counter()
    lib = ntt_kernels.build()
    ntt_kernels._library()
    nvcc_s = ntt_kernels.BUILD_LOG.get("seconds")
    log(f"build: {lib} in {time.perf_counter() - t0:.2f} s "
        + (f"(nvcc {nvcc_s:.2f} s)" if nvcc_s is not None else "(already built)"))
    report = ntt_kernels.ptxas_report(ntt_kernels.BUILD_LOG.get("compiler_output", ""))
    for name, info in report.items():
        log(f"  ptxas: {name}: {info['registers']}")
    spills = [name for name, info in report.items() if info["spill_bytes"]]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    log("  ptxas: no kernel spills")


def phase_kernels():
    """Kernel == plain version, bit for bit, at every N the wrapper takes,
    for lazy, eager and t moduli, with fewer tiles than SMs and with at least
    four tiles for every block (so each block reuses its tile buffers)."""
    import torch

    from hhe_tpu_torch.ops import ntt, ntt_kernels, primes

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for logn in range(8, 15):
        n = 1 << logn
        tile_rows = ntt_kernels.MAX_N // n  # rows in one 64 KB tile
        for bits, k in ((30, 13), (30, 14), (31, 15), (17, 1)):
            mods = (65537,) if bits == 17 else primes.ntt_primes(n, bits, k)
            tb = ntt.build_tables(mods, n, dev)
            gen = torch.Generator(device=dev).manual_seed(n * 100 + bits)
            for lead in ((2, 3), (-(-(4 * sms + 3) * tile_rows // k),)):
                x = torch.stack(
                    [torch.randint(0, m, (*lead, n), generator=gen, device=dev) for m in mods], -2
                ).to(torch.int32)  # [*lead, k, n]
                f_plain = ntt.ntt_fwd_plain(x, tb)
                f_kern = ntt.ntt_fwd(x, tb)
                i_plain = ntt.ntt_inv_plain(f_plain, tb)
                i_kern = ntt.ntt_inv(f_plain, tb)
                back = ntt.ntt_inv(f_kern, tb)
                ok = (torch.equal(f_kern, f_plain) and torch.equal(i_kern, i_plain)
                      and torch.equal(back, x))
                rows = x.numel() // n
                log(f"kernels n={n} bits={bits} k={k} rows={rows} "
                    f"tiles={-(-rows // tile_rows)} lazy={tb.lazy}: "
                    f"{'equal' if ok else 'DIFFER'}")
                if not ok:
                    raise AssertionError(
                        f"NTT kernel differs from plain version at n={n} bits={bits} rows={rows}")


class ShapeRecorder:
    """Records the (rows, k, n) of every kernel call, without touching the
    wrappers or their launch counts."""

    def __init__(self):
        from hhe_tpu_torch.ops import ntt_kernels

        self.mod = ntt_kernels
        self.orig = {name: getattr(ntt_kernels, name) for name in ("ntt_fwd", "ntt_inv")}
        self.calls = {name: collections.Counter() for name in self.orig}

    def __enter__(self):
        for name, fn in self.orig.items():
            def rec(x, tb, _fn=fn, _name=name):
                self.calls[_name][(tuple(x.shape), tb.moduli)] += 1
                return _fn(x, tb)
            setattr(self.mod, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one fn() launch, without the host's time per call:
    ``launches`` calls captured in a CUDA graph, replayed ``reps`` times."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, reps) / launches


def bound(name, shape, moduli):
    """Least time on the card for one call (ms): the larger of the bytes
    over the HBM rate and the multiplies over the int32 multiply rate, and
    which of the two it is.  Bytes: the row tensor read and written once,
    one twiddle table and the per-limb constants.  Multiplies: 3 per
    butterfly (a Shoup product) and, for the inverse, 3 per coefficient for
    N^-1."""
    n = shape[-1]
    nrows = int(np.prod(shape[:-1]))
    logn = n.bit_length() - 1
    nbytes = 8 * nrows * n + 4 * len(moduli) * (n + 3)
    muls = 3 * nrows * (n // 2) * logn + (3 * nrows * n if name == "ntt_inv" else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, muls / INT32_MUL_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_rows(launches, calls):
    """Check each kernel against its plain version at every shape the main
    path gave it (random residues below each q, ``torch.equal``), time it
    there and give its bound there.  ``ms`` is the time of a Python call
    (a loop of 20 calls timed by CUDA events) and
    ``device_ms`` the device's alone (a CUDA graph of launches).  The row's
    headline numbers are at the dominant shape (the one carrying the most
    polynomial rows).  Raises on any difference."""
    import torch

    from hhe_tpu_torch.ops import ntt, ntt_kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for name, replaces, plain in (
        ("ntt_fwd", "hhe_tpu/ops/ntt_pallas.py:146", ntt.ntt_fwd_plain),
        ("ntt_inv", "hhe_tpu/ops/ntt_pallas.py:197", ntt.ntt_inv_plain),
    ):
        kern = getattr(ntt_kernels, name)
        (shape, moduli), ncalls = max(
            calls[name].items(), key=lambda kv: kv[1] * int(np.prod(kv[0][0][:-1]))
        )
        err, shapes = 0, []
        for (shp, mods), cnt in sorted(calls[name].items()):
            tb = ntt.build_tables(mods, shp[-1], dev)
            q = tb.q.reshape(*([1] * (len(shp) - 2)), -1, 1)
            x = (torch.randint(0, 1 << 31, shp, generator=gen, device=dev) % q).to(torch.int32)
            got, want = kern(x, tb), plain(x, tb)
            err = max(err, int((got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from its plain version at {list(shp)}")
            del got, want
            b_ms, b_by = bound(name, shp, mods)
            ms, dev_ms = cuda_ms(lambda: kern(x, tb), 20), graph_ms(lambda: kern(x, tb))
            shapes.append({
                "shape": list(shp), "lazy": tb.lazy, "calls": cnt, "ms": ms, "device_ms": dev_ms,
                "bound_ms": b_ms, "bound_by": b_by,
                "share_of_bound": b_ms / ms, "device_share_of_bound": b_ms / dev_ms,
            })
            if (shp, mods) == (shape, moduli):
                plain_ms = cuda_ms(lambda: plain(x, tb), 2)
                head = shapes[-1]
            log(f"  {name} {list(shp)} lazy={tb.lazy} x{cnt}: {ms:.4f} ms a call, "
                f"{dev_ms:.4f} ms on the device, bound {b_ms:.4f} ms ({b_by}), "
                f"{b_ms / ms:.0%} ({b_ms / dev_ms:.0%} on the device) of it")
        log(f"{name}: equal to its plain version at all {len(shapes)} main-path shapes")
        path_ms = sum(r["calls"] * r["ms"] for r in shapes)
        path_dev = sum(r["calls"] * r["device_ms"] for r in shapes)
        path_bound = sum(r["calls"] * r["bound_ms"] for r in shapes)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "hhe_tpu_torch/csrc/ntt.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err,
            "tolerance": 0,  # exact residues: the kernel must equal its plain version
            "ms": head["ms"],
            "device_ms": head["device_ms"],
            "plain_ms": plain_ms,
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "shape": list(shape),
            "lazy": head["lazy"],
            "calls_at_shape": ncalls,
            # over the main path: every recorded shape, times its calls
            "main_path_ms": path_ms,
            "main_path_device_ms": path_dev,
            "main_path_bound_ms": path_bound,
            "main_path_share_of_bound": path_bound / path_ms,
            "main_path_device_share_of_bound": path_bound / path_dev,
            "shapes_checked": len(shapes),
            "shapes": shapes,
            "verdict": "equal",
        })
        log(f"{name} at {list(shape)}: {head['ms']:.4f} ms a call ({head['device_ms']:.4f} ms "
            f"on the device), {plain_ms:.3f} ms plain, bound {head['bound_ms']:.4f} ms "
            f"({head['bound_by']}); over the main path's {launches[name]} launches "
            f"{path_ms:.3f} ms in calls ({path_dev:.3f} ms on the device) against a bound of "
            f"{path_bound:.3f} ms ({path_bound / path_ms:.0%}; {path_bound / path_dev:.0%})")
    return rows


def phase_main_path():
    import torch

    from hhe_tpu_torch.models import pocketnn
    from hhe_tpu_torch.ops import bfv, ntt_kernels, pasta, transcipher
    from hhe_tpu_torch.workloads import hhe_inference as wk

    stats = {}
    t0 = time.perf_counter()
    stack = wk.build_stack(
        bfv.BFVParams(n=16384, data_limbs=13, seed=1), input_len=128,
        device_keygen=True, seed=1,
    )
    torch.cuda.synchronize()
    stats["setup_s"] = time.perf_counter() - t0
    ctx = stack.ctx
    log(f"setup: {stats['setup_s']:.2f} s, {len(stack.gks)} galois keys")

    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, (B, transcipher.T))
    w = rng.integers(-508, 509, transcipher.T)

    torch.cuda.reset_peak_memory_stats()
    ntt_kernels.reset_launches()
    with ShapeRecorder() as rec:
        t0 = time.perf_counter()
        out = wk.hhe_ecg_inference(stack, w, x)
        torch.cuda.synchronize()
        stats["ecg_inference_s"] = time.perf_counter() - t0
    launches = dict(ntt_kernels.LAUNCHES)
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path: hhe_ecg_inference B={B} in {stats['ecg_inference_s']:.2f} s, "
        f"launches {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel did not launch on the main path: {launches}")

    sums = (x.astype(np.int64) * w).sum(1)
    expect = np.where(pocketnn.simple_pocket_sigmoid(sums).numpy() > 64, 128, 0)
    if not np.array_equal(out["predictions"], expect):
        raise AssertionError("encrypted predictions differ from the plaintext model")
    d0 = bfv.Ciphertext(out["data_ct"].data[:, 0])
    budget = ctx.noise_budget(stack.sk, d0)
    got = ctx.decode(ctx.decrypt(stack.sk, d0))[: transcipher.T]
    if budget < 40 or not np.array_equal(got, x[0]):
        raise AssertionError(f"decomposed sample wrong or noisy (budget {budget})")
    stats["noise_budget_bits"] = budget
    n_one = int((out["predictions"] == 128).sum())
    log(f"predictions equal the plaintext model ({n_one}/{B} positive); "
        f"decomposed sample 0 decrypts exactly, noise budget {budget} bits")

    # decompose at B with a fresh nonce per rep; PASTA encryption outside
    key = pasta.get_fixed_symmetric_key()
    cipher = pasta.Pasta(key, ctx.t)
    enc_key = stack.tc.encrypt_key(stack.pk, key)
    nonce = 50_000
    times = []
    for _ in range(REPS + 1):  # the first rep warms the allocator
        sym = cipher.encrypt(x.astype(np.uint64), nonce=nonce)
        times.append(wall_s(lambda: wk.csp_decompose(stack, enc_key, sym, nonce=nonce)))
        nonce += 1
    stats["decompose_s_by_rep"] = times
    stats["pasta_bfv_transcipher_samples_per_s_batch64"] = B / min(times[1:])

    tc = stack.tc
    mats_qp, rcs_pt = tc.device_block_plaintexts(pasta.NONCE, 0)
    keys = tc._keys()
    stats["block_ms"] = 1e3 * min(
        wall_s(lambda: tc._keystream_impl(enc_key.data, mats_qp, rcs_pt, keys))
        for _ in range(REPS)
    )
    stats["expand_ms"] = 1e3 * min(
        wall_s(lambda: tc._expand_round_mats(tc.block_first_rows(nonce, 0)))
        for _ in range(REPS)
    )
    data_ct = out["data_ct"]
    wct = bfv.Ciphertext(helin_weight(stack, w).data[:, None])
    stats["csp_eval_1fc_ms"] = 1e3 * min(
        wall_s(lambda: wk.csp_eval_1fc(stack, data_ct, wct, do_sum=False)) for _ in range(REPS)
    )
    prod = out["prod_ct"]
    stats["decrypt_ms"] = 1e3 * min(
        wall_s(lambda: wk.analyst_decrypt_sum_sigmoid(stack, prod, transcipher.T))
        for _ in range(REPS)
    )
    stats["peak_mem_gib_after_timing"] = torch.cuda.max_memory_allocated() / 2**30
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    return stack, launches, rec.calls, stats


def helin_weight(stack, w):
    from hhe_tpu_torch.ops import helin

    return helin.encrypt_weight(stack.ctx, stack.pk, np.asarray(w)[None, :])[0]


def phase_profile(stack, block_ms):
    """Device time by kernel over one keystream block under torch.profiler.
    The profiler slows the host, so the busy share is also given against
    the unprofiled ``block_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hhe_tpu_torch.ops import pasta

    tc = stack.tc
    key = pasta.get_fixed_symmetric_key()
    enc_key = tc.encrypt_key(stack.pk, key)
    mats_qp, rcs_pt = tc.device_block_plaintexts(pasta.NONCE, 0)
    keys = tc._keys()
    tc._keystream_impl(enc_key.data, mats_qp, rcs_pt, keys)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tc._keystream_impl(enc_key.data, mats_qp, rcs_pt, keys)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    ntt_ms = sum(e.self_device_time_total for e in evs if "ntt_" in e.key) / 1e3
    out = {
        "profiled_block_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "busy_share_of_profiled_wall": busy_ms / wall_ms,
        "busy_share_of_unprofiled_block_ms": busy_ms / block_ms,
        "device_kernels": sum(e.count for e in evs),
        "ntt_ms": ntt_ms,
        "ntt_share_of_busy": ntt_ms / busy_ms,
    }
    log(f"profile: {out}")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  {e.key[:100]}")
    return out


def main():
    import torch

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    phase_kernels()
    stack, launches, calls, stats = phase_main_path()
    rows = kernel_rows(launches, calls)
    prof = phase_profile(stack, stats["block_ms"])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"card": smi, "main_path": stats, "profile": prof}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
