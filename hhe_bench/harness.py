"""One run of one cell: set-up, the measured window, the traced window, the
check of what the window produced against the plain reference, and the
result line.

Everything that belongs to a configuration, a traffic mix, an entry or a
metric is found by name (see README.md): ``configs/<config>.json``,
``traffic/<mix>.json``, ``entries/<entry>.py`` (the configuration's
``entry``) and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import pathlib
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import frozen
from .reference import bfv as ref_bfv
from .reference import pasta as ref_pasta

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hhe_tpu")  # top-level module names, compared whole
NONCE_SPACE = 1 << 62
WARMUP = 2  # requests before the window: the first captures each graph unit, the second replays it
CHECK_AMONG = 5  # the sample is drawn among the first pool / CHECK_AMONG requests


def load_cell(workload: str, root: pathlib.Path = ROOT) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic mix and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"cell": cell,
            "config": json.loads((HERE / "configs" / f"{cell['config']}.json").read_text()),
            "traffic": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card() -> dict:
    """The card's name, power limit and SM clock, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return {"nvidia_smi": out.stdout.strip().splitlines()[0]}
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"nvidia_smi": None}


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


class Pool:
    """The users' uploads, made before the window: request i is
    ``records_per_request`` records under nonce ``base + i`` (no nonce
    repeats in a run), uploaded as the configuration's ``upload`` says
    (``Harness.upload``): PASTA-3 ciphertexts [B, L] uint64 under the
    user's PASTA key, or BFV ciphertexts [2, B, k, N] int32 on the host,
    record b in slots [0, L) of ciphertext b, under the benchmark's public
    key.  Past the pool's end further requests are encrypted inline, and
    the run says so."""

    CHUNK = 256  # keystream blocks a call (268 MB of round matrices)
    BFV_ROWS = 64  # records a call of the reference's encryption

    def __init__(self, h: "Harness", count: int, base: int):
        self.h, self.base, self.count, self.issued = h, base, count, 0
        self.records, self.uploads = self._make(0, count) if count else (None, None)

    def _make(self, first: int, count: int):
        h, cfg = self.h, self.h.config
        b, words, t = h.traffic["records_per_request"], cfg["input_words"], cfg["t"]
        blocks = -(-words // ref_pasta.T)
        recs, ups = [], []
        step = max(1, self.CHUNK // blocks)
        for s in range(first, first + count, step):
            n = min(step, first + count - s)
            x = torch.randint(0, cfg["record_high"], (n, b, words), generator=h.gen, device=h.device)
            if cfg["record_zero_share"]:
                keep = torch.rand((n, b, words), generator=h.gen, device=h.device) >= cfg["record_zero_share"]
                x = x * keep
            recs.append(x.to(torch.uint8).cpu().numpy())
            if h.upload == "bfv":
                ups += [self._encrypt(r) for r in x]
                continue
            ks = ref_pasta.keystream(h.pasta_key, [self.base + i for i in range(s, s + n)], blocks, t,
                                     h.device)
            ups.append(((x + ks[:, None, :words]) % t).cpu().numpy().astype(np.uint64))
        return np.concatenate(recs), ups if h.upload == "bfv" else np.concatenate(ups)

    def _encrypt(self, x: torch.Tensor) -> torch.Tensor:
        """One request's records [B, L] -> its BFV upload [2, B, k, N] int32 on
        the host, encrypted on the records' device BFV_ROWS at a time."""
        return torch.cat([self.h.encrypt_slots(x[r:r + self.BFV_ROWS]).cpu()
                          for r in range(0, x.shape[0], self.BFV_ROWS)], 1)

    def next(self):
        """(index, nonce, upload)."""
        i = self.issued
        self.issued += 1
        if i < self.count:
            return i, self.base + i, self.uploads[i]
        if i == self.count:
            log(f"the pool of {self.count} requests ran out: request {i} on are encrypted inline")
        rec, up = self._make(i, 1)
        self.records = np.concatenate([self.records, rec]) if self.records is not None else rec
        return i, self.base + i, up[0]


class Harness:
    """What a run shares with its entry: the cell, the seeds, the
    reference scheme and the benchmark's own keys and inputs."""

    def __init__(self, loaded: dict, seed: int, device):
        self.cell, self.config, self.traffic = loaded["cell"], loaded["config"], loaded["traffic"]
        self.seed = seed
        self.device = torch.device(device)
        self.rng = np.random.default_rng([seed, 0])
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        cfg = self.config
        self.scheme = ref_bfv.Scheme(cfg["n"], cfg["t"], cfg["data_limb_bits"], cfg["data_limbs"],
                                     self.device)
        self.s = self.scheme.secret_key(self.rng)
        self.s_dev = torch.as_tensor(self.s, dtype=torch.int64, device=self.device)
        self.pk = self.scheme.public_key(self.s_dev, self.gen)
        # what the configuration's users upload (README): "pasta" (the
        # default) or "bfv"
        self.upload = cfg.get("upload", "pasta")
        if self.upload not in ("pasta", "bfv"):
            raise ValueError(f"upload {self.upload!r}: 'pasta' or 'bfv'")
        if self.upload == "pasta":
            self.pasta_key = self.rng.integers(0, cfg["t"], ref_pasta.KEY_WORDS)

    def encrypt_slots(self, values: torch.Tensor) -> torch.Tensor:
        """Slot values [..., L] -> int32 ciphertexts [2, ..., k, N] under the
        benchmark's public key."""
        return self.scheme.encrypt(self.pk, self.scheme.slots.encode(values), self.gen)

    def program_stack(self, galois_elts):
        """The program's CSP stack: a Context at the configuration's
        parameters, evaluation keys made on the device from the benchmark's
        secret key (relinearisation, and the galois elements that
        ``galois_elts(ctx)`` names), and for PASTA uploads the transcipher
        (``tc`` None for BFV uploads)."""
        from hhe_tpu_torch.ops import bfv, transcipher
        from hhe_tpu_torch.workloads import hhe_inference as wk

        cfg = self.config
        ctx = bfv.Context(bfv.BFVParams(n=cfg["n"], t=cfg["t"], data_limb_bits=cfg["data_limb_bits"],
                                        data_limbs=cfg["data_limbs"], seed=self.seed), device=self.device)
        if tuple(ctx.q_moduli) != self.scheme.q or ctx.p_special != self.scheme.special:
            raise RuntimeError(f"the program's moduli {ctx.q_moduli} differ from the reference's {self.scheme.q}")
        sk = bfv.SecretKey(self.s, self.scheme.secret_residues(self.s))
        rk, gks = ctx.keygen_eval_keys_device(sk, sorted(set(galois_elts(ctx))), include_relin=True,
                                              seed=self.seed)
        tc = transcipher.Transcipher(ctx, rk, gks) if self.upload == "pasta" else None
        return wk.HHEStack(ctx, sk, None, rk, gks, tc)

    def encrypted_pasta_key(self):
        """The user's PASTA key under BFV: halves in slots [0, 128) and
        [N/2, N/2 + 128), the transcipher's packing."""
        from hhe_tpu_torch.ops.bfv import Ciphertext

        if self.upload != "pasta":
            raise ValueError(f"{self.config['name']} takes {self.upload} uploads: "
                             "its users hold no PASTA key")

        half, t = self.config["n"] // 2, ref_pasta.T
        v = torch.zeros(half + t, dtype=torch.int64, device=self.device)
        key = torch.as_tensor(self.pasta_key, device=self.device)
        v[:t], v[half:] = key[:t], key[t:]
        return Ciphertext(self.encrypt_slots(v))


class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def read_metrics(specs: List[dict], run: Run) -> Dict[str, dict]:
    out = {}
    for spec in specs:
        value = importlib.import_module(f"hhe_bench.metrics.{spec['name']}").read(run)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def to_host(x):
    """A tensor, or a list or tuple of them, copied to the host."""
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x.cpu()


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
        root: pathlib.Path = ROOT, config_overrides: Optional[dict] = None,
        traffic_overrides: Optional[dict] = None, patch=None) -> dict:
    """One run of cell ``workload``; returns the result line's object.

    The overrides and ``patch`` are for the tests and the control: other
    sizes, and a callable given the harness and the entry after set-up that
    may break the timed path underneath."""
    t_start = time.perf_counter() if t_start is None else t_start
    loaded = load_cell(workload, root)
    loaded["config"].update(config_overrides or {})
    loaded["traffic"].update(traffic_overrides or {})
    traffic = loaded["traffic"]
    h = Harness(loaded, seed, device)
    log(f"set-up: imports, the benchmark's keys {time.perf_counter() - t_start:.2f} s")
    entry = importlib.import_module(f"hhe_bench.entries.{h.config['entry']}").Entry(h)
    log(f"set-up: the program's stack, the encrypted weights {time.perf_counter() - t_start:.2f} s")
    if patch is not None:
        patch(h, entry)
    window = min(seconds, traffic["trace_seconds"]) if trace else seconds
    base = int(h.rng.integers(0, NONCE_SPACE))
    pool = Pool(h, max(1, math.ceil(traffic["pool_requests_per_s"] * window)), base + WARMUP)
    # the requests whose answers are checked, drawn from the seed before the
    # window among those a window completes (the pool holds four times and
    # more what the window completes at the rate measured)
    among = max(traffic["check_requests"], pool.count // CHECK_AMONG)
    picks = set(np.random.default_rng([seed, 1]).choice(among, traffic["check_requests"],
                                                        replace=False).tolist())
    cuda = h.device.type == "cuda"
    log(f"set-up: a pool of {pool.count} requests {time.perf_counter() - t_start:.2f} s")

    from hhe_tpu_torch.ops import mod_kernels, ntt_kernels

    def launches():
        return sum(ntt_kernels.LAUNCHES.values()) + sum(mod_kernels.LAUNCHES.values())

    def sync():
        if cuda:
            torch.cuda.synchronize(h.device)

    # the traced run records the calls per layout of the last warm-up request
    # (credited on graph replays) and scales them by the window's requests:
    # the recorder's wrappers are off in the window
    recorder = frozen.ShapeRecorder() if trace else None  # installed before the first capture
    for i in range(WARMUP):
        recording = recorder if trace and i == WARMUP - 1 else contextlib.nullcontext()
        launches_0 = launches()
        with recording:
            entry.request(base + i, pool.uploads[i % pool.count], contextlib.nullcontext, False)
            sync()
        warm_launches = launches() - launches_0
    setup_s = time.perf_counter() - t_start
    log(f"set-up: {WARMUP} warm-up requests {setup_s:.2f} s")

    span = torch.profiler.record_function if trace else (lambda name: contextlib.nullcontext())
    latencies, kept = [], []
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
    launches_0 = launches()
    paused = 0.0  # seconds of copying the picked answers to the host, not the window's
    with prof, span("window"):
        t0 = time.perf_counter()
        deadline = t0 + window
        while time.perf_counter() < deadline:
            t_issue = time.perf_counter()
            with span("fetch"):
                i, nonce, upload = pool.next()
            out = entry.request(nonce, upload, span, trace)  # ends synchronised
            t_done = time.perf_counter()
            latencies.append(t_done - t_issue)
            if i in picks:
                with span("check_copy"):
                    kept.append((i, *to_host(out)))
                copied = time.perf_counter() - t_done
                paused, deadline = paused + copied, deadline + copied
            del out  # the CSP holds no answer it has returned
        window_s = time.perf_counter() - t0 - paused
    requests = len(latencies)
    launched = launches() - launches_0
    memory_peak = torch.cuda.max_memory_allocated(h.device) if cuda else 0

    r = Run(cell=h.cell, config=h.config, traffic=traffic, root=root, requests=requests,
            records_per_request=traffic["records_per_request"], latencies=latencies,
            window_s=window_s, setup_s=setup_s, trace=None, launches=launched)
    if trace:
        from .trace import Trace

        r.trace = Trace(prof)
        if launched != warm_launches * requests:
            log(f"the window launched {launched} kernels over {requests} requests; "
                f"the recorded warm-up request {warm_launches}")
        ntt_ms, ntt_mults = recorder.totals(("ntt_fwd", "ntt_inv"))
        mod_ms, mod_mults = recorder.totals(("mont", "elem", "down"))
        r.ntt_bound_ms, r.modarith_bound_ms = ntt_ms * requests, mod_ms * requests
        log(f"int32 multiplies a request (ShapeRecorder, NTT and modular kernels): {ntt_mults + mod_mults}")
    metrics = read_metrics(loaded["per_layer"] if trace else loaded["end_to_end"], r)

    device = {"platform": "gpu" if cuda else h.device.type,
              "kind": torch.cuda.get_device_name(h.device) if cuda else h.device.type,
              "count": 1, "memory_peak_bytes": memory_peak}
    breakdown = None
    if r.trace is not None:
        device.update(busy_s=r.trace.busy_s, window_s=r.trace.window_s)
        breakdown = {"device_ops": r.trace.device_ops(), "idle_gaps": r.trace.idle_gaps()}

    # the program's state goes before the reference runs: its peak is read
    kept = [(i, pool.records[i], d, outs) for i, d, outs in kept]
    log(f"checked: {len(kept)} of the {len(picks)} requests picked among the first {among} "
        f"({requests} completed)")
    entry.release()
    del entry, pool, recorder, r, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare(h, kept)
    limits = h.config["limits"]
    result = {"correct": bool(kept) and all(numbers[k] <= limits[k] for k in limits),
              "attempted": requests, "failed": 0, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if cuda:
        result["card"] = card()
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    bad = forbidden_modules()  # last, after every import the run made
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {bad}")
    return result


def compare(h: Harness, kept) -> Dict[str, float]:
    """The numbers compared, over the sampled requests: records that do not
    decrypt to themselves, model outputs that do not decrypt to the
    reference model's, and the largest noise share of an output."""
    entry_mod = importlib.import_module(f"hhe_bench.entries.{h.config['entry']}")
    totals = {"records_wrong": 0, "outputs_wrong": 0, "noise_share": 0.0, "requests_checked": len(kept)}
    for _, x, d, outs in kept:
        got = entry_mod.compare(h, torch.as_tensor(x, device=h.device), d, outs)
        totals["records_wrong"] += got["records_wrong"]
        totals["outputs_wrong"] += got["outputs_wrong"]
        totals["noise_share"] = max(totals["noise_share"], got["noise_share"])
    return totals
