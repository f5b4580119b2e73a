"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--ecg-full-samples N]

Phases (any failure propagates and the exit code is nonzero):

0. device: the card's name and power limit, torch's CUDA version, nvcc, and
   whether ``grpc`` and ``google.protobuf`` import;
1. build: compile the kernels from ``hhe_tpu_torch/csrc`` (``ntt.cu``: the
   NTT, K1 and K2; ``modarith.cu``: the Montgomery product K3 and
   multiply-accumulate K4, the modular add / sub / neg / reduction K5 and
   the mod-down K6), one nvcc each, started together; a kernel instance
   that spills registers fails;
2. kernels: each NTT kernel against its plain PyTorch version
   (``torch.equal``) for 30-bit (lazy) and 31-bit (eager) moduli and t at
   every N = 2^5 ... 2^16 (each a kernel instance of its own; above 2^14 the
   row is cut into 64 KB parts and the top passes run too), with fewer 64 KB
   tiles than the card has SMs and with at least four tiles a block, and
   inv(fwd(x)) == x; K3 (eager and lazy) and K4 against theirs at the shapes
   and broadcast patterns of their sites at N = 16384 / 13 limbs and
   N = 65536 / 17 limbs, on operands holding 0, q - 1 and lazy [0, 2q)
   values, each K4 form (general, fanout, table, fanout_regs) launched,
   aligned and not (``check_mont_sites``); K5 (each op) and K6 against
   theirs at their sites' shapes, broadcast patterns and dtype mixes, on
   operands holding 0, q - 1 and (reduce) values near 2^31, aligned and not
   (``check_elem_sites``); K5's gather (signed and not, one index row and
   one a row), sum (of gathered, signed terms) and centred lift, and K6
   with addends (gathered, strided, one row's, into a caller's slice), at
   their sites' layouts on one ciphertext, a batch and a limb view's rows
   (``fused_sites``); every K5 mode and K6 form must launch;
3. ECG path (the main path): ``build_stack`` at the production BFV
   parameters (N=16384, 13 x 30-bit limbs, device keygen), then
   ``hhe_ecg_inference`` on B=64 samples twice: the first run calls each
   ``utils.graphs`` unit (expand, keystream, finish, the 1FC evaluation)
   for the first time, so it runs the unit's body and then captures it;
   the second, the keystream caches cleared, replays every unit.  Both
   runs' launch counts and calls per layout must be equal (replays
   credited), and so must their predictions; each unit must have replayed
   in the second.  Predictions must equal the plaintext model's, one
   decomposed sample must decrypt to its input with >= 40 bits of noise
   budget, and K1-K6 must have launched during the run.  Then the
   timings: decompose at B=64 with a fresh nonce per rep (PASTA
   encryption outside the timed region) through the entry point and
   through the units' bodies (equal bits), one keystream block through
   its body (``block_ms``) and replayed (``block_graph_ms``), the
   expansion replayed and through its body, the FC product through the
   entry point and its body, the batched decrypt; and one keystream block
   under ``torch.profiler`` (device busy time by kernel), replayed and
   through its body: a PyTorch gather, index, ``where`` or stack kernel
   left in the replayed block fails the run (``PYTORCH_PASSES``).  The graphs phase: each unit of the stack captured
   afresh in a pool of its own, its replay equal to its body on two
   inputs and the first replay's result unchanged by the second (the
   outputs are clones); capture, replay and eager ms, the kernels inside
   the graph and the pool's GiB (``check_unit``).  On the same stack:
   ``mod_switch_to_next`` of the decomposed sample from 13 limbs to one,
   decrypting right at every level, with ``cipher_size`` before and after;
   then the parallel path at world size 1 (a one-rank NCCL group): the
   four-step ``ShardedNtt`` at N = 1024, 4096, 16384 and 65536 (local
   transforms of M = 32 ... 256) equal to ``poly_mul_host``,
   ``keygen_public(mesh=)`` at the large preset cut to 3 limbs equal in
   bytes to the host path, ``csp_decompose(mesh=)`` on this stack equal to
   the unsplit result, and the native PASTA expansion (which every phase
   must have used) against the pure-Python one, ms each;
   then the limb path at world size 1 (a one-rank NCCL group, the
   ("batch": 1, "limb": 1) mesh): the ``LimbView`` of the ECG stack must be
   split (its 13 limbs in one block), and the keystream of one block on the
   key placed by ``shard_limbs``, ``csp_decompose(mesh=)`` of B=64 samples
   and ``csp_eval_1fc(mesh=)`` without and with the log-depth sum, gathered
   by ``gather_limbs`` / ``gather_batch``, must each equal the unsplit path
   bit for bit, the predictions the plaintext model's and the sums x @ w
   mod t; keystream and FC times split and unsplit, the all-gathers of a
   block and the key bytes each rank holds;
   then the full-dataset ECG run, ``hhe_ecg_full_inference`` (surrogate
   ecg_512 weights and a 13,245-row label file written to temporary CSVs,
   chunks of 512, products in slices of 64), over ``--ecg-full-samples``
   samples (default ECG_FULL_CAP; 0 for all 13,245), agreement 1.0;
4. 1FC path: ``hhe_1fc_inference`` (SpO2: 300 words, three blocks, mask,
   flatten, ct x ct, log-depth vec-sum) on B=64 samples at N=16384 with
   FC_LIMBS limbs, its hard parity check, the noise budgets after
   decompose+flatten and after FC+sum, the experiment report;
   4b. the parties in this process over gRPC on localhost: a port ``CSP``
   at N=16384 / 13 limbs and two ``Analyst``s (L=300 and L=128, host
   keygen, weights in [-3, 3]) that encrypt their models and publish their
   keys (~1.27 GB each) to it; a ``User`` submits B=64 records to each,
   the CSP decomposes them on arrival and checkpoints them, and
   ``evaluateModelFromFile`` (then, for L=300, ``evaluateModel`` with the
   checkpoint split across repeated ``HHEDecomp`` entries) returns results
   that must decrypt to x @ w exactly, with predictions (x @ w > 0); the
   three secret keys must differ and K1-K6 must launch; per-party ms
   and per-edge MB, the decompose wall, evaluation ms a ciphertext (the
   CSP's unit replayed) and through the unit's body, the key set's
   publish time, one result's noise budget, peak memory; the CSP's unit
   (``csp_eval_1fc`` with the sum) through ``check_unit``;
   4c. the CLI: ``python -m hhe_tpu_torch.parties.cli`` csp, analyst and
   user as three processes on the card at the CLI's defaults (N=16384, 13
   limbs, --input-len 300, --rows 2) with surrogate CSVs; the analyst's
   printed predictions must equal the plain model's, and both servers must
   exit 0 on SIGINT;
   FashionMNIST: ``hhe_fmnist_1fc_inference`` (784 -> 10 + bias, seven
   blocks, the C class rows in one batched pass) on B=4 at FMNIST_LIMBS
   limbs, its hard mod-t parity, the report and the stage budgets;
   MNIST 2FC: ``hhe_2fc_inference`` (784 -> 128 -> square -> 10) on B=4 at
   MNIST_LIMBS limbs, MNIST_ROW_CHUNK rows a pass, its hard mod-t parity;
   an untimed warm-up with the stage budgets, then the timed run:
   inferences/s, the transcipher's and the 2FC pass's time, peak memory
   with the units' graphs alive and their pool; the transcipher units at
   B=4 through ``check_unit``;
   HCNN: ``he_mnist_conv_inference`` (conv 1->5 -> square -> conv 5->50 ->
   square -> fc 800->10, the reference's pure-HE speed test) at N=16384 /
   HCNN_LIMBS limbs and the 47-bit t on surrogate MNIST idx files: QAT on
   the card, device keygen, the plaintexts, HCNN_IMAGES encrypted images;
   the encrypted logits must equal the integer model's with noise budget
   left; the Galois key count, the QAT, keygen and plaintext seconds, per
   image the encryption, device evaluation and decrypt/decode seconds, the
   budget after each stage, peak memory;
   training: integer DFA training at the reference's full widths on
   numpy-seeded surrogates, ``train_mnist_dfa`` 784-100-50-10 (DFA_TRAIN
   images, one epoch), ``train_spo2_square`` 300-128-1 and
   ``train_spo2_one_layer`` 300-1 (SPO2_TRAIN rows, SPO2_EPOCHS epochs),
   each equal to a CPU run of the same call bit for bit (history, final and
   epoch-best parameters, checkpoint bytes), and ``int32_matmul`` on
   wrapping int32 operands at the DFA step's shapes equal to the int64
   product; ms a step and a product;
   accuracy parity: ``accuracy_parity_report`` from a temporary reference
   tree of surrogates (PARITY_PATIENTS SIESTA-layout recordings, the SpO2
   1FC and MNIST 2FC weight CSVs, PARITY_IMAGES MNIST t10k images): the
   float SpO2 and MNIST baselines, both integer accuracies, and
   PARITY_SAMPLES encrypted SpO2 samples at N=1024 / 13 limbs whose parity
   check must hold; the float SpO2 weights within FLOAT_SPO2_TOL of a CPU
   run, with the same predictions; the seconds of each part;
5. large preset (a): the 58-limb N=65536 chain: encrypt, decrypt, device
   galois key, rotate_rows(-1), each with > 1000 bits of budget, and the
   tile kernels and the top passes launched; then ``default_context(32768)``
   (26 limbs) and one rotation at N=32768;
6. large preset (b): one 3-round keystream block at N=65536 with
   LARGE_KS_LIMBS limbs, decrypting to the plain PASTA keystream, its
   budget after each round, its time and its profile;
7. kernels at the paths' shapes: every shape each path of phases 3-6 gave
   each NTT kernel, and every operand layout the ECG path, the MONT_TOP
   most-called layouts and every base conversion each other path gave K3
   and K4, and every ECG layout and the MONT_TOP most-called of each other
   path K5 and K6 were given, on random residues,
   against the plain version (``torch.equal``; above N = 16384 each NTT
   launch alone too), timed per call from Python (``ms``) and on the device
   alone (``device_ms``, a CUDA graph of launches) on one operand, and again
   cycling through copies that miss the L2 (``ms_cold``,
   ``device_ms_cold``), each beside its bound and (K3, K4) the plain
   version's ms; each K4 layout with the form it took and, for a fan-out
   form, the general form's cold device time on the same copies; each K5
   reduction beside one ``torch.remainder`` call and each unsigned gather
   beside one ``torch.index_select`` / ``torch.gather`` call (the library
   time, per call and on the device alone), the index and mask bytes in
   K5's and K6's bounds;
8. one JSON line of every phase's numbers, the card's line, one JSON line
   with every kernel's launches per path, error, time, plain time and bound,
   per shape and summed per path, then the device line last.

Each path's launch counts are set to 0 just before it and read just after;
every path of phases 3-6 must launch K1-K6 (the top passes where N > 16384),
K5's gather, and K6 with addends only (``check_fused_modes``).
A unit's replay adds to them (and to ``ShapeRecorder``'s calls per layout)
what its capture counted, so they are an eager run's counts; each path of
``PATH_UNITS`` must replay its units (``graphs.REPLAYS``).
Imports only ``hhe_tpu_torch``, ``hhe_bench.frozen`` (the roofline
arithmetic the benchmark froze), ``torch``, ``numpy`` and the standard
library.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import importlib
import io
import itertools
import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np

from hhe_bench.frozen import (HBM_BYTES_PER_S, bound, elem_args, kernel_family, launch_bound,
                               mont_bound, words_bytes)

L2_BYTES = 50 * 2**20  # H100 L2 cache

B = 64  # samples per decompose, the JAX package's headline batch
REPS = 3
FC_L = 300  # SpO2 words per sample
FC_LIMBS = 13  # the 1FC path's data limbs at N=16384
# the large preset's keystream block: the fewest data limbs whose last round
# keeps >= 20 bits of noise budget (tools/torch_keystream_budgets.py)
LARGE_KS_LIMBS = 17
MITBIH_TEST_ROWS = 13245  # the reference's ECG test set
ECG_FULL_BATCH = 512  # samples per decompose in the full ECG run
# samples the full ECG run takes by default (--ecg-full-samples); 2048 keeps the
# script near 10 minutes with the parties' phases
ECG_FULL_CAP = 2048
FMNIST_LIMBS = 13  # the production chain holds the FashionMNIST FC
MNIST_B = 4  # images per 2FC batch, the JAX package's
MNIST_LIMBS = 16  # the 2FC path's chain: fc1, rotate-reduce and square need ~70 bits
# hidden rows per 2FC pass; the phase also records the peak memory at twice
# as many
MNIST_ROW_CHUNK = 32
# the encrypted HCNN (he_mnist_conv_inference): the JAX package's own
# parameters, N=16384 with 13 limbs and the 47-bit conv_plain_t; surrogate
# MNIST idx files of HCNN_TRAIN + 200 images
HCNN_LIMBS = 13
HCNN_IMAGES = 2
HCNN_TRAIN = 3000
HCNN_EPOCHS = 2
# integer DFA training: MNIST-shaped images (784 pixels 0-255, labels 0-9)
# for train_mnist_dfa at 784-100-50-10, one epoch of mini-batch 20; SIESTA-
# shaped rows (300 values 0-31) for the two SpO2 trainers, two epochs of 4
DFA_TRAIN, DFA_TEST = 10_000, 2_000
SPO2_TRAIN, SPO2_TEST, SPO2_EPOCHS = 2_000, 500, 2
# the accuracy report's surrogate reference tree: SIESTA-layout recordings
# (patients x rows of 300), MNIST t10k idx files (the float MNIST split keeps
# the last 2,000 for test); two encrypted samples at N=1024 / 13 limbs
PARITY_PATIENTS, PARITY_ROWS, PARITY_IMAGES, PARITY_SAMPLES = 40, 50, 10_000, 2
# the float SpO2 weights on the card against a CPU run: cuBLAS adds in
# another order than the CPU (2.4e-7 apart after 400 steps on an H100)
FLOAT_SPO2_TOL = 1e-5
# the parties' localhost ports, away from the tests' (50951-50982)
PARTY_CSP = "localhost:50591"
PARTY_ANALYSTS = ((FC_L, 32, "localhost:50592"), (128, 16, "localhost:50593"))  # L, x < hi
CLI_ANALYST, CLI_CSP = "localhost:50594", "localhost:50595"
PARTY_WAIT_S = 600  # the longest one party step may take
EVAL_EAGER_CTS = 8  # ciphertexts of a checkpoint the CSP's unit body is timed on


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


def timed(fn):
    """(fn(), its wall seconds), the device synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def wall_s(fn) -> float:
    return timed(fn)[1]


# the kernels every path of phases 3-6 must launch: K1, K2 (the NTT), K3 and
# K4 (the Montgomery product and multiply-accumulate), K5 (the modular add /
# sub / neg / reduction; every HE path) and K6 (the mod-down of every
# key-switch; each of these paths has one)
PATH_KERNELS = ("ntt_fwd", "ntt_inv", "mont_mul", "mont_mac", "mod_elem", "mod_down")
# and, on rows longer than 16384 words, the NTT's top passes
TOP_KERNELS = ("ntt_fwd_top", "ntt_inv_top")


def reset_launches():
    from hhe_tpu_torch.ops import mod_kernels, ntt_kernels
    from hhe_tpu_torch.utils import graphs

    ntt_kernels.reset_launches()
    mod_kernels.reset_launches()
    graphs.reset_counts()


# the units (utils.graphs names) each path must replay: those it calls
# again at a layout it has captured.  Other paths, and units a path calls
# once at a layout (the L=128 analyst's expand and keystream among the
# parties, each stack's first keystream block in the large preset), are
# reported with their replays and captures but not held to them.
PATH_UNITS = {
    "ecg": ("expand", "keystream", "finish", "eval_1fc"),
    "ecg_full": ("expand", "keystream", "finish", "eval_1fc"),
    "1fc": ("keystream_seeded", "finish", "eval_1fc"),
    "parties": ("keystream_seeded", "finish", "eval_1fc"),
    "fmnist_1fc": ("keystream_seeded", "finish"),
    "mnist_2fc": ("keystream_seeded", "finish"),
}


def graph_counts(path: str) -> dict:
    """The units' replays and captures since ``reset_launches``; raises
    where a unit of ``PATH_UNITS[path]`` did not replay."""
    from hhe_tpu_torch.utils import graphs

    out = {"replays": dict(graphs.REPLAYS), "captures": dict(graphs.CAPTURES)}
    missing = [u for u in PATH_UNITS.get(path, ()) if not graphs.REPLAYS[u]]
    if missing:
        raise AssertionError(f"{path}: units {missing} did not replay: {out}")
    return out


def launch_counts() -> dict:
    from hhe_tpu_torch.ops import mod_kernels, ntt_kernels

    return {**ntt_kernels.LAUNCHES, **mod_kernels.LAUNCHES,
            **{f"mont_mac_{form}": n for form, n in mod_kernels.FORM_LAUNCHES.items()},
            **{f"mod_elem_{op}": n for op, n in mod_kernels.OP_LAUNCHES.items()},
            **{f"mod_down_{form}": n for form, n in mod_kernels.DOWN_LAUNCHES.items()}}


def check_fused_modes(launches: dict):
    """Every path rotates and key-switches: each must have read a galois
    permutation through K5's gather and added after its key-switches in K6
    (a mod-down with addends), and none may have launched K6 bare."""
    bad = {path: {k: v for k, v in per.items() if k.startswith(("mod_elem_gather", "mod_down_"))}
           for path, per in launches.items()
           if not per.get("mod_elem_gather") or per.get("mod_down_bare")
           or not per.get("mod_down_one_addend", 0) + per.get("mod_down_two_addends", 0)}
    if bad:
        raise AssertionError(f"paths that missed K5's gather or K6's addends: {bad}")


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
    # the parties' wire (phases 4b and 4c) needs these on the card's machine
    for mod in ("grpc", "google.protobuf"):
        try:
            log(f"{mod} {importlib.import_module(mod).__version__}")
        except ImportError as e:
            log(f"{mod} not importable: {e}")
    return smi


def phase_build():
    """Compile the kernels, ``csrc/ntt.cu`` (K1, K2) and ``csrc/modarith.cu``
    (K3, K4) with one nvcc each, started together, and show ptxas' registers
    and spills per kernel; a kernel that spills fails the build phase."""
    import threading

    from hhe_tpu_torch.ops import mod_kernels, ntt_kernels

    t0 = time.perf_counter()
    failed = []

    def build(mod):
        try:
            mod.build()
        except Exception as e:  # raised below, on the main thread
            failed.append(e)

    threads = [threading.Thread(target=build, args=(mod,)) for mod in (ntt_kernels, mod_kernels)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if failed:
        raise failed[0]
    ntt_kernels._library()
    mod_kernels._library()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    spills = []
    for mod in (ntt_kernels, mod_kernels):
        nvcc_s = mod.BUILD_LOG.get("seconds")
        log(f"  {mod.BUILD_LOG['library']} "
            + (f"(nvcc {nvcc_s:.2f} s)" if nvcc_s is not None else "(already built)"))
        report = ntt_kernels.ptxas_report(mod.BUILD_LOG.get("compiler_output", ""))
        for name, info in report.items():
            log(f"  ptxas: {name}: {info['registers']}")
        spills += [name for name, info in report.items() if info["spill_bytes"]]
        if mod is mod_kernels and mod.BUILD_LOG.get("compiler_output") is not None:
            for kernel in ("mont_kernel", "mont_fan_kernel", "mod_elem_kernel", "mod_fused_kernel",
                           "mod_down_kernel"):
                if not any(kernel in name for name in report):
                    raise AssertionError(f"ptxas reported no {kernel} instance")
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    log("  ptxas: no kernel spills")


def phase_kernels():
    """Kernel == plain version, bit for bit, at every N the wrapper takes,
    for lazy, eager and t moduli, with fewer tiles than SMs and with at least
    four tiles for every block (so each block reuses its tile buffers).
    Above N = 16384 a row is N / 16384 tiles and the top passes run too."""
    import torch

    from hhe_tpu_torch.ops import bfv, ntt, ntt_kernels, primes

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ntt_kernels.reset_launches()
    for logn in range(5, 17):
        n = 1 << logn
        t = 65537 if n <= 32768 else bfv.large_params().t  # t - 1 must divide 2N
        for bits, k in ((30, 13), (30, 14), (31, 15), (17, 1)):
            mods = (t,) if bits == 17 else primes.ntt_primes(n, bits, k)
            tb = ntt.build_tables(mods, n, dev)
            gen = torch.Generator(device=dev).manual_seed(n * 100 + bits)
            small = (2, 3) if n <= ntt.TILE else (1,)  # fewer tiles than SMs
            for lead in (small, (-(-(4 * sms + 3) * ntt.TILE // (n * k)),)):
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
                    f"tiles={-(-rows * n // ntt.TILE)} lazy={tb.lazy}: "
                    f"{'equal' if ok else 'DIFFER'}")
                if not ok:
                    raise AssertionError(
                        f"NTT kernel differs from plain version at n={n} bits={bits} rows={rows}")
    log(f"kernels: launches {ntt_kernels.LAUNCHES}")
    if min(ntt_kernels.LAUNCHES.values()) == 0:
        raise AssertionError(f"a kernel did not launch in the kernel phase: {ntt_kernels.LAUNCHES}")
    check_mont_sites()
    check_elem_sites()


# (N, data limbs) of phase 2's K3 / K4 checks: the production chain and the
# large preset's keystream chain
MONT_CHECKS = ((16384, 13), (65536, LARGE_KS_LIMBS))
# the plain Montgomery versions run over leading slices of at most this many
# products (their int64 temporaries take ~50 bytes a product)
PLAIN_SLICE_WORDS = 1 << 27


def mont_residues(shape, q, gen, top=1):
    """int32 residues below top * q (q broadcasts against `shape`), with 0
    and top * q - 1 planted."""
    import torch

    lim = (q.to(torch.int64) * top).expand(shape).reshape(-1)
    v = torch.randint(0, 1 << 62, lim.shape, generator=gen, device=q.device) % lim
    v[::7] = 0
    v[3::11] = lim[3::11] - 1
    return v.reshape(shape).to(torch.int32)


def mont_columns(mods, dev, nd=2):
    """q and qinv_neg of `mods` as int64 columns [k, 1, ...] of `nd` dimensions."""
    import torch

    from hhe_tpu_torch.ops import modular

    shape = (len(mods),) + (1,) * (nd - 1)
    qi = [int(modular.mont_constants(m)[0]) for m in mods]
    return (torch.tensor([int(m) for m in mods], dtype=torch.int64, device=dev).reshape(shape),
            torch.tensor(qi, dtype=torch.int64, device=dev).reshape(shape))


def mont_call(name, a, b, q, qi, dim):
    """K3 / K4 through ``modular`` (CUDA tensors: the kernels); `name` is a
    wrapper's: ``mont_mul``, ``mont_mul_lazy`` or ``mont_mac``."""
    from hhe_tpu_torch.ops import modular

    if name == "mont_mac":
        return modular.mont_mac(a, b, q, qi, dim)
    return getattr(modular, name)(a, b, q, qi)


def mont_plain(name, a, b, q, qi, dim):
    """The plain version of `name`, in slices where the products are many
    (``sliced``)."""
    import torch

    from hhe_tpu_torch.ops import modular

    fn = {"mont_mul": modular.mont_mul_plain, "mont_mul_lazy": modular.mont_mul_lazy_plain,
          "mont_mac": lambda *x: modular.mont_mac_plain(*x, dim)}[name]
    ops = (a, b, q, qi)
    full = tuple(torch.broadcast_shapes(*(x.shape for x in ops if isinstance(x, torch.Tensor))))
    return sliced(fn, ops, full, None if dim is None else dim % len(full))


def check_mont_sites():
    """Phase 2's K3 / K4 checks, at N = 16384 / 13 limbs and N = 65536 /
    LARGE_KS_LIMBS limbs (30-bit q and P, 31-bit Bsk moduli): each kernel
    against its plain version (``torch.equal``) at the shapes and broadcast
    patterns of its sites -- K4 at the key-switch products against one key
    and against the k0/k1 pair (``hoisted_ks_products``: a batch, one
    ciphertext, a ``keyswitch`` digit chunk against a row slice of the
    key), the BSGS key contraction (digits as a transposed view, one key
    and the pair), the giantsteps' contraction, the BSGS plaintext sums (one
    over a [:, 1:] view, against H0/H1 as a transposed view) and
    the base conversions (``fbc_from_digits`` q -> Bsk, B -> q ∪ {m_sk});
    K3, eager and lazy, at ``mod_down``'s and ``multiply_plain``'s shapes on
    lazy inputs in [0, 2q) and with a Python-int b (``from_mont``); K3 and
    each K4 form again on rows that are not 16-byte aligned (the kernel's
    word path; the others take its vector path).  Each K4 form (general,
    fanout, table) must launch.  Every operand holds 0 and its bound - 1."""
    import torch

    from hhe_tpu_torch.ops import mod_kernels, primes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    mod_kernels.reset_launches()
    for n, k in MONT_CHECKS:
        kd, kp = k, k + 1
        qp_mods = primes.ntt_primes(n, 30, kp)
        q, qi = mont_columns(qp_mods[:k], dev)
        qp, qpi = mont_columns(qp_mods, dev)
        bsk, bski = mont_columns(primes.ntt_primes(n, 31, k + 2), dev)

        def r(shape, qq, top=1):
            return mont_residues(shape, qq, gen, top)

        key, pair = r((kd, kp, n), qp), r((2, kd, kp, n), qp)
        batch = 64 if n <= 16384 else 4
        lazy_in, wide_in = r((2, k, n), q, 2), r((2, batch, k, n), q, 2)
        col, plain_pt = r((k, 1), q), r((k, n), q)
        q_msk, q_mski = mont_columns(primes.ntt_primes(n, 30, k) + primes.ntt_primes(n, 31, 1), dev)
        sites = {  # name: (wrapper, a, b, q, qinv_neg, dim)
            "mod_down": ("mont_mul", lazy_in, col, q, qi, None),
            "mod_down lazy": ("mont_mul_lazy", lazy_in, col, q, qi, None),
            "multiply_plain": ("mont_mul", wide_in, plain_pt, q, qi, None),
            "multiply_plain lazy": ("mont_mul_lazy", wide_in, plain_pt, q, qi, None),
            "from_mont": ("mont_mul", lazy_in, 1, q, qi, None),
            "hoisted_ks_products": ("mont_mac", r((2, kd, kp, n), qp), key, qp, qpi, -3),
            # one key against one ciphertext has no fan-out: the general form
            "one ciphertext, one key": ("mont_mac", r((kd, kp, n), qp), key, qp, qpi, -3),
            "hoisted_ks_products, k0/k1": ("mont_mac", r((batch, kd, kp, n), qp), pair[:, None],
                                           qp, qpi, -3),
            "hoisted_ks_products, one ciphertext": ("mont_mac", r((kd, kp, n), qp), pair, qp, qpi, -3),
            "keyswitch digit_chunk": ("mont_mac", r((4, 4, kp, n), qp), key[4:8], qp, qpi, -3),
            "keyswitch digit_chunk, k0/k1": ("mont_mac", r((4, 4, kp, n), qp), pair[:, None, 4:8],
                                             qp, qpi, -3),
            "bsgs key contraction": ("mont_mac", key.transpose(-3, -2),
                                     r((31, kp, kd, n), qp[:, None]), qp[:, None], qpi[:, None], -2),
            "bsgs key contraction, k0/k1": ("mont_mac", key.transpose(-3, -2),
                                            r((2, 31, kp, kd, n), qp[:, None]), qp[:, None],
                                            qpi[:, None], -2),
            "bsgs giantstep contraction, k0/k1": ("mont_mac", r((3, kd, kp, n), qp).transpose(-3, -2),
                                                  r((2, 3, kp, kd, n), qp[:, None]), qp[:, None],
                                                  qpi[:, None], -2),
            "bsgs q sum": ("mont_mac", r((1, 32, k, n), q), r((4, 32, k, n), q), q, qi, 1),
            "bsgs qp sum": ("mont_mac", r((1, 31, kp, n), qp), r((4, 32, kp, n), qp)[:, 1:],
                            qp, qpi, 1),
            "bsgs qp sum, H0/H1": ("mont_mac", r((31, 2, kp, n), qp).transpose(0, 1)[:, None],
                                   r((4, 32, kp, n), qp)[:, 1:], qp, qpi, 2),
            "fbc_from_digits q -> Bsk": ("mont_mac", r((3, k, n), q)[..., None, :],
                                         r((k, k + 2), bsk.reshape(1, -1)).long()[:, :, None],
                                         bsk, bski, -3),
            "fbc_from_digits B -> q + m_sk": ("mont_mac", r((3, k + 1, n), bsk[: k + 1])[..., None, :],
                                              r((k + 1, k + 1), q_msk.reshape(1, -1)).long()[:, :, None],
                                              q_msk, q_mski, -3),
            # rows that start off the 16-byte grid take the kernel's word path
            "mod_down, unaligned": ("mont_mul", r((2, k, n + 1), q, 2)[..., 1:], col, q, qi, None),
            "hoisted_ks_products, unaligned": ("mont_mac", r((2, kd, kp, n + 1), qp)[..., 1:],
                                               key, qp, qpi, -3),
            "one ciphertext, one key, unaligned": ("mont_mac", r((kd, kp, n + 1), qp)[..., 1:],
                                                   key, qp, qpi, -3),
            "hoisted_ks_products, k0/k1, unaligned": ("mont_mac", r((2, kd, kp, n + 1), qp)[..., 1:],
                                                      pair[:, None], qp, qpi, -3),
            "bsgs key contraction, unaligned": ("mont_mac", key.transpose(-3, -2),
                                                r((31, kp, kd, n + 1), qp[:, None])[..., 1:],
                                                qp[:, None], qpi[:, None], -2),
            "fbc_from_digits, unaligned": ("mont_mac", r((3, k, n + 1), q)[..., None, 1:],
                                           r((k, k + 2), bsk.reshape(1, -1)).long()[:, :, None],
                                           bsk, bski, -3),
        }
        for site, (name, a, b, qq, qqi, dim) in sites.items():
            form = "" if dim is None else " " + mod_kernels.plan(a, b, qq, qqi, dim).form
            got = mont_call(name, a, b, qq, qqi, dim)
            want = mont_plain(name, a, b, qq, qqi, dim)
            ok = torch.equal(got, want)
            log(f"kernels {name}{form} n={n} k={k} {site} {list(got.shape)}: {'equal' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"{name} differs from its plain version at {site}, n={n}")
            del got, want
        del sites, key, pair, lazy_in, wide_in
    counts = {k: mod_kernels.LAUNCHES[k] for k in ("mont_mul", "mont_mac")}
    log(f"kernels: launches {counts}, K4 by form {mod_kernels.FORM_LAUNCHES}")
    if min(counts.values()) == 0 or min(mod_kernels.FORM_LAUNCHES.values()) == 0:
        raise AssertionError(f"a kernel or form did not launch in the kernel phase: "
                             f"{counts} {mod_kernels.FORM_LAUNCHES}")


def sliced(fn, ops, full, red=None):
    """fn(*ops) over slices of the first axis of the broadcast shape `full`
    (the reduced axis `red` aside) longer than one, when the words are many
    (the plain versions' int64 temporaries take ~50 bytes a word); each
    output word depends on its own operands only, so the slices concatenate
    to the whole."""
    import torch

    nd, words = len(full), int(np.prod(full))
    axes = [d for d in range(nd - 1) if d != red and full[d] > 1]
    if words <= PLAIN_SLICE_WORDS or not axes:
        return fn(*ops)
    d = axes[0]
    step = max(1, full[d] * PLAIN_SLICE_WORDS // words)

    def cut(x, i):
        if not isinstance(x, torch.Tensor) or x.ndim < nd - d or x.shape[d - nd] == 1:
            return x
        return x.narrow(d - nd, i, min(step, full[d] - i))

    out_axis = d if red is None or d < red else d - 1
    return torch.cat([sliced(fn, [cut(x, i) for x in ops],
                             full[:d] + (min(step, full[d] - i),) + full[d + 1:], red)
                      for i in range(0, full[d], step)], dim=out_axis)


def elem_plain(op, a, b, q):
    """K5's plain version: ``add_mod_plain`` / ``sub_mod_plain`` /
    ``neg_mod_plain`` / ``reduce_u32_plain``, in slices where large."""
    import torch

    from hhe_tpu_torch.ops import modular, rns

    fn = {"add": modular.add_mod_plain, "sub": modular.sub_mod_plain,
          "neg": lambda a, b, q: modular.neg_mod_plain(a, q),
          "reduce": lambda a, b, q: rns.reduce_u32_plain(a, q)}[op]
    ops = [a, b, q]
    full = tuple(torch.broadcast_shapes(*(x.shape for x in ops if isinstance(x, torch.Tensor))))
    return sliced(fn, ops, full)


def elem_call(op, a, b, q):
    """K5 through the dispatching functions (CUDA tensors: the kernel)."""
    from hhe_tpu_torch.ops import modular, rns

    if op == "neg":
        return modular.neg_mod(a, q)
    if op == "reduce":
        return rns.reduce_u32(a, q)
    return {"add": modular.add_mod, "sub": modular.sub_mod}[op](a, b, q)


def down_plain(c, *consts, adds=()):
    """K6's plain version, ``bfv_eval.mod_down_plain``, on the wrapper's
    constants (q, qinv_neg, P mod q, Mont(P^-1), p_half) and addends, in
    slices where large and without addends."""
    from hhe_tpu_torch.ops import bfv_eval

    if adds:
        return bfv_eval.mod_down_plain(c, *consts, adds=adds)
    return sliced(lambda cc: bfv_eval.mod_down_plain(cc, *consts), [c],
                  tuple(c.shape[:-2]) + (1, c.shape[-1]))


def check_elem_sites():
    """Phase 2's K5 / K6 checks, on the production context (N = 16384, 13
    limbs) and the large preset's keystream context (N = 65536,
    LARGE_KS_LIMBS limbs): K5 (each op) against its plain version
    (``torch.equal``) at the shapes, broadcast patterns and dtype mixes of
    its sites -- the digit decomposition of a batch, of one ciphertext and
    of a digit chunk (one limb to every modulus of q and P), the round
    material's lift mod t to q and P, the reduction of values near 2^31,
    ciphertext adds and subtracts (a batch, a plaintext, the finish's int64
    fix, a broadcast first operand, over q and P, a 2FC tree's narrowed
    halves, ``_bsk_to_q``'s view of y and its one-modulus subtract), negs
    (a ciphertext, the giantsteps' rows view); K6 at a batch's key-switch
    (k0/k1 stacked), one ciphertext's, a BSGS sum's, an int64 c and a
    limb view's rows of the constants; each again on rows that are not
    16-byte aligned (the word path).  Operands hold 0 and q - 1.  Every op
    and both kernels must launch."""
    import torch

    from hhe_tpu_torch.ops import bfv, bfv_eval, mod_kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    mod_kernels.reset_launches()
    for params in (bfv.BFVParams(n=16384, data_limbs=13, seed=1),
                   bfv.large_params(data_limbs=LARGE_KS_LIMBS, seed=1)):
        ctx = bfv.Context(params)
        n, k = ctx.n, ctx.k
        ec = bfv_eval.eval_consts(ctx)
        q, qp, bq = ctx.tb_q.q, ctx.tb_qp.q, ctx.tb_bsk.q
        msk = ec.fbc_b_to_q_msk.c_q[-1:]
        t = torch.tensor([[ctx.t]], dtype=torch.int64, device=dev)
        batch = 64 if n <= 16384 else 4

        def r(shape, qq, top=1):
            return mont_residues(shape, qq, gen, top)

        def near_2_31(shape):
            v = torch.randint((1 << 31) - (1 << 24), 1 << 31, shape, generator=gen, device=dev)
            v.view(-1)[::5] = (1 << 31) - 1
            return v.to(torch.int32)

        poly = r((batch, k, n), q)
        y = r((2, batch, k + 1, n), qp)
        tree = r((2, 4, 4, k, n), q)
        sites = {  # name: (op, a, b, q)
            "digits, batch": ("reduce", poly[..., None, :], 0, qp),
            "digits, one ciphertext": ("reduce", poly[0, :, None, :], 0, qp),
            "digits, a digit chunk": ("reduce", poly[..., 4:8, None, :], 0, qp),
            "lift mod t": ("reduce", r((4, 128, 1, n), t), 0, qp),
            "reduce near 2^31": ("reduce", near_2_31((2, k, 1, n)), 0, q),
            "reduce m_sk alpha": ("reduce", r((2, batch, 1, n), msk), 0, q),
            "add ciphertexts": ("add", r((2, batch, k, n), q), r((2, batch, k, n), q), q),
            "add a plaintext": ("add", r((batch, k, n), q), r((k, n), q), q),
            "add the finish's int64 fix": ("add", r((batch, k, n), q),
                                           r((batch, 1, n), q[:1]).long() % (1 << 19), q),
            "add a broadcast first operand": ("add", r((1, k, n), q), r((batch, k, n), q), q),
            "add over q and P": ("add", y, r((2, batch, k + 1, n), qp), qp),
            "add a tree's halves": ("add", tree.narrow(2, 0, 2), tree.narrow(2, 2, 2), q),
            "add int64 a": ("add", r((2, k, n), q).long(), r((2, k, n), q), q),
            "sub a view of y": ("sub", y[..., :-1, :], r((2, batch, k, n), q), q),
            "sub one modulus": ("sub", r((2, batch, 1, n), msk), r((2, batch, 1, n), msk), msk),
            "sub over Bsk": ("sub", r((2, batch, len(bq), n), bq), r((2, batch, len(bq), n), bq), bq),
            "neg a ciphertext": ("neg", r((2, k, n), q), 0, q),
            "neg the giantsteps' rows": ("neg", r((4, k, n), q)[1:], 0, q),
            "add, unaligned": ("add", r((2, k, n + 1), q)[..., 1:], r((k, n), q), q),
            "sub, unaligned": ("sub", r((2, k, n + 1), q)[..., 1:], r((2, k, n + 1), q)[..., 1:], q),
            "neg, unaligned": ("neg", r((2, k, n + 1), q)[..., 1:], 0, q),
            "digits, unaligned": ("reduce", r((2, k, n + 1), q)[..., None, 1:], 0, qp),
        }
        for site, (op, a, b, qq) in sites.items():
            got = elem_call(op, a, b, qq)
            want = elem_plain(op, a, b, qq)
            ok = torch.equal(got, want)
            log(f"kernels mod_elem {op} n={n} k={k} {site} {list(got.shape)} {got.dtype}: "
                f"{'equal' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"mod_elem differs from its plain version at {site}, n={n}")
            del got, want
        cols = (ec.q, ec.qi, ec.p_mod_q, ec.p_inv_mont)
        c_pair = r((2, batch, k + 1, n), qp)
        downs = {  # name: (c, the four columns)
            "a batch's key-switch, k0/k1": (c_pair, cols),
            "one ciphertext's key-switch": (r((2, k + 1, n), qp), cols),
            "a BSGS sum": (r((k + 1, n), qp), cols),
            "int64 c": (r((2, k + 1, n), qp).long(), cols),
            "a limb view's rows": (torch.cat([c_pair[:, :, 4:8], c_pair[:, :, -1:]], 2),
                                   tuple(x[4:8] for x in cols)),
            "unaligned": (r((2, k + 1, n + 1), qp)[..., 1:], cols),
        }
        for site, (c, cc) in downs.items():
            got = mod_kernels.mod_down(c, *cc, ec.p_half)
            want = down_plain(c, *cc, ec.p_half)
            ok = torch.equal(got, want)
            log(f"kernels mod_down n={n} k={k} {site} {list(got.shape)} {got.dtype}: "
                f"{'equal' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"mod_down differs from its plain version at {site}, n={n}")
            del got, want
        for site, (mode, kern, plain) in fused_sites(ctx, r, batch, gen).items():
            got = kern()
            want = plain()
            ok = torch.equal(got, want)
            log(f"kernels {mode} n={n} k={k} {site} {list(got.shape)} {got.dtype}: "
                f"{'equal' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"{mode} differs from its plain version at {site}, n={n}")
            del got, want
        del sites, downs, poly, y, tree, c_pair, ctx
    counts = {k: mod_kernels.LAUNCHES[k] for k in ("mod_elem", "mod_down")}
    log(f"kernels: launches {counts}, K5 by mode {mod_kernels.OP_LAUNCHES}, "
        f"K6 by addends {mod_kernels.DOWN_LAUNCHES}")
    if min(counts.values()) == 0 or min(mod_kernels.OP_LAUNCHES.values()) == 0 or \
            min(mod_kernels.DOWN_LAUNCHES.values()) == 0:
        raise AssertionError(f"K5 (a mode) or K6 (a form) did not launch in the kernel phase: {counts} "
                             f"{mod_kernels.OP_LAUNCHES} {mod_kernels.DOWN_LAUNCHES}")


def fused_sites(ctx, r, batch, gen):
    """Phase 2's checks of K5's gather, sum and centred lift and of K6 with
    addends, at each site's layout on `ctx` (r(shape, q) makes residues
    below q): {name: (mode, kernel call, plain call)}.  Gathers: a galois
    permutation of one ciphertext's c1 and of a batch's (int32 index and
    sign mask of ``galois_perm_device``), the BSGS rot_f0 fan-out and the
    babystep results' permutation (per-row index tables); sums: the
    giantsteps' signed gathered sum over q and the contraction results'
    over q and P; lifts: BEHZ's alpha mod m_sk to q and r mod m_tilde to
    Bsk; K6: apply_galois (a gathered, signed c0 for row 0, and a rotation's
    running sum), relinearize's c0 / c1, the BSGS's strided inner_g rows
    and its one-row p0, into a caller's slice; and a limb view's rows (limbs
    4..7 of the constants and of every operand)."""
    import torch

    from hhe_tpu_torch.ops import bfv_eval, mod_kernels, modular, rns, transcipher

    n, k = ctx.n, ctx.k
    ec = bfv_eval.eval_consts(ctx)
    q, qp, bq = ctx.tb_q.q, ctx.tb_qp.q, ctx.tb_bsk.q
    n1, n2 = transcipher.BSGS_N1, transcipher.BSGS_N2
    src, sign = ctx.galois_perm_device(ctx.galois_elt_from_step(-1))
    srcs = torch.stack([ctx.galois_perm_device(ctx.galois_elt_from_step(-j))[0] for j in range(n1)])
    signs = torch.stack([ctx.galois_perm_device(ctx.galois_elt_from_step(-j))[1] for j in range(n2)])
    rot_idx, h_idx = srcs[:, None, :], srcs[None, 1:, None, :]
    csrc, csign, nsrc = srcs[1:n2, None, :], signs[1:, None, :], srcs[None, 1:n2, None, :]
    cols = (ec.q, ec.qi, ec.p_mod_q, ec.p_inv_mont)
    msk = ec.fbc_b_to_q_msk.c_q[-1:]
    one, bat = r((2, k, n), q), r((2, batch, k, n), q)
    f0, inner = r((k, n), q), r((2, n2, k, n), q)
    b_res, g01 = r((2, n1 - 1, k + 1, n), qp), r((2, n2 - 1, k + 1, n), qp)
    alpha = r((2, batch, 1, n), msk)
    rt = torch.randint(0, ctx.m_tilde, (batch, 1, 1, n), generator=gen, device=q.device).int()
    c_one, c_bat = r((2, k + 1, n), qp), r((2, batch, k + 1, n), qp)
    c_bsgs, c_g = r((2, n2, k + 1, n), qp), r((2, k + 1, n), qp)
    p0 = r((k, n), q)
    view = lambda x: torch.cat([x[..., 4:8, :], x[..., -1:, :]], -2)  # noqa: E731
    vcols = tuple(x[4:8] for x in cols)

    def down(c, adds, cc=cols, into=False):
        def kern():
            out = c.new_empty((*c.shape[:-2], c.shape[-2] - 1, c.shape[-1])) if into else None
            return mod_kernels.mod_down(c, *cc, ec.p_half, adds=adds, out=out)
        return ("mod_down+addends", kern, lambda: down_plain(c, *cc, ec.p_half, adds=adds))

    def gather(a, idx, qq=None, sg=None):
        return ("gather", lambda: modular.gather_mod(a, idx, qq, sg),
                lambda: modular.gather_mod_plain(a, idx, qq, sg))

    def msum(a, qq, dim, idx=None, sg=None):
        return ("sum", lambda: modular.sum_mod(a, qq, dim, idx, sg),
                lambda: modular.sum_mod_plain(a, qq, dim, idx, sg))

    def center(x, m, qq, half):
        return ("center", lambda: rns.center_lift(x, m, qq, half),
                lambda: rns.center_lift_plain(x, m, qq, half))

    return {
        "gather, one ciphertext's c1, signed": gather(one[1], src, q, sign),
        "gather, a batch's c1, signed": gather(bat[1], src, q, sign),
        "gather, rot_f0's fan-out": gather(f0[None], rot_idx),
        "gather, the babystep results": gather(b_res, h_idx),
        "sum, the giantsteps' signed inner_g": msum(inner[0, 1:], q, 0, csrc, csign),
        "sum, the giantstep contractions": msum(g01, qp, 1, nsrc),
        "sum, a plain axis": msum(g01, qp, 1),
        "center, alpha mod m_sk to q": center(alpha, ec.msk_mod_q, q, ec.msk_half),
        "center, r mod m_tilde to Bsk": center(rt, ctx.m_tilde, bq, ctx.m_tilde // 2 - 1),
        "K6, apply_galois (gathered c0, a running sum), one ciphertext":
            down(c_one, (mod_kernels.Addend(one[:1], src, sign), one)),
        "K6, apply_galois, a batch": down(c_bat, (mod_kernels.Addend(bat[:1], src, sign),)),
        "K6, relinearize's c0 / c1 and a sum, a batch": down(c_bat, (bat, bat), into=True),
        "K6, the BSGS inner_g": down(c_bsgs, (inner,)),
        "K6, the BSGS output (p0, strided inner_g rows), into a slice":
            down(c_g, (p0[None], inner[:, 0]), into=True),
        "K6, a limb view's rows, gathered c0": down(
            view(c_one), (mod_kernels.Addend(one[:1, 4:8], src, sign), one[:, 4:8]), vcols),
        "gather, a limb view's rows, signed": gather(one[1, 4:8], src, q[4:8], sign),
        "K6, unaligned": down(r((2, k + 1, n + 1), qp)[..., 1:], (one,)),
    }


# the moduli columns (q, qinv_neg) first seen with each K3 / K4 layout, so
# that phase 7 can remake the layout's operands
MONT_MODULI = {}


def mont_layout(x):
    """A K3 / K4 operand as phase 7 remakes it: a Python int, or the
    tensor's (shape, strides, dtype)."""
    if isinstance(x, (int, np.integer)):
        return int(x)
    return tuple(x.shape), tuple(x.stride()), str(x.dtype).split(".")[-1]


# the moduli, index tables and masks (and K6's constants and addends'
# tables) first seen with each K5 / K6 layout: phase 7 remakes a layout's
# streamed operands and keeps these
ELEM_MODULI = {}
DOWN_CONSTS = {}


def index_layout(x):
    """An index or mask as phase 7 keys it: None, or its layout (phase 7
    reuses the first tensor seen: the real permutation)."""
    return None if x is None else mont_layout(x)


def elem_call_mode(mode, e, a, b):
    """K5 in `mode` on the recorded operands `e`, with a and b remade."""
    from hhe_tpu_torch.ops import mod_kernels

    if mode == "center":
        return mod_kernels.mod_center(a, b, e["q"], e["half"])
    if mode == "gather":
        return mod_kernels.mod_gather(a, e["idx"], e["q"] if e["sign"] is not None else None, e["sign"])
    if mode == "sum":
        return mod_kernels.mod_sum(a, e["q"], e["dim"], e["idx"], e["sign"])
    return mod_kernels.mod_elem(mode, a, b, e["q"])


def elem_plain_mode(mode, e, a, b):
    """K5's plain version in `mode` (``elem_plain`` for the four ops)."""
    from hhe_tpu_torch.ops import modular, rns

    if mode == "center":
        return rns.center_lift_plain(a, b, e["q"], e["half"])
    if mode == "gather":
        return modular.gather_mod_plain(a, e["idx"], e["q"], e["sign"])
    if mode == "sum":
        return modular.sum_mod_plain(a, e["q"], e["dim"], e["idx"], e["sign"])
    return elem_plain(mode, a, b, e["q"])


class ShapeRecorder:
    """Records the (shape, moduli) of every K1 / K2 call (``calls["ntt_fwd"]``,
    ``calls["ntt_inv"]``), the operand layout of every K3 / K4 call
    (``calls["mont"]``: (wrapper, dim, a, b, q, qinv_neg) layouts), of every
    K5 call (``calls["elem"]``: (op, a, b, q)) and of every K6 call
    (``calls["down"]``: (c, q) layouts), without touching the wrappers'
    launch counts.

    While a recorder is entered, and during every capture of a
    ``utils.graphs`` unit, the wrappers are patched to count each call into
    ``TAPE``, whose counters ``graphs.COUNTERS`` holds: a unit's replay
    credits the calls its capture made, as it credits the launch counts, so
    that the calls per layout of a path are those of an eager run.  A
    recorder's ``calls`` are TAPE's growth while it is entered.  ``install``
    runs once, before any unit is captured."""

    TAPE = None
    _orig = None
    _depth = 0

    @classmethod
    def install(cls):
        from hhe_tpu_torch.ops import mod_kernels, ntt_kernels
        from hhe_tpu_torch.utils import graphs

        if cls.TAPE is not None:
            return
        cls.TAPE = {name: collections.Counter()
                    for name in ("ntt_fwd", "ntt_inv", "mont", "elem", "down")}
        graphs.COUNTERS.extend(cls.TAPE.values())
        cls._orig = [(ntt_kernels, name, getattr(ntt_kernels, name)) for name in ("ntt_fwd", "ntt_inv")]
        cls._orig += [(mod_kernels, name, getattr(mod_kernels, name))
                      for name in ("mont_mul", "mont_mul_lazy", "mont_mac", "mod_elem", "mod_center",
                                   "mod_gather", "mod_sum", "mod_down")]
        capture = graphs.Jit._capture

        def recorded_capture(jit, key, args):
            cls._patch()
            try:
                return capture(jit, key, args)
            finally:
                cls._unpatch()

        graphs.Jit._capture = recorded_capture

    @classmethod
    def _patch(cls):
        cls._depth += 1
        if cls._depth > 1:
            return
        tape = cls.TAPE
        for mod, name, fn in cls._orig:
            if name.startswith("ntt"):
                def rec(x, tb, _fn=fn, _name=name):
                    tape[_name][(tuple(x.shape), tb.moduli)] += 1
                    return _fn(x, tb)
            elif name.startswith("mod_") and name != "mod_down":
                def rec(*args, _fn=fn, _name=name, **kw):
                    mode, e = elem_args(_name, args)
                    key = (mode, *map(mont_layout, (e["a"], e["b"], e["q"])), e["half"],
                           *map(index_layout, (e["idx"], e["sign"])), e["dim"])
                    ELEM_MODULI.setdefault(key, {k: v for k, v in e.items() if k not in ("a", "b")})
                    tape["elem"][key] += 1
                    return _fn(*args, **kw)
            elif name == "mod_down":
                def rec(c, *consts, adds=(), out=None, _fn=fn, _mod=mod):
                    adds = tuple(_mod.addend(x) for x in adds)
                    key = (mont_layout(c), mont_layout(consts[0]),
                           tuple((mont_layout(x.x), *map(index_layout, (x.idx, x.sign))) for x in adds))
                    DOWN_CONSTS.setdefault(key, (consts, tuple(x._replace(x=None) for x in adds)))
                    tape["down"][key] += 1
                    return _fn(c, *consts, adds=adds, out=out)
            else:
                def rec(a, b, q, qi, *dim, _fn=fn, _name=name, **kw):
                    key = (_name, dim[0] if dim else None, *map(mont_layout, (a, b, q, qi)))
                    MONT_MODULI.setdefault(key, (q, qi))
                    tape["mont"][key] += 1
                    return _fn(a, b, q, qi, *dim, **kw)
            setattr(mod, name, rec)

    @classmethod
    def _unpatch(cls):
        cls._depth -= 1
        if cls._depth == 0:
            for mod, name, fn in cls._orig:
                setattr(mod, name, fn)

    def __init__(self):
        self.install()
        self.calls = None

    def __enter__(self):
        self._patch()
        self.start = {name: collections.Counter(c) for name, c in self.TAPE.items()}
        return self

    def __exit__(self, *exc):
        self.calls = {name: c - self.start[name] for name, c in self.TAPE.items()}
        self._unpatch()


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


# (kernel, the TPU kernel it replaces): the tile kernels K1 and K2 and, for
# rows longer than one 64 KB tile, their top passes
KERNELS = (
    ("ntt_fwd", "hhe_tpu/ops/ntt_pallas.py:146"),
    ("ntt_inv", "hhe_tpu/ops/ntt_pallas.py:197"),
    ("ntt_fwd_top", "hhe_tpu/ops/ntt_pallas.py:146"),
    ("ntt_inv_top", "hhe_tpu/ops/ntt_pallas.py:197"),
)


def rotating(fns):
    """One callable that runs fns[0], fns[1], ... in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def timings(hot, cold, b_ms):
    """``ms`` / ``device_ms``: every call on one operand (PR 2's measure);
    ``ms_cold`` / ``device_ms_cold``: successive calls on different copies,
    so that no call finds its data in the L2; each beside the bound."""
    ms, dev_ms = cuda_ms(hot, 20), graph_ms(hot)
    ms_cold, dev_cold = cuda_ms(cold, 20), graph_ms(cold)
    return {
        "ms": ms, "device_ms": dev_ms, "ms_cold": ms_cold, "device_ms_cold": dev_cold,
        "share_of_bound": b_ms / ms, "device_share_of_bound": b_ms / dev_ms,
        "share_of_bound_cold": b_ms / ms_cold, "device_share_of_bound_cold": b_ms / dev_cold,
    }


def time_entry(hot, cold, name, shape, moduli, calls, lazy):
    b_ms, b_by = launch_bound(name, shape, moduli)
    return {"shape": list(shape), "lazy": lazy, "calls": calls,
            "bound_ms": b_ms, "bound_by": b_by, **timings(hot, cold, b_ms)}


def check_shape(name, shape, moduli, calls, gen):
    """At one shape a path gave K1 (`name` "ntt_fwd") or K2 ("ntt_inv"), on
    random residues below each q: the wrapper against the plain version and,
    above N = 16384, each of its two launches alone against the plain
    version of what that launch computes (the top passes' own plain
    versions; a lazy intermediate reduced mod q first), all ``torch.equal``.
    Times each launch (``ms`` a Python call, a loop of 20 timed by CUDA
    events; ``device_ms`` the device alone, a CUDA graph of launches) beside
    its bound, and above 16384 the wrapper's two launches together beside
    the single-pass bound.  Up to 16384 a launch is timed through the
    wrapper, whose time per call is what its callers pay.  ``ms`` and
    ``device_ms`` run every call on one operand; the ``_cold`` keys cycle
    through copies of it, enough that a call's data has left the 50 MB L2
    cache before it comes round again (the bound counts device-memory
    bytes).  Returns ({kernel: entry}, max abs error); raises on any
    difference."""
    import torch

    from hhe_tpu_torch.ops import ntt, ntt_kernels

    dev = torch.device("cuda")
    lib = ntt_kernels._library()
    fwd, top = name == "ntt_fwd", name + "_top"
    n = shape[-1]
    tb = ntt.build_tables(moduli, n, dev)
    q = tb.q.reshape(*([1] * (len(shape) - 2)), -1, 1)

    def rand():
        return (torch.randint(0, 1 << 31, shape, generator=gen, device=dev) % q).to(torch.int32)

    def go(kname, src, dst):
        rc = ntt_kernels.launch(lib, kname, src, dst, tb)
        if rc:
            raise RuntimeError(f"{kname} launch failed: CUDA error {rc}")
        return dst

    def reduced(t):  # lazy residues (u32 bits) -> [0, q)
        return ((t.long() & 0xFFFFFFFF) % q).to(torch.int32)

    wrapper = getattr(ntt_kernels, name)
    x = rand()
    want = (ntt.ntt_fwd_plain if fwd else ntt.ntt_inv_plain)(x, tb)
    pairs = [(name, wrapper(x, tb), want)]
    y = torch.empty_like(x)
    if n > ntt.TILE:
        if fwd:
            top_in, tile_in = x, ntt.ntt_fwd_top_plain(x, tb)
            pairs.append((top, reduced(go(top, x, y)), tile_in))
            pairs.append((f"{name} alone", go(name, tile_in, y).clone(), want))
        else:
            tile_in, top_in = x, rand()
            pairs.append((f"{name} alone", ntt.ntt_inv_top_plain(reduced(go(name, x, y)), tb), want))
            pairs.append((top, go(top, top_in, y).clone(), ntt.ntt_inv_top_plain(top_in, tb)))
    err = 0
    for what, got, exp in pairs:
        err = max(err, int((got.long() - exp.long()).abs().max()))
        if not torch.equal(got, exp):
            raise AssertionError(f"{what} differs from its plain version at {list(shape)}")
    del pairs, want
    copies = range(max(1, min(20, -(-2 * L2_BYTES // (8 * x.numel())))))
    xs = [x] + [x.clone() for _ in copies[1:]]
    whole = (lambda: wrapper(x, tb), rotating([lambda xi=xi: wrapper(xi, tb) for xi in xs]))
    if n <= ntt.TILE:
        return {name: time_entry(*whole, name, shape, moduli, calls, tb.lazy)}, err

    def alone(kname, src):
        pairs = [(src.clone(), torch.empty_like(src)) for _ in copies]
        hot = pairs[0]
        return (lambda: go(kname, *hot),
                rotating([lambda s=s, d=d: go(kname, s, d) for s, d in pairs]))

    entries = {
        name: time_entry(*alone(name, tile_in), name, shape, moduli, calls, tb.lazy),
        top: time_entry(*alone(top, top_in), top, shape, moduli, calls, tb.lazy),
    }
    del y
    b_ms, _ = bound(shape, moduli, n.bit_length() - 1, not fwd)
    entries[name]["both_launches"] = {"single_pass_bound_ms": b_ms, **timings(*whole, b_ms)}
    return entries, err


def kernel_rows(launches, calls):
    """Phase 7: every shape each path in `calls` ({path: {"ntt_fwd" |
    "ntt_inv": Counter((shape, moduli))}}) gave K1 and K2, checked and timed
    by ``check_shape`` (once a shape: a later path reuses the entry); one
    row per kernel.  A row's headline numbers are at its dominant shape (the
    one carrying the most polynomial rows) on the ECG path for the tile
    kernels and on the large preset's keystream for the top passes;
    ``paths`` sums every recorded shape times its calls per path (the
    ``main_path_*`` keys: the ECG path).  `launches` is {path: {kernel:
    count}}, each from that path's run."""
    import torch

    from hhe_tpu_torch.ops import ntt

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    per = {name: [] for name, _ in KERNELS}
    errs = dict.fromkeys(per, 0)
    checked = {}
    for path, path_calls in calls.items():
        for name in ("ntt_fwd", "ntt_inv"):
            for (shp, mods), cnt in sorted(path_calls[name].items()):
                if (name, shp, mods) not in checked:
                    checked[name, shp, mods] = check_shape(name, shp, mods, cnt, gen)
                entries, err = checked[name, shp, mods]
                for kname, e in entries.items():
                    e = dict(e, path=path, calls=cnt)
                    per[kname].append((e, mods))
                    errs[kname] = max(errs[kname], err)
                    both = e.get("both_launches")
                    log(f"  {path} {kname} {list(shp)} lazy={e['lazy']} x{cnt}: {e['ms']:.4f} ms "
                        f"a call ({e['ms_cold']:.4f} cold), {e['device_ms']:.4f} ms on the device "
                        f"({e['device_ms_cold']:.4f} cold), bound {e['bound_ms']:.4f} ms "
                        f"({e['bound_by']}), {e['share_of_bound']:.0%} "
                        f"({e['device_share_of_bound_cold']:.0%} on the device, cold)"
                        + (f"; both launches {both['ms']:.4f} ms ({both['device_ms_cold']:.4f} "
                           f"cold on the device) against the single-pass bound "
                           f"{both['single_pass_bound_ms']:.4f} "
                           f"({both['device_share_of_bound_cold']:.0%})" if both else ""))
    plains = {"ntt_fwd": ntt.ntt_fwd_plain, "ntt_inv": ntt.ntt_inv_plain,
              "ntt_fwd_top": ntt.ntt_fwd_top_plain, "ntt_inv_top": ntt.ntt_inv_top_plain}
    rows = []
    for name, replaces in KERNELS:
        shapes = [e for e, _ in per[name]]
        head_path = "large_keystream" if name.endswith("_top") else "ecg"
        head, mods = max(((e, m) for e, m in per[name] if e["path"] == head_path),
                         key=lambda em: em[0]["calls"] * int(np.prod(em[0]["shape"][:-1])))
        tb = ntt.build_tables(mods, head["shape"][-1], dev)
        q = tb.q.reshape(*([1] * (len(head["shape"]) - 2)), -1, 1)
        x = (torch.randint(0, 1 << 31, head["shape"], generator=gen, device=dev) % q).to(torch.int32)
        plain_ms = cuda_ms(lambda: plains[name](x, tb), 2)
        del x
        paths = {}
        for path in calls:
            mine = [e for e in shapes if e["path"] == path]
            if mine:
                s = {key: sum(e["calls"] * e[key] for e in mine)
                     for key in ("ms", "device_ms", "ms_cold", "device_ms_cold", "bound_ms")}
                b = s["bound_ms"]
                paths[path] = {**s, "share_of_bound": b / s["ms"],
                               "device_share_of_bound": b / s["device_ms"],
                               "device_share_of_bound_cold": b / s["device_ms_cold"]}
        main = paths.get("ecg")
        row = {
            "name": name,
            "route": "cuda",
            "source": "hhe_tpu_torch/csrc/ntt.cu",
            "replaces": replaces,
            "launches": sum(per_path[name] for per_path in launches.values()),
            "launches_by_path": {path: per_path[name] for path, per_path in launches.items()},
            "max_abs_err": errs[name],
            "tolerance": 0,  # exact residues: the kernel must equal its plain version
            "ms": head["ms"],
            "device_ms": head["device_ms"],
            "ms_cold": head["ms_cold"],
            "device_ms_cold": head["device_ms_cold"],
            "plain_ms": plain_ms,
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,  # no PyTorch call computes an exact modular NTT
            "shape": head["shape"],
            "shape_path": head_path,
            "lazy": head["lazy"],
            "calls_at_shape": head["calls"],
            "paths": paths,
            "shapes_checked": len(shapes),
            "shapes": shapes,
            "verdict": "equal",
        }
        if main:
            row.update({
                "main_path_ms": main["ms"],
                "main_path_device_ms": main["device_ms"],
                "main_path_ms_cold": main["ms_cold"],
                "main_path_device_ms_cold": main["device_ms_cold"],
                "main_path_bound_ms": main["bound_ms"],
                "main_path_share_of_bound": main["share_of_bound"],
                "main_path_device_share_of_bound": main["device_share_of_bound"],
                "main_path_device_share_of_bound_cold": main["device_share_of_bound_cold"],
            })
        rows.append(row)
        log(f"{name} at {head['shape']} ({head_path}): {head['ms']:.4f} ms a call "
            f"({head['device_ms']:.4f} ms on the device, {head['device_ms_cold']:.4f} cold), "
            f"{plain_ms:.3f} ms plain, bound {head['bound_ms']:.4f} ms ({head['bound_by']}); "
            f"launches {row['launches_by_path']}; "
            + "; ".join(f"{p}: {v['ms']:.3f} ms in calls ({v['device_ms']:.3f} on the device, "
                        f"{v['device_ms_cold']:.3f} cold) against {v['bound_ms']:.3f} "
                        f"({v['share_of_bound']:.0%}; {v['device_share_of_bound_cold']:.0%} cold)"
                        for p, v in paths.items()))
    return rows


# (kernel, what it stands for): K3 and K4 are not TPU kernels; the JAX package
# gets them as XLA fusions of these functions
MONT_KERNELS = (
    ("mont_mul", "hhe_tpu/ops/modular.py:79 (XLA fusion of mont_mul / mont_mul_lazy :94)"),
    ("mont_mac", "hhe_tpu/ops/modular.py:121 (XLA fusion of tree_add_mod(mont_mul(...)))"),
)
MONT_TOP = 10  # layouts checked per path besides the ECG path's (all of those)


def mont_entry(key, calls, gen):
    """Phase 7 for one K3 / K4 layout `key` a path gave the kernels: its
    operands remade (random residues below the smallest modulus, through the
    recorded strides, so broadcast operands stay unmaterialised), the kernel
    against the plain version (``torch.equal``), timed as ``timings`` does
    (the ``_cold`` keys cycle through copies of a and b), the plain
    version's ms, and the bound; for a K4 layout in a fan-out form, the
    general form's device time on the same copies beside it (the one-pass loop,
    which re-reads the shared operand for every output of its fan-out).
    Returns (entry, max abs error)."""
    import torch

    from hhe_tpu_torch.ops import mod_kernels

    name, dim, la, lb, _, _ = key
    q, qi = MONT_MODULI[key]
    qmin = int(q.min()) if isinstance(q, torch.Tensor) else int(q)

    def operand(lay):
        if isinstance(lay, int):
            return lay
        shape, stride, dtype = lay
        extent = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
        base = torch.randint(0, qmin, (extent,), generator=gen, device="cuda",
                             dtype=getattr(torch, dtype))
        return base.as_strided(shape, stride)

    a, b = operand(la), operand(lb)
    got = mont_call(name, a, b, q, qi, dim)
    want = mont_plain(name, a, b, q, qi, dim)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain version at {key}")
    del got, want
    p = mod_kernels.plan(a, b, q, qi, dim)
    b_ms, b_by = mont_bound(p, a, b, q, qi)
    nbytes = sum(x.element_size() * x.numel() for x in (a, b) if isinstance(x, torch.Tensor))
    copies = max(1, min(20, -(-2 * L2_BYTES // max(1, nbytes))))
    pairs = [(a, b)] + [(operand(la), operand(lb)) for _ in range(copies - 1)]
    hot = lambda: mont_call(name, a, b, q, qi, dim)
    cold = rotating([lambda x=x, y=y: mont_call(name, x, y, q, qi, dim) for x, y in pairs])
    entry = {
        "kernel": "mont_mac" if name == "mont_mac" else "mont_mul", "wrapper": name,
        "a": [list(la[0]), la[2]] if not isinstance(la, int) else la,
        "b": [list(lb[0]), lb[2]] if not isinstance(lb, int) else lb,
        "dim": dim, "out": list(p.shape), "terms": p.terms, "calls": calls,
        "form": p.form if name == "mont_mac" else None,
        "bound_ms": b_ms, "bound_by": b_by, **timings(hot, cold, b_ms),
        "plain_ms": cuda_ms(lambda: mont_plain(name, a, b, q, qi, dim), 2),
        "general_device_ms_cold": None,
    }
    if name == "mont_mac" and p.form != "general":
        entry["general_device_ms_cold"] = graph_ms(rotating(
            [lambda x=x, y=y: mod_kernels.mont_mac(x, y, q, qi, dim, fan_out=False) for x, y in pairs]))
    return entry, err


def mont_rows(launches, calls):
    """Phase 7 for K3 and K4: every layout the ECG path gave them, the
    MONT_TOP most-called layouts of every other path in `calls` and every
    base-conversion layout of each (K4 against constants), checked and
    timed by ``mont_entry`` (once a layout: a later path reuses the entry);
    one row per kernel, its headline at the ECG path's layout with the most
    bound time (calls x bound), ``paths`` summing calls x time over the
    checked layouts of each path."""
    import torch

    from hhe_tpu_torch.ops import mod_kernels

    gen = torch.Generator(device="cuda").manual_seed(11)
    checked, per, errs = {}, {name: [] for name, _ in MONT_KERNELS}, dict.fromkeys(("mont_mul", "mont_mac"), 0)
    def conversion(key):  # a K4 layout whose b is a constant per word row: a base conversion
        lb = key[3]
        return key[0] == "mont_mac" and not isinstance(lb, int) and lb[0][-1] == 1

    for path, path_calls in calls.items():
        mont = path_calls["mont"]
        keys = mont.items() if path == "ecg" else mont.most_common(MONT_TOP)
        keys = list(keys) + [kv for kv in mont.items() if conversion(kv[0]) and kv not in keys]
        for key, cnt in keys:
            if key not in checked:
                checked[key] = mont_entry(key, cnt, gen)
            e, err = checked[key]
            e = dict(e, path=path, calls=cnt)
            per[e["kernel"]].append(e)
            errs[e["kernel"]] = max(errs[e["kernel"]], err)
            general = e["general_device_ms_cold"]
            log(f"  {path} {e['wrapper']}{' ' + e['form'] if e['form'] else ''} a={e['a']} b={e['b']} "
                f"dim={e['dim']} -> {e['out']} x{cnt}: {e['ms']:.4f} ms a call ({e['ms_cold']:.4f} "
                f"cold), {e['device_ms']:.4f} on the device ({e['device_ms_cold']:.4f} cold"
                + (f"; general form {general:.4f}" if general is not None else "")
                + f"), plain {e['plain_ms']:.3f}, bound {e['bound_ms']:.4f} ({e['bound_by']}), "
                f"{e['device_share_of_bound_cold']:.0%} on the device, cold")
    rows = []
    for name, replaces in MONT_KERNELS:
        shapes = per[name]
        head = max((e for e in shapes if e["path"] == "ecg"), key=lambda e: e["calls"] * e["bound_ms"])
        paths = {}
        for path in calls:
            mine = [e for e in shapes if e["path"] == path]
            if mine:
                t = {key: sum(e["calls"] * e[key] for e in mine)
                     for key in ("ms", "device_ms", "ms_cold", "device_ms_cold", "bound_ms", "plain_ms")}
                # every layout in the general form (a fan-out form's layouts timed in both)
                t["general_device_ms_cold"] = sum(
                    e["calls"] * (e["general_device_ms_cold"] or e["device_ms_cold"]) for e in mine)
                paths[path] = {**t, "layouts": len(mine), "calls": sum(e["calls"] for e in mine),
                               "device_share_of_bound_cold": t["bound_ms"] / t["device_ms_cold"]}
        main = paths["ecg"]
        row = {
            "name": name,
            "route": "cuda",
            "source": "hhe_tpu_torch/csrc/modarith.cu",
            "replaces": replaces,
            "launches": sum(per_path[name] for per_path in launches.values()),
            "launches_by_path": {path: per_path[name] for path, per_path in launches.items()},
            "max_abs_err": errs[name],
            "tolerance": 0,  # exact residues: the kernel must equal its plain version
            **{key: head[key] for key in ("ms", "device_ms", "ms_cold", "device_ms_cold", "plain_ms",
                                          "bound_ms", "bound_by", "a", "b", "dim", "out", "terms")},
            # no PyTorch call computes a Montgomery product modulo a per-row prime
            "library_ms": None,
            "shape_path": "ecg",
            "calls_at_shape": head["calls"],
            "paths": paths,
            "shapes_checked": len(shapes),
            "shapes": [{key: e[key] for key in ("path", "wrapper", "form", "a", "b", "dim", "out",
                                                "calls", "ms", "device_ms_cold",
                                                "general_device_ms_cold", "plain_ms", "bound_ms")}
                       for e in shapes],
            "verdict": "equal",
            "main_path_ms": main["ms"],
            "main_path_device_ms": main["device_ms"],
            "main_path_device_ms_cold": main["device_ms_cold"],
            "main_path_bound_ms": main["bound_ms"],
            "main_path_plain_ms": main["plain_ms"],
            "main_path_device_share_of_bound_cold": main["device_share_of_bound_cold"],
        }
        if name == "mont_mac":  # K4's launches by form on each path
            row["launches_by_form"] = {
                path: {form: per_path.get(f"mont_mac_{form}", 0) for form in mod_kernels.FORMS}
                for path, per_path in launches.items()}
            log(f"mont_mac launches by form: {row['launches_by_form']}")
        rows.append(row)
        log(f"{name} at a={head['a']} b={head['b']} dim={head['dim']} (ecg, x{head['calls']}): "
            f"{head['ms']:.4f} ms a call ({head['device_ms']:.4f} on the device, "
            f"{head['device_ms_cold']:.4f} cold), {head['plain_ms']:.3f} ms plain, bound "
            f"{head['bound_ms']:.4f} ms ({head['bound_by']}); launches {row['launches_by_path']}; "
            + "; ".join(f"{p}: {v['calls']} calls in {v['layouts']} layouts, {v['ms']:.3f} ms "
                        f"({v['device_ms_cold']:.3f} on the device, cold; general form "
                        f"{v['general_device_ms_cold']:.3f}; plain {v['plain_ms']:.1f}) "
                        f"against {v['bound_ms']:.3f}" for p, v in paths.items()))
    return rows


# (kernel, what it stands for): K5 and K6 are not TPU kernels; the JAX
# package gets them as XLA fusions of these functions
ELEM_KERNELS = (
    ("mod_elem", "hhe_tpu/ops/modular.py:108 (XLA fusions of add_mod / sub_mod :113 / neg_mod "
                 ":117) and hhe_tpu/ops/rns.py:150 (reduce_u32)"),
    ("mod_down", "hhe_tpu/ops/bfv_eval.py:224 (XLA fusion of mod_down)"),
)


def remade(lay, bound, gen):
    """An operand of layout `lay` (a Python int as it is) holding random
    values below `bound`, through the recorded strides (broadcast operands
    stay unmaterialised)."""
    import torch

    if isinstance(lay, int):
        return lay
    shape, stride, dtype = lay
    extent = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    base = torch.randint(0, bound, (extent,), generator=gen, device="cuda",
                         dtype=getattr(torch, dtype))
    return base.as_strided(shape, stride)


def elem_entry(kind, key, calls, gen):
    """Phase 7 for one K5 (`kind` "mod_elem") or K6 ("mod_down") layout a
    path gave it: its streamed operands remade (random values below the
    smallest modulus, below 2^31 for a reduction's or a lift's input; the
    recorded moduli, constants, index tables and masks), the kernel against
    the plain version (``torch.equal``), timed as ``timings`` does (the
    ``_cold`` keys cycle through copies of the streamed operands), the plain
    version's ms, the bound (each operand's distinct words read once, the
    index and mask bytes included, and the output written once at the HBM
    rate) and the library call where one PyTorch call computes the same
    function -- ``torch.remainder`` for a reduction (three subtracts are x
    mod q for x < 4q), ``torch.index_select`` for an unsigned gather with
    one index row (``torch.gather`` on an int64 copy of the index, made
    beforehand, with several) -- timed as ``ms`` is (``library_ms``) and on
    the device alone (``library_device_ms``), where it equals the kernel's
    output; else None (add, sub, neg, a signed gather, a sum, a lift, K6).
    Returns (entry, max abs error)."""
    import torch

    from hhe_tpu_torch.ops import mod_kernels

    def lay(x):
        return x if isinstance(x, int) else [list(x[0]), x[2]]

    if kind == "mod_elem":
        mode, la, lb, _, half, lidx, lsign, dim = key
        e = ELEM_MODULI[key]
        q = e["q"]
        # an unsigned gather reads no modulus (q is 0): any word below 2^31
        qmin = (int(q.min()) if isinstance(q, torch.Tensor) else int(q)) or 1 << 31
        top = 1 << 31 if mode in ("reduce", "center") else qmin
        bmax = qmin

        def make():
            return remade(la, top, gen), remade(lb, bmax, gen)

        def kern(x, y):
            return elem_call_mode(mode, e, x, y)

        def plain(x, y):
            return elem_plain_mode(mode, e, x, y)

        library = None
        if mode == "reduce":
            def library(x, _):
                return torch.remainder(x, q.to(x.dtype) if isinstance(q, torch.Tensor) else q)
        elif mode == "gather" and e["sign"] is None:
            idx = e["idx"]
            if idx.dim() == 1:
                def library(x, _):
                    return torch.index_select(x, -1, idx)
            else:
                full = torch.broadcast_shapes(torch.Size(la[0]), idx.shape)
                idx64 = idx.long().expand(full)

                def library(x, _):
                    return torch.gather(x.expand(full), -1, idx64)

        desc = {"op": mode, "a": lay(la), "b": lay(lb),
                "idx": None if lidx is None else list(lidx[0]), "signed": lsign is not None, "dim": dim}
        extra = words_bytes(q) + words_bytes(e["idx"]) + words_bytes(e["sign"])
        reads = lambda x, y: words_bytes(x) + words_bytes(y) + extra  # noqa: E731
    else:
        lc, _, ladds = key
        consts, adds = DOWN_CONSTS[key]
        qmin = int(consts[0].min())

        def make():
            xs = tuple(remade(la, qmin, gen) for la, _, _ in ladds)
            return remade(lc, qmin, gen), xs

        def with_x(xs):
            return tuple(a._replace(x=x) for a, x in zip(adds, xs))

        def kern(x, xs):
            return mod_kernels.mod_down(x, *consts, adds=with_x(xs))

        def plain(x, xs):
            return down_plain(x, *consts, adds=with_x(xs))

        library = None
        desc = {"op": f"{len(adds)} addends" if adds else None, "a": lay(lc),
                "b": [lay(la) for la, _, _ in ladds] or None,
                "idx": [None if li is None else list(li[0]) for _, li, _ in ladds] or None,
                "signed": any(ls is not None for _, _, ls in ladds), "dim": None}
        extra = sum(words_bytes(c) for c in consts[:4]) + sum(
            words_bytes(a.idx) + words_bytes(a.sign) for a in adds)
        reads = lambda x, xs: words_bytes(x) + sum(map(words_bytes, xs)) + extra  # noqa: E731
    a, b = make()
    got, want = kern(a, b), plain(a, b)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{kind} differs from its plain version at {key}")
    library_ms = library_device_ms = None
    if library is not None and torch.equal(library(a, b), got):
        library_ms = cuda_ms(lambda: library(a, b), 20)
        library_device_ms = graph_ms(lambda: library(a, b))
    elif library is not None:
        log(f"  the library call differs from {kind} at {key}: no library time")
    nbytes = reads(a, b) + got.numel() * got.element_size()
    out = list(got.shape)
    del got, want
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    copies = max(1, min(20, -(-2 * L2_BYTES // max(1, nbytes))))
    pairs = [(a, b)] + [make() for _ in range(copies - 1)]
    hot = lambda: kern(a, b)  # noqa: E731
    cold = rotating([lambda x=x, y=y: kern(x, y) for x, y in pairs])
    entry = {"kernel": kind, **desc, "out": list(out), "calls": calls, "bound_ms": b_ms,
             "bound_by": "bytes", **timings(hot, cold, b_ms),
             "plain_ms": cuda_ms(lambda: plain(a, b), 2), "library_ms": library_ms,
             "library_device_ms": library_device_ms}
    return entry, err


def elem_rows(launches, calls):
    """Phase 7 for K5 and K6: every layout the ECG path gave them and the
    MONT_TOP most-called layouts of every other path in `calls`, checked
    and timed by ``elem_entry`` (once a layout: a later path reuses the
    entry); one row per kernel, its headline at the ECG path's layout with
    the most bound time (calls x bound), ``paths`` summing calls x time
    over the checked layouts of each path."""
    import torch

    from hhe_tpu_torch.ops import mod_kernels

    gen = torch.Generator(device="cuda").manual_seed(13)
    checked, per = {}, {name: [] for name, _ in ELEM_KERNELS}
    errs = dict.fromkeys(per, 0)
    for path, path_calls in calls.items():
        for kind, part in (("mod_elem", "elem"), ("mod_down", "down")):
            counter = path_calls[part]
            keys = counter.items() if path == "ecg" else counter.most_common(MONT_TOP)
            for key, cnt in keys:
                if (kind, key) not in checked:
                    checked[kind, key] = elem_entry(kind, key, cnt, gen)
                e, err = checked[kind, key]
                e = dict(e, path=path, calls=cnt)
                per[kind].append(e)
                errs[kind] = max(errs[kind], err)
                log(f"  {path} {kind}{' ' + e['op'] if e['op'] else ''} a={e['a']} b={e['b']} "
                    f"idx={e['idx']}{' signed' if e['signed'] else ''} dim={e['dim']} -> "
                    f"{e['out']} x{cnt}: {e['ms']:.4f} ms a call ({e['ms_cold']:.4f} cold), "
                    f"{e['device_ms']:.4f} on the device ({e['device_ms_cold']:.4f} cold), plain "
                    f"{e['plain_ms']:.3f}, library {e['library_ms']} ({e['library_device_ms']} on the "
                    f"device), bound {e['bound_ms']:.4f} (bytes), "
                    f"{e['device_share_of_bound_cold']:.0%} on the device, cold")
    rows = []
    for name, replaces in ELEM_KERNELS:
        shapes = per[name]
        head = max((e for e in shapes if e["path"] == "ecg"), key=lambda e: e["calls"] * e["bound_ms"])
        paths = {}
        for path in calls:
            mine = [e for e in shapes if e["path"] == path]
            if mine:
                t = {key: sum(e["calls"] * e[key] for e in mine)
                     for key in ("ms", "device_ms", "ms_cold", "device_ms_cold", "bound_ms", "plain_ms")}
                paths[path] = {**t, "layouts": len(mine), "calls": sum(e["calls"] for e in mine),
                               "device_share_of_bound_cold": t["bound_ms"] / t["device_ms_cold"]}
        main = paths["ecg"]
        row = {
            "name": name,
            "route": "cuda",
            "source": "hhe_tpu_torch/csrc/modarith.cu",
            "replaces": replaces,
            "launches": sum(per_path[name] for per_path in launches.values()),
            "launches_by_path": {path: per_path[name] for path, per_path in launches.items()},
            "max_abs_err": errs[name],
            "tolerance": 0,  # exact residues: the kernel must equal its plain version
            # library_ms: torch.remainder where the headline is a reduction; no one
            # PyTorch call computes a modular add, sub or neg or K6's divide-and-round
            **{key: head[key] for key in ("ms", "device_ms", "ms_cold", "device_ms_cold", "plain_ms",
                                          "library_ms", "library_device_ms", "bound_ms", "bound_by",
                                          "op", "a", "b", "out")},
            "shape_path": "ecg",
            "calls_at_shape": head["calls"],
            "paths": paths,
            "shapes_checked": len(shapes),
            "shapes": [{key: e[key] for key in ("path", "op", "a", "b", "idx", "signed", "dim", "out",
                                                "calls", "ms", "device_ms", "device_ms_cold", "plain_ms",
                                                "library_ms", "library_device_ms", "bound_ms")}
                       for e in shapes],
            "verdict": "equal",
            "main_path_ms": main["ms"],
            "main_path_device_ms": main["device_ms"],
            "main_path_device_ms_cold": main["device_ms_cold"],
            "main_path_bound_ms": main["bound_ms"],
            "main_path_plain_ms": main["plain_ms"],
            "main_path_device_share_of_bound_cold": main["device_share_of_bound_cold"],
        }
        if name == "mod_elem":  # K5's launches by mode on each path
            row["launches_by_op"] = {
                path: {op: per_path.get(f"mod_elem_{op}", 0) for op in mod_kernels.ELEM_OPS}
                for path, per_path in launches.items()}
            log(f"mod_elem launches by op: {row['launches_by_op']}")
        else:  # K6's launches by the addends they took on each path
            row["launches_by_addends"] = {
                path: {form: per_path.get(f"mod_down_{form}", 0) for form in mod_kernels.DOWN_FORMS}
                for path, per_path in launches.items()}
            log(f"mod_down launches by addends: {row['launches_by_addends']}")
        rows.append(row)
        log(f"{name} at a={head['a']} b={head['b']} (ecg, x{head['calls']}): {head['ms']:.4f} ms a "
            f"call ({head['device_ms']:.4f} on the device, {head['device_ms_cold']:.4f} cold), "
            f"{head['plain_ms']:.3f} ms plain, library {head['library_ms']}, bound "
            f"{head['bound_ms']:.4f} ms; launches "
            f"{row['launches_by_path']}; "
            + "; ".join(f"{p}: {v['calls']} calls in {v['layouts']} layouts, {v['ms']:.3f} ms "
                        f"({v['device_ms_cold']:.3f} on the device, cold; plain {v['plain_ms']:.1f}) "
                        f"against {v['bound_ms']:.3f}" for p, v in paths.items()))
    return rows


def phase_main_path():
    import torch

    from hhe_tpu_torch.models import pocketnn
    from hhe_tpu_torch.ops import bfv, pasta, transcipher
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

    # the first run: each unit's first call runs its body, then captures it;
    # the second, the keystream caches cleared, replays every unit.  Their
    # launch counts and calls per layout must be equal (replays credited)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with ShapeRecorder() as rec_eager:
        t0 = time.perf_counter()
        out = wk.hhe_ecg_inference(stack, w, x)
        torch.cuda.synchronize()
        stats["ecg_inference_s"] = time.perf_counter() - t0
    eager_launches = launch_counts()
    stats["first_run_graphs"] = graph_counts("first run")
    stack.tc.clear_caches()
    reset_launches()
    rc_before = dict(transcipher.RC_BLOCKS)
    with ShapeRecorder() as rec:
        t0 = time.perf_counter()
        out2 = wk.hhe_ecg_inference(stack, w, x)
        torch.cuda.synchronize()
        stats["ecg_inference_replayed_s"] = time.perf_counter() - t0
    launches = launch_counts()
    stats["rc_blocks"] = {k: v - rc_before[k] for k, v in transcipher.RC_BLOCKS.items()}
    if stats["rc_blocks"]["host"] or not stats["rc_blocks"]["device"]:
        raise AssertionError(f"round constants made on the host on the main path: "
                             f"{stats['rc_blocks']}")
    stats["graphs"] = graph_counts("ecg")
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path: hhe_ecg_inference B={B} in {stats['ecg_inference_s']:.2f} s (bodies and "
        f"captures), {stats['ecg_inference_replayed_s']:.2f} s (replays), launches {launches}, "
        f"graphs {stats['graphs']}")
    if launches != eager_launches or rec.calls != rec_eager.calls:
        raise AssertionError(f"the replayed run's launches {launches} differ from the eager "
                             f"run's {eager_launches}, or its calls per layout do")
    if min(launches[k] for k in PATH_KERNELS) == 0:  # no row longer than a tile here
        raise AssertionError(f"a kernel did not launch on the main path: {launches}")
    if not np.array_equal(out["predictions"], out2["predictions"]):
        raise AssertionError("the replayed run's predictions differ from the first run's")

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

    # decompose at B with a fresh nonce per rep, PASTA encryption outside:
    # through the entry point (the units replayed) and through the units'
    # bodies, which must give the same bits
    key = pasta.get_fixed_symmetric_key()
    cipher = pasta.Pasta(key, ctx.t)
    enc_key = stack.tc.encrypt_key(stack.pk, key)
    tc = stack.tc
    nonce = 50_000
    times, eager = [], []
    for _ in range(REPS + 1):  # the first rep warms the allocator
        sym = cipher.encrypt(x.astype(np.uint64), nonce=nonce)
        got, t = timed(lambda: wk.csp_decompose(stack, enc_key, sym, nonce=nonce))
        times.append(t)
        want, t = timed(lambda: eager_decompose(tc, enc_key, sym, nonce))
        eager.append(t)
        if not torch.equal(got.data, want):
            raise AssertionError("decompose through the replayed units differs from their bodies")
        nonce += 1
    stats["decompose_s_by_rep"] = times
    stats["decompose_eager_s_by_rep"] = eager
    stats["decompose_ms"] = 1e3 * min(times[1:])
    stats["decompose_eager_ms"] = 1e3 * min(eager[1:])
    stats["pasta_bfv_transcipher_samples_per_s_batch64"] = B / min(times[1:])

    mats_qp, rcs_pt = tc.device_block_plaintexts(pasta.NONCE, 0)
    keys = tc._keys()
    stats["block_ms"] = 1e3 * min(
        wall_s(lambda: tc._keystream_impl(enc_key.data, mats_qp, rcs_pt, keys))
        for _ in range(REPS)
    )
    block = (enc_key.data, mats_qp, rcs_pt, keys)
    stats["block_graph_ms"] = 1e3 * min(wall_s(lambda: tc._jit_keystream(*block))
                                        for _ in range(REPS))
    stats["block_graph_device_ms"] = cuda_ms(lambda: tc._jit_keystream(*block), REPS)
    stats["expand_ms"] = 1e3 * min(
        wall_s(lambda: tc._jit_expand(tc.block_words(nonce, [0])[0])) for _ in range(REPS)
    )
    stats["expand_eager_ms"] = 1e3 * min(
        wall_s(lambda: tc._expand_impl(tc.block_words(nonce, [0])[0])) for _ in range(REPS)
    )
    # the host's share of a decompose outside the units, for a fresh nonce:
    # a block's SHAKE words (the SHAKE expansion, then cached, and one
    # upload), and beside it the host's own round constants (encode,
    # scaling, upload; off the main path)
    host = []
    for _ in range(REPS):
        nonce += 1
        host.append((wall_s(lambda: tc.block_words(nonce, [0])),
                     wall_s(lambda: tc.block_rcs(nonce, 0))))
    stats["block_words_ms"] = 1e3 * min(h[0] for h in host)
    stats["block_rcs_ms"] = 1e3 * min(h[1] for h in host)
    if not torch.equal(tc._round_constants(tc.block_words(nonce, [0])[0, 8:]),
                       tc.block_rcs(nonce, 0)):
        raise AssertionError("the card's round constants differ from the host's block_rcs")
    data_ct = out["data_ct"]
    wct = bfv.Ciphertext(helin_weight(stack, w).data[:, None])
    stats["csp_eval_1fc_ms"] = 1e3 * min(
        wall_s(lambda: wk.csp_eval_1fc(stack, data_ct, wct, do_sum=False)) for _ in range(REPS)
    )
    fc_body = stack._jit_1fc_False.fn
    stats["csp_eval_1fc_eager_ms"] = 1e3 * min(
        wall_s(lambda: fc_body(data_ct.data, wct.data, stack.rk, stack.gks)) for _ in range(REPS)
    )
    prod = out["prod_ct"]
    stats["decrypt_ms"] = 1e3 * min(
        wall_s(lambda: wk.analyst_decrypt_sum_sigmoid(stack, prod, transcipher.T))
        for _ in range(REPS)
    )
    stats["peak_mem_gib_after_timing"] = torch.cuda.max_memory_allocated() / 2**30
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    return stack, launches, rec.calls, stats, (d0, x[0])


# the parallel phase's four-step NTTs: (N, limbs), local transforms of
# M = 32, 64, 128, 256 (N = 1024 and 16384 at the production limb count,
# 4096 at default_context's, 65536 at the sharded keygen's)
PARALLEL_NTTS = ((1024, 13), (4096, 4), (16384, 13), (65536, 3))


def phase_parallel(stack):
    """The parallel path (``hhe_tpu_torch.parallel``) at world size 1 on the
    card: a one-rank NCCL group on an in-memory store, a ("poly",) mesh and
    the ("batch", "limb") mesh.  Each ``ShardedNtt`` of PARALLEL_NTTS
    (roundtrip the identity, ``negacyclic_mul`` equal to ``poly_mul_host``);
    ``keygen_public(sk, mesh=)`` at ``large_params(data_limbs=3)`` equal in
    bytes to the host path; on the ECG stack (N=16384, 13 limbs, B=64)
    ``csp_decompose(mesh=)`` equal to the unsplit result bit for bit (each
    with its keystream evaluated afresh) and decrypting to its input; K1
    and K2 must launch at M = 128 and 256, K3 and K4 at all.  Then, outside the counted run: the
    native and the pure-Python PASTA block expansion, equal, ms each with
    the cache cleared (the native one must be what every earlier phase
    used), and the sharded transforms' and the single-card NTT's times."""
    import torch
    import torch.distributed as dist

    from hhe_tpu_torch import native
    from hhe_tpu_torch.ops import bfv, ntt, pasta, primes, transcipher
    from hhe_tpu_torch.parallel import mesh as hmesh
    from hhe_tpu_torch.parallel import ntt_shard
    from hhe_tpu_torch.workloads import hhe_inference as wk

    t_phase = time.perf_counter()
    stats = {"ntt": {}}
    poly = hmesh.make_mesh((1,), ("poly",))
    mesh = hmesh.make_hhe_mesh()
    stats["backend"], stats["world_size"] = dist.get_backend(), dist.get_world_size()
    ctx, tc = stack.ctx, stack.tc
    key = pasta.get_fixed_symmetric_key()
    x = np.random.default_rng(11).integers(0, 64, (B, transcipher.T))
    nonce = 70_000
    sym = pasta.Pasta(key, ctx.t).encrypt(x.astype(np.uint64), nonce=nonce)
    enc_key = tc.encrypt_key(stack.pk, key)
    operands, shardeds = {}, {}

    reset_launches()
    with ShapeRecorder() as rec:
        t0 = time.perf_counter()
        for n, k in PARALLEL_NTTS:
            mods = primes.ntt_primes(n, 30, k)
            rng = np.random.default_rng(n)
            a = np.stack([rng.integers(0, q, n) for q in mods]).astype(np.uint32)
            b = np.stack([rng.integers(0, q, n) for q in mods]).astype(np.uint32)
            (sn, plan_s) = timed(lambda: ntt_shard.ShardedNtt(mods, n, poly))
            xl = sn.shard(a)
            rt = ntt.u32_to_numpy(sn.gather(sn.inv(sn.fwd(xl))))
            prod = ntt.u32_to_numpy(sn.negacyclic_mul(a, b)).astype(np.uint64)
            want = np.stack([ntt.poly_mul_host(a[i].astype(np.uint64), b[i].astype(np.uint64), q)
                             for i, q in enumerate(mods)])
            if not (np.array_equal(rt, a) and np.array_equal(prod, want)):
                raise AssertionError(f"ShardedNtt wrong at N={n}, {k} limbs")
            stats["ntt"][n] = {"limbs": k, "n1": sn.plan.n1, "n2": sn.plan.n2, "plan_s": plan_s}
            operands[n], shardeds[n] = (xl, a), sn
        stats["sharded_ntt_checks_s"] = time.perf_counter() - t0

        params = bfv.large_params(data_limbs=3, seed=9)
        ca, cb = bfv.Context(params), bfv.Context(params)
        pk_host, stats["keygen_host_s"] = timed(lambda: ca.keygen_public(ca.keygen_secret()))
        sk_b = cb.keygen_secret()
        pk_mesh, stats["keygen_mesh_s"] = timed(lambda: cb.keygen_public(sk_b, mesh=poly))
        if pk_host.data.tobytes() != pk_mesh.data.tobytes():
            raise AssertionError("keygen_public(mesh=) differs from the host path")
        v = np.arange(100, dtype=np.int64)
        if not np.array_equal(cb.decode(cb.decrypt(sk_b, cb.encrypt(pk_mesh, cb.encode(v))))[:100], v):
            raise AssertionError("the sharded keygen's public key does not encrypt")

        tc.clear_caches()
        whole, stats["decompose_s"] = timed(lambda: wk.csp_decompose(stack, enc_key, sym, nonce=nonce))
        tc.clear_caches()
        split, stats["decompose_mesh_s"] = timed(
            lambda: wk.csp_decompose(stack, enc_key, sym, nonce=nonce, mesh=mesh))
        if not torch.equal(whole.data, split.data):
            raise AssertionError("csp_decompose(mesh=) differs from the unsplit result")
        one = bfv.Ciphertext(split.data[:, 5])
        if not np.array_equal(ctx.decode(ctx.decrypt(stack.sk, one))[: transcipher.T], x[5]):
            raise AssertionError("a sample of csp_decompose(mesh=) decrypts wrong")
        tc.clear_caches()
    launches = launch_counts()
    ms = {(shape[-1], name) for name in ("ntt_fwd", "ntt_inv") for shape, _ in rec.calls[name]}
    for m in (128, 256):
        for name in ("ntt_fwd", "ntt_inv"):
            if (m, name) not in ms:
                raise AssertionError(f"{name} did not launch at M={m} on the parallel path")
    if min(launches[k] for k in ("mont_mul", "mont_mac", "mod_elem", "mod_down")) == 0:
        raise AssertionError(f"a modular kernel did not launch on the parallel path: {launches}")
    log(f"parallel ({stats['backend']}, world {stats['world_size']}): ShardedNtt at "
        f"{[n for n, _ in PARALLEL_NTTS]} equal to poly_mul_host, sharded keygen equal to the "
        f"host's, csp_decompose(mesh=) equal to the unsplit one; launches {launches}")

    # outside the counted run: the PASTA block expansion, native against Python
    if not native.available() or pasta.EXPANSIONS["python"] or not pasta.EXPANSIONS["native"]:
        raise AssertionError(f"the native PASTA expansion is not the one in use: {pasta.EXPANSIONS}")
    pasta.block_randomness.cache_clear()
    nat, stats["block_randomness_native_ms"] = timed(lambda: pasta.block_randomness(ctx.t, nonce, 1))
    pure, stats["block_randomness_python_ms"] = timed(
        lambda: pasta.block_randomness_python(ctx.t, nonce, 1))
    stats["block_randomness_native_ms"] *= 1e3
    stats["block_randomness_python_ms"] *= 1e3
    if not all(np.array_equal(g, w) for gs, ws in zip(nat, pure) for g, w in zip(gs, ws)):
        raise AssertionError("native and Python PASTA expansions differ")
    stats["expansions"] = dict(pasta.EXPANSIONS)

    # the sharded transforms against the single-card NTT on the same [k, N]
    for n, (xl, a) in operands.items():
        sn = shardeds[n]
        tb = ntt.build_tables(sn.moduli, n, xl.device)
        fl = sn.fwd(xl)
        stats["ntt"][n].update(
            sharded_fwd_ms=cuda_ms(lambda: sn.fwd(xl), 10),
            sharded_inv_ms=cuda_ms(lambda: sn.inv(fl), 10),
            single_fwd_ms=cuda_ms(lambda: ntt.ntt_fwd(xl, tb), 10),
            single_inv_ms=cuda_ms(lambda: ntt.ntt_inv(xl, tb), 10),
        )
    del operands, shardeds
    dist.destroy_process_group()
    stats["wall_s"] = time.perf_counter() - t_phase
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    return stats, launches, rec.calls


def phase_limb(stack):
    """The limb path (``parallel.limb_shard``) at world size 1 on the card:
    a one-rank NCCL group and the ("batch": 1, "limb": 1) mesh, on the ECG
    stack (N=16384, 13 limbs, device keygen), B=64 samples.  First the
    unsplit path (outside the counted run): one keystream block, the
    finish (``csp_decompose``), ``csp_eval_1fc`` without and with the
    log-depth sum.  Then, counted: the same through the limb view, the
    encrypted key placed by ``shard_limbs``, the FC on the decomposed batch
    placed by ``shard_ciphertext_batch``, each result gathered.  The view
    must be split (limbs 0..12 in one block: a view that kept its limbs
    whole where the mesh divides them fails), every result must equal the
    unsplit one bit for bit, the predictions the plaintext model's and the
    summed slots x @ w mod t, and K1-K6 must launch.  Then, outside the
    counted run, keystream and FC times split and unsplit, the all-gathers
    (and bytes) of a keystream block, and the bytes of the key set each
    rank holds against the whole set's."""
    import torch
    import torch.distributed as dist

    from hhe_tpu_torch.models import pocketnn
    from hhe_tpu_torch.ops import bfv, pasta, transcipher
    from hhe_tpu_torch.parallel import mesh as hmesh
    from hhe_tpu_torch.workloads import hhe_inference as wk

    t_phase = time.perf_counter()
    stats = {}
    mesh = hmesh.make_hhe_mesh()
    stats["backend"], stats["mesh"] = dist.get_backend(), mesh.shape
    ctx, tc = stack.ctx, stack.tc
    rng = np.random.default_rng(13)
    x = rng.integers(0, 64, (B, transcipher.T))
    w = rng.integers(-508, 509, transcipher.T)
    key = pasta.get_fixed_symmetric_key()
    nonce = 90_000
    sym = pasta.Pasta(key, ctx.t).encrypt(x.astype(np.uint64), nonce=nonce)
    enc_key = tc.encrypt_key(stack.pk, key)
    wct = bfv.Ciphertext(helin_weight(stack, w).data[:, None])

    # the unsplit path on the same inputs
    tc.clear_caches()
    ks, stats["keystream_unsplit_first_s"] = timed(lambda: tc.keystream_ct(enc_key, nonce, 0))
    dec, stats["finish_unsplit_s"] = timed(lambda: wk.csp_decompose(stack, enc_key, sym, nonce=nonce))
    prod, stats["csp_eval_1fc_unsplit_s"] = timed(lambda: wk.csp_eval_1fc(stack, dec, wct, do_sum=False))
    summed, stats["csp_eval_1fc_sum_unsplit_s"] = timed(
        lambda: wk.csp_eval_1fc(stack, dec, wct, do_sum=True))

    tcl, stats["view_build_s"] = timed(lambda: tc.on_limbs(mesh))
    view = tcl.ctx
    if not (view.split and view.limbs == range(ctx.k) and tcl is not tc):
        raise AssertionError(f"the limb view did not split where the mesh divides the limbs: {view}")
    key_l = hmesh.shard_limbs(enc_key, mesh)
    if key_l.data.shape != (2, len(view.limbs), ctx.n):
        raise AssertionError(f"shard_limbs placed {tuple(key_l.data.shape)}")

    reset_launches()
    with ShapeRecorder() as rec:
        t0 = time.perf_counter()
        ks_l = tcl.keystream_ct(key_l, nonce, 0)
        dec_l = wk.csp_decompose(stack, key_l, sym, nonce=nonce, mesh=mesh)
        ct_l = hmesh.shard_ciphertext_batch(dec_l, mesh)
        prod_l = wk.csp_eval_1fc(stack, ct_l, wct, do_sum=False, mesh=mesh)
        summed_l = wk.csp_eval_1fc(stack, ct_l, wct, do_sum=True, mesh=mesh)
        got = {name: hmesh.gather_batch(hmesh.gather_limbs(t.data, mesh), mesh)
               for name, t in (("prod", prod_l), ("summed", summed_l))}
        got["keystream"] = hmesh.gather_limbs(ks_l.data, mesh)
        torch.cuda.synchronize()
        stats["limb_path_s"] = time.perf_counter() - t0
    launches = launch_counts()
    if min(launches[k] for k in PATH_KERNELS) == 0:
        raise AssertionError(f"a kernel did not launch on the limb path: {launches}")
    for name, want in (("keystream", ks.data), ("prod", prod.data), ("summed", summed.data)):
        if not torch.equal(got[name], want):
            raise AssertionError(f"the limb path's {name} differs from the unsplit path's")
    if not torch.equal(dec_l.data, dec.data):
        raise AssertionError("csp_decompose(mesh=) on the limb view differs from the unsplit one")
    sums = (x.astype(np.int64) * w).sum(1)
    expect = np.where(pocketnn.simple_pocket_sigmoid(sums).numpy() > 64, 128, 0)
    preds = wk.analyst_decrypt_sum_sigmoid(stack, bfv.Ciphertext(got["prod"]), transcipher.T)
    if not np.array_equal(preds, expect):
        raise AssertionError("the limb path's predictions differ from the plaintext model's")
    slot0 = ctx.decode_batch(ctx.decrypt_batch(stack.sk, bfv.Ciphertext(got["summed"])))[:, 0]
    if not np.array_equal(slot0.astype(np.int64), sums % ctx.t):
        raise AssertionError("the limb path's summed slots differ from x @ w mod t")
    log(f"limb ({stats['backend']}, mesh {mesh.shape}): {view}; keystream, decompose, FC and "
        f"summed FC equal to the unsplit path; predictions equal the plaintext model's "
        f"({int((preds == 128).sum())}/{B} positive); launches {launches}")

    # outside the counted run: times split and unsplit, gathers, key bytes
    def keystream(t, k):
        t.clear_caches()
        return t.keystream_ct(k, nonce, 0)

    g0, b0 = view.all_gathers, view.gathered_bytes
    stats["keystream_split_s"] = min(wall_s(lambda: keystream(tcl, key_l)) for _ in range(REPS))
    stats["all_gathers_per_block"] = (view.all_gathers - g0) // REPS
    stats["gathered_bytes_per_block"] = (view.gathered_bytes - b0) // REPS
    stats["keystream_unsplit_s"] = min(wall_s(lambda: keystream(tc, enc_key)) for _ in range(REPS))
    for tag, m, c in (("split", mesh, ct_l), ("unsplit", None, dec)):
        for do_sum in (False, True):
            stats[f"csp_eval_1fc{'_sum' if do_sum else ''}_{tag}_ms"] = 1e3 * min(
                wall_s(lambda: wk.csp_eval_1fc(stack, c, wct, do_sum=do_sum, mesh=m))
                for _ in range(REPS))
    keyset = [stack.rk, *stack.gks.values()]
    bsgs = lambda t: sum(k.nbytes for k in (t.baby_k0, t.baby_k1, t.giant_k0, t.giant_k1))
    stats["key_bytes_rank"] = view.key_bytes(keyset) + bsgs(tcl)
    stats["key_bytes_whole"] = sum(k.k0.nbytes + k.k1.nbytes for k in keyset) + bsgs(tc)
    stats["rk_rows_rank"] = list(view.take_key(stack.rk).k0.shape)
    tc.clear_caches()
    dist.destroy_process_group()
    stats["wall_s"] = time.perf_counter() - t_phase
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    return stats, launches, rec.calls


def reference_files(tmp, **arrays):
    """Write each array as a reference-layout CSV (``save_csv_matrix``) in
    directory `tmp`; returns {name: path}."""
    from hhe_tpu_torch.models import pocketnn

    paths = {}
    for name, arr in arrays.items():
        paths[name] = os.path.join(tmp, f"{name}.csv")
        pocketnn.save_csv_matrix(paths[name], arr)
    return paths


def debug_budgets(fn) -> dict:
    """Run fn() with RunConfig's debugging prints captured; returns
    {stage: noise budget bits} as printed."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        fn()
    log(printed.getvalue().rstrip())
    return {k: int(v) for k, v in
            re.findall(r"noise budget after (.+?): (-?\d+) bits", printed.getvalue())}


def phase_1fc():
    """The SpO2 1FC path: ``hhe_1fc_inference`` on B samples of L=300 words
    (three PASTA blocks, then mask, flatten, ct x ct, relinearize and the
    log-depth vec-sum), its hard parity check raising on any difference;
    the noise budget after decompose+flatten and after FC+sum from a first
    run (which captures the units), then the recorded run (which replays
    them): its launches and the experiment report's per-party ms and
    per-edge MB."""
    import torch

    from hhe_tpu_torch.ops import bfv
    from hhe_tpu_torch.utils.config import RunConfig
    from hhe_tpu_torch.workloads import hhe_inference as wk

    t0 = time.perf_counter()
    stack = wk.build_stack(
        bfv.BFVParams(n=16384, data_limbs=FC_LIMBS, seed=1), input_len=FC_L,
        device_keygen=True, seed=1,
    )
    torch.cuda.synchronize()
    stats = {"limbs": FC_LIMBS, "setup_s": time.perf_counter() - t0, "galois_keys": len(stack.gks)}
    rng = np.random.default_rng(0)
    w = rng.integers(-3, 4, FC_L)
    x = rng.integers(0, 32, (B, FC_L))
    # the stage budgets, as RunConfig's debugging prints them, from a first
    # run (it captures the units), so that the host's noise budgets stay out
    # of the timed report of the second, which replays them
    budgets = debug_budgets(lambda: wk.hhe_1fc_inference(
        stack, w, x, check_parity=True, run=RunConfig(dry_run=False, debugging=True)))
    stats["noise_budget_after_decompose_flatten"] = budgets["decomposition+flatten"]
    stats["noise_budget_after_fc_sum"] = budgets["encrypted FC + vec_sum"]
    reset_launches()
    with ShapeRecorder() as rec:
        t0 = time.perf_counter()
        out = wk.hhe_1fc_inference(stack, w, x, check_parity=True,
                                   run=RunConfig(dry_run=False, verbose=True))
        torch.cuda.synchronize()
        stats["inference_s"] = time.perf_counter() - t0
    launches = launch_counts()
    stats["graphs"] = graph_counts("1fc")
    if min(launches[k] for k in PATH_KERNELS) == 0:
        raise AssertionError(f"a kernel did not launch on the 1FC path: {launches}")
    if not np.array_equal(out["raw"], x.astype(np.int64) @ w):
        raise AssertionError("1FC outputs differ from the plaintext model")
    stats["computation_ms"] = out["report"]["computation_ms"]
    stats["communication_mb"] = out["report"]["communication_mb"]
    log(f"1fc: hhe_1fc_inference B={B} L={FC_L} at N=16384 / {FC_LIMBS} limbs: parity held, "
        f"launches {launches}")
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    return stats, launches, rec.calls


def phase_parties():
    """The three parties in this process, over gRPC on localhost, at the
    production parameters (N=16384, 13 limbs) on the card: the port's
    ``CSP`` / ``CSPServer`` and, for L=300 (SpO2) and L=128 (ECG), an
    ``Analyst`` (host keygen) that encrypts surrogate weights in [-3, 3],
    serves, and publishes its keys and model to the CSP.  A ``User``
    submits B records to each analyst (values below 32 and 16); the CSP
    decomposes them on arrival and writes its checkpoint; then
    ``evaluateModelFromFile`` and, for L=300, ``evaluateModel`` with the
    checkpoint's ciphertexts in repeated ``HHEDecomp`` entries.  Gates: each
    analyst's results equal x @ w exactly and its predictions (x @ w > 0);
    the three secret keys differ; K1-K6 launch."""
    import torch

    from hhe_tpu_torch.ops import bfv
    from hhe_tpu_torch.parties import rpc
    from hhe_tpu_torch.parties.analyst import Analyst, AnalystServer
    from hhe_tpu_torch.parties.csp import CSP, CSPServer
    from hhe_tpu_torch.parties.gen import hhe_pb2 as pb
    from hhe_tpu_torch.parties.user import User
    from hhe_tpu_torch.utils import checks, metrics, serial

    def params(seed):
        return bfv.BFVParams(n=16384, data_limbs=13, seed=seed)

    def csp_s():  # the CSP's own synchronised wall in decompose and evaluate
        return csp.timer.phases.get("csp", 0.0)

    def call(method, msg):
        client = rpc.csp_client(PARTY_CSP)
        try:
            return timed(lambda: client.call(method, msg))[1]
        finally:
            client.close()

    rng = np.random.default_rng(15)
    stats = {"n": 16384, "limbs": 13, "batch": B, "analysts": {}}
    servers, users, analysts, checkpoints = [], [], [], {}
    tmp = tempfile.TemporaryDirectory()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        with ShapeRecorder() as rec:
            csp, stats["csp_setup_s"] = timed(lambda: CSP(params(2), workdir=tmp.name))
            servers.append(CSPServer(csp, PARTY_CSP))
            for i, (L, hi, addr) in enumerate(PARTY_ANALYSTS):
                st = stats["analysts"][L] = {}
                a, st["keygen_s"] = timed(lambda: Analyst(params(3 + i), input_len=L))
                w = rng.integers(-3, 4, (L, 1))
                _, st["encrypt_model_s"] = timed(lambda: a.encrypt_model(w))
                srv = AnalystServer(a, addr)
                servers.append(srv)
                _, st["publish_s"] = timed(lambda: srv.publish_to_csp(PARTY_CSP))
                st["publish_mb"] = a.ledger.edges["analyst-csp"]
                analysts.append((L, hi, addr, a, srv, w))
            keys = [t[3].sk for t in analysts] + [csp.sk]
            for sk1, sk2 in itertools.combinations(keys, 2):
                checks.are_same_he_sk(sk1, sk2)  # raises if two are equal

            for i, (L, hi, addr, a, srv, w) in enumerate(analysts):
                st = stats["analysts"][L]
                x = rng.integers(0, hi, (B, L))
                expect = x.astype(np.int64) @ w.reshape(-1)
                user = User(params(5 + i), data=x)
                users.append(user)
                before = csp_s()
                _, st["submit_s"] = timed(lambda: user.submit(addr, PARTY_CSP, f"p{L}"))
                st["decompose_s"] = csp_s() - before
                path = os.path.join(tmp.name, f"p{L}_{a.uuid}.bin")
                st["checkpoint_mb"] = os.path.getsize(path) / 2**20
                checkpoints[L] = (addr, path)

                requests = [("evaluateModelFromFile", pb.DataFile(filename=os.path.basename(path)))]
                if L == FC_L:  # the checkpoint's ciphertexts, one frame an entry
                    with open(path, "rb") as f:
                        cts = serial.load_ciphertext_vec(f.read(), "cpu")
                    msg = pb.CiphertextBytes(analystID=a.uuid)
                    for ct in cts:
                        msg.HHEDecomp.append(serial.dump_ciphertext_vec([ct]))
                    requests.append(("evaluateModel", msg))
                for method, msg in requests:
                    a.raw_results.clear()
                    a.predictions.clear()
                    srv.results_ready.clear()
                    before = csp_s()
                    wall = call(method, msg)
                    if not srv.results_ready.wait(timeout=PARTY_WAIT_S):
                        raise AssertionError(f"parties: no results for L={L} after {method}")
                    if not (np.array_equal(a.raw_results, expect)
                            and np.array_equal(a.predictions, (expect > 0).astype(int))):
                        raise AssertionError(f"parties: L={L} {method} results differ from x @ w")
                    st[f"{method}_wall_s"] = wall
                    st[f"{method}_eval_ms_per_ct"] = 1e3 * (csp_s() - before) / B
                # one result's noise budget, from the CSP's own evaluation of
                # the first record of its checkpoint (the batch's only copy)
                with open(path, "rb") as f:
                    ct0 = serial.load_ciphertext_vec(f.read(), csp.ctx.device)[0]
                res = csp.evaluate_model(addr, [ct0])[0]
                st["result_noise_budget_bits"] = a.ctx.noise_budget(a.sk, res)
        launches = launch_counts()
        stats["graphs"] = graph_counts("parties")
        stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        # after the path: each analyst's 1FC unit with the sum (the graph
        # that evaluateModel* replayed) against its body, eagerly, on
        # EVAL_EAGER_CTS of its checkpoint's ciphertexts; the unit itself
        # on two of the L=300 checkpoint's, through check_unit
        for L, (addr, path) in checkpoints.items():
            st_csp = csp.state(addr)
            stk = st_csp.stack
            unit = stk._jit_1fc_True
            with open(path, "rb") as f:
                cts = serial.load_ciphertext_vec(f.read(), csp.ctx.device)[:EVAL_EAGER_CTS]
            args = [(ct.data, st_csp.weight_cts[0].data, stk.rk, stk.gks) for ct in cts]
            stats["analysts"][L]["eval_eager_ms_per_ct"] = 1e3 * wall_s(
                lambda: [unit.fn(*a) for a in args]) / len(args)
            if L == FC_L:
                stats["graph_unit_eval_1fc"] = check_unit(unit, args[0], args[1])
        everyone = [t[3] for t in analysts] + users + [csp]
        timer, ledger = metrics.merge(timers=[p.timer for p in everyone],
                                      ledgers=[p.ledger for p in everyone])
        report = metrics.experiment_report(timer, ledger, accuracy=1.0)
        log(metrics.format_experiment_report(report))
        stats["computation_ms"] = report["computation_ms"]
        stats["communication_mb"] = report["communication_mb"]
    finally:
        for srv in servers:
            srv.stop()
        tmp.cleanup()
    log(f"parties: CSP + analysts L=300 / L=128 + users at N=16384 / 13 limbs, B={B}, over gRPC: "
        f"results equal x @ w, keys differ, launches {launches}")
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    if min(launches[k] for k in PATH_KERNELS) == 0:
        raise AssertionError(f"a kernel did not launch on the parties' path: {launches}")
    return stats, launches, rec.calls


class CliParty:
    """One ``python -m hhe_tpu_torch.parties.cli`` process; its output lines
    are collected on a thread."""

    def __init__(self, *args):
        import queue
        import sys
        import threading

        self.name = args[0]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "hhe_tpu_torch.parties.cli", *args],
            cwd=os.path.dirname(os.path.abspath(__file__)), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        self.lines, self.seen = queue.Queue(), []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)

    def wait_for(self, pattern, timeout=PARTY_WAIT_S):
        """The first match of `pattern` in a line not yet searched."""
        import queue

        rx, end = re.compile(pattern), time.perf_counter() + timeout
        while True:
            try:
                line = self.lines.get(timeout=max(0.0, end - time.perf_counter()))
            except queue.Empty:
                raise AssertionError(f"cli {self.name}: no {pattern!r} in {timeout} s; "
                                     f"output: {self.output()[-4000:]}") from None
            self.seen.append(line)
            m = rx.search(line)
            if m:
                return m

    def output(self) -> str:
        """Every line the process has printed so far."""
        while not self.lines.empty():
            self.seen.append(self.lines.get())
        return "".join(self.seen)

    def stop(self):
        """SIGINT, as Ctrl-C; the exit code (the process is killed if it
        outlives a minute)."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode


def phase_cli():
    """The CLI as three processes on the card at its defaults (N=16384,
    13 limbs, --input-len 300, --rows 2), surrogate weights in [-3, 3] and
    four records below 32 in temporary CSVs: csp, then analyst (keygen,
    model, publish), then user (submit; the CSP decomposes and
    checkpoints); then ``evaluateModelFromFile`` on the checkpoint, and the
    analyst's printed predictions must equal the plain model's; both servers
    must exit 0 on SIGINT.  Any nonzero exit or timeout fails."""
    import sys

    from hhe_tpu_torch.models import pocketnn
    from hhe_tpu_torch.parties import rpc
    from hhe_tpu_torch.parties.gen import hhe_pb2 as pb

    rng = np.random.default_rng(22)  # predictions [1, 0]
    w = rng.integers(-3, 4, (FC_L, 1))
    x = rng.integers(0, 32, (4, FC_L))
    expect = (x[:2].astype(np.int64) @ w.reshape(-1) > 0).astype(int).tolist()
    stats, parties = {}, []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        weights, data = os.path.join(tmp, "weights.csv"), os.path.join(tmp, "c000101_data.txt")
        pocketnn.save_csv_matrix(weights, w)
        pocketnn.save_csv_matrix(data, x)
        try:
            parties.append(CliParty("csp", CLI_CSP, "--workdir", tmp))
            parties[0].wait_for(r"\[CSP\] serving on")
            stats["csp_up_s"] = time.perf_counter() - t0
            analyst = CliParty("analyst", CLI_ANALYST, CLI_CSP, "--weights", weights,
                               "--input-len", str(FC_L))
            parties.append(analyst)
            uuid = analyst.wait_for(r"\[Analyst\] uuid=(\S+)")[1]
            analyst.wait_for(r"\[Analyst\] ready")
            stats["analyst_ready_s"] = time.perf_counter() - t0
            user = subprocess.run(
                [sys.executable, "-m", "hhe_tpu_torch.parties.cli", "user", CLI_ANALYST, CLI_CSP,
                 "--data", data, "--rows", "2"],
                cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                timeout=PARTY_WAIT_S)
            log(user.stdout.rstrip())
            if user.returncode:
                raise AssertionError(f"cli user exited {user.returncode}: {user.stderr[-4000:]}")
            stats["user_done_s"] = time.perf_counter() - t0
            client = rpc.csp_client(CLI_CSP)
            client.call("evaluateModelFromFile", pb.DataFile(filename=f"c000101_{uuid}.bin"))
            client.close()
            # the analyst prints what it has every 5 s, so wait for a line
            # with a prediction for each row
            got = analyst.wait_for(r"predictions so far: \[(%s)\]"
                                   % ", ".join([r"-?\d+"] * len(expect)))[1]
            stats["predictions_s"] = time.perf_counter() - t0
            stats["predictions"] = [int(v) for v in got.split(",")]
            if stats["predictions"] != expect:
                raise AssertionError(f"cli predictions {stats['predictions']} != plain {expect}")
            for p in reversed(parties):
                rc = p.stop()
                if rc != 0:
                    raise AssertionError(f"cli {p.name} exited {rc} on SIGINT")
        finally:
            for p in parties:
                if p.proc.poll() is None:
                    p.proc.kill()
                    p.proc.wait()
                log("".join(f"  [{p.name} out] {ln}" for ln in p.output().splitlines(True)).rstrip())
    stats["wall_s"] = time.perf_counter() - t0
    log(f"cli: csp, analyst and user as three processes at N=16384 / 13 limbs: predictions "
        f"{stats['predictions']} equal the plain model's; {stats}")
    return stats


def phase_ecg_full(stack, samples):
    """The full-dataset ECG run on the ECG phase's stack:
    ``hhe_ecg_full_inference`` with surrogate ecg_512 weights in
    [-508, 508] and a 13,245-row label file (temporary CSVs), `samples` of
    them (RunConfig's dry run; all with 0) in chunks of 512 samples, the
    product in slices of 64, one batched decrypt per chunk.  Its agreement
    with the plaintext model must be 1.0 and K1-K6 must launch."""
    import torch

    from hhe_tpu_torch.ops import transcipher
    from hhe_tpu_torch.utils.config import RunConfig
    from hhe_tpu_torch.workloads import hhe_inference as wk

    rng = np.random.default_rng(12)
    run = RunConfig(dry_run=True, dry_run_num_samples=samples) if samples else None
    with tempfile.TemporaryDirectory() as tmp:
        files = reference_files(tmp, fc1_weight=rng.integers(-508, 509, (transcipher.T, 1)))
        np.savetxt(os.path.join(tmp, "mitbih_bin_y_test.csv"),
                   rng.integers(0, 2, MITBIH_TEST_ROWS), fmt="%d")
        stack.tc.clear_caches()  # so that the round material is expanded again, by a replay
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with ShapeRecorder() as rec:
            out, wall = timed(lambda: wk.hhe_ecg_full_inference(
                stack, files["fc1_weight"], batch=ECG_FULL_BATCH, eval_batch=B, run=run,
                labels_root=tmp))
        launches = launch_counts()
        graph_stats = graph_counts("ecg_full")
    rep = out["report"]
    stats = {"samples": rep["samples"], "batch": ECG_FULL_BATCH, "eval_batch": B,
             "wall_s": wall, "samples_per_s": rep["samples"] / wall,
             "agreement": out["agreement"],
             "computation_ms": rep["computation_ms"], "communication_mb": rep["communication_mb"],
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "graphs": graph_stats}
    log(f"ecg_full: hhe_ecg_full_inference over {rep['samples']} samples, launches {launches}")
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    if out["agreement"] != 1.0:
        raise AssertionError(f"full ECG run: agreement {out['agreement']} with the plaintext model")
    if min(launches[k] for k in PATH_KERNELS) == 0:
        raise AssertionError(f"a kernel did not launch on the full ECG run: {launches}")
    return stats, launches, rec.calls


def phase_mod_switch(stack, ct, values):
    """``mod_switch_to_next`` from 13 limbs down to one on a decomposed ECG
    sample: at every level it must decrypt to its 128 values; its noise
    budget per level and ``cipher_size`` before and after."""
    from hhe_tpu_torch.ops import transcipher
    from hhe_tpu_torch.utils import metrics

    ctx, sk = stack.ctx, stack.sk
    stats = {"cipher_size_mb": metrics.cipher_size(ctx, ct),
             "cipher_size_mb_one_limb": metrics.cipher_size(ctx, ct, mod_switch=True),
             "budget_by_limbs": {}, "switch_ms": []}
    while ct.data.shape[-2] > 1:
        ct, dt = timed(lambda: ctx.mod_switch_to_next(ct))
        limbs = ct.data.shape[-2]
        stats["switch_ms"].append(1e3 * dt)
        stats["budget_by_limbs"][limbs] = ctx.noise_budget(sk, ct)
        if not np.array_equal(ctx.decode(ctx.decrypt(sk, ct))[: transcipher.T], values):
            raise AssertionError(f"mod-switched sample decrypts wrong at {limbs} limbs")
    if ct.data.device.type != "cuda":
        raise AssertionError("mod_switch_to_next left the card")
    log(f"mod_switch: 13 -> 1 limbs, every level decrypts to the sample; {stats}")
    return stats


def phase_fmnist():
    """The FashionMNIST one-layer path: ``hhe_fmnist_1fc_inference`` at
    N=16384 / FMNIST_LIMBS limbs on B=4 surrogate inputs in [0, 4] through
    the transcipher (7 blocks, mask, flatten), 784 x 10 surrogate weights
    and 10 biases in [-128, 128] (temporary CSVs), its hard mod-t parity;
    the experiment report; the stage budgets from a second run with
    RunConfig's debugging."""
    import torch

    from hhe_tpu_torch.ops import bfv
    from hhe_tpu_torch.utils.config import RunConfig
    from hhe_tpu_torch.workloads import hhe_inference as wk

    stack, setup_s = timed(lambda: wk.build_stack(
        bfv.BFVParams(n=16384, data_limbs=FMNIST_LIMBS, seed=1), input_len=784,
        device_keygen=True, seed=1))
    rng = np.random.default_rng(13)
    stats = {"limbs": FMNIST_LIMBS, "batch": MNIST_B, "setup_s": setup_s}
    with tempfile.TemporaryDirectory() as tmp:
        files = reference_files(tmp, weight=rng.integers(-128, 129, (784, 10)),
                                bias=rng.integers(-128, 129, (1, 10)))

        def run(cfg=None):
            return wk.hhe_fmnist_1fc_inference(
                stack, batch=MNIST_B, via_transcipher=True, check_parity=True, run=cfg,
                weight_csv=files["weight"], bias_csv=files["bias"])

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with ShapeRecorder() as rec:
            out, stats["inference_s"] = timed(run)
        launches = launch_counts()
        stats["graphs"] = graph_counts("fmnist_1fc")
        stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        budgets = debug_budgets(lambda: run(RunConfig(dry_run=False, debugging=True)))
    stats["computation_ms"] = out["report"]["computation_ms"]
    stats["communication_mb"] = out["report"]["communication_mb"]
    stats["noise_budget_after_decompose_flatten"] = budgets["decomposition+flatten"]
    stats["noise_budget_after_fc"] = budgets["fmnist 1fc eval"]
    log(f"fmnist_1fc: B={MNIST_B}, 784 -> 10 + bias at N=16384 / {FMNIST_LIMBS} limbs: "
        f"parity held, launches {launches}")
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    if min(launches[k] for k in PATH_KERNELS) == 0:
        raise AssertionError(f"a kernel did not launch on the FMNIST path: {launches}")
    return stats, launches, rec.calls


class PhaseTimer:
    """Times calls of the named functions of `module` (device synchronised
    before and after each), summed per name, while the context is open."""

    def __init__(self, module, names):
        self.mod, self.orig = module, {n: getattr(module, n) for n in names}
        self.seconds = dict.fromkeys(names, 0.0)

    def __enter__(self):
        for name, fn in self.orig.items():
            def rec(*args, _fn=fn, _name=name, **kw):
                out, dt = timed(lambda: _fn(*args, **kw))
                self.seconds[_name] += dt
                return out
            setattr(self.mod, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def phase_mnist_2fc():
    """The MNIST 2FC path, the most demanding model of the repo:
    ``hhe_2fc_inference`` 784 -> 128 -> square -> 10 on B=4 surrogate 2-bit
    images (levels 0-4, ~80% zeros) with 2-bit signed surrogate weights in
    [-2, 1], through the transcipher (7 blocks, mask, flatten), at N=16384
    with MNIST_LIMBS limbs (below 128-bit security: the JAX package's flag),
    MNIST_ROW_CHUNK hidden rows a pass, its hard mod-t parity.  An untimed
    warm-up with RunConfig's debugging gives the stage budgets; then, the
    keystream caches cleared, the timed run (a new key ciphertext, so its
    seven keystream blocks are evaluated again): inferences/s over the
    transcipher and the fc1/square/fc2 pass, and the peak memory; then the
    same call at twice MNIST_ROW_CHUNK, its peak memory or "out of memory"."""
    import torch

    from hhe_tpu_torch.ops import bfv
    from hhe_tpu_torch.utils.config import RunConfig
    from hhe_tpu_torch.workloads import hhe_inference as wk

    stack, setup_s = timed(lambda: wk.build_stack(
        bfv.BFVParams(n=16384, data_limbs=MNIST_LIMBS, seed=1), input_len=784,
        device_keygen=True, seed=1))
    rng = np.random.default_rng(14)
    w1 = rng.integers(-2, 2, (784, 128))
    w2 = rng.integers(-2, 2, (128, 10))
    x = rng.integers(0, 5, (MNIST_B, 784)) * (rng.random((MNIST_B, 784)) >= 0.8)

    def run(cfg=None):
        return wk.hhe_2fc_inference(stack, w1, w2, x, via_transcipher=True, check_parity=True,
                                    row_chunk=MNIST_ROW_CHUNK, run=cfg)

    stats = {"limbs": MNIST_LIMBS, "batch": MNIST_B, "row_chunk": MNIST_ROW_CHUNK,
             "sec_level": "below-128-bit (16 x 30-bit limbs at N=16384; the JAX "
                          "package's mnist_2fc_sec_level)",
             "setup_s": setup_s, "input_zero_share": float(np.mean(x == 0))}
    budgets, stats["warmup_s"] = timed(
        lambda: debug_budgets(lambda: run(RunConfig(dry_run=False, debugging=True))))
    stats["noise_budget_after_decompose_flatten"] = budgets["decomposition+flatten"]
    stats["noise_budget_after_2fc"] = budgets["2FC eval"]
    stack.tc.clear_caches()
    free_device()
    reset_launches()
    with ShapeRecorder() as rec, PhaseTimer(wk, ("csp_decompose", "csp_eval_2fc")) as pt:
        out, stats["inference_s"] = timed(run)
    launches = launch_counts()
    stats["graphs"] = graph_counts("mnist_2fc")
    # the peak with the units' graphs (the seeded keystream's among them) alive
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    stats["graph_pool_gib"] = pool_bytes(stack.ctx) / 2**30
    stats["transcipher_s"] = pt.seconds["csp_decompose"]
    stats["eval_2fc_s"] = pt.seconds["csp_eval_2fc"]
    stats["inferences_per_s"] = MNIST_B / (stats["transcipher_s"] + stats["eval_2fc_s"])
    stats["predictions"] = out["predictions"].tolist()
    # whether twice the rows a pass fit the card (parity still checked)
    free_device()
    try:
        wk.hhe_2fc_inference(stack, w1, w2, x, via_transcipher=True, check_parity=True,
                             row_chunk=2 * MNIST_ROW_CHUNK)
        stats[f"peak_mem_gib_row_chunk_{2 * MNIST_ROW_CHUNK}"] = torch.cuda.max_memory_allocated() / 2**30
    except torch.cuda.OutOfMemoryError:
        stats[f"peak_mem_gib_row_chunk_{2 * MNIST_ROW_CHUNK}"] = "out of memory"
    free_device()
    stats["graph_units"] = phase_graphs(stack, MNIST_B, with_eval=False)
    log(f"mnist_2fc: B={MNIST_B}, 784 -> 128 -> square -> 10 at N=16384 / {MNIST_LIMBS} limbs, "
        f"row_chunk {MNIST_ROW_CHUNK}: parity held, launches {launches}")
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    if min(launches[k] for k in PATH_KERNELS) == 0:
        raise AssertionError(f"a kernel did not launch on the 2FC path: {launches}")
    return stats, launches, rec.calls


def write_mnist_idx(root, images, labels):
    """The MNIST test split's two idx files, as ``loaders.load_mnist_test``
    reads them."""
    import struct

    with open(os.path.join(root, "t10k-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, len(images), 28, 28))
        f.write(np.asarray(images, np.uint8).tobytes())
    with open(os.path.join(root, "t10k-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + np.asarray(labels, np.uint8).tobytes())


def phase_he_conv():
    """The encrypted HCNN: ``he_mnist_conv_inference`` at the JAX package's
    parameters (N=16384, HCNN_LIMBS limbs, the 47-bit ``conv_plain_t``) on
    surrogate MNIST idx files (HCNN_TRAIN + 200 numpy-seeded images in
    0-255, labels 0-9) in a temporary directory: QAT of the conv(1->5) ->
    square -> conv(5->50) -> square -> fc(800->10) model on the card
    (HCNN_EPOCHS epochs), device keygen, the conv and FC plaintexts, then
    HCNN_IMAGES encrypted images.  Gates: the encrypted logits equal the
    integer model's (the workload raises otherwise), noise budget left after
    the FC, K1-K6 launched.  Records the Galois key count, the QAT,
    keygen and plaintext seconds, per image the host encryption, device
    evaluation and decrypt/decode seconds, the seconds in each heconv
    function, the budget after each stage and the peak memory."""
    import torch

    from hhe_tpu_torch.ops import heconv
    from hhe_tpu_torch.workloads import he_conv

    rng = np.random.default_rng(16)
    total = HCNN_TRAIN + 200
    stages = ("conv_plaintexts", "fc_plaintexts", "he_conv2d", "he_square", "he_fc_from_conv")
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        write_mnist_idx(tmp, rng.integers(0, 256, (total, 784)), rng.integers(0, 10, total))
        reset_launches()
        with ShapeRecorder() as rec, PhaseTimer(heconv, stages) as pt:
            rep, wall = timed(lambda: he_conv.he_mnist_conv_inference(
                n_images=HCNN_IMAGES, train_subset=HCNN_TRAIN, epochs=HCNN_EPOCHS, n=16384,
                data_limbs=HCNN_LIMBS, mnist_root=tmp))
        launches = launch_counts()
    stats = {"limbs": HCNN_LIMBS, "t_bits": he_conv.conv_plain_t(16384).bit_length(),
             "wall_s": wall, **dataclasses.asdict(rep),
             # synchronised seconds in each heconv function, summed over the run
             # (both convs, both squares, every image)
             "heconv_s": pt.seconds,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"he_conv: HCNN on {HCNN_IMAGES} encrypted images at N=16384 / {HCNN_LIMBS} limbs, "
        f"{stats['t_bits']}-bit t: logits equal the integer model's, launches {launches}")
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    if not (rep.he_matches_int and rep.noise_left > 0):
        raise AssertionError(f"HCNN: parity {rep.he_matches_int}, {rep.noise_left} bits left")
    if min(launches[k] for k in PATH_KERNELS) == 0:
        raise AssertionError(f"a kernel did not launch on the HCNN path: {launches}")
    return stats, launches, rec.calls


def phase_large_chain():
    """Large preset, part (a): the full 58-limb chain at N = 65536 (the
    counterpart of tests/test_large_preset.py::test_full_58_limb_chain_keygen_rotation):
    encrypt 300 values, decrypt them with > 1000 bits of noise budget, device
    keygen of the galois key for step -1, rotate_rows by -1 (a hybrid
    key-switch over 59 moduli), budget still > 1000 bits and the rolled
    vector back.  The tile kernels and the top passes must launch."""
    import torch

    from hhe_tpu_torch.ops import bfv, bfv_eval

    stats = {}
    t0 = time.perf_counter()
    ctx = bfv.Context(bfv.large_params(seed=7))  # three NTT table sets: 58, 59, 60 limbs
    stats["context_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sk = ctx.keygen_secret()
    pk = ctx.keygen_public(sk)
    stats["host_keys_s"] = time.perf_counter() - t0
    if (ctx.k, ctx.n) != (58, 65536):
        raise AssertionError(f"large preset has {ctx.k} limbs at N={ctx.n}")
    v = np.random.default_rng(8).integers(0, ctx.t, 300, dtype=np.int64)
    t0 = time.perf_counter()
    ct = ctx.encrypt(pk, ctx.encode(v))
    stats["encrypt_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats["noise_budget_fresh"] = ctx.noise_budget(sk, ct)
    stats["noise_budget_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = ctx.decode(ctx.decrypt(sk, ct))[:300]
    stats["decrypt_s"] = time.perf_counter() - t0
    if stats["noise_budget_fresh"] <= 1000 or not np.array_equal(dec, v):
        raise AssertionError(f"58-limb encryption wrong or noisy ({stats['noise_budget_fresh']} bits)")

    reset_launches()
    g = ctx.galois_elt_from_step(-1)
    with ShapeRecorder() as rec:
        (_, gks), stats["galois_key_s"] = timed(
            lambda: ctx.keygen_eval_keys_device(sk, [g], include_relin=False, seed=7))
        rot, stats["rotate_s"] = timed(lambda: bfv_eval.rotate_rows(ctx, ct, -1, gks))
    launches = launch_counts()
    stats["galois_key_gib"] = 2 * gks[g].k0.numel() * 4 / 2**30
    stats["noise_budget_rotated"] = ctx.noise_budget(sk, rot)
    half = ctx.n // 2
    vv = np.zeros(ctx.n, np.uint64)
    vv[:300] = v
    expect = np.roll(vv.reshape(2, half), 1, axis=1).reshape(-1)
    if stats["noise_budget_rotated"] <= 1000 or not np.array_equal(
            ctx.decode(ctx.decrypt(sk, rot)), expect):
        raise AssertionError(f"58-limb rotation wrong or noisy ({stats['noise_budget_rotated']} bits)")
    if min(launches[k] for k in PATH_KERNELS + TOP_KERNELS) == 0:
        raise AssertionError(f"a kernel did not launch on the 58-limb chain: {launches}")
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"large preset (a): N=65536, 58 limbs, t={ctx.t}: encrypt, decrypt, device galois key, "
        f"rotate_rows(-1) right; launches {launches}")
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    return stats, launches, rec.calls


def phase_rotation_32768():
    """N = 32768 through the entry points: ``default_context(32768)`` (26
    limbs), a device galois key, ``rotate_rows`` by -1 on an encrypted
    vector and the rolled vector back; the shapes and layouts it gives K1-K4
    go to the kernel phase."""
    from hhe_tpu_torch.ops import bfv, bfv_eval

    ctx = bfv.default_context(32768, seed=3)
    sk = ctx.keygen_secret()
    pk = ctx.keygen_public(sk)
    v = np.random.default_rng(9).integers(0, ctx.t, ctx.n, dtype=np.int64)
    ct = ctx.encrypt(pk, ctx.encode(v))
    g = ctx.galois_elt_from_step(-1)
    _, gks = ctx.keygen_eval_keys_device(sk, [g], include_relin=False, seed=3)
    reset_launches()
    with ShapeRecorder() as rec:
        rot, rotate_s = timed(lambda: bfv_eval.rotate_rows(ctx, ct, -1, gks))
    launches = launch_counts()
    half = ctx.n // 2
    if not np.array_equal(ctx.decode(ctx.decrypt(sk, rot)),
                          np.roll(v.reshape(2, half), 1, axis=1).reshape(-1)):
        raise AssertionError("rotate_rows at N=32768 gives the wrong vector")
    # a rotation's only Montgomery products are K4's contraction and K6's
    # mod-down: it launches no K3
    if min(launches[k] for k in PATH_KERNELS + TOP_KERNELS if k != "mont_mul") == 0:
        raise AssertionError(f"a kernel did not launch at N=32768: {launches}")
    stats = {"limbs": ctx.k, "rotate_s": rotate_s, "noise_budget_rotated": ctx.noise_budget(sk, rot)}
    log(f"N=32768: default_context ({ctx.k} limbs), rotate_rows(-1) right; launches {launches}; "
        f"{stats}")
    bfv.default_context.cache_clear()
    return stats, launches, rec.calls


def large_keystream_setup(limbs, seed=1):
    """The large preset (N = 65536, 29-bit t) cut to `limbs` data limbs:
    the context, device keygen of the transcipher's keys, and the fixed
    PASTA key (mod t) encrypted; returns (ctx, sk, tc, key, enc_key)."""
    from hhe_tpu_torch.ops import bfv, pasta, transcipher

    ctx = bfv.Context(bfv.large_params(data_limbs=limbs, seed=seed))
    sk = ctx.keygen_secret()
    pk = ctx.keygen_public(sk)
    rk, gks = ctx.keygen_eval_keys_device(
        sk, transcipher.galois_elts(ctx), include_relin=True, seed=seed
    )
    tc = transcipher.Transcipher(ctx, rk, gks)
    key = pasta.get_fixed_symmetric_key() % np.uint64(ctx.t)
    return ctx, sk, tc, key, tc.encrypt_key(pk, key)


def keystream_right(ctx, sk, key, ks) -> bool:
    """Whether keystream ciphertext `ks` of block 0 decrypts to the plain
    PASTA keystream."""
    from hhe_tpu_torch.ops import pasta, transcipher

    got = ctx.decode(ctx.decrypt(sk, ks))[: transcipher.T]
    return bool(np.array_equal(got, pasta.keystream(key, ctx.t, pasta.NONCE, 0)))


def phase_large_keystream():
    """Large preset, part (b): one full 3-round keystream block at N = 65536
    with the chain cut to LARGE_KS_LIMBS data limbs (the 58-limb chain's
    ~40 galois keys of 1.79 GB each do not fit the card).  Its decryption
    must equal the plain PASTA keystream; the budget after each round is
    printed and the last must be >= 20 bits.  Then the block's time with a
    fresh nonce per rep (round-material expansion included) and on expanded
    material, synchronised per rep."""
    import torch

    from hhe_tpu_torch.ops import pasta

    stats = {"limbs": LARGE_KS_LIMBS}
    (ctx, sk, tc, key, enc_key), stats["setup_s"] = timed(
        lambda: large_keystream_setup(LARGE_KS_LIMBS))
    stats["galois_keys"] = len(tc.gks_all)

    reset_launches()
    with ShapeRecorder() as rec:
        t0 = time.perf_counter()
        ks = tc.keystream_ct(enc_key, pasta.NONCE, 0)
        torch.cuda.synchronize()
        stats["first_block_s"] = time.perf_counter() - t0
    launches = launch_counts()
    if min(launches[k] for k in PATH_KERNELS + TOP_KERNELS) == 0:
        raise AssertionError(f"a kernel did not launch on the large keystream: {launches}")
    if not keystream_right(ctx, sk, key, ks):
        raise AssertionError("N=65536 keystream block differs from the plain PASTA keystream")
    stats["keystream_round_budgets"] = tc.keystream_round_budgets(enc_key, sk)
    if stats["keystream_round_budgets"][-1] < 20:
        raise AssertionError(f"keystream budget below 20 bits: {stats['keystream_round_budgets']}")
    nonce = 60_000
    stats["block_fresh_nonce_s_by_rep"] = []
    for _ in range(REPS):
        stats["block_fresh_nonce_s_by_rep"].append(
            wall_s(lambda: tc.keystream_ct(enc_key, nonce, 0)))
        nonce += 1
    mats_qp, rcs_pt = tc.device_block_plaintexts(pasta.NONCE, 0)
    keys = tc._keys()
    stats["block_ms"] = 1e3 * min(
        wall_s(lambda: tc._keystream_impl(enc_key.data, mats_qp, rcs_pt, keys))
        for _ in range(REPS)
    )
    stats["block_graph_ms"] = 1e3 * min(
        wall_s(lambda: tc._jit_keystream(enc_key.data, mats_qp, rcs_pt, keys))
        for _ in range(REPS)
    )
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"large preset (b): one keystream block at N=65536, {LARGE_KS_LIMBS} limbs, t={ctx.t}: "
        f"decrypts to the plain PASTA keystream; launches {launches}")
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    stats["profile"] = phase_profile(tc, enc_key, stats["block_ms"], "large keystream",
                                     stats["block_graph_ms"])
    return stats, launches, rec.calls


def pool_bytes(owner) -> int:
    """Bytes of the card's memory in ``owner``'s graph pool: its segments
    in the caching allocator's snapshot."""
    import torch

    handle = getattr(owner, "_graph_pool", None)
    if handle is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(handle))


def check_unit(unit, args_a, args_b) -> dict:
    """A ``utils.graphs`` unit captured afresh, in a pool of its own, on
    inputs ``args_a``: its replay must equal its eager body bit for bit on
    ``args_a`` and then on ``args_b``, and the first replay's result must
    be unchanged by the second (the outputs are clones).  Returns the
    capture's ms, the replay's ms (CUDA events over REPS calls, and the
    least wall of a call with the device synchronised), the body's least
    wall ms, the port's kernel launches inside the graph and the pool's
    GiB."""
    import types

    import torch

    from hhe_tpu_torch.utils import graphs

    owner = types.SimpleNamespace()
    probe = graphs.jit(unit.fn, unit.name, owner)
    first = graphs._tuple(probe(*args_a))  # the body, then the capture
    entry = probe.entry(*args_a)
    want_a, want_b = graphs._tuple(unit.fn(*args_a)), graphs._tuple(unit.fn(*args_b))
    got_a = graphs._tuple(probe(*args_a))
    kept = tuple(t.clone() for t in got_a)
    got_b = graphs._tuple(probe(*args_b))
    torch.cuda.synchronize()
    same = (all(map(torch.equal, first, want_a)) and all(map(torch.equal, got_a, want_a))
            and all(map(torch.equal, got_b, want_b)) and all(map(torch.equal, got_a, kept)))
    if not same or entry.replays != 2:
        raise AssertionError(f"graphs: unit {unit.name}'s replay differs from its body "
                             f"(or did not replay: {entry.replays})")
    row = {"capture_ms": 1e3 * entry.capture_s,
           "replay_ms": cuda_ms(lambda: probe(*args_a), REPS),
           "replay_wall_ms": 1e3 * min(wall_s(lambda: probe(*args_a)) for _ in range(REPS)),
           "eager_ms": 1e3 * min(wall_s(lambda: unit.fn(*args_a)) for _ in range(REPS)),
           "kernels_in_graph": entry.kernels,
           "pool_gib": pool_bytes(owner) / 2**30}
    log(f"graphs: {unit.name}: replay equals its body on two inputs, the first result kept; "
        f"{row}")
    return row


def phase_graphs(stack, batch, with_eval=True) -> dict:
    """The graphs phase on `stack`: each transcipher unit (expand,
    keystream, seeded keystream, finish of `batch` samples) and, with
    ``with_eval``, the 1FC evaluation without the sum on two decomposed
    batches, through ``check_unit``; and the GiB of the stack's own pool,
    which every unit of its context shares."""
    from hhe_tpu_torch.ops import bfv, pasta, transcipher
    from hhe_tpu_torch.workloads import hhe_inference as wk

    tc, ctx = stack.tc, stack.ctx
    enc_key = tc.encrypt_key(stack.pk, pasta.get_fixed_symmetric_key())
    keys = tc._keys()
    rng = np.random.default_rng(16)
    words = [tc.block_words(70_000 + i, [0])[0] for i in range(2)]
    mats, rcs = zip(*(tc._expand_impl(w) for w in words))
    kss = [tc._keystream_impl(enc_key.data, m, r, keys) for m, r in zip(mats, rcs)]
    chunks = [ctx.to_device(rng.integers(0, ctx.t, (batch, transcipher.T)).astype(np.uint64))
              for _ in range(2)]
    cases = [(tc._jit_expand, [(w,) for w in words]),
             (tc._jit_keystream, [(enc_key.data, m, r, keys) for m, r in zip(mats, rcs)]),
             (tc._jit_keystream_seeded, [(enc_key.data, w, keys) for w in words]),
             (tc._jit_finish, list(zip(kss, chunks)))]
    if with_eval:
        data = [tc._finish_impl(k, c) for k, c in zip(kss, chunks)]
        wct = helin_weight(stack, rng.integers(-3, 4, transcipher.T)).data[:, None]
        wk.csp_eval_1fc(stack, bfv.Ciphertext(data[0]), bfv.Ciphertext(wct),
                        do_sum=False)  # the stack's unit, where no earlier call made it
        cases.append((stack._jit_1fc_False, [(d, wct, stack.rk, stack.gks) for d in data]))
    out = {}
    for unit, (a, b) in cases:
        out[unit.name] = check_unit(unit, a, b)
        free_device()
    out["stack_pool_gib"] = pool_bytes(ctx) / 2**30
    log(f"graphs: the stack's shared pool {out['stack_pool_gib']:.3f} GiB")
    return out


def eager_decompose(tc, enc_key, sym, nonce):
    """``Transcipher.decompose`` of one block of B samples through the
    units' bodies: the round-material expansion, the keystream and the
    finish, called eagerly (what ``csp_decompose`` runs at L=128 when no
    unit has a graph)."""
    from hhe_tpu_torch.ops import transcipher

    mats, rcs = tc._expand_impl(tc.block_words(nonce, [0])[0])
    ks = tc._keystream_impl(enc_key.data, mats, rcs, tc._keys())
    chunk = np.asarray(sym, np.uint64)[:, : transcipher.T]
    return tc._finish_impl(ks, tc.ctx.to_device(chunk))


def helin_weight(stack, w):
    from hhe_tpu_torch.ops import helin

    return helin.encrypt_weight(stack.ctx, stack.pk, np.asarray(w)[None, :])[0]


PROFILE_TOP = 12  # kernels of a profile listed by device time
# PyTorch's own passes that K5 / K6 took in: its gathers and index
# selections, torch.where and torch.stack / torch.cat; none may be left in
# a replayed ECG keystream block
PYTORCH_PASSES = ("index_elementwise_kernel", "gather", "scatter", "where_kernel", "CatArray")


def profiled(fn) -> dict:
    """fn() once, then once more under torch.profiler, synchronised: its
    device kernels, busy ms and profiled wall ms, kernels and device ms (and
    share of busy) by ``kernel_family``, and the PROFILE_TOP kernels by
    device time.  The profiler slows the host, so a busy share belongs
    against an unprofiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    fams = {}
    for e in evs:
        fam = kernel_family(e.key)
        for f in [fam] + (["int64 elementwise"] if fam == "elementwise" and "long" in e.key else []):
            v = fams.setdefault(f, {"kernels": 0, "device_ms": 0.0})
            v["kernels"] += e.count
            v["device_ms"] += e.self_device_time_total / 1e3
    for v in fams.values():
        v["share_of_busy"] = v["device_ms"] / busy_ms
    top = [{"device_ms": e.self_device_time_total / 1e3, "count": e.count, "name": e.key[:160]}
           for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:PROFILE_TOP]]
    passes = [{"count": e.count, "device_ms": e.self_device_time_total / 1e3, "name": e.key[:160]}
              for e in evs if any(tag in e.key for tag in PYTORCH_PASSES)]
    return {"kernels": sum(e.count for e in evs), "busy_ms": busy_ms, "profiled_wall_ms": wall_ms,
            "by_family": fams, "top": top, "pytorch_passes": passes}


def phase_profile(tc, enc_key, block_ms, tag, block_graph_ms=None, gate=False):
    """One keystream block of Transcipher `tc`, ``profiled``: replayed
    (``_jit_keystream``, the units' path; CUPTI traces a graph's kernel
    nodes) and, beside it, its eager body; each busy share also against the
    unprofiled ``block_graph_ms`` / ``block_ms``.  Where the replay's
    profile holds no kernel, it says so.  With `gate`, a PyTorch gather,
    index, where or stack kernel (``PYTORCH_PASSES``) left in the replayed
    block fails the run."""
    from hhe_tpu_torch.ops import pasta

    mats_qp, rcs_pt = tc.device_block_plaintexts(pasta.NONCE, 0)
    keys = tc._keys()
    out = {}
    for name, fn, ms in (
            ("replayed", lambda: tc._jit_keystream(enc_key.data, mats_qp, rcs_pt, keys),
             block_graph_ms),
            ("eager", lambda: tc._keystream_impl(enc_key.data, mats_qp, rcs_pt, keys), block_ms)):
        if ms is None:
            continue
        prof = profiled(fn)
        prof["busy_share_of_profiled_wall"] = prof["busy_ms"] / prof["profiled_wall_ms"]
        prof["busy_share_of_unprofiled_ms"] = prof["busy_ms"] / ms
        if prof["kernels"] == 0:
            prof["note"] = "the profiler saw no kernel of the replayed graph"
        log(f"profile ({tag}, {name}): {({k: v for k, v in prof.items() if k != 'top'})}")
        for e in prof["top"]:
            log(f"  {e['device_ms']:9.2f} ms {e['count']:6d}x  {e['name'][:100]}")
        out[name] = prof
        if gate and name == "replayed" and (prof["pytorch_passes"] or not prof["kernels"]):
            raise AssertionError(f"{tag}: PyTorch gathers, wheres or stacks left in the replayed "
                                 f"block (or no kernel seen): {prof['pytorch_passes']}")
    return out


def same_training(card, cpu, what):
    """Two ``TrainResult``s equal bit for bit: history, best accuracy, and
    every tensor of the final and the epoch-best parameters."""
    import torch

    if card.history != cpu.history or card.best_test_acc != cpu.best_test_acc:
        raise AssertionError(f"{what}: card history {card.history} != CPU {cpu.history}")
    for tag, a, b in (("final", card.model, cpu.model), ("best", card.best_params, cpu.best_params)):
        for li, (p, q) in enumerate(zip(a.params, b.params)):
            for field, u, v in zip(p._fields, p, q):
                if (u is None) != (v is None) or (u is not None and not torch.equal(u.cpu(), v)):
                    raise AssertionError(f"{what}: {tag} layer {li} {field} differs from the CPU's")


def phase_training():
    """Integer DFA training (``workloads/training``) on the card at the
    reference's full widths, on numpy-seeded surrogates: ``train_mnist_dfa``
    at 784-100-50-10 (DFA_TRAIN images, one epoch, mini-batch 20, lr_inv
    1000), ``train_spo2_square`` (300 -> 128 tanh -> 1 square) and
    ``train_spo2_one_layer`` (300 -> 1) for SPO2_EPOCHS epochs with their
    epoch-best CSV checkpoints.  Gates: each run's history, best accuracy,
    final and epoch-best parameters and checkpoint bytes equal a CPU run of
    the same call (``device="cpu"``) bit for bit; ``int32_matmul`` on full-
    range operands that wrap, at the DFA step's three shapes, equals the
    int64 product wrapped.  Records the wall of each run on the card and the
    CPU, ms per training step (a loop of ``dfa_train_step`` on one batch,
    CUDA events) and steps/s, ms per ``int32_matmul``, the phase's wall and
    peak memory."""
    import torch

    from hhe_tpu_torch.models import pocketnn as pk
    from hhe_tpu_torch.workloads import training

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(18)
    n = DFA_TRAIN + DFA_TEST
    img, lab = rng.integers(0, 256, (n, 784)), rng.integers(0, 10, n)
    n = SPO2_TRAIN + SPO2_TEST
    rows = rng.integers(0, 32, (n, 300))
    score = rows @ rng.integers(-3, 4, 300)
    pos = (score > np.median(score)).astype(np.int64)  # learnable labels, half positive
    runs = {  # name: (trainer, arguments, keywords, checkpoint files)
        "mnist_dfa": (training.train_mnist_dfa,
                      (img[:DFA_TRAIN], lab[:DFA_TRAIN], img[DFA_TRAIN:], lab[DFA_TRAIN:]),
                      dict(epochs=1), (), 20),
        "spo2_square": (training.train_spo2_square,
                        (rows[:SPO2_TRAIN], pos[:SPO2_TRAIN], rows[SPO2_TRAIN:], pos[SPO2_TRAIN:]),
                        dict(epochs=SPO2_EPOCHS), ("w.fc1.csv", "w.fc2.csv"), 4),
        "spo2_one_layer": (training.train_spo2_one_layer,
                           (rows[:SPO2_TRAIN], pos[:SPO2_TRAIN], rows[SPO2_TRAIN:], pos[SPO2_TRAIN:]),
                           dict(epochs=SPO2_EPOCHS), ("w.csv",), 4),
    }
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (fn, args, kw, files, mb) in runs.items():
            out, wall = {}, {}
            for dev in ("cuda", "cpu"):
                if files:
                    os.makedirs(os.path.join(tmp, dev, name))
                    kw["save_best_path"] = os.path.join(
                        tmp, dev, name, "w.csv" if files == ("w.csv",) else "w")
                out[dev], wall[dev] = timed(lambda: fn(*args, **kw, device=dev))
            same_training(out["cuda"], out["cpu"], name)
            for f in files:
                card, cpu = (open(os.path.join(tmp, d, name, f), "rb").read() for d in ("cuda", "cpu"))
                if card != cpu:
                    raise AssertionError(f"{name}: checkpoint {f} differs from the CPU's")
            res = out["cuda"]
            x = torch.as_tensor(args[0][:mb], dtype=torch.int32, device="cuda")
            y = torch.zeros((mb, res.specs[-1].out_dim), dtype=torch.int32, device="cuda")
            step_ms = cuda_ms(lambda: pk.dfa_train_step(res.model, res.specs, x, y, 1000), 50)
            steps = kw["epochs"] * (len(args[0]) // mb)
            stats[name] = {
                "widths": [res.specs[0].in_dim] + [s.out_dim for s in res.specs],
                "epochs": kw["epochs"], "mini_batch": mb, "steps": steps,
                "card_s": wall["cuda"], "cpu_s": wall["cpu"],
                "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
                "history": res.history, "best_test_acc": res.best_test_acc,
                "nonzero_weights": [int((p.weight != 0).sum()) for p in res.model.params],
            }
            log(f"training {name}: card equals CPU bit for bit ({steps} steps, "
                f"{wall['cuda']:.2f} s on the card, {wall['cpu']:.2f} s on the CPU), "
                f"{step_ms:.3f} ms a step")
    mm = {}
    for m, k, nn in ((20, 784, 100), (784, 20, 100), (1, 20, 100)):
        a = rng.integers(-(2**31) + 1, 2**31, (m, k))
        b = rng.integers(-(2**31) + 1, 2**31, (k, nn))
        want = torch.as_tensor((a @ b).astype(np.int32))  # int64 wraps mod 2^64: exact mod 2^32
        at, bt = (torch.as_tensor(v.astype(np.int32), device="cuda") for v in (a, b))
        if not torch.equal(pk.int32_matmul(at, bt).cpu(), want):
            raise AssertionError(f"int32_matmul [{m}, {k}] x [{k}, {nn}] differs from int64")
        mm[f"{m}x{k}x{nn}"] = cuda_ms(lambda: pk.int32_matmul(at, bt), 50)
    stats["int32_matmul_ms"] = mm
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    stats["wall_s"] = time.perf_counter() - t_phase
    log(f"training: int32_matmul equals the wrapped int64 product, ms a call {mm}")
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    return stats


def write_reference_tree(root, rng):
    """Surrogates of the reference files the accuracy report reads, at their
    published shapes: PARITY_PATIENTS SIESTA-layout recordings of
    PARITY_ROWS rows of 300 values 0-31 with 0/1 labels, the SpO2 1FC weights
    (300 x 1 in [-3, 3]), the MNIST 2FC weights (784 x 128 and 128 x 10 in
    [-2, 1]) and PARITY_IMAGES MNIST t10k images."""
    from hhe_tpu_torch.models import pocketnn
    from hhe_tpu_torch.workloads import float_baseline as fb

    siesta = os.path.join(root, "data", "Harpocrates_recordingwise_SIESTA_4percent")
    mnist = os.path.join(root, "data", "mnist", "MNIST", "raw")
    for d in (siesta, mnist, os.path.dirname(os.path.join(root, fb.SPO2_WEIGHTS)),
              os.path.dirname(os.path.join(root, fb.MNIST_FC1_WEIGHTS))):
        os.makedirs(d, exist_ok=True)
    w = rng.integers(-3, 4, (300, 1))
    for i in range(PARITY_PATIENTS):
        x = rng.integers(0, 32, (PARITY_ROWS, 300))
        y = ((x @ w)[:, 0] + rng.integers(-40, 41, PARITY_ROWS) > 0).astype(int)
        stem = os.path.join(siesta, f"c{i:06d}")
        np.savetxt(stem + "_data.txt", x, fmt="%d", delimiter=",")
        np.savetxt(stem + "_binaryoutput.txt", y, fmt="%d")
    pocketnn.save_csv_matrix(os.path.join(root, fb.SPO2_WEIGHTS), w)
    pocketnn.save_csv_matrix(os.path.join(root, fb.MNIST_FC1_WEIGHTS), rng.integers(-2, 2, (784, 128)))
    pocketnn.save_csv_matrix(os.path.join(root, fb.MNIST_FC2_WEIGHTS), rng.integers(-2, 2, (128, 10)))
    write_mnist_idx(mnist, rng.integers(0, 256, (PARITY_IMAGES, 784)),
                    rng.integers(0, 10, PARITY_IMAGES))
    return siesta


def phase_accuracy_parity():
    """``accuracy_parity_report`` on the card, from a temporary reference
    tree of surrogates (``write_reference_tree``): the float SpO2 logistic
    regression (400 full-batch Adam steps over PARITY_PATIENTS patients), the
    SpO2 1FC integer accuracy, the float MNIST 2FC (784 -> 128 -> square ->
    10, 3 epochs over 8,000 images), the MNIST 2FC integer accuracy on 2,000
    images, then ``build_stack`` at N=1024 / 13 limbs and
    ``hhe_1fc_inference`` on PARITY_SAMPLES samples with its hard parity
    check.  Gates: the encrypted columns equal the integer ones, K1-K4
    launched, and the float SpO2 weights of a card run within FLOAT_SPO2_TOL
    of a CPU run's with the same predictions on every row.  Records every
    column, the synchronised seconds of each part, the seconds of the float
    SpO2 run again on the card and on the CPU, the float weights' largest
    difference and the peak memory."""
    import torch

    from hhe_tpu_torch.workloads import float_baseline as fb
    from hhe_tpu_torch.workloads import hhe_inference as wk

    parts = ("train_float_spo2", "spo2_integer_accuracy", "train_float_mnist_2fc",
             "mnist_integer_accuracy")
    with tempfile.TemporaryDirectory() as tmp:
        siesta = write_reference_tree(tmp, np.random.default_rng(19))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with ShapeRecorder() as rec, PhaseTimer(fb, parts) as pt, \
                PhaseTimer(wk, ("build_stack", "hhe_1fc_inference")) as pt_he:
            rep, wall = timed(lambda: fb.accuracy_parity_report(
                encrypted_samples=PARITY_SAMPLES, reference_root=tmp))
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        card, card_s = timed(lambda: fb.train_float_spo2(root=siesta))
        cpu, cpu_s = timed(lambda: fb.train_float_spo2(root=siesta, device="cpu"))
        x, _ = fb.load_siesta(siesta, 40)
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(card.params, cpu.params))
    xs = torch.as_tensor(((x - x.mean(0)) / (x.std(0) + 1e-6)).astype(np.float32))
    agree = torch.equal(xs @ card.params[0].cpu() + card.params[1].cpu() > 0,
                        xs @ cpu.params[0] + cpu.params[1] > 0)
    stats = {"report": rep, "wall_s": wall, "seconds": {**pt.seconds, **pt_he.seconds},
             "float_spo2_again_s_card_cpu": [card_s, cpu_s],
             "float_spo2_max_weight_diff_vs_cpu": diff,
             "float_spo2_accuracies_card_cpu": [card.train_acc, card.test_acc,
                                                cpu.train_acc, cpu.test_acc],
             "peak_mem_gib": peak}
    log(f"accuracy_parity: encrypted parity held on {PARITY_SAMPLES} samples at N=1024 / "
        f"13 limbs, launches {launches}")
    for key_, val in stats.items():
        log(f"  {key_}: {val}")
    for model in ("spo2_1fc", "mnist_2fc"):
        if rep[model]["encrypted"] != rep[model]["integer"]:
            raise AssertionError(f"{model}: encrypted column differs from the integer one")
    if rep["spo2_1fc"].get("encrypted_parity_checked_samples") != PARITY_SAMPLES:
        raise AssertionError("the encrypted samples were not checked")
    if diff > FLOAT_SPO2_TOL or not agree:
        raise AssertionError(f"float SpO2 on the card: weights {diff} from the CPU's, "
                             f"predictions agree: {agree}")
    if min(launches[k] for k in PATH_KERNELS) == 0:
        raise AssertionError(f"a kernel did not launch on the accuracy path: {launches}")
    return stats, launches, rec.calls


def free_device(dropped=()):
    """Collect what the phases dropped -- a dropped stack's graph units go
    with it, their pools with the last graph -- and return the freed
    memory to the card; fail if a unit of ``dropped`` (weak references,
    ``unit_refs``) is still alive."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    alive = [r().name for r in dropped if r() is not None]
    if alive:
        raise AssertionError(f"free_device() left a dropped stack's units {alive} alive")


def unit_refs(stack) -> list:
    """Weak references to `stack`'s graph units: its transcipher's and its
    1FC evaluation's."""
    import weakref

    tc = stack.tc
    units = [tc._jit_expand, tc._jit_keystream, tc._jit_keystream_seeded, tc._jit_finish]
    units += [u for k, u in vars(stack).items() if k.startswith("_jit_1fc_")]
    return [weakref.ref(u) for u in units]


def main():
    import torch

    from hhe_tpu_torch.ops import pasta

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ecg-full-samples", type=int, default=ECG_FULL_CAP,
                    help=f"samples of the full ECG run (0: all {MITBIH_TEST_ROWS}; "
                         f"default {ECG_FULL_CAP})")
    args = ap.parse_args()
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    phase_kernels()
    ShapeRecorder.install()
    launches, calls = {}, {}
    stack, launches["ecg"], calls["ecg"], stats, (d0, x0) = phase_main_path()
    enc_key = stack.tc.encrypt_key(stack.pk, pasta.get_fixed_symmetric_key())
    prof = phase_profile(stack.tc, enc_key, stats["block_ms"], "ECG keystream",
                         stats["block_graph_ms"], gate=True)
    del enc_key
    free_device()
    graph_units = {"ecg": phase_graphs(stack, B)}
    free_device()
    mod_switch = phase_mod_switch(stack, d0, x0)
    del d0
    free_device()
    parallel, launches["parallel"], calls["parallel"] = phase_parallel(stack)
    free_device()
    limb, launches["limb"], calls["limb"] = phase_limb(stack)
    free_device()
    ecg_full, launches["ecg_full"], calls["ecg_full"] = phase_ecg_full(
        stack, args.ecg_full_samples)
    dropped = unit_refs(stack)
    del stack
    free_device(dropped)
    graph_units["reserved_gib_after_dropping_the_ecg_stack"] = torch.cuda.memory_reserved() / 2**30
    log(f"the ECG stack dropped with its graphs: "
        f"{graph_units['reserved_gib_after_dropping_the_ecg_stack']:.3f} GiB reserved")
    fc, launches["1fc"], calls["1fc"] = phase_1fc()
    free_device()
    parties, launches["parties"], calls["parties"] = phase_parties()
    free_device()
    cli = phase_cli()
    free_device()
    fmnist, launches["fmnist_1fc"], calls["fmnist_1fc"] = phase_fmnist()
    free_device()
    mnist, launches["mnist_2fc"], calls["mnist_2fc"] = phase_mnist_2fc()
    free_device()
    hcnn, launches["he_conv"], calls["he_conv"] = phase_he_conv()
    free_device()
    training = phase_training()
    free_device()
    parity, launches["accuracy_parity"], calls["accuracy_parity"] = phase_accuracy_parity()
    free_device()
    chain, launches["large_chain"], calls["large_chain"] = phase_large_chain()
    free_device()
    rot32k, launches["rotation_32768"], calls["rotation_32768"] = phase_rotation_32768()
    free_device()
    large, launches["large_keystream"], calls["large_keystream"] = phase_large_keystream()
    free_device()
    check_fused_modes(launches)
    rows = kernel_rows(launches, calls) + mont_rows(launches, calls) + elem_rows(launches, calls)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    graph_units["mnist_2fc"] = mnist.pop("graph_units")
    graph_units["parties_eval_1fc"] = parties.pop("graph_unit_eval_1fc")
    print(json.dumps({"card": smi, "main_path": stats, "profile": prof, "graphs": graph_units,
                      "mod_switch": mod_switch,
                      "parallel": parallel, "limb": limb, "ecg_full": ecg_full, "1fc": fc, "parties": parties, "cli": cli,
                      "fmnist_1fc": fmnist, "mnist_2fc": mnist, "he_conv": hcnn,
                      "training": training, "accuracy_parity": parity,
                      "large_chain": chain, "rotation_32768": rot32k,
                      "large_keystream": large}), flush=True)
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
