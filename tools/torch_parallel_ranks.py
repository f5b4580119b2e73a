"""Run the port's multi-rank parallel path on the cards of one machine, one
process a card over NCCL, and check it against the unsplit computation.

    python3 tools/torch_parallel_ranks.py [--ranks R] [--out FILE]

R defaults to every card.  Each rank, on card ``rank``:

1. ``ShardedNtt`` over a ("poly",) mesh of R ranks at N = 16384 (13 limbs)
   and N = 65536 (3 limbs): the gathered roundtrip is the identity and the
   gathered ``negacyclic_mul`` equals ``ntt.poly_mul_host``; then the split
   forward and inverse transforms (CUDA events, mean of 10 calls after a
   warm-up) beside the single-card ``ntt_fwd`` / ``ntt_inv`` of the whole
   [k, N] on the same card;
2. ``keygen_public(sk, mesh=)`` at ``large_params(data_limbs=3)``, equal in
   bytes to the host path;
3. on the ECG stack (N=16384, 13 limbs, device keygen with seed 1, B=64)
   ``csp_decompose(mesh=)`` over a ("batch": R, "limb": 1) mesh equal to the
   unsplit ``csp_decompose`` on the same rank, bit for bit, each with its
   keystream evaluated afresh, and their walls;
4. the limb split on the MNIST 2FC chain (N=16384, 16 limbs: the ECG
   chain's 13 is prime and cannot split), over ("batch": R/2, "limb": 2)
   and ("batch": 1, "limb": R): the keystream of one block on the key
   placed by ``shard_limbs``, ``csp_decompose(mesh=)`` of B=64 samples and
   ``csp_eval_1fc(mesh=)`` with the log-depth sum on the batch placed by
   ``shard_ciphertext_batch``, each gathered and equal to the unsplit run
   on the same rank; per mesh the limbs and key rows the rank holds, its
   key bytes against the whole set's, the all-gathers a keystream block
   makes, and the keystream, decompose and FC times split and unsplit
   (the least of three; the keystream and the decompose with the keystream
   and its round material evaluated afresh).  A limb axis that does not
   divide 16 must keep every limb whole.

The K1/K2 launches of each rank's checked run are counted.  The parent
builds the kernels before it starts the ranks, and prints one JSON line:
the card's name and power limit, and each rank's numbers.  Exits nonzero
if any rank fails a check.  Needs R cards; one card is the world of one
that ``chip_smoke.py``'s ``parallel`` phase runs.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NTTS = ((16384, 13), (65536, 3))
B = 64
LIMB_CHAIN = 16  # MNIST 2FC's data limbs at N=16384, even
REPS = 3


def cuda_ms(fn, reps: int = 10) -> float:
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
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rank_main(rank: int, world: int, port: int, out_path: str):
    import numpy as np
    import torch
    import torch.distributed as dist

    from hhe_tpu_torch.ops import bfv, ntt, ntt_kernels, pasta, primes, transcipher
    from hhe_tpu_torch.parallel import mesh as hmesh
    from hhe_tpu_torch.parallel import ntt_shard
    from hhe_tpu_torch.workloads import hhe_inference as wk

    hmesh.init_distributed(f"localhost:{port}", world, rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    res = {"rank": rank, "device": str(dev), "ntt": {}}
    poly = hmesh.make_mesh((world,), ("poly",))
    mesh = hmesh.make_hhe_mesh()
    res["mesh_shape"] = mesh.shape
    stack = wk.build_stack(
        bfv.BFVParams(n=16384, data_limbs=13, seed=1), input_len=128, device_keygen=True, seed=1
    )
    ctx, tc = stack.ctx, stack.tc
    key = pasta.get_fixed_symmetric_key()
    x = np.random.default_rng(11).integers(0, 64, (B, transcipher.T))
    nonce = 80_000
    sym = pasta.Pasta(key, ctx.t).encrypt(x.astype(np.uint64), nonce=nonce)
    enc_key = tc.encrypt_key(stack.pk, key)
    torch.cuda.synchronize()

    checks, operands = {}, {}
    ntt_kernels.reset_launches()
    for n, k in NTTS:
        mods = primes.ntt_primes(n, 30, k)
        rng = np.random.default_rng(n)
        a = np.stack([rng.integers(0, q, n) for q in mods]).astype(np.uint32)
        b = np.stack([rng.integers(0, q, n) for q in mods]).astype(np.uint32)
        sn = ntt_shard.ShardedNtt(mods, n, poly)
        xl = sn.shard(a)
        rt = ntt.u32_to_numpy(sn.gather(sn.inv(sn.fwd(xl))))
        prod = ntt.u32_to_numpy(sn.negacyclic_mul(a, b)).astype(np.uint64)
        want = np.stack([ntt.poly_mul_host(a[i].astype(np.uint64), b[i].astype(np.uint64), q)
                         for i, q in enumerate(mods)])
        checks[f"ntt_{n}"] = bool(np.array_equal(rt, a) and np.array_equal(prod, want))
        operands[n] = (sn, xl, a)
        res["ntt"][n] = {"limbs": k, "n1": sn.plan.n1, "n2": sn.plan.n2,
                         "local_shape": list(xl.shape)}

    params = bfv.large_params(data_limbs=3, seed=9)
    ca, cb = bfv.Context(params), bfv.Context(params)
    pk_host, res["keygen_host_s"] = timed(lambda: ca.keygen_public(ca.keygen_secret()))
    pk_mesh, res["keygen_mesh_s"] = timed(lambda: cb.keygen_public(cb.keygen_secret(), mesh=poly))
    checks["keygen"] = pk_host.data.tobytes() == pk_mesh.data.tobytes()

    tc.clear_caches()
    whole, res["decompose_s"] = timed(lambda: wk.csp_decompose(stack, enc_key, sym, nonce=nonce))
    tc.clear_caches()
    split, res["decompose_mesh_s"] = timed(
        lambda: wk.csp_decompose(stack, enc_key, sym, nonce=nonce, mesh=mesh))
    checks["decompose"] = bool(torch.equal(whole.data, split.data))
    got = ctx.decode(ctx.decrypt(stack.sk, bfv.Ciphertext(split.data[:, B - 1])))
    checks["decompose_decrypts"] = bool(np.array_equal(got[: transcipher.T], x[B - 1]))
    tc.clear_caches()
    res["launches"] = dict(ntt_kernels.LAUNCHES)
    res["checks"] = checks

    for n, (sn, xl, a) in operands.items():
        whole_x = torch.from_numpy(a.view(np.int32)).to(dev)
        tb = ntt.build_tables(sn.moduli, n, dev)
        fl = sn.fwd(xl)
        res["ntt"][n].update(
            sharded_fwd_ms=cuda_ms(lambda: sn.fwd(xl)),
            sharded_inv_ms=cuda_ms(lambda: sn.inv(fl)),
            single_fwd_ms=cuda_ms(lambda: ntt.ntt_fwd(whole_x, tb)),
            single_inv_ms=cuda_ms(lambda: ntt.ntt_inv(whole_x, tb)),
        )
    del stack, tc, whole, split
    torch.cuda.empty_cache()
    limb_case(world, res, checks)

    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)
    if not all(checks.values()):
        raise SystemExit(f"rank {rank}: a check failed: {checks}")


def limb_meshes(world: int):
    """(batch, limb) shapes of the limb case: a two-way and an R-way split."""
    shapes = [(world // 2, 2)] if world % 2 == 0 else []
    return shapes + [(1, world)] if (1, world) not in shapes else shapes


def limb_case(world: int, res: dict, checks: dict):
    """Step 4 of the module docstring, on this rank."""
    import numpy as np
    import torch

    from hhe_tpu_torch.ops import bfv, helin, ntt_kernels, pasta, transcipher
    from hhe_tpu_torch.parallel import mesh as hmesh
    from hhe_tpu_torch.workloads import hhe_inference as wk

    stack = wk.build_stack(bfv.BFVParams(n=16384, data_limbs=LIMB_CHAIN, seed=2), input_len=128,
                           device_keygen=True, seed=2)
    ctx, tc = stack.ctx, stack.tc
    rng = np.random.default_rng(17)
    x = rng.integers(0, 64, (B, transcipher.T))
    w = rng.integers(-3, 4, transcipher.T)
    key = pasta.get_fixed_symmetric_key()
    nonce = 81_000
    sym = pasta.Pasta(key, ctx.t).encrypt(x.astype(np.uint64), nonce=nonce)
    enc_key = tc.encrypt_key(stack.pk, key)
    wct = bfv.Ciphertext(helin.encrypt_weight(ctx, stack.pk, w[None, :])[0].data[:, None])
    keyset = [stack.rk, *stack.gks.values()]

    def bsgs(t):
        return sum(k.nbytes for k in (t.baby_k0, t.baby_k1, t.giant_k0, t.giant_k1))

    def keystream(t, k):
        t.clear_caches()
        return t.keystream_ct(k, nonce, 0)

    def decompose(k, mesh=None):
        tc.clear_caches()  # the limb views' too
        return wk.csp_decompose(stack, k, sym, nonce=nonce, mesh=mesh)

    def least(fn):
        return min(timed(fn)[1] for _ in range(REPS))

    ks = keystream(tc, enc_key)
    dec = wk.csp_decompose(stack, enc_key, sym, nonce=nonce)
    fc = wk.csp_eval_1fc(stack, dec, wct, do_sum=True)
    sums = ctx.decode_batch(ctx.decrypt_batch(stack.sk, fc))[:, 0].astype(np.int64)
    checks["limb_unsplit_sums"] = bool(np.array_equal(sums, (x * w).sum(1) % ctx.t))
    out = {"limbs": LIMB_CHAIN, "key_bytes_whole": sum(k.k0.nbytes + k.k1.nbytes for k in keyset)
           + bsgs(tc), "keystream_unsplit_s": least(lambda: keystream(tc, enc_key)),
           "decompose_unsplit_s": least(lambda: decompose(enc_key)),
           "csp_eval_1fc_sum_unsplit_s": least(lambda: wk.csp_eval_1fc(stack, dec, wct, do_sum=True)),
           "meshes": {}}
    for shape in limb_meshes(world):
        mesh = hmesh.make_hhe_mesh(limb_shards=shape[1])
        tag = f"{shape[0]}x{shape[1]}"
        tcl = tc.on_limbs(mesh)
        view = tcl.ctx
        d = shape[1]
        r = mesh.rank("limb")
        want = range(r * LIMB_CHAIN // d, (r + 1) * LIMB_CHAIN // d) if LIMB_CHAIN % d == 0 \
            else range(LIMB_CHAIN)
        checks[f"limb_{tag}_split"] = bool(view.split == (LIMB_CHAIN % d == 0) and view.limbs == want)
        key_l = hmesh.shard_limbs(enc_key, mesh)
        ntt_kernels.reset_launches()
        g0 = view.all_gathers
        ks_l = tcl.keystream_ct(key_l, nonce, 0)
        gathers = view.all_gathers - g0
        dec_l = wk.csp_decompose(stack, key_l, sym, nonce=nonce, mesh=mesh)
        fc_l = wk.csp_eval_1fc(stack, hmesh.shard_ciphertext_batch(dec_l, mesh), wct, do_sum=True,
                               mesh=mesh)
        fc_whole = hmesh.gather_batch(hmesh.gather_limbs(fc_l.data, mesh), mesh)
        checks[f"limb_{tag}_keystream"] = bool(torch.equal(hmesh.gather_limbs(ks_l.data, mesh), ks.data))
        checks[f"limb_{tag}_decompose"] = bool(torch.equal(dec_l.data, dec.data))
        checks[f"limb_{tag}_fc"] = bool(torch.equal(fc_whole, fc.data))
        ct_l = hmesh.shard_ciphertext_batch(dec, mesh)
        out["meshes"][tag] = {
            "limbs": [view.limbs.start, view.limbs.stop],
            "rk_rows": list(view.take_key(stack.rk).k0.shape),
            "baby_rows": list(tcl.baby_k0.shape),
            "key_bytes_rank": view.key_bytes(keyset) + bsgs(tcl),
            "all_gathers_per_block": gathers,
            "launches": dict(ntt_kernels.LAUNCHES),
            "keystream_split_s": least(lambda: keystream(tcl, key_l)),
            "decompose_split_s": least(lambda: decompose(key_l, mesh)),
            "csp_eval_1fc_sum_split_s": least(lambda: wk.csp_eval_1fc(stack, ct_l, wct, do_sum=True,
                                                                      mesh=mesh)),
        }
        tc.clear_caches()
    res["limb"] = out


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None, help="processes, one a card (default: all)")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.rank is not None:
        return rank_main(args.rank, args.ranks, args.port, args.rank_out)

    if not torch.cuda.is_available():
        raise SystemExit("torch_parallel_ranks: no CUDA device")
    world = args.ranks or torch.cuda.device_count()
    if world > torch.cuda.device_count():
        raise SystemExit(f"{world} ranks need {world} cards; this machine has "
                         f"{torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    from hhe_tpu_torch.ops import mod_kernels, ntt_kernels

    ntt_kernels.build()  # once, before the ranks start
    mod_kernels.build()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--ranks", str(world),
             "--port", str(port), "--rank-out", outs[r]], cwd=ROOT)
            for r in range(world)]
        try:
            rcs = [p.wait(timeout=1200) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = [json.load(open(o)) if os.path.exists(o) else None for o in outs]
    line = {"cards": smi, "world": world, "wall_s": time.perf_counter() - t0,
            "rcs": rcs, "ranks": ranks}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f)
    if any(rcs):
        raise SystemExit(f"a rank failed: exit codes {rcs}")


if __name__ == "__main__":
    main()
