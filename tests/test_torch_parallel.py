"""The port's process-group meshes (``hhe_tpu_torch.parallel``) against the
JAX package's on its 8-device virtual CPU mesh, bit for bit: the mirror of
``test_parallel.py``, of the sharded keygen of ``test_large_preset.py`` and
of ``distributed_worker.py``.

The port's ranks are spawned processes on gloo (``_rank_main``, in this
file).  They import neither JAX nor ``hhe_tpu`` (each starts with
``sys.modules["jax"] = None``), run every multi-rank case of their world
size once, and write their gathered results to a temporary directory; the
tests compute the JAX package's results in this process meanwhile and
compare.  One world of four ranks (a ("batch": 2, "limb": 2) mesh, its
limbs split two ways through ``limb_shard.LimbView``, and a 4-rank "poly"
axis) and one of two (a ("batch": 1, "limb": 2) mesh and a 2-rank "poly"
axis)."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hhe_tpu_torch import convert
from hhe_tpu_torch.ops import bfv, primes
from hhe_tpu_torch.parallel import limb_shard
from hhe_tpu_torch.parallel import mesh as hmesh
from hhe_tpu_torch.parallel import ntt_shard

ROOT = pathlib.Path(__file__).resolve().parents[1]
JOIN_S = 240  # seconds a world of ranks may take, as test_parallel.py's workers
NTT_SIZES = (4096, 65536)


# ---------------------------------------------------------------------------
# The ranks (spawned processes: nothing here may import JAX)
# ---------------------------------------------------------------------------


def _u32(x) -> np.ndarray:
    return convert.to_numpy(x)


def _eval_keys(n=2048, limbs=4, seed=33):
    """test_parallel.py's fixture: a context and its keys, drawn in its
    order (secret, public, relinearisation, the galois key of step 1)."""
    ctx = bfv.Context(bfv.BFVParams(n=n, data_limbs=limbs, seed=seed), device="cpu")
    sk = ctx.keygen_secret()
    pk = ctx.keygen_public(sk)
    rk = ctx.keygen_relin(sk)
    g = ctx.galois_elt_from_step(1)
    return ctx, sk, pk, rk, g, ctx.keygen_galois(sk, [g])


def _batch_eval(m, out):
    """test_parallel.py's multiply_plain + rotate + add on a ciphertext batch
    split over the mesh's samples and limbs (through the rank's LimbView),
    gathered; keys and inputs drawn as its fixture draws them (N=2048, 4
    limbs, seed 33)."""
    from hhe_tpu_torch.ops import bfv_eval

    ctx, sk, pk, _, g, gks = _eval_keys()
    rng = np.random.default_rng(0)
    vals = rng.integers(0, ctx.t, (8, ctx.n), dtype=np.int64)
    batch = bfv.Ciphertext(torch.stack([ctx.encrypt(pk, ctx.encode(v)).data for v in vals], 1))
    w = rng.integers(0, ctx.t, ctx.n, dtype=np.int64)
    wpt = ctx.plain_for_mul(ctx.encode(w))
    view = limb_shard.LimbView(ctx, m)
    local = hmesh.shard_ciphertext_batch(batch, m)
    prod = bfv_eval.multiply_plain(view, local, wpt)
    res = bfv_eval.add(view, prod, bfv_eval.apply_galois(view, prod, g, gks[g]))
    whole = hmesh.gather_batch(hmesh.gather_limbs(res.data, m), m)
    out["batch_eval"] = _u32(whole)
    out["batch_eval_local_samples"] = np.array(local.data.shape[1])
    out["batch_eval_local_limbs"] = np.array(local.data.shape[2])
    out["batch_eval_limbs"] = np.array([view.limbs.start, view.limbs.stop])
    out["batch_eval_gathers"] = np.array(view.all_gathers)
    out["batch_eval_dec3"] = ctx.decode(ctx.decrypt(sk, bfv.Ciphertext(whole[:, 3])))
    out["batch_eval_want3"] = _rolled_product(vals[3], w, ctx)


def _rolled_product(v, w, ctx):
    prod = v * w % ctx.t
    half = ctx.n // 2
    return (prod + np.roll(prod.reshape(2, half), -1, axis=1).reshape(-1)) % ctx.t


class NttBases:
    """Counts the plain NTTs (the kernels' stand-in on the CPU) a block of
    code runs, by the moduli of their tables, and keeps the shapes."""

    def __init__(self):
        from hhe_tpu_torch.ops import ntt

        self.ntt, self.calls = ntt, []
        self.orig = (ntt.ntt_fwd_plain, ntt.ntt_inv_plain)

    def __enter__(self):
        def rec(fn):
            def call(x, tb):
                self.calls.append((tuple(x.shape), tb.moduli))
                return fn(x, tb)
            return call
        self.ntt.ntt_fwd_plain, self.ntt.ntt_inv_plain = map(rec, self.orig)
        return self

    def __exit__(self, *exc):
        self.ntt.ntt_fwd_plain, self.ntt.ntt_inv_plain = self.orig


def _transcipher_cases(m, out):
    """test_parallel.py's one transcipher round on the encrypted key, split
    over the limb ranks by ``shard_limbs`` (through the view's transcipher,
    ``on_limbs``), with the finish of the rank's samples and limbs and the
    1FC on them (N=1024, 6 limbs, seed 5, B=8), gathered; the moduli of
    every NTT the round ran, the shapes of the rank's key rows, and the
    round constants the rank made on the device over its limbs; then
    csp_decompose(mesh=) of 5 samples of 100 words (padded to the batch
    axis, tail masked) at a fresh nonce, its keystream split over the limb
    ranks, beside the unsplit run."""
    from hhe_tpu_torch.ops import bfv_eval, helin, pasta, transcipher
    from hhe_tpu_torch.workloads import hhe_inference as wk

    stack = wk.build_stack(
        bfv.BFVParams(n=1024, data_limbs=6, seed=5), input_len=128, device="cpu"
    )
    ctx, tc = stack.ctx, stack.tc
    tcl = tc.on_limbs(m)
    view = tcl.ctx
    rng = np.random.default_rng(2)
    x = rng.integers(0, 64, (8, 128)).astype(np.uint64)
    w = rng.integers(-3, 4, 128)
    key = pasta.get_fixed_symmetric_key()
    enc_key = tc.encrypt_key(stack.pk, key)
    weight_ct = helin.encrypt_weight(ctx, stack.pk, w[None, :])[0]
    made = dict(transcipher.RC_BLOCKS)
    with NttBases() as bases:
        mats, rcs = tcl.device_block_plaintexts(pasta.NONCE, 0)
        keys = tcl._keys()
        st = tcl._matmul(hmesh.shard_limbs(enc_key, m), tcl.round_mats(mats, 0), keys)
        st = bfv_eval.add_plain(view, st, rcs[0])
        st = tcl._sbox_feistel(tcl._mix(st, keys), keys)
    out["round_rcs"] = _u32(rcs)
    out["round_rcs_made"] = np.array([transcipher.RC_BLOCKS[where] - made[where]
                                      for where in ("device", "host")])
    chunk = ctx.to_device(hmesh.local_batch(x, m))
    fin = bfv.Ciphertext(tcl._finish_impl(st.data, chunk))
    wct = bfv.Ciphertext(weight_ct.data[:, None])
    fc = wk.csp_eval_1fc(stack, fin, wct, do_sum=True, mesh=m)
    out["round_ks"] = _u32(hmesh.gather_limbs(st.data, m))
    out["round_fc"] = _u32(hmesh.gather_batch(hmesh.gather_limbs(fc.data, m), m))
    out["round_limbs"] = np.array([view.limbs.start, view.limbs.stop])
    out["round_fin_shape"] = np.array(fin.data.shape)
    local = {view.tb_q.moduli, view.tb_qp.moduli, view.tb_bsk.moduli, tc._tb_t.moduli}
    out["round_ntt_calls"] = np.array(len(bases.calls))
    out["round_ntt_other_bases"] = np.array(sum(mods not in local for _, mods in bases.calls))
    out["round_ntt_whole_q"] = np.array(
        sum(mods in (ctx.tb_q.moduli, ctx.tb_qp.moduli) for _, mods in bases.calls))
    out["round_hoist_shapes"] = np.array(sorted({s for s, mods in bases.calls
                                                 if mods == view.tb_qp.moduli and len(s) == 3}))
    out["rk_rows"] = np.array(view.take_key(stack.rk).k0.shape)
    out["baby_rows"] = np.array(tcl.baby_k0.shape)
    out["giant_rows"] = np.array(tcl.giant_k0.shape)

    nonce = pasta.NONCE + 1
    x2 = np.random.default_rng(4).integers(0, 64, (5, 100)).astype(np.uint64)
    sym = pasta.Pasta(key, ctx.t).encrypt(x2, nonce=nonce)
    dec = wk.csp_decompose(stack, enc_key, sym, nonce=nonce, mesh=m)
    out["decompose"] = _u32(dec.data)
    out["decompose_ks"] = _u32(hmesh.gather_limbs(tcl.keystream_ct(enc_key, nonce, 0).data, m))
    out["decompose_unsplit"] = _u32(wk.csp_decompose(stack, enc_key, sym, nonce=nonce).data)
    out["decompose_ks_unsplit"] = _u32(tc.keystream_ct(enc_key, nonce, 0).data)


def _ntt_cases(pm, out):
    """ShardedNtt over the "poly" axis at each size: forward output,
    roundtrip and negacyclic product, gathered; then keygen_public(mesh=)
    at large_params(data_limbs=3, seed=9) and the host path's key."""
    for n in NTT_SIZES:
        mods = primes.ntt_primes(n, 30, 2)
        rng = np.random.default_rng(0)
        a = np.stack([rng.integers(0, q, n) for q in mods]).astype(np.uint32)
        b = np.stack([rng.integers(0, q, n) for q in mods]).astype(np.uint32)
        sn = ntt_shard.ShardedNtt(mods, n, pm)
        fa = sn.fwd(sn.shard(a))
        out[f"ntt_fwd_{n}"] = _u32(sn.gather(fa))
        out[f"ntt_roundtrip_{n}"] = _u32(sn.gather(sn.inv(fa)))
        out[f"ntt_mul_{n}"] = _u32(sn.negacyclic_mul(a, b))
    params = bfv.large_params(data_limbs=3, seed=9)
    ctx_a, ctx_b = bfv.Context(params, device="cpu"), bfv.Context(params, device="cpu")
    pk_host = ctx_a.keygen_public(ctx_a.keygen_secret())
    sk_b = ctx_b.keygen_secret()
    pk_shard = ctx_b.keygen_public(sk_b, mesh=pm)
    v = np.arange(100, dtype=np.int64)
    ct = ctx_b.encrypt(pk_shard, ctx_b.encode(v))
    out["keygen_host"] = pk_host.data
    out["keygen_shard"] = pk_shard.data
    out["keygen_decrypts"] = np.array(np.array_equal(ctx_b.decode(ctx_b.decrypt(sk_b, ct))[:100], v))


def _gloo_smoke(m, out):
    """distributed_worker.py: one cross-process all_reduce and one
    batch-split multiply_plain, each rank with 2 samples of its own."""
    from hhe_tpu_torch.ops import bfv_eval

    rank = dist.get_rank()
    x = torch.full((2,), float(rank + 1))
    dist.all_reduce(x)  # ranks 0 and 1: [1, 1] + [2, 2]
    out["smoke_sum"] = x.sum().numpy()
    ctx = bfv.Context(bfv.BFVParams(n=1024, data_limbs=2, seed=0), device="cpu")
    sk = ctx.keygen_secret()
    pk = ctx.keygen_public(sk)
    msg = np.arange(8, dtype=np.int64)
    ct = ctx.encrypt(pk, ctx.encode(msg))
    mult = np.zeros(ctx.n, np.int64)
    mult[:8] = 3
    local = bfv.Ciphertext(ct.data[:, None].expand(2, 2, ctx.k, ctx.n).contiguous())
    res = bfv_eval.multiply_plain(ctx, local, ctx.plain_for_mul(ctx.encode(mult)))
    got = ctx.decode(ctx.decrypt(sk, bfv.Ciphertext(res.data[:, 0])))
    out["smoke_local_right"] = np.array(np.array_equal(got[:8], msg * 3 % ctx.t))
    whole = hmesh.gather_batch(res.data, m)
    out["smoke_gathered_samples"] = np.array(whole.shape[1])
    out["smoke_all_equal"] = np.array(all(torch.equal(whole[:, i], res.data[:, 0]) for i in range(4)))


def _world_four(out):
    m = hmesh.make_hhe_mesh(4, limb_shards=2, device="cpu")
    out["mesh_shape"] = np.array([m.shape["batch"], m.shape["limb"]])
    _batch_eval(m, out)
    _transcipher_cases(m, out)
    _ntt_cases(hmesh.make_mesh((4,), ("poly",), device="cpu"), out)


def _limb_eval(m, out):
    """On a ("batch": 1, "limb": 2) mesh: relinearize(multiply(a, b)) and
    apply_galois of step 1 on the fixture's context (N=2048, 4 limbs), a
    split by ``shard_limbs`` and b whole, gathered; then a 3-limb context,
    which the axis does not divide: its limbs stay whole on both ranks and
    the view equals the context."""
    from hhe_tpu_torch.ops import bfv_eval

    ctx, sk, pk, rk, g, gks = _eval_keys()
    a = ctx.encrypt(pk, ctx.encode(np.arange(64)))
    b = ctx.encrypt(pk, ctx.encode(np.arange(64) + 5))
    view = limb_shard.LimbView(ctx, m)
    rel = bfv_eval.relinearize(view, bfv_eval.multiply(view, hmesh.shard_limbs(a, m), b), rk)
    rot = bfv_eval.apply_galois(view, rel, g, gks[g])
    out["limb_relin"] = _u32(hmesh.gather_limbs(rel.data, m))
    out["limb_galois"] = _u32(hmesh.gather_limbs(rot.data, m))
    out["limb_local_shape"] = np.array(rel.data.shape)
    out["limb_gathers"] = np.array(view.all_gathers)
    out["limb_dec"] = ctx.decode(ctx.decrypt(sk, bfv.Ciphertext(hmesh.gather_limbs(rot.data, m))))

    odd = bfv.Context(bfv.BFVParams(n=1024, data_limbs=3, seed=4), device="cpu")
    osk = odd.keygen_secret()
    ork = odd.keygen_relin(osk)
    oa = odd.encrypt(odd.keygen_public(osk), odd.encode(np.arange(8)))
    oview = limb_shard.LimbView(odd, m)
    placed = hmesh.shard_ciphertext_batch(bfv.Ciphertext(oa.data[:, None]), m)
    got = bfv_eval.relinearize(oview, bfv_eval.square(oview, bfv.Ciphertext(placed.data[:, 0])), ork)
    want = bfv_eval.relinearize(odd, bfv_eval.square(odd, oa), ork)
    out["odd_split"] = np.array(oview.split)
    out["odd_limbs"] = np.array([oview.limbs.start, oview.limbs.stop])
    out["odd_placed_limbs"] = np.array(placed.data.shape[2])
    out["odd_equal"] = np.array(torch.equal(got.data, want.data))
    out["odd_gathers"] = np.array(oview.all_gathers)


def _world_two(out):
    m = hmesh.make_hhe_mesh(device="cpu")
    out["mesh_shape"] = np.array([m.shape["batch"], m.shape["limb"]])
    _gloo_smoke(m, out)
    _limb_eval(hmesh.make_hhe_mesh(limb_shards=2, device="cpu"), out)
    _ntt_cases(hmesh.make_mesh((2,), ("poly",), device="cpu"), out)


WORLDS = {4: _world_four, 2: _world_two}


def _rank_main(world: int, rank: int, port: int, out_dir: str):
    """One rank: join the gloo group, run the world's cases, save them."""
    torch.set_num_threads(1)
    hmesh.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    out = {}
    WORLDS[world](out)
    np.savez(os.path.join(out_dir, f"world{world}_rank{rank}.npz"), **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Launching the ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class World:
    """`size` rank processes started now; ``results()`` joins them (once)
    and returns each rank's saved arrays."""

    def __init__(self, size: int, out_dir: pathlib.Path):
        self.size, self.out_dir = size, out_dir
        port = _free_port()
        self.procs = []
        for rank in range(size):
            code = (
                "import sys; sys.modules['jax'] = None; "
                f"sys.path.insert(0, {str(ROOT)!r}); "
                "from tests.test_torch_parallel import _rank_main; "
                f"_rank_main({size}, {rank}, {port}, {str(out_dir)!r})"
            )
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=ROOT, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            ))
        self._results = None

    def results(self):
        if self._results is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=JOIN_S)[0])
            finally:
                self.kill()
            for rank, (p, text) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0, f"rank {rank} of {self.size} failed:\n{text[-3000:]}"
            self._results = [
                dict(np.load(self.out_dir / f"world{self.size}_rank{r}.npz"))
                for r in range(self.size)
            ]
        return self._results

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    started = {size: World(size, tmp_path_factory.mktemp(f"world{size}")) for size in WORLDS}
    yield started
    for w in started.values():
        w.kill()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread here too: the ranks run beside this process."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    if dist.is_initialized():  # the one-rank group of the in-process tests
        dist.destroy_process_group()


def same(got: np.ndarray, j_arr) -> bool:
    return np.array_equal(got, np.asarray(j_arr).astype(np.uint32))


def every_rank(results, key):
    """The value `key` of rank 0, after checking that every rank has it."""
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        assert np.array_equal(res[key], first), (key, r)
    return first


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_transcipher_stack():
    from hhe_tpu.ops import bfv as jbfv
    from hhe_tpu.workloads import hhe_inference as jwk

    return jwk.build_stack(jbfv.BFVParams(n=1024, data_limbs=6, seed=5), input_len=128)


def test_sharded_transcipher_hot_path_matches_jax(worlds, jax_transcipher_stack):
    """One full transcipher round on the encrypted key split over the 2
    limb ranks (BSGS matmul with its hoisted key-switch, round constants,
    mix, feistel sbox), the finish of the rank's samples and limbs and the
    encrypted 1FC on them (ct x ct, relinearize, rotate-reduce), gathered
    == the JAX package's run with the key limb-sharded and the batch
    batch-sharded on its mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hhe_tpu.ops import bfv as jbfv
    from hhe_tpu.ops import bfv_eval as jev
    from hhe_tpu.ops import helin as jhelin
    from hhe_tpu.ops import pasta as jpasta
    from hhe_tpu.parallel import mesh as jmesh
    from hhe_tpu.workloads import hhe_inference as jwk

    stack = jax_transcipher_stack
    mesh = jmesh.make_hhe_mesh(8, limb_shards=2)
    ctx, tc = stack.ctx, stack.tc
    rng = np.random.default_rng(2)
    x = rng.integers(0, 64, (8, 128)).astype(np.uint64)
    w = rng.integers(-3, 4, 128)
    enc_key = tc.encrypt_key(stack.pk, jpasta.get_fixed_symmetric_key())
    weight_ct = jhelin.encrypt_weight(ctx, stack.pk, w[None, :])[0]
    mats_pt, rcs_pt = tc.device_block_plaintexts(jpasta.NONCE, 0)

    def one_round(key_data, mats, rcs, keys):
        st = tc._matmul(jbfv.Ciphertext(key_data), tc.round_mats(mats, 0), keys)
        st = jev.add_plain(ctx, st, rcs[0])
        return tc._sbox_feistel(tc._mix(st, keys), keys).data

    key_sh = jax.device_put(enc_key.data, NamedSharding(mesh, P(None, "limb", None)))
    ks = jax.jit(one_round)(key_sh, mats_pt, rcs_pt, tc._keys())
    chunk = jax.device_put(jnp.asarray(x.astype(np.uint32)), NamedSharding(mesh, P("batch", None)))
    fin = tc._jit_finish(ks, chunk)
    ct = jmesh.shard_ciphertext_batch(jbfv.Ciphertext(fin), mesh)
    out = jwk.csp_eval_1fc(stack, ct, jbfv.Ciphertext(weight_ct.data[:, None]), do_sum=True)

    results = worlds[4].results()
    assert same(every_rank(results, "round_ks"), ks)
    assert same(every_rank(results, "round_fc"), out.data)


def test_one_process_mesh_and_refusals():
    """In one process the mesh needs no address (a one-rank group); sizes
    the group cannot hold, and entry points without a device on a machine
    without CUDA, raise."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            hmesh.make_hhe_mesh()
    with pytest.raises(ValueError, match="limb shards"):
        hmesh.make_hhe_mesh(4, limb_shards=3, device="cpu")
    m = hmesh.make_hhe_mesh(device="cpu")
    assert m.shape == {"batch": 1, "limb": 1} and m.device == torch.device("cpu")
    assert m.rank("batch") == 0 and m.rank("limb") == 0
    with pytest.raises(ValueError, match="needs 2 ranks"):
        hmesh.make_hhe_mesh(2, device="cpu")
    shard, rep = hmesh.batch_sharding(m), hmesh.replicated(m)
    assert [p.is_shard(1) for p in shard] == [True, False] and all(p.is_replicate() for p in rep)
    assert shard[1].is_shard(2)
    with pytest.raises(ValueError, match="batched ciphertext"):
        hmesh.shard_ciphertext_batch(bfv.Ciphertext(torch.zeros(2, 3, 16, dtype=torch.int32)), m)
    with pytest.raises(ValueError, match=r"ciphertext \[size, k, N\]"):
        hmesh.shard_limbs(bfv.Ciphertext(torch.zeros(2, 3, 2, 16, dtype=torch.int32)), m)
    x = torch.arange(2 * 3 * 2 * 4, dtype=torch.int32).reshape(2, 3, 2, 4)
    local = hmesh.shard_ciphertext_batch(bfv.Ciphertext(x), m)
    assert hmesh.limb_range(2, m) == range(2) and local.data.shape == x.shape
    assert torch.equal(hmesh.gather_batch(hmesh.gather_limbs(local.data, m), m), x)
    assert torch.equal(hmesh.shard_limbs(bfv.Ciphertext(x[:, 0]), m).data, x[:, 0])


@pytest.mark.parametrize("axis", [0, 1])
def test_pad_batch(axis):
    from hhe_tpu.parallel import mesh as jmesh

    x = np.arange(30).reshape(5, 6) if axis == 0 else np.arange(30).reshape(6, 5)
    for multiple in (1, 2, 4, 5):
        p, n = hmesh.pad_batch(x, multiple, axis=axis)
        jp, jn = jmesh.pad_batch(x, multiple, axis=axis)
        assert n == jn == 5 and np.array_equal(p, jp) and p.shape[axis] % multiple == 0


def test_sharded_batch_eval_matches_jax(worlds):
    """multiply_plain + rotate + add, the batch split over 2 batch ranks
    (limbs whole on the 2 limb ranks), gathered == the JAX package's run on
    its ("batch": 4, "limb": 2) mesh, and decrypting to the rolled product."""
    import jax
    import jax.numpy as jnp

    from hhe_tpu.ops import bfv as jbfv
    from hhe_tpu.ops import bfv_eval as jev
    from hhe_tpu.parallel import mesh as jmesh

    results = worlds[4].results()
    ctx = jbfv.Context(jbfv.BFVParams(n=2048, data_limbs=4, seed=33))
    sk = ctx.keygen_secret()
    pk = ctx.keygen_public(sk)
    ctx.keygen_relin(sk)
    g = ctx.galois_elt_from_step(1)
    gks = ctx.keygen_galois(sk, [g])
    rng = np.random.default_rng(0)
    vals = rng.integers(0, ctx.t, (8, ctx.n), dtype=np.int64)
    batch = jbfv.Ciphertext(jnp.stack([ctx.encrypt(pk, ctx.encode(v)).data for v in vals], axis=1))
    w = rng.integers(0, ctx.t, ctx.n, dtype=np.int64)
    wpt = ctx.plain_for_mul(ctx.encode(w))

    def pipeline(ct):
        prod = jev.multiply_plain(ctx, ct, wpt)
        return jev.add(ctx, prod, jev.apply_galois(ctx, prod, g, gks[g]))

    jout = jax.jit(pipeline)(jmesh.shard_ciphertext_batch(batch, jmesh.make_hhe_mesh(8, limb_shards=2)))
    assert same(every_rank(results, "batch_eval"), jout.data)
    # each rank holds 4 of the 8 samples and 2 of the 4 limbs (rank = 2 b + l)
    for rank, res in enumerate(results):
        assert int(res["batch_eval_local_samples"]) == 4 and int(res["batch_eval_local_limbs"]) == 2
        assert res["batch_eval_limbs"].tolist() == [2 * (rank % 2), 2 * (rank % 2) + 2]
        assert int(res["batch_eval_gathers"]) == 1  # the key-switch's digits
    assert np.array_equal(results[0]["batch_eval_dec3"], results[0]["batch_eval_want3"])


def test_csp_decompose_mesh_matches_jax(worlds, jax_transcipher_stack):
    """csp_decompose(mesh=) of 5 samples (the keystream split over the 2
    limb ranks; padded to the batch axis, each rank finishing its share on
    its limbs, gathered, tail masked) == the unsplit port result == the JAX
    package's csp_decompose(mesh=) on its mesh, and the split keystream ==
    the unsplit one.  The JAX package gets the block's keystream ciphertext
    from the port's ranks in its cache (test_torch_transcipher.py holds the
    unsplit keystreams of both equal; JAX's jit of a whole keystream costs
    ~50 s here), so what is compared with it is the split finish, the
    gathers and the mask."""
    from hhe_tpu.ops import bfv as jbfv
    from hhe_tpu.ops import pasta as jpasta
    from hhe_tpu.parallel import mesh as jmesh
    from hhe_tpu.workloads import hhe_inference as jwk

    results = worlds[4].results()
    stack = jax_transcipher_stack
    key = jpasta.get_fixed_symmetric_key()
    enc_key = stack.tc.encrypt_key(stack.pk, key)
    nonce = jpasta.NONCE + 1
    x2 = np.random.default_rng(4).integers(0, 64, (5, 100)).astype(np.uint64)
    sym = jpasta.Pasta(key, stack.ctx.t).encrypt(x2, nonce=nonce)
    ks = every_rank(results, "decompose_ks")
    assert np.array_equal(ks, every_rank(results, "decompose_ks_unsplit"))
    stack.tc._ks_cache[(id(enc_key.data), nonce, 0)] = (enc_key.data, jbfv.Ciphertext(ks))
    padded, n = jmesh.pad_batch(sym, 8)
    jdec = jwk.csp_decompose(stack, enc_key, padded, nonce=nonce, mesh=jmesh.make_hhe_mesh(8, limb_shards=2))
    got = every_rank(results, "decompose")
    assert got.shape == (2, 5, stack.ctx.k, stack.ctx.n)
    assert np.array_equal(got, results[0]["decompose_unsplit"])
    assert same(got, np.asarray(jdec.data)[:, :n])


def test_limb_split_rank_rows(worlds):
    """The world of four's ("batch": 2, "limb": 2) mesh at N=1024 / 6
    limbs: limb rank l holds limbs 3l..3l+2, the rows of every key-switch
    and BSGS key of its 3 target moduli and P ([kd, k/d + 1, N] with all 6
    digits), and the transcipher round ran each NTT over the rank's moduli
    (L_r, L_r ∪ P), the whole Bsk base or t, never over the whole q: the
    key-switch hoists at [6 digits, 4 moduli, N]."""
    for rank, res in enumerate(worlds[4].results()):
        lo = 3 * (rank % 2)
        assert res["round_limbs"].tolist() == [lo, lo + 3]
        assert res["round_fin_shape"].tolist() == [2, 4, 3, 1024]
        assert res["rk_rows"].tolist() == [6, 4, 1024]
        assert res["baby_rows"].tolist() == [31, 4, 6, 1024]  # moduli-major
        assert res["giant_rows"].tolist() == [3, 4, 6, 1024]
        assert int(res["round_ntt_calls"]) > 0
        assert int(res["round_ntt_other_bases"]) == 0 and int(res["round_ntt_whole_q"]) == 0
        assert [6, 4, 1024] in res["round_hoist_shapes"].tolist()


def test_limb_split_round_constants_match_jax(worlds, jax_transcipher_stack):
    """The round constants each limb rank of the world of four makes on the
    device, over its view's moduli, are its rows of the JAX package's host
    ``block_rcs``, bit for bit: the whole context's rows."""
    from hhe_tpu.ops import pasta as jpasta

    want = np.asarray(jax_transcipher_stack.tc.block_rcs(jpasta.NONCE, 0))
    for res in worlds[4].results():
        lo, hi = res["round_limbs"].tolist()
        assert res["round_rcs"].shape == (4, hi - lo, 1024) and hi - lo == 3
        assert same(res["round_rcs"], want[:, lo:hi])
        assert res["round_rcs_made"].tolist() == [1, 0]


@pytest.fixture(scope="module")
def jax_eval_keys():
    """test_parallel.py's fixture stack (N=2048, 4 limbs, seed 33)."""
    from hhe_tpu.ops import bfv as jbfv

    ctx = jbfv.Context(jbfv.BFVParams(n=2048, data_limbs=4, seed=33))
    sk = ctx.keygen_secret()
    pk = ctx.keygen_public(sk)
    rk = ctx.keygen_relin(sk)
    g = ctx.galois_elt_from_step(1)
    return ctx, sk, pk, rk, g, ctx.keygen_galois(sk, [g])


def test_limb_split_relin_galois_matches_jax(worlds, jax_eval_keys):
    """relinearize(multiply(a, b)) and apply_galois on a ciphertext split
    over a 2-rank limb axis (the world of two's ("batch": 1, "limb": 2)
    mesh), gathered == the JAX package's jit on its 8-device mesh with a
    limb-sharded; each rank holds [2, 2, N]; the result decrypts to the
    rolled product."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hhe_tpu.ops import bfv as jbfv
    from hhe_tpu.ops import bfv_eval as jev
    from hhe_tpu.parallel import mesh as jmesh

    ctx, sk, pk, rk, g, gks = jax_eval_keys
    a = ctx.encrypt(pk, ctx.encode(np.arange(64)))
    b = ctx.encrypt(pk, ctx.encode(np.arange(64) + 5))
    mesh = jmesh.make_hhe_mesh(8, limb_shards=2)

    def f(ad, bd):
        rel = jev.relinearize(ctx, jev.multiply(ctx, jbfv.Ciphertext(ad), jbfv.Ciphertext(bd)), rk)
        return rel.data, jev.apply_galois(ctx, rel, g, gks[g]).data

    a_sh = jax.device_put(a.data, NamedSharding(mesh, P(None, "limb", None)))
    rel, rot = jax.jit(f)(a_sh, b.data)
    results = worlds[2].results()
    assert same(every_rank(results, "limb_relin"), rel)
    assert same(every_rank(results, "limb_galois"), rot)
    for res in results:
        assert res["limb_local_shape"].tolist() == [2, 2, 2048]
        assert int(res["limb_gathers"]) == 4  # BEHZ: a, t x_q; two key-switches
    prod = np.zeros(ctx.n, np.int64)
    prod[:64] = np.arange(64) * (np.arange(64) + 5) % ctx.t
    half = ctx.n // 2
    assert np.array_equal(results[0]["limb_dec"], np.roll(prod.reshape(2, half), -1, 1).reshape(-1))


def test_limb_axis_not_dividing_keeps_limbs_whole(worlds):
    """A 3-limb context on the world of two's 2-rank limb axis: both ranks
    keep all 3 limbs (``shard_ciphertext_batch`` places them whole, as the
    JAX package's does when k % limb != 0), the view is not split, gathers
    nothing, and its square + relinearise equals the context's."""
    for res in worlds[2].results():
        assert not bool(res["odd_split"]) and res["odd_limbs"].tolist() == [0, 3]
        assert int(res["odd_placed_limbs"]) == 3
        assert bool(res["odd_equal"]) and int(res["odd_gathers"]) == 0


class _StubMesh:
    """Axis sizes and this rank's index along "limb", as a Mesh reports them."""

    def __init__(self, limb: int, rank: int):
        self.shape, self._rank = {"batch": 1, "limb": limb}, rank

    def rank(self, axis):
        return self._rank if axis == "limb" else 0


@pytest.mark.parametrize("k, limb, rank, want", [
    (13, 1, 0, (0, 13)), (13, 2, 1, (0, 13)), (12, 4, 2, (6, 9)), (16, 2, 1, (8, 16)),
])
def test_limb_range_rule(k, limb, rank, want):
    """Rank r of d limb ranks holds the r-th of d contiguous blocks where d
    divides k, every limb otherwise (``hhe_tpu/parallel/mesh.py:71``)."""
    assert hmesh.limb_range(k, _StubMesh(limb, rank)) == range(*want)


def test_one_rank_limb_view_equals_unsplit():
    """In one process (a one-rank group, the ("batch": 1, "limb": 1) mesh
    chip_smoke.py's limb phase runs on): the view holds every limb and is
    split (a one-way split; its gathers are real collectives), and its
    keystream, csp_decompose(mesh=) and csp_eval_1fc(mesh=) equal the
    unsplit ones bit for bit (N=1024, 3 limbs)."""
    from hhe_tpu_torch.ops import helin, pasta, transcipher
    from hhe_tpu_torch.workloads import hhe_inference as wk

    stack = wk.build_stack(bfv.BFVParams(n=1024, data_limbs=3, seed=8), input_len=128, device="cpu")
    ctx, tc = stack.ctx, stack.tc
    m = hmesh.make_hhe_mesh(device="cpu")
    tcl = tc.on_limbs(m)
    view = tcl.ctx
    assert view.split and view.limbs == range(3) and view.whole is ctx
    assert tcl is not tc and tc.on_limbs(m) is tcl
    assert view.take_key(stack.rk) is stack.rk and tcl.baby_k0.shape == tc.baby_k0.shape
    key = pasta.get_fixed_symmetric_key()
    enc_key = tc.encrypt_key(stack.pk, key)
    nonce = 9
    ks = tc.keystream_ct(enc_key, nonce, 0)
    assert torch.equal(tcl.keystream_ct(hmesh.shard_limbs(enc_key, m), nonce, 0).data, ks.data)
    assert view.all_gathers == 31  # hoists, BEHZ operands and key-switches of 4 rounds
    x = np.random.default_rng(6).integers(0, 64, (4, transcipher.T)).astype(np.uint64)
    sym = pasta.Pasta(key, ctx.t).encrypt(x, nonce=nonce)
    whole = wk.csp_decompose(stack, enc_key, sym, nonce=nonce)
    split = wk.csp_decompose(stack, enc_key, sym, nonce=nonce, mesh=m)
    assert torch.equal(whole.data, split.data)
    wct = bfv.Ciphertext(helin.encrypt_weight(ctx, stack.pk, np.arange(-3, 4).repeat(19)[None])[0].data[:, None])
    fc = wk.csp_eval_1fc(stack, whole, wct, do_sum=True)
    fc_view = wk.csp_eval_1fc(stack, hmesh.shard_ciphertext_batch(whole, m), wct, do_sum=True, mesh=m)
    assert torch.equal(fc.data, hmesh.gather_batch(hmesh.gather_limbs(fc_view.data, m), m))


@pytest.mark.parametrize("n", NTT_SIZES)
def test_build_plan_matches_jax(n):
    """Every constant of the four-step plan equals the JAX package's (same
    bits in int32), and the plan refuses ranks that do not divide N1, N2."""
    from hhe_tpu.parallel import ntt_shard as jshard

    mods = tuple(primes.ntt_primes(n, 30, 2))
    mine, theirs = ntt_shard.build_plan(mods, n, 4), jshard.build_plan(mods, n, 4)
    assert (mine.n1, mine.n2, mine.d) == (theirs.n1, theirs.n2, theirs.d)
    for field in ("pre", "mid_f", "tw_f", "tw_i", "mid_i", "post", "psi2_i", "psi2", "r2"):
        got = getattr(mine, field)
        assert got.dtype == np.int32, field
        assert same(got.view(np.uint32), getattr(theirs, field)), field
    with pytest.raises(ValueError, match="do not divide"):
        ntt_shard.build_plan(mods, n, 3)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_ntt_matches_jax(worlds, d):
    """ShardedNtt over d "poly" ranks: the gathered forward output equals
    the JAX package's ShardedNtt on d of its devices, the roundtrip is the
    identity, and negacyclic_mul equals JAX's and poly_mul_host."""
    import jax

    from hhe_tpu.ops import ntt as jntt
    from hhe_tpu.parallel import ntt_shard as jshard

    results = worlds[d].results()
    jm = jax.make_mesh((d,), ("poly",), devices=jax.devices()[:d])
    for n in NTT_SIZES:
        mods = primes.ntt_primes(n, 30, 2)
        rng = np.random.default_rng(0)
        a = np.stack([rng.integers(0, q, n) for q in mods]).astype(np.uint32)
        b = np.stack([rng.integers(0, q, n) for q in mods]).astype(np.uint32)
        sn = jshard.ShardedNtt(mods, n, jm)
        assert same(every_rank(results, f"ntt_fwd_{n}"), sn.fwd(sn.shard(a)))
        assert np.array_equal(every_rank(results, f"ntt_roundtrip_{n}"), a)
        prod = every_rank(results, f"ntt_mul_{n}")
        assert same(prod, sn.negacyclic_mul(a, b))
        want = np.stack([jntt.poly_mul_host(a[i].astype(np.uint64), b[i].astype(np.uint64), int(q))
                         for i, q in enumerate(mods)])
        assert np.array_equal(prod.astype(np.uint64), want)


def test_keygen_public_mesh_matches_jax(worlds):
    """keygen_public(mesh=) at large_params(data_limbs=3) (N = 65536) over
    2 and 4 "poly" ranks == the host path == the JAX package's sharded
    keygen on its 8-device "poly" mesh, and the key encrypts."""
    import jax

    from hhe_tpu.ops import bfv as jbfv

    ctx = jbfv.Context(jbfv.large_params(data_limbs=3, seed=9))
    sk = ctx.keygen_secret()
    jpk = ctx.keygen_public(sk, mesh=jax.make_mesh((8,), ("poly",)))
    for size in WORLDS:
        results = worlds[size].results()
        assert same(every_rank(results, "keygen_shard"), jpk.data)
        assert np.array_equal(results[0]["keygen_host"], results[0]["keygen_shard"])
        assert bool(results[0]["keygen_decrypts"])


def test_keygen_public_one_rank_mesh():
    """In one process: a one-rank "poly" mesh gives the host path's key; a
    mesh without a "poly" axis or on another device type is refused."""
    params = bfv.BFVParams(n=1024, data_limbs=3, seed=4)
    ca, cb = bfv.Context(params, device="cpu"), bfv.Context(params, device="cpu")
    pk_host = ca.keygen_public(ca.keygen_secret())
    pk_mesh = cb.keygen_public(cb.keygen_secret(), mesh=hmesh.make_mesh((1,), ("poly",), device="cpu"))
    assert np.array_equal(pk_host.data, pk_mesh.data)
    with pytest.raises(KeyError, match="poly"):
        cb.keygen_public(cb.keygen_secret(), mesh=hmesh.make_hhe_mesh(device="cpu"))


def test_two_process_gloo_smoke(worlds):
    """distributed_worker.py's checks across two gloo processes: the
    all_reduce sums to 6 on both, each rank's batch-split multiply_plain
    decrypts to the product, and the gathered batch holds both ranks'."""
    for res in worlds[2].results():
        assert float(res["smoke_sum"]) == 6.0
        assert bool(res["smoke_local_right"])
        assert int(res["smoke_gathered_samples"]) == 4 and bool(res["smoke_all_equal"])


def test_mesh_shapes(worlds):
    from hhe_tpu.parallel import mesh as jmesh

    assert jmesh.make_hhe_mesh(8, limb_shards=2).shape == {"batch": 4, "limb": 2}
    want4 = dict(jmesh.make_hhe_mesh(4, limb_shards=2).shape)
    want2 = dict(jmesh.make_hhe_mesh(2).shape)
    for size, want in ((4, want4), (2, want2)):
        for res in worlds[size].results():
            assert dict(zip(("batch", "limb"), res["mesh_shape"].tolist())) == want


def test_ranks_import_no_jax():
    """The rank entry point imports without JAX (as each spawned rank does)."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        f"sys.path.insert(0, {str(ROOT)!r}); "
        "import tests.test_torch_parallel as t; "
        "assert not any(m == 'hhe_tpu' or m.startswith('hhe_tpu.') for m in sys.modules); "
        "print('OK')"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr
