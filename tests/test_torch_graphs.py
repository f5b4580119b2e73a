"""``hhe_tpu_torch.utils.graphs`` -- the port's ``jax.jit``: each unit of the
main path captured once per layout as a CUDA graph and replayed -- on the CPU.

A stand-in capture backend (``Rerun``) takes the CUDA graph's place: its
"capture" runs the body once on the static input buffers, its "replay"
reruns the body on them and writes into the same static outputs, as a
graph's replay does, without the wrappers counting (a graph launches its
kernels without calling them).  With it:

- entries: a new shape or a new constant gives a new entry, the same
  layout replays its entry, the least recently used goes past MAX_ENTRIES;
- outputs are clones: a result is unchanged by later calls;
- the launch counters are credited on every replay, with what the capture
  counted, and the capture itself counts nothing;
- a CPU tensor goes straight to the body under the real backend, and
  creates no entry;
- the units on a stack of ``build_stack`` at N=2048 / 4 limbs, built by
  both packages: ``csp_decompose`` (expand, keystream, finish; the seeded
  keystream for L=300) and ``csp_eval_1fc`` with and without the sum,
  first call and replay, each equal to the JAX package's jitted units bit
  for bit;
- the parties' CSP on its analyst stack's 1FC unit, equal to its body,
  the weight ciphertext an input, dropped with the stack when
  ``add_public_keys`` replaces the keys;
- the two per-call host uploads gone: the galois permutation and BEHZ's
  ``tilde_mod_mtilde`` are device constants read from a cache.

The ``cuda`` cases capture units 2 (keystream), 4 (finish) and 5 (the 1FC
evaluation) at N=2048 on a card and compare them with their bodies under
``torch.equal``; they skip without one (chip_smoke.py's graphs phase runs
every unit at the production layouts)."""

import types

import numpy as np
import pytest
import torch

from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.ops import helin as jhelin
from hhe_tpu.ops import pasta as jpasta
from hhe_tpu.workloads import hhe_inference as jwk
from hhe_tpu_torch import convert
from hhe_tpu_torch.ops import bfv as tbfv
from hhe_tpu_torch.ops import bfv_eval as tev
from hhe_tpu_torch.ops import helin as thelin
from hhe_tpu_torch.ops import mod_kernels, ntt_kernels
from hhe_tpu_torch.ops import transcipher as ttr
from hhe_tpu_torch.parallel import limb_shard
from hhe_tpu_torch.parties.analyst import Analyst
from hhe_tpu_torch.parties.csp import CSP
from hhe_tpu_torch.utils import graphs
from hhe_tpu_torch.workloads import hhe_inference as twk

PARAMS = dict(n=2048, data_limbs=4, seed=11)  # test_transcipher.py's make_stack(2048, 4)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test worker (the suite runs several on one
    CPU)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Rerun:
    """Stand-in for ``graphs.CudaGraphs`` on CPU tensors: the capture runs
    the body once; a replay reruns it on the static buffers and copies its
    outputs into the static outputs, counting nothing itself."""

    device_type = "cpu"

    def new_pool(self):
        return object()

    def capture(self, body, pool):
        outs = body()
        return (body, outs), outs

    def replay(self, graph):
        body, outs = graph
        before = [dict(c) for c in graphs.COUNTERS]
        fresh = body()
        for c, b in zip(graphs.COUNTERS, before):
            c.clear()
            c.update(b)
        for o, f in zip(outs, fresh):
            o.copy_(f)


@pytest.fixture
def rerun(monkeypatch):
    monkeypatch.setattr(graphs, "BACKEND", Rerun())
    graphs.reset_counts()
    yield
    graphs.reset_counts()


@pytest.fixture(scope="module")
def stacks():
    jst = jwk.build_stack(jbfv.BFVParams(**PARAMS), input_len=300)
    tst = twk.build_stack(tbfv.BFVParams(**PARAMS), input_len=300, device=CPU)
    return jst, tst


def same(t_obj, j_arr):
    return np.array_equal(convert.to_numpy(t_obj), np.asarray(j_arr).astype(np.uint32))


# ---------------------------------------------------------------------------
# The mechanism, on a small function
# ---------------------------------------------------------------------------


def _affine(x, w, scale):
    """A unit that 'launches' one K3 and one K5 add per call, as a wrapper
    counts them."""
    mod_kernels.LAUNCHES["mont_mul"] += 1
    mod_kernels.LAUNCHES["mod_elem"] += 1
    mod_kernels.OP_LAUNCHES["add"] += 1
    return x * scale + w, x.sum(-1)


def _inputs(seed, shape=(3, 8)):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 100, shape)), torch.as_tensor(rng.integers(0, 100, shape))


def test_entries_by_layout_and_constant(rerun):
    """A new shape, dtype or constant gives a new entry; the same layout
    replays its entry; a strided view shares the contiguous layout's."""
    unit = graphs.jit(_affine, "affine", types.SimpleNamespace())
    x, w = _inputs(0)
    two, three = 2, 3
    unit(x, w, two)
    assert len(unit.entries) == 1 and graphs.CAPTURES["affine"] == 1
    unit(*_inputs(1), two)
    assert len(unit.entries) == 1 and graphs.REPLAYS["affine"] == 1
    wide = torch.as_tensor(np.arange(48).reshape(6, 8))
    unit(wide[::2], wide[1::2], two)  # strided views of the same shape: the same entry
    assert len(unit.entries) == 1 and graphs.REPLAYS["affine"] == 2
    unit(*_inputs(2, (4, 8)), two)  # a new shape
    unit(x.to(torch.int32), w, two)  # a new dtype
    unit(x, w, three)  # a new constant
    assert len(unit.entries) == 4 and graphs.CAPTURES["affine"] == 4
    assert unit.entry(x, w, three).consts == [three]
    assert graphs.REPLAYS["affine"] == 2


def test_replay_equals_body_and_results_are_clones(rerun):
    """Each replay equals the body on its own inputs, and a result stays
    as it was after later calls with other inputs (the clone check)."""
    unit = graphs.jit(_affine, "affine", types.SimpleNamespace())
    args = [_inputs(s) for s in range(4)]
    outs = [unit(x, w, 5) for x, w in args]
    kept = [tuple(o.clone() for o in out) for out in outs]
    for (x, w), out, k in zip(args, outs, kept):
        want = _affine(x, w, 5)
        assert all(torch.equal(o, e) and torch.equal(o, c) for o, e, c in zip(out, want, k))
    assert graphs.REPLAYS["affine"] == 3
    entry = unit.entry(*args[0], 5)
    assert all(o.data_ptr() != s.data_ptr() for o in outs[-1] for s in entry.static_out)


def test_counters_credited_on_every_replay(rerun):
    """The first call counts its eager run; the capture counts nothing; each
    replay adds what the capture counted, per kernel, form and op."""
    mod_kernels.reset_launches()
    ntt_kernels.reset_launches()
    unit = graphs.jit(_affine, "affine", types.SimpleNamespace())
    x, w = _inputs(0)
    unit(x, w, 2)
    assert mod_kernels.LAUNCHES["mont_mul"] == 1 and mod_kernels.OP_LAUNCHES["add"] == 1
    entry = unit.entry(x, w, 2)
    assert entry.counted[1] == {"mont_mul": 1, "mod_elem": 1} and entry.counted[3] == {"add": 1}
    assert entry.kernels == 2
    for i in range(1, 4):
        unit(x, w, 2)
        assert mod_kernels.LAUNCHES["mont_mul"] == mod_kernels.LAUNCHES["mod_elem"] == 1 + i
        assert mod_kernels.OP_LAUNCHES["add"] == 1 + i
    assert entry.replays == 3 and ntt_kernels.LAUNCHES["ntt_fwd"] == 0
    mod_kernels.reset_launches()


def test_lru_eviction_drops_the_oldest(rerun):
    unit = graphs.jit(_affine, "affine", types.SimpleNamespace())
    for n in range(1, graphs.MAX_ENTRIES + 2):
        unit(*_inputs(n, (n, 4)), 1)
    assert len(unit.entries) == graphs.MAX_ENTRIES
    assert unit.entry(*_inputs(0, (1, 4)), 1) is None
    assert unit.entry(*_inputs(0, (2, 4)), 1) is not None


def test_one_pool_per_owner(rerun):
    owner = type("Owner", (), {})()
    a = graphs.jit(_affine, "a", owner)
    b = graphs.jit(_affine, "b", owner)
    assert graphs.pool(owner) is graphs.pool(owner)
    assert graphs.pool(type("Owner", (), {})()) is not graphs.pool(owner)
    assert a.owner is b.owner


def test_failed_capture_raises_and_keeps_no_entry(rerun, monkeypatch):
    """A capture that fails raises (nothing falls back to the body), keeps
    no entry and leaves the counters as the eager run left them."""

    def refuse(body, pool):
        body()
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphs.BACKEND, "capture", refuse)
    mod_kernels.reset_launches()
    unit = graphs.jit(_affine, "affine", types.SimpleNamespace())
    with pytest.raises(RuntimeError, match="capturing"):
        unit(*_inputs(0), 2)
    assert not unit.entries and mod_kernels.LAUNCHES["mont_mul"] == 1
    mod_kernels.reset_launches()


def test_cpu_tensor_goes_to_the_body(stacks):
    """Under the real backend a CPU tensor runs the body and makes no entry,
    no pool and no count."""
    _, tst = stacks
    graphs.reset_counts()
    assert isinstance(graphs.BACKEND, graphs.CudaGraphs)
    tc = tst.tc
    ks = torch.as_tensor(np.random.default_rng(3).integers(0, 1 << 29, (2, tst.ctx.k, tst.ctx.n)),
                         dtype=torch.int32)
    chunk = torch.as_tensor(np.random.default_rng(4).integers(0, 60000, (2, 128)), dtype=torch.int32)
    got = tc._jit_finish(ks, chunk)
    assert torch.equal(got, tc._finish_impl(ks, chunk))
    assert not tc._jit_finish.entries and not graphs.REPLAYS and not graphs.CAPTURES
    assert getattr(tst.ctx, "_graph_pool", None) is None


# ---------------------------------------------------------------------------
# The units against the JAX package's jitted ones
# ---------------------------------------------------------------------------


def _encrypted(jst, x):
    key = jpasta.get_fixed_symmetric_key()
    sym = jpasta.Pasta(key, jst.ctx.t).encrypt(x.astype(np.uint64))
    return sym, jst.tc.encrypt_key(jst.pk, key)


def test_decompose_units_replay_match_jax(stacks, rerun, monkeypatch):
    """csp_decompose at L=128: the first call (the bodies of expand,
    keystream and finish) and, with the keystream caches cleared, the
    second (their replays) each equal the JAX package's result bit for bit.
    At L=300 one call, whose first block captures the seeded keystream and
    whose later blocks replay it, equals the bodies' result (which
    test_torch_workloads.py holds against the JAX package)."""
    jst, tst = stacks
    tc = tst.tc
    rng = np.random.default_rng(21)
    tc.clear_caches()
    x = rng.integers(0, 64, (2, 128))
    sym, jkey = _encrypted(jst, x)
    want = jwk.csp_decompose(jst, jkey, sym).data
    tkey = convert.ciphertext(jkey, CPU)
    first = twk.csp_decompose(tst, tkey, sym).data
    assert same(first, want) and not graphs.REPLAYS
    assert dict(graphs.CAPTURES) == {"expand": 1, "keystream": 1, "finish": 1}
    tc.clear_caches()
    again = twk.csp_decompose(tst, tkey, sym).data
    assert same(again, want) and same(first, want)
    assert dict(graphs.REPLAYS) == {"expand": 1, "keystream": 1, "finish": 1}

    graphs.reset_counts()
    tc.clear_caches()
    x = rng.integers(0, 64, (2, 300))
    sym, _ = _encrypted(jst, x)
    got = twk.csp_decompose(tst, tkey, sym).data
    assert dict(graphs.CAPTURES) == {"keystream_seeded": 1, "finish": 1}  # [2, 44]
    assert dict(graphs.REPLAYS) == {"keystream_seeded": 2, "finish": 2}  # [2, 128] twice
    tc.clear_caches()
    monkeypatch.setattr(graphs, "BACKEND", graphs.CudaGraphs())  # CPU tensors: the bodies
    assert torch.equal(got, twk.csp_decompose(tst, tkey, sym).data)
    tc.clear_caches()


def test_csp_eval_1fc_unit_replay_matches_jax(stacks, rerun):
    """csp_eval_1fc with and without the sum: one unit per do_sum on the
    stack, its first call and its replay (on other data) each equal to the
    JAX package's ``_jit_1fc_{do_sum}``."""
    jst, tst = stacks
    jc = jst.ctx
    rng = np.random.default_rng(22)
    w = rng.integers(-3, 4, 128)
    jw = jhelin.encrypt_weight(jc, jst.pk, w[None, :])[0]
    jwct = jbfv.Ciphertext(jw.data[:, None])
    twct = convert.ciphertext(jwct, CPU)
    datas = [jwk.csp_decompose(jst, *reversed(_encrypted(jst, rng.integers(0, 64, (2, 128)))))
             for _ in range(2)]
    for do_sum in (False, True):
        results = []
        for d in datas:
            want = jwk.csp_eval_1fc(jst, d, jwct, do_sum=do_sum).data
            got = twk.csp_eval_1fc(tst, convert.ciphertext(d, CPU), twct, do_sum=do_sum).data
            assert same(got, want)
            results.append((got, want))
        assert all(same(g, w_) for g, w_ in results)  # the first result kept its values
        unit = tst.__dict__[f"_jit_1fc_{do_sum}"]
        assert len(unit.entries) == 1 and unit.entry(
            convert.ciphertext(datas[0], CPU).data, twct.data, tst.rk, tst.gks).replays == 1


# ---------------------------------------------------------------------------
# The parties' CSP on the 1FC unit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def csp_env():
    analyst = Analyst(tbfv.BFVParams(n=1024, data_limbs=13, seed=120), input_len=128, device=CPU)
    analyst.encrypt_model(np.random.default_rng(23).integers(-3, 4, (128, 1)))
    csp = CSP(tbfv.BFVParams(n=1024, data_limbs=13, seed=42), device=CPU)
    csp.add_public_keys("a", analyst.keys_msg())
    csp.add_ml_model("a", analyst.model_msg())
    return csp, analyst


def test_csp_unit_equals_body_and_is_dropped_with_its_keys(csp_env, rerun):
    """The parties' CSP evaluates through its analyst stack's 1FC unit with
    the sum: the results equal ``_fc_body``'s, the second ciphertext
    replays; ``add_ml_model`` changes the results and not the unit (the
    weight ciphertext is an input), ``add_public_keys`` makes a new stack
    and with it a new unit."""
    csp, analyst = csp_env
    ctx = analyst.ctx
    rng = np.random.default_rng(24)
    cts = [ctx.encrypt(analyst.pk, ctx.encode(rng.integers(0, 16, 128))) for _ in range(2)]
    st = csp.state("a")
    stack = st.stack

    def bodies():
        return [twk._fc_body(stack.ctx, True, ct.data, st.weight_cts[0].data, stack.rk, stack.gks)
                for ct in cts]

    want = bodies()
    outs = csp.evaluate_model("a", cts)  # the first call, then a replay
    assert all(torch.equal(o.data, b) for o, b in zip(outs, want))
    unit = stack._jit_1fc_True
    assert len(unit.entries) == 1 and graphs.REPLAYS["eval_1fc"] == 1
    analyst.encrypt_model(np.random.default_rng(25).integers(-3, 4, (128, 1)))
    csp.add_ml_model("a", analyst.model_msg())
    want2 = bodies()
    outs2 = csp.evaluate_model("a", cts)
    assert st.stack is stack and stack._jit_1fc_True is unit and len(unit.entries) == 1
    assert all(torch.equal(o.data, b) for o, b in zip(outs2, want2))
    assert not torch.equal(outs2[0].data, outs[0].data)
    csp.add_public_keys("a", analyst.keys_msg())
    assert st.stack is not stack and "_jit_1fc_True" not in vars(st.stack)
    assert torch.equal(csp.evaluate_model("a", cts[:1])[0].data, want2[0])
    assert st.stack._jit_1fc_True is not unit


# ---------------------------------------------------------------------------
# The per-call host uploads, now device constants
# ---------------------------------------------------------------------------


def test_galois_and_tilde_constants_are_cached(stacks, monkeypatch):
    """The galois permutation and BEHZ's (Q/q_j) mod m_tilde are device
    tensors made once: a second call reads the same tensors, and a rotation
    and a multiply upload nothing once they exist."""
    _, tst = stacks
    ctx = tst.ctx
    g = ctx.galois_elt_from_step(1)
    src, sign = ctx.galois_perm_device(g)
    assert ctx.galois_perm_device(g)[0] is src and ctx.galois_perm_device(g)[1] is sign
    hsrc, hsign = ctx.galois_perm(g)
    assert np.array_equal(src.numpy(), hsrc) and np.array_equal(sign.numpy(), hsign)
    ec = tev.eval_consts(ctx)
    assert ec.tilde_mod_mtilde is tev.eval_consts(ctx).tilde_mod_mtilde
    assert ec.tilde_mod_mtilde.shape == (ctx.k, 1) and ec.tilde_mod_mtilde.dtype == torch.int64
    assert ec.tilde_mod_mtilde.device == ctx.device
    assert ec.tilde_mod_mtilde[:, 0].tolist() == [t % ctx.m_tilde for t in ctx.base_q.tilde]
    view = types.SimpleNamespace(whole_ctx=ctx)  # a LimbView reads its whole context's
    assert limb_shard.LimbView.galois_perm_device(view, g)[0] is src

    rng = np.random.default_rng(25)
    ct = tbfv.Ciphertext(torch.stack([
        torch.as_tensor(np.stack([rng.integers(0, q, ctx.n) for q in ctx.q_moduli]),
                        dtype=torch.int32) for _ in range(2)]))
    rot = tev.apply_galois(ctx, ct, g, tst.gks[g])
    prod = tev.multiply(ctx, ct, ct)

    def refuse(*args, **kw):
        raise AssertionError("a host upload on a warm call")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    assert torch.equal(tev.apply_galois(ctx, ct, g, tst.gks[g]).data, rot.data)
    assert torch.equal(tev.multiply(ctx, ct, ct).data, prod.data)


# ---------------------------------------------------------------------------
# On a card: units 2, 4 and 5 captured and replayed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_stack():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's graphs phase runs this on the card")
    return twk.build_stack(tbfv.BFVParams(n=2048, data_limbs=4, seed=11), input_len=128,
                           device="cuda")


def _replays_equal(unit, args_a, args_b):
    """The body and the replay agree on two inputs, and the first replay's
    result is unchanged by the second."""
    unit(*args_a)  # the body, then the capture, where the layout is new
    entry = unit.entry(*args_a)
    before = entry.replays
    want_a, want_b = unit.fn(*args_a), unit.fn(*args_b)
    got_a = unit(*args_a)
    got_b = unit(*args_b)
    torch.cuda.synchronize()
    pairs = [(got_a, want_a), (got_b, want_b)]
    return entry.replays == before + 2 and all(
        torch.equal(g, w) for got, want in pairs
        for g, w in zip(graphs._tuple(got), graphs._tuple(want)))


@pytest.mark.cuda
def test_keystream_graph_matches_body_on_cuda(cuda_stack):
    tc = cuda_stack.tc
    key = tc.encrypt_key(cuda_stack.pk, jpasta.get_fixed_symmetric_key())
    args = [(key.data, *tc.device_block_plaintexts(nonce, 0), tc._keys()) for nonce in (7, 8)]
    assert _replays_equal(tc._jit_keystream, *args)


@pytest.mark.cuda
def test_finish_graph_matches_body_on_cuda(cuda_stack):
    tc, ctx = cuda_stack.tc, cuda_stack.ctx
    rng = np.random.default_rng(26)
    args = [(torch.as_tensor(np.stack([rng.integers(0, q, (2, ctx.n)) for q in ctx.q_moduli], 1),
                             dtype=torch.int32, device="cuda"),
             torch.as_tensor(rng.integers(0, ctx.t, (4, 128)), dtype=torch.int32, device="cuda"))
            for _ in range(2)]
    assert _replays_equal(tc._jit_finish, *args)


@pytest.mark.cuda
def test_eval_1fc_graph_matches_body_on_cuda(cuda_stack):
    st, ctx = cuda_stack, cuda_stack.ctx
    rng = np.random.default_rng(27)
    w = thelin.encrypt_weight(ctx, st.pk, rng.integers(-3, 4, (1, 128)))[0]
    cts = [ctx.encrypt(st.pk, ctx.encode(rng.integers(0, 64, 128))) for _ in range(2)]
    twk.csp_eval_1fc(st, cts[0], w, do_sum=True)  # makes the unit
    unit = st.__dict__["_jit_1fc_True"]
    args = [(ct.data, w.data, st.rk, st.gks) for ct in cts]
    assert _replays_equal(unit, *args)
