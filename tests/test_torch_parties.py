"""The port's three parties (``hhe_tpu_torch.parties``) on the CPU, at the
N=1024 / 13-limb parameters of ``test_parties.py``:

- bit-identity without a wire: the port's Analyst writes the JAX Analyst's
  key and model messages for the same seed, the port's User the JAX User's
  key and data, and a port CSP and a JAX CSP fed the same messages write the
  same checkpoint file and serialize the same results;
- the port's versions of ``test_parties.py``'s wire tests (gRPC servers on
  localhost), a JAX Analyst and User against the port's CSPServer, and the
  typed gRPC statuses;
- the parties' CUDA default.

One port CSP and two port analysts (input lengths 300 and 128) are started
once at module scope, as in ``test_parties.py``.  Ports 50971-50975 are this
file's alone."""

import dataclasses
import sys
import threading

import grpc
import numpy as np
import pytest
import torch

from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.parties.analyst import Analyst as JAnalyst
from hhe_tpu.parties.analyst import AnalystServer as JAnalystServer
from hhe_tpu.parties.csp import CSP as JCSP
from hhe_tpu.parties.gen import hhe_pb2 as jpb
from hhe_tpu.parties.user import User as JUser
from hhe_tpu.utils import serial as jserial
from hhe_tpu_torch.ops import bfv
from hhe_tpu_torch.parties import rpc
from hhe_tpu_torch.parties.analyst import Analyst, AnalystServer
from hhe_tpu_torch.parties.csp import CSP, CSPServer
from hhe_tpu_torch.parties.gen import hhe_pb2 as pb
from hhe_tpu_torch.parties.user import User, patient_id_from_path
from hhe_tpu_torch.utils import checks, metrics, serial

CPU = "cpu"
PARAMS = bfv.BFVParams(n=1024, data_limbs=13, seed=42)
JPARAMS = jbfv.BFVParams(n=1024, data_limbs=13, seed=42)
CSP_ADDR = "localhost:50972"
ANALYST_ADDRS = ("localhost:50973", "localhost:50971")
JAX_ANALYST_ADDR = "localhost:50974"
STATUS_ADDR = "localhost:50975"
LENS = (300, 128)  # analyst 0: 3-block mask+flatten; analyst 1: single block


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the suite runs several test workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def analyst_params(i):
    return dict(n=1024, data_limbs=13, seed=100 + i)


class _WireEnv:
    def __init__(self, tmp_path):
        rng = np.random.default_rng(7)
        self.tmp_path = tmp_path
        self.csp = CSP(PARAMS, workdir=str(tmp_path), device=CPU)
        self.cserver = CSPServer(self.csp, CSP_ADDR)
        self.analysts, self.aservers, self.ws = [], [], []
        for i, (L, addr) in enumerate(zip(LENS, ANALYST_ADDRS)):
            w = rng.integers(-3, 4, (L, 1))
            a = Analyst(bfv.BFVParams(**analyst_params(i)), input_len=L, device=CPU)
            a.encrypt_model(w)
            srv = AnalystServer(a, addr)
            srv.publish_to_csp(CSP_ADDR)
            self.ws.append(w)
            self.analysts.append(a)
            self.aservers.append(srv)

    def stop(self):
        for srv in self.aservers:
            srv.stop()
        self.cserver.stop()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = _WireEnv(tmp_path_factory.mktemp("wire"))
    try:
        yield e
    finally:
        e.stop()


@pytest.fixture(scope="module")
def jax_analyst(env):
    """The JAX Analyst with the seed, input length and weights of the
    port's analyst 0."""
    a = JAnalyst(jbfv.BFVParams(**analyst_params(0)), input_len=LENS[0])
    a.encrypt_model(env.ws[0])
    return a


def _key_msg(ct_bytes):
    msg = pb.EncSymmetricKeysMsg()
    msg.key.append(pb.CiphertextMsg(data=ct_bytes, length=len(ct_bytes)))
    return msg


def test_patient_id_parsing():
    assert patient_id_from_path("/x/y/c000101_data.txt") == "c000101"


def test_analyst_messages_identical_to_jax(env, jax_analyst):
    """Same seed -> the same keys: every key field of keys_msg() and the
    whole model_msg() byte-identical (the UUID differs by design); both
    packages' message classes are one class."""
    assert pb.PublicKeySetMsg is jpb.PublicKeySetMsg and pb.Empty is jpb.Empty
    mine, ref = env.analysts[0], jax_analyst
    assert np.array_equal(mine.sk.s_small, ref.sk.s_small)
    assert (mine.gk_elts, mine.csp_gk_elts) == (ref.gk_elts, ref.csp_gk_elts)
    assert mine.csp_gk_elts  # L=300: the flatten keys ride csp_gk
    tk, jk = mine.keys_msg(), ref.keys_msg()
    for field in ("pk", "rk", "gk", "csp_rk", "csp_gk"):
        t, j = getattr(tk, field), getattr(jk, field)
        assert t.length == j.length == len(j.data) and t.data == j.data, field
    assert tk.analystUUID == mine.uuid != jk.analystUUID
    assert mine.model_msg().SerializeToString() == ref.model_msg().SerializeToString()


def test_user_messages_identical_to_jax(env):
    """The User's HE-encrypted PASTA key and its PASTA-encrypted rows."""
    x = np.random.default_rng(9).integers(0, 32, (3, LENS[0]))
    mine, ref = User(PARAMS, data=x, device=CPU), JUser(JPARAMS, data=x)
    pk_bytes = serial.dump_public_key(env.analysts[0].pk)
    assert serial.dump_ciphertext(mine.encrypt_sym_key(pk_bytes)) == jserial.dump_ciphertext(
        ref.encrypt_sym_key(pk_bytes)
    )
    for rows in (None, slice(0, 2)):
        got, want = mine.encrypt_data(rows), ref.encrypt_data(rows)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_csp_checkpoint_and_results_identical_to_jax(env, tmp_path):
    """A port CSP and a JAX CSP fed the same messages (analyst 1's keys and
    model, a user's key and two records): the same checkpoint file, byte
    for byte, and the same evaluate_model results."""
    analyst, w = env.analysts[1], env.ws[1]
    x = np.random.default_rng(10).integers(0, 32, (2, LENS[1]))
    user = User(PARAMS, data=x, device=CPU)
    keys = analyst.keys_msg()
    key_msg = _key_msg(serial.dump_ciphertext(user.encrypt_sym_key(keys.pk.data)))
    records = user.encrypt_data()
    files = {}
    (tmp_path / "jax").mkdir()
    csps = {"port": CSP(PARAMS, workdir=str(tmp_path), device=CPU),
            "jax": JCSP(JPARAMS, workdir=str(tmp_path / "jax"))}
    for name, csp in csps.items():
        csp.add_public_keys("a", keys)
        csp.add_ml_model("a", analyst.model_msg())
        csp.add_encrypted_keys("a", key_msg)
        with open(csp.add_encrypted_data("a", records, "c000101"), "rb") as f:
            files[name] = f.read()
    assert np.array_equal(csps["port"].sk.s_small, csps["jax"].sk.s_small)
    assert files["port"] == files["jax"]
    assert csps["port"].state("a").input_len == LENS[1]

    got = csps["port"].evaluate_model("a", serial.load_ciphertext_vec(files["port"], CPU))
    want = csps["jax"].evaluate_model("a", jserial.load_ciphertext_vec(files["jax"]))
    got_b = [serial.dump_ciphertext(c) for c in got]
    assert len(got_b) == 2 and got_b == [jserial.dump_ciphertext(c) for c in want]
    for b in got_b:
        analyst.decrypt_result_bytes(b)
    assert analyst.raw_results[-2:] == list(x.astype(np.int64) @ w.reshape(-1))
    del analyst.raw_results[-2:], analyst.predictions[-2:]


def test_three_party_protocol(env):
    """Port version of test_parties.py::test_three_party_protocol: submit,
    checkpoint file, evaluateModelFromFile resume, evaluateModel with the
    ciphertexts split across repeated HHEDecomp entries, and the
    experiment report."""
    rng = np.random.default_rng(8)
    analyst, aserver, w = env.analysts[1], env.aservers[1], env.ws[1]
    L = LENS[1]
    x = rng.integers(0, 32, (2, L))
    analyst.raw_results.clear()
    analyst.predictions.clear()
    aserver.results_ready.clear()

    user = User(PARAMS, data=x, device=CPU)
    user.submit(ANALYST_ADDRS[1], CSP_ADDR, "c000101")

    fname = f"c000101_{analyst.uuid}.bin"
    assert (env.tmp_path / fname).exists()

    client = rpc.csp_client(CSP_ADDR)
    client.call("evaluateModelFromFile", pb.DataFile(filename=fname))
    client.close()

    assert aserver.results_ready.wait(timeout=300)
    expect_raw = x.astype(np.int64) @ w.reshape(-1)
    assert np.array_equal(np.asarray(analyst.raw_results), expect_raw)
    assert np.array_equal(np.asarray(analyst.predictions), (expect_raw > 0).astype(int))

    timer, ledger = metrics.merge(
        timers=(analyst.timer, user.timer, env.csp.timer),
        ledgers=(analyst.ledger, user.ledger, env.csp.ledger),
    )
    acc = float(np.mean((expect_raw > 0).astype(int) == np.asarray(analyst.predictions)))
    report = metrics.experiment_report(timer, ledger, accuracy=acc)
    print(metrics.format_experiment_report(report), flush=True)
    for party in ("analyst", "user", "csp", "total"):
        assert report["computation_ms"][party] > 0.0, party
    for edge in ("analyst-user", "user-csp", "analyst-csp", "total"):
        assert report["communication_mb"][edge] > 0.0, edge
    assert report["accuracy"] == 1.0

    cts = serial.load_ciphertext_vec((env.tmp_path / fname).read_bytes(), CPU)
    assert len(cts) == 2  # one per submitted record
    analyst.raw_results.clear()
    analyst.predictions.clear()
    aserver.results_ready.clear()
    msg = pb.CiphertextBytes(analystID=analyst.uuid)
    for ct in cts:  # one frame per repeated entry — multi-record payload
        msg.HHEDecomp.append(serial.dump_ciphertext_vec([ct]))
    client = rpc.csp_client(CSP_ADDR)
    client.call("evaluateModel", msg)
    client.close()
    assert aserver.results_ready.wait(timeout=300)
    assert np.array_equal(np.asarray(analyst.raw_results), expect_raw)


def test_two_analysts_long_input_over_wire(env):
    """Port version of test_parties.py::test_two_analysts_long_input_over_wire:
    one CSP serves two analysts with different models and input lengths
    (300: 3-block mask+flatten; 128: one block); each gets its own result."""
    rng = np.random.default_rng(11)
    checks.are_same_he_sk(env.analysts[0].sk, env.analysts[1].sk)
    checks.are_same_he_sk(env.analysts[0].sk, env.csp.sk)
    checks.are_same_he_sk(env.analysts[1].sk, env.csp.sk)

    xs = []
    for i, addr in enumerate(ANALYST_ADDRS):
        xs.append(rng.integers(0, 16, (1, LENS[i])))
        env.analysts[i].raw_results.clear()
        env.analysts[i].predictions.clear()
        env.aservers[i].results_ready.clear()

        user = User(PARAMS, data=xs[i], device=CPU)
        user.submit(addr, CSP_ADDR, f"p{i}")
        assert env.csp.state(addr).input_len == LENS[i]

        client = rpc.csp_client(CSP_ADDR)
        client.call(
            "evaluateModelFromFile",
            pb.DataFile(filename=f"p{i}_{env.analysts[i].uuid}.bin"),
        )
        client.close()
        assert env.aservers[i].results_ready.wait(timeout=300)

    for i in range(2):
        expect = xs[i].astype(np.int64) @ env.ws[i].reshape(-1)
        assert np.array_equal(np.asarray(env.analysts[i].raw_results), expect), i


def test_concurrent_requests_match_serial_results(env):
    """The CSP's handlers run on gRPC's worker threads: two users submit at
    once to one analyst (both decompositions share its transcipher's
    caches), then four evaluateModelFromFile requests run at once, with a
    short thread switch interval; every result is the serial one."""
    analyst, aserver, w = env.analysts[1], env.aservers[1], env.ws[1]
    xs = np.random.default_rng(13).integers(0, 32, (2, 1, LENS[1]))
    analyst.raw_results.clear()
    analyst.predictions.clear()
    errors = []

    def run(fn, *args):
        try:
            fn(*args)
        except Exception as e:  # raised again below, in the test's thread
            errors.append(e)

    def evaluate(pid):
        client = rpc.csp_client(CSP_ADDR)
        client.call("evaluateModelFromFile", pb.DataFile(filename=f"{pid}_{analyst.uuid}.bin"))
        client.close()

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for jobs in (
            [(User(PARAMS, data=x, device=CPU).submit, ANALYST_ADDRS[1], CSP_ADDR, f"q{i}")
             for i, x in enumerate(xs)],
            [(evaluate, f"q{i % 2}") for i in range(4)],
        ):
            threads = [threading.Thread(target=run, args=job) for job in jobs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads) and not errors, errors
    finally:
        sys.setswitchinterval(prev)
    want = [int(x[0].astype(np.int64) @ w.reshape(-1)) for x in xs]
    assert sorted(analyst.raw_results) == sorted(want * 2)


def _state_tensors(obj):
    """Every tensor reachable from obj through dataclass fields, dicts,
    lists and tuples (key and ciphertext tuples included), except the
    transcipher's (its round-material and keystream caches are bounded) and
    the last user's key ciphertext (one, replaced by each submission)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _state_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _state_tensors(v)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if f.name not in ("tc", "enc_key"):
                yield from _state_tensors(getattr(obj, f.name))


def _submit_and_evaluate(env, x, patient_id):
    """User submits x to analyst 1 under patient_id, then
    evaluateModelFromFile on its checkpoint; returns the analyst's results."""
    analyst, aserver = env.analysts[1], env.aservers[1]
    analyst.raw_results.clear()
    analyst.predictions.clear()
    aserver.results_ready.clear()
    User(PARAMS, data=x, device=CPU).submit(ANALYST_ADDRS[1], CSP_ADDR, patient_id)
    client = rpc.csp_client(CSP_ADDR)
    client.call("evaluateModelFromFile",
                pb.DataFile(filename=f"{patient_id}_{analyst.uuid}.bin"))
    client.close()
    assert aserver.results_ready.wait(timeout=300)
    return np.asarray(analyst.raw_results)


def _state_bytes(st) -> int:
    """Bytes of the distinct storages behind the state's tensors."""
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in _state_tensors(st)}
    return sum(storages.values())


def test_submission_keeps_no_device_copy(env):
    """The decomposed batch's only copy is its checkpoint file: after a
    submission the CSP's state for the analyst holds as many tensor bytes
    as before, and evaluateModelFromFile still returns x @ w exactly."""
    st = env.csp.state(ANALYST_ADDRS[1])
    before = _state_bytes(st)
    x = np.random.default_rng(14).integers(0, 32, (2, LENS[1]))
    got = _submit_and_evaluate(env, x, "f10")
    assert _state_bytes(st) == before
    assert (env.tmp_path / f"f10_{env.analysts[1].uuid}.bin").exists()
    assert np.array_equal(got, x.astype(np.int64) @ env.ws[1].reshape(-1))


def test_patient_id_with_underscore_round_trips(env):
    """The UUID is read after the checkpoint name's last '_', so a patient
    id that holds '_' reads back."""
    x = np.random.default_rng(15).integers(0, 32, (1, LENS[1]))
    got = _submit_and_evaluate(env, x, "c000_101")
    assert np.array_equal(got, x.astype(np.int64) @ env.ws[1].reshape(-1))


@pytest.mark.parametrize("name", ["../f11", "f11/x", "f11\0x", "..\\f11", ""])
def test_unsafe_wire_names_get_data_loss(env, name):
    """A patientID or analystUUID that could leave the workdir (or name no
    file) gets DATA_LOSS, and nothing is written outside the workdir."""
    outside = set(env.tmp_path.parent.rglob("*"))
    x = np.random.default_rng(16).integers(0, 32, (1, LENS[1]))
    with pytest.raises(grpc.RpcError) as ei:
        User(PARAMS, data=x, device=CPU).submit(ANALYST_ADDRS[1], CSP_ADDR, name)
    assert ei.value.code() == grpc.StatusCode.DATA_LOSS
    keys = env.analysts[1].keys_msg()
    keys.analystUUID = name
    client = rpc.csp_client(CSP_ADDR)
    try:
        with pytest.raises(grpc.RpcError) as ei:
            client.call("addPublicKeys", keys, metadata=(("analystid", "f11-analyst"),))
        assert ei.value.code() == grpc.StatusCode.DATA_LOSS
    finally:
        client.close()
    assert "f11-analyst" not in env.csp.analysts
    assert set(env.tmp_path.parent.rglob("*")) == outside


def test_jax_analyst_and_user_against_port_csp(env, jax_analyst):
    """Mixed wire: a JAX AnalystServer publishes its keys and model to the
    port's CSPServer, a JAX User submits a 300-word record, and the JAX
    analyst decrypts the right x @ w from the port's results."""
    server = JAnalystServer(jax_analyst, JAX_ANALYST_ADDR)
    try:
        server.publish_to_csp(CSP_ADDR)
        x = np.random.default_rng(12).integers(0, 32, (1, LENS[0]))
        JUser(JPARAMS, data=x).submit(JAX_ANALYST_ADDR, CSP_ADDR, "m0")
        client = rpc.csp_client(CSP_ADDR)
        client.call("evaluateModelFromFile", pb.DataFile(filename=f"m0_{jax_analyst.uuid}.bin"))
        client.close()
        assert server.results_ready.wait(timeout=300)
        expect = x.astype(np.int64) @ env.ws[0].reshape(-1)
        assert np.array_equal(np.asarray(jax_analyst.raw_results), expect)
        assert jax_analyst.predictions == list((expect > 0).astype(int))
    finally:
        server.stop()


def test_typed_grpc_status_on_bad_payload(tmp_path):
    """Bad payloads map to typed statuses, not UNKNOWN (reference
    CSPRPC.cpp:241-244 returns Status(DATA_LOSS, ...))."""
    csp = CSP(PARAMS, workdir=str(tmp_path), device=CPU)
    cserver = CSPServer(csp, STATUS_ADDR)
    try:
        client = rpc.csp_client(STATUS_ADDR)
        msg = _key_msg(b"garbage-not-a-ciphertext")
        with pytest.raises(grpc.RpcError) as ei:
            client.call("addEncryptedKeys", msg, metadata=(("analystid", "a"),))
        assert ei.value.code() == grpc.StatusCode.DATA_LOSS
        zipped = _key_msg(serial.compress(b"x" * 64)[:-3])  # truncated zlib container
        with pytest.raises(grpc.RpcError) as ei:
            client.call("addEncryptedKeys", zipped, metadata=(("analystid", "a"),))
        assert ei.value.code() == grpc.StatusCode.DATA_LOSS
        with pytest.raises(grpc.RpcError) as ei:
            client.call("evaluateModelFromFile", pb.DataFile(filename="nope_deadbeef.bin"))
        assert ei.value.code() in (grpc.StatusCode.NOT_FOUND, grpc.StatusCode.DATA_LOSS)
        csp.uuid_to_id["deadbeef"] = "a"  # a known analyst, but no checkpoint file
        with pytest.raises(grpc.RpcError) as ei:
            client.call("evaluateModelFromFile", pb.DataFile(filename="nope_deadbeef.bin"))
        assert ei.value.code() == grpc.StatusCode.NOT_FOUND
        client.close()
    finally:
        cserver.stop()


@pytest.mark.parametrize("party", ["analyst", "user", "csp"])
def test_parties_default_to_cuda(party):
    """Built without device=, a party asks for CUDA and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    make = {"analyst": lambda: Analyst(PARAMS, input_len=128),
            "user": lambda: User(PARAMS), "csp": lambda: CSP(PARAMS)}[party]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
