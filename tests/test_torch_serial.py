"""The port's ``utils/serial`` against the JAX package's, both ways (CPU):
every ``dump_*`` writes JAX's bytes, every ``load_*`` of JAX-written bytes
reads JAX's arrays, and the zlib container round-trips and refuses a corrupt
or truncated payload in both packages.  Inputs come from numpy seeds; keys
and ciphertexts are made by the JAX package (N=1024, 3 limbs) and carried
over with ``convert``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hhe_tpu.ops import bfv as jbfv
from hhe_tpu.utils import serial as jserial
from hhe_tpu_torch import convert
from hhe_tpu_torch.utils import serial as tserial

CPU = torch.device("cpu")
PARAMS = dict(n=1024, data_limbs=3, seed=11)


def same(t_arr, j_arr) -> bool:
    return np.array_equal(convert.to_numpy(t_arr), np.asarray(j_arr).astype(np.uint32))


@pytest.fixture(scope="module")
def objs():
    """JAX keys and ciphertexts (a 2- and a 3-component one, a batched one)
    and the port's copies."""
    jc = jbfv.Context(jbfv.BFVParams(**PARAMS))
    sk = jc.keygen_secret()
    pk = jc.keygen_public(sk)
    rk = jc.keygen_relin(sk)
    gks = jc.keygen_galois(sk, [jc.galois_elt_from_step(s) for s in (1, -4)] + [2 * jc.n - 1])
    rng = np.random.default_rng(3)
    cts = [jc.encrypt(pk, jc.encode(rng.integers(0, jc.t, 200))) for _ in range(3)]
    cts.append(jbfv.Ciphertext(jnp.concatenate([cts[0].data, cts[1].data[:1]])))  # size 3
    cts.append(jbfv.Ciphertext(jnp.stack([c.data for c in cts[:3]], 1)))  # [2, 3, k, N]
    return dict(
        pk=pk, rk=rk, gks=gks, cts=cts,
        tpk=convert.public_key(pk), trk=convert.kswitch_key(rk, CPU),
        tgks=convert.galois_keys(gks, CPU), tcts=[convert.ciphertext(c, CPU) for c in cts],
    )


KINDS = ["ciphertext", "ciphertext_3", "ciphertext_batch", "public_key", "kswitch",
         "galois_keys", "ciphertext_vec"]


def _dumps(o, kind):
    """(port bytes, JAX bytes) of one object."""
    return {
        "ciphertext": (lambda: tserial.dump_ciphertext(o["tcts"][0]),
                       lambda: jserial.dump_ciphertext(o["cts"][0])),
        "ciphertext_3": (lambda: tserial.dump_ciphertext(o["tcts"][3]),
                         lambda: jserial.dump_ciphertext(o["cts"][3])),
        "ciphertext_batch": (lambda: tserial.dump_ciphertext(o["tcts"][4]),
                             lambda: jserial.dump_ciphertext(o["cts"][4])),
        "public_key": (lambda: tserial.dump_public_key(o["tpk"]),
                       lambda: jserial.dump_public_key(o["pk"])),
        "kswitch": (lambda: tserial.dump_kswitch(o["trk"]), lambda: jserial.dump_kswitch(o["rk"])),
        "galois_keys": (lambda: tserial.dump_galois_keys(o["tgks"]),
                        lambda: jserial.dump_galois_keys(o["gks"])),
        "ciphertext_vec": (lambda: tserial.dump_ciphertext_vec(o["tcts"][:4]),
                           lambda: jserial.dump_ciphertext_vec(o["cts"][:4])),
    }[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_dump_bytes_identical(objs, kind):
    got, want = _dumps(objs, kind)
    b = got()
    assert isinstance(b, bytes) and b == want()


def _assert_loaded_equal(kind, t_obj, j_obj):
    if kind.startswith("ciphertext") and kind != "ciphertext_vec":
        assert t_obj.data.device == CPU and t_obj.data.dtype == torch.int32
        assert same(t_obj.data, j_obj.data)
    elif kind == "public_key":
        assert isinstance(t_obj.data, np.ndarray) and t_obj.data.dtype == np.uint32
        assert np.array_equal(t_obj.data, np.asarray(j_obj.data))
    elif kind == "kswitch":
        assert same(t_obj.k0, j_obj.k0) and same(t_obj.k1, j_obj.k1)
    elif kind == "galois_keys":
        assert sorted(t_obj) == sorted(j_obj)
        for g in j_obj:
            _assert_loaded_equal("kswitch", t_obj[g], j_obj[g])
    else:
        assert len(t_obj) == len(j_obj)
        for t, j in zip(t_obj, j_obj):
            _assert_loaded_equal("ciphertext", t, j)


def _loads(kind):
    """(port loader on the CPU, JAX loader) for the bytes of one kind."""
    if kind.startswith("ciphertext") and kind != "ciphertext_vec":
        return (lambda b: tserial.load_ciphertext(b, CPU)), jserial.load_ciphertext
    return {
        "public_key": (tserial.load_public_key, jserial.load_public_key),
        "kswitch": ((lambda b: tserial.load_kswitch(b, CPU)), jserial.load_kswitch),
        "galois_keys": ((lambda b: tserial.load_galois_keys(b, CPU)), jserial.load_galois_keys),
        "ciphertext_vec": ((lambda b: tserial.load_ciphertext_vec(b, CPU)),
                           jserial.load_ciphertext_vec),
    }[kind]


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "zlib"])
@pytest.mark.parametrize("kind", KINDS)
def test_load_jax_bytes_matches_jax(objs, kind, compressed):
    """JAX-written bytes (raw or in JAX's zlib container) read by the port
    equal what the JAX package reads back."""
    b = _dumps(objs, kind)[1]()
    if compressed:
        b = jserial.compress(b)
    tload, jload = _loads(kind)
    _assert_loaded_equal(kind, tload(b), jload(b))


def test_compress_round_trip_matches_jax(objs):
    raw = _dumps(objs, "galois_keys")[1]()
    for level in (1, 6, 9):
        z = tserial.compress(raw, level)
        assert z == jserial.compress(raw, level) and z[:4] == tserial.MAGIC_Z
        assert len(z) < len(raw)
        assert tserial.decompress(z) == jserial.decompress(z) == raw
    assert tserial.decompress(raw) is raw  # not a container: passed through
    assert (tserial.KIND_CT, tserial.KIND_PK, tserial.KIND_KSK) == (
        jserial.KIND_CT, jserial.KIND_PK, jserial.KIND_KSK)


@pytest.mark.parametrize("fault", ["corrupt", "truncated", "wrong_length"])
def test_bad_container_raises_value_error_in_both(objs, fault):
    raw = _dumps(objs, "ciphertext")[1]()
    z = bytearray(jserial.compress(raw))
    if fault == "corrupt":
        z[20:40] = bytes(20)
    elif fault == "truncated":
        z = z[: len(z) // 2]
    else:  # the header's length disagrees with the payload
        z[4:12] = (len(raw) + 1).to_bytes(8, "little")
    for decompress in (tserial.decompress, jserial.decompress):
        with pytest.raises(ValueError, match="corrupt compressed payload"):
            decompress(bytes(z))
    with pytest.raises(ValueError):
        tserial.load_ciphertext(bytes(z), CPU)


def test_load_array_round_trip_and_bad_header():
    rng = np.random.default_rng(4)
    for arr in (rng.integers(-128, 128, (3, 5), dtype=np.int8),
                rng.integers(0, 1 << 32, (2, 3, 4), dtype=np.uint64).astype(np.uint32),
                np.uint32(7)):
        b = tserial.dump_array(arr)
        assert b == jserial.dump_array(arr)
        got, off = tserial.load_array(b + b, len(b))
        want, joff = jserial.load_array(b + b, len(b))
        assert off == joff == 2 * len(b)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="bad serialization header"):
        tserial.load_array(b"XXXX" + bytes(8))


def test_tensor_loaders_take_the_device_explicitly(objs):
    b = _dumps(objs, "ciphertext")[1]()
    for load in (tserial.load_ciphertext, tserial.load_kswitch, tserial.load_galois_keys,
                 tserial.load_ciphertext_vec):
        with pytest.raises(TypeError):
            load(b)
