"""The port's native host library (``hhe_tpu_torch.native``: C++ SHAKE128,
PASTA block randomness and batched keystreams) against hashlib, the pure
Python expansion, the JAX package's native library and the golden vectors,
as ``test_native.py`` holds the JAX package's; and the choice of expansion
in ``pasta.block_randomness``."""

import hashlib
import pathlib
import shutil

import numpy as np
import pytest

from hhe_tpu_torch import native
from hhe_tpu_torch.ops import pasta


@pytest.fixture(autouse=True)
def needs_gxx():
    """As test_native.py, skip where no g++ can build the library."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the library")


GOLDEN = pathlib.Path(__file__).parent / "data" / "pasta_golden.npz"


@pytest.mark.parametrize("seed", [b"", b"abc", bytes(range(16)), b"x" * 100])
def test_shake128_vs_hashlib(seed):
    assert native.shake128(seed, 500) == hashlib.shake_128(seed).digest(500)


@pytest.mark.parametrize("p", [65537, 2147352577])
def test_block_randomness_matches_python_and_jax(p):
    """The native expansion equals the port's pure-Python one and the JAX
    package's native one, for t = 65537 and the 31-bit t."""
    from hhe_tpu import native as jnative

    m1, m2, r1, r2 = native.pasta_block_randomness(p, 424242, 3)
    pm1, pm2, pr1, pr2 = pasta.block_randomness_python(p, 424242, 3)
    for r in range(pasta.PASTA_R + 1):
        assert np.array_equal(m1[r], pm1[r])
        assert np.array_equal(m2[r], pm2[r])
        assert np.array_equal(r1[r], pr1[r])
        assert np.array_equal(r2[r], pr2[r])
    if jnative.available():
        for mine, theirs in zip((m1, m2, r1, r2), jnative.pasta_block_randomness(p, 424242, 3)):
            assert np.array_equal(mine, theirs)


def test_keystreams_match_golden():
    key = pasta.get_fixed_symmetric_key()
    ks = native.pasta_keystreams(65537, pasta.NONCE, 0, key[None, :])
    gold = np.load(GOLDEN)
    assert np.array_equal(ks[0], gold["ks"][:128])
    x = np.arange(128, dtype=np.uint64)
    assert np.array_equal((x + ks[0]) % np.uint64(65537), pasta.Pasta(key, 65537).encrypt(x))


def test_keystreams_31bit_modulus_and_batch():
    """Any NTT-friendly prime (the 31-bit t of the 2FC path), several keys
    in one call, each equal to the plain keystream."""
    p = 2147352577
    key = pasta.get_fixed_symmetric_key()
    keys = np.stack([key, (key * np.uint64(3) + np.uint64(1)) % np.uint64(p)])
    ks = native.pasta_keystreams(p, pasta.NONCE, 2, keys)
    for i in range(2):
        assert np.array_equal(ks[i], pasta.keystream(keys[i], p, pasta.NONCE, 2))


def test_block_randomness_takes_native_and_says_so():
    """With the library built, ``block_randomness`` expands natively (and
    counts it); with it unavailable, the Python expansion runs and is
    counted instead.  Both give the same arrays."""
    nonce, b = pasta.NONCE + 11, 5
    pasta.block_randomness.cache_clear()
    before = dict(pasta.EXPANSIONS)
    got = pasta.block_randomness(65537, nonce, b)
    assert pasta.EXPANSIONS["native"] == before["native"] + 1
    assert pasta.EXPANSIONS["python"] == before["python"]
    pasta.block_randomness(65537, nonce, b)  # cached: no expansion
    assert pasta.EXPANSIONS["native"] == before["native"] + 1
    want = pasta.block_randomness_python(65537, nonce, b)
    for g, w in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(g, w))


def test_python_expansion_when_native_unavailable(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    pasta.block_randomness.cache_clear()
    before = dict(pasta.EXPANSIONS)
    key = pasta.get_fixed_symmetric_key()
    try:
        got = pasta.block_randomness(65537, pasta.NONCE, 0)
        ks = pasta.keystream(key, 65537, pasta.NONCE, 0)  # from the cache
    finally:
        pasta.block_randomness.cache_clear()
    assert pasta.EXPANSIONS["python"] == before["python"] + 1
    assert pasta.EXPANSIONS["native"] == before["native"]
    assert len(got[0]) == pasta.PASTA_R + 1
    assert np.array_equal(ks, np.load(GOLDEN)["ks"][:128])


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile: ``available()`` reports False, and
    every call raises with g++'s message (nothing falls back silently)."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        native.shake128(b"abc", 8)
    assert "broken.cpp" in str(info.value)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.pasta_block_randomness(65537, 1, 0)
