"""The plain reference agrees with the program at small sizes on the CPU:
each decrypts and decodes what the other encrypted, at t = 65537 and at the
HCNN's 47-bit t; the slot transform and decryption are exact against
Python integers at the 47-bit t; PASTA-3's keystream is the program's, and
refuses a prime its int64 products cannot take; and one request of each
entry decrypts to its records and to the reference model's outputs."""

import fractions

import numpy as np
import pytest
import torch

from hhe_bench import harness
from hhe_bench.reference import bfv as ref_bfv
from hhe_bench.reference import models
from hhe_bench.reference import pasta as ref_pasta
from hhe_tpu_torch.ops import bfv, pasta
from hhe_tpu_torch.workloads.he_conv import conv_plain_t

N, LIMBS, T = 1024, 5, 65537
WIDE = conv_plain_t(N)  # the HCNN's plaintext modulus at N = 1024: 47 bits


@pytest.fixture(scope="module", params=(T, WIDE), ids=("t17", "t47"))
def pair(request):
    t = request.param
    sch = ref_bfv.Scheme(N, t, 30, LIMBS, "cpu")
    ctx = bfv.Context(bfv.BFVParams(n=N, t=t, data_limbs=LIMBS, seed=3), device="cpu")
    s = sch.secret_key(np.random.default_rng(5))
    return sch, ctx, s, bfv.SecretKey(s, sch.secret_residues(s))


def test_moduli_are_the_programs(pair):
    sch, ctx, _, _ = pair
    assert sch.q == tuple(ctx.q_moduli) and sch.special == ctx.p_special


def test_program_ciphertexts_decrypt_in_the_reference(pair):
    sch, ctx, s, sk = pair
    v = np.random.default_rng(1).integers(0, sch.t, (3, N))
    pk = ctx.keygen_public(sk)
    ct = torch.stack([ctx.encrypt(pk, ctx.encode(row)).data for row in v], 1)
    m, share = sch.decrypt(torch.as_tensor(s, dtype=torch.int64), ct)
    assert torch.equal(sch.slots.decode(m), torch.as_tensor(v))
    assert float(share.max()) < 1e-6


def test_reference_ciphertexts_decrypt_in_the_program(pair):
    sch, ctx, s, sk = pair
    v = torch.as_tensor(np.random.default_rng(2).integers(0, sch.t, (3, N)))
    gen = torch.Generator().manual_seed(9)
    pk = sch.public_key(torch.as_tensor(s, dtype=torch.int64), gen)
    ct = sch.encrypt(pk, sch.slots.encode(v), gen)
    got = ctx.decode_batch(ctx.decrypt_batch(sk, bfv.Ciphertext(ct)))
    assert np.array_equal(got.astype(np.int64), v.numpy())
    assert np.array_equal(ctx.encode(v[0].numpy()).data.astype(np.int64), sch.slots.encode(v[0]).numpy())


def test_noise_share_reads_a_ciphertext_pushed_past_its_limit(pair):
    sch, _, s, _ = pair
    gen = torch.Generator().manual_seed(4)
    sd = torch.as_tensor(s, dtype=torch.int64)
    ct = sch.encrypt(sch.public_key(sd, gen), sch.slots.encode(torch.zeros(1, N)), gen).to(torch.int64)
    half = torch.tensor([(sch.Q // sch.t // 2 + 1) % q for q in sch.q])  # half a step, and one
    ct[0, ..., 0] = (ct[0, ..., 0] + half) % sch.qcol[:, 0]
    _, share = sch.decrypt(sd, ct)
    assert 0.99 < float(share[..., 0].max()) <= 1.0


def _evaluate(poly, x, t):
    """poly(x) mod t in Python integers (Horner)."""
    r = 0
    for c in reversed(poly):
        r = (r * x + c) % t
    return r


def test_slots_are_exact_against_python_integers_at_47_bits():
    """Slot i < N/2 holds m(psi^(3^i)), slot N/2 + i holds m(psi^(-3^i)):
    the encoder's polynomial evaluated there in Python integers gives back
    every value, and the decoder reads each of them."""
    sch = ref_bfv.Slots(WIDE, N, "cpu")
    v = torch.as_tensor(np.random.default_rng(6).integers(0, WIDE, N))
    v[:4] = torch.tensor([0, 1, WIDE - 1, WIDE // 2])
    m = sch.encode(v)
    assert int(m.min()) >= 0 and int(m.max()) < WIDE
    poly = [int(c) for c in m]
    root = ref_bfv.psi(WIDE, N)
    g, want = 1, [0] * N
    for i in range(N // 2):
        want[i] = _evaluate(poly, pow(root, g, WIDE), WIDE)
        want[N // 2 + i] = _evaluate(poly, pow(root, 2 * N - g, WIDE), WIDE)
        g = g * 3 % (2 * N)
    assert want == v.tolist()
    assert torch.equal(sch.decode(m), v)


def test_decryption_is_exact_against_python_integers_at_47_bits():
    """m = round(t x / Q) mod t and the share 2 |t x / Q - round(t x / Q)|
    for x = [c0 + c1 s]_Q, composed by the CRT in Python integers: a fresh
    ciphertext, and one pushed to a share of about a half."""
    sch = ref_bfv.Scheme(N, WIDE, 30, LIMBS, "cpu")
    s = torch.as_tensor(sch.secret_key(np.random.default_rng(7)), dtype=torch.int64)
    gen = torch.Generator().manual_seed(8)
    v = torch.as_tensor(np.random.default_rng(9).integers(0, WIDE, (1, N)))
    fresh = sch.encrypt(sch.public_key(s, gen), sch.slots.encode(v), gen).to(torch.int64)
    pushed = fresh.clone()
    quarter = torch.tensor([(sch.Q // WIDE // 4) % q for q in sch.q])
    pushed[0, ..., :] = (pushed[0, ..., :] + quarter[:, None]) % sch.qcol
    Q, t = sch.Q, WIDE
    for ct, most in ((fresh, 1e-6), (pushed, 0.51)):
        m, share = sch.decrypt(s, ct)
        x_rns = ((ct[0] + sch.rns.mul(ct[1], sch.to_rns(s))) % sch.qcol)[0].tolist()
        for j in range(N):
            x = sum(int(r) * (Q // q) * pow(Q // q, -1, q) for r, q in zip((row[j] for row in x_rns), sch.q)) % Q
            near = (2 * t * x + Q) // (2 * Q)
            assert int(m[0, j]) == near % t
            exact = 2 * abs(fractions.Fraction(t * x, Q) - near)
            assert abs(float(share[0, j]) - float(exact)) < 1e-15
        assert float(share.max()) < most
    assert torch.equal(sch.slots.decode(m), v)


@pytest.mark.parametrize("nonce", (11, 2**63 + 5, pasta.NONCE))
def test_pasta_keystream_is_the_programs(nonce):
    key = np.random.default_rng(3).integers(0, T, 256)
    got = ref_pasta.keystream(key, [nonce], 3, T, "cpu")[0].numpy()
    assert np.array_equal(got, pasta.keystream_for_length(key, T, 384, nonce).astype(np.int64))


@pytest.mark.parametrize("p", (2**31 - 1, WIDE))
def test_pasta_keystream_refuses_a_prime_beyond_its_int64_products(p):
    with pytest.raises(ValueError, match="below 2"):
        ref_pasta.keystream(np.zeros(256, np.int64), [11], 1, p, "cpu")


def test_models():
    x = torch.tensor([[1, 2, 3]])
    assert models.ecg_products(x, torch.tensor([-1, 40000, 2]), T).tolist() == [[-1, 80000 - T, 6]]
    w1, w2 = torch.tensor([[1], [1], [1]]), torch.tensor([[2, -1]])
    assert models.mnist_logits(x, w1, w2, T).tolist() == [[72, -36]]


@pytest.mark.parametrize("records", (4, 72))
def test_ecg_request_at_small_size(records):
    """72 records: the product in a slice of 64 and one of 8, as
    ``hhe_ecg_full_inference`` runs it, each record checked in order."""
    r = harness.run("ecg_1fc.b64", 2**31 + 3, 0.01, False, device="cpu",
                    config_overrides={"n": 1024, "data_limbs": 11},
                    traffic_overrides={"records_per_request": records, "check_requests": 1})
    assert r["correct"], r["checks"]
    assert r["checks"]["records_wrong"]["value"] == 0 and r["checks"]["outputs_wrong"]["value"] == 0


@pytest.mark.parametrize("t, records", ((T, 4), (WIDE, 72)), ids=("t17", "t47"))
def test_ecg_request_with_bfv_uploads_at_small_size(t, records):
    """The users' BFV ciphertexts, made in set-up, through the product in
    slices of 64 records: no transcipher, no PASTA key."""
    r = harness.run("ecg_1fc.b64", 2**31 + 3, 0.01, False, device="cpu",
                    config_overrides={"n": 1024, "data_limbs": 11, "upload": "bfv", "t": t},
                    traffic_overrides={"records_per_request": records, "check_requests": 1})
    assert r["correct"], r["checks"]
    assert r["checks"]["records_wrong"]["value"] == 0 and r["checks"]["outputs_wrong"]["value"] == 0


def test_mnist_request_at_small_size():
    """Two blocks a record (mask and flatten), 4 hidden rows in chunks of 2,
    at the configuration's 16 limbs."""
    r = harness.run("mnist_2fc.b4", 2**31 + 3, 0.01, False, device="cpu",
                    config_overrides={"n": 1024, "input_words": 200, "hidden": 4, "row_chunk": 2},
                    traffic_overrides={"records_per_request": 2, "check_requests": 1})
    assert r["correct"], r["checks"]

