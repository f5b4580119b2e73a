"""The plain reference agrees with the program at small sizes on the CPU:
each decrypts and decodes what the other encrypted, PASTA-3's keystream is
the program's, and one request of each entry decrypts to its records and
to the reference model's outputs."""

import numpy as np
import pytest
import torch

from hhe_bench import harness
from hhe_bench.reference import bfv as ref_bfv
from hhe_bench.reference import models
from hhe_bench.reference import pasta as ref_pasta
from hhe_tpu_torch.ops import bfv, pasta

N, LIMBS, T = 1024, 5, 65537


@pytest.fixture(scope="module")
def pair():
    sch = ref_bfv.Scheme(N, T, 30, LIMBS, "cpu")
    ctx = bfv.Context(bfv.BFVParams(n=N, data_limbs=LIMBS, seed=3), device="cpu")
    s = sch.secret_key(np.random.default_rng(5))
    return sch, ctx, s, bfv.SecretKey(s, sch.secret_residues(s))


def test_moduli_are_the_programs(pair):
    sch, ctx, _, _ = pair
    assert sch.q == tuple(ctx.q_moduli) and sch.special == ctx.p_special


def test_program_ciphertexts_decrypt_in_the_reference(pair):
    sch, ctx, s, sk = pair
    v = np.random.default_rng(1).integers(0, T, (3, N))
    pk = ctx.keygen_public(sk)
    ct = torch.stack([ctx.encrypt(pk, ctx.encode(row)).data for row in v], 1)
    m, share = sch.decrypt(torch.as_tensor(s, dtype=torch.int64), ct)
    assert torch.equal(sch.slots.decode(m), torch.as_tensor(v))
    assert float(share.max()) < 1e-6


def test_reference_ciphertexts_decrypt_in_the_program(pair):
    sch, ctx, s, sk = pair
    v = torch.as_tensor(np.random.default_rng(2).integers(0, T, (3, N)))
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
    half = torch.tensor([(sch.Q // T // 2 + 1) % q for q in sch.q])  # half a step, and one
    ct[0, ..., 0] = (ct[0, ..., 0] + half) % sch.qcol[:, 0]
    _, share = sch.decrypt(sd, ct)
    assert 0.99 < float(share[..., 0].max()) <= 1.0


@pytest.mark.parametrize("nonce", (11, 2**63 + 5, pasta.NONCE))
def test_pasta_keystream_is_the_programs(nonce):
    key = np.random.default_rng(3).integers(0, T, 256)
    got = ref_pasta.keystream(key, [nonce], 3, T, "cpu")[0].numpy()
    assert np.array_equal(got, pasta.keystream_for_length(key, T, 384, nonce).astype(np.int64))


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


def test_mnist_request_at_small_size():
    """Two blocks a record (mask and flatten), 4 hidden rows in chunks of 2,
    at the configuration's 16 limbs."""
    r = harness.run("mnist_2fc.b4", 2**31 + 3, 0.01, False, device="cpu",
                    config_overrides={"n": 1024, "input_words": 200, "hidden": 4, "row_chunk": 2},
                    traffic_overrides={"records_per_request": 2, "check_requests": 1})
    assert r["correct"], r["checks"]

