"""Noise budget after each round of one homomorphic PASTA keystream block at
N = 65536, by the number of data limbs, on one CUDA card.

    python3 tools/torch_keystream_budgets.py [--limbs 14 15 16 17 18]

For each limb count: ``chip_smoke.large_keystream_setup`` (the large preset
cut to that many limbs, device keygen, the PASTA key encrypted), then
``Transcipher.keystream_round_budgets`` for block 0 and whether the block
decrypts to the plain PASTA keystream.  The smallest count whose last budget
stays >= 20 bits is the one ``chip_smoke.py`` runs the large preset's
keystream at.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def budgets(limbs: int) -> dict:
    import torch

    from hhe_tpu_torch.ops import pasta

    (ctx, sk, tc, key, enc_key), setup_s = chip_smoke.timed(
        lambda: chip_smoke.large_keystream_setup(limbs))
    t0 = time.perf_counter()
    per_round = tc.keystream_round_budgets(enc_key, sk)
    ks = tc.keystream_ct(enc_key, pasta.NONCE, 0)
    out = {
        "n": ctx.n, "limbs": limbs, "t": int(ctx.t), "round_budgets": per_round,
        "decrypts_to_plain_keystream": chip_smoke.keystream_right(ctx, sk, key, ks),
        "setup_s": setup_s, "budgets_s": time.perf_counter() - t0,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    del ctx, sk, tc, enc_key, ks
    chip_smoke.free_device()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--limbs", type=int, nargs="+", default=[14, 15, 16, 17, 18])
    args = ap.parse_args()
    card = chip_smoke.phase_device()
    rows = []
    for limbs in args.limbs:
        rows.append(budgets(limbs))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"card": card, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
