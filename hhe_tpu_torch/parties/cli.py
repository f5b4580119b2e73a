"""CLI entry points for the three parties — counterpart of
``hhe_tpu.parties.cli``.

Equivalent to the reference binaries ``analyst``, ``user``, ``csp``
(reference ``AnalystRPC.cpp:91-152``, ``UserRPC.cpp:6-96``,
``CSPRPC.cpp:358-392``), with the same default addresses
(analyst localhost:50051, csp localhost:50052) and startup order
csp -> analyst -> user (reference README.md:96-117).

Usage:
    python -m hhe_tpu_torch.parties.cli csp [url] [--workdir DIR]
    python -m hhe_tpu_torch.parties.cli analyst [url] [csp_url] [--weights CSV] [--input-len N]
    python -m hhe_tpu_torch.parties.cli user [analyst_url] [csp_url] [--data CSV] [--rows R]

Every party runs on CUDA unless ``--device cpu`` is given.  The default
``--weights`` / ``--data`` are the reference project's files under
``models.loaders.REFERENCE_ROOT`` (``HHE_REFERENCE_ROOT``); a missing file
raises ``FileNotFoundError``.  Each process seeds its party's randomness
afresh: the JAX package's CLI gives every party ``BFVParams`` seed 0, so its
CSP's "own" secret key is the analyst's and the user's encryption draws
repeat the analyst's key draws.
"""

from __future__ import annotations

import argparse
import os
import secrets
import time

from ..models import loaders, pocketnn
from ..ops.bfv import BFVParams

DEFAULT_ANALYST = "localhost:50051"
DEFAULT_CSP = "localhost:50052"
DEFAULT_DATA = os.path.join(
    loaders.REFERENCE_ROOT, "data", "Harpocrates_recordingwise_SIESTA_4percent",
    "c000101_data.txt",
)
DEFAULT_WEIGHTS = os.path.join(
    loaders.REFERENCE_ROOT, "weights", "SpO2", "qat", "quant_fc_5bits_data_2bits_weights.csv"
)


def _params(args) -> BFVParams:
    return BFVParams(n=args.n, data_limbs=args.limbs, seed=secrets.randbits(63))


def _add_common(p):
    p.add_argument("--n", type=int, default=16384, help="BFV polynomial degree")
    p.add_argument("--limbs", type=int, default=13, help="RNS data limbs")
    p.add_argument(
        "--verbose", action="store_true", help="verbose logging (config::verbose)"
    )
    p.add_argument(
        "--device", default="cuda", help="torch device of the party (cuda, or cpu)"
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hhe_tpu_torch.parties")
    sub = ap.add_subparsers(dest="party", required=True)

    pa = sub.add_parser("analyst")
    pa.add_argument("url", nargs="?", default=DEFAULT_ANALYST)
    pa.add_argument("csp_url", nargs="?", default=DEFAULT_CSP)
    pa.add_argument("--weights", default=DEFAULT_WEIGHTS)
    pa.add_argument("--input-len", type=int, default=300)
    _add_common(pa)

    pu = sub.add_parser("user")
    pu.add_argument("analyst_url", nargs="?", default=DEFAULT_ANALYST)
    pu.add_argument("csp_url", nargs="?", default=DEFAULT_CSP)
    pu.add_argument("--data", default=DEFAULT_DATA)
    pu.add_argument("--rows", type=int, default=2, help="rows to encrypt")
    _add_common(pu)

    pc = sub.add_parser("csp")
    pc.add_argument("url", nargs="?", default=DEFAULT_CSP)
    pc.add_argument("--workdir", default=".")
    _add_common(pc)

    args = ap.parse_args(argv)

    if args.party == "csp":
        from ..utils.config import RunConfig
        from .csp import CSP, CSPServer

        csp = CSP(
            _params(args),
            workdir=args.workdir,
            run_config=RunConfig(verbose=args.verbose),
            device=args.device,
        )
        server = CSPServer(csp, args.url)
        print(f"[CSP] serving on {args.url}", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            server.stop()
        return

    if args.party == "analyst":
        from .analyst import Analyst, AnalystServer

        weight = pocketnn.read_csv_matrix(args.weights)  # before the keygen
        analyst = Analyst(_params(args), input_len=args.input_len, device=args.device)
        print(f"[Analyst] uuid={analyst.uuid}", flush=True)
        analyst.encrypt_model(weight)
        server = AnalystServer(analyst, args.url)
        print(
            f"[Analyst] serving on {args.url}; publishing keys+model to {args.csp_url}",
            flush=True,
        )
        server.publish_to_csp(args.csp_url)
        print("[Analyst] ready; waiting for results (Ctrl-C to stop)", flush=True)
        try:
            while True:
                time.sleep(5)
                if analyst.predictions:
                    print(f"[Analyst] predictions so far: {analyst.predictions}", flush=True)
        except KeyboardInterrupt:
            server.stop()
        return

    if args.party == "user":
        from .user import User, patient_id_from_path

        user = User.from_csv(args.data, params=_params(args), device=args.device)
        pid = patient_id_from_path(args.data)
        print(f"[User] patient {pid}: submitting {args.rows} encrypted rows", flush=True)
        user.submit(args.analyst_url, args.csp_url, pid, rows=slice(0, args.rows))
        print("[User] done", flush=True)


if __name__ == "__main__":
    main()
