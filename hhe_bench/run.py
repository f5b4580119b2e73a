"""Runs one cell of BENCHMARK.json once and prints its result line:

    python3 -m hhe_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without a CUDA card (never falling
back to the CPU), without the cards the cell asks for, or where a module of
JAX or the JAX package was loaded.  The numbers compared, each with its
limit, are the last lines on standard error and the last key of the
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import harness

    cell = harness.load_cell(args.workload)["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                    f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
