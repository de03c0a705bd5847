#!/usr/bin/env python3
"""Run one cell of the benchmark of psba_tpu_torch once.

    python3 portbench/run.py --workload ladybug138.lm --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout, on a machine with the CUDA card(s) the cell
asks for. Prints, last on standard output, one JSON line: correct,
attempted, failed, metrics (the cell's end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1), device, and last the numbers
compared with their limits (also the last lines on standard error). Exits
nonzero, printing no result, without enough CUDA devices, or when a module
of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    spec = harness.cell(args.workload)
    import torch

    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START, spec=spec)
    found = harness.forbidden_modules()
    if found:
        print("portbench: modules of JAX or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
