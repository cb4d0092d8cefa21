#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``lorikeet_tpu_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on this machine's card: set-up, a
measured window of whole-genome ``lorikeet call`` jobs, the check of every
answer, and one JSON object as the last line of standard output (the
end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``).  Each number compared for ``correct`` is printed beside its
limit as the last lines of standard error.  Exits 2, printing no result,
without the CUDA cards the cell asks for, and 3 if JAX or the JAX package
was loaded.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the program builds its kernels and host libraries into its own
# lorikeet_tpu_torch/build/, inside the checkout, so only a cell's first
# run in a checkout builds
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.lib import cells, harness
    cell = cells.load(args.workload)
    try:
        result = harness.run(cell, args.seed, args.seconds,
                             bool(args.trace), started=STARTED)
    except harness.NoCard as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    foreign = harness.foreign_modules()
    if foreign:
        print(f"portbench: loaded JAX or the JAX package: {foreign}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
