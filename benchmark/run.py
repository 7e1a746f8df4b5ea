"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout on a machine with the cell's CUDA devices.
The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`,
and last `checks`: each number compared beside its limit); the last lines
of standard error repeat the checks. See benchmark/README.md.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    return harness.main(args, T0, ROOT, time.perf_counter())


if __name__ == "__main__":
    sys.exit(main())
