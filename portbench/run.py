"""Run one cell of the port's benchmark on the card this process runs on.

    python3 portbench/run.py --workload amazon-polarity-nomic128.fit --seed 7 \\
        --seconds 51 --trace 0

Run from the root of a checkout: it imports ``repro_torch`` from ``src/``
and builds its kernels under ``build/repro_torch`` there.  The last line of
standard output is the result, one JSON object; the last lines of standard
error are the numbers the check compared, each beside its limit.  Exits
non-zero, with no result, when there is no CUDA device or too few, or when
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=T_START)
    except harness.NoDevice as e:
        print(f"portbench: no run: {e}", file=sys.stderr)
        return 2
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
