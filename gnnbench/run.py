"""One run of one cell of ``BENCHMARK.json``:

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the result as the last line of its
standard output and each compared number beside its limit as the last
lines of its standard error; exits non-zero, with no result, where the
cell's CUDA devices are missing.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from gnnbench.harness import checkout_dirs, main
    checkout_dirs()
    sys.exit(main(t_start=T_START))
