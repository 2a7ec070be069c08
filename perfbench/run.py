"""Run one cell of BENCHMARK.json once:

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the card(s) the cell
asks for.  Prints the result as the last line of standard output (see
harness.py).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    from perfbench import harness
    harness.environment(ROOT)
    sys.exit(harness.main(sys.argv[1:], T_START))
