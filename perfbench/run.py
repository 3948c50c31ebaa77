"""Run one cell of the port's benchmark once; see perfbench/README.md.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
