"""Run one cell of the benchmark (see bench_port/harness.py):

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import os
import sys
import time

T_PROCESS = time.perf_counter()

# a library the program pulls in must not load JAX on its own
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# the repository's root, in place of this script's own directory
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from bench_port.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
