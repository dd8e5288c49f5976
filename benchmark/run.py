"""Run one cell of BENCHMARK.json once and print its result as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding the port (pixie_tpu_torch) and a CUDA
card.  See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark.harness import main

    sys.exit(main(t_start=T_START))
