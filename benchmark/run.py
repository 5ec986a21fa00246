"""The benchmark's command: one run of one cell (harness.py says how).

    python3 benchmark/run.py --workload vitb16-train-s919 --seed 7 \
        --seconds 10 --trace 0
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
