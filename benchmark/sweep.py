"""The knee of a serving cell: the highest rate the server sustains with
no growing backlog (the benchmark's own runs never run this; the rate a
cell offers is written into its traffic file as a number).

    python3 benchmark/sweep.py --workload vitl14-serve-rate \
        --rates 200,250,300,350,400 --seconds 8 --seed 1

One process builds the cell's server once, then offers each rate for
--seconds in an open loop (traffic/<mix>.json with its "rate" replaced)
and prints one JSON line a rate: completed a second, p50 and p95 ms, the
generator's lag, and the p95 of the window's last third against its
first (a backlog that grows shows as a tail that grows).
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402
from benchmark.tracing import Window  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    harness.setup_environment()
    import numpy as np
    import torch
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(spec, args.workload, args.seed)
    cell.device = torch.device("cuda")
    driver = harness.driver_for(cell).Driver(cell)
    driver.setup()
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate"] = rate
        cell.traffic["mode"] = "open"
        driver.results.clear()
        t0 = time.perf_counter()
        out = driver.run_window(Window(args.seconds,
                                       sync=torch.cuda.synchronize))
        lat = np.array(driver.last_latencies)
        third = max(1, len(lat) // 3)
        print(json.dumps({
            "rate": rate, "completed_per_s": out.end_to_end["serve_img_per_s"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p95_first_third_ms": float(np.percentile(lat[:third], 95)),
            "p95_last_third_ms": float(np.percentile(lat[-third:], 95)),
            "lag_s": out.layer["generator_lag_s"], "failed": out.failed,
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
