"""The readings the limits of `correct` are set from (the benchmark's own
runs never run this).

    python3 benchmark/calibrate.py --workload vitb16-train-s919 \
        --seeds 1,2,3 --control-seeds 1,2 --faults half_batch:1 \
        --out calibrate.jsonl

For each seed, in one process: a run's set-up and a short window at the
cell's own load (--seconds), then the numbers the check compares against
the plain reference (what sound runs read: the lower end of each limit).
For each control seed, the reference computed in the control's precision
in the program's place (the upper end). For each fault, the program with
that fault planted (each driver's FAULTS). The limits file may hold any
values: every number it names is read. One JSON line each, to standard
output and to --out.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="name:seed,name:seed")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="the short window each program run serves")
    args = ap.parse_args(argv)
    harness.setup_environment()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    jobs = [("program", s) for s in seeds(args.seeds)]
    jobs += [("control", s) for s in seeds(args.control_seeds)]
    for item in args.faults.split(","):
        if item:
            name, s = item.split(":")
            jobs.append((name, int(s)))
    from benchmark.tracing import Window
    for kind, seed in jobs:
        t0 = time.perf_counter()
        cell = harness.load_cell(spec, args.workload, seed)
        cell.device = torch.device("cuda")
        mod = harness.driver_for(cell)
        driver = mod.Driver(cell)
        torch.cuda.reset_peak_memory_stats()
        rec = {"workload": args.workload, "kind": kind, "seed": seed}
        if kind == "control":
            rec["numbers"] = driver.control_numbers()
        else:
            undo = mod.FAULTS[kind]() if kind != "program" else None
            try:
                driver.setup()
                driver.run_window(Window(args.seconds,
                                         sync=torch.cuda.synchronize))
                compared = {c.name: c.value for c in driver.check()}
                # every number read, those not compared too
                rec["numbers"] = getattr(driver, "read", compared)
            finally:
                if undo:
                    undo()
            rec["detail"] = driver.detail()
        rec["seconds"] = time.perf_counter() - t0
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        emit(rec)
        del driver
        torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
