"""The benchmark's harness: one cell, one run, one result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Everything is found by name from `BENCHMARK.json`: the cell's entry of
`workloads` names a configuration (`configs/<config>.json`, whose
`"model"` is the reference's sizes) and a traffic mix
(`traffic/<traffic>.json`, whose `"driver"` names the module under
`drivers/` that runs it, with the mix's parameters); the limits that
decide `correct` are `limits/<workload>.json`; each per-layer metric is
read by `metrics/<metric name>.py`. A cell, a configuration, a mix or a
metric is added by adding files, and no file here changes.

A run: set-up (the traffic driver builds the program, makes the weights
and the traffic from the seed and warms every shape up; `setup_s` runs
from the process's start to the window's), the window of `--seconds`,
the peak memory read, the program's state freed, then the check against
the plain reference. With `--trace 0` the metrics are the cell's
end-to-end ones, with `--trace 1` its per-layer ones: those of the host's
clock read over the window as in an untraced run, those of the device
from a traced tail that runs the same traffic after the window closes
(tracing.py). The last line of standard output is the result; the numbers compared, each
beside its limit, close standard error.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zutis_tpu")


class BenchmarkError(RuntimeError):
    pass


@dataclass
class Comparison:
    name: str
    value: float
    limit: float

    def passed(self) -> bool:
        return self.value <= self.limit


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    seed: int
    device: object = None


@dataclass
class Outcome:
    """What a driver hands back after its window."""
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    layer: Dict[str, object] = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise BenchmarkError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(spec: dict, workload: str, kind: str) -> List[dict]:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list it under "workloads", or that list none."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def load_cell(spec: dict, workload: str, seed: int, root: Path = HERE) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchmarkError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    return Cell(
        workload=w,
        config=load_json(root.parent / configs[w["config"]]["file"]),
        traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(root / "limits" / f"{workload}.json"),
        end_to_end=metrics_for(spec, workload, "end_to_end"),
        per_layer=metrics_for(spec, workload, "per_layer"),
        seed=seed)


def driver_for(cell: Cell, root: Path = HERE) -> ModuleType:
    name = cell.traffic["driver"]
    return load_module(root / "drivers" / f"{name}.py",
                       f"benchmark_driver_{name}")


def read_layer_metrics(cell: Cell, ctx: dict, root: Path = HERE
                       ) -> Dict[str, dict]:
    """Each per-layer metric from its reader; a reader that finds nothing
    returns None, and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(root / "metrics" / f"{m['name']}.py",
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def setup_environment() -> None:
    """Caches inside the checkout at fixed paths; JAX kept out of the
    libraries that would load it by themselves."""
    cache = ROOT / "build" / "benchmark_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(torch, chips: int) -> dict:
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def warm_profiler(torch) -> None:
    """Start and stop the device profiler once, so that its first start
    (CUPTI's set-up, a stall of its own) falls outside the traced window."""
    x = torch.ones(1, device="cuda")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA,
                        torch.profiler.ProfilerActivity.CPU]):
        (x + 1).sum().item()
    torch.cuda.synchronize()


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def run(argv: List[str], t_start: float,
        require_cuda: bool = True,
        device: Optional[str] = None,
        spec_path: Path = ROOT / "BENCHMARK.json",
        root: Path = HERE,
        emit: Callable[[str], None] = print) -> int:
    """One run; -> the exit code. Tests pass require_cuda=False and
    device="cpu" to drive every step of a run but the look for a card."""
    args = parse(argv)
    setup_environment()
    import torch

    spec = load_json(spec_path)
    cell = load_cell(spec, args.workload, args.seed, root)
    chips = int(cell.workload["chips"])
    if require_cuda:
        if not torch.cuda.is_available():
            print("no CUDA device: torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                  f"for {chips}", file=sys.stderr)
            return 2
    cell.device = torch.device(device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # load from one process with few threads: the mix says how many the
    # program's host work may use (a deployment setting, as a server's)
    torch.set_num_threads(int(cell.traffic.get("threads", 1)))
    on_card = cell.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    driver = driver_for(cell, root).Driver(cell)
    driver.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    if args.trace and on_card:
        warm_profiler(torch)

    from benchmark.tracing import Window
    window = Window(args.seconds, trace=bool(args.trace),
                    trace_seconds=cell.traffic.get("trace_seconds", 2.0),
                    gap_seconds=cell.traffic.get("gap_seconds", 1.0),
                    settle_seconds=cell.traffic.get("settle_seconds", 1.5),
                    sync=sync, counters=driver.counters,
                    guard=getattr(driver, "lock", None))
    outcome: Outcome = driver.run_window(window)
    device = (device_info(torch, chips) if on_card else
              {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0})
    if args.trace:
        summary = window.summary
        if summary is None:
            raise BenchmarkError("the traced tail never opened")
        if on_card and summary.busy_s <= 0:
            raise BenchmarkError("the traced tail recorded no device time")
        ctx = {"trace": summary, "outcome": outcome, "cell": cell,
               "window_s": window.window_s()}
        metrics = read_layer_metrics(cell, ctx, root)
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
    else:
        metrics = {m["name"]: {"value": float(outcome.end_to_end[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    comparisons = driver.check()
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}",
              file=sys.stderr)
        return 3
    correct = bool(comparisons) and all(c.passed() for c in comparisons)
    result = {"correct": correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": summary.idle_gaps}
    result["card"] = power_limit() if on_card else "cpu"
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                          for c in comparisons}
    if not correct and hasattr(driver, "detail"):
        print(f"detail: {json.dumps(driver.detail())[:1500]}",
              file=sys.stderr)
    for c in comparisons:
        print(f"compared {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.passed() else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    emit(json.dumps(result))
    return 0


def main(argv: List[str], t_start: float) -> int:
    try:
        return run(argv, t_start)
    except BenchmarkError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 4
