"""The harness end to end on the CPU at tiny sizes: the result line's
schema, the traced run's fields, a cell, a configuration and a metric
added as files only, and the refusals."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import run_cell

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-rate", "tiny-max"])
def test_result_line_schema(tiny, cell):
    rc, res = run_cell(tiny, cell)
    assert rc == 0 and res["correct"] is True
    assert list(res)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    spec = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    for c in res["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-rate", "tiny-max"])
def test_traced_run(tiny, cell):
    rc, res = run_cell(tiny, cell, seconds=2.0, trace=1)
    assert rc == 0 and res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    spec = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    allowed = {m["name"] for m in spec["per_layer"]
               if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) <= allowed
    # on the CPU no kernel runs: the device readers find nothing to read
    assert not any(k.startswith("flash_attention_roofline")
                   for k in res["metrics"])


def test_a_cell_config_and_metric_added_as_files_only(tmp_path):
    from conftest import make_copy
    root = make_copy(tmp_path)
    spec_path = root.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    cfg = json.loads((root / "configs" / "tiny.json").read_text())
    cfg["model"]["n_queries"] = 16
    (root / "configs" / "tiny16.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "tiny-train.json").read_text())
    mix["valid_counts"] = [2, 3]
    (root / "traffic" / "tiny-few.json").write_text(json.dumps(mix))
    shutil.copy(root / "limits" / "tiny-train.json",
                root / "limits" / "tiny16-few.json")
    (root / "metrics" / "steps.train_window.py").write_text(
        "def read(ctx):\n    return ctx['outcome'].attempted\n")
    spec["configs"].append({"name": "tiny16", "source": "x", "reduced": [],
                            "file": "benchmark/configs/tiny16.json",
                            "why": "x"})
    spec["workloads"].append({"name": "tiny16-few", "config": "tiny16",
                              "traffic": "tiny-few", "chips": 1, "why": "x"})
    spec["end_to_end"][0]["workloads"].append("tiny16-few")
    spec["per_layer"].append({"name": "steps.train_window", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "model step",
                              "moves": spec["end_to_end"][0]["name"],
                              "workloads": ["tiny16-few"]})
    spec_path.write_text(json.dumps(spec))
    rc, res = run_cell(root, "tiny16-few", trace=1, seconds=1.5)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["steps.train_window"]["value"] > 0


def test_no_result_without_a_card_or_the_program(tmp_path):
    """The command exits with another code than 0 and prints no result
    without CUDA, and in a directory holding only the benchmark."""
    cmd = [sys.executable, "benchmark/run.py", "--workload",
           "vitb16-train-s919", "--seed", "1", "--seconds", "1", "--trace",
           "0"]
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(tmp_path)}
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         env=env)
    assert out.returncode != 0 and "correct" not in out.stdout
    alone = tmp_path / "alone"
    shutil.copytree(ROOT / "benchmark", alone / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    out = subprocess.run(cmd, cwd=alone, capture_output=True, text=True,
                         env=env)
    assert out.returncode != 0 and "correct" not in out.stdout


def test_the_trace_runs_after_the_window(monkeypatch):
    """Nothing of the tracer runs inside the measured window: the traced
    phases follow its close, and each is exported and read as it
    closes."""
    import time

    from benchmark import tracing
    read_at = []
    monkeypatch.setattr(tracing, "_events",
                        lambda prof: read_at.append(time.perf_counter()) or [])
    work = [0]
    w = tracing.Window(0.3, trace=True, trace_seconds=0.1, gap_seconds=0.1,
                       settle_seconds=0.05,
                       counters=lambda: {"flops": float(work[0])})
    w.start()
    while w.measuring():
        time.sleep(0.01)
        work[0] += 1
    assert not read_at
    w.close()
    closed = time.perf_counter()
    assert w.tracing() and not read_at
    while w.tracing():
        time.sleep(0.01)
        work[0] += 1
        w.tick()
    w.finish()
    assert len(read_at) == 2 and min(read_at) >= closed
    assert 0.3 <= w.window_s() < 0.4
    assert set(w.summary.rates) == {"window", "device_trace", "host_trace"}
    assert w.summary.counters["flops"] > 0


def test_an_untraced_window_opens_no_trace():
    from benchmark import tracing
    w = tracing.Window(0.05)
    w.start()
    while w.measuring():
        pass
    w.close()
    assert not w.tracing()
    w.finish()
    assert w.summary is None and w.window_s() >= 0.05
