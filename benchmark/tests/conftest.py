"""Tiny cells for the benchmark's CPU tests: a copy of the benchmark in a
temporary directory, with a small configuration and a small traffic mix
beside each of the real cells, under the real cells' limits. The harness
runs them on the CPU with `require_cuda=False`."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path.insert(0, str(BENCH.parent))

TINY_MODEL = dict(width=64, encoder_layers=2, encoder_heads=2, patch_size=16,
                  text_dim=32, input_resolution=32, n_queries=12,
                  n_decoder_layers=2, n_heads=2)
# tiny cell -> (the real cell it stands beside, its mix's changes)
TRACE = dict(trace_seconds=0.3, gap_seconds=0.2, settle_seconds=0.1)
TINY = {
    "train": ("vitb16-train-s919", dict(batch=2, image_size=64,
                                        n_categories=20, pool=4, **TRACE)),
    "rate": ("vitl14-serve-rate", dict(batch=4, pool=16, image_size=64,
                                       rate=100.0, max_wait_ms=50.0,
                                       n_categories=20, sample=4, grace=20,
                                       **TRACE)),
    "max": ("vitl14-serve-max", dict(batch=4, pool=16, image_size=64,
                                     clients=8, n_categories=20, sample=4,
                                     grace=20, **TRACE)),
}


def make_copy(dst: Path, dtype: str = "float32") -> Path:
    """A copy of the benchmark under dst, with a tiny cell `tiny-<key>`
    beside each real cell; -> the copy's benchmark directory."""
    root = dst / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "configs" / "zutis-vitb16.json").read_text())
    cfg.update(name="tiny", model=TINY_MODEL, compute_dtype=dtype)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny", "source": "x", "reduced": [],
                            "file": "benchmark/configs/tiny.json", "why": "x"})
    cells = {w["name"]: w for w in spec["workloads"]}
    for key, (real, changes) in TINY.items():
        mix = json.loads((root / "traffic" /
                          f"{cells[real]['traffic']}.json").read_text())
        mix.update(changes)
        (root / "traffic" / f"tiny-{key}.json").write_text(json.dumps(mix))
        shutil.copy(root / "limits" / f"{real}.json",
                    root / "limits" / f"tiny-{key}.json")
        spec["workloads"].append({"name": f"tiny-{key}", "config": "tiny",
                                  "traffic": f"tiny-{key}", "chips": 1,
                                  "why": "x"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(f"tiny-{key}")
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_cell(root: Path, cell: str, seed: int = 3_000_000_019,
             seconds: float = 1.0, trace: int = 0):
    """One harness run of a cell of the copy on the CPU -> (exit code,
    the result line as a dict or None)."""
    from benchmark import harness
    lines = []
    rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)],
                     time.perf_counter(), require_cuda=False, device="cpu",
                     spec_path=root.parent / "BENCHMARK.json", root=root,
                     emit=lines.append)
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    """The copy with its tiny cells computed in float32 (sound runs agree
    with the reference to rounding)."""
    return make_copy(tmp_path_factory.mktemp("bench"))
