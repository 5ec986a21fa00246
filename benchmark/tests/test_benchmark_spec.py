"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs_exist_and_are_used():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["model"]
        assert c["reduced"] == []


def test_cells_find_their_files():
    bench = ROOT / "benchmark"
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mix = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (bench / "drivers" / f"{mix['driver']}.py").exists()
        assert (bench / "limits" / f"{w['name']}.json").exists()


def test_metrics_are_well_formed_and_every_cell_reports():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"])
    for m in SPEC["per_layer"]:
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", [w])
    for cell in cells:
        names = [m["name"] for m in SPEC["end_to_end"]
                 if cell in m.get("workloads", [cell])]
        assert "setup_s" in names and len(names) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in SPEC["per_layer"])
