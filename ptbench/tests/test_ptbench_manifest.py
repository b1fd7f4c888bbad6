"""BENCHMARK.json against the rules of its format, and the files it names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "ptbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(map(_line, MANIFEST["command"]))
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for path in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and ".." not in path
        assert not path.startswith("/") and not path.endswith("_torch")
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.fullmatch(entry[key])


def test_names_unique():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                           "workloads"}
    for cell in metric.get("workloads", ()):
        assert cell in CELLS


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_each_of_its_cells_reports(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert _line(metric["layer"])
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in MANIFEST["per_layer"])


def test_configs_cells_and_chips():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert {c["name"] for c in MANIFEST["configs"]} == used
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in MANIFEST["workloads"])
    assert len(four) <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("conf", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert _line(conf["source"]) and _line(conf["why"])
    assert conf["file"].startswith("ptbench/")
    body = json.loads((ROOT / conf["file"]).read_text())
    assert body["name"] == conf["name"] and body["source"] == conf["source"]
    assert body["reduced"] == conf["reduced"] and len(conf["reduced"]) <= 16


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and _line(cell["why"])
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
    limits = json.loads((BENCH / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
