"""A short CPU run of each traffic mix prints a well-formed result; the
command refuses to run without the card."""

import json
import shutil
import subprocess
import sys

import pytest

from tiny import CELLS, ROOT, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_prints_a_well_formed_line(workload, trace):
    result, checks = run_tiny(workload, trace=trace)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == set(checks)
    for name, entry in line["metrics"].items():
        assert set(entry) == {"value", "unit"} and entry["value"] > 0, name
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        assert not set(line["metrics"]) & e2e
    else:
        assert set(line["metrics"]) == e2e
    assert line["device"]["platform"] == "cpu"


def _command(cwd, *args):
    return subprocess.run([sys.executable, "-m", "ptbench", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    got = _command(ROOT, "--workload", "default_scene.interactive", "--seed", "1",
                   "--seconds", "1", "--trace", "0")
    assert got.returncode != 0 and got.stdout == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "ptbench", tmp_path / "ptbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    got = _command(tmp_path, "--workload", "default_scene.invert", "--seed", "1",
                   "--seconds", "1", "--trace", "0")
    assert got.returncode != 0 and got.stdout == ""
