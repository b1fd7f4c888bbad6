"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the one its entry in `configs` gives; the mix
is `traffic/<traffic>.json`, and the loop kind it names under "loop" is
`loops/<loop>.py` (its `run`, `check` and `fault`); the limits of the
cell's correctness check are `limits/<cell>.json`; a per-layer metric's
reader is `metrics/<name>.py`, a module with `read(trace, counts) -> float
| None`.  A later cell, mix, loop kind or metric is a new file and a new
entry: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's end-to-end metric entries this cell reports
    per_layer: list  # the manifest's per-layer metric entries this cell reports


def read_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def cell(root: Path, name: str, bench: Path = HERE) -> Cell:
    """The cell `name` of the manifest at `root`, with its files read from
    the benchmark folder `bench`."""
    manifest = read_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=per_layer,
    )


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, bench: Path = HERE):
    """The `read` function of `metrics/<name>.py`."""
    return _load(f"ptbench_metric_{name.replace('.', '_')}", bench / "metrics" / f"{name}.py").read


def loop(name: str, bench: Path = HERE):
    """The loop kind `loops/<name>.py`, a module of the package `loops`, so
    that it imports the benchmark's shared modules relatively."""
    return _load(f"{__package__}.loops.{name}", bench / "loops" / f"{name}.py")
