"""A configuration, a traffic mix with a loop kind of its own and a
per-layer metric are added as new files and manifest entries, and picked
up with no edit of a file that is there."""

import json
import shutil

from tiny import ROOT, run_tiny


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "ptbench", tmp_path / "ptbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = tmp_path / "ptbench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())

    config = json.loads((bench / "configs/default_scene.json").read_text())
    config.update(name="two_bounce", max_bounces=2)
    (bench / "configs/two_bounce.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic/interactive.json").read_text())
    mix.update(orbit_step_deg=90.0, loop="counted")
    (bench / "loops/counted.py").write_text(
        "from .progressive import check, fault, run as progressive\n\n\n"
        "def run(run):\n"
        "    outcome = progressive(run)\n"
        "    outcome.counts['counted'] = outcome.counts['frames']\n"
        "    return outcome\n")
    (bench / "traffic/quarter_turns.json").write_text(json.dumps(mix))
    (bench / "metrics/frames_traced.py").write_text(
        "def read(trace, counts):\n    return counts.get('counted')\n")
    (bench / "limits/two_bounce.quarter_turns.json").write_text(
        (bench / "limits/default_scene.interactive.json").read_text())

    cell = "two_bounce.quarter_turns"
    manifest["configs"].append({"name": "two_bounce", "source": config["source"],
                                "file": "ptbench/configs/two_bounce.json", "reduced": [],
                                "why": "the default scene at two bounces"})
    manifest["workloads"].append({"name": cell, "config": "two_bounce",
                                  "traffic": "quarter_turns", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if "frame_ms" in m["name"]:
            m["workloads"].append(cell)
    manifest["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                                  "source": "host_clock", "layer": "entry",
                                  "moves": "frame_ms", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    result, _ = run_tiny(cell, trace=True, root=tmp_path, bench=bench, loop="progressive")
    assert result["correct"]
    assert result["metrics"]["frames_traced"] == {"value": result["attempted"], "unit": "frames"}
    assert all(p.read_bytes() == data for p, data in before.items())
