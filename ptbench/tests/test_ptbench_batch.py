"""The `batch` mix on the CPU at a small size: a run of `large524K.batch`
with the scene cut to a small `mesh_scene` forced through 'bvh8' prints a
well-formed line with the walk's metrics, is correct, and the control and
each fault planted under its timed path are not correct."""

import json
import time

import pytest

from ptbench import faults, run
from tiny import ROOT

CELL = "large524K.batch"
SMALL = {
    "traffic": {"width": 32, "height": 32, "warm_frames": 1, "check_blocks": 2,
                "check_block": 8},
    "config": {"meshes": [
        {"shape": "sphere", "args": [0.5, 24, 12], "material": "beige"},
        {"shape": "plane", "args": [4.0, 4.0], "material": "white",
         "transform": [["rotation_x", -1.5707963267948966]]}],
        "environment": {"kind": "gradient_sky", "height": 32, "width": 64},
        "intersector": "bvh8"},
}


def _run(trace=False, **kw):
    return run.run_cell(ROOT, CELL, 20251018, 0.5, trace, time.perf_counter(), device="cpu",
                        overrides=SMALL, **kw)


@pytest.mark.parametrize("trace", [False, True])
def test_small_run_prints_a_well_formed_line(trace):
    result, checks = _run(trace)
    line = json.loads(json.dumps(result))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1, checks
    assert set(line["checks"]) == {"median_abs_diff", "first_frame_gap_share"}
    metrics = line["metrics"]
    if trace:
        assert {"bvh_walk_ms", "bvh_steps_per_frame", "bvh_nodes_per_ray", "bvh_lane_use_pct",
                "syncs_per_frame", "shade_ms", "sync_ms"} <= set(metrics)
        assert 0 < metrics["bvh_lane_use_pct"]["value"] <= 100
        assert "frame_ms" not in metrics and "frame_p95_ms" not in metrics
    else:
        assert set(metrics) == {"frame_ms", "setup_s"}
    assert all(entry["value"] > 0 for entry in metrics.values())


@pytest.mark.parametrize("bad", ["control", *faults.FAULTS])
def test_control_and_faults_are_not_correct(bad):
    kw = {"control": "bfloat16"} if bad == "control" else {"fault": bad}
    result, checks = _run(**kw)
    assert not result["correct"], checks


def test_walk_readers_keep_the_window(monkeypatch):
    import types

    from ptbench import manifest, program_spans
    from tpu_pathtracer_torch.utils.spans import Count, Span

    spans = [Span("walk.fat", 1100, 1400, -1, 0, None),
             Span("walk.fat.compact", 1300, 1350, 0, 0, None),
             Span("walk.fat", 1500, 1600, -1, 1, None),
             Span("walk.fat", 2500, 2900, -1, 2, None)]  # ends after the window
    counts = [Count("walk.fat.rays", 1100, 0, 100), Count("walk.fat.steps", 1400, 0, 24),
              Count("walk.fat.lane_steps", 1400, 0, 2000), Count("walk.fat.nodes", 1400, 0, 500),
              Count("walk.fat.nodes", 2900, 2, 99999)]
    fake = types.SimpleNamespace(recorded=lambda: spans, counters=lambda: counts)
    trace = types.SimpleNamespace(window_us=(1000.0, 2000.0))
    monkeypatch.setattr(program_spans, "recorder", lambda: fake)
    want = {"bvh_walk_ms": 0.4 / 2, "bvh_steps_per_frame": 24 / 2, "bvh_nodes_per_ray": 500 / 100,
            "bvh_lane_use_pct": 100 * 500 / 2000}
    for name, value in want.items():
        assert manifest.reader(name)(trace, {"frames": 2}) == pytest.approx(value, rel=1e-9)
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert all(manifest.reader(name)(trace, {"frames": 2}) is None for name in want)


def test_traced_window_is_cut_to_its_bound(monkeypatch):
    from ptbench import manifest

    load = manifest.loop

    def loop(name, bench=manifest.HERE):
        module = load(name, bench)
        module.TRACED_SECONDS = 1e-3
        return module

    monkeypatch.setattr(manifest, "loop", loop)
    result, _ = run.run_cell(ROOT, CELL, 20251019, 60.0, True, time.perf_counter(),
                             device="cpu", overrides=SMALL)
    assert result["attempted"] == 1 and result["device"]["window_s"] < 60.0
