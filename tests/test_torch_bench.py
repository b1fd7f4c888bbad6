"""Port parity: the benchmark harness (tpu_pathtracer_torch/render/benchmark.py).

`make_budget` is held bit for bit to n `Renderer` frames on the CPU.  The
gates of `measure_budget` (non-increasing time, linearity, device time
above twice the slope, the physics ceiling) are driven by a fake clock and
a fake budget whose times are set by the test, so nothing here depends on
how long the CPU takes: a real budget's wall-clock linearity is load
dependent under parallel test workers.  `headline_record` is held to the
JAX package's keys."""

import numpy as np
import pytest
import torch

from tpu_pathtracer.render import benchmark as jbench
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.render import benchmark
from tpu_pathtracer_torch.scene.envmap import gradient_sky

CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)


@pytest.fixture(scope="module")
def scene():
    return tpt.default_scene(gradient_sky(8, 16))


def test_make_budget_equals_renderer_frames(scene):
    cfg = tpt.RenderConfig(width=16, height=12, frames=3, samples_per_frame=1, max_bounces=2)
    r = tpt.Renderer(scene, tpt.Camera.create(**CAM), cfg, device="cpu")
    r.reset()
    want = r.render_all().clone()
    budget = benchmark.make_budget(16, 12, 1, 2)
    params = tpt.RenderParams.create(r.camera, frame=1)
    got = budget(r.scene_data, params, 3)
    assert torch.equal(got, want)
    assert torch.equal(budget(r.scene_data, params, 0), torch.zeros_like(want))


class FakeClock:
    """A clock that moves only when the fake budget runs: a budget of n
    frames takes `latency + n * frame` seconds (`frame` may be a function
    of n)."""

    def __init__(self, latency, frame):
        self.now = 0.0
        self.latency = latency
        self.frame = frame

    def __call__(self):
        return self.now

    def budget(self, scene_data, params, n):
        per = self.frame(n) if callable(self.frame) else self.frame
        self.now += self.latency + n * per
        return torch.zeros((4, 4, 3))


def _measure(scene, clock, *, device_s_per_frame=None, size=64, profile=True, device_fixed_s=0.0,
             device_ok=lambda call: True, device_calls=None):
    """`measure_budget` on the fake clock.  The fake `device_time` reports
    `device_fixed_s + n * device_s_per_frame` for a budget of n frames, and
    fails on the calls (numbered from 0) where `device_ok` is false; the
    frame counts it saw go to `device_calls`."""
    data = scene.compile(device="cpu")
    calls = [] if device_calls is None else device_calls

    def device_time(fn, device):
        if device_s_per_frame is None or not device_ok(len(calls)):
            calls.append(None)
            return {"total_s": 0.0, "programs": {}, "ok": False}
        before = clock.now
        fn()
        n = round((clock.now - before - clock.latency) / clock.frame)
        calls.append(n)
        return {"total_s": device_fixed_s + device_s_per_frame * n, "programs": {}, "ok": True}

    return benchmark.measure_budget(
        clock.budget, data, tpt.Camera.create(**CAM), width=size, height=size, spp=1,
        bounces=4, reps=3, target_seconds=1.0, clock=clock, device_time=device_time,
        profile=profile)


def test_gates_pass_a_linear_budget(scene):
    clock = FakeClock(latency=0.002, frame=0.01)
    res = _measure(scene, clock, device_s_per_frame=0.009)
    assert res.ok and not res.reasons
    assert res.n1 == 100 and res.n2 == 200
    assert res.per_frame_s == pytest.approx(0.01, rel=1e-9)
    assert res.linearity == pytest.approx(0.01 / (2.002 / 200), rel=1e-9)
    assert res.device_per_frame_s == pytest.approx(0.009)
    assert res.rays_per_s == pytest.approx(64 * 64 * 4 / 0.01)


def test_device_time_is_the_two_point_slope(scene):
    """A fixed device cost of 2 s a call cancels in (D(n2) - D(n1)) /
    (n2 - n1): the reading is 9 ms/frame, where D(n1) / n1 would read
    29 ms/frame and trip the 2x gate against the 10 ms wall slope."""
    clock = FakeClock(latency=0.002, frame=0.01)
    seen = []
    res = _measure(scene, clock, device_s_per_frame=0.009, device_fixed_s=2.0, device_calls=seen)
    assert seen == [res.n1, res.n2] == [100, 200]
    assert res.device_per_frame_s == pytest.approx(0.009, rel=1e-9)
    assert (2.0 + 0.009 * res.n1) / res.n1 > 2 * res.per_frame_s
    assert res.ok and not res.reasons


@pytest.mark.parametrize("failing_call", [0, 1], ids=["first", "second"])
def test_device_time_failing_either_reading_is_unavailable(scene, failing_call):
    clock = FakeClock(latency=0.002, frame=0.01)
    res = _measure(scene, clock, device_s_per_frame=0.009,
                   device_ok=lambda call: call != failing_call)
    assert res.device_per_frame_s is None
    assert res.ok and res.per_frame_s == pytest.approx(0.01, rel=1e-9)


def test_gate_refuses_non_increasing_time(scene):
    clock = FakeClock(latency=0.5, frame=lambda n: 0.01 if n <= 2 else 0.0)
    res = _measure(scene, clock, profile=False)
    assert not res.ok and "non-increasing" in res.reasons[0]


def test_gate_refuses_a_latency_bound_budget(scene):
    """Doubling the frames barely moves the time: the linearity gate."""
    clock = FakeClock(latency=100.0, frame=0.001)
    res = _measure(scene, clock, profile=False)
    assert not res.ok and any("linearity fail" in r for r in res.reasons)
    assert res.per_frame_s == pytest.approx(res.t_n2_s / res.n2)


def test_gate_refuses_device_time_above_twice_the_slope(scene):
    clock = FakeClock(latency=0.002, frame=0.01)
    res = _measure(scene, clock, device_s_per_frame=0.025)
    assert not res.ok and any("device time" in r for r in res.reasons)
    assert res.per_frame_s == pytest.approx(0.025)


def test_gate_refuses_throughput_above_the_h100(scene):
    """262,144 x 4 rays in 1 us is beyond the H100's 3.35 TB/s at 32 bytes
    a ray."""
    clock = FakeClock(latency=1e-6, frame=1e-6)
    res = _measure(scene, clock, size=512, profile=False)
    assert not res.ok and any("exceeds hardware" in r for r in res.reasons)
    assert benchmark.HW_PEAK_FLOPS == 989e12 and benchmark.HW_PEAK_HBM_BPS == 3.35e12


@pytest.mark.parametrize("ok,device", [(True, 0.004), (False, None)])
def test_headline_record_has_the_jax_keys(ok, device):
    fields = dict(rays_per_s=2.5e8, per_frame_s=0.005, t_n1_s=0.5, t_n2_s=1.0, n1=100, n2=200,
                  spread_rel=0.01, linearity=0.99, device_per_frame_s=device, compile_s=1.5,
                  ok=ok, reasons=[] if ok else ["linearity fail: ..."])
    got = benchmark.headline_record(benchmark.BenchResult(**fields), "cuda", paths_per_s=5e7)
    want = jbench.headline_record(jbench.BenchResult(**fields), "cuda", paths_per_s=5e7)
    assert got == want
    assert ("suspect" in got) == (not ok)


def test_bench_scaling_is_not_ported(scene):
    """bench_scaling, ported since it was named so: in one process without
    a process group it times tiles=1 alone (efficiency 1) and logs the
    tile counts above the world's one rank as skipped, as JAX's does."""
    logs = []
    rows = benchmark.bench_scaling(scene.compile(device="cpu"), tpt.Camera.create(**CAM),
                                   width=16, height=16, bounces=1, reps=1, target_seconds=0.02,
                                   max_frames=4, log=logs.append)
    assert [r["tiles"] for r in rows] == [1]
    assert rows[0]["per_frame_s"] > 0 and rows[0]["efficiency"] == 1.0
    assert sum("skip tiles=" in line for line in logs) == 3


def test_device_time_requests_no_cuda_activity_off_the_card():
    from tpu_pathtracer_torch.utils.devtime import device_time

    calls = []
    got = device_time(lambda: calls.append(1), device="cpu")
    assert got["ok"] is False and got["total_s"] == 0.0 and not calls
    assert np.isfinite(got["total_s"])
