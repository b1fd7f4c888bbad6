"""Port parity: the Renderer's shell (per-pass timing, options, checkpoints)
and the timing and metrics modules.

  * `RollingAverage` gives the JAX package's values for the same samples;
  * `MetricsLogger` emits the same events with the same keys and values as
    the JAX package's for the same sequence of renderer events (its
    timestamps and wall-clock rates aside);
  * `enable_timing=True` renders the same accumulation as without it, and
    fills the three pass meters;
  * checkpoints cross between the packages in both directions (a JAX
    `save_state` npz loads in the port, and back, with the same acc, frame
    and keys), and a resumed render equals a fresh one bit for bit."""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_pathtracer as jpt
from tpu_pathtracer.render.metrics import MetricsLogger as JMetricsLogger
from tpu_pathtracer.render.timing import PassTimer as JPassTimer
from tpu_pathtracer.render.timing import RollingAverage as JRollingAverage
from tpu_pathtracer.scene.envmap import gradient_sky as j_gradient_sky
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.render.metrics import MetricsLogger
from tpu_pathtracer_torch.render.timing import PassTimer, RollingAverage
from tpu_pathtracer_torch.scene.envmap import gradient_sky

CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
CFG = dict(width=16, height=12, frames=3, samples_per_frame=1, max_bounces=2)


def _renderer(**kw):
    return tpt.Renderer(tpt.default_scene(gradient_sky(8, 16)), tpt.Camera.create(**CAM),
                        tpt.RenderConfig(**{**CFG, **kw}), tpt.PostConfig(denoise=False),
                        device="cpu")


def test_rolling_average_matches_jax():
    samples = np.random.default_rng(0).random(75) * 100.0
    a, b = RollingAverage(), JRollingAverage()
    assert a.value == b.value == 0.0
    for x in samples:
        a.add_sample(float(x))
        b.add_sample(float(x))
        assert a.value == b.value


class FakeRenderer:
    """The part of a Renderer that MetricsLogger reads, with its event bus."""

    def __init__(self, timers):
        self.listeners = {}
        self.frame, self.status, self.samples = 1, "idle", 0
        self.config = tpt.RenderConfig(**CFG)
        self.timings = timers

    def on(self, event, cb):
        self.listeners.setdefault(event, []).append(cb)
        return lambda: self.listeners[event].remove(cb)

    def emit(self, event, *args):
        for cb in list(self.listeners.get(event, [])):
            cb(*args)


def test_metrics_logger_emits_the_jax_records():
    timers = {"raytrace": (PassTimer("raytrace"), JPassTimer("raytrace")),
              "accumulate": (PassTimer("accumulate"), JPassTimer("accumulate")),
              "fullscreen": (PassTimer("fullscreen"), JPassTimer("fullscreen"))}
    for i, (t, jt) in enumerate(timers.values()):
        for x in (10.0 * (i + 1), 20.0):
            t.average.add_sample(x)
            jt.average.add_sample(x)
    timers["fullscreen"] = (PassTimer("fullscreen"), JPassTimer("fullscreen"))  # empty: omitted
    rp = FakeRenderer({k: v[0] for k, v in timers.items()})
    rj = FakeRenderer({k: v[1] for k, v in timers.items()})
    sp, sj = io.StringIO(), io.StringIO()
    loggers = [MetricsLogger(rp, stream=sp), JMetricsLogger(rj, stream=sj)]
    for r in (rp, rj):
        r.status = "sampling"
        r.emit("reset")
        r.emit("start")
        for f in (2, 3, 4):
            r.frame, r.samples = f, f - 1
            r.emit("progress", f / 4)
        r.status = "idle"
        r.emit("pause")
        r.emit("complete")
    for lg in loggers:
        lg.close()
    got = [json.loads(x) for x in sp.getvalue().splitlines()]
    want = [json.loads(x) for x in sj.getvalue().splitlines()]
    assert [r["event"] for r in got] == ["reset", "start"] + ["progress"] * 3 + ["pause",
                                                                              "complete"]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in set(a) - {"ts", "frame_ms", "rays_per_s"}:
            assert a[key] == b[key], key
    assert got[-3]["pass_us"] == {"raytrace": 15.0, "accumulate": 20.0}


def test_metrics_logger_follows_a_render():
    r = _renderer()
    stream = io.StringIO()
    logger = MetricsLogger(r, stream=stream)
    r.reset()
    r.render_all()
    logger.close()
    events = [json.loads(x)["event"] for x in stream.getvalue().splitlines()]
    assert events == ["reset", "start", "progress", "progress", "complete", "progress"]


def test_timing_renders_the_same_accumulation():
    plain = _renderer()
    plain.reset()
    want = plain.render_all().clone()
    timed = _renderer()
    timed.set_timing(True)
    timed.reset()
    got = timed.render_all()
    assert torch.equal(got, want)
    img = timed.display()
    assert img.shape == (12, 16, 3)
    assert all(timed.timings[name].value > 0 for name in ("raytrace", "accumulate", "fullscreen"))
    assert all(t.value == 0 for t in plain.timings.values())


def test_set_option_and_env_importance():
    r = _renderer()
    r.reset()
    r.render()
    r.set_option(frames=5, denoise=True, env_intensity=2.0)
    assert r.config.frames == 5 and r.post.denoise and r.env_intensity == 2.0
    assert r.frame == 1 and float(r.accumulation.abs().sum()) == 0.0
    with pytest.raises(AttributeError):
        r.set_option(nonsense=1)
    r.set_env_importance(False)
    assert not r.env_importance
    # env importance sampling (which raised until it was ported): the
    # setter rebuilds the passes and clears the accumulation, and renders
    # what a Renderer built with it renders
    r.set_option(frames=1, env_intensity=1.0)
    r.set_env_importance(True)
    assert r.env_importance and float(r.accumulation.abs().sum()) == 0.0
    r.render_all()
    fresh = _renderer(frames=1)
    fresh = tpt.Renderer(fresh.scene, fresh.camera, fresh.config, fresh.post, device="cpu",
                         env_importance=True)
    assert torch.equal(r.accumulation, fresh.render_all())
    assert not torch.equal(r.accumulation, _renderer(frames=1).render_all())


def test_checkpoint_from_jax_loads_in_the_port(tmp_path):
    jr = jpt.Renderer(jpt.default_scene(j_gradient_sky(8, 16)), jpt.Camera.create(**CAM),
                      jpt.RenderConfig(**CFG))
    acc = np.random.default_rng(1).random((12, 16, 3)).astype(np.float32)
    jr._acc, jr._frame = jnp.asarray(acc), 3
    path = str(tmp_path / "jax.npz")
    jr.save_state(path)
    r = _renderer()
    r.load_state(path)
    assert r.frame == 3 and r.status == "sampling"
    assert r.accumulation.dtype == torch.float32
    np.testing.assert_array_equal(r.accumulation.numpy(), acc)
    # saved again by the port: the same keys, dtypes and values
    path2 = str(tmp_path / "port.npz")
    r.save_state(path2)
    a, b = np.load(path), np.load(path2)
    assert sorted(a.files) == sorted(b.files) == ["acc", "frame", "frames", "spp"]
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_from_the_port_loads_in_jax(tmp_path):
    r = _renderer(frames=4)
    r.reset()
    r.render()
    r.render()
    path = str(tmp_path / "port.npz")
    r.save_state(path)
    jr = jpt.Renderer(jpt.default_scene(j_gradient_sky(8, 16)), jpt.Camera.create(**CAM),
                      jpt.RenderConfig(**{**CFG, "frames": 4}))
    jr.load_state(path)
    assert jr.frame == 3 and jr.status == "sampling"
    np.testing.assert_array_equal(np.asarray(jr.accumulation), r.accumulation.numpy())


def test_resume_equals_a_fresh_render(tmp_path):
    path = str(tmp_path / "ck.npz")
    first = _renderer(frames=2)
    first.reset()
    first.render_all(checkpoint_path=path, checkpoint_every=1)
    resumed = _renderer(frames=4)
    resumed.load_state(path)
    assert resumed.frame == 3
    got = resumed.render_all()
    fresh = _renderer(frames=4)
    fresh.reset()
    assert torch.equal(got, fresh.render_all())


def test_make_frame_step_has_the_jax_signature():
    """make_frame_step (and make_passes, its two halves) take the JAX
    package's parameters, names, order and defaults."""
    import inspect

    from tpu_pathtracer.render.renderer import make_frame_step as j_make_frame_step
    from tpu_pathtracer_torch.render.renderer import make_frame_step, make_passes

    def params(fn):
        return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]

    assert params(make_frame_step) == params(j_make_frame_step)
    assert params(make_passes) == params(j_make_frame_step)


def test_make_frame_step_passes_env_importance_and_blue_noise():
    """`accumulate`, `env_importance` and `blue_noise` by keyword, as JAX's
    step takes them: the step folds what render_frame renders with them."""
    from tpu_pathtracer_torch.ops import trace as ttrace
    from tpu_pathtracer_torch.render.renderer import make_frame_step
    from tpu_pathtracer_torch.scene.sky import sun_sky
    from tpu_pathtracer_torch.utils.bluenoise import blue_noise_table

    data = tpt.default_scene(sun_sky(16, 32)).compile(device="cpu")
    params = tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=1)
    bn = blue_noise_table(64)
    kw = dict(aspect=1.0, samples_per_frame=1, max_bounces=2)
    step = make_frame_step(16, 12, accumulate=False, env_importance=True, blue_noise=bn, **kw)
    acc = step(data, params, torch.zeros((12, 16, 3)))
    want = ttrace.render_frame(data, params, width=16, height=12, env_importance=True,
                               blue_noise=bn, **kw)
    assert torch.equal(acc, want)
    assert not torch.equal(acc, ttrace.render_frame(data, params, width=16, height=12, **kw))


def test_package_exports_match_jax():
    assert tpt.__all__ == jpt.__all__
    from tpu_pathtracer_torch import FlatBVH, ShardConfig  # noqa: F401
