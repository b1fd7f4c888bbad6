"""The port's 'bvh8' path (the fat-leaf walk in the plain loop) against the
benchmark's plain reference (`ptbench/reference/tracer.py`), which shares
no code with the port: a few progressive frames of a few-thousand-triangle
`mesh_scene` through `Renderer`, compared with the reference traced over
the same pixels and frames, by the benchmark check's two rules
(`ptbench/loops/batch.py`).

The port's Möller–Trumbore (the determinant form) and the reference's
textbook form round apart, so a ray that meets a shared edge can hit the
triangle on one side in one and the other side's in the other, or slip
between them: that path is then another Monte Carlo sample and moves a
few values by up to the whole range.  So the rules are a median and a
share, never a maximum."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_pathtracer_torch as tpt
from ptbench import scenes
from ptbench.check import reference_scene
from ptbench.reference import tracer

ROOT = Path(__file__).resolve().parents[1]
SIZE, FRAMES = 32, 3
# Both rules are the benchmark check's: a median at rounding, far below the
# 8-bit display step it guards, and a share of values whose paths branched
# apart at shared edges, a few percent at most in a sound frame.
MEDIAN_LIMIT = 1e-3  # median |port - reference| of the accumulated radiance
GAP, SHARE_LIMIT = 1e-3, 0.1  # share of frame 1's values off by more than GAP


@pytest.fixture(scope="module")
def config():
    conf = copy.deepcopy(json.loads((ROOT / "ptbench/configs/large524K.json").read_text()))
    conf["meshes"][0]["args"] = [0.5, 48, 24]  # 2,208 triangles on the plane's 2
    conf["environment"].update(height=32, width=64)
    conf["intersector"] = "bvh8"
    return conf


def _frames(config):
    """The port's accumulation after frame 1 and after FRAMES frames."""
    cam = config["camera"]
    r = tpt.Renderer(scenes.program_scene(tpt, config),
                     tpt.Camera.create(position=tuple(cam["position"]),
                                       look_at=tuple(cam["look_at"]), fov=cam["fov"]),
                     tpt.RenderConfig(width=SIZE, height=SIZE, frames=FRAMES,
                                      max_bounces=config["max_bounces"],
                                      intersector=config["intersector"]),
                     tpt.PostConfig(), device="cpu")
    r.reset()
    r.render()
    first = r.accumulation.clone()
    while r.frame <= FRAMES:
        r.render()
    return first.numpy(), r.accumulation.numpy()


def test_bvh8_frames_match_the_plain_reference(config):
    first, acc = _frames(config)
    ys, xs = torch.meshgrid(torch.arange(SIZE), torch.arange(SIZE), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    light = tracer.render(reference_scene(config, "cpu", torch.float32), config["camera"], xs,
                          ys, range(1, FRAMES + 1), SIZE, SIZE, config["max_bounces"])
    mean = light.cumsum(0) / torch.arange(1, FRAMES + 1)[:, None, None]
    want_first = light[0].numpy().reshape(SIZE, SIZE, 3)
    want_acc = mean[-1].numpy().reshape(SIZE, SIZE, 3)
    share = float((np.abs(first - want_first) > GAP).mean())
    median = float(np.median(np.abs(acc - want_acc)))
    assert share <= SHARE_LIMIT, share
    assert median <= MEDIAN_LIMIT, median
    assert np.isfinite(acc).all() and acc.max() > 0.1  # the scene is lit, not black
