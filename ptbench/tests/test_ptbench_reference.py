"""The plain reference against the program at a tiny size on the CPU.

The test imports both; the reference itself imports nothing of the program
(`test_ptbench_imports.py`)."""

import json
from pathlib import Path

import numpy as np
import torch

import tpu_pathtracer_torch as pt
from ptbench import scenes
from ptbench.reference import post, tracer
from tpu_pathtracer_torch import diff
from tpu_pathtracer_torch.ops import rng
from tpu_pathtracer_torch.post.denoise import smart_denoise
from tpu_pathtracer_torch.post.tonemap import aces_tonemap

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "ptbench/configs/default_scene.json").read_text())
CAM = CONFIG["camera"]


def _program_frame(size, frame=1, color=None):
    data = scenes.program_scene(pt, CONFIG).compile(device="cpu")
    if color is not None:
        data = diff.api.set_leaf(data, "materials.color", color)
    params = pt.RenderParams.create(pt.Camera.create(position=tuple(CAM["position"]),
                                                     look_at=tuple(CAM["look_at"]), fov=45.0),
                                    frame=frame)
    return diff.render_frame_diff(data, params, width=size, height=size, aspect=1.0,
                                  max_bounces=CONFIG["max_bounces"])


def _reference_paths(size, frame=1):
    tris, table = scenes.world_triangles(CONFIG)
    scene = tracer.build_scene(tris, table, scenes.environment(CONFIG))
    ys, xs = torch.meshgrid(torch.arange(size), torch.arange(size), indexing="ij")
    seed, o, d = tracer.primary(scene, CAM, xs.reshape(-1), ys.reshape(-1), frame, size, size)
    return scene, tracer.trace(scene, o, d, seed, CONFIG["max_bounces"])


def test_rng_stream_is_bit_exact():
    seeds = torch.from_numpy(np.random.default_rng(0).integers(0, 2**32, 4096))
    a, b = seeds.clone(), seeds.clone()
    for _ in range(7):
        a, x = rng.rand(a)
        b, y = tracer.rand(b, torch.float32)
        assert torch.equal(a, b) and torch.equal(x, y)


def test_frame_agrees_but_for_a_few_branching_paths():
    got = _program_frame(48, frame=3).numpy()
    scene, paths = _reference_paths(48, frame=3)
    want = tracer.radiance(paths, scene.color, scene.specular, scene.emission).reshape(48, 48, 3)
    gap = np.abs(got - want.numpy())
    branched = gap.max(-1) > 1e-4  # a path that took another branch
    assert branched.mean() < 0.01
    assert gap[~branched].max() < 1e-5


def test_display_pass_agrees():
    img = torch.from_numpy(np.random.default_rng(1).random((24, 24, 3)).astype(np.float32)) * 3
    frames = torch.stack([img, img * 0.5, img * 2.0])
    acc = post.running_mean(frames)
    want = (img + img * 0.5 + img * 2.0) / 3
    assert torch.allclose(acc, want, rtol=1e-6)
    shown = aces_tonemap(smart_denoise(acc))
    r = post.RADIUS
    tile = torch.roll(acc, shifts=(r - 3, r - 7), dims=(0, 1))[:8 + 2 * r, :8 + 2 * r]
    block = post.aces(post.denoise_block(tile, 8))
    assert torch.allclose(block, shown[3:11, 7:15], atol=2e-6)


def test_colour_gradient_agrees():
    size = 40
    color = torch.tensor([[0.3, 0.6, 0.2], [0.5, 0.1, 0.9]])
    target = _program_frame(size).detach()
    leaf = color.clone().requires_grad_(True)
    loss = diff.l2_image_loss(_program_frame(size, color=leaf), target)
    (got,) = torch.autograd.grad(loss, [leaf])
    scene, paths = _reference_paths(size)
    ref_target = tracer.radiance(paths, scene.color, scene.specular, scene.emission)
    x = color.clone().requires_grad_(True)
    ref_loss = 0.5 * torch.mean((tracer.radiance(paths, x, scene.specular, scene.emission)
                                 - ref_target) ** 2)
    (want,) = torch.autograd.grad(ref_loss, [x])
    assert abs(float(loss.detach()) - float(ref_loss.detach())) < 0.05 * float(ref_loss.detach())
    assert float((got - want).norm()) < 0.05 * float(want.norm())
