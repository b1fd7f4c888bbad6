"""The port held to the repository's own references, not only to the JAX
package: the four 48x48 golden snapshots under tests/golden/, rendered
through the port's Renderer on the CPU and read with the port's
`read_png`, and one frame against the independent numpy oracle
(`tpu_pathtracer/oracle`, read, not ported) under the outlier rule of
tests/test_trace_golden.py:60-70.  The PNGs are never regenerated here.

The snapshots were written by the JAX package on the CPU, and
tests/test_golden_snapshots.py holds JAX to them byte for byte but for 1
u8 on under 1% of values.  The port cannot meet that rule: XLA on the CPU
contracts a*b+c into one rounding (fused multiply-add) and has its own
log, cos and sin, while the port's float32 torch ops round every product
and use torch's functions.  The last-bit differences that follow flip a
few paths of each 48x48 frame onto another branch (a specular choice, an
edge hit), and a flipped path moves its pixel by up to 1/frames of its
range; the denoiser carries it to its neighbours.  So the port's snapshots are held to the golden file's 1-u8
bound on 95% of pixels, and to the outlier rule's bound (a pixel off by
more than 0.05) on 99% of pixels."""

import math
import os

import numpy as np
import pytest
import torch

import tpu_pathtracer_torch as tpt
from tpu_pathtracer.oracle import reference as oracle
from tpu_pathtracer.scene import host as jhost
from tpu_pathtracer_torch.io.image import read_png, to_uint8
from tpu_pathtracer_torch.ops.trace import render_frame
from tpu_pathtracer_torch.scene import primitives
from tpu_pathtracer_torch.scene.envmap import gradient_sky
from tpu_pathtracer_torch.scene.host import Material, Mesh, Scene, rotation_x, translation

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _meshes():
    white = Material(color=(1, 1, 1), roughness=1.0, metalness=0.02)
    red = Material(color=(1, 0.05, 0.05), roughness=1.0, metalness=0.0)
    mirror = Material(color=(0.9, 0.9, 0.9), roughness=0.05, metalness=0.9)
    return [(primitives.plane(5, 5), white, rotation_x(-math.pi / 2)),
            (primitives.box(0.8, 0.8, 0.8), red, translation(0, 0.4, 0.5)),
            (primitives.sphere(0.5, 12, 8), mirror, translation(0, 0.5, -0.6))]


def _scene():
    """tests/test_golden_snapshots.py's `_scene`, in the port."""
    sc = Scene()
    for (p, n, i), mat, xf in _meshes():
        sc.add(Mesh(p, n, i, mat, transform=xf))
    sc.set_environment(gradient_sky(32, 64))
    return sc


def _check(name: str, img_u8: np.ndarray):
    golden = read_png(os.path.join(GOLDEN_DIR, name))[..., :3]
    pix = np.abs(img_u8.astype(int) - golden.astype(int)).max(axis=-1)
    assert (pix > 1).mean() < 0.05, f"{name}: {100 * (pix > 1).mean():.2f}% pixels off by > 1 u8"
    outliers = (pix / 255.0 > 0.05).mean()
    assert outliers < 0.01, f"{name}: {100 * outliers:.2f}% pixels off by > 0.05"


def _render(cfg, cam, post):
    r = tpt.Renderer(_scene(), cam, cfg, post, device="cpu")
    r.reset()
    r.render_all()
    return to_uint8(r.display().numpy()[::-1])


CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
SNAPSHOTS = {
    "base_48.png": (dict(frames=8, max_bounces=3), CAM, tpt.PostConfig(denoise=False)),
    "denoise_reinhard_48.png": (dict(frames=8, max_bounces=3), CAM,
                                tpt.PostConfig(denoise=True, tonemap=tpt.Tonemap.REINHARD)),
    "dof_48.png": (dict(frames=8, max_bounces=2), dict(CAM, focal_distance=3.5, aperture=0.25),
                   tpt.PostConfig(denoise=False)),
    "halfscale_denoise_48.png": (dict(frames=6, max_bounces=3, scaling_factor=0.5), CAM,
                                 tpt.PostConfig(denoise=True)),
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_port_matches_golden_snapshot(name):
    cfg_kw, cam_kw, post = SNAPSHOTS[name]
    cfg = tpt.RenderConfig(width=48, height=48, samples_per_frame=1, **cfg_kw)
    img = _render(cfg, tpt.Camera.create(**cam_kw), post)
    assert img.shape == (48, 48, 3)
    _check(name, img)


def _mini_meshes():
    """tests/test_trace_golden.py's `_mini_scene` (fewer sphere segments for the oracle)."""
    white = Material(color=(1, 1, 1), roughness=1.0, metalness=0.02)
    red = Material(color=(1, 0.05, 0.05), roughness=1.0, metalness=0.0)
    return [(primitives.plane(5, 5), white, rotation_x(-math.pi / 2)),
            (primitives.box(0.8, 0.8, 0.8), red, translation(0, 0.4, 0.5)),
            (primitives.sphere(0.5, 10, 8), white, translation(0, 0.5, -0.5))]


def test_port_frame_matches_the_numpy_oracle():
    """tests/test_trace_golden.py's primary-frame check, through the port:
    one 32x32 frame (4 bounces) against the float64 oracle."""
    pos, direction = (0.0, 1.0, 4.0), (0.0, -0.124034734, -0.992277876)
    jsc, sc = jhost.Scene(), Scene()
    for (p, n, i), mat, xf in _mini_meshes():
        jsc.add(jhost.Mesh(p, n, i, jhost.Material(**vars(mat)), transform=xf))
        sc.add(Mesh(p, n, i, mat, transform=xf))
    jsc.set_environment(gradient_sky(32, 64))
    sc.set_environment(gradient_sky(32, 64))
    want = oracle.render_frame(
        oracle.OracleScene.from_host_scene(jsc), width=32, height=32, aspect=1.0, frame=1,
        camera_position=pos, camera_direction=direction, fov=45.0, focal_distance=1.0,
        aperture=0.0, samples_per_frame=1, max_bounces=4)
    params = tpt.RenderParams.create(tpt.Camera.create(position=pos, direction=direction, fov=45),
                                     frame=1)
    got = render_frame(sc.compile(device="cpu"), params, width=32, height=32, aspect=1.0,
                       samples_per_frame=1, max_bounces=4)
    diff = np.abs(got.to(torch.float64).numpy() - np.asarray(want, np.float64))
    outlier = diff.max(axis=-1) > 0.05
    assert outlier.mean() < 0.01, f"outlier fraction {outlier.mean():.4f}"
    assert diff[~outlier].mean() < 1e-4, f"non-outlier mean abs diff {diff[~outlier].mean():.6f}"
