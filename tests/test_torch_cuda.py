"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX for the other test files.)
"""

import math
import shutil

import numpy as np
import pytest
import torch

import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch import _build
from tpu_pathtracer_torch.ops import camera as camera_ops
from tpu_pathtracer_torch.ops import trace
from tpu_pathtracer_torch.ops.kernels import denoise as kdenoise
from tpu_pathtracer_torch.ops.kernels import mt_intersect, mt_shade, mt_stream
from tpu_pathtracer_torch.ops.mt_matmul import ray_features
from tpu_pathtracer_torch.ops.rng import pixel_seed
from tpu_pathtracer_torch.scene import envmap, primitives
from tpu_pathtracer_torch.scene.convert import leaves_to_numpy
from tpu_pathtracer_torch.scene.host import rotation_x


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _soup(rng, n, spread=0.1):
    v0 = rng.uniform(-1, 1, (n, 3))
    e = rng.uniform(-spread, spread, (n, 2, 3))
    return np.concatenate([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris,n_rays,tile_rays", [
    (2000, 40000, None),   # default 512-ray tiles
    (700, 1300, 384),      # a partial tile, non-power-of-two tile width
    (5000, 300000, 512),   # > 512 tiles: the tile widens to 1024 rays
])
def test_mt_kernel_matches_plain_bit_for_bit(cuda, n_tris, n_rays, tile_rays):
    rng = np.random.default_rng(n_tris)
    tri = torch.from_numpy(_soup(rng, n_tris)).to(cuda)
    ro = rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    rd = rng.normal(size=(n_rays, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    park = (np.arange(n_rays) % 7 == 0)[:, None]
    ro = np.where(park, np.float32(1e30), ro).astype(np.float32)
    rd = np.where(park, np.float32(0.0), rd).astype(np.float32)
    phi_t = ray_features(torch.from_numpy(ro), torch.from_numpy(rd)).T.contiguous().to(cuda)
    before = mt_shade.mt_intersect_nf_phi.launches
    hk = mt_shade.mt_intersect_nf_phi(tri, phi_t, tile_rays=tile_rays)
    assert mt_shade.mt_intersect_nf_phi.launches == before + 1
    hp = mt_shade.mt_intersect_nf_phi_plain(tri, phi_t, tile_rays=tile_rays)
    assert int(hk.hit.sum()) > 0 and not hk.hit[torch.from_numpy(park[:, 0]).to(cuda)].any()
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)


def _parked_rays(rng, n_rays, park_every=7):
    ro = rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    rd = rng.normal(size=(n_rays, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    park = np.arange(n_rays) % park_every == 0
    ro = np.where(park[:, None], np.float32(1e30), ro).astype(np.float32)
    rd = np.where(park[:, None], np.float32(0.0), rd).astype(np.float32)
    return ray_features(torch.from_numpy(ro), torch.from_numpy(rd)).T.contiguous(), park


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris,n_rays,tile_rays", [
    (9000, 40000, None),    # 5 supers, the last one partly padding
    (2100, 1300, 384),      # a partial tile, dead padding chunks and subs
    (20000, 300000, 512),   # > 512 tiles: the tile widens to 1024 rays
])
def test_stream_kernel_matches_plain_bit_for_bit(cuda, n_tris, n_rays, tile_rays):
    rng = np.random.default_rng(n_tris)
    tri = torch.from_numpy(_soup(rng, n_tris)).to(cuda)
    phi_t, park = _parked_rays(rng, n_rays)
    phi_t = phi_t.to(cuda)
    before = mt_stream.mt_intersect_stream2_phi.launches
    hk = mt_stream.mt_intersect_stream2_phi(tri, phi_t, tile_rays=tile_rays)
    assert mt_stream.mt_intersect_stream2_phi.launches == before + 1
    hp = mt_stream.mt_intersect_stream2_phi_plain(tri, phi_t, tile_rays=tile_rays)
    assert int(hk.hit.sum()) > 0 and not hk.hit[torch.from_numpy(park).to(cuda)].any()
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    # the same liveness decisions: supers walked, chunks staged, subs evaluated
    stats = mt_stream.walk_stats(tri, phi_t, tile_rays=tile_rays)
    assert torch.equal(stats, mt_stream.walk_stats(tri, phi_t, tile_rays=tile_rays, plain=True))
    assert int(stats[:, 2].sum()) > 0


@pytest.mark.cuda
def test_stream_kernel_culls_like_plain_on_a_mesh(cuda):
    """Camera rays on a BVH-ordered mesh (9,402 triangles, padded to
    16,384), where chunk and sub culling decide which blocks are evaluated:
    on random soups every box of a tile is live.  Hits and walk counts must
    equal the plain version's."""
    scene = tpt.Scene()
    scene.add(tpt.Mesh(*primitives.sphere(0.5, 80, 60), tpt.Material()))
    scene.add(tpt.Mesh(*primitives.plane(4, 4), tpt.Material(),
                       transform=rotation_x(-math.pi / 2)))
    tri = scene.compile(device=cuda).packed.tri_pos
    cam = tpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45, device=cuda)
    xs, ys = trace.blocked_pixel_grid(256, 256, cuda)
    o, d = camera_ops.camera_rays(cam, torch.stack([xs / 256.0, ys / 256.0], dim=-1), 1.0)
    phi_t = trace._ray_features_t(o.T.contiguous(), d.T.contiguous())
    hk = mt_stream.mt_intersect_stream2_phi(tri, phi_t)
    hp = mt_stream.mt_intersect_stream2_phi_plain(tri, phi_t)
    assert int(hk.hit.sum()) > 10000
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    stats = mt_stream.walk_stats(tri, phi_t)
    assert torch.equal(stats, mt_stream.walk_stats(tri, phi_t, plain=True))
    walked, staged, evaluated = (int(x) for x in stats.sum(dim=0))
    assert staged < 16 * walked and evaluated < 4 * staged  # both culling levels decide


@pytest.mark.cuda
def test_stream_kernel_empty_and_oversized_scenes_launch_nothing(cuda):
    phi_t = torch.ones((10, 64), device=cuda)
    before = mt_stream.mt_intersect_stream2_phi.launches
    h = mt_stream.mt_intersect_stream2_phi(torch.zeros((0, 9), device=cuda), phi_t)
    assert not h.hit.any()
    with pytest.raises(ValueError):
        mt_stream.mt_intersect_stream2_phi(torch.zeros((262145, 9), device=cuda), phi_t)
    assert mt_stream.mt_intersect_stream2_phi.launches == before


CULL_WRAPPERS = {
    "nf": (mt_shade.mt_intersect_nf_phi, mt_shade.mt_intersect_nf_phi_plain),
    "list": (mt_shade.mt_intersect_list_phi, mt_shade.mt_intersect_list_phi_plain),
    "cond": (mt_shade.mt_intersect_cond_phi, mt_shade.mt_intersect_cond_phi_plain),
}


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [32, 64, 128])
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
@pytest.mark.parametrize("n_tris,n_rays,tile_rays", [
    (2000, 40000, None),   # default 512-ray tiles
    (700, 1300, 384),      # a partial tile, non-power-of-two tile width
])
def test_cull_kernels_match_plain_bit_for_bit(cuda, cull, sub, n_tris, n_rays, tile_rays):
    """Each culling variant at each sub-treelet size, through
    `mt_intersect_pallas2_phi`: only the selected kernel launches, once,
    and its hits equal its plain version's bit for bit."""
    rng = np.random.default_rng(n_tris + sub)
    tri = torch.from_numpy(_soup(rng, n_tris)).to(cuda)
    phi_t, park = _parked_rays(rng, n_rays)
    phi_t = phi_t.to(cuda)
    before = {k: w.launches for k, (w, _) in CULL_WRAPPERS.items()}
    hk = mt_shade.mt_intersect_pallas2_phi(tri, phi_t, tile_rays=tile_rays, cull=cull, sub=sub)
    after = {k: w.launches for k, (w, _) in CULL_WRAPPERS.items()}
    assert {k: after[k] - before[k] for k in after} == {k: int(k == cull) for k in after}
    hp = CULL_WRAPPERS[cull][1](tri, phi_t, tile_rays=tile_rays, sub=sub)
    assert int(hk.hit.sum()) > 0 and not hk.hit[torch.from_numpy(park).to(cuda)].any()
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)


def _camera_rays(cuda, size=256):
    cam = tpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45, device=cuda)
    xs, ys = trace.blocked_pixel_grid(size, size, cuda)
    o, d = camera_ops.camera_rays(cam, torch.stack([xs / float(size), ys / float(size)], dim=-1),
                                  1.0)
    return trace._ray_features_t(o.T.contiguous(), d.T.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [32, 64, 128])
def test_cond_kernel_culls_like_plain_on_a_mesh(cuda, sub):
    """Camera rays on the BVH-ordered default scene (1,998 triangles,
    padded to 2,048), where the chunk and sub tests decide which blocks
    are evaluated: hits and per-tile walk counts (chunks live, subs
    evaluated) must equal the plain version's."""
    tri = tpt.default_scene().compile(device=cuda).packed.tri_pos
    phi_t = _camera_rays(cuda)
    hk = mt_shade.mt_intersect_cond_phi(tri, phi_t, sub=sub)
    hp = mt_shade.mt_intersect_cond_phi_plain(tri, phi_t, sub=sub)
    assert int(hk.hit.sum()) > 10000
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    stats = mt_shade.cond_walk_stats(tri, phi_t, sub=sub)
    assert torch.equal(stats, mt_shade.cond_walk_stats(tri, phi_t, sub=sub, plain=True))
    live, evaluated = (int(x) for x in stats.sum(dim=0))
    n_chunks = tri.shape[0] // mt_shade.CHUNK_TRIS
    assert live < n_chunks * stats.shape[0]  # the chunk test culls
    assert evaluated <= live * (mt_shade.CHUNK_TRIS // sub)
    if sub < mt_shade.CHUNK_TRIS:
        assert evaluated < live * (mt_shade.CHUNK_TRIS // sub)  # and so does the sub test


MXU_WRAPPERS = {
    "nf": (mt_shade.mt_intersect_nf_mxu_phi, mt_shade.mt_intersect_nf_mxu_phi_plain),
    "list": (mt_shade.mt_intersect_list_mxu_phi, mt_shade.mt_intersect_list_mxu_phi_plain),
    "cond": (mt_shade.mt_intersect_cond_mxu_phi, mt_shade.mt_intersect_cond_mxu_phi_plain),
}


def _assert_mxu_agrees(tri, phi_t, hk, hp, what):
    """`hit_agreement`'s MXU rule: hit and triangle equal on at least 99.9%
    of lanes, each differing lane a near-tie, an edge or a floor lane, and
    t, u, v within 1e-4 of their conditioned scale where both hit the same
    triangle."""
    agree = mt_shade.hit_agreement(tri, phi_t, hk, hp)
    assert agree["ok"], f"{what}: {agree}"
    return agree


def _assert_walk_counts_close(sk, sp):
    """cond walk counts of the MXU kernel against its plain version: t
    differs between them by float32 rounding, so a box whose entry ties a
    ray's t may be decided the other way; at most 1% of the tiles may
    differ, and the total subs evaluated by at most 1%."""
    tiles = int((sk != sp).any(dim=1).sum())
    assert tiles <= 0.01 * sk.shape[0], (tiles, sk.shape[0])
    ek, ep = int(sk[:, 1].sum()), int(sp[:, 1].sum())
    assert abs(ek - ep) <= 0.01 * ep, (ek, ep)


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [32, 64, 128])
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
@pytest.mark.parametrize("n_tris,n_rays,tile_rays", [
    (2000, 40000, None),   # default 512-ray tiles
    (700, 1300, 384),      # a partial tile, non-power-of-two tile width
])
def test_mxu_kernels_match_plain_on_soups(cuda, cull, sub, n_tris, n_rays, tile_rays):
    """Each MXU variant through `mt_intersect_pallas2_phi(mxu_dets=True)`:
    only it launches, once, and it agrees with its plain version and with
    the FP32 kernel by the MXU rule."""
    rng = np.random.default_rng(n_tris + sub)
    tri = torch.from_numpy(_soup(rng, n_tris)).to(cuda)
    phi_t, park = _parked_rays(rng, n_rays)
    phi_t = phi_t.to(cuda)
    wrappers = {**{k: w for k, (w, _) in CULL_WRAPPERS.items()},
                **{f"{k}_mxu": w for k, (w, _) in MXU_WRAPPERS.items()}}
    before = {k: w.launches for k, w in wrappers.items()}
    hk = mt_shade.mt_intersect_pallas2_phi(tri, phi_t, tile_rays=tile_rays, cull=cull, sub=sub,
                                           mxu_dets=True)
    after = {k: w.launches - before[k] for k, w in wrappers.items()}
    assert after == {k: int(k == f"{cull}_mxu") for k in after}
    assert int(hk.hit.sum()) > 0 and not hk.hit[torch.from_numpy(park).to(cuda)].any()
    with mt_shade._full_fp32():
        assert not torch.backends.cuda.matmul.allow_tf32
        hp = MXU_WRAPPERS[cull][1](tri, phi_t, tile_rays=tile_rays, sub=sub)
    _assert_mxu_agrees(tri, phi_t, hk, hp, "plain")
    hf = CULL_WRAPPERS[cull][0](tri, phi_t, tile_rays=tile_rays, sub=sub)
    _assert_mxu_agrees(tri, phi_t, hk, hf, "fp32")
    if cull == "cond":
        sk = mt_shade.cond_walk_stats(tri, phi_t, tile_rays=tile_rays, sub=sub, mxu=True)
        sp = mt_shade.cond_walk_stats(tri, phi_t, tile_rays=tile_rays, sub=sub, mxu=True,
                                      plain=True)
        assert torch.equal(sk, sp)  # every box of a random soup is live


@pytest.mark.cuda
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
@pytest.mark.parametrize("tile_rays,sub", [(128, 64), (1024, 64), (4096, 32), (8192, 128)])
def test_mxu_kernels_take_every_tile_width(cuda, cull, tile_rays, sub):
    """Every tile width the wrapper produces runs, up to 8,192 rays at sub
    128 (csrc/mxu_walk.cu: 1, 2 or 4 m-tiles a warp over a cluster of 8;
    cond's widest over a cluster of 16)."""
    rng = np.random.default_rng(tile_rays + sub)
    tri = torch.from_numpy(_soup(rng, 1500)).to(cuda)
    phi_t, _ = _parked_rays(rng, 3 * tile_rays - 77)
    phi_t = phi_t.to(cuda)
    kernel, plain = MXU_WRAPPERS[cull]
    hk = kernel(tri, phi_t, tile_rays=tile_rays, sub=sub)
    hp = plain(tri, phi_t, tile_rays=tile_rays, sub=sub)
    assert int(hk.hit.sum()) > 0
    _assert_mxu_agrees(tri, phi_t, hk, hp, f"{cull} {tile_rays}")


@pytest.mark.cuda
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
def test_mxu_kernels_refuse_a_tile_no_shape_places(cuda, cull):
    """The MXU walks place tiles of up to 8,192 rays; the wrapper refuses a
    wider one with a ValueError and launches nothing."""
    tri = torch.from_numpy(_soup(np.random.default_rng(3), 300)).to(cuda)
    phi_t = torch.ones((10, 256), device=cuda)
    wrapper = MXU_WRAPPERS[cull][0]
    before = wrapper.launches
    if cull == "cond":
        with pytest.raises(ValueError, match="no launch shape"):
            wrapper(tri, phi_t, tile_rays=16384, sub=64)
    else:  # the nf and list wrappers widen the tile only past 512 tiles
        prepare, _, walk = mt_shade._MXU_WALKS[cull]
        prep = mt_shade._mma_prepare(prepare)(tri, phi_t, 16384, 64)
        with pytest.raises(ValueError, match="no launch shape"):
            walk(*prep, mxu=True)
    assert wrapper.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
def test_mxu_parked_and_padding_lanes_stay_finite(cuda, cull):
    """Padding lanes carry phi = 1e30 and parked lanes ro = 1e30, rd = 0;
    zero coefficient columns meet them in both the hi and the lo products.
    No output lane may be NaN, and parked lanes never hit (nf: padding
    lanes neither)."""
    rng = np.random.default_rng(17)
    tri = torch.from_numpy(_soup(rng, 900)).to(cuda)
    phi_t, park = _parked_rays(rng, 1000, park_every=3)  # pads to 1024
    phi_t = phi_t.to(cuda)
    prepare, _, walk = mt_shade._MXU_WALKS[cull]
    prep = mt_shade._mma_prepare(prepare)(tri, phi_t, None, 64)
    t, idx, u, v = walk(*prep, mxu=True)
    torch.cuda.synchronize()
    assert t.shape == (1024,)
    for x in (t, u, v):
        assert not torch.isnan(x).any()
    parked = torch.from_numpy(park).to(cuda)
    assert (idx[:1000][parked] == -1).all()
    if cull == "nf":
        assert (idx[1000:] == -1).all() and (t[1000:] == -1e20).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [32, 64, 128])
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
def test_mxu_kernels_on_a_mesh(cuda, cull, sub):
    """Camera rays on the default scene: each MXU kernel against its plain
    version and the FP32 kernel by the MXU rule; cond's walk counts against
    its plain version's, and its culling skips work."""
    tri = tpt.default_scene().compile(device=cuda).packed.tri_pos
    phi_t = _camera_rays(cuda)
    kernel, plain = MXU_WRAPPERS[cull]
    hk = kernel(tri, phi_t, sub=sub)
    assert int(hk.hit.sum()) > 10000
    _assert_mxu_agrees(tri, phi_t, hk, plain(tri, phi_t, sub=sub), "plain")
    _assert_mxu_agrees(tri, phi_t, hk, CULL_WRAPPERS[cull][0](tri, phi_t, sub=sub), "fp32")
    if cull == "cond":
        sk = mt_shade.cond_walk_stats(tri, phi_t, sub=sub, mxu=True)
        _assert_walk_counts_close(sk, mt_shade.cond_walk_stats(tri, phi_t, sub=sub, mxu=True,
                                                               plain=True))
        live = int(sk[:, 0].sum())
        assert live < tri.shape[0] // mt_shade.CHUNK_TRIS * sk.shape[0]


def _bounce_rays(cuda, size=256):
    """The default scene's first-bounce ray features at size x size, as
    render_frame builds them: rays leave the surfaces they hit, terminated
    rays parked.  Returns (tri_pos, phi_t)."""
    data = tpt.default_scene(envmap.gradient_sky(16, 32)).compile(device=cuda)
    cam = tpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45, device=cuda)
    xs, ys = trace.blocked_pixel_grid(size, size, cuda)
    o, d = camera_ops.camera_rays(cam, torch.stack([xs / float(size), ys / float(size)], dim=-1),
                                  1.0)
    ro, rd = o.T.contiguous(), d.T.contiguous()
    seed = pixel_seed(xs + ys * size, 1)
    hit = mt_shade.mt_intersect_nf_phi(data.packed.tri_pos, trace._ray_features_t(ro, rd))
    carry = (ro, rd, torch.zeros_like(ro), torch.ones_like(ro), seed,
             torch.ones_like(seed, dtype=torch.bool))
    ro2, rd2, _, _, _, active = trace.bounce_shade_t(
        data, tpt.RenderParams.create(cam, frame=1), hit, carry,
        shade_mat=trace.pack_shade_material_rows(data))
    am = active[None, :]
    phi_t = trace._ray_features_t(torch.where(am, ro2, 1e30), torch.where(am, rd2, 0.0))
    return data.packed.tri_pos, phi_t


def _mxu_mutant_agreement(cuda, tmp_path, monkeypatch, old, new):
    """`hit_agreement` of the MXU nf kernel against its plain version on
    rays leaving the default scene's surfaces (which re-hit them at t about
    0), as built from csrc/ and from a copy of csrc/ whose mxu_walk.cu has
    its one `old` replaced by `new`: (intact, mutant)."""
    tri, phi_t = _bounce_rays(cuda)
    hp = mt_shade.mt_intersect_nf_mxu_phi_plain(tri, phi_t)
    good = mt_shade.hit_agreement(tri, phi_t, mt_shade.mt_intersect_nf_mxu_phi(tri, phi_t), hp)
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    walk = src / "mxu_walk.cu"
    text = walk.read_text()
    assert text.count(old) == 1
    walk.write_text(text.replace(old, new))
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "_cache_dir", tmp_path / "build")
    _build.load.cache_clear()
    try:
        bad = mt_shade.hit_agreement(tri, phi_t, mt_shade.mt_intersect_nf_mxu_phi(tri, phi_t), hp)
    finally:
        _build.load.cache_clear()  # the next load() builds from the package's sources
    print(f"intact kernel: {good}\nmutant ({new}): {bad}")
    return good, bad


@pytest.mark.cuda
def test_mxu_rule_catches_a_dropped_epsilon_test(cuda, tmp_path, monkeypatch):
    """Mutation check of `hit_agreement`'s rule: the MXU nf kernel passes it
    against its plain version, and a copy of csrc/mxu_walk.cu whose
    epilogue tests t as ts > 0 (EPSILON*|a| dropped) fails it."""
    good, bad = _mxu_mutant_agreement(cuda, tmp_path, monkeypatch,
                                      "ts > __fmul_rn(kEpsilon, abs_a)", "ts > 0.f")
    assert good["ok"], good
    assert not bad["ok"], bad


@pytest.mark.cuda
def test_mxu_rule_catches_a_hi_that_keeps_its_low_bits(cuda, tmp_path, monkeypatch):
    """Mutation check of the rays' 3xTF32 split: a copy of csrc/mxu_walk.cu
    whose hi is x itself (no `cvt.rna`) keeps bits the MMA ignores, so lo =
    x - hi is 0 and the rays enter the product at TF32's precision; the
    rule catches it."""
    good, bad = _mxu_mutant_agreement(cuda, tmp_path, monkeypatch, "hi = to_tf32(x);",
                                      "hi = __float_as_uint(x);")
    assert good["ok"], good
    assert not bad["ok"], bad


def _diff_setup(device, size=32):
    scene = tpt.default_scene(envmap.gradient_sky(16, 32)).compile(device=device)
    params = tpt.RenderParams.create(
        tpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45, device=device),
        frame=1)
    kw = dict(width=size, height=size, aspect=1.0, max_bounces=2)
    return scene, params, kw


@pytest.mark.cuda
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
def test_gradients_through_kernel_match_plain(cuda, cull, monkeypatch):
    """`diff.grads` through the MT kernel (TPT_CULL selects which) against
    the same gradients through the plain versions.  The kernels pick the
    same triangles, so only the atomics of the gather backward differ."""
    from tpu_pathtracer_torch import diff

    monkeypatch.setenv("TPT_CULL", cull)
    scene, params, kw = _diff_setup(cuda)
    target = diff.render_frame_diff(scene, params, plain=True, **kw) * 0.8
    wrapper = CULL_WRAPPERS[cull][0]
    before = wrapper.launches
    gk = diff.grads(diff.make_loss(target, **kw), scene, params)
    assert wrapper.launches - before >= 1
    gp = diff.grads(diff.make_loss(target, plain=True, **kw), scene, params)
    for tree_k, tree_p in zip(gk, gp):
        for path, a in leaves_to_numpy(tree_k).items():
            b = leaves_to_numpy(tree_p)[path]
            if a is None:
                assert b is None, path
                continue
            assert np.isfinite(a).all(), path
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=path)
    assert np.abs(leaves_to_numpy(gk[0])["materials.color"]).max() > 0


@pytest.mark.cuda
def test_mt_kernel_empty_scene_launches_nothing(cuda):
    phi_t = torch.ones((10, 64), device=cuda)
    before = mt_shade.mt_intersect_nf_phi.launches
    h = mt_shade.mt_intersect_nf_phi(torch.zeros((0, 9), device=cuda), phi_t)
    assert not h.hit.any() and mt_shade.mt_intersect_nf_phi.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(512, 512), (1080, 1920), (300, 517), (6, 10), (7, 3)])
@pytest.mark.parametrize("sigma", [5.0, 3.0])
def test_denoise_kernel_matches_plain(cuda, sigma, hw):
    """The tiled kernel (compile-time taps at sigma 5, the tap table read at
    run time at sigma 3) against the plain version within the stated
    tolerance; images smaller than the halo included."""
    img = torch.from_numpy(np.random.default_rng(sum(hw)).random(hw + (3,), np.float32)).to(cuda)
    before = kdenoise.smart_denoise.launches
    out = kdenoise.smart_denoise(img, sigma=sigma)
    assert kdenoise.smart_denoise.launches == before + 1
    torch.testing.assert_close(out, kdenoise.smart_denoise_plain(img, sigma=sigma), atol=2e-5,
                               rtol=1e-4)
    assert kdenoise.smart_denoise.launches == before + 1


@pytest.mark.cuda
def test_denoise_kernel_takes_the_widest_radius_and_refuses_a_wider_one(cuda):
    """Radius 17 (921 taps; the staged tile needs more than 48 KB of shared
    memory) runs; radius 18 (1,029 taps, above the 1,024 cap) raises."""
    img = torch.from_numpy(np.random.default_rng(17).random((70, 90, 3), np.float32)).to(cuda)
    out = kdenoise.smart_denoise(img, sigma=17.0)
    torch.testing.assert_close(out, kdenoise.smart_denoise_plain(img, sigma=17.0), atol=2e-5,
                               rtol=1e-4)
    with pytest.raises(RuntimeError):
        kdenoise.smart_denoise(img, sigma=18.0)


R2_WRAPPERS = {
    False: (mt_intersect.mt_intersect_pallas, mt_intersect.mt_intersect_pallas_plain),
    True: (mt_intersect.mt_intersect_stream, mt_intersect.mt_intersect_stream_plain),
}


def _rays(phi_t):
    return phi_t[1:4].T.contiguous(), phi_t[4:7].T.contiguous()


def _assert_r2_walk_matches_plain(cuda, tri, ro, rd, stream):
    """The Hopper round-2 walk (csrc/r2_walk.cu) against the plain walk on
    the same prepared inputs: hits and t/u/v bit-equal, walk counts equal.
    Returns the plain hits and the Hopper walk's counts."""
    prep = (*mt_intersect._prepare(tri, ro, rd, stream), stream)
    table = mt_intersect._r2_table(*prep[1:2], prep[3], stream)
    sk = torch.zeros((prep[0].shape[1] // 1024, 2), dtype=torch.int32, device=cuda)
    hk = mt_intersect._walk_table_cuda(prep[0], table, *prep[2:], stats=sk)
    sp = torch.zeros_like(sk)
    hp = mt_intersect._walk_plain(*prep, stats=sp)
    assert torch.equal(sk, sp)
    for a, c in zip(hk, hp):
        assert torch.equal(a, c)
    return hp, sk


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True], ids=["pallas", "stream"])
@pytest.mark.parametrize("n_tris,n_rays", [
    (2000, 40000),   # chunks of 128, a partial last tile
    (700, 1300),     # a partial last chunk of padding rows
    (61, 3000),      # chunks of 64 (the chunk rule for small scenes)
    (7, 2500),       # chunks of 8
    (3968, 5000),    # 31 chunks: one short group
    (4096, 5000),    # 32 chunks: one whole group
    (4224, 5000),    # 33 chunks: a group and one chunk
    (8192, 20480),   # the whole-scene cap, whole tiles
])
def test_r2_kernels_match_plain_bit_for_bit(cuda, stream, n_tris, n_rays):
    """The round-2 kernels (mt_intersect_pallas / mt_intersect_stream, one
    Hopper walk) against their plain versions on soups with parked rays:
    one launch, bit-equal hits and t/u/v, equal walk counts; and the walk
    on the same prepared inputs, bit for bit."""
    rng = np.random.default_rng(n_tris + n_rays)
    tri = torch.from_numpy(_soup(rng, n_tris)).to(cuda)
    phi_t, park = _parked_rays(rng, n_rays)
    ro, rd = (x.to(cuda) for x in _rays(phi_t))
    kernel, plain = R2_WRAPPERS[stream]
    before = kernel.launches
    hk = kernel(tri, ro, rd)
    assert kernel.launches == before + 1
    hp = plain(tri, ro, rd)
    assert int(hk.hit.sum()) > 0 and not hk.hit[torch.from_numpy(park).to(cuda)].any()
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    stats = mt_intersect.walk_stats(tri, ro, rd, stream=stream)
    assert torch.equal(stats, mt_intersect.walk_stats(tri, ro, rd, stream=stream, plain=True))
    _assert_r2_walk_matches_plain(cuda, tri, ro, rd, stream)


@pytest.mark.cuda
def test_r2_stream_walk_at_its_cap(cuda):
    """`mt_intersect_stream` at 131,072 triangles (1,024 chunks, 32 groups)
    on camera rays over copies of a BVH-ordered mesh, each below the last
    (so chunks are culled), and a
    ray count that is no multiple of 1,024: bit-equal to the plain walk,
    walk counts equal."""
    mesh = _stream_mesh(cuda)  # 16,384 rows; eight copies, each 2 below the last
    drop = torch.zeros(9, device=cuda)
    drop[[1, 4, 7]] = -2.0
    tri = torch.cat([mesh + j * drop for j in range(131072 // mesh.shape[0])])
    ro, rd = (x[:9000].contiguous() for x in _rays(_camera_rays(cuda)))
    before = mt_intersect.mt_intersect_stream.launches
    hk = mt_intersect.mt_intersect_stream(tri, ro, rd)
    assert mt_intersect.mt_intersect_stream.launches == before + 1
    hp, stats = _assert_r2_walk_matches_plain(cuda, tri, ro, rd, True)
    for a, b in zip((hk.t, hk.tri, hk.u, hk.v), hp):
        assert torch.equal(a, b[:9000])
    assert int(hk.hit.sum()) > 1000 and 0 < int(stats[:, 0].max()) < 1024


@pytest.mark.cuda
def test_r2_walk_kept_shape_matches_plain(cuda):
    """The walk at its one launch shape (a cluster of 8 CTAs a tile, 2
    lanes a ray) is bit-equal to the plain walk, walk counts included, on
    camera rays over the default scene and on a soup of 33 chunks."""
    tri = tpt.default_scene().compile(device=cuda).packed.tri_pos
    ro, rd = (x[:30000].contiguous() for x in _rays(_camera_rays(cuda)))
    _assert_r2_walk_matches_plain(cuda, tri, ro, rd, False)
    rng = np.random.default_rng(33)
    soup = torch.from_numpy(_soup(rng, 4224)).to(cuda)
    ro, rd = (x.to(cuda) for x in _rays(_parked_rays(rng, 5000)[0]))
    _assert_r2_walk_matches_plain(cuda, soup, ro, rd, True)
    shape_of = mt_shade.walk_shape("tpt_mt_r2_walk_shape")
    assert (shape_of["cluster"], shape_of["tpr"], shape_of["threads"]) == (8, 2, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True], ids=["pallas", "stream"])
def test_r2_kernels_cull_like_plain_on_a_mesh(cuda, stream):
    """Camera rays on the BVH-ordered default scene, where chunk culling
    (and the copies) decide what is evaluated: hits and walk counts must
    equal the plain version's, and the culling must skip chunks."""
    tri = tpt.default_scene().compile(device=cuda).packed.tri_pos
    ro, rd = _rays(_camera_rays(cuda))
    kernel, plain = R2_WRAPPERS[stream]
    hk, hp = kernel(tri, ro, rd), plain(tri, ro, rd)
    assert int(hk.hit.sum()) > 10000
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    stats = mt_intersect.walk_stats(tri, ro, rd, stream=stream)
    assert torch.equal(stats, mt_intersect.walk_stats(tri, ro, rd, stream=stream, plain=True))
    evaluated, copied = (int(x) for x in stats.sum(dim=0))
    assert 0 < evaluated < stats.shape[0] * tri.shape[0] // mt_intersect.CHUNK_TRIS
    assert copied >= evaluated


@pytest.mark.cuda
def test_r2_kernels_empty_and_oversized_scenes_launch_nothing(cuda):
    ro = torch.zeros((64, 3), device=cuda)
    rd = torch.ones((64, 3), device=cuda)
    for stream, cap in ((False, 8192), (True, 131072)):
        kernel = R2_WRAPPERS[stream][0]
        before = kernel.launches
        h = kernel(torch.zeros((0, 9), device=cuda), ro, rd)
        assert not h.hit.any() and (h.t == 1e20).all()
        with pytest.raises(ValueError, match="bvh8"):
            kernel(torch.zeros((cap + 1, 9), device=cuda), ro, rd)
        assert kernel.launches == before


@pytest.mark.cuda
def test_r2_walk_refuses_bad_inputs_before_a_launch(cuda, monkeypatch):
    """Rays that are not whole 1,024-ray tiles, `_prepare`'s 40-float rows
    in place of the walk table, a misaligned table or box array and a
    chunk off the 8-step rule raise ValueError before the launch, and
    through the wrappers count none."""
    rng = np.random.default_rng(3)
    tri = torch.from_numpy(_soup(rng, 700)).to(cuda)
    ro, rd = (x.to(cuda) for x in _rays(_parked_rays(rng, 3000)[0]))
    phi_pad, rows, boxes, chunk = mt_intersect._prepare(tri, ro, rd, True)
    table = mt_intersect._r2_table(rows, chunk, True)
    walk = mt_intersect._walk_table_cuda
    odd = torch.empty(table.numel() + 4, device=cuda)[1:table.numel() + 1].view_as(table)
    odd.copy_(table)
    for bad in (lambda: walk(phi_pad[:, :1536].contiguous(), table, boxes, chunk, True),
                lambda: walk(phi_pad, rows.reshape(-1, 10), boxes, chunk, True),
                lambda: walk(phi_pad, odd, boxes, chunk, True),
                lambda: walk(phi_pad, table, odd.view(-1)[:boxes.numel()].view_as(boxes), chunk,
                             True),
                lambda: walk(phi_pad, table.reshape(-1, 20)[:-4], boxes[:-1], chunk - 4, True)):
        with pytest.raises(ValueError):
            bad()
    kernel = mt_intersect.mt_intersect_stream
    before = kernel.launches
    monkeypatch.setattr(mt_intersect, "_r2_table", lambda rows, chunk, stream: rows)
    with pytest.raises(ValueError):
        kernel(tri, ro, rd)
    assert kernel.launches == before


@pytest.mark.cuda
def test_walk_count_check_catches_a_dropped_r2_mask_reformation(cuda, tmp_path, monkeypatch):
    """Mutation check of the round-2 walk's decisions by mask: a copy of
    the kernels that keeps each group's first mask (chunks stay live under
    the t they were first tested against) still finds the same hits, but
    evaluates more chunks than the plain walk, and the walk-count check
    sees it."""
    tri = tpt.default_scene().compile(device=cuda).packed.tri_pos
    ro, rd = _rays(_camera_rays(cuda))
    rng = np.random.default_rng(8)
    soup = torch.from_numpy(_soup(rng, 4224))
    soup = soup[torch.argsort(soup[:, 2], descending=True)].to(cuda)  # chunks as z slabs
    soup[0] = torch.tensor([-20, -20, -0.2, 20, -20, -0.2, 0, 20, -0.2], device=cuda)  # a floor
    s_ro = torch.tensor([[0.0, 0.0, 3.0]], device=cuda).expand(3000, 3).contiguous()
    s_rd = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(3000, 3)).astype(np.float32)).to(cuda)
        * torch.tensor([0.1, 0.1, 1.0], device=cuda) - torch.tensor([0, 0, 2.0], device=cuda),
        dim=1)
    cases = ((tri, ro, rd), (soup, s_ro, s_rd))
    sp = [mt_intersect.walk_stats(*c, stream=True, plain=True) for c in cases]
    assert all(torch.equal(mt_intersect.walk_stats(*c, stream=True), s) for c, s in zip(cases, sp))
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    walk = src / "r2_walk.cu"
    text = walk.read_text()
    reform = "chunks = decide<C>(slots, parity, live, kNone).bits;"
    assert text.count(reform) == 1
    walk.write_text(text.replace(reform, "chunks = decide<C>(slots, parity, chunks, kNone).bits;"))
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "_cache_dir", tmp_path / "build")
    _build.load.cache_clear()
    try:
        bad = [mt_intersect.walk_stats(*c, stream=True) for c in cases]
        hits = [mt_intersect.mt_intersect_stream(*c) for c in cases]
    finally:
        _build.load.cache_clear()  # the next load() builds from the package's sources
    print(f"plain walk counts {[s.sum(dim=0).tolist() for s in sp]}, mutant "
          f"{[b.sum(dim=0).tolist() for b in bad]}")
    for c, h in zip(cases, hits):
        assert all(torch.equal(a, b) for a, b in zip(h, mt_intersect.mt_intersect_stream_plain(*c)))
    assert any(int(b[:, 0].sum()) > int(s[:, 0].sum()) for b, s in zip(bad, sp))


# --- the Hopper walks (csrc/nf_walk.cu, csrc/stream_walk.cu, csrc/cond_walk.cu)

WALK_WIDTHS = [128, 200, 333, 512, 1024, 4096, 8192]  # 200, 333: uneven over a cluster


def _stream_mesh(cuda):
    """A BVH-ordered sphere and plane (9,402 triangles, padded to 16,384):
    past the nf kernel's 8,192, so the streamed walk culls on it."""
    scene = tpt.Scene()
    scene.add(tpt.Mesh(*primitives.sphere(0.5, 80, 60), tpt.Material()))
    scene.add(tpt.Mesh(*primitives.plane(4, 4), tpt.Material(),
                       transform=rotation_x(-math.pi / 2)))
    return scene.compile(device=cuda).packed.tri_pos


def _walk_inputs(cuda, kind, stream):
    """(tri_pos, phi_t, parked lanes or None) of a soup with parked rays and
    a partial last tile, or of camera rays on a mesh."""
    if kind == "mesh":
        tri = _stream_mesh(cuda) if stream else tpt.default_scene().compile(device=cuda).packed.tri_pos
        return tri, _camera_rays(cuda), None
    rng = np.random.default_rng(5 + stream)
    tri = torch.from_numpy(_soup(rng, 9000 if stream else 2000)).to(cuda)
    phi_t, park = _parked_rays(rng, 40000 - 77)
    return tri, phi_t.to(cuda), torch.from_numpy(park).to(cuda)


def _assert_walks_agree(cuda, module, prep, n_stats, park=None, r=None):
    """Kept walk and plain walk on the same prepared inputs: hits
    bit-equal, walk counts equal.  Returns the plain walk counts."""
    n_tiles = prep[0].shape[1] // prep[-1]
    sk = torch.zeros((n_tiles,) + n_stats, dtype=torch.int32, device=cuda)
    sp = torch.zeros_like(sk)
    hk = module._walk_cuda(*prep, stats=sk)
    hp = module._walk_plain(*prep, stats=sp)
    torch.cuda.synchronize()
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    assert torch.equal(sk, sp)
    if park is not None:
        t, idx = hk[0][:r], hk[1][:r]
        assert (t[park] == -1e20).all() and (idx[park] == -1).all()
        assert (hk[0][r:] == -1e20).all()  # padding lanes never take a hit
    return sp


def _any_tile(monkeypatch):
    """Let the wrappers take a tile width that is no multiple of 128."""
    for module in (mt_shade, mt_stream):
        monkeypatch.setattr(module, "_widened_tile", lambda tile_rays, r: tile_rays)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rays", WALK_WIDTHS)
@pytest.mark.parametrize("kind", ["soup", "mesh"])
def test_nf_walk_matches_plain(cuda, kind, tile_rays, monkeypatch):
    """The Hopper nf walk (sub 64) at every tile width the wrappers give,
    wide tiles included, and at widths that split unevenly over a
    cluster's CTAs and threads (lanes past the tile start at -INF): hits
    bit-equal to the plain walk, per-tile walk counts equal to its."""
    _any_tile(monkeypatch)
    tri, phi_t, park = _walk_inputs(cuda, kind, stream=False)
    prep = mt_shade._prepare(tri, phi_t, tile_rays, 64)
    assert prep[-1] == tile_rays
    sp = _assert_walks_agree(cuda, mt_shade, prep, (), park, phi_t.shape[1])
    assert int(sp.sum()) > 0
    if kind == "mesh":
        assert int(sp.sum()) < sp.shape[0] * prep[3].shape[1] // 2  # the precull culls


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rays", WALK_WIDTHS)
@pytest.mark.parametrize("kind", ["soup", "mesh"])
def test_stream_walk_matches_plain(cuda, kind, tile_rays, monkeypatch):
    """The Hopper streamed walk at every tile width: hits bit-equal to the
    plain walk, walk counts (supers walked, chunks staged, subs evaluated)
    equal to its; on the mesh both culling levels decide."""
    _any_tile(monkeypatch)
    tri, phi_t, park = _walk_inputs(cuda, kind, stream=True)
    prep = mt_stream._prepare(tri, phi_t, tile_rays)
    assert prep[-1] == tile_rays
    sp = _assert_walks_agree(cuda, mt_stream, prep, (3,), park, phi_t.shape[1])
    walked, staged, evaluated = (int(x) for x in sp.sum(dim=0))
    assert evaluated > 0
    if kind == "mesh":
        assert staged < 16 * walked and evaluated < 4 * staged


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [32, 64, 128])
@pytest.mark.parametrize("rays", ["primary", "bounce"])
def test_nf_walk_counts_equal_plain(cuda, sub, rays):
    """`nf_walk_stats` of the kernel equals the plain walk's on the default
    scene's camera rays and first-bounce rays (parked lanes included)."""
    if rays == "primary":
        tri, phi_t = tpt.default_scene().compile(device=cuda).packed.tri_pos, _camera_rays(cuda)
    else:
        tri, phi_t = _bounce_rays(cuda)
    sk = mt_shade.nf_walk_stats(tri, phi_t, sub=sub)
    sp = mt_shade.nf_walk_stats(tri, phi_t, sub=sub, plain=True)
    assert torch.equal(sk, sp) and int(sk.sum()) > 0


@pytest.mark.cuda
def test_stream_walk_repeats_on_bounce_rays(cuda):
    """The streamed walk, launched many times on first-bounce rays of the
    default scene at 512 x 512 (parked lanes, prefetched chunks that a
    re-test drops), returns the plain walk's hits and counts every time.
    A reused staging buffer whose previous copy not every thread had seen
    land stalled the walk now and then, before the staging waited for all
    threads first."""
    tri, phi_t = _bounce_rays(cuda, size=512)
    prep = mt_stream._prepare(tri, phi_t, None)
    sp = torch.zeros((prep[5].shape[0], 3), dtype=torch.int32, device=cuda)
    hp = mt_stream._walk_plain(*prep, stats=sp)
    table = mt_shade._pack_walk_table(prep[1], mt_stream.SUB_TRIS)
    for _ in range(300):
        sk = torch.zeros_like(sp)
        hk = mt_stream._walk_table_cuda(prep[0], table, *prep[2:7], prep[-1], stats=sk)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(hk, hp)) and torch.equal(sk, sp)
    assert int(sp[:, 1].sum()) > 0


@pytest.mark.cuda
def test_walk_count_check_catches_a_skipped_chunk_retest(cuda, tmp_path, monkeypatch):
    """Mutation check of the streamed walk's decisions by mask: a copy of
    the kernels whose chunk mask is not re-tested after an evaluation
    (chunks stay live under the super's first t) still finds the same hits
    (a stale chunk only adds work), but stages more chunks than the plain
    walk, and the walk-count check sees it."""
    tri = _stream_mesh(cuda)
    phi_t = _camera_rays(cuda)
    sp = mt_stream.walk_stats(tri, phi_t, plain=True)
    assert torch.equal(mt_stream.walk_stats(tri, phi_t), sp)
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    walk = src / "stream_walk.cu"
    text = walk.read_text()
    retest = "retest(chunks, 0)"
    assert text.count(retest) == 2
    walk.write_text(text.replace(retest, "chunks"))
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "_cache_dir", tmp_path / "build")
    _build.load.cache_clear()
    try:
        bad = mt_stream.walk_stats(tri, phi_t)
        hits = mt_stream.mt_intersect_stream2_phi(tri, phi_t)
    finally:
        _build.load.cache_clear()  # the next load() builds from the package's sources
    print(f"plain walk counts {sp.sum(dim=0).tolist()}, mutant {bad.sum(dim=0).tolist()}")
    assert all(torch.equal(a, b) for a, b in
               zip(hits, mt_stream.mt_intersect_stream2_phi_plain(tri, phi_t)))
    assert not torch.equal(bad, sp)
    assert int(bad[:, 1].sum()) > int(sp[:, 1].sum())


def _cond_prep(tri, phi_t, tile_rays, sub):
    """`mt_shade._prepare_cond` at any tile width."""
    tri_padded, cols_rows = mt_shade._pad_scene(tri, sub)
    return (mt_shade._pad_rays(phi_t, tile_rays), cols_rows,
            mt_intersect.treelet_boxes(tri_padded, mt_shade.CHUNK_TRIS),
            mt_intersect.treelet_boxes(tri_padded, sub), tile_rays)


def _cond_rays(cuda, rays, size=256):
    if rays == "primary":
        return tpt.default_scene().compile(device=cuda).packed.tri_pos, _camera_rays(cuda, size)
    return _bounce_rays(cuda, size)


def _cond_walks(cuda, prep):
    """(kernel hits, kernel walk counts, plain hits, plain walk counts)."""
    sk = torch.zeros((prep[0].shape[1] // prep[-1], 2), dtype=torch.int32, device=cuda)
    sp = torch.zeros_like(sk)
    hk = mt_shade._walk_cond_cuda(*prep, stats=sk)
    hp = mt_shade._walk_cond_plain(*prep, stats=sp)
    torch.cuda.synchronize()
    return hk, sk, hp, sp


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rays", [512, 200, 333, 4096, 8192])
@pytest.mark.parametrize("rays", ["primary", "bounce"])
@pytest.mark.parametrize("sub", [8, 16, 32, 64, 128])
def test_cond_walk_matches_plain(cuda, sub, rays, tile_rays):
    """The Hopper cond walk (csrc/cond_walk.cu) on the default scene's
    camera and first-bounce rays at every sub, at tile widths that split
    unevenly over the cluster and wide ones: hits bit-equal to the plain
    walk, per-tile walk counts (chunks live, subs evaluated) equal to the
    plain walk's; both culling levels decide."""
    tri, phi_t = _cond_rays(cuda, rays)
    prep = _cond_prep(tri, phi_t, tile_rays, sub)
    hk, sk, hp, sp = _cond_walks(cuda, prep)
    assert all(torch.equal(a, b) for a, b in zip(hk, hp))
    assert torch.equal(sk, sp)
    live, evaluated = (int(x) for x in sp.sum(dim=0))
    assert int((hp[1] >= 0).sum()) > 100
    assert live < sp.shape[0] * prep[2].shape[0]
    if sub < mt_shade.CHUNK_TRIS:
        assert evaluated < live * (mt_shade.CHUNK_TRIS // sub)


@pytest.mark.cuda
def test_cond_walk_repeats_on_bounce_rays(cuda):
    """The cond walk, launched 300 times on first-bounce rays of the
    default scene at 512 x 512 (parked lanes, prefetched chunks that a
    re-test drops), returns the plain walk's hits and counts every time."""
    tri, phi_t = _bounce_rays(cuda, size=512)
    prep = mt_shade._prepare_cond(tri, phi_t, None, 64)
    _, _, hp, sp = _cond_walks(cuda, prep)
    table = mt_shade._pack_walk_table(prep[1], 64)
    differ = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(300):
        sk = torch.zeros_like(sp)
        hk = mt_shade._walk_cond_table_cuda(prep[0], table, *prep[2:], stats=sk)
        differ += sum((a != b).sum() for a, b in zip(hk, hp)) + (sk != sp).sum()
    torch.cuda.synchronize()
    assert int(differ) == 0
    assert int(sp[:, 1].sum()) > 0


@pytest.mark.cuda
def test_walk_count_check_catches_a_dropped_cond_mask_reformation(cuda, tmp_path, monkeypatch):
    """Mutation check of the cond walk's decisions by mask: a copy of the
    kernels that does not form the chunk and sub masks again after an
    evaluated sub (blocks stay live under the t they were first tested
    against) still finds the same hits, but evaluates more subs than the
    plain walk, and the walk-count check sees it."""
    tri, phi_t = _cond_rays(cuda, "primary")
    sp = mt_shade.cond_walk_stats(tri, phi_t, sub=32, plain=True)
    assert torch.equal(mt_shade.cond_walk_stats(tri, phi_t, sub=32), sp)
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    walk = src / "cond_walk.cu"
    text = walk.read_text()
    reform = "retest(subs, kGroup) << 16 | retest(chunks, 0)"
    assert text.count(reform) == 1
    walk.write_text(text.replace(reform, "subs << 16 | chunks"))
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "_cache_dir", tmp_path / "build")
    _build.load.cache_clear()
    try:
        bad = mt_shade.cond_walk_stats(tri, phi_t, sub=32)
        hits = mt_shade.mt_intersect_cond_phi(tri, phi_t, sub=32)
    finally:
        _build.load.cache_clear()  # the next load() builds from the package's sources
    print(f"plain walk counts {sp.sum(dim=0).tolist()}, mutant {bad.sum(dim=0).tolist()}")
    assert all(torch.equal(a, b) for a, b in
               zip(hits, mt_shade.mt_intersect_cond_phi_plain(tri, phi_t, sub=32)))
    assert not torch.equal(bad, sp)
    assert int(bad[:, 1].sum()) > int(sp[:, 1].sum())


# --- the Hopper list walk (csrc/nf_walk.cu) and MXU walks (csrc/mxu_walk.cu)


def _list_walks(cuda, prep):
    """(kernel hits, kernel walk counts, plain hits, plain walk counts) of
    the list walk on `_prepare_list`'s inputs."""
    sk = torch.zeros((prep[2].shape[0],), dtype=torch.int32, device=cuda)
    sp = torch.zeros_like(sk)
    hk = mt_shade._walk_list_cuda(*prep, stats=sk)
    hp = mt_shade._walk_list_plain(*prep, stats=sp)
    torch.cuda.synchronize()
    return hk, sk, hp, sp


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rays", WALK_WIDTHS)
@pytest.mark.parametrize("kind", ["soup", "mesh"])
@pytest.mark.parametrize("sub", [8, 32, 128])
def test_list_walk_matches_plain(cuda, kind, sub, tile_rays, monkeypatch):
    """The Hopper list walk (csrc/nf_walk.cu, no bound) at every tile width
    the wrappers give and widths that split unevenly over its CTAs: hits
    bit-equal to `_walk_list_plain`, every listed sub walked (walk counts
    equal to the list lengths)."""
    _any_tile(monkeypatch)
    tri, phi_t, _ = _walk_inputs(cuda, kind, stream=False)
    prep = mt_shade._prepare_list(tri, phi_t, tile_rays, sub)
    assert prep[-1] == tile_rays
    hk, sk, hp, sp = _list_walks(cuda, prep)
    assert all(torch.equal(a, b) for a, b in zip(hk, hp))
    assert torch.equal(sk, sp) and torch.equal(sk, prep[2])
    assert int((hp[1] >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [16, 64])
def test_list_walk_matches_plain_on_bounce_rays(cuda, sub):
    """The list walk on the default scene's first-bounce rays at 512 x 512
    (parked lanes start at t = INF and never hit), launched 100 times:
    the plain walk's hits and walk counts every time."""
    tri, phi_t = _bounce_rays(cuda, size=512)
    prep = mt_shade._prepare_list(tri, phi_t, None, sub)
    _, _, hp, sp = _list_walks(cuda, prep)
    table = mt_shade._pack_walk_table(prep[1], sub)
    differ = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(100):
        sk = torch.zeros_like(sp)
        hk = mt_shade._list_launch("mt_list", prep[0], table, *prep[2:4], None, prep[-1], sk)
        differ += sum((a != b).sum() for a, b in zip(hk, hp)) + (sk != sp).sum()
    torch.cuda.synchronize()
    assert int(differ) == 0 and int(sp.sum()) > 0


MXU_WIDTHS = [128, 200, 333, 512, 1024, 4096, 8192]


def _mxu_walk(cuda, cull, tri, phi_t, tile_rays, sub):
    """The MXU walk of `cull` and its plain version on the same prepared
    inputs at any tile width: (kernel hits, plain hits, kernel walk counts,
    plain walk counts or None for list, the tile width)."""
    prepare = {"nf": mt_shade._prepare, "list": mt_shade._prepare_list,
               "cond": lambda tri, phi, tile, sub: _cond_prep(tri, phi, tile, sub)}[cull]
    prep = prepare(tri, phi_t, tile_rays, sub)
    table = mt_shade._pack_mxu_table(prep[1], sub)
    _, walk_p, walk_k = mt_shade._MXU_WALKS[cull]
    n_tiles = prep[0].shape[1] // prep[-1]
    shape = (n_tiles, 2) if cull == "cond" else (n_tiles,)
    sk = torch.zeros(shape, dtype=torch.int32, device=cuda)
    sp = torch.zeros_like(sk)
    hk = walk_k(prep[0], table, *prep[2:], mxu=True, stats=sk)
    with mt_shade._full_fp32():
        hp = walk_p(*prep, mxu=True, stats=sp)
    torch.cuda.synchronize()
    return hk, hp, sk, sp, prep[-1]


def _as_hit(walk_out, r):
    t, idx, u, v = (x[:r] for x in walk_out)
    return mt_shade.Hit(idx >= 0, t, idx, u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rays", MXU_WIDTHS)
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
@pytest.mark.parametrize("kind", ["soup", "mesh"])
def test_mxu_walk_agrees_at_every_tile_width(cuda, kind, cull, tile_rays, monkeypatch):
    """Each MXU walk of csrc/mxu_walk.cu (sub 64) at every tile width it
    places, widths that split unevenly over its CTAs and m-tiles included
    (cond's 8,192 over a cluster of 16): it agrees with its
    plain version by `hit_agreement`'s rule, parked lanes never hit,
    nothing is NaN, and its walk counts are within 1% of the plain walk's
    (list: equal)."""
    _any_tile(monkeypatch)
    tri, phi_t, park = _walk_inputs(cuda, kind, stream=False)
    hk, hp, sk, sp, tile = _mxu_walk(cuda, cull, tri, phi_t, tile_rays, 64)
    assert tile == tile_rays
    r = phi_t.shape[1]
    for x in (hk[0], hk[2], hk[3]):
        assert not torch.isnan(x).any()
    _assert_mxu_agrees(tri, phi_t, _as_hit(hk, r), _as_hit(hp, r), f"{cull} {tile_rays}")
    if park is not None:
        assert (hk[1][:r][park] == -1).all()
    if cull == "cond":
        _assert_walk_counts_close(sk, sp)
    elif cull == "nf":
        _assert_walk_counts_close(sk[:, None].expand(-1, 2), sp[:, None].expand(-1, 2))
    else:
        assert torch.equal(sk, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("rays", ["primary", "bounce"])
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
def test_mxu_walk_agrees_with_plain_and_fp32(cuda, cull, rays, sub):
    """Each MXU walk on the default scene's camera and first-bounce rays at
    every sub: `hit_agreement` against its plain version and against the
    FP32 Hopper walk, floor lanes at most 0.3%; nf's and cond's walk
    counts within 1% of the plain walk's."""
    tri, phi_t = _cond_rays(cuda, rays)
    hk, hp, sk, sp, _ = _mxu_walk(cuda, cull, tri, phi_t, 512, sub)
    r = phi_t.shape[1]
    hf = mt_shade._ROUTES[cull, False][0](tri, phi_t, sub=sub)
    _assert_mxu_agrees(tri, phi_t, _as_hit(hk, r), _as_hit(hp, r), "plain")
    _assert_mxu_agrees(tri, phi_t, _as_hit(hk, r), hf, "fp32")
    if cull == "list":
        assert torch.equal(sk, sp)
    else:
        pairs = (sk, sp) if cull == "cond" else (sk[:, None].expand(-1, 2),
                                                 sp[:, None].expand(-1, 2))
        _assert_walk_counts_close(*pairs)


@pytest.mark.cuda
@pytest.mark.parametrize("cull", ["nf", "cond"])
def test_mxu_walk_stats_entry_points(cuda, cull):
    """`nf_walk_stats(mxu=True)` and `cond_walk_stats(mxu=True)` launch the
    MXU walks and come within 1% of tiles of their plain versions' counts
    on the default scene's camera rays."""
    tri, phi_t = _cond_rays(cuda, "primary")
    fn = mt_shade.nf_walk_stats if cull == "nf" else mt_shade.cond_walk_stats
    sk = fn(tri, phi_t, mxu=True)
    sp = fn(tri, phi_t, mxu=True, plain=True)
    if cull == "nf":
        sk, sp = sk[:, None].expand(-1, 2), sp[:, None].expand(-1, 2)
    _assert_walk_counts_close(sk, sp)
    assert int(sk[:, -1].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
def test_mxu_walk_repeats_on_bounce_rays(cuda, cull):
    """Each MXU walk, launched 100 times on first-bounce rays of the
    default scene at 512 x 512, returns the same hits and walk counts
    every time (its staging reuses each buffer hundreds of times a
    launch)."""
    tri, phi_t = _bounce_rays(cuda, size=512)
    prepare, _, walk = mt_shade._MXU_WALKS[cull]
    prep = mt_shade._mma_prepare(prepare)(tri, phi_t, None, 64)
    n_tiles = prep[0].shape[1] // prep[-1]
    shape = (n_tiles, 2) if cull == "cond" else (n_tiles,)
    s0 = torch.zeros(shape, dtype=torch.int32, device=cuda)
    h0 = walk(*prep, mxu=True, stats=s0)
    differ = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(100):
        sk = torch.zeros_like(s0)
        hk = walk(*prep, mxu=True, stats=sk)
        differ += sum((a != b).sum() for a, b in zip(hk, h0)) + (sk != s0).sum()
    torch.cuda.synchronize()
    assert int(differ) == 0 and int(s0.sum()) > 0


def _precull_inputs(cuda, ms, n_rays, tile_rays, seed=0):
    """(boxes (ms, 8), ray features (10, R) padded to the tile, tile) for the
    precull kernel.  Boxes of random sizes around the scene, two of them
    dead padding boxes (`_dead_pad_boxes`) and two copies of box 1 (exact
    ties); each 512-ray run of rays coherent (one origin and a cone of
    directions), with parked lanes (rd = 0) at box centres, axes under
    EPSILON or exactly 0 from inside boxes, NaN lanes, and padding lanes
    (1e30) past n_rays.  `tile_rays` None: the wrappers' width
    (`_widened_tile`)."""
    rng = np.random.default_rng(seed + ms)
    centre = rng.uniform(-1, 1, (ms, 3))
    half = rng.uniform(0.02, 0.3, (ms, 3))
    boxes = np.concatenate([centre - half, centre + half, np.zeros((ms, 2))], axis=1)
    boxes[[5 % ms, 7 % ms]] = boxes[1]
    boxes[-2:, :3], boxes[-2:, 3:6] = 1e20, -1e20
    runs = -(-n_rays // 512)
    ro = np.repeat(rng.uniform(-1.5, 1.5, (runs, 3)), 512, axis=0)[:n_rays]
    rd = np.repeat(rng.normal(size=(runs, 3)), 512, axis=0)[:n_rays]
    rd = rd / np.linalg.norm(rd, axis=1, keepdims=True) + rng.normal(0, 0.3, (n_rays, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    idx = np.arange(n_rays)
    inside = centre[rng.integers(0, ms - 2, n_rays)]
    for every, value in ((7, None), (11, 3e-7), (13, 0.0)):
        pick = idx % every == 0
        ro[pick] = inside[pick]
        if value is None:
            rd[pick] = 0.0
        else:
            rd[pick, idx[pick] % 3] = value
    ro[idx % 997 == 3, 1] = np.nan
    rd[idx % 991 == 5, 2] = np.nan
    ro, rd = (torch.from_numpy(x.astype(np.float32)) for x in (ro, rd))
    phi_t = ray_features(ro, rd).T.contiguous()
    tile = mt_shade._widened_tile(tile_rays, n_rays)
    return (torch.from_numpy(boxes.astype(np.float32)).to(cuda),
            mt_shade._pad_rays(phi_t, tile).to(cuda), tile)


@pytest.mark.cuda
@pytest.mark.parametrize("ms", [32, 64, 128, 1024])
@pytest.mark.parametrize("n_rays,tile_rays,want_tile", [
    (262144, None, 512),      # a 512^2 frame: 512 tiles of 512 rays
    (300000, None, 1024),     # more than 512 tiles: the tile widens
    (40000 - 77, 384, 384),   # not a multiple of 65,536, a partial last tile
])
def test_precull_kernel_matches_plain_bit_for_bit(cuda, ms, n_rays, tile_rays, want_tile):
    """The precull kernel (csrc/precull.cu) against `_precull_live_subs_plain`
    on the same CUDA inputs: counts, lists and emins equal, one launch a
    call, and no fault."""
    boxes, phi, tile = _precull_inputs(cuda, ms, n_rays, tile_rays)
    assert tile == want_tile
    before = mt_shade._precull_live_subs.launches
    got = mt_shade._precull_live_subs(boxes, phi, tile)
    assert mt_shade._precull_live_subs.launches == before + 1
    want = mt_shade._precull_live_subs_plain(boxes, phi, tile)
    torch.cuda.synchronize()
    n_tiles = phi.shape[1] // tile
    for a, b, shape, dtype in zip(got, want, [(n_tiles,), (n_tiles, ms), (n_tiles, ms)],
                                  [torch.int32, torch.int32, torch.float32]):
        assert a.shape == shape and a.dtype == dtype and a.is_contiguous()
        assert torch.equal(a, b)
    counts, _, emins = got
    assert int(counts.min()) > 0
    assert int((emins[:, 1:] == emins[:, :-1]).sum()) > 0  # ties


@pytest.mark.cuda
def test_precull_kernel_repeats_and_counts_its_rays(cuda):
    """On the default scene's camera rays the kernel gives the same lists
    every time, and under a profiler it counts its rays in
    `walk.precull.rays` (the nf wrapper's lanes in `walk.lanes`)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch.utils import spans

    tri = tpt.default_scene().compile(device=cuda).packed.tri_pos
    phi_t = _camera_rays(cuda)
    with spans.span("between sessions"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        mt_shade.mt_intersect_nf_phi(tri, phi_t)
    got = spans.totals()
    assert got["walk.precull.rays"] == got["walk.lanes"] == phi_t.shape[1]
    prep = mt_shade._prepare(tri, phi_t, None)
    boxes = mt_shade.treelet_boxes(mt_shade._pad_scene(tri, 64)[0], 64)
    first = mt_shade._precull_live_subs(boxes, prep[0], prep[-1])
    differ = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(20):
        again = mt_shade._precull_live_subs(boxes, prep[0], prep[-1])
        differ += sum((a != b).sum() for a, b in zip(again, first))
    plain = mt_shade._precull_live_subs_plain(boxes, prep[0], prep[-1])
    torch.cuda.synchronize()
    assert int(differ) == 0
    assert all(torch.equal(a, b) for a, b in zip(first, plain))
    assert int(first[0].sum()) < first[1].numel()  # camera rays leave boxes dead
