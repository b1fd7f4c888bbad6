"""Port parity: the round-2 MT kernels' plain versions
(`mt_intersect_pallas`, `mt_intersect_stream` of
tpu_pathtracer_torch/ops/kernels/mt_intersect.py).

The JAX side runs `_kernel` and `_kernel_stream` of
tpu_pathtracer/ops/pallas/mt_intersect.py in interpret mode, on the inputs
of tests/test_mt_matmul.py::test_mt_pallas_interpret_parity (200
triangles, 300 rays) and ::test_mt_stream_interpret_parity (700, 1,300),
with every 4th ray parked (origin 1e30, direction 0) as the trace loop
parks finished rays.  Hits are held to `assert_hit_parity` (equal hit
masks and triangles, t within rtol 5e-5, u/v within rtol 1e-3); miss lanes
must report t = INF and triangle -1.  The CUDA kernels are compared with
these plain versions bit for bit, walk counts included, in
tests/test_torch_cuda.py and chip_smoke.py, on a machine with a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops.pallas import mt_intersect as jr2
from tpu_pathtracer.scene.envmap import gradient_sky as j_gradient_sky
import tpu_pathtracer as jpt
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops.kernels import mt_intersect, mt_shade, mt_stream
from tpu_pathtracer_torch.ops.vecmath import INF
from tpu_pathtracer_torch.scene.envmap import gradient_sky
from test_mt_matmul import random_rays, random_tri_pos
from test_torch_cull import assert_hit_parity

KERNELS = {
    "pallas": (jr2.mt_intersect_pallas, mt_intersect.mt_intersect_pallas),
    "stream": (jr2.mt_intersect_stream, mt_intersect.mt_intersect_stream),
}


def _inputs(seed, n_tris, n_rays, park_every=4):
    rng = np.random.default_rng(seed)
    tri = np.array(random_tri_pos(rng, n_tris))
    ro, rd = (np.asarray(x).copy() for x in random_rays(rng, n_rays))
    park = np.arange(n_rays) % park_every == 0
    ro[park], rd[park] = np.float32(1e30), np.float32(0.0)
    return tri, ro, rd, park


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("seed,n_tris,n_rays", [(21, 200, 300), (17, 700, 1300)],
                         ids=["pallas_inputs", "stream_inputs"])
def test_r2_plain_matches_pallas_interpret(kernel, seed, n_tris, n_rays):
    tri, ro, rd, park = _inputs(seed, n_tris, n_rays)
    jfn, tfn = KERNELS[kernel]
    ha = jfn(jnp.asarray(tri), jnp.asarray(ro), jnp.asarray(rd), interpret=True)
    hb = tfn(*(torch.from_numpy(x) for x in (tri, ro, rd)))
    assert_hit_parity(ha, hb, min_hits=30)
    miss = ~hb.hit.numpy()
    assert park.sum() > 0 and miss[park].all()
    assert (hb.t.numpy()[miss] == INF).all() and (hb.tri.numpy()[miss] == -1).all()


def test_r2_pallas_and_stream_plain_agree_bit_for_bit():
    """The two walks differ only in the table layout, so on the same inputs
    every output and every walk count (chunks evaluated, chunks copied)
    agree, and each copies at least the chunks it evaluates."""
    tri, ro, rd = (torch.from_numpy(x) for x in _inputs(5, 2100, 2500)[:3])
    hp = mt_intersect.mt_intersect_pallas(tri, ro, rd)
    hs = mt_intersect.mt_intersect_stream(tri, ro, rd)
    assert int(hp.hit.sum()) > 100
    for a, b in zip(hp, hs):
        assert torch.equal(a, b)
    sp = mt_intersect.walk_stats(tri, ro, rd, stream=False)
    ss = mt_intersect.walk_stats(tri, ro, rd, stream=True)
    assert torch.equal(sp[:, 0], ss[:, 0]) and torch.equal(sp, ss)
    assert (ss[:, 1] >= ss[:, 0]).all()


@pytest.mark.parametrize("n_tris", [5, 61, 130])
def test_r2_chunk_rule_and_padding_match_jax(n_tris):
    """min(128, max(8, ceil(N/8)*8))-triangle chunks and 1,024-ray tiles:
    a small scene takes a small chunk, the last chunk and tile pad."""
    tri, ro, rd, _ = _inputs(n_tris, n_tris, 1100)
    phi_pad, rows, boxes, chunk = mt_intersect._prepare(
        *(torch.from_numpy(x) for x in (tri, ro, rd)), stream=True)
    assert chunk == min(128, max(8, -(-n_tris // 8) * 8)) and phi_pad.shape == (10, 2048)
    assert (phi_pad[:, 1100:] == 1e30).all() and boxes.shape == (-(-n_tris // chunk), 8)
    tri_p = jr2._pad_to(jnp.asarray(tri), boxes.shape[0] * chunk, 0)
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(jr2.treelet_boxes(tri_p, chunk)))
    for kernel in sorted(KERNELS):
        jfn, tfn = KERNELS[kernel]
        ha = jfn(jnp.asarray(tri), jnp.asarray(ro), jnp.asarray(rd), interpret=True)
        assert_hit_parity(ha, tfn(*(torch.from_numpy(x) for x in (tri, ro, rd))), min_hits=1)


def test_r2_walk_stats_on_a_mesh():
    """Camera rays on the BVH-ordered default scene: chunks are culled
    (fewer evaluated than tiles x chunks), each walk copies at least what
    it evaluates; an all-parked tile evaluates and copies nothing.  (The
    copy rule chunk by chunk is held in tests/test_torch_r2_walk.py.)"""
    data = tpt.default_scene().compile(device="cpu")
    tri = data.packed.tri_pos
    xs, ys = np.meshgrid(np.linspace(-0.4, 0.4, 64), np.linspace(-0.3, 0.5, 32))
    target = np.stack([xs.ravel(), ys.ravel() + 0.5, np.zeros(xs.size)], axis=1)
    ro = np.tile(np.float32([[0.0, 1.0, 4.0]]), (3072, 1))
    d = np.concatenate([target - ro[:2048], np.zeros((1024, 3))]).astype(np.float32)
    rd = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30).astype(np.float32)
    ro[2048:] = np.float32(1e30)
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd.astype(np.float32))
    for stream in (False, True):
        stats = mt_intersect.walk_stats(tri, ro, rd, stream=stream)
        assert stats.shape == (3, 2) and stats.dtype == torch.int32
        assert (stats[2] == 0).all()
        assert 0 < int(stats[:2, 0].min()) and int(stats[:2, 0].max()) < 16
        assert (stats[:, 1] >= stats[:, 0]).all()
    assert int(mt_intersect.mt_intersect_stream(tri, ro, rd).hit.sum()) > 1000


def test_r2_empty_and_oversized_scenes_match_jax():
    ro = torch.zeros((64, 3))
    rd = torch.ones((64, 3))
    for kernel, cap in (("pallas", 8192), ("stream", 131072)):
        jfn, tfn = KERNELS[kernel]
        h = tfn(torch.zeros((0, 9)), ro, rd)
        assert not h.hit.any() and (h.tri == -1).all() and (h.t == INF).all()
        with pytest.raises(ValueError) as want:
            jfn(jnp.zeros((cap + 1, 9)), jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()))
        with pytest.raises(ValueError) as got:
            tfn(torch.zeros((cap + 1, 9)), ro, rd)
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError):
        mt_intersect.mt_intersect_pallas(torch.zeros((8, 9), device="meta"),
                                         torch.zeros((8, 3), device="meta"),
                                         torch.zeros((8, 3), device="meta"))


def test_shared_helpers_live_in_mt_intersect():
    """As in the JAX package, `treelet_boxes` and `_pad_to` belong to the
    round-2 module and the other kernel modules re-export them."""
    for mod in (mt_shade, mt_stream):
        assert mod.treelet_boxes is mt_intersect.treelet_boxes
        assert mod._pad_to is mt_intersect._pad_to
        assert mod._slab_entries is mt_intersect._slab_entries
    tri = torch.from_numpy(np.array(random_tri_pos(np.random.default_rng(1), 300)))
    np.testing.assert_array_equal(
        mt_intersect.treelet_boxes(mt_intersect._pad_to(tri, 384, 0)).numpy(),
        np.asarray(jr2.treelet_boxes(jr2._pad_to(jnp.asarray(tri.numpy()), 384, 0))))


def test_r2_hits_match_nf_on_the_default_scene():
    """Against the near-to-far kernel's plain version: on camera rays the
    two epilogues pick the same triangles (they may differ only on
    borderline t, which these rays do not meet)."""
    data = tpt.default_scene(gradient_sky(8, 16)).compile(device="cpu")
    jdata = jpt.default_scene(j_gradient_sky(8, 16)).compile()
    rng = np.random.default_rng(2)
    target = rng.uniform([-1.5, 0.0, -1.0], [1.5, 1.2, 1.0], (2000, 3))
    ro = np.tile(np.float32([[0.0, 1.0, 4.0]]), (2000, 1))
    rd = (target - ro) / np.linalg.norm(target - ro, axis=1, keepdims=True)
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd.astype(np.float32))
    h = mt_intersect.mt_intersect_pallas(data.packed.tri_pos, ro, rd)
    hn = mt_shade.mt_intersect_pallas2(data.packed.tri_pos, ro, rd)
    assert int(h.hit.sum()) > 500
    assert torch.equal(h.hit, hn.hit) and torch.equal(h.tri, hn.tri)
    ha = jr2.mt_intersect_pallas(jdata.packed.tri_pos, jnp.asarray(ro.numpy()),
                                 jnp.asarray(rd.numpy()), interpret=True)
    assert_hit_parity(ha, h, min_hits=500)
