"""Port parity: the MT oracle and the near-to-far MT kernel's plain version.

Random triangle soups and rays, made with numpy, go through the JAX XLA
oracle (`mt_intersect`), the JAX Pallas kernel in interpret mode
(`mt_intersect_pallas2_phi`, cull='nf', sub=64) and the port.  Tolerances are
`tests/test_mt_shade.py::assert_hit_parity`'s: equal hit masks and
triangles, t within rtol 5e-5, u/v within rtol 1e-3.  The CUDA kernel
itself is compared with the plain version in tests/test_torch_cuda.py and
chip_smoke.py, on a machine with a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops.mt_matmul import mt_intersect as j_mt_intersect
from tpu_pathtracer.ops.mt_matmul import ray_features as j_ray_features
from tpu_pathtracer.ops.mt_matmul import triangle_columns as j_triangle_columns
from tpu_pathtracer.ops.pallas.mt_intersect import _pad_to as j_pad_to
from tpu_pathtracer.ops.pallas.mt_intersect import treelet_boxes as j_treelet_boxes
from tpu_pathtracer.ops.pallas.mt_shade import _dead_pad_boxes as j_dead_pad_boxes
from tpu_pathtracer.ops.pallas.mt_shade import _pack_subblock_major as j_pack
from tpu_pathtracer.ops.pallas.mt_shade import _precull_live_subs as j_precull
from tpu_pathtracer.ops.pallas.mt_shade import mt_intersect_pallas2_phi
from tpu_pathtracer_torch.ops.kernels import mt_shade
from tpu_pathtracer_torch.ops.mt_matmul import mt_intersect, ray_features, triangle_columns


def random_soup(rng, n, spread=0.2):
    v0 = rng.uniform(-1, 1, (n, 3))
    e = rng.uniform(-spread, spread, (n, 2, 3))
    return np.concatenate([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1).astype(np.float32)


def random_rays(rng, r, park_every=0):
    ro = rng.uniform(-1, 1, (r, 3)).astype(np.float32)
    rd = rng.normal(size=(r, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    if park_every:
        park = (np.arange(r) % park_every == 0)[:, None]
        ro = np.where(park, np.float32(1e30), ro).astype(np.float32)
        rd = np.where(park, np.float32(0.0), rd).astype(np.float32)
    return ro, rd


def assert_hit_parity(ha, hb, min_hits=50):
    """ha: JAX Hit; hb: port Hit (torch)."""
    hb = [x.numpy() for x in hb]
    np.testing.assert_array_equal(hb[0], np.asarray(ha.hit))
    m = np.asarray(ha.hit)
    assert m.sum() >= min_hits
    np.testing.assert_array_equal(hb[2][m], np.asarray(ha.tri)[m])
    np.testing.assert_allclose(hb[1][m], np.asarray(ha.t)[m], rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(hb[3][m], np.asarray(ha.u)[m], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(hb[4][m], np.asarray(ha.v)[m], rtol=1e-3, atol=1e-4)


def _port_nf(tri, ro, rd):
    phi_t = ray_features(torch.from_numpy(ro), torch.from_numpy(rd)).T.contiguous()
    return mt_shade.mt_intersect_nf_phi(torch.from_numpy(tri), phi_t)


def test_oracle_matches_jax_mt_intersect():
    rng = np.random.default_rng(5)
    tri = random_soup(rng, 700)
    ro, rd = random_rays(rng, 1300)
    ha = j_mt_intersect(jnp.asarray(tri), jnp.asarray(ro), jnp.asarray(rd))
    hb = mt_intersect(torch.from_numpy(tri), torch.from_numpy(ro), torch.from_numpy(rd),
                      chunk=256, ray_chunk=512)
    assert_hit_parity(ha, hb)


def test_triangle_columns_and_packing_match_jax():
    tri = random_soup(np.random.default_rng(1), 256)
    jc = j_triangle_columns(jnp.asarray(tri))
    tc = triangle_columns(torch.from_numpy(tri))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(mt_shade._pack_subblock_major(tc, 64).numpy(),
                                  np.asarray(j_pack(jnp.asarray(tc.numpy()), 64)))
    np.testing.assert_array_equal(mt_shade.treelet_boxes(torch.from_numpy(tri), 64).numpy(),
                                  np.asarray(j_treelet_boxes(jnp.asarray(tri), 64)))


@pytest.mark.parametrize("n_tris,n_rays,park_every,seed", [
    (700, 1300, 0, 5),   # unaligned counts: triangle and ray padding
    (300, 600, 3, 6),    # parked rays interleaved
    (500, 900, 4, 11),   # the cull-mode soup of tests/test_mt_shade.py
])
def test_nf_plain_matches_pallas_interpret(n_tris, n_rays, park_every, seed):
    rng = np.random.default_rng(seed)
    tri = random_soup(rng, n_tris)
    ro, rd = random_rays(rng, n_rays, park_every)
    phi_t = j_ray_features(jnp.asarray(ro), jnp.asarray(rd)).T
    ha = mt_intersect_pallas2_phi(jnp.asarray(tri), phi_t, interpret=True, cull="nf",
                                  sub=64, tile_rays=512)
    hb = _port_nf(tri, ro, rd)
    if park_every:
        assert not hb.hit.numpy()[::park_every].any()
    assert_hit_parity(ha, hb, min_hits=30)
    # and the oracle agrees on the same inputs
    assert_hit_parity(j_mt_intersect(jnp.asarray(tri), jnp.asarray(ro), jnp.asarray(rd)),
                      hb, min_hits=30)


def test_nf_plain_empty_scene_misses():
    ro, rd = random_rays(np.random.default_rng(7), 64)
    h = _port_nf(np.zeros((0, 9), np.float32), ro, rd)
    assert not h.hit.any() and (h.tri == -1).all()


def precull_edge_rays(rng, r, boxes):
    """Rays for the precull's edge cases, (10, r) features: every 7th parked
    (rd = 0) with its origin at a box's centre; every 11th with one axis
    under EPSILON and every 13th with one axis exactly 0, aimed from inside
    a box; the rest from random origins, some inside boxes."""
    ro, rd = random_rays(rng, r)
    idx = np.arange(r)
    centres = (boxes[:, :3] + boxes[:, 3:6]) / 2
    live = np.nonzero(boxes[:, 0] <= boxes[:, 3])[0]
    inside = centres[rng.choice(live, r)].astype(np.float32)
    for every, value in ((7, None), (11, np.float32(3e-7)), (13, np.float32(0.0))):
        pick = idx % every == 0
        ro[pick] = inside[pick]
        if value is None:
            rd[pick] = 0.0
        else:
            rd[pick, idx[pick] % 3] = value
    return np.array(j_ray_features(jnp.asarray(ro), jnp.asarray(rd))).T  # (10, R)


def precull_case(case):
    """(boxes (Ms, 8), padded ray features (10, R), tile_rays) of a precull
    test case.  `_dead_pad_boxes`' impossible box is entered by every ray
    with no parallel axis (its slabs swap ends): entry -INF, as in JAX."""
    rng = np.random.default_rng(9)
    if case == "soup":
        tri = random_soup(rng, 500)
        ro, rd = random_rays(rng, 1024, park_every=5)
        phi = np.asarray(j_ray_features(jnp.asarray(ro), jnp.asarray(rd))).T
        tri_p = np.asarray(j_pad_to(jnp.asarray(tri), 512, 0))
        return np.asarray(j_treelet_boxes(jnp.asarray(tri_p), 64)), phi, 256
    if case == "edges":  # dead padding boxes, duplicate boxes (exact ties), padding lanes
        tri = random_soup(rng, 300)
        tri_p = np.asarray(j_pad_to(jnp.asarray(tri), 512, 0))
        boxes = np.asarray(j_dead_pad_boxes(j_treelet_boxes(jnp.asarray(tri_p), 32), 300, 32))
        boxes = np.concatenate([boxes, boxes[[3, 0, 3, 9]]])  # 20 boxes, ties with 0, 3, 9
        phi = precull_edge_rays(rng, 1000, boxes)
        centre = (boxes[2, :3] + boxes[2, 3:6]) / 2
        phi[:, 768:] = 0.0  # the last tile: rays parked at one point, then padding lanes
        phi[0, 768:], phi[1:4, 768:] = 1.0, centre[:, None]
        return boxes, np.asarray(j_pad_to(jnp.asarray(phi), 1152, 1, value=1e30)), 384
    # "wide": Ms = 1,024 (sub 8 on 8,192 triangles, 8 a cell of a 16 x 8 x 8
    # grid), 128-ray tiles
    cells = np.stack(np.meshgrid(*(np.linspace(-1, 1, n) for n in (16, 8, 8)),
                                 indexing="ij"), axis=-1).reshape(-1, 1, 3)
    v = cells + rng.uniform(-0.06, 0.06, (1024, 8 * 3, 3))
    tri = v.reshape(8192, 9).astype(np.float32)
    boxes = np.asarray(j_treelet_boxes(jnp.asarray(tri), 8))
    return boxes, precull_edge_rays(rng, 512, boxes), 128


def assert_precull_matches_jax(got, boxes, phi, tile_rays):
    """The port's (counts, lists, emins) against the JAX precull: equal
    counts and live entry distances, and each tile's live list in JAX's
    order, equal distances taken in index order (the port's sort is
    stable; JAX's need not be)."""
    jc, jl, je = (np.asarray(x) for x in j_precull(jnp.asarray(boxes), jnp.asarray(phi), tile_rays))
    tc, tl, te = (x.numpy() for x in got)
    np.testing.assert_array_equal(tc, jc[:, 0])
    assert tc.sum() > 0
    for t in range(tc.shape[0]):
        c = tc[t]
        order = np.lexsort((jl[t, :c], je[t, :c]))
        np.testing.assert_array_equal(tl[t, :c], jl[t, :c][order])
        np.testing.assert_array_equal(te[t, :c], je[t, :c])
    return tc, tl, te


@pytest.mark.parametrize("case", ["soup", "edges", "wide"])
def test_precull_live_sets_match_jax(case):
    boxes, phi, tile_rays = precull_case(case)
    got = mt_shade._precull_live_subs(torch.from_numpy(boxes.copy()),
                                      torch.from_numpy(phi.copy()), tile_rays)
    tc, tl, te = assert_precull_matches_jax(got, boxes, phi, tile_rays)
    n_tiles, ms = phi.shape[1] // tile_rays, boxes.shape[0]
    assert tl.shape == te.shape == (n_tiles, ms) and tl.dtype == np.int32
    # past counts: the dead boxes at INF, in index order
    for t in range(tc.shape[0]):
        assert (te[t, tc[t]:] == np.float32(1e20)).all()
        assert (np.diff(tl[t, tc[t]:]) > 0).all()
    if case == "edges":
        assert (tc < boxes.shape[0]).any()  # some tile leaves boxes dead
        ties = [(te[t, :tc[t]][1:] == te[t, :tc[t]][:-1]).sum() for t in range(tc.shape[0])]
        assert sum(ties) > 0


def test_tile_widening_and_padding_contract():
    rng = np.random.default_rng(12)
    tri = random_soup(rng, 130)  # pads to 256 rows, 4 subs
    ro, rd = random_rays(rng, 1000)
    phi_t = ray_features(torch.from_numpy(ro), torch.from_numpy(rd)).T.contiguous()
    phi_pad, cols_rows, counts, lists, emins, tile_rays = mt_shade._prepare(
        torch.from_numpy(tri), phi_t, 128)
    assert tile_rays == 128 and phi_pad.shape == (10, 1024) and cols_rows.shape == (1024, 10)
    assert (phi_pad[:, 1000:] == np.float32(1e30)).all()
    assert lists.shape == (8, 4) and counts.shape == (8,)
    with pytest.raises(ValueError):
        mt_shade._tile_rays(100)
    # more than 512 tiles widen the tile
    big = torch.zeros((10, 512 * 128 + 1))
    assert mt_shade._prepare(torch.from_numpy(tri), big, 128)[-1] == 256


def test_oversized_scene_raises():
    """As the JAX wrapper: past 8,192 triangles the near-to-far kernel
    refuses the scene with ValueError and names the streamed kernel."""
    tri = torch.zeros((8193, 9))
    with pytest.raises(ValueError, match="mt_stream"):
        mt_shade.mt_intersect_nf_phi(tri, torch.zeros((10, 8)))

