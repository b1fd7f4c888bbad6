"""The round-2 Hopper walk's inputs and decisions on the CPU
(csrc/r2_walk.cu, behind `mt_intersect_pallas` and `mt_intersect_stream`
of tpu_pathtracer_torch/ops/kernels/mt_intersect.py).

  * the walk table `_pack_walk_table` packs from either round-2 layout
    holds `triangle_columns`' 19 nonzero coefficients in `FEATS` order;
  * the walk's order of decisions, re-enacted here one tile at a time in
    plain torch (chunks taken `R2_GROUP` at a time, the mask formed again
    after each evaluated chunk, the two staging buffers tracked as the
    kernel's `Stager` tracks them), gives the per-tile walk counts of the
    plain walk `_walk_plain`, both columns, on camera rays and on soups
    whose chunk count falls around a group boundary; a re-enactment that
    keeps its first mask evaluates more;
  * the copy rule (`walk_stats`) on a three-chunk scene whose counts are
    worked out below.

The kernel itself is held to the plain walk, walk counts included, in
tests/test_torch_cuda.py and chip_smoke.py, on a machine with a card; the
plain versions to the JAX kernels in tests/test_torch_r2.py."""

import numpy as np
import pytest
import torch

import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops.kernels import mt_intersect as r2
from tpu_pathtracer_torch.ops.mt_matmul import FEATS, determinants, nearest, triangle_columns
from tpu_pathtracer_torch.ops.vecmath import INF

G = r2.R2_GROUP


def _soup(n_tris, n_rays, seed):
    """A soup that culls: one big floor triangle at z = 0 in the first
    chunk, the other triangles small, in z in [-2, 2] sorted far side
    last; rays from z = 5 towards the floor, every 4th parked (origin 1e30,
    direction 0).  Chunks wholly below the floor die once a ray's t falls
    to it."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform([-1.5, -1.5, -2.0], [1.5, 1.5, 2.0], (n_tris, 3))
    e = rng.uniform(-0.3, 0.3, (n_tris, 2, 3))
    tri = np.concatenate([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)
    tri = tri[np.argsort(-v0[:, 2])]
    tri[0] = [-20, -20, 0, 20, -20, 0, 0, 20, 0]
    ro = np.tile([[0.0, 0.0, 5.0]], (n_rays, 1)) + rng.uniform(-0.5, 0.5, (n_rays, 3))
    rd = np.concatenate([rng.uniform(-0.2, 0.2, (n_rays, 2)), -np.ones((n_rays, 1))], axis=1)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    park = np.arange(n_rays) % 4 == 0
    ro[park], rd[park] = 1e30, 0.0
    return tuple(torch.from_numpy(x.astype(np.float32)) for x in (tri, ro, rd))


def _camera(n_rays=64 * 64 - 300):
    """Camera rays on the default scene, aimed at the red box's front face
    (z = 0.9): a 64 x 64 grid less its last 300 rays (a partial last
    tile)."""
    tri = tpt.default_scene().compile(device="cpu").packed.tri_pos
    xs, ys = np.meshgrid(np.linspace(-0.35, 0.35, 64), np.linspace(0.05, 0.75, 64))
    target = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 0.9)], axis=1)[:n_rays]
    ro = np.tile(np.float32([[0.0, 1.0, 4.0]]), (n_rays, 1))
    rd = (target - ro) / np.linalg.norm(target - ro, axis=1, keepdims=True)
    return tri, torch.from_numpy(ro), torch.from_numpy(rd.astype(np.float32))


def _reenact(tri, ro, rd, reform=True):
    """The Hopper walk's decisions, one tile at a time: per group of G
    chunks, the entries of every lane into the group's boxes; the chunks
    some lane enters before its t; then, taking the lowest, staging it
    (and prefetching the next candidate) in two buffers used in turn, and
    evaluating it, the mask formed again (`reform`) or kept.  Returns the
    (T, 2) counts [chunks evaluated, copies issued]."""
    phi_pad, _, boxes, chunk = r2._prepare(tri, ro, rd, True)
    n_chunks = boxes.shape[0]
    cols = triangle_columns(r2._pad_to(tri, n_chunks * chunk, 0))  # (10, 4, Np)
    counts = []
    for tile in range(phi_pad.shape[1] // r2.TILE_RAYS):
        phi = phi_pad[:, tile * r2.TILE_RAYS:(tile + 1) * r2.TILE_RAYS]
        par, inv = r2._slab_setup(phi[1:4], phi[4:7])
        t = torch.full((r2.TILE_RAYS,), float(INF))
        held, cur, evaluated, copies = [-1, -1], 1, 0, 0
        for g0 in range(0, n_chunks, G):
            entry = r2._slab_entries(boxes[g0:g0 + G], phi[1:4], phi[4:7], par, inv)
            mask = [g0 + k for k in range(entry.shape[0]) if (entry[k] < t).any()]
            while mask:
                c = mask.pop(0)
                cur ^= 1  # take c into the idle buffer, unless it holds c
                if held[cur] != c:
                    held[cur], copies = c, copies + 1
                if mask and held[cur ^ 1] != mask[0]:  # prefetch the next candidate
                    held[cur ^ 1], copies = mask[0], copies + 1
                evaluated += 1
                coef = cols[:, :, c * chunk:(c + 1) * chunk].permute(1, 2, 0)
                tt, _, _ = r2._epilogue_r2(*determinants(phi, coef))
                t = torch.minimum(t, nearest(tt, tt, tt, 0)[0])
                if reform:
                    mask = [k for k in mask if (entry[k - g0] < t).any()]
        counts.append([evaluated, copies])
    return torch.tensor(counts, dtype=torch.int32)


@pytest.mark.parametrize("stream", [False, True], ids=["pallas", "stream"])
@pytest.mark.parametrize("n_tris", [5, 300, 2100])
def test_walk_table_holds_the_round2_coefficients(stream, n_tris):
    """Quantity-major rows (one sub-block of Np) and chunk-major rows
    (sub-blocks of the chunk) pack to the same table: per triangle the
    coefficients of `triangle_columns` at FEATS, in that order, then a
    zero; every coefficient left out is zero."""
    tri, ro, rd = _soup(n_tris, 64, seed=n_tris)
    _, rows, boxes, chunk = r2._prepare(tri, ro, rd, stream)
    table = r2._r2_table(rows, chunk, stream)
    n_pad = boxes.shape[0] * chunk
    cols = triangle_columns(r2._pad_to(tri, n_pad, 0))  # (10, 4, Np)
    want = torch.cat([cols[list(ks), q].T for q, ks in enumerate(FEATS)], dim=1)
    assert table.shape == (n_pad, r2.WALK_TABLE_FLOATS) and want.shape == (n_pad, 19)
    assert torch.equal(table[:, :19], want) and (table[:, 19] == 0).all()
    for q, ks in enumerate(FEATS):
        rest = [k for k in range(10) if k not in ks]
        assert (cols[rest, q] == 0).all()
    other = r2._prepare(tri, ro, rd, not stream)
    assert torch.equal(r2._r2_table(other[1], chunk, not stream), table)


@pytest.mark.parametrize("case", ["camera", 1, G - 1, G, G + 1])
def test_group_mask_walk_counts_equal_the_plain_walk(case):
    """Per-tile walk counts of the re-enacted group-mask walk against the
    plain walk's, both columns: on camera rays on the default scene (16
    chunks, one group) and on soups of 1, G-1, G and G+1 chunks with
    parked rays.  The whole-scene entry counts the same."""
    if case == "camera":
        tri, ro, rd = _camera()
    else:
        tri, ro, rd = _soup(100 if case == 1 else case * r2.CHUNK_TRIS, 1500, seed=case)
    stats = r2.walk_stats(tri, ro, rd, stream=True)
    n_chunks = -(-tri.shape[0] // r2._chunk_tris(tri.shape[0]))
    assert n_chunks == (16 if case == "camera" else case)
    assert torch.equal(_reenact(tri, ro, rd), stats)
    assert 0 < int(stats[:, 0].sum()) and int(stats[:, 0].max()) < n_chunks or n_chunks == 1
    assert (stats[:, 1] >= stats[:, 0]).all()
    assert torch.equal(r2.walk_stats(tri, ro, rd, stream=False), stats)


@pytest.mark.parametrize("case", [G - 1, G + 1])
def test_walk_without_mask_reformation_evaluates_more(case):
    """The mutant that keeps each group's first mask (chunks stay live
    under the t they were first tested against) evaluates more chunks.
    (On the default scene's camera rays it does not: its box and floor,
    which hide the sphere, lie in the last chunk.)"""
    tri, ro, rd = _soup(case * r2.CHUNK_TRIS, 1500, seed=case)
    stats = r2.walk_stats(tri, ro, rd, stream=True)
    bad = _reenact(tri, ro, rd, reform=False)
    assert int(bad[:, 0].sum()) > int(stats[:, 0].sum())


def _three_chunks():
    """Three chunks of 128 copies of one triangle each: T0 at z = 3 over
    x, y in [-2, 2]; T1 at z = 1 over x in [3, 7], y in [-2, 2]; T2 at
    z = 0, a large triangle under both.  Three tiles of 1,024 rays from
    z = 5 straight down (-z), on a 32 x 32 grid:
      A, x and y in [-0.5, 0.5]: boxes 0 (entry 2) and 2 (entry 5);
      B, x in [4.5, 5.5], y in [-0.5, 0.5]: boxes 1 (entry 4) and 2,
         hitting T1;
      C, x in [3.3, 3.7], y in [1.3, 1.7]: boxes 1 and 2, missing T1."""
    tris = [[-2, -2, 3, 2, -2, 3, 0, 2, 3], [3, -2, 1, 7, -2, 1, 5, 2, 1],
            [-3, -3, 0, 9, -3, 0, 3, 8, 0]]
    tri = torch.tensor(np.repeat(tris, 128, axis=0), dtype=torch.float32)
    grid = np.stack(np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32)), -1).reshape(-1, 2)
    xy = np.concatenate([grid + [-0.5, -0.5], grid + [4.5, -0.5], grid * 0.4 + [3.3, 1.3]])
    ro = torch.tensor(np.concatenate([xy, np.full((3072, 1), 5.0)], axis=1), dtype=torch.float32)
    rd = torch.tensor([[0.0, 0.0, -1.0]]).expand(3072, 3).contiguous()
    return tri, ro, rd


def test_copy_rules_on_three_chunks():
    """Worked counts, [chunks evaluated, chunks copied] per tile, the same
    for both entries: A takes chunk 0 (a copy) and prefetches 2, the next
    chunk of its mask (a copy), which dies at t = 2: [1, 2].  B takes 1 and
    prefetches 2, which dies at t = 4: [1, 2].  C takes 1 and prefetches 2,
    which stays live (T1 missed) and is taken from the prefetch: [2, 2]."""
    tri, ro, rd = _three_chunks()
    hit = r2.mt_intersect_stream(tri, ro, rd)
    assert hit.hit.all()
    for tile, (t, i) in enumerate(((2.0, 0), (4.0, 128), (5.0, 256))):
        rays = slice(tile * 1024, (tile + 1) * 1024)
        assert (hit.t[rays] == t).all() and (hit.tri[rays] == i).all()
    want = [[1, 2], [1, 2], [2, 2]]
    for stream in (True, False):
        got = r2.walk_stats(tri, ro, rd, stream=stream)
        assert got.tolist() == want, stream
    assert torch.equal(_reenact(tri, ro, rd), torch.tensor(want, dtype=torch.int32))
