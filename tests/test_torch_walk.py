"""The Hopper walks' inputs and walk counts on the CPU: the packed walk
table (`mt_shade._pack_walk_table`, read by csrc/nf_walk.cu,
csrc/cond_walk.cu and csrc/stream_walk.cu) and the near-to-far and list
walks' per-tile counts (`mt_shade.nf_walk_stats`, `_walk_list_plain`'s
`stats`, and with `mxu=True` those of the MXU nf walk).

The table is read back here by a plain evaluation in torch, which must
give the determinants of `determinants` on the sub-block-major rows bit
for bit: the kernels sum the same terms in the same order.  The CUDA
walks themselves are held to their plain versions, walk counts included,
in tests/test_torch_cuda.py and chip_smoke.py, on a machine with a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops.pallas.mt_shade import mt_intersect_pallas2_phi as j_pallas2_phi
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops import camera as camera_ops
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.ops.kernels import mt_shade, mt_stream
from tpu_pathtracer_torch.ops.mt_matmul import FEATS, determinants

CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)


def _soup(seed, n=300):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n, 3))
    e = rng.uniform(-0.2, 0.2, (n, 2, 3))
    tri = np.concatenate([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1).astype(np.float32)
    phi = rng.normal(size=(10, 96)).astype(np.float32)
    return torch.from_numpy(tri), torch.from_numpy(phi)


def _table_determinants(table, phi):
    """[a, ua, va, ta] of every (triangle, ray) pair read from the walk
    table's columns in FEATS order: each (Np, R)."""
    out, col = [], 0
    for ks in FEATS:
        acc = None
        for k in ks:
            term = table[:, col, None] * phi[k][None, :]
            acc = term if acc is None else acc + term
            col += 1
        out.append(acc)
    return out


def _assert_table_matches_rows(table, cols_rows, phi, sub):
    n = cols_rows.shape[0] // 4
    assert table.shape == (n, mt_shade.WALK_TABLE_FLOATS) and table.is_contiguous()
    assert (table[:, len(mt_shade.WALK_TABLE):] == 0).all()  # the padding slot
    coef = cols_rows.reshape(-1, 4, sub, 10)
    want = determinants(phi[None].expand(coef.shape[0], 10, phi.shape[1]), coef)
    for got, w in zip(_table_determinants(table, phi), want):
        assert torch.equal(got, w.reshape(n, -1))


@pytest.mark.parametrize("sub", [8, 16, 32, 64, 128])
def test_walk_table_gives_the_determinants_nf(sub):
    tri, phi = _soup(sub)
    _, cols_rows = mt_shade._pad_scene(tri, sub)
    _assert_table_matches_rows(mt_shade._pack_walk_table(cols_rows, sub), cols_rows, phi, sub)


def test_walk_table_gives_the_determinants_stream():
    """The streamed walk's table at its sub of 32, over 2,048 padded rows
    (one super; most of it padding, whose coefficients are zero)."""
    tri, phi = _soup(7, n=1500)
    prep = mt_stream._prepare(tri, phi, None)
    cols_rows = prep[1]
    assert cols_rows.shape == (4 * mt_stream.SUPER_TRIS, 10)
    table = mt_shade._pack_walk_table(cols_rows, mt_stream.SUB_TRIS)
    _assert_table_matches_rows(table, cols_rows, phi, mt_stream.SUB_TRIS)
    # one 128-triangle chunk is one contiguous 10 KB block of the table
    chunk = table[mt_shade.CHUNK_TRIS:2 * mt_shade.CHUNK_TRIS]
    assert chunk.numel() * 4 == 10240
    assert torch.equal(chunk[:, 0], cols_rows[4 * 128:8 * 128].reshape(4, 4, 32, 10)[:, 0, :, 4]
                       .reshape(-1))


@pytest.mark.parametrize("sub", [8, 16, 32, 64, 128])
def test_torch_walk_table_gives_the_determinants_cond(sub):
    """The cond walk stages the table a 128-triangle chunk at a time: chunk
    c's 128 rows give the determinants of its 128 / sub sub-treelets'
    coefficient blocks bit for bit (a soup of 700 triangles, 6 chunks, the
    last one partly padding)."""
    tri, phi = _soup(30 + sub, n=700)
    _, cols_rows, chunk_boxes, sub_boxes, _ = mt_shade._prepare_cond(tri, phi, None, sub)
    table = mt_shade._pack_walk_table(cols_rows, sub)
    n_chunks, spc = chunk_boxes.shape[0], sub_boxes.shape[0] // chunk_boxes.shape[0]
    assert table.shape == (n_chunks * mt_shade.CHUNK_TRIS, mt_shade.WALK_TABLE_FLOATS)
    coef = cols_rows.reshape(-1, 4, sub, 10)
    for c in range(n_chunks):
        rows = table[c * mt_shade.CHUNK_TRIS:(c + 1) * mt_shade.CHUNK_TRIS]
        blocks = coef[c * spc:(c + 1) * spc]
        want = determinants(phi[None].expand(spc, 10, phi.shape[1]), blocks)
        for got, w in zip(_table_determinants(rows, phi), want):
            assert torch.equal(got, w.reshape(mt_shade.CHUNK_TRIS, -1))


def test_walk_table_index_is_cached():
    mt_shade._walk_table_index.cache_clear()
    _, cols_rows = mt_shade._pad_scene(_soup(3)[0], 64)
    for _ in range(3):
        mt_shade._pack_walk_table(cols_rows, 64)
    info = mt_shade._walk_table_index.cache_info()
    assert info.misses == 1 and info.hits == 2


def _camera_phi(size=32):
    cam = tpt.Camera.create(**CAM)
    xs, ys = ttrace.blocked_pixel_grid(size, size)
    o, d = camera_ops.camera_rays(cam, torch.stack([xs / float(size), ys / float(size)], dim=-1),
                                  1.0)
    return ttrace._ray_features_t(o.T.contiguous(), d.T.contiguous())


@pytest.mark.parametrize("sub", [32, 64])
def test_nf_walk_stats_on_a_mesh(sub):
    """Camera rays on the BVH-ordered default scene (1,998 triangles): one
    count a tile, none above the tile's list length, and culling visible
    (tiles that walk nothing, far fewer subs than tiles x subs); equal to
    what `_walk_plain(stats=)` counts."""
    tri = tpt.default_scene().compile(device="cpu").packed.tri_pos
    phi = _camera_phi()
    stats = mt_shade.nf_walk_stats(tri, phi, tile_rays=128, sub=sub, plain=True)
    prep = mt_shade._prepare(tri, phi, 128, sub)
    counts, ms = prep[2], prep[3].shape[1]
    assert stats.shape == (phi.shape[1] // 128,) and stats.dtype == torch.int32
    assert (stats <= counts).all() and 0 < int(stats.sum()) < stats.shape[0] * ms // 2
    assert bool((stats == 0).any()) and int(stats.max()) < ms
    direct = torch.zeros_like(stats)
    mt_shade._walk_plain(*prep, stats=direct)
    assert torch.equal(stats, direct)
    # a CPU tensor runs the plain version without `plain=True`
    assert torch.equal(mt_shade.nf_walk_stats(tri, phi, tile_rays=128, sub=sub), stats)


def test_nf_walk_with_stats_matches_jax():
    """The plain nf walk that counts (the reference of the kernel's walk
    counts) still finds JAX's `_kernel_nf` hits in interpret mode."""
    tri = tpt.default_scene().compile(device="cpu").packed.tri_pos
    phi = _camera_phi(16)
    prep = mt_shade._prepare(tri, phi, 128, 64)
    stats = torch.zeros((prep[3].shape[0],), dtype=torch.int32)
    t, idx, u, v = mt_shade._walk_plain(*prep, stats=stats)
    ha = j_pallas2_phi(jnp.asarray(tri.numpy()), jnp.asarray(phi.numpy()), tile_rays=128,
                       cull="nf", sub=64, interpret=True)
    r = phi.shape[1]
    np.testing.assert_array_equal(idx[:r].numpy(), np.asarray(ha.tri))
    hit = np.asarray(ha.hit)
    assert hit.sum() > 50
    np.testing.assert_allclose(t[:r].numpy()[hit], np.asarray(ha.t)[hit], rtol=5e-5)
    assert int(stats.sum()) > 0


@pytest.mark.parametrize("sub", [8, 32, 128])
def test_list_walk_with_stats_matches_jax(sub):
    """The plain list walk that counts (the reference of the list kernel's
    walk counts) evaluates every listed sub of each tile, and still finds
    JAX's `_kernel_list` hits in interpret mode."""
    tri = tpt.default_scene().compile(device="cpu").packed.tri_pos
    phi = _camera_phi(16)
    prep = mt_shade._prepare_list(tri, phi, 128, sub)
    stats = torch.zeros_like(prep[2])
    t, idx, u, v = mt_shade._walk_list_plain(*prep, stats=stats)
    assert torch.equal(stats, prep[2]) and int(stats.sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip((t, idx, u, v),
                                                   mt_shade._walk_list_plain(*prep)))
    ha = j_pallas2_phi(jnp.asarray(tri.numpy()), jnp.asarray(phi.numpy()), tile_rays=128,
                       cull="list", sub=sub, interpret=True)
    r = phi.shape[1]
    np.testing.assert_array_equal(idx[:r].numpy(), np.asarray(ha.tri))
    hit = np.asarray(ha.hit)
    assert hit.sum() > 50
    np.testing.assert_allclose(t[:r].numpy()[hit], np.asarray(ha.t)[hit], rtol=5e-5)


@pytest.mark.parametrize("sub", [32, 64])
def test_mxu_nf_walk_stats_on_a_mesh(sub):
    """`nf_walk_stats(mxu=True)` on the CPU counts the MXU plain walk's
    subs (its decisions read the matrix-product t): one count a tile, none
    above the tile's list length, within 1% of tiles of the FP32 walk's on
    camera rays (the same t up to rounding)."""
    tri = tpt.default_scene().compile(device="cpu").packed.tri_pos
    phi = _camera_phi()
    sm = mt_shade.nf_walk_stats(tri, phi, tile_rays=128, sub=sub, mxu=True)
    sf = mt_shade.nf_walk_stats(tri, phi, tile_rays=128, sub=sub)
    counts = mt_shade._prepare(tri, phi, 128, sub)[2]
    assert sm.shape == sf.shape and (sm <= counts).all() and int(sm.sum()) > 0
    assert int((sm != sf).sum()) <= max(1, sm.shape[0] // 100)
    prep = mt_shade._prepare(tri, phi, 128, sub)
    direct = torch.zeros_like(sm)
    mt_shade._walk_plain(*prep, stats=direct, mxu=True)
    assert torch.equal(sm, direct)
