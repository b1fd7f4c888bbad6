"""The MXU walks' inputs on the CPU (csrc/mxu_walk.cu, kernel #5): the TF32
split, the table `_pack_mxu_table` packs, and the per-lane best that the
walks keep.

  * `mt_shade._tf32` against a numpy reference of `cvt.rna.tf32.f32`
    written from the rounding rule (ties away from zero, subnormals,
    overflow to inf), bit for bit; hi and lo with their low 13 bits zero
    and hi + lo within 2^-22 of x;
  * the table's layout at every sub: each lane's B fragments read back from
    it and its A fragments built from the rays as the kernel builds them,
    multiplied through the m16n8k8 fragment layouts in float64 in the
    kernel's three passes, give in the C fragment of lane (g, tig) the four
    determinants of rays g, g+8 and triangles 2*tig, 2*tig+1: those of
    `determinants`, and of the contraction JAX's `_mt_mxu_block` forms;
  * a sub-treelet's (and a chunk's) rows are one contiguous block of the
    table, and its index is cached;
  * the walks' per-lane best: each lane takes the pairs of its triangles
    (2*tig and 2*tig+1 of every 8) by (t, index), a decision reads a ray's
    t as the min over its lanes, and the lanes combine by (t, index) at the
    end.  Mirrored in torch with the FP32 determinants, the nf and list
    walks so ordered give the plain walks' hits and walk counts bit for
    bit, exact-t ties between lanes included.

The CUDA walks themselves are held to their plain versions in
tests/test_torch_cuda.py and chip_smoke.py, on a machine with a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops import camera as camera_ops
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.ops.kernels import mt_shade
from tpu_pathtracer_torch.ops.mt_matmul import determinants

CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
LOW13 = 0x1FFF


def _cvt_rna_reference(x):
    """float32 -> TF32 by the rule, in float64: |x| rounded to 11
    significant bits (the quantum 2^(e-10) of its binade, 2^-136 for
    subnormals), half a quantum rounding away from zero; overflow past
    float32 gives inf."""
    x64 = x.astype(np.float64)
    out = x64.copy()
    finite = np.isfinite(x64) & (x64 != 0)
    mag = np.abs(x64[finite])
    _, e = np.frexp(mag)  # mag = m * 2^e, 0.5 <= m < 1
    quantum = np.ldexp(1.0, np.maximum(e - 1, -126) - 10)
    out[finite] = np.sign(x64[finite]) * np.floor(mag / quantum + 0.5) * quantum
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _split_inputs():
    rng = np.random.default_rng(0)
    scales = np.float32(10.0) ** rng.integers(-30, 31, 4000)
    normal = (rng.normal(size=4000) * scales).astype(np.float32)
    # exact halfway points, below and above: mantissa bits 0x1000 / 0x0fff / 0x1001 over a
    # TF32 value, both signs
    base = _bits(rng.normal(size=300).astype(np.float32)) & ~np.uint32(LOW13)
    ties = np.concatenate([base | 0x1000, base | 0x0FFF, base | 0x1001, base | 0x3000])
    special = np.array([0.0, -0.0, 1.0, -1.0, 1e30, -1e30, np.inf, -np.inf,
                        np.finfo(np.float32).max, -np.finfo(np.float32).max,
                        np.finfo(np.float32).tiny, 1.4e-45, -1.4e-45, 3e-39, -7.7e-40,
                        2.0 ** -126 - 2.0 ** -149], np.float32)
    carry = (np.uint32(0x3FFFF000) + np.arange(0, 0x1000, 0x100, dtype=np.uint32))  # carries
    subnormal = rng.integers(1, 0x7FFFFF, 500).astype(np.uint32) | (
        rng.integers(0, 2, 500).astype(np.uint32) << 31)
    return np.concatenate([normal, ties.view(np.float32), special, carry.view(np.float32),
                           subnormal.view(np.float32)])


def test_tf32_matches_cvt_rna_reference():
    x = _split_inputs()
    got = mt_shade._tf32(torch.from_numpy(x)).numpy()
    want = _cvt_rna_reference(x)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not (_bits(got) & LOW13).any()
    # ties go away from zero
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11], np.float32)
    np.testing.assert_array_equal(mt_shade._tf32(torch.from_numpy(tie)).numpy(),
                                  np.array([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                            1.0 + 2 * 2.0 ** -10], np.float32))
    assert np.isinf(mt_shade._tf32(torch.tensor([3.4028235e38])).numpy()[0])  # rounds past max
    assert torch.isnan(mt_shade._tf32(torch.tensor([float("nan")]))).all()


def test_tf32_split_keeps_22_bits():
    x = _split_inputs()
    x = x[np.isfinite(x) & (np.abs(x) < 1e38)]
    hi, lo = (v.numpy() for v in mt_shade._tf32_split(torch.from_numpy(x)))
    assert not (_bits(hi) & LOW13).any() and not (_bits(lo) & LOW13).any()
    np.testing.assert_array_equal(_bits(hi), _bits(_cvt_rna_reference(x)))
    normal = np.abs(x) >= np.finfo(np.float32).tiny
    err = np.abs(hi.astype(np.float64) + lo - x)
    assert (err[normal] <= 2.0 ** -22 * np.abs(x[normal].astype(np.float64))).all()
    assert (err[~normal] <= 2.0 ** -136).all()  # one TF32 quantum of the subnormal range


def _soup(seed, n):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n, 3))
    e = rng.uniform(-0.3, 0.3, (n, 2, 3))
    return torch.from_numpy(np.concatenate([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)
                            .astype(np.float32))


def _b_matrices(group):
    """One 8-triangle group of the MXU table (5 float4 x 32 lanes, as
    (5, 32, 4)) read back through the m16n8k8 B layout (register b0 of lane
    (g, tig) is row tig, b1 row tig+4, column g): per quantity (a, ua, va,
    ta) the (16 K positions, 8 triangles) hi and lo matrices."""
    hi = np.zeros((4, 16, 8))
    lo = np.zeros((4, 16, 8))
    for lane in range(32):
        g, tig = lane // 4, lane % 4
        for q in range(4):
            for reg in range(2):
                w = 2 * (q % 2) + reg
                hi[q, tig + 4 * reg, g] = group[q // 2, lane, w]
                lo[q, tig + 4 * reg, g] = group[2 + q // 2, lane, w]
        hi[3, 8 + tig, g] = group[4, lane, 0]  # ta's k-step-1 b0; b1 is position 12 + tig
        lo[3, 8 + tig, g] = group[4, lane, 1]
    return hi, lo


def _a_matrices(phi16):
    """The A fragments of 16 rays, built per lane as csrc/mxu_walk.cu
    `load_frags` builds them (lane (g, tig): a0/a1 feature 4 + tig of rays
    g / g+8, a2/a3 feature 8 + tig or tig - 2, k-step 1 a0/a1 feature 2 + tig
    for tig < 2), split in hi and lo and read back through the A layout
    (register r of k-step k is row g + 8 (r % 2), column 8k + tig + 4 (r //
    2)): (16 rays, 16 K positions) hi and lo."""
    hi = np.zeros((16, 16))
    lo = np.zeros((16, 16))
    for lane in range(32):
        g, tig = lane // 4, lane % 4
        feats = {(0, 0): 4 + tig, (0, 1): 4 + tig, (0, 2): 8 + tig if tig < 2 else tig - 2,
                 (0, 3): 8 + tig if tig < 2 else tig - 2, (1, 0): 2 + tig, (1, 1): 2 + tig}
        for (k, r), f in feats.items():
            ray = g + 8 * (r % 2)
            x = phi16[f, ray] if (k == 0 or tig < 2) else np.float32(0)
            h, low = (v.item() for v in mt_shade._tf32_split(torch.tensor([x])))
            hi[ray, 8 * k + tig + 4 * (r // 2)] = h
            lo[ray, 8 * k + tig + 4 * (r // 2)] = low
    return hi, lo


@pytest.mark.parametrize("sub", [8, 16, 32, 64, 128])
def test_mxu_table_gives_each_lane_all_four_determinants(sub):
    """Per group G and lane (g, tig): C = lo*hi + hi*lo + hi*hi of the A and
    B fragments (float64) holds at c0, c1, c2, c3 the determinants of (ray
    g, triangle 2tig), (g, 2tig+1), (g+8, 2tig), (g+8, 2tig+1) of group G,
    within 2^-20 of their terms' magnitudes; and agrees with the
    (4*SUB, 10) @ (10, 16) contraction JAX's `_mt_mxu_block` forms."""
    tri = _soup(sub, 300)
    _, cols_rows = mt_shade._pad_scene(tri, sub)
    n = cols_rows.shape[0] // 4
    table = mt_shade._pack_mxu_table(cols_rows, sub)
    assert table.shape == (n, mt_shade.MXU_TABLE_FLOATS) and table.is_contiguous()
    groups = table.numpy().reshape(n // 8, 5, 32, 4)
    assert not (_bits(groups) & LOW13).any()  # every word a TF32 half
    # float4 4: ta's k-step-1 hi and lo, K positions 8 and 9 only (tig < 2), then padding
    assert (groups[:, 4, :, 2:] == 0).all() and (groups[:, 4, np.arange(32) % 4 >= 2] == 0).all()

    phi = torch.from_numpy(np.random.default_rng(sub + 1).normal(size=(10, 16))
                           .astype(np.float32))
    coef = cols_rows.reshape(-1, 4, sub, 10)
    want = determinants(phi.double()[None], coef.double())  # 4 x (Ms, sub, 16)
    want = np.stack([w.reshape(n, 16).numpy() for w in want])  # (4, Np, 16 rays)
    scale = np.stack([(coef.double().abs()[:, q] @ phi.double().abs()).reshape(n, 16).numpy()
                      for q in range(4)])
    blk = jnp.asarray(cols_rows.numpy().reshape(-1, 4 * sub, 10))
    jax_d = np.stack([np.asarray(jax.lax.dot_general(
        b, jnp.asarray(phi.numpy()), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST))
        for b in blk])  # (Ms, 4*sub, 16), as `_mt_mxu_block`
    jax_d = jax_d.reshape(-1, 4, sub, 16).transpose(1, 0, 2, 3).reshape(4, n, 16)

    a_hi, a_lo = _a_matrices(phi.numpy())
    for grp in sorted({0, n // 16, n // 8 - 1}):
        b_hi, b_lo = _b_matrices(groups[grp])
        c = np.stack([a_lo @ b_hi[q] + a_hi @ b_lo[q] + a_hi @ b_hi[q] for q in range(4)])
        for lane in range(32):
            g, tig = lane // 4, lane % 4
            for i, (ray, col) in enumerate(((g, 2 * tig), (g, 2 * tig + 1), (g + 8, 2 * tig),
                                            (g + 8, 2 * tig + 1))):
                got = c[:, ray, col]  # register c_i of lane (g, tig), all four quantities
                tri_i = 8 * grp + col
                assert i == 2 * (ray >= 8) + col % 2
                np.testing.assert_array_less(np.abs(got - want[:, tri_i, ray]),
                                             2.0 ** -20 * scale[:, tri_i, ray] + 1e-30)
                np.testing.assert_allclose(got, jax_d[:, tri_i, ray], rtol=1e-5,
                                           atol=1e-6 * scale[:, tri_i, ray].max())


@pytest.mark.parametrize("sub", [8, 32, 128])
def test_mxu_table_blocks_are_contiguous(sub):
    """Sub-treelet s is rows [s*sub, (s+1)*sub) of the table and chunk c
    rows [128c, 128(c+1)): packing a block alone gives those rows, so the
    walks stage a sub (nf, list) or a chunk (cond) as one bulk copy."""
    _, cols_rows = mt_shade._pad_scene(_soup(3, 700), sub)
    table = mt_shade._pack_mxu_table(cols_rows, sub)
    for s in (0, 3, cols_rows.shape[0] // (4 * sub) - 1):
        alone = mt_shade._pack_mxu_table(cols_rows[4 * sub * s:4 * sub * (s + 1)], sub)
        assert torch.equal(alone, table[sub * s:sub * (s + 1)])
    chunk = mt_shade._pack_mxu_table(cols_rows[4 * 128:8 * 128], sub)
    assert torch.equal(chunk, table[128:256]) and chunk.numel() * 4 == 128 * 320


def test_mxu_table_index_is_cached():
    mt_shade._mxu_table_index.cache_clear()
    _, cols_rows = mt_shade._pad_scene(_soup(4, 300), 64)
    for _ in range(3):
        mt_shade._pack_mxu_table(cols_rows, 64)
    info = mt_shade._mxu_table_index.cache_info()
    assert info.misses == 1 and info.hits == 2


# --- the per-lane best of the MXU walks, mirrored -------------------------------


def _lane_coefs(coef):
    """(Ms, 4, sub, 10) coefficients split by the lane that evaluates each
    triangle, tig = (index % 8) // 2; the other triangles' rows zeroed
    (a = 0 never hits)."""
    lane = (torch.arange(coef.shape[2]) % 8) // 2
    return [coef * (lane == tig).to(coef.dtype)[None, None, :, None] for tig in range(4)]


def _mirror(phi_pad, cols_rows, counts, lists, emins, tile_rays, nf):
    """The nf (`nf`) or list walk as the MXU walks keep their state: four
    lanes' bests per ray, each over its own triangles; nf's bound from each
    ray's min over its lanes; the lanes combined by (t, index) at the end.
    Returns (hits (R_pad,) x4, walk counts (T,))."""
    n_tiles, ms = lists.shape
    phi, _ = mt_shade._walk_start(phi_pad, n_tiles, tile_rays, park=nf)
    bests = [mt_shade._walk_start(phi_pad, n_tiles, tile_rays, park=nf)[1] for _ in range(4)]
    coefs = _lane_coefs(cols_rows.reshape(ms, 4, -1, 10))
    tmax = torch.full((n_tiles,), float(mt_shade.INF))
    walking = torch.ones((n_tiles,), dtype=torch.bool)
    stats = torch.zeros((n_tiles,), dtype=torch.int32)
    for j in range(ms):
        walking &= counts > j
        if nf:
            walking &= emins[:, j] < tmax
        tiles = walking.nonzero().squeeze(1)
        if tiles.numel() == 0:
            break
        for coef, best in zip(coefs, bests):
            mt_shade._fold_subs(phi, coef, tiles, lists[tiles, j], best)
        ray_t = torch.stack([best[0] for best in bests]).amin(dim=0)
        tmax[tiles] = ray_t[tiles].amax(dim=1)
        stats[tiles] += 1
    t, idx, u, v = bests[0]
    for ot, oi, ou, ov in bests[1:]:
        take = (ot < t) | ((ot == t) & (oi < idx))
        t, idx, u, v = (torch.where(take, a, b) for a, b in ((ot, t), (oi, idx), (ou, u), (ov, v)))
    return tuple(x.reshape(-1) for x in (t, idx, u, v)), stats


def _tied_scene():
    """The default scene with every tenth triangle copied to index + 2 (the
    next lane), so exact-t ties fall between lanes."""
    tri = tpt.default_scene().compile(device="cpu").packed.tri_pos
    out = tri.clone()
    src = torch.arange(0, tri.shape[0] - 2, 10)
    out[src + 2] = tri[src]
    return out


def _camera_phi(size=32):
    cam = tpt.Camera.create(**CAM)
    xs, ys = ttrace.blocked_pixel_grid(size, size)
    o, d = camera_ops.camera_rays(cam, torch.stack([xs / float(size), ys / float(size)], dim=-1),
                                  1.0)
    return ttrace._ray_features_t(o.T.contiguous(), d.T.contiguous())


@pytest.mark.parametrize("sub", [8, 32, 64, 128])
@pytest.mark.parametrize("cull", ["nf", "list"])
def test_per_lane_bests_give_the_plain_walk(cull, sub):
    tri, phi = _tied_scene(), _camera_phi()
    prep = mt_shade._prepare(tri, phi, 128, sub)
    phi_pad, cols_rows, counts, lists, emins, tile = prep
    got, stats = _mirror(phi_pad, cols_rows, counts, lists, emins, tile, cull == "nf")
    want_stats = torch.zeros_like(stats)
    if cull == "nf":
        want = mt_shade._walk_plain(*prep, stats=want_stats)
    else:
        want = mt_shade._walk_list_plain(phi_pad, cols_rows, counts, lists, tile,
                                         stats=want_stats)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(stats, want_stats) and int(stats.sum()) > 0
    hit_idx = want[1][want[1] >= 0]
    assert int(hit_idx.numel()) > 300
    assert bool(((hit_idx % 10 == 0) | (hit_idx % 10 == 2)).any())  # the copies are reached
