"""Near-to-far Möller–Trumbore intersection over per-tile live sub-treelet
lists: the wrapper, its plain PyTorch version and the CUDA kernel's binding.

Replaces the TPU kernel `_kernel_nf` of tpu_pathtracer/ops/pallas/mt_shade.py
(reached through `mt_intersect_pallas2_phi` with cull='nf', sub=64,
tile_rays=512, VPU determinants).  The contract is the JAX wrapper's:

  * triangles pad to a multiple of 128 rows (all-zero rows never hit) and
    are cut into 64-row sub-treelets; the ray features phi_t (10, R) pad
    with 1e30 to a multiple of the ray tile;
  * a precull (`_precull_live_subs`, plain torch) slab-tests every ray
    against every sub-treelet box, reduces per ray tile, and sorts each
    tile's live subs by entry distance;
  * per tile, the kernel walks that list near to far and stops once the
    next entry distance reaches the tile's largest live t.  Parked lanes
    (rd = 0) and padding lanes (|rd| >= 1e30) start at t = -INF, so they
    never take a hit and never hold the walk open;
  * nearest hit wins, exact-t ties go to the lowest triangle index, in
    whatever order the subs arrive.

`mt_intersect_nf_phi` launches the CUDA kernel (csrc/mt_shade.cu) for a
CUDA tensor and runs `mt_intersect_nf_phi_plain` for a CPU tensor.  The
plain version walks the same lists in the same order, sub by sub over all
tiles at once, with the same elementwise arithmetic, so the two agree bit
for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..mt_matmul import Hit, determinants, epilogue, miss_hit, nearest, triangle_columns
from ..vecmath import EPSILON, INF

TILE_RAYS = 512  # rays per tile (one CUDA block)
CHUNK_TRIS = 128  # triangle padding granule
SUB_TRIS = 64  # sub-treelet: the unit of culling and of one staged block
MAX_TILES = 512  # tiles widen past this many (the JAX contract's list cap)
# The JAX contract's size limits: scenes above MT_SHADE_MAX_TRIS go to the
# streamed kernel (mt_stream.py), whose super-treelets are
# CHUNKS_PER_SUPER chunks, up to MT_STREAM2_MAX_TRIS triangles.
MT_SHADE_MAX_TRIS = 8192
CHUNKS_PER_SUPER = 16
MT_STREAM2_MAX_TRIS = 262144


def _pad_to(x, size: int, dim: int, value: float = 0.0):
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=dim)


def treelet_boxes(tri_pos, chunk: int = CHUNK_TRIS):
    """AABBs of consecutive `chunk`-row treelets: (N, 9) -> (M, 8) f32
    [min3, max3, 0, 0].  All-zero padding rows pull the last box toward the
    origin, which is conservative."""
    n = tri_pos.shape[0]
    m = -(-n // chunk)
    verts = _pad_to(tri_pos, m * chunk, 0).reshape(m, chunk * 3, 3)
    bmin = verts.amin(dim=1)
    bmax = verts.amax(dim=1)
    return torch.cat([bmin, bmax, torch.zeros_like(bmin[:, :2])], dim=1)


def _slab_entries(boxes, ro, rd, par, inv):
    """Conservative slab entry distances of (..., K, 8) boxes vs (..., 3, R)
    rays (leading dims equal): (..., K, R) f32 entry distance, INF where the
    box is missed.  Parallel axes require containment."""
    inf = float(INF)
    shape = (*boxes.shape[:-1], ro.shape[-1])
    hit_par = torch.ones(shape, dtype=torch.bool, device=ro.device)
    tmin_all = torch.full(shape, -inf, device=ro.device)
    tmax_all = torch.full(shape, inf, device=ro.device)
    for k in range(3):
        pk = par[..., k, None, :]
        o = ro[..., k, None, :]
        lo_b = boxes[..., k, None]
        hi_b = boxes[..., k + 3, None]
        lo = (lo_b - o) * inv[..., k, None, :]
        hi = (hi_b - o) * inv[..., k, None, :]
        tn = torch.where(pk, -inf, torch.minimum(lo, hi))
        tf = torch.where(pk, inf, torch.maximum(lo, hi))
        inside = (o >= lo_b) & (o <= hi_b)
        hit_par &= ~pk | inside
        tmin_all = torch.maximum(tmin_all, tn)
        tmax_all = torch.minimum(tmax_all, tf)
    box_hit = hit_par & (tmax_all >= torch.clamp(tmin_all, min=0.0))
    return torch.where(box_hit, tmin_all, inf)


def _slab_setup(ro, rd):
    """(par, inv) for `_slab_entries`: axes with |rd| < EPSILON are parallel."""
    par = torch.abs(rd) < float(EPSILON)
    inv = 1.0 / torch.where(par, torch.ones_like(rd), rd)
    return par, inv


def _parked_lanes(rd):
    """Lanes that must never take a hit: parked rays (rd = 0) and padding
    lanes (rd = 1e30).  rd: (3, ...) -> bool (...)."""
    return ((torch.abs(rd[0]) + torch.abs(rd[1]) + torch.abs(rd[2])) == 0.0) | (
        torch.abs(rd[0]) >= 1e30)


def _precull_live_subs(sub_boxes, phi_t, tile_rays: int):
    """Per-ray slab precull, reduced to per-tile live sub lists.

    sub_boxes: (Ms, 8); phi_t: (10, R) padded to a tile multiple.  Returns
    (counts (T,) i32, lists (T, Ms) i32, emins (T, Ms) f32): lists[t, :counts[t]]
    are tile t's live subs by ascending tile entry distance (a stable sort, so
    equal distances keep index order); emins holds those distances, INF past
    counts[t].  Rays are processed in bounded chunks of whole tiles."""
    ms, r = sub_boxes.shape[0], phi_t.shape[1]
    step = max(1, 65536 // tile_rays) * tile_rays
    emin_parts = []
    for r0 in range(0, r, step):
        ro = phi_t[1:4, r0:r0 + step]
        rd = phi_t[4:7, r0:r0 + step]
        entry = _slab_entries(sub_boxes, ro, rd, *_slab_setup(ro, rd))  # (Ms, Rc)
        emin_parts.append(entry.reshape(ms, -1, tile_rays).amin(dim=2))
    emin = torch.cat(emin_parts, dim=1)  # (Ms, T)
    counts = (emin < float(INF)).sum(dim=0, dtype=torch.int32)
    emins, lists = torch.sort(emin, dim=0, stable=True)
    return counts, lists.T.to(torch.int32).contiguous(), emins.T.contiguous()


def _dead_pad_boxes(boxes, n_real: int, granule: int):
    """Give treelets made only of padding rows the impossible box
    [+INF]*3, [-INF]*3, 0, 0, which every slab test misses (`treelet_boxes`
    pulls padding toward the origin, which a ray there would hit)."""
    first_dead = -(-n_real // granule)
    if first_dead >= boxes.shape[0]:
        return boxes
    inf = float(INF)
    out = boxes.clone()
    out[first_dead:] = torch.tensor([inf] * 3 + [-inf] * 3 + [0.0, 0.0], device=boxes.device)
    return out


def _pack_subblock_major(cols, sub: int):
    """(10, 4, Np) coefficients -> (4*Np, 10) sub-block-major rows: row
    b*4*sub + q*sub + i holds quantity q of triangle b*sub + i, so one
    contiguous (4*sub, 10) block per sub-treelet."""
    n = cols.shape[2]
    qs = cols.permute(1, 2, 0)  # (4, Np, 10)
    return qs.reshape(4, n // sub, sub, 10).permute(1, 0, 2, 3).reshape(4 * n, 10).contiguous()


def _tile_rays(override) -> int:
    value = int(override) if override is not None else TILE_RAYS
    if value <= 0 or value % 128:
        raise ValueError(f"tile_rays must be a positive multiple of 128, got {value}")
    return value


def _prepare(tri_pos, phi_t, tile_rays):
    """Padding, coefficient packing and precull shared by kernel and plain
    version.  Returns (phi_pad, cols_rows, counts, lists, emins, tile_rays)."""
    n = tri_pos.shape[0]
    if n > MT_SHADE_MAX_TRIS:
        raise ValueError(
            f"mt_pallas supports <= {MT_SHADE_MAX_TRIS} triangles (got {n}); use 'mt_stream'")
    tile_rays = _widened_tile(tile_rays, phi_t.shape[1])
    n_pad = -(-n // CHUNK_TRIS) * CHUNK_TRIS
    tri_padded = _pad_to(tri_pos, n_pad, 0)
    cols_rows = _pack_subblock_major(triangle_columns(tri_padded), SUB_TRIS)
    sub_boxes = treelet_boxes(tri_padded, SUB_TRIS)
    phi_pad = _pad_rays(phi_t, tile_rays)
    counts, lists, emins = _precull_live_subs(sub_boxes, phi_pad, tile_rays)
    return phi_pad, cols_rows, counts, lists, emins, tile_rays


def _widened_tile(override, r: int) -> int:
    """The ray-tile width for R rays: doubled while there are more than
    MAX_TILES tiles."""
    tile_rays = _tile_rays(override)
    while -(-r // tile_rays) > MAX_TILES:
        tile_rays *= 2
    return tile_rays


def _pad_rays(phi_t, tile_rays: int):
    """(10, R) ray features padded with 1e30 (lanes that never hit) to a
    tile multiple."""
    return _pad_to(phi_t, -(-phi_t.shape[1] // tile_rays) * tile_rays, 1, value=1e30).contiguous()


def _walk_start(phi_pad, n_tiles: int, tile_rays: int):
    """Per-tile ray features (T, 10, TR) and the initial best state
    [t, idx, u, v], each (T, TR): parked and padding lanes start at -INF."""
    inf = float(INF)
    phi = phi_pad.reshape(10, n_tiles, tile_rays).permute(1, 0, 2)
    parked = _parked_lanes(phi[:, 4:7].permute(1, 0, 2))
    t = torch.where(parked, -inf, inf)
    return phi, [t, torch.full_like(t, -1, dtype=torch.int32), torch.zeros_like(t),
                 torch.zeros_like(t)]


def _fold_subs(phi, coef, tiles, subs, best, tiles_per_chunk: int = 128):
    """Evaluate sub-treelet subs[i] against every ray of tile tiles[i] and
    fold its nearest hit into `best` in place with the kernels' take rule
    (exact-t ties to the lower index).  coef: (Ms, 4, sub, 10)."""
    inf = float(INF)
    t, idx, u, v = best
    sub = coef.shape[2]
    for c0 in range(0, tiles.numel(), tiles_per_chunk):
        tc = tiles[c0:c0 + tiles_per_chunk]
        s = subs[c0:c0 + tiles_per_chunk].long()
        tt, uu, vv = epilogue(*determinants(phi[tc], coef[s]))  # (Tc, sub, TR)
        tmin, imin, u_w, v_w = nearest(tt, uu, vv, (s * sub).to(torch.int32))
        cur_t, cur_i = t[tc], idx[tc]
        take = (tmin < cur_t) | ((tmin == cur_t) & (tmin < inf) & (imin < cur_i))
        t[tc] = torch.where(take, tmin, cur_t)
        idx[tc] = torch.where(take, imin, cur_i)
        u[tc] = torch.where(take, u_w, u[tc])
        v[tc] = torch.where(take, v_w, v[tc])


def _walk_plain(phi_pad, cols_rows, counts, lists, emins, tile_rays: int):
    """The kernel's walk in torch ops: step j evaluates entry j of every
    tile still walking, then refreshes those tiles' largest live t."""
    n_tiles, ms = lists.shape
    phi, best = _walk_start(phi_pad, n_tiles, tile_rays)
    coef = cols_rows.reshape(-1, 4, SUB_TRIS, 10)  # (Ms, 4, sub, 10)
    t = best[0]
    tmax = torch.full((n_tiles,), float(INF), device=t.device)
    walking = torch.ones((n_tiles,), dtype=torch.bool, device=t.device)
    for j in range(ms):
        walking &= (counts > j) & (emins[:, j] < tmax)
        tiles = walking.nonzero().squeeze(1)
        if tiles.numel() == 0:
            break
        _fold_subs(phi, coef, tiles, lists[tiles, j], best)
        tmax[tiles] = t[tiles].amax(dim=1)
    return tuple(x.reshape(-1) for x in best)


def _walk_cuda(phi_pad, cols_rows, counts, lists, emins, tile_rays: int):
    """Launch csrc/mt_shade.cu on the current stream; outputs (R_pad,) x4."""
    from ... import _build

    lib = _build.load()
    r_pad = phi_pad.shape[1]
    n_tiles, ms = lists.shape
    for x, dt in ((phi_pad, torch.float32), (cols_rows, torch.float32), (counts, torch.int32),
                  (lists, torch.int32), (emins, torch.float32)):
        if x.dtype != dt or not x.is_contiguous() or x.device != phi_pad.device:
            raise ValueError("mt_shade kernel: bad input dtype, layout or device")
    dev = phi_pad.device
    t = torch.empty((r_pad,), dtype=torch.float32, device=dev)
    idx = torch.empty((r_pad,), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    p = lambda x: ctypes.c_void_p(x.data_ptr())
    err = lib.tpt_mt_nf(
        p(phi_pad), p(cols_rows), p(counts), p(lists), p(emins),
        p(t), p(idx), p(u), p(v),
        r_pad, tile_rays, n_tiles, ms, SUB_TRIS,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err:
        raise RuntimeError(f"mt_shade kernel launch failed: {_build.error_string(err)}")
    return t, idx, u, v


def _intersect(tri_pos, phi_t, tile_rays, walk, prepare=_prepare) -> Hit:
    r = phi_t.shape[1]
    if tri_pos.shape[0] == 0 or r == 0:
        return miss_hit(r, phi_t.device)
    t, idx, u, v = walk(*prepare(tri_pos, phi_t, tile_rays))
    idx = idx[:r]
    return Hit(idx >= 0, t[:r], idx, u[:r], v[:r])


def mt_intersect_nf_phi_plain(tri_pos, phi_t, *, tile_rays=None) -> Hit:
    """Plain PyTorch version of the near-to-far MT kernel, on any device.
    tri_pos: (N, 9) packed rows; phi_t: (10, R) ray features."""
    return _intersect(tri_pos, phi_t, tile_rays, _walk_plain)


def mt_intersect_nf_phi(tri_pos, phi_t, *, tile_rays=None) -> Hit:
    """Near-to-far MT intersection of (10, R) ray features against (N, 9)
    packed triangle rows; returns `Hit` (t is INF on a miss, -INF on a
    parked lane).  A CUDA tensor launches the kernel (and counts the launch
    in `mt_intersect_nf_phi.launches`); a CPU tensor runs the plain version."""
    if phi_t.device.type == "cpu":
        return mt_intersect_nf_phi_plain(tri_pos, phi_t, tile_rays=tile_rays)
    if phi_t.device.type != "cuda":
        raise NotImplementedError(f"no MT kernel for device {phi_t.device}")

    def walk(*args):
        mt_intersect_nf_phi.launches += 1
        return _walk_cuda(*args)

    return _intersect(tri_pos, phi_t, tile_rays, walk)


mt_intersect_nf_phi.launches = 0
