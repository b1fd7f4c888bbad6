"""Whole-scene Möller–Trumbore intersection (up to 8,192 triangles): the
wrappers, their plain PyTorch versions and the CUDA kernels' bindings.

Replaces the three culling variants of tpu_pathtracer/ops/pallas/mt_shade.py
that `mt_intersect_pallas2_phi` dispatches to, with the JAX wrapper's
contract:

  * `_cull_mode`: 'nf' (`_kernel_nf`, the default), 'list' (`_kernel_list`)
    or 'cond' (`_kernel`); `_sub_tris`: the sub-treelet granule, a positive
    multiple of 8 dividing 128 (default 64); `_tile_rays`: rays per tile, a
    positive multiple of 128 (default 512).  Each is an explicit argument,
    then an environment variable (TPT_CULL, TPT_SUB, TPT_TILE_RAYS), then
    the default.  The MXU determinant option (TPT_MXU_DETS) is not ported
    and raises;
  * triangles pad to a multiple of 128 rows (all-zero rows never hit) and
    are cut into `sub`-row sub-treelets; the ray features phi_t (10, R) pad
    with 1e30 to a multiple of the ray tile;
  * 'nf' and 'list': a precull (`_precull_live_subs`, plain torch)
    slab-tests every ray against every sub box, reduces per ray tile and
    sorts each tile's live subs by entry distance; the tile widens while
    there are more than 512 tiles.  'nf' walks that list near to far and
    stops once the next entry distance reaches the tile's largest live t;
    parked lanes (rd = 0) and padding lanes (|rd| >= 1e30) start at
    t = -INF, so they never take a hit and never hold the walk open.
    'list' walks the whole list in list order, every lane from t = INF;
  * 'cond': no precull and no tile widening.  A tile runs only if some lane
    has a nonzero direction; it then visits every 128-triangle chunk in
    index order, evaluates a chunk only if some ray enters its box before
    its current t, and inside it each sub likewise (a 128-triangle sub is
    the chunk itself).  Boxes come straight from `treelet_boxes`, padding
    rows included; every lane starts at t = INF;
  * nearest hit wins, exact-t ties go to the lowest triangle index, in
    whatever order the subs arrive.

Each kernel has its own wrapper (`mt_intersect_nf_phi`,
`mt_intersect_list_phi`, `mt_intersect_cond_phi`), which launches the CUDA
kernel (csrc/mt_shade.cu) for a CUDA tensor, counting the launch in its
`.launches`, and runs its plain version for a CPU tensor.  The plain
versions walk the same lists, chunks and subs in the same order, vectorised
over tiles, with the same elementwise arithmetic, so kernel and plain
version agree bit for bit.
"""

from __future__ import annotations

import os

import torch

from ..mt_matmul import Hit, determinants, epilogue, miss_hit, nearest, ray_features, triangle_columns
from ..vecmath import INF
from .mt_intersect import (
    _check_inputs,
    _counted,
    _launches_kernel,
    _outputs,
    _pad_to,
    _ptr,
    _slab_entries,
    _slab_setup,
    _stream,
    treelet_boxes,
)

TILE_RAYS = 512  # rays per tile (one CUDA block)
CHUNK_TRIS = 128  # triangle padding granule and the 'cond' chunk
SUB_TRIS = 64  # default sub-treelet granule: the unit of culling and of one staged block
MAX_TILES = 512  # 'nf'/'list' tiles widen past this many (the JAX contract's list cap)
CULL_MODES = ("nf", "list", "cond")
# The JAX contract's size limits: scenes above MT_SHADE_MAX_TRIS go to the
# streamed kernel (mt_stream.py), whose super-treelets are
# CHUNKS_PER_SUPER chunks, up to MT_STREAM2_MAX_TRIS triangles.
MT_SHADE_MAX_TRIS = 8192
CHUNKS_PER_SUPER = 16
MT_STREAM2_MAX_TRIS = 262144


def _tile_rays(override=None) -> int:
    """Rays per tile: `override`, then TPT_TILE_RAYS, then TILE_RAYS; a
    positive multiple of 128."""
    value = int(override if override is not None
                else os.environ.get("TPT_TILE_RAYS", str(TILE_RAYS)))
    if value <= 0 or value % 128:
        raise ValueError(f"tile_rays must be a positive multiple of 128, got {value}")
    return value


def _cull_mode(override=None) -> str:
    """Culling strategy: `override`, then TPT_CULL, then 'nf'."""
    value = override if override is not None else os.environ.get("TPT_CULL", "nf")
    if value not in CULL_MODES:
        raise ValueError(f"cull must be 'nf', 'list' or 'cond', got {value!r}")
    return value


def _sub_tris(override=None) -> int:
    """Sub-treelet granule: `override`, then TPT_SUB, then SUB_TRIS; a
    positive multiple of 8 dividing CHUNK_TRIS."""
    value = int(override if override is not None else os.environ.get("TPT_SUB", str(SUB_TRIS)))
    if value <= 0 or value % 8 or CHUNK_TRIS % value:
        raise ValueError(
            f"sub must be a positive multiple of 8 dividing {CHUNK_TRIS}, got {value}")
    return value


def _mxu_dets(override=None) -> bool:
    """The MXU-determinant toggle: `override`, then TPT_MXU_DETS, then
    False.  True raises: the option is not ported."""
    on = (bool(override) if override is not None
          else os.environ.get("TPT_MXU_DETS", "0") not in ("0", "false", ""))
    if on:
        raise NotImplementedError(
            "MXU determinants (mxu_dets / TPT_MXU_DETS, `_mt_mxu_block`) are not ported yet "
            "(ROADMAP.md §2, kernel #5)")
    return False


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


def _check_size(n: int) -> None:
    if n > MT_SHADE_MAX_TRIS:
        raise ValueError(
            f"mt_pallas supports <= {MT_SHADE_MAX_TRIS} triangles (got {n}); use 'mt_stream'")


def _pad_scene(tri_pos, sub: int):
    """Triangles padded to a chunk multiple and their coefficient table,
    sub-block-major at `sub`: (tri_padded (Np, 9), cols_rows (4*Np, 10))."""
    n_pad = -(-tri_pos.shape[0] // CHUNK_TRIS) * CHUNK_TRIS
    tri_padded = _pad_to(tri_pos, n_pad, 0)
    return tri_padded, _pack_subblock_major(triangle_columns(tri_padded), sub)


def _prepare(tri_pos, phi_t, tile_rays, sub: int = SUB_TRIS):
    """Padding, coefficient packing and precull shared by the 'nf' kernel
    and its plain version.  Returns (phi_pad, cols_rows, counts, lists,
    emins, tile_rays)."""
    _check_size(tri_pos.shape[0])
    tile_rays = _widened_tile(tile_rays, phi_t.shape[1])
    tri_padded, cols_rows = _pad_scene(tri_pos, sub)
    sub_boxes = treelet_boxes(tri_padded, sub)
    phi_pad = _pad_rays(phi_t, tile_rays)
    counts, lists, emins = _precull_live_subs(sub_boxes, phi_pad, tile_rays)
    return phi_pad, cols_rows, counts, lists, emins, tile_rays


def _prepare_list(tri_pos, phi_t, tile_rays, sub: int = SUB_TRIS):
    """`_prepare` for 'list', which walks the same lists without their
    entry distances: (phi_pad, cols_rows, counts, lists, tile_rays)."""
    phi_pad, cols_rows, counts, lists, _, tile_rays = _prepare(tri_pos, phi_t, tile_rays, sub)
    return phi_pad, cols_rows, counts, lists, tile_rays


def _prepare_cond(tri_pos, phi_t, tile_rays, sub: int = SUB_TRIS):
    """Padding, coefficient packing and boxes for 'cond': no precull, no
    tile widening, chunk boxes at 128 and sub boxes at `sub` straight from
    `treelet_boxes` (padding rows included).  Returns (phi_pad, cols_rows,
    chunk_boxes, sub_boxes, tile_rays)."""
    _check_size(tri_pos.shape[0])
    tile_rays = _tile_rays(tile_rays)
    tri_padded, cols_rows = _pad_scene(tri_pos, sub)
    chunk_boxes = treelet_boxes(tri_padded, CHUNK_TRIS)
    sub_boxes = treelet_boxes(tri_padded, sub)
    return _pad_rays(phi_t, tile_rays), cols_rows, chunk_boxes, sub_boxes, tile_rays


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


def _walk_start(phi_pad, n_tiles: int, tile_rays: int, park: bool = True):
    """Per-tile ray features (T, 10, TR) and the initial best state
    [t, idx, u, v], each (T, TR): with `park`, parked and padding lanes
    start at -INF, every other lane at INF."""
    inf = float(INF)
    phi = phi_pad.reshape(10, n_tiles, tile_rays).permute(1, 0, 2)
    t = torch.full((n_tiles, tile_rays), inf, device=phi_pad.device)
    if park:
        t = torch.where(_parked_lanes(phi[:, 4:7].permute(1, 0, 2)), -inf, t)
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


def _walk_plain(phi_pad, cols_rows, counts, lists, emins, tile_rays: int, stats=None):
    """The 'nf' kernel's walk in torch ops: step j evaluates entry j of
    every tile still walking, then refreshes those tiles' largest live t.
    `stats`, a zeroed (T,) int32 tensor, receives each tile's count of
    evaluated subs."""
    n_tiles, ms = lists.shape
    phi, best = _walk_start(phi_pad, n_tiles, tile_rays)
    coef = cols_rows.reshape(ms, 4, -1, 10)  # (Ms, 4, sub, 10)
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
        if stats is not None:
            stats[tiles] += 1
    return tuple(x.reshape(-1) for x in best)


def _walk_list_plain(phi_pad, cols_rows, counts, lists, tile_rays: int):
    """The 'list' kernel's walk in torch ops: step j evaluates entry j of
    every tile whose list is longer than j; no bound, no break, every lane
    from t = INF."""
    n_tiles, ms = lists.shape
    phi, best = _walk_start(phi_pad, n_tiles, tile_rays, park=False)
    coef = cols_rows.reshape(ms, 4, -1, 10)
    for j in range(ms):
        tiles = (counts > j).nonzero().squeeze(1)
        if tiles.numel() == 0:
            break
        _fold_subs(phi, coef, tiles, lists[tiles, j], best)
    return tuple(x.reshape(-1) for x in best)


def _walk_cond_plain(phi_pad, cols_rows, chunk_boxes, sub_boxes, tile_rays: int, stats=None):
    """The 'cond' kernel's walk in torch ops, vectorised over tiles: the
    tiles with a nonzero ray direction visit chunk c = 0, 1, ... where some
    ray enters the chunk box before its current t, and inside it sub s
    likewise, against t as it stands at that moment.  `stats`, a zeroed
    (T, 2) int32 tensor, receives each tile's walk counts: chunks live,
    subs evaluated."""
    if stats is None:
        stats = torch.zeros((phi_pad.shape[1] // tile_rays, 2), dtype=torch.int32,
                            device=phi_pad.device)
    n_tiles = phi_pad.shape[1] // tile_rays
    n_chunks, n_subs = chunk_boxes.shape[0], sub_boxes.shape[0]
    spc = n_subs // n_chunks
    phi, best = _walk_start(phi_pad, n_tiles, tile_rays, park=False)
    coef = cols_rows.reshape(n_subs, 4, -1, 10)
    ro, rd = phi[:, 1:4], phi[:, 4:7]
    par, inv = _slab_setup(ro, rd)
    t = best[0]
    alive = (rd.abs().sum(dim=(1, 2)) > 0.0).nonzero().squeeze(1)  # the tile-alive gate

    def entries(boxes, tiles):  # (Tc, K, 8) boxes -> (Tc, K, TR)
        return _slab_entries(boxes, ro[tiles], rd[tiles], par[tiles], inv[tiles])

    for c in range(n_chunks):
        if alive.numel() == 0:
            break
        centry = entries(chunk_boxes[c].expand(alive.numel(), 1, 8), alive)[:, 0]
        tc = alive[(centry < t[alive]).any(dim=1)]
        stats[tc, 0] += 1
        if tc.numel() == 0:
            continue
        subs = torch.arange(c * spc, (c + 1) * spc, device=tc.device)
        sub_entry = entries(sub_boxes[subs].expand(tc.numel(), spc, 8), tc)  # (Tc, spc, TR)
        for s in range(spc):
            ts = tc if spc == 1 else tc[(sub_entry[:, s] < t[tc]).any(dim=1)]
            stats[ts, 1] += 1
            _fold_subs(phi, coef, ts, subs[s].expand(ts.numel()), best)
    return tuple(x.reshape(-1) for x in best)


def _walk_cuda(phi_pad, cols_rows, counts, lists, emins, tile_rays: int):
    """Launch the 'nf' kernel of csrc/mt_shade.cu on the current stream;
    outputs (R_pad,) x4."""
    from ... import _build

    lib = _build.load()
    dev = phi_pad.device
    n_tiles, ms = lists.shape
    _check_inputs("mt_nf", (phi_pad, torch.float32), (cols_rows, torch.float32),
                  (counts, torch.int32), (lists, torch.int32), (emins, torch.float32), device=dev)
    out = _outputs(phi_pad.shape[1], dev)
    err = lib.tpt_mt_nf(
        *map(_ptr, (phi_pad, cols_rows, counts, lists, emins, *out)),
        phi_pad.shape[1], tile_rays, n_tiles, ms, cols_rows.shape[0] // (4 * ms), _stream(dev))
    if err:
        raise RuntimeError(f"mt_nf kernel launch failed: {_build.error_string(err)}")
    return out


def _walk_list_cuda(phi_pad, cols_rows, counts, lists, tile_rays: int):
    """Launch the 'list' kernel of csrc/mt_shade.cu; outputs (R_pad,) x4."""
    from ... import _build

    lib = _build.load()
    dev = phi_pad.device
    n_tiles, ms = lists.shape
    _check_inputs("mt_list", (phi_pad, torch.float32), (cols_rows, torch.float32),
                  (counts, torch.int32), (lists, torch.int32), device=dev)
    out = _outputs(phi_pad.shape[1], dev)
    err = lib.tpt_mt_list(
        *map(_ptr, (phi_pad, cols_rows, counts, lists, *out)),
        phi_pad.shape[1], tile_rays, n_tiles, ms, cols_rows.shape[0] // (4 * ms), _stream(dev))
    if err:
        raise RuntimeError(f"mt_list kernel launch failed: {_build.error_string(err)}")
    return out


def _walk_cond_cuda(phi_pad, cols_rows, chunk_boxes, sub_boxes, tile_rays: int, stats=None):
    """Launch the 'cond' kernel of csrc/mt_shade.cu; outputs (R_pad,) x4.
    `stats`, if given, a (T, 2) int32 tensor, receives the walk counts."""
    from ... import _build

    lib = _build.load()
    dev = phi_pad.device
    n_tiles = phi_pad.shape[1] // tile_rays
    n_chunks, n_subs = chunk_boxes.shape[0], sub_boxes.shape[0]
    _check_inputs("mt_cond", (phi_pad, torch.float32), (cols_rows, torch.float32),
                  (chunk_boxes, torch.float32), (sub_boxes, torch.float32), device=dev)
    if (cols_rows.shape != (4 * n_chunks * CHUNK_TRIS, 10) or cols_rows.data_ptr() % 16
            or n_subs % n_chunks):
        raise ValueError("mt_cond kernel: coefficient table and boxes do not match")
    if stats is not None:
        _check_inputs("mt_cond", (stats, torch.int32), device=dev)
        if stats.shape != (n_tiles, 2):
            raise ValueError("mt_cond kernel: walk stats must be a (T, 2) int32 tensor")
    out = _outputs(phi_pad.shape[1], dev)
    err = lib.tpt_mt_cond(
        *map(_ptr, (phi_pad, cols_rows, chunk_boxes, sub_boxes, *out, stats)),
        phi_pad.shape[1], tile_rays, n_tiles, n_chunks, CHUNK_TRIS * n_chunks // n_subs,
        _stream(dev))
    if err:
        raise RuntimeError(f"mt_cond kernel launch failed: {_build.error_string(err)}")
    return out


def _intersect(tri_pos, phi_t, tile_rays, walk, prepare=_prepare, **prep_kw) -> Hit:
    r = phi_t.shape[1]
    if tri_pos.shape[0] == 0 or r == 0:
        return miss_hit(r, phi_t.device)
    t, idx, u, v = walk(*prepare(tri_pos, phi_t, tile_rays, **prep_kw))
    idx = idx[:r]
    return Hit(idx >= 0, t[:r], idx, u[:r], v[:r])


def mt_intersect_nf_phi_plain(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """Plain PyTorch version of the 'nf' MT kernel, on any device.
    tri_pos: (N, 9) packed rows; phi_t: (10, R) ray features."""
    return _intersect(tri_pos, phi_t, tile_rays, _walk_plain, sub=_sub_tris(sub))


def mt_intersect_nf_phi(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """Near-to-far MT intersection of (10, R) ray features against (N, 9)
    packed triangle rows; returns `Hit` (t is INF on a miss, -INF on a
    parked lane).  A CUDA tensor launches the kernel (and counts the launch
    in `mt_intersect_nf_phi.launches`); a CPU tensor runs the plain version."""
    if not _launches_kernel(phi_t):
        return mt_intersect_nf_phi_plain(tri_pos, phi_t, tile_rays=tile_rays, sub=sub)
    return _intersect(tri_pos, phi_t, tile_rays, _counted(mt_intersect_nf_phi, _walk_cuda),
                      sub=_sub_tris(sub))


mt_intersect_nf_phi.launches = 0


def mt_intersect_list_phi_plain(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """Plain PyTorch version of the 'list' MT kernel, on any device."""
    return _intersect(tri_pos, phi_t, tile_rays, _walk_list_plain, _prepare_list,
                      sub=_sub_tris(sub))


def mt_intersect_list_phi(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """MT intersection through each tile's whole precull list, in list
    order; returns `Hit`.  A CUDA tensor launches the kernel (counted in
    `mt_intersect_list_phi.launches`); a CPU tensor runs the plain version."""
    if not _launches_kernel(phi_t):
        return mt_intersect_list_phi_plain(tri_pos, phi_t, tile_rays=tile_rays, sub=sub)
    return _intersect(tri_pos, phi_t, tile_rays,
                      _counted(mt_intersect_list_phi, _walk_list_cuda), _prepare_list,
                      sub=_sub_tris(sub))


mt_intersect_list_phi.launches = 0


def mt_intersect_cond_phi_plain(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """Plain PyTorch version of the 'cond' MT kernel, on any device."""
    return _intersect(tri_pos, phi_t, tile_rays, _walk_cond_plain, _prepare_cond,
                      sub=_sub_tris(sub))


def mt_intersect_cond_phi(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """MT intersection with in-kernel two-level culling over all chunks;
    returns `Hit`.  A CUDA tensor launches the kernel (counted in
    `mt_intersect_cond_phi.launches`); a CPU tensor runs the plain version."""
    if not _launches_kernel(phi_t):
        return mt_intersect_cond_phi_plain(tri_pos, phi_t, tile_rays=tile_rays, sub=sub)
    return _intersect(tri_pos, phi_t, tile_rays,
                      _counted(mt_intersect_cond_phi, _walk_cond_cuda), _prepare_cond,
                      sub=_sub_tris(sub))


mt_intersect_cond_phi.launches = 0


def cond_walk_stats(tri_pos, phi_t, *, tile_rays=None, sub=None, plain: bool = False):
    """Per-tile walk counts of the 'cond' kernel (or, with `plain=True` or
    a CPU tensor, of its plain version) on these inputs: (T, 2) int32,
    [chunks live, subs evaluated].  Kernel and plain version must agree on
    them exactly.  Launches made here are not counted."""
    prep = _prepare_cond(tri_pos, phi_t, tile_rays, _sub_tris(sub))
    stats = torch.zeros((prep[0].shape[1] // prep[-1], 2), dtype=torch.int32,
                        device=phi_t.device)
    walk = _walk_cond_plain if plain or phi_t.device.type == "cpu" else _walk_cond_cuda
    walk(*prep, stats=stats)
    return stats


_ROUTES = {
    "nf": (mt_intersect_nf_phi, mt_intersect_nf_phi_plain),
    "list": (mt_intersect_list_phi, mt_intersect_list_phi_plain),
    "cond": (mt_intersect_cond_phi, mt_intersect_cond_phi_plain),
}


def _pallas2(plain: bool, tri_pos, phi_t, tile_rays, cull, sub, mxu_dets) -> Hit:
    tile_rays = _tile_rays(tile_rays)
    _mxu_dets(mxu_dets)
    kernel, plain_fn = _ROUTES[_cull_mode(cull)]
    return (plain_fn if plain else kernel)(tri_pos, phi_t, tile_rays=tile_rays,
                                           sub=_sub_tris(sub))


def mt_intersect_pallas2_phi(tri_pos, phi_t, *, tile_rays=None, cull=None, sub=None,
                             mxu_dets=None) -> Hit:
    """Whole-scene MT intersection of (10, R) ray features against (N, 9)
    packed triangle rows through the kernel `cull` selects ('nf', 'list'
    or 'cond'; see the module docstring for how each option resolves)."""
    return _pallas2(False, tri_pos, phi_t, tile_rays, cull, sub, mxu_dets)


def mt_intersect_pallas2_phi_plain(tri_pos, phi_t, *, tile_rays=None, cull=None, sub=None,
                                   mxu_dets=None) -> Hit:
    """`mt_intersect_pallas2_phi` through the plain versions, on any device."""
    return _pallas2(True, tri_pos, phi_t, tile_rays, cull, sub, mxu_dets)


def mt_intersect_pallas2(tri_pos, ro, rd, *, tile_rays=None, cull=None, sub=None,
                         mxu_dets=None) -> Hit:
    """`mt_intersect_pallas2_phi` on (R, 3) ray origins and directions."""
    return mt_intersect_pallas2_phi(tri_pos, ray_features(ro, rd).T.contiguous(),
                                    tile_rays=tile_rays, cull=cull, sub=sub, mxu_dets=mxu_dets)


def mt_intersect_pallas2_plain(tri_pos, ro, rd, *, tile_rays=None, cull=None, sub=None,
                               mxu_dets=None) -> Hit:
    """`mt_intersect_pallas2` through the plain versions, on any device."""
    return mt_intersect_pallas2_phi_plain(tri_pos, ray_features(ro, rd).T.contiguous(),
                                          tile_rays=tile_rays, cull=cull, sub=sub,
                                          mxu_dets=mxu_dets)
