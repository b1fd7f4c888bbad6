"""Round-2 fused Möller–Trumbore intersection with one level of treelet
culling: the wrappers, their plain PyTorch versions, the CUDA kernels'
bindings, and the helpers the other MT kernel modules share.

Replaces the two TPU kernels of tpu_pathtracer/ops/pallas/mt_intersect.py:

  * `_kernel` behind `mt_intersect_pallas` (N <= 8,192): the coefficient
    table is read from device memory chunk by chunk;
  * `_kernel_stream` behind `mt_intersect_stream` (N <= 131,072): the same
    walk over a chunk-major table, each chunk copied ahead of its use.

On the H100 both launch one Hopper walk (csrc/r2_walk.cu) on the table
`_pack_walk_table` packs from either layout (20 floats a triangle, in
triangle order): what split the TPU kernels was VMEM against HBM, and the
whole 131,072-triangle table fits the H100's L2.  The entries keep their
own caps, errors and launch counters.

The contract is the JAX wrappers':

  * chunks of min(128, max(8, ceil(N/8)*8)) triangles; triangles pad with
    zero rows (never hit) to a chunk multiple; one box per chunk from
    `treelet_boxes`, padding rows included;
  * phi = [1, ro, rd, ro x rd] per ray, padded with 1e30 in all ten rows
    to a multiple of TILE_RAYS rays;
  * per 1,024-ray tile, chunks in ascending order: a chunk is evaluated
    only if some lane of the tile (padding lanes included) enters its box
    before its current best t.  Every lane starts at t = INF;
  * the round-2 epilogue: f = 1/a where |a| >= EPSILON (else 1), t = ta*f,
    valid = |a| >= EPSILON, 0 <= u*a*sign(a) <= |a|, v*a*sign(a) >= 0, their
    sum <= |a|, and t > EPSILON (the divided form; the near-to-far kernels
    test ts > EPSILON*|a|, so the two may differ on borderline t).  The
    winner's u = ua*f and v = va*f;
  * the lowest row of a chunk's smallest t wins the chunk, and it replaces
    the best only if strictly nearer, so the lowest triangle index wins
    exact-t ties;
  * an empty scene misses everywhere; past each cap, JAX's ValueError.

`mt_intersect_pallas` and `mt_intersect_stream` launch the CUDA kernel for
CUDA tensors (counting launches in `.launches`) and run their plain
versions for CPU tensors.  The plain versions make the same decisions in
the same order with the same elementwise arithmetic, vectorised over
tiles, so kernel and plain version agree bit for bit, and so do their
per-tile walk counts (`walk_stats`): chunks evaluated, and chunks copied
into shared memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..mt_matmul import (FEATS, Hit, determinants, miss_hit, nearest, ray_features,
                         triangle_columns)
from ..vecmath import EPSILON, INF

TILE_RAYS = 1024  # rays per tile (one cluster of CTAs)
CHUNK_TRIS = 128  # the culling granule
MT_PALLAS_MAX_TRIS = 8192
MT_STREAM_MAX_TRIS = 131072
R2_GROUP = 32  # chunks one decision of the Hopper walk covers (csrc/r2_walk.cu kGroup)
_TILES_PER_FOLD = 32  # tiles evaluated together by the plain walk (bounds its memory)


# --- helpers shared with mt_shade.py and mt_stream.py -------------------------


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


def _check_inputs(what, *pairs, device):
    for x, dt in pairs:
        if x.dtype != dt or not x.is_contiguous() or x.device != device:
            raise ValueError(f"{what} kernel: bad input dtype, layout or device")


def _outputs(r_pad: int, device):
    t = torch.empty((r_pad,), dtype=torch.float32, device=device)
    return t, torch.empty((r_pad,), dtype=torch.int32, device=device), torch.empty_like(t), \
        torch.empty_like(t)


def _ptr(x):
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _counted(wrapper, walk):
    """`walk`, counting each call that launched (returned) in
    `wrapper.launches`."""
    def launch(*args, **kw):
        out = walk(*args, **kw)
        wrapper.launches += 1
        return out

    return launch


# (quantity, feature) coefficients a pair uses, in FEATS order (a: 4-6;
# ua, va: 4-9; ta: 0-3), then one zero: 20 floats, five float4 loads.
WALK_TABLE = tuple((q, k) for q, ks in enumerate(FEATS) for k in ks)
WALK_TABLE_FLOATS = 20


@functools.lru_cache(maxsize=16)
def _walk_table_index(n: int, sub: int, device: torch.device):
    """Flat indices into the (4*Np, 10) sub-block-major rows at `sub` of
    the walk table's first 19 columns for Np = n triangles: (n, 19), built
    once per shape and device."""
    tri = torch.arange(n)[:, None]
    q = torch.tensor([q for q, _ in WALK_TABLE])
    k = torch.tensor([k for _, k in WALK_TABLE])
    return ((tri // sub * 4 * sub + q * sub + tri % sub) * 10 + k).to(device)


def _pack_walk_table(cols_rows, sub: int):
    """(4*Np, 10) sub-block-major rows -> the Hopper walks' (Np, 20) table,
    in triangle order (so a sub-treelet or a chunk stays one contiguous
    block), the last column zero."""
    n = cols_rows.shape[0] // 4
    table = cols_rows.new_zeros((n, WALK_TABLE_FLOATS))
    table[:, :len(WALK_TABLE)] = cols_rows.reshape(-1)[_walk_table_index(n, sub, cols_rows.device)]
    return table


def _launches_kernel(x) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); other devices raise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise NotImplementedError(f"no MT kernel for device {x.device}")
    return True


# --- the round-2 kernels -------------------------------------------------------


def _chunk_tris(n: int) -> int:
    return min(CHUNK_TRIS, max(8, -(-n // 8) * 8))


def _check_size(n: int, stream: bool) -> None:
    if stream and n > MT_STREAM_MAX_TRIS:
        raise ValueError(
            f"mt_stream's cull table scales with N/{CHUNK_TRIS} and supports "
            f"<= {MT_STREAM_MAX_TRIS} triangles (got {n}); use 'bvh8'")
    if not stream and n > MT_PALLAS_MAX_TRIS:
        raise ValueError(
            f"mt_pallas holds the whole scene in VMEM and supports <= {MT_PALLAS_MAX_TRIS} "
            f"triangles (got {n}); use intersector='bvh8' (the auto default for large scenes) "
            "or 'mt'")


def _prepare(tri_pos, ro, rd, stream: bool):
    """Padding, coefficient layout, chunk boxes and ray features, shared by
    each kernel and its plain version: (phi_pad (10, Rp), rows, boxes (M, 8),
    chunk).  `rows` is quantity-major (4*Np, 10) for `mt_intersect_pallas`
    (row q*Np + j holds quantity q of triangle j) and chunk-major (M, 4*C,
    10) for `mt_intersect_stream`; the same values either way."""
    n = tri_pos.shape[0]
    _check_size(n, stream)
    chunk = _chunk_tris(n)
    n_pad = -(-n // chunk) * chunk
    tri_padded = _pad_to(tri_pos, n_pad, 0)
    coef = triangle_columns(tri_padded).permute(1, 2, 0)  # (4, Np, 10)
    if stream:
        rows = coef.reshape(4, n_pad // chunk, chunk, 10).permute(1, 0, 2, 3).reshape(
            n_pad // chunk, 4 * chunk, 10).contiguous()
    else:
        rows = coef.reshape(4 * n_pad, 10).contiguous()
    r_pad = -(-ro.shape[0] // TILE_RAYS) * TILE_RAYS
    phi_pad = _pad_to(ray_features(ro, rd).T, r_pad, 1, value=1e30).contiguous()
    return phi_pad, rows, treelet_boxes(tri_padded, chunk), chunk


def _epilogue_r2(a, ua, va, ta):
    """The round-2 epilogue on (..., C, R) determinants: (t, u, v) per pair,
    t = INF where invalid (validity by the divided form t > EPSILON)."""
    abs_a = torch.abs(a)
    sa = torch.sign(a)
    us = ua * sa
    vs = va * sa
    ok_a = abs_a >= float(EPSILON)
    f = 1.0 / torch.where(ok_a, a, torch.ones_like(a))
    t_raw = ta * f
    valid = ok_a & (us >= 0.0) & (us <= abs_a) & (vs >= 0.0) & (us + vs <= abs_a) & (
        t_raw > float(EPSILON))
    return torch.where(valid, t_raw, torch.full_like(a, float(INF))), ua * f, va * f


def _walk_plain(phi_pad, rows, boxes, chunk: int, stream: bool, stats=None):
    """The kernels' walk in torch ops, vectorised over tiles.  For chunk
    c = 0, 1, ...: every tile in which some lane enters box c before its
    current t evaluates the chunk and keeps its winner where strictly
    nearer.  `stats`, a zeroed (T, 2) int32 tensor, receives each tile's
    walk counts: chunks evaluated, and chunks copied into shared memory by
    csrc/r2_walk.cu (both entries): an evaluated chunk is copied unless it
    is the chunk prefetched after the tile's previous one; after taking
    chunk c the walk prefetches the lowest chunk after c in c's group of
    R2_GROUP that some lane enters before its t as it stands before chunk
    c, if there is one."""
    inf = float(INF)
    n_tiles = phi_pad.shape[1] // TILE_RAYS
    n_chunks = boxes.shape[0]
    counting = stats is not None
    coef = rows.reshape(n_chunks, 4, chunk, 10) if stream else rows.reshape(
        4, n_chunks, chunk, 10).permute(1, 0, 2, 3)
    phi = phi_pad.reshape(10, n_tiles, TILE_RAYS).permute(1, 0, 2)  # (T, 10, TR)
    ro, rd = phi[:, 1:4], phi[:, 4:7]
    par, inv = _slab_setup(ro, rd)
    t = torch.full((n_tiles, TILE_RAYS), inf, device=phi.device)
    idx = torch.full_like(t, -1, dtype=torch.int32)
    u, v = torch.zeros_like(t), torch.zeros_like(t)
    groups = {}  # (T, G, TR) entry distances of every lane into a group's boxes

    def group(g):
        if g not in groups:
            for old in [k for k in groups if k < g - 1]:
                del groups[old]
            gb = boxes[g * R2_GROUP:(g + 1) * R2_GROUP]
            groups[g] = _slab_entries(gb.expand(n_tiles, *gb.shape), ro, rd, par, inv)
        return groups[g]

    def entries(c):  # (T, TR)
        return group(c // R2_GROUP)[:, c % R2_GROUP]

    prefetched = torch.full((n_tiles,), -1, dtype=torch.int64, device=phi.device)
    for c in range(n_chunks):
        tiles = (entries(c) < t).any(dim=1).nonzero().squeeze(1)
        if counting:
            stats[tiles, 0] += 1
            if tiles.numel():
                took = (prefetched[tiles] != c).to(torch.int32)
                ahead = group(c // R2_GROUP)[tiles, c % R2_GROUP + 1:]  # (Tl, K, TR)
                # a zero column first: argmax finds the lowest candidate, 0 none
                cand = torch.cat([torch.zeros((tiles.numel(), 1), dtype=torch.bool,
                                              device=t.device),
                                  (ahead < t[tiles, None, :]).any(dim=2)], dim=1)
                first = cand.to(torch.int32).argmax(dim=1)
                prefetched[tiles] = torch.where(first > 0, first + c, -1)
                stats[tiles, 1] += took + (first > 0).to(torch.int32)
        for g in range(0, tiles.numel(), _TILES_PER_FOLD):
            tg = tiles[g:g + _TILES_PER_FOLD]
            tt, uu, vv = _epilogue_r2(*determinants(phi[tg], coef[c]))  # (Tg, C, TR)
            tmin, imin, u_w, v_w = nearest(tt, uu, vv, c * chunk)
            take = tmin < t[tg]
            t[tg] = torch.where(take, tmin, t[tg])
            idx[tg] = torch.where(take, imin, idx[tg])
            # + 0.0: the TPU kernel sums the winner's u over the chunk's rows,
            # all others 0.0, which turns a -0.0 into +0.0
            u[tg] = torch.where(take, u_w + 0.0, u[tg])
            v[tg] = torch.where(take, v_w + 0.0, v[tg])
    return tuple(x.reshape(-1) for x in (t, idx, u, v))


def _r2_table(rows, chunk: int, stream: bool):
    """The Hopper walk's table (`_pack_walk_table`, (Np, 20)) of `_prepare`'s
    rows: the quantity-major rows of `mt_intersect_pallas` are one
    sub-block of all Np triangles, the chunk-major rows of
    `mt_intersect_stream` sub-blocks of `chunk`; both give the same table."""
    flat = rows.reshape(-1, 10)
    return _pack_walk_table(flat, chunk if stream else flat.shape[0] // 4)


def _walk_cuda(phi_pad, rows, boxes, chunk: int, stream: bool, stats=None):
    """Launch the Hopper walk (csrc/r2_walk.cu) on the table `_r2_table`
    packs from `rows`, on the current stream; outputs (R_pad,) x4.
    `stats`, if given, a (T, 2) int32 tensor, receives the walk counts."""
    return _walk_table_cuda(phi_pad, _r2_table(rows, chunk, stream), boxes, chunk, stream, stats)


def _walk_table_cuda(phi_pad, table, boxes, chunk: int, stream: bool, stats=None):
    """Launch csrc/r2_walk.cu on its (Np, 20) table.  Raises before the
    launch on inputs that do not match."""
    from ... import _build

    lib = _build.load()
    dev = phi_pad.device
    what = "mt_stream_r2" if stream else "mt_pallas_r2"
    _check_inputs(what, (phi_pad, torch.float32), (table, torch.float32),
                  (boxes, torch.float32), device=dev)
    n_tiles, n_chunks = phi_pad.shape[1] // TILE_RAYS, boxes.shape[0]
    if table.shape != (n_chunks * chunk, WALK_TABLE_FLOATS) or table.data_ptr() % 16 \
            or boxes.shape != (n_chunks, 8) or boxes.data_ptr() % 16 \
            or chunk % 8 or not 0 < chunk <= CHUNK_TRIS or n_tiles == 0 \
            or phi_pad.shape != (10, n_tiles * TILE_RAYS):
        raise ValueError(f"{what} kernel: the table must be `_pack_walk_table`'s (Np, 20) rows "
                         f"of chunks of 8-{CHUNK_TRIS} (16-byte aligned, as the boxes), the rays "
                         f"whole {TILE_RAYS}-ray tiles")
    if stats is not None:
        _check_inputs(what, (stats, torch.int32), device=dev)
        if stats.shape != (n_tiles, 2):
            raise ValueError(f"{what} kernel: walk stats must be a (T, 2) int32 tensor")
    out = _outputs(phi_pad.shape[1], dev)
    err = lib.tpt_mt_r2_walk(*map(_ptr, (phi_pad, table, boxes, *out, stats)), phi_pad.shape[1],
                             n_chunks, chunk, _stream(dev))
    if err:
        raise RuntimeError(f"{what} kernel launch failed: {_build.error_string(err)}")
    return out


def _intersect(tri_pos, ro, rd, stream: bool, walk) -> Hit:
    r = ro.shape[0]
    if tri_pos.shape[0] == 0:
        return miss_hit(r, ro.device)
    phi_pad, rows, boxes, chunk = _prepare(tri_pos, ro, rd, stream)
    t, idx, u, v = walk(phi_pad, rows, boxes, chunk, stream)
    idx = idx[:r]
    return Hit(idx >= 0, t[:r], idx, u[:r], v[:r])


def mt_intersect_pallas_plain(tri_pos, ro, rd) -> Hit:
    """Plain PyTorch version of the whole-scene round-2 kernel, on any
    device.  tri_pos: (N, 9) packed rows; ro, rd: (R, 3)."""
    return _intersect(tri_pos, ro, rd, False, _walk_plain)


def mt_intersect_pallas(tri_pos, ro, rd) -> Hit:
    """Round-2 MT intersection with chunk culling of (R, 3) rays against
    (N, 9) packed triangle rows, N <= 8,192; returns `Hit` (t is INF on a
    miss).  A CUDA tensor launches the kernel (counted in
    `mt_intersect_pallas.launches`); a CPU tensor runs the plain version."""
    if not _launches_kernel(ro):
        return mt_intersect_pallas_plain(tri_pos, ro, rd)
    return _intersect(tri_pos, ro, rd, False, _counted(mt_intersect_pallas, _walk_cuda))


mt_intersect_pallas.launches = 0


def mt_intersect_stream_plain(tri_pos, ro, rd) -> Hit:
    """Plain PyTorch version of the streamed round-2 kernel, on any device."""
    return _intersect(tri_pos, ro, rd, True, _walk_plain)


def mt_intersect_stream(tri_pos, ro, rd) -> Hit:
    """`mt_intersect_pallas`'s walk over a chunk-major table with chunks
    copied ahead of their use, N <= 131,072; returns `Hit`.  A CUDA tensor
    launches the kernel (counted in `mt_intersect_stream.launches`); a CPU
    tensor runs the plain version."""
    if not _launches_kernel(ro):
        return mt_intersect_stream_plain(tri_pos, ro, rd)
    return _intersect(tri_pos, ro, rd, True, _counted(mt_intersect_stream, _walk_cuda))


mt_intersect_stream.launches = 0


def walk_stats(tri_pos, ro, rd, *, stream: bool, plain: bool = False):
    """Per-tile walk counts of a round-2 entry (`stream`) on these inputs:
    (T, 2) int32, [chunks evaluated, chunks copied]; with `plain=True` or a
    CPU tensor, of the plain walk.  Kernel and plain walk must agree on them
    exactly.  Tiles are independent, so the rays of whole tiles (a multiple
    of TILE_RAYS from a tile boundary) give those tiles' counts.  Launches
    made here are not counted."""
    phi_pad, rows, boxes, chunk = _prepare(tri_pos, ro, rd, stream)
    stats = torch.zeros((phi_pad.shape[1] // TILE_RAYS, 2), dtype=torch.int32,
                        device=ro.device)
    if plain or not _launches_kernel(ro):
        _walk_plain(phi_pad, rows, boxes, chunk, stream, stats=stats)
    else:
        _walk_cuda(phi_pad, rows, boxes, chunk, stream, stats=stats)
    return stats
