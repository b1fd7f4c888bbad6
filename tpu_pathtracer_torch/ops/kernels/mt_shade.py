"""Whole-scene Möller–Trumbore intersection (up to 8,192 triangles): the
wrappers, their plain PyTorch versions and the CUDA kernels' bindings.

Replaces the three culling variants of tpu_pathtracer/ops/pallas/mt_shade.py
that `mt_intersect_pallas2_phi` dispatches to, with the JAX wrapper's
contract:

  * `_cull_mode`: 'nf' (`_kernel_nf`, the default), 'list' (`_kernel_list`)
    or 'cond' (`_kernel`); `_sub_tris`: the sub-treelet granule, a positive
    multiple of 8 dividing 128 (default 64); `_tile_rays`: rays per tile, a
    positive multiple of 128 (default 512); `_mxu_dets`: the determinants
    of a sub-treelet as one matrix product (`_mt_mxu_block`) instead of the
    term loop (default off).  Each is an explicit argument, then an
    environment variable (TPT_CULL, TPT_SUB, TPT_TILE_RAYS, TPT_MXU_DETS),
    then the default;
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
kernel for a CUDA tensor, counting the launch in its `.launches`, and runs
its plain version for a CPU tensor.  The plain versions walk the same
lists, chunks and subs in the same order, vectorised over tiles, with the
same elementwise arithmetic, so kernel and plain version agree bit for bit.
The kernels are the Hopper walks of csrc/nf_walk.cu ('nf' and 'list')
and csrc/cond_walk.cu ('cond'), which read their own coefficient table
(`_pack_walk_table`: 20 floats a triangle) and write per-tile walk counts
on request (`nf_walk_stats`, `cond_walk_stats`).  The first designs of
'list' and 'cond' stay in csrc/mt_shade.cu as `tpt_mt_list_v1` and
`tpt_mt_cond_v1`, launched only by `_walk_list_cuda_v1` and
`_walk_cond_cuda_v1`, for comparison.

The MXU variants (`mt_intersect_{nf,list,cond}_mxu_phi`, kernel #5) walk
the same way.  Their plain versions take each sub-treelet's determinants
as one float32 `torch.matmul` of its (4*sub, 10) coefficient rows against
phi (10, TR), TF32 off; their kernels (csrc/mxu_walk.cu) as 3xTF32
tensor-core products against a table the wrapper splits into TF32 hi and
lo halves in the `mma.sync` fragment order (`_pack_mxu_table`).  The two
sum in different orders, so they agree to float32 rounding, not bit for
bit: `hit_agreement` counts the lanes that differ and checks that each is
a near-tie, lies on a triangle's edge or is decided by the EPSILON test's
rounding.  Their first designs stay in csrc/mt_shade.cu as
`tpt_mt_{nf,list,cond}_mxu_v1` on the `_pack_mma` table, launched only by
`_walk_mxu_cuda_v1`, for comparison.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os

import torch

from ...utils import spans
from ..mt_matmul import (Hit, determinants, epilogue, miss_hit, nearest, ray_features,
                         triangle_columns)
from ..vecmath import EPSILON, INF
from .mt_intersect import (
    WALK_TABLE,
    WALK_TABLE_FLOATS,
    _check_inputs,
    _counted,
    _launches_kernel,
    _outputs,
    _pack_walk_table,
    _pad_to,
    _ptr,
    _slab_entries,
    _slab_setup,
    _stream,
    _walk_table_index,
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
    """The MXU-determinant toggle: `override`, then TPT_MXU_DETS (any value
    but '0', 'false' and '' turns it on), then False."""
    if override is not None:
        return bool(override)
    return os.environ.get("TPT_MXU_DETS", "0") not in ("0", "false", "")


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
    with spans.sync(boxes.is_cuda):  # the row is copied from host memory
        out[first_dead:] = torch.tensor([inf] * 3 + [-inf] * 3 + [0.0, 0.0], device=boxes.device)
    return out


def _pack_subblock_major(cols, sub: int):
    """(10, 4, Np) coefficients -> (4*Np, 10) sub-block-major rows: row
    b*4*sub + q*sub + i holds quantity q of triangle b*sub + i, so one
    contiguous (4*sub, 10) block per sub-treelet."""
    n = cols.shape[2]
    qs = cols.permute(1, 2, 0)  # (4, Np, 10)
    return qs.reshape(4, n // sub, sub, 10).permute(1, 0, 2, 3).reshape(4 * n, 10).contiguous()


@functools.lru_cache(maxsize=16)
def _mma_index(n: int, sub: int, device: torch.device):
    """Where each value of the `mma.sync` fragment table of Np = n triangles
    at `sub` comes from, as flat indices into the sub-block-major rows padded
    to 16 features; built once per shape and device.  For register j (16)
    of lane l (32) of 8-triangle group G: quantity q, triangle 8G + l // 4
    and feature k.  The first m16n8k8 tile holds a (rows 0-7) and ua (rows
    8-15) of the group's triangles, the second va and ta, so the C fragment
    of lane l holds all four of triangle l // 4; register j is A register
    j % 4 of k-step (j // 4) % 2 of tile j // 8, row l // 4 + 8 * (j % 2),
    column l % 4 + 4 * ((j // 2) % 2)."""
    j = torch.arange(16)[:, None]
    lane = torch.arange(32)[None, :]
    q = 2 * (j // 8) + j % 2
    k = lane % 4 + 4 * ((j // 2) % 2) + 8 * ((j // 4) % 2)
    tri = torch.arange(0, n, 8)[:, None, None] + lane // 4  # (Np/8, 1, 32)
    row = tri // sub * 4 * sub + q * sub + tri % sub  # (Np/8, 16, 32)
    return (row * 16 + k).reshape(-1).to(device)


def _pack_mma(cols_rows, sub: int):
    """(4*Np, 10) sub-block-major rows -> the MXU kernels' (4*Np, 16) table:
    per 8-triangle group, in triangle order, 16 registers x 32 lanes of the
    tf32 `mma.sync` A fragments (`_mma_index`), features padded to 16 with
    zeros.  A sub-treelet is a contiguous block of sub/8 groups."""
    n = cols_rows.shape[0] // 4
    padded = torch.nn.functional.pad(cols_rows, (0, 6)).reshape(-1)
    return padded[_mma_index(n, sub, cols_rows.device)].reshape(4 * n, 16)


# The Hopper walks' coefficient table (csrc/walk.cuh): per triangle, the
def _tf32(x):
    """x rounded to TF32 as `cvt.rna.tf32.f32` rounds it: to nearest, ties
    away from zero, keeping 10 mantissa bits; the low 13 bits zero.  The
    sign-magnitude bit pattern plus half a TF32 unit, truncated, is that
    rounding, subnormals and overflow to inf included.  NaN stays NaN."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (bits + 0x1000) & 0xFFFFE000
    rounded = torch.where(torch.isnan(x), bits, rounded)
    return (rounded - ((rounded >> 31) << 32)).to(torch.int32).view(torch.float32)


def _tf32_split(x):
    """(hi, lo) = (tf32(x), tf32(x - hi)): the 3xTF32 halves of float32 x,
    hi + lo within 2^-22 of x (relative; normal numbers)."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


# The MXU walks' table (csrc/mxu_walk.cu): per 8-triangle group, five float4
# of `mma.sync` B fragments for each of 32 lanes, 80 floats a triangle.  K
# position p of the product holds feature MXU_K[p] (zero past 9), so a, ua
# and va fall in k-step 0 (positions 0-7) and ta in both.
MXU_K = (4, 5, 6, 7, 8, 9, 0, 1, 2, 3)
MXU_TABLE_FLOATS = 80
# The widest tile the MXU walks place (csrc/mxu_walk.cu `kept_list`,
# `kept_cond`): a cluster of 8 CTAs of 16 warps of 4 m-tiles of 16 rays
# (cond: 16 CTAs of 2 m-tiles).
MXU_MAX_TILE_RAYS = 8 * 16 * 4 * 16


@functools.lru_cache(maxsize=16)
def _mxu_table_index(n: int, sub: int, device: torch.device):
    """Where each float of the MXU table of Np = n triangles at `sub` comes
    from, as (flat indices into the (4*Np, 11) sub-block-major rows with a
    zero column 10 appended, whether it takes the lo half); built once per
    shape and device.  Float w of float4 v of lane l = 4g + tig of group G
    is a B register of triangle 8G + g: for v < 4, quantity
    (4*(v % 2) + w) // 2, register w % 2 (K position tig + 4*(w % 2)), the
    hi half for v < 2 and the lo half for v = 2, 3; float4 4 holds hi and
    lo of ta's k-step-1 register (K position 8 + tig), then two zeros."""
    v = torch.arange(5)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    w = torch.arange(4)[None, None, :]
    g, tig = lane // 4, lane % 4
    q = torch.where(v < 4, (4 * (v % 2) + w) // 2, 3)
    pos = torch.where(v < 4, tig + 4 * (w % 2), torch.where(w < 2, 8 + tig, 16))
    k_of = torch.tensor(MXU_K + (10,) * 7)  # K position -> feature (10: the zero column)
    k = k_of[pos]
    lo = torch.where(v < 4, v >= 2, w == 1).expand(5, 32, 4)
    tri = torch.arange(0, n, 8)[:, None, None, None] + g  # (Np/8, 1, 32, 1)
    row = tri // sub * 4 * sub + q * sub + tri % sub  # (Np/8, 5, 32, 4)
    index = (row * 11 + k).reshape(-1)
    return index.to(device), lo.expand(n // 8, 5, 32, 4).reshape(-1).to(device)


def _pack_mxu_table(cols_rows, sub: int):
    """(4*Np, 10) sub-block-major rows -> the MXU walks' (Np, 80) table:
    per 8-triangle group, in triangle order, the TF32 hi and lo halves of
    each lane's `mma.sync` B fragments (`_mxu_table_index`), so that a
    sub-treelet or a chunk is one contiguous block the walks copy as it
    is."""
    n = cols_rows.shape[0] // 4
    index, lo = _mxu_table_index(n, sub, cols_rows.device)
    x = torch.nn.functional.pad(cols_rows, (0, 1)).reshape(-1)[index]
    hi, low = _tf32_split(x)
    return torch.where(lo, low, hi).reshape(n, MXU_TABLE_FLOATS)


@contextlib.contextmanager
def _full_fp32():
    """Float32 matrix products without TF32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _mxu_determinants(phi, coef):
    """`determinants` as `_mt_mxu_block` forms them: one float32 matrix
    product per sub-treelet of its (4*sub, 10) coefficient rows against phi,
    TF32 off.  phi: (Tc, 10, TR); coef: (Tc, 4, sub, 10)."""
    tc, _, sub, _ = coef.shape
    with _full_fp32():
        d = torch.matmul(coef.reshape(tc, 4 * sub, 10), phi)  # (Tc, 4*sub, TR)
    return list(d.split(sub, dim=1))


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
    with spans.span("walk.precull"):
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


def _fold_subs(phi, coef, tiles, subs, best, mxu: bool = False, tiles_per_chunk: int = 128):
    """Evaluate sub-treelet subs[i] against every ray of tile tiles[i] and
    fold its nearest hit into `best` in place with the kernels' take rule
    (exact-t ties to the lower index).  coef: (Ms, 4, sub, 10); `mxu` forms
    the determinants as one matrix product per sub-treelet."""
    inf = float(INF)
    t, idx, u, v = best
    sub = coef.shape[2]
    dets = _mxu_determinants if mxu else determinants
    for c0 in range(0, tiles.numel(), tiles_per_chunk):
        tc = tiles[c0:c0 + tiles_per_chunk]
        s = subs[c0:c0 + tiles_per_chunk].long()
        tt, uu, vv = epilogue(*dets(phi[tc], coef[s]))  # (Tc, sub, TR)
        tmin, imin, u_w, v_w = nearest(tt, uu, vv, (s * sub).to(torch.int32))
        cur_t, cur_i = t[tc], idx[tc]
        take = (tmin < cur_t) | ((tmin == cur_t) & (tmin < inf) & (imin < cur_i))
        t[tc] = torch.where(take, tmin, cur_t)
        idx[tc] = torch.where(take, imin, cur_i)
        u[tc] = torch.where(take, u_w, u[tc])
        v[tc] = torch.where(take, v_w, v[tc])


@spans.spanned("walk.launch")
def _walk_plain(phi_pad, cols_rows, counts, lists, emins, tile_rays: int, stats=None,
                mxu: bool = False):
    """The 'nf' kernel's walk in torch ops: step j evaluates entry j of
    every tile still walking, then refreshes those tiles' largest live t.
    `stats`, a zeroed (T,) int32 tensor, receives each tile's count of
    evaluated subs; `mxu` takes the MXU variant's determinants."""
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
        _fold_subs(phi, coef, tiles, lists[tiles, j], best, mxu)
        tmax[tiles] = t[tiles].amax(dim=1)
        if stats is not None:
            stats[tiles] += 1
    return tuple(x.reshape(-1) for x in best)


@spans.spanned("walk.launch")
def _walk_list_plain(phi_pad, cols_rows, counts, lists, tile_rays: int, mxu: bool = False,
                     stats=None):
    """The 'list' kernel's walk in torch ops: step j evaluates entry j of
    every tile whose list is longer than j; no bound, no break, every lane
    from t = INF.  `stats`, a zeroed (T,) int32 tensor, receives each
    tile's count of evaluated subs."""
    n_tiles, ms = lists.shape
    phi, best = _walk_start(phi_pad, n_tiles, tile_rays, park=False)
    coef = cols_rows.reshape(ms, 4, -1, 10)
    for j in range(ms):
        tiles = (counts > j).nonzero().squeeze(1)
        if tiles.numel() == 0:
            break
        _fold_subs(phi, coef, tiles, lists[tiles, j], best, mxu)
        if stats is not None:
            stats[tiles] += 1
    return tuple(x.reshape(-1) for x in best)


@spans.spanned("walk.launch")
def _walk_cond_plain(phi_pad, cols_rows, chunk_boxes, sub_boxes, tile_rays: int, stats=None,
                     mxu: bool = False):
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
            _fold_subs(phi, coef, ts, subs[s].expand(ts.numel()), best, mxu)
    return tuple(x.reshape(-1) for x in best)


@functools.cache
def _mxu_smem_limit(lib, device_index: int) -> int:
    """The most dynamic shared memory one first-design MXU block may take on
    this card."""
    limit = ctypes.c_size_t()
    err = lib.tpt_mxu_smem_limit(device_index, ctypes.byref(limit))
    if err:
        raise RuntimeError(f"reading the shared-memory limit failed: {err}")
    return limit.value


def _check_mxu_shape(what: str, lib, table, tile_rays: int, sub: int) -> None:
    """The first-design MXU kernels' table layout, and their shared memory
    (the tile's best state and one staged sub-treelet's fragments, sized by
    csrc/mt_shade.cu) within the card's limit."""
    if table.shape[1] != 16 or table.data_ptr() % 16:
        raise ValueError(f"{what} kernel: the table must be `_pack_mma`'s (4*Np, 16) rows")
    need = lib.tpt_mxu_smem_bytes(sub, tile_rays)
    limit = _mxu_smem_limit(lib, table.device.index or 0)
    if need > limit:
        raise ValueError(f"{what} kernel: a {tile_rays}-ray tile at sub {sub} needs {need} bytes "
                         f"of shared memory, above the card's {limit}")


# Floats a triangle of each Hopper walk's table: `_pack_walk_table`'s or
# `_pack_mxu_table`'s.
_TABLE_FLOATS = {**{f"mt_{cull}": WALK_TABLE_FLOATS for cull in CULL_MODES},
                 **{f"mt_{cull}_mxu": MXU_TABLE_FLOATS for cull in CULL_MODES}}


def _check_table(what: str, table, tile_rays: int) -> None:
    """A Hopper walk's table: (Np, floats a triangle), 16-byte aligned; the
    MXU walks also refuse a tile wider than they place."""
    if table.shape[1:] != (_TABLE_FLOATS[what],) or table.data_ptr() % 16:
        pack = "_pack_mxu_table" if what.endswith("_mxu") else "_pack_walk_table"
        raise ValueError(f"{what} kernel: the table must be `{pack}`'s "
                         f"(Np, {_TABLE_FLOATS[what]}) rows")
    if what.endswith("_mxu") and tile_rays > MXU_MAX_TILE_RAYS:
        raise ValueError(f"{what} kernel: no launch shape places a {tile_rays}-ray tile (at most "
                         f"{MXU_MAX_TILE_RAYS})")


def _walk_cuda(phi_pad, cols_rows, counts, lists, emins, tile_rays: int, mxu: bool = False,
               stats=None):
    """Launch the 'nf' kernel (csrc/nf_walk.cu, on the table
    `_pack_walk_table` repacks; with `mxu`, the MXU walk of
    csrc/mxu_walk.cu, `cols_rows` then being `_pack_mxu_table`'s table) on
    the current stream; outputs (R_pad,) x4.  `stats`, if given, a (T,)
    int32 tensor, receives each tile's count of evaluated subs."""
    if mxu:
        return _list_launch("mt_nf_mxu", phi_pad, cols_rows, counts, lists, emins, tile_rays,
                            stats)
    sub = cols_rows.shape[0] // (4 * lists.shape[1])
    with spans.span("walk.prep"):
        table = _pack_walk_table(cols_rows, sub)
    return _list_launch("mt_nf", phi_pad, table, counts, lists, emins, tile_rays, stats)


@spans.spanned("walk.launch")
def _list_launch(what, phi_pad, table, counts, lists, emins, tile_rays: int, stats=None):
    """Launch `tpt_<what>`, a Hopper walk over the per-tile lists ('nf',
    which reads `emins`, or 'list', given None), on its table; outputs
    (R_pad,) x4.  `stats`, if given, a (T,) int32 tensor, receives each
    tile's count of evaluated subs."""
    from ... import _build

    lib = _build.load()
    dev = phi_pad.device
    n_tiles, ms = lists.shape
    bounded = (emins,) if emins is not None else ()
    _check_inputs(what, (phi_pad, torch.float32), (table, torch.float32), (counts, torch.int32),
                  (lists, torch.int32), *((x, torch.float32) for x in bounded), device=dev)
    _check_table(what, table, tile_rays)
    if table.shape[0] % ms:
        raise ValueError(f"{what} kernel: table and lists do not match")
    if stats is not None:
        _check_inputs(what, (stats, torch.int32), device=dev)
        if stats.shape != (n_tiles,):
            raise ValueError(f"{what} kernel: walk stats must be a (T,) int32 tensor")
    out = _outputs(phi_pad.shape[1], dev)
    err = getattr(lib, f"tpt_{what}")(
        *map(_ptr, (phi_pad, table, counts, lists, *bounded, *out, stats)), phi_pad.shape[1],
        tile_rays, n_tiles, ms, table.shape[0] // ms, _stream(dev))
    if err:
        raise RuntimeError(f"{what} kernel launch failed: {_build.error_string(err)}")
    return out


def walk_shape(fn, *args) -> dict:
    """What `tpt_mt_nf_shape`, `tpt_mt_list_shape`, `tpt_mt_cond_shape`,
    `tpt_mt_stream_shape` or `tpt_mt_{nf,list,cond}_mxu_shape` (`fn`, by
    name) say of the kept Hopper walk at this shape: rays a thread (the MXU
    walks: twice the m-tiles a warp), cluster size, threads and registers a
    thread, static and dynamic shared bytes, CTAs resident per SM, clusters
    resident on the card, lanes a ray."""
    from ... import _build

    out = (ctypes.c_int * 9)()
    err = getattr(_build.load(), fn)(*args, out)
    if err:
        raise RuntimeError(f"{fn} failed: {_build.error_string(err)}")
    keys = ("rpt", "cluster", "threads", "registers", "static_smem", "dynamic_smem",
            "ctas_per_sm", "clusters", "tpr")
    return dict(zip(keys, out))


def _walk_list_cuda(phi_pad, cols_rows, counts, lists, tile_rays: int, mxu: bool = False,
                    stats=None):
    """Launch the 'list' kernel (the list walk of csrc/nf_walk.cu, on the
    table `_pack_walk_table` repacks; with `mxu`, the MXU walk of
    csrc/mxu_walk.cu, `cols_rows` then being `_pack_mxu_table`'s table);
    outputs (R_pad,) x4.  `stats`, if given, a (T,) int32 tensor, receives
    each tile's count of evaluated subs."""
    if mxu:
        return _list_launch("mt_list_mxu", phi_pad, cols_rows, counts, lists, None, tile_rays,
                            stats)
    sub = cols_rows.shape[0] // (4 * lists.shape[1])
    with spans.span("walk.prep"):
        table = _pack_walk_table(cols_rows, sub)
    return _list_launch("mt_list", phi_pad, table, counts, lists, None, tile_rays, stats)


def _walk_list_cuda_v1(phi_pad, cols_rows, counts, lists, tile_rays: int):
    """Launch the first design of the 'list' walk (csrc/mt_shade.cu
    `tpt_mt_list_v1`, on the sub-block-major rows), kept only to compare
    its redesign with; outputs (R_pad,) x4."""
    if cols_rows.shape[1:] != (10,):
        raise ValueError("mt_list_v1 kernel: the table must be `_pad_scene`'s (4*Np, 10) rows")
    return _rows_launch("mt_list_v1", phi_pad, cols_rows, counts, lists, None, tile_rays)


def _rows_launch(what, phi_pad, rows, counts, lists, emins, tile_rays: int):
    """Launch `tpt_<what>`, a first-design walk of csrc/mt_shade.cu over
    the per-tile lists ('nf' reads `emins`; 'list' is given None);
    outputs (R_pad,) x4."""
    from ... import _build

    lib = _build.load()
    dev = phi_pad.device
    n_tiles, ms = lists.shape
    bounded = (emins,) if emins is not None else ()
    _check_inputs(what, (phi_pad, torch.float32), (rows, torch.float32), (counts, torch.int32),
                  (lists, torch.int32), *((x, torch.float32) for x in bounded), device=dev)
    sub = rows.shape[0] // (4 * ms)
    if what.endswith("_mxu_v1"):
        _check_mxu_shape(what, lib, rows, tile_rays, sub)
    out = _outputs(phi_pad.shape[1], dev)
    err = getattr(lib, f"tpt_{what}")(
        *map(_ptr, (phi_pad, rows, counts, lists, *bounded, *out)),
        phi_pad.shape[1], tile_rays, n_tiles, ms, sub, _stream(dev))
    if err:
        raise RuntimeError(f"{what} kernel launch failed: {_build.error_string(err)}")
    return out


def _walk_cond_cuda(phi_pad, cols_rows, chunk_boxes, sub_boxes, tile_rays: int, stats=None,
                    mxu: bool = False):
    """Launch the 'cond' kernel (csrc/cond_walk.cu, on the table
    `_pack_walk_table` repacks; with `mxu`, the MXU walk of
    csrc/mxu_walk.cu, `cols_rows` then being `_pack_mxu_table`'s table) on
    the current stream; outputs (R_pad,) x4.  `stats`, if given, a (T, 2)
    int32 tensor, receives the walk counts."""
    if mxu:
        _check_table("mt_cond_mxu", cols_rows, tile_rays)
        return _cond_launch("mt_cond_mxu", 1, phi_pad, cols_rows, chunk_boxes, sub_boxes,
                            tile_rays, stats)
    sub = CHUNK_TRIS * chunk_boxes.shape[0] // sub_boxes.shape[0]
    with spans.span("walk.prep"):
        table = _pack_walk_table(cols_rows, sub)
    return _walk_cond_table_cuda(phi_pad, table, chunk_boxes, sub_boxes, tile_rays, stats)


def _walk_cond_table_cuda(phi_pad, table, chunk_boxes, sub_boxes, tile_rays: int, stats=None):
    """Launch the Hopper 'cond' walk of csrc/cond_walk.cu on the walk
    table; outputs (R_pad,) x4.  `stats`, if given, a (T, 2) int32 tensor,
    receives the walk counts."""
    _check_table("mt_cond", table, tile_rays)
    return _cond_launch("mt_cond", 1, phi_pad, table, chunk_boxes, sub_boxes, tile_rays, stats)


def _walk_cond_cuda_v1(phi_pad, cols_rows, chunk_boxes, sub_boxes, tile_rays: int, stats=None):
    """Launch the first design of the 'cond' walk (csrc/mt_shade.cu
    `tpt_mt_cond_v1`, on the sub-block-major rows), kept only to compare
    its redesign with; outputs (R_pad,) x4."""
    if cols_rows.shape[1:] != (10,):
        raise ValueError("mt_cond_v1 kernel: the table must be `_pad_scene`'s (4*Np, 10) rows")
    return _cond_launch("mt_cond_v1", 4, phi_pad, cols_rows, chunk_boxes, sub_boxes, tile_rays,
                        stats)


@spans.spanned("walk.launch")
def _cond_launch(what, rows_a_tri: int, phi_pad, table, chunk_boxes, sub_boxes, tile_rays: int,
                 stats=None):
    """Launch `tpt_<what>`, a 'cond' walk over `table`, whose row width
    the caller has checked and which holds `rows_a_tri` rows a triangle;
    outputs (R_pad,) x4.  `stats`, if given, a (T, 2) int32 tensor,
    receives the walk counts."""
    from ... import _build

    dev = phi_pad.device
    n_tiles = phi_pad.shape[1] // tile_rays
    n_chunks, n_subs = chunk_boxes.shape[0], sub_boxes.shape[0]
    _check_inputs(what, (phi_pad, torch.float32), (table, torch.float32),
                  (chunk_boxes, torch.float32), (sub_boxes, torch.float32), device=dev)
    if (table.shape[0] != rows_a_tri * n_chunks * CHUNK_TRIS
            or table.data_ptr() % 16 or n_subs % n_chunks):
        raise ValueError(f"{what} kernel: coefficient table and boxes do not match")
    if stats is not None:
        _check_inputs(what, (stats, torch.int32), device=dev)
        if stats.shape != (n_tiles, 2):
            raise ValueError(f"{what} kernel: walk stats must be a (T, 2) int32 tensor")
    out = _outputs(phi_pad.shape[1], dev)
    err = getattr(_build.load(), f"tpt_{what}")(
        *map(_ptr, (phi_pad, table, chunk_boxes, sub_boxes, *out, stats)),
        phi_pad.shape[1], tile_rays, n_tiles, n_chunks, CHUNK_TRIS * n_chunks // n_subs,
        _stream(dev))
    if err:
        raise RuntimeError(f"{what} kernel launch failed: {_build.error_string(err)}")
    return out


def _walk_mxu_cuda_v1(cull: str, phi_pad, table, *rest, stats=None):
    """Launch the first design of the MXU `cull` walk (csrc/mt_shade.cu
    `tpt_mt_<cull>_mxu_v1`) on `_pack_mma`'s table, kept only to compare
    its redesign with.  `rest` is what follows the table in the prepared
    inputs of `cull` (`_prepare`, `_prepare_list`, `_prepare_cond`), the
    tile width last; outputs (R_pad,) x4.  `stats` (a (T, 2) int32 tensor)
    only for cond."""
    *rest, tile_rays = rest
    what = f"mt_{cull}_mxu_v1"
    if cull == "cond":
        from ... import _build

        sub = CHUNK_TRIS * rest[0].shape[0] // rest[1].shape[0]
        _check_mxu_shape(what, _build.load(), table, tile_rays, sub)
        return _cond_launch(what, 4, phi_pad, table, *rest, tile_rays, stats)
    if stats is not None:
        raise ValueError(f"{what} kernel: no walk counts")
    counts, lists, *emins = rest
    return _rows_launch(what, phi_pad, table, counts, lists, emins[0] if emins else None,
                        tile_rays)


def _mma_prepare(prepare, pack=None):
    """`prepare` with the coefficient table repacked for the MXU kernels
    (`_pack_mxu_table`; `pack`, e.g. `_pack_mma` for the first designs)."""
    def prep(tri_pos, phi_t, tile_rays, sub: int = SUB_TRIS):
        phi_pad, cols_rows, *rest = prepare(tri_pos, phi_t, tile_rays, sub)
        return (phi_pad, (pack or _pack_mxu_table)(cols_rows, sub), *rest)

    return prep


_STATS_COLUMNS = {"nf": 1, "list": 1, "cond": 2, "stream": 3}  # a tile's walk counts


def _walk_counts(kind: str, prep, n_tris: int, lanes: int):
    """While the recorder is on: a zeroed stats buffer for the walk `kind`
    ('nf', 'list', 'cond' or 'stream') on its prepared inputs `prep`, and
    that walk's work counted from it (`walk.pairs`, `walk.slabs`) as
    `chip_smoke._walk_work` counts it, every lane of a tile, with the
    `lanes` handed to it (`walk.lanes`).  Read when the counters are, so the
    counts add no launch and no host wait (cond's tile-alive gate aside,
    which its kernel does not count).  None when the recorder is off."""
    phi_pad, tile_rays = prep[0], prep[-1]
    n_tiles = phi_pad.shape[1] // tile_rays
    cols = _STATS_COLUMNS[kind]
    stats = spans.ints(phi_pad.device, n_tiles * cols)
    if stats is None:
        return None
    spans.count("walk.lanes", lanes)
    if cols == 1:  # subs evaluated; no slab tests
        sub = -(-n_tris // CHUNK_TRIS) * CHUNK_TRIS // prep[3].shape[1]
        spans.count("walk.pairs", stats, sub * tile_rays)
        spans.count("walk.slabs", 0)
        return stats
    stats = stats.view(n_tiles, cols)
    chunk_boxes, sub_boxes = prep[2], prep[3]
    subs_a_chunk = sub_boxes.shape[0] // chunk_boxes.shape[0]
    sub = CHUNK_TRIS // subs_a_chunk
    spans.count("walk.pairs", stats[:, -1], sub * tile_rays)
    if kind == "cond":  # every chunk box of a tile that moves, the sub boxes of live chunks
        alive = phi_pad[4:7].abs().reshape(3, n_tiles, tile_rays).sum(dim=(0, 2)) > 0.0
        spans.count("walk.slabs", alive, chunk_boxes.shape[0] * tile_rays)
        spans.count("walk.slabs", stats[:, 0], (subs_a_chunk if subs_a_chunk > 1 else 0) * tile_rays)
    else:  # stream: the chunk boxes of walked supers, the sub boxes of staged chunks
        spans.count("walk.slabs", stats[:, 0], CHUNKS_PER_SUPER * tile_rays)
        spans.count("walk.slabs", stats[:, 1], subs_a_chunk * tile_rays)
    return stats


def _intersect(tri_pos, phi_t, tile_rays, walk, prepare=_prepare, kind: str = "nf",
               **prep_kw) -> Hit:
    r = phi_t.shape[1]
    if tri_pos.shape[0] == 0 or r == 0:
        return miss_hit(r, phi_t.device)
    with spans.span("walk.prep"):
        prep = prepare(tri_pos, phi_t, tile_rays, **prep_kw)
    stats = _walk_counts(kind, prep, tri_pos.shape[0], r)
    t, idx, u, v = walk(*prep) if stats is None else walk(*prep, stats=stats)
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
    return _intersect(tri_pos, phi_t, tile_rays, _walk_list_plain, _prepare_list, "list",
                      sub=_sub_tris(sub))


def mt_intersect_list_phi(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """MT intersection through each tile's whole precull list, in list
    order; returns `Hit`.  A CUDA tensor launches the kernel (counted in
    `mt_intersect_list_phi.launches`); a CPU tensor runs the plain version."""
    if not _launches_kernel(phi_t):
        return mt_intersect_list_phi_plain(tri_pos, phi_t, tile_rays=tile_rays, sub=sub)
    return _intersect(tri_pos, phi_t, tile_rays,
                      _counted(mt_intersect_list_phi, _walk_list_cuda), _prepare_list, "list",
                      sub=_sub_tris(sub))


mt_intersect_list_phi.launches = 0


def mt_intersect_cond_phi_plain(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """Plain PyTorch version of the 'cond' MT kernel, on any device."""
    return _intersect(tri_pos, phi_t, tile_rays, _walk_cond_plain, _prepare_cond, "cond",
                      sub=_sub_tris(sub))


def mt_intersect_cond_phi(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """MT intersection with in-kernel two-level culling over all chunks;
    returns `Hit`.  A CUDA tensor launches the kernel (counted in
    `mt_intersect_cond_phi.launches`); a CPU tensor runs the plain version."""
    if not _launches_kernel(phi_t):
        return mt_intersect_cond_phi_plain(tri_pos, phi_t, tile_rays=tile_rays, sub=sub)
    return _intersect(tri_pos, phi_t, tile_rays,
                      _counted(mt_intersect_cond_phi, _walk_cond_cuda), _prepare_cond, "cond",
                      sub=_sub_tris(sub))


mt_intersect_cond_phi.launches = 0


# --- the MXU variants (kernel #5) ------------------------------------------

_MXU_WALKS = {  # cull -> (prepare, plain walk, CUDA walk)
    "nf": (_prepare, _walk_plain, _walk_cuda),
    "list": (_prepare_list, _walk_list_plain, _walk_list_cuda),
    "cond": (_prepare_cond, _walk_cond_plain, _walk_cond_cuda),
}


def _mxu_plain(cull: str, tri_pos, phi_t, tile_rays, sub) -> Hit:
    prepare, walk, _ = _MXU_WALKS[cull]
    return _intersect(tri_pos, phi_t, tile_rays, functools.partial(walk, mxu=True), prepare,
                      cull, sub=_sub_tris(sub))


def _mxu_kernel(cull: str, wrapper, tri_pos, phi_t, tile_rays, sub) -> Hit:
    if not _launches_kernel(phi_t):
        return _mxu_plain(cull, tri_pos, phi_t, tile_rays, sub)
    prepare, _, walk = _MXU_WALKS[cull]
    return _intersect(tri_pos, phi_t, tile_rays,
                      _counted(wrapper, functools.partial(walk, mxu=True)),
                      _mma_prepare(prepare), cull, sub=_sub_tris(sub))


def mt_intersect_nf_mxu_phi_plain(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """Plain PyTorch version of the 'nf' kernel's MXU variant, on any device:
    the 'nf' walk with each sub-treelet's determinants as one float32 matrix
    product (TF32 off)."""
    return _mxu_plain("nf", tri_pos, phi_t, tile_rays, sub)


def mt_intersect_nf_mxu_phi(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """`mt_intersect_nf_phi` with the determinants on the tensor cores
    (3xTF32).  A CUDA tensor launches the kernel (counted in
    `mt_intersect_nf_mxu_phi.launches`); a CPU tensor runs the plain version."""
    return _mxu_kernel("nf", mt_intersect_nf_mxu_phi, tri_pos, phi_t, tile_rays, sub)


mt_intersect_nf_mxu_phi.launches = 0


def mt_intersect_list_mxu_phi_plain(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """Plain PyTorch version of the 'list' kernel's MXU variant."""
    return _mxu_plain("list", tri_pos, phi_t, tile_rays, sub)


def mt_intersect_list_mxu_phi(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """`mt_intersect_list_phi` with the determinants on the tensor cores
    (counted in `mt_intersect_list_mxu_phi.launches`)."""
    return _mxu_kernel("list", mt_intersect_list_mxu_phi, tri_pos, phi_t, tile_rays, sub)


mt_intersect_list_mxu_phi.launches = 0


def mt_intersect_cond_mxu_phi_plain(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """Plain PyTorch version of the 'cond' kernel's MXU variant."""
    return _mxu_plain("cond", tri_pos, phi_t, tile_rays, sub)


def mt_intersect_cond_mxu_phi(tri_pos, phi_t, *, tile_rays=None, sub=None) -> Hit:
    """`mt_intersect_cond_phi` with the determinants on the tensor cores
    (counted in `mt_intersect_cond_mxu_phi.launches`)."""
    return _mxu_kernel("cond", mt_intersect_cond_mxu_phi, tri_pos, phi_t, tile_rays, sub)


mt_intersect_cond_mxu_phi.launches = 0


def cond_walk_stats(tri_pos, phi_t, *, tile_rays=None, sub=None, plain: bool = False,
                    mxu: bool = False):
    """Per-tile walk counts of the 'cond' kernel, or with `mxu` of its MXU
    variant (or, with `plain=True` or a CPU tensor, of its plain version)
    on these inputs: (T, 2) int32, [chunks live, subs evaluated].  The FP32
    kernel and its plain version agree on them exactly.  Launches made here
    are not counted."""
    sub = _sub_tris(sub)
    plain = plain or phi_t.device.type == "cpu"
    prepare = _mma_prepare(_prepare_cond) if mxu and not plain else _prepare_cond
    prep = prepare(tri_pos, phi_t, tile_rays, sub)
    stats = torch.zeros((prep[0].shape[1] // prep[-1], 2), dtype=torch.int32,
                        device=phi_t.device)
    walk = _walk_cond_plain if plain else _walk_cond_cuda
    walk(*prep, stats=stats, mxu=mxu)
    return stats


def nf_walk_stats(tri_pos, phi_t, *, tile_rays=None, sub=None, plain: bool = False,
                  mxu: bool = False):
    """Per-tile walk counts of the 'nf' kernel, or with `mxu` of its MXU
    variant (or, with `plain=True` or a CPU tensor, of its plain version)
    on these inputs: (T,) int32, the subs each tile evaluated.  The FP32
    kernel and its plain version agree on them exactly.  Launches made here
    are not counted."""
    plain = plain or phi_t.device.type == "cpu"
    prepare = _mma_prepare(_prepare) if mxu and not plain else _prepare
    prep = prepare(tri_pos, phi_t, tile_rays, _sub_tris(sub))
    stats = torch.zeros((prep[3].shape[0],), dtype=torch.int32, device=phi_t.device)
    walk = _walk_plain if plain else _walk_cuda
    walk(*prep, stats=stats, mxu=mxu)
    return stats


def _pair_terms(tri_pos, phi_t, tri, lanes):
    """The four determinants [a, ua, va, ta] of these lanes against their
    triangles `tri`, recomputed in float64, and the sums of their terms'
    magnitudes (the scale float32 rounding errors are relative to): each
    (4, L)."""
    cols = triangle_columns(tri_pos[tri.clamp(min=0).long()].double())  # (10, 4, L)
    terms = cols * phi_t[:, lanes].double()[:, None, :]
    return terms.sum(dim=0), terms.abs().sum(dim=0)


def hit_agreement(tri_pos, phi_t, ha: Hit, hb: Hit, *, tol: float = 1e-4,
                  t_rel: float = 1e-5, margin_rel: float = 1e-5) -> dict:
    """How two `Hit`s of the same rays agree when their determinants were
    summed in different orders (the MXU variants against their plain
    versions or the FP32 kernels), measured against float64.

    A lane whose hit or triangle differs should be a near-tie (both hit, t
    within `t_rel` relative), an edge (a triangle either took has a
    barycentric validity margin, us, vs or |a|-us-vs, within `margin_rel`
    of the magnitude of its terms) or a floor lane (its t test, ts against
    EPSILON*|a|, as close: mostly a ray re-hitting the surface it starts
    on).  On the lanes where both hit the same triangle, t, u and v are
    compared relative to the magnitude their sums are conditioned by:
    (sum of |numerator terms| + |value| * sum of |a's terms|) / |a|, which is
    about |value| except at grazing angles, where a cancels.

    Returns counts ("differ", "near_ties", "edges", "floor", and "other"
    for the rest), "t_err" and "uv_err" (the largest such differences), and
    "ok", the MXU rule: no "other" lane, at most 0.1% of the lanes differ
    other than floor lanes, at most 0.3% are floor lanes, and t_err and
    uv_err <= `tol`.  Floor lanes are held apart because rays that leave a
    surface re-hit it at t about 0, where the EPSILON test is decided by
    rounding (primary rays have none; the headline scene's first bounce on
    an H100 has 0.13%).  A kernel whose t test drops EPSILON (ts > 0) fails
    the rule (`test_mxu_rule_catches_a_dropped_epsilon_test`)."""
    eps = float(EPSILON)
    differ = (ha.hit != hb.hit) | (ha.tri != hb.tri)
    lanes = differ.nonzero().squeeze(1)
    both = ha.hit[lanes] & hb.hit[lanes]
    ta, tb = ha.t[lanes].double(), hb.t[lanes].double()
    near = both & ((ta - tb).abs() <= t_rel * torch.maximum(ta.abs(), tb.abs()))
    on_edge = torch.zeros_like(near)
    on_floor = torch.zeros_like(near)
    for h in (ha, hb):
        (a, ua, va, t_a), (sa_, su, sv, st) = _pair_terms(tri_pos, phi_t, h.tri[lanes], lanes)
        sign = torch.sign(a)
        us, vs, ts, abs_a = ua * sign, va * sign, t_a * sign, a.abs()
        margin = torch.minimum(torch.minimum(us, vs), abs_a - us - vs).abs()
        on_edge |= h.hit[lanes] & (margin <= margin_rel * (sa_ + su + sv))
        on_floor |= h.hit[lanes] & ((ts - eps * abs_a).abs() <= margin_rel * (st + eps * sa_))

    same = ha.hit & hb.hit & ~differ
    t_err = uv_err = 0.0
    if bool(same.any()):
        idx = same.nonzero().squeeze(1)
        (a, _, _, _), scales = _pair_terms(tri_pos, phi_t, ha.tri[idx], idx)
        abs_a = a.abs()

        def err(x, y, q):  # q: the numerator's row of `scales`
            x, y = x[idx].double(), y[idx].double()
            scale = (scales[q] + x.abs() * scales[0]) / abs_a
            return float(((x - y).abs() / scale).max())

        t_err = err(ha.t, hb.t, 3)
        uv_err = max(err(ha.u, hb.u, 1), err(ha.v, hb.v, 2))
    out = {"lanes": int(ha.hit.numel()), "differ": int(lanes.numel()),
           "near_ties": int(near.sum()), "edges": int((~near & on_edge).sum()),
           "floor": int((~near & ~on_edge & on_floor).sum()),
           "other": int((~near & ~on_edge & ~on_floor).sum()),
           "t_err": t_err, "uv_err": uv_err}
    out["ok"] = (out["other"] == 0 and out["differ"] - out["floor"] <= 1e-3 * out["lanes"]
                 and out["floor"] <= 3e-3 * out["lanes"] and t_err <= tol and uv_err <= tol)
    return out


_ROUTES = {
    ("nf", False): (mt_intersect_nf_phi, mt_intersect_nf_phi_plain),
    ("list", False): (mt_intersect_list_phi, mt_intersect_list_phi_plain),
    ("cond", False): (mt_intersect_cond_phi, mt_intersect_cond_phi_plain),
    ("nf", True): (mt_intersect_nf_mxu_phi, mt_intersect_nf_mxu_phi_plain),
    ("list", True): (mt_intersect_list_mxu_phi, mt_intersect_list_mxu_phi_plain),
    ("cond", True): (mt_intersect_cond_mxu_phi, mt_intersect_cond_mxu_phi_plain),
}


def _pallas2(plain: bool, tri_pos, phi_t, tile_rays, cull, sub, mxu_dets) -> Hit:
    tile_rays = _tile_rays(tile_rays)
    kernel, plain_fn = _ROUTES[_cull_mode(cull), _mxu_dets(mxu_dets)]
    return (plain_fn if plain else kernel)(tri_pos, phi_t, tile_rays=tile_rays,
                                           sub=_sub_tris(sub))


def mt_intersect_pallas2_phi(tri_pos, phi_t, *, tile_rays=None, cull=None, sub=None,
                             mxu_dets=None) -> Hit:
    """Whole-scene MT intersection of (10, R) ray features against (N, 9)
    packed triangle rows through the kernel `cull` and `mxu_dets` select
    ('nf', 'list' or 'cond', each with FP32 or MXU determinants; see the
    module docstring for how each option resolves)."""
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
