"""Streamed two-level-culled Möller–Trumbore intersection for large scenes
(8K-256K triangles): the wrapper, its plain PyTorch version and the CUDA
kernel's binding.

Replaces the TPU kernel `_kernel_stream2` of
tpu_pathtracer/ops/pallas/mt_shade.py (reached through
`mt_intersect_stream2_phi`).  The contract is the JAX wrapper's:

  * triangles pad to a multiple of one super-treelet (2,048 rows: 16
    chunks of 128, each 4 subs of 32); treelets made only of padding get
    an impossible box (`_dead_pad_boxes`); the ray features phi_t (10, R)
    pad with 1e30 to a multiple of the ray tile, which widens while there
    are more than 512 tiles;
  * a precull (`_precull_live_subs` over the super boxes) gives each ray
    tile its live supers, sorted near to far by tile entry distance;
  * per tile the kernel walks that list and stops once the next entry
    distance reaches the tile's largest live t, refreshed once per super.
    Inside a super, chunk k (in index order) is evaluated only if some ray
    of the tile enters its box before its current t; inside a live chunk,
    sub s likewise, against t as it stands at that moment;
  * parked lanes (rd = 0) and padding lanes start at t = -INF; nearest hit
    wins, exact-t ties go to the lowest triangle index.

The coefficients are laid out sub-block-major at 32 triangles
(`_pack_subblock_major`), so a chunk is one contiguous 20 KB block
(128 triangles x 4 quantities x 10 features, f32), not the TPU's
lane-padded (128, 128) blocks; the kernel reads them repacked into the
walk table (`_pack_walk_table`: 20 floats a triangle, a chunk 10 KB).
`mt_intersect_stream2_phi` launches the CUDA kernel (the Hopper walk of
csrc/stream_walk.cu) for a CUDA tensor and runs
`mt_intersect_stream2_phi_plain` for a CPU tensor.  The plain version walks
the same lists, chunks and subs in the same order with the same
elementwise arithmetic, vectorised over tiles, so the two agree bit for
bit, walk counts included.
"""

from __future__ import annotations

import torch

from ...utils import spans
from ..mt_matmul import Hit, ray_features, triangle_columns
from ..vecmath import INF
from .mt_intersect import _check_inputs, _outputs, _ptr, _stream
from .mt_shade import (
    CHUNK_TRIS,
    CHUNKS_PER_SUPER,
    MT_STREAM2_MAX_TRIS,
    WALK_TABLE_FLOATS,
    _dead_pad_boxes,
    _fold_subs,
    _intersect,
    _pack_subblock_major,
    _pack_walk_table,
    _pad_rays,
    _pad_to,
    _precull_live_subs,
    _slab_entries,
    _slab_setup,
    _walk_start,
    _widened_tile,
    treelet_boxes,
)

SUB_TRIS = 32  # the stream's own sub-treelet granule
SUBS_PER_CHUNK = CHUNK_TRIS // SUB_TRIS
SUPER_TRIS = CHUNK_TRIS * CHUNKS_PER_SUPER


def _prepare(tri_pos, phi_t, tile_rays):
    """Padding, coefficient packing, treelet boxes and the super precull,
    shared by kernel and plain version.  Returns (phi_pad, cols_rows,
    chunk_boxes, sub_boxes, counts, lists, emins, tile_rays)."""
    n = tri_pos.shape[0]
    if n > MT_STREAM2_MAX_TRIS:
        raise ValueError(f"mt_stream supports <= {MT_STREAM2_MAX_TRIS} triangles (got {n}); "
                         "use 'bvh8'")
    tile_rays = _widened_tile(tile_rays, phi_t.shape[1])
    tri_padded = _pad_to(tri_pos, -(-n // SUPER_TRIS) * SUPER_TRIS, 0)
    cols_rows = _pack_subblock_major(triangle_columns(tri_padded), SUB_TRIS)
    super_boxes, chunk_boxes, sub_boxes = (
        _dead_pad_boxes(treelet_boxes(tri_padded, g), n, g)
        for g in (SUPER_TRIS, CHUNK_TRIS, SUB_TRIS))
    phi_pad = _pad_rays(phi_t, tile_rays)
    with spans.span("walk.precull"):
        counts, lists, emins = _precull_live_subs(super_boxes, phi_pad, tile_rays)
    return phi_pad, cols_rows, chunk_boxes, sub_boxes, counts, lists, emins, tile_rays


@spans.spanned("walk.launch")
def _walk_plain(phi_pad, cols_rows, chunk_boxes, sub_boxes, counts, lists, emins,
                tile_rays: int, stats=None):
    """The kernel's walk in torch ops, vectorised over tiles: list entry j
    of every tile still walking; inside it chunk k = 0..15 for the tiles
    where some ray enters the chunk box before its current t, and sub
    s = 0..3 likewise; then the walked tiles' largest live t.  `stats`, a
    zeroed (T, 3) int32 tensor, receives each tile's walk counts: supers
    walked, chunks staged, subs evaluated."""
    if stats is None:
        stats = torch.zeros((lists.shape[0], 3), dtype=torch.int32, device=lists.device)
    n_tiles, n_list = lists.shape
    phi, best = _walk_start(phi_pad, n_tiles, tile_rays)
    coef = cols_rows.reshape(-1, 4, SUB_TRIS, 10)  # (Ms, 4, sub, 10)
    ro, rd = phi[:, 1:4], phi[:, 4:7]
    par, inv = _slab_setup(ro, rd)
    spc = torch.arange(SUBS_PER_CHUNK, device=phi.device)
    t = best[0]
    tmax = torch.full((n_tiles,), float(INF), device=t.device)
    walking = torch.ones((n_tiles,), dtype=torch.bool, device=t.device)
    for j in range(n_list):
        walking &= (counts > j) & (emins[:, j] < tmax)
        tiles = walking.nonzero().squeeze(1)
        if tiles.numel() == 0:
            break
        stats[tiles, 0] += 1
        rays = ro[tiles], rd[tiles], par[tiles], inv[tiles]
        first_chunk = lists[tiles, j].long() * CHUNKS_PER_SUPER
        for k in range(CHUNKS_PER_SUPER):
            chunk = first_chunk + k
            centry = _slab_entries(chunk_boxes[chunk, None], *rays)[:, 0]  # (Tw, TR)
            live = (centry < t[tiles]).any(dim=1)
            if not bool(live.any()):
                continue
            tc, cc = tiles[live], chunk[live]
            stats[tc, 1] += 1
            subs = cc[:, None] * SUBS_PER_CHUNK + spc  # (Tc, 4)
            sub_entry = _slab_entries(sub_boxes[subs], *(x[live] for x in rays))  # (Tc, 4, TR)
            for s in range(SUBS_PER_CHUNK):
                live_s = (sub_entry[:, s] < t[tc]).any(dim=1)
                stats[tc[live_s], 2] += 1
                _fold_subs(phi, coef, tc[live_s], subs[live_s, s], best)
        tmax[tiles] = t[tiles].amax(dim=1)
    return tuple(x.reshape(-1) for x in best)


def _walk_cuda(phi_pad, cols_rows, chunk_boxes, sub_boxes, counts, lists, emins,
               tile_rays: int, stats=None):
    """Launch the Hopper walk (csrc/stream_walk.cu) on the current stream,
    on the table `_pack_walk_table` repacks; outputs (R_pad,) x4.
    `stats`, if given, a (T, 3) int32 tensor, receives the walk counts."""
    with spans.span("walk.prep"):
        table = _pack_walk_table(cols_rows, SUB_TRIS)
    return _walk_table_cuda(phi_pad, table, chunk_boxes, sub_boxes, counts, lists, emins,
                            tile_rays, stats=stats)


@spans.spanned("walk.launch")
def _walk_table_cuda(phi_pad, table, chunk_boxes, sub_boxes, counts, lists, emins,
                     tile_rays: int, stats=None):
    """Launch the Hopper walk on the walk table; outputs (R_pad,) x4."""
    from ... import _build

    lib = _build.load()
    dev = phi_pad.device
    r_pad = phi_pad.shape[1]
    n_tiles, n_list = lists.shape
    _check_inputs("mt_stream", (phi_pad, torch.float32), (table, torch.float32),
                  (chunk_boxes, torch.float32), (sub_boxes, torch.float32),
                  (counts, torch.int32), (lists, torch.int32), (emins, torch.float32), device=dev)
    n_chunks = chunk_boxes.shape[0]
    if (table.shape != (n_chunks * CHUNK_TRIS, WALK_TABLE_FLOATS) or table.data_ptr() % 16
            or sub_boxes.shape[0] != n_chunks * SUBS_PER_CHUNK
            or n_chunks != n_list * CHUNKS_PER_SUPER):
        raise ValueError("mt_stream kernel: coefficient table or boxes do not match the lists")
    if stats is not None:
        _check_inputs("mt_stream", (stats, torch.int32), device=dev)
        if stats.shape != (n_tiles, 3):
            raise ValueError("mt_stream kernel: walk stats must be a (T, 3) int32 tensor")
    out = _outputs(r_pad, dev)
    err = lib.tpt_mt_stream(
        *map(_ptr, (phi_pad, table, chunk_boxes, sub_boxes, counts, lists, emins, *out, stats)),
        r_pad, tile_rays, n_tiles, n_list, SUB_TRIS, CHUNKS_PER_SUPER, _stream(dev))
    if err:
        raise RuntimeError(f"mt_stream kernel launch failed: {_build.error_string(err)}")
    return out


def mt_intersect_stream2_phi_plain(tri_pos, phi_t, *, tile_rays=None) -> Hit:
    """Plain PyTorch version of the streamed MT kernel, on any device.
    tri_pos: (N, 9) packed rows; phi_t: (10, R) ray features."""
    return _intersect(tri_pos, phi_t, tile_rays, _walk_plain, _prepare, "stream")


def mt_intersect_stream2_phi(tri_pos, phi_t, *, tile_rays=None) -> Hit:
    """Streamed MT intersection of (10, R) ray features against (N, 9)
    packed triangle rows, N <= 262,144; returns `Hit` (t is INF on a miss,
    -INF on a parked lane).  A CUDA tensor launches the kernel (and counts
    the launch in `mt_intersect_stream2_phi.launches`); a CPU tensor runs
    the plain version."""
    if phi_t.device.type == "cpu":
        return mt_intersect_stream2_phi_plain(tri_pos, phi_t, tile_rays=tile_rays)
    if phi_t.device.type != "cuda":
        raise NotImplementedError(f"no MT kernel for device {phi_t.device}")

    def walk(*args, **kw):
        mt_intersect_stream2_phi.launches += 1
        return _walk_cuda(*args, **kw)

    return _intersect(tri_pos, phi_t, tile_rays, walk, _prepare, "stream")


mt_intersect_stream2_phi.launches = 0


def mt_intersect_stream2(tri_pos, ro, rd) -> Hit:
    """`mt_intersect_stream2_phi` on (R, 3) ray origins and directions."""
    return mt_intersect_stream2_phi(tri_pos, ray_features(ro, rd).T.contiguous())


def walk_stats(tri_pos, phi_t, *, tile_rays=None, plain: bool = False):
    """Per-tile walk counts of the streamed kernel (or, with `plain=True`
    or a CPU tensor, of its plain version) on these inputs: (T, 3) int32,
    [supers walked, chunks staged, subs evaluated].  Kernel and plain
    version must agree on them exactly.  Launches made here are not
    counted in `mt_intersect_stream2_phi.launches`."""
    prep = _prepare(tri_pos, phi_t, tile_rays)
    stats = torch.zeros((prep[5].shape[0], 3), dtype=torch.int32, device=phi_t.device)
    walk = _walk_plain if plain or phi_t.device.type == "cpu" else _walk_cuda
    walk(*prep, stats=stats)
    return stats
