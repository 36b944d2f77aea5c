"""Tile binning: triangle stream → per-tile compact triangle lists.

The reference's analog is the indirect-draw stream (one sorted command list
consumed by the whole GPU, renderer.rs:219-256); a software tile rasterizer
instead needs per-tile work lists so each tile only touches triangles that
overlap it (SURVEY.md §5.7 — the "scale axis" of this engine).

Formulation: everything is dense XLA ops —
1. per-triangle tile span from the setup bbox (pixel-center semantics),
2. expansion to (tile, triangle) pairs with `jnp.repeat(total_repeat_length)`
   (static capacity, overflow-safe), then a tight edge-plane trivial-reject
   per pair (bbox spans overbin heavily — w-crossing triangles get a
   full-screen bbox from the clipless setup; the reject prunes ~90% of the
   bench scene's expanded pairs before they cost sort-payload scatter or
   kernel reads),
3. one stable sort by tile id,
4. scatter of the kernel-consumed triangle setup rows into bin order → a
   [B_ROWS, P] SoA array where every tile's rows are CONTIGUOUS, so a
   raster program walks its tile's list with sequential reads,
5. per-tile (start, count) via searchsorted, which each raster program
   loads for its own tile.

Pair order within a tile is triangle-stream order (stable sort), preserving
the reference's later-submission-wins depth-tie semantics. The opaque class
may additionally be sub-ordered nearest-first at z-bucket granularity
(`zbuckets`, riding the same sort) — output-invariant because the opaque
kernel's merge is a lexicographic (z, id) max, and the enabler for its
conservative early-depth rejection (see bin_triangle_classes docstring).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from renderer_tpu.raster.setup import BBOX_ROWS, TID_ROW, VALID_ROW

# Binned-row layout: the raster kernels consume only the plane rows
# (edges 0-8 with the eps band pre-folded into C — setup.py —, depth 9-11,
# 1/w 12-14) and the triangle id. The bbox rows (binning input only), the
# valid flag (zeroed planes can never cover: e' = 0 fails both the strict
# test and the a/b-derived ownership tie-break), the eps row (folded into
# C) and setup's padding rows never reach the binned buffer — cutting its
# device-memory footprint, the bin scatter and every kernel's list reads by
# 33% (24 → 16 rows). Indices below are positions in the SLIM [B_ROWS, Pp]
# buffer.
KEEP_ROWS = tuple(range(15)) + (TID_ROW,)
B_ROWS = len(KEEP_ROWS)  # 16
B_TID = 15


def _tile_spans(tri_data, bounds, n_classes, *, tiles_x, tiles_y,
                tile_w, tile_h):
    """Bbox→tile-span math for bin_triangle_classes' stage-1 expansion:
    per-triangle first tile (tx0, ty0), span (span_w, span_h), bbox pair
    count (0 for invalid / out-of-bounds triangles), and alpha-class id.
    Factored out to keep the two-stage expansion body readable."""
    tc = tri_data.shape[1]
    xmin, ymin, xmax, ymax = (tri_data[k] for k in BBOX_ROWS)
    tri_idx = jnp.arange(tc, dtype=jnp.int32)
    valid = (tri_data[VALID_ROW] > 0.0) & (tri_idx >= bounds[0]) & (tri_idx < bounds[-1])
    cls = jnp.zeros(tc, jnp.int32)
    for c in range(1, n_classes):
        cls = cls + (tri_idx >= bounds[c]).astype(jnp.int32)

    # tile index ranges covering any pixel CENTER in [min, max]
    tx0 = jnp.clip(jnp.ceil((xmin + 0.5) / tile_w - 1.0), 0, tiles_x - 1).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor((xmax - 0.5) / tile_w), 0, tiles_x - 1).astype(jnp.int32)
    ty0 = jnp.clip(jnp.ceil((ymin + 0.5) / tile_h - 1.0), 0, tiles_y - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor((ymax - 0.5) / tile_h), 0, tiles_y - 1).astype(jnp.int32)

    span_w = jnp.maximum(tx1 - tx0 + 1, 0)
    span_h = jnp.maximum(ty1 - ty0 + 1, 0)
    n_pairs = jnp.where(valid, span_w * span_h, 0)
    return tx0, ty0, span_w, span_h, n_pairs, cls


@functools.partial(
    jax.jit,
    static_argnames=("tiles_x", "tiles_y", "tile_w", "tile_h",
                     "pair_capacity", "row_capacity", "local_tiles_y",
                     "row_stride"),
)
def bin_triangles(
    tri_data: jnp.ndarray,  # [ROWS, Tc] from triangle_setup
    lo=0,  # traced: bin only triangles with lo <= index < hi (pass class
    hi=None,  # ranges; the stream is [opaque | masked | blended])
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    pair_capacity: int,
    row_capacity: int | None = None,
    tile_row_lo=0,
    local_tiles_y: int | None = None,
    row_stride: int = 1,
):
    """Single-class binning (kept for per-stage profiling + tests; the
    production frame uses `bin_triangle_classes` — one sort for all alpha
    classes). `row_capacity` defaults to `pair_capacity` (tile rows per
    triangle never exceed its bbox pairs). Returns (binned [B_ROWS, Pp] f32
    SoA — slim layout, see KEEP_ROWS —, starts [tiles] i32,
    counts [tiles] i32, overflow_pairs i32 scalar)."""
    tc = tri_data.shape[1]
    if hi is None:
        hi = tc
    binned, starts, counts, overflow, row_ov, _pd, _rd = bin_triangle_classes(
        tri_data, (lo, hi),
        tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
        pair_capacity=pair_capacity,
        row_capacity=pair_capacity if row_capacity is None else row_capacity,
        tile_row_lo=tile_row_lo, local_tiles_y=local_tiles_y,
        row_stride=row_stride,
    )
    # fold row truncation into the loud scalar (each dropped row hides ≥ 0
    # pairs; callers only test > 0 and grow their one capacity knob)
    return binned, starts[0], counts[0], overflow[0] + row_ov


@functools.partial(
    jax.jit,
    static_argnames=("tiles_x", "tiles_y", "tile_w", "tile_h",
                     "pair_capacity", "row_capacity", "local_tiles_y",
                     "zbuckets", "row_stride"),
)
def bin_triangle_classes(
    tri_data: jnp.ndarray,  # [ROWS, Tc] from triangle_setup
    bounds,  # (C+1) traced scalars: class c = triangles [bounds[c], bounds[c+1])
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    pair_capacity: int,
    row_capacity: int | None = None,
    tile_row_lo=0,  # traced i32: first tile row this call bins (sharding)
    local_tiles_y: int | None = None,  # static: tile rows binned (None = all)
    zbuckets: int = 1,  # static: nearest-first sub-order of the OPAQUE class
    row_stride: int = 1,  # static: stride between binned tile rows
):
    """Bin all alpha classes with ONE stable sort: pairs are keyed by
    class * n_tiles + tile, so each (class, tile) segment lands contiguous
    in one shared buffer — the raster kernels for each class index
    the same binned array through their own starts/counts rows. The stream is
    ordered [opaque | masked | blended] (scene sort key), so classes are
    contiguous triangle-index ranges and pair/row truncation drops from the
    blended tail first.

    The expansion is RAGGED two-level so the sort width tracks actual
    coverage, not the bbox (the clipless setup gives w-crossing triangles a
    full-screen bbox — rectangular expansion made the bench scene demand
    814k pairs for 26k of real coverage):
      1. triangles expand to (triangle, tile-row) pairs (`row_capacity`),
      2. each row gets a tight x-window from the edge planes — for each
         edge, max of b·y + c over the row's padded y-extent turns e ≥ 0
         into a half-line in x; the window is the intersection, ±1 px of
         slack so f32 division rounding can never cull true coverage,
      3. rows expand to (triangle, tile) pairs over their windows only
         (`pair_capacity`), and the per-pair extent reject prunes the rest.

    Z-ORDER (`zbuckets` > 1): within each tile, class-0 (opaque) pairs are
    sub-ordered nearest-first at zbucket granularity — the bucket of each
    triangle's conservative nearest depth over its bbox (reverse-Z max)
    rides the SAME single sort as a low-order key component, costing no
    extra sort. The raster kernel's depth merge is an order-invariant
    lexicographic (z, triangle-id) max (raster_kernel), so the image is
    bit-identical to stream order — but the kernel's per-sub conservative
    depth rejection now sees near geometry first and skips occluded work
    (the early-Z analog; reference gets this from hardware,
    pipelines.rs:152-158). Equal-depth later-submission-wins ties are
    exact: within a bucket the stable sort keeps stream order, and the
    kernel breaks depth ties by triangle id (= submission order). The
    ORDER-DEPENDENT masked/blended/UI classes are never bucketed.

    SHARDING (`tile_row_lo` + `local_tiles_y` + `row_stride`): bin only the
    tile rows {tile_row_lo + k·row_stride : 0 ≤ k < local_tiles_y} — the
    stage-1 row expansion is clipped to that set BEFORE it costs row slots,
    windows, or sort width, so a multichip shard (parallel/mesh.py) pays
    only its own rows' O(P log P). Contiguous bands use row_stride=1;
    row_stride=n_devices INTERLEAVES rows round-robin, balancing
    screen-content load across shards. Tile keys and the starts/counts
    arrays are LOCAL (row k of the set); per-row math is shard-independent,
    so the shards' pair sets partition the full-screen expansion exactly
    (demands sum to the single-chip totals) under either layout. Defaults
    are the full screen — a no-op clip, bit-identical to the unsharded
    path.

    Returns (binned [B_ROWS, Pp] f32 SoA — slim layout, see KEEP_ROWS —,
    starts [C, tiles] i32, counts [C, tiles] i32,
    overflow_pairs [C] i32, row_overflow i32 scalar, pair_demand i32 scalar,
    row_demand i32 scalar). The demands are the UNtruncated expansion
    totals — the sizing signals for pair_capacity / row_capacity (the
    `total_pairs` / `total_rows` frame stats); when rows overflow,
    pair_demand only covers the rows that fit (grow row_capacity first)."""
    tc = tri_data.shape[1]
    if row_capacity is None:
        row_capacity = pair_capacity  # tools/tests with ample single buckets
    if local_tiles_y is None:
        local_tiles_y = tiles_y
    n_classes = len(bounds) - 1
    assert n_classes >= 1
    tx0, ty0, span_w, span_h, n_pairs, cls = _tile_spans(
        tri_data, bounds, n_classes,
        tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
    )
    # clip each triangle's tile-row span to this shard's row SET
    # {row_lo + k·stride} — in local k units (no-op for the full-screen
    # defaults: _tile_spans already clamps to [0, tiles_y-1]; jnp // is
    # floor division, so the ceil identity holds for spans starting above
    # row_lo too)
    row_lo = jnp.asarray(tile_row_lo, jnp.int32)
    ty1 = ty0 + span_h - 1
    k0 = jnp.maximum(-((row_lo - ty0) // row_stride), 0)  # ceil((ty0-lo)/s)
    k1 = jnp.minimum((ty1 - row_lo) // row_stride, local_tiles_y - 1)
    span_h = jnp.maximum(k1 - k0 + 1, 0)
    n_pairs = jnp.where(n_pairs > 0, span_w * span_h, 0)
    xmin, _ymin, xmax, _ymax = (tri_data[k] for k in BBOX_ROWS)

    # -- stage 1: (triangle, tile-row) expansion ------------------------------
    n_rows = jnp.where(n_pairs > 0, span_h, 0)
    cum_end_r = jnp.cumsum(n_rows)
    row_demand = cum_end_r[-1]
    cum_start_r = cum_end_r - n_rows
    tri_of_row = jnp.repeat(
        jnp.arange(tc, dtype=jnp.int32), n_rows, total_repeat_length=row_capacity
    )
    row_idx = jnp.arange(row_capacity, dtype=jnp.int32)
    row_live = row_idx < jnp.minimum(row_demand, row_capacity)
    # local row index within this shard's row set, and its GLOBAL tile row
    # (pixel-coordinate math below runs on the global row)
    row_k = k0[tri_of_row] + (row_idx - cum_start_r[tri_of_row])
    row_ty = row_lo + row_k * row_stride

    # tight per-row x-window: for each edge, coverage anywhere in the row's
    # padded y-extent needs a·x + max_y(b·y) + c ≥ 0 — a half-line in x
    ext_y0 = row_ty.astype(jnp.float32) * tile_h - 0.5
    ext_y1 = ext_y0 + (tile_h + 1.0)
    xlo = xmin[tri_of_row]
    xhi = xmax[tri_of_row]
    alive = row_live
    for e in range(3):
        a = tri_data[3 * e][tri_of_row]
        b = tri_data[3 * e + 1][tri_of_row]
        c = tri_data[3 * e + 2][tri_of_row]
        bb = b * jnp.where(b > 0, ext_y1, ext_y0) + c
        t = -bb / jnp.where(a == 0.0, 1.0, a)
        xlo = jnp.where(a > 0, jnp.maximum(xlo, t), xlo)
        xhi = jnp.where(a < 0, jnp.minimum(xhi, t), xhi)
        alive &= (a != 0.0) | (bb >= 0.0)
    xlo = xlo - 1.0  # one pixel of slack each side: f32 division rounding
    xhi = xhi + 1.0  # can never cull a pair the extent reject would keep
    # tile columns whose padded extent [tx·tw − 0.5, tx·tw + tw + 0.5]
    # intersects the window, clipped to the triangle's bbox span
    rx_lo = jnp.maximum(
        tx0[tri_of_row],
        jnp.ceil((xlo - 0.5) / tile_w - 1.0).astype(jnp.int32),
    )
    rx_hi = jnp.minimum(
        tx0[tri_of_row] + span_w[tri_of_row] - 1,
        jnp.floor((xhi + 0.5) / tile_w).astype(jnp.int32),
    )
    row_span = jnp.where(alive, jnp.maximum(rx_hi - rx_lo + 1, 0), 0)

    # -- stage 2: (triangle, tile) expansion over the row windows -------------
    cum_end_p = jnp.cumsum(row_span)
    total = cum_end_p[-1]  # the ragged pair demand
    cum_start_p = cum_end_p - row_span
    row_of_pair = jnp.repeat(
        row_idx, row_span, total_repeat_length=pair_capacity
    )
    pair_idx = jnp.arange(pair_capacity, dtype=jnp.int32)
    pair_live = pair_idx < jnp.minimum(total, pair_capacity)

    tri_of_pair = tri_of_row[row_of_pair]
    tile_x = rx_lo[row_of_pair] + (pair_idx - cum_start_p[row_of_pair])
    tile_y = row_ty[row_of_pair]
    # tile keys are LOCAL to the binned row set (k of tile_row_lo + k·s);
    # the kernels index starts/counts by their grid step, not the global row
    tile = row_k[row_of_pair] * tiles_x + tile_x
    n_tiles = tiles_x * local_tiles_y
    n_keys = n_classes * n_tiles  # (class, tile) GROUPS — starts/counts rows
    group = cls[tri_of_pair] * n_tiles + tile
    if zbuckets > 1:
        # nearest-first sub-key for the opaque class (see docstring): the
        # conservative nearest depth of each triangle over its bbox is the
        # corner-max of the z plane (reverse-Z: larger = nearer), bucketed
        # so nearer pairs sort earlier within their (class=0, tile) group.
        za, zb, zc = tri_data[9], tri_data[10], tri_data[11]
        ymin, ymax = tri_data[BBOX_ROWS[1]], tri_data[BBOX_ROWS[3]]
        z_near = (za * jnp.where(za > 0, xmax, xmin)
                  + zb * jnp.where(zb > 0, ymax, ymin) + zc)
        z_near = jnp.clip(z_near, 0.0, 1.0)
        zb_tri = jnp.clip(((1.0 - z_near) * zbuckets).astype(jnp.int32),
                          0, zbuckets - 1)
        sub = jnp.where(cls[tri_of_pair] == 0, zb_tri[tri_of_pair], 0)
        key = group * zbuckets + sub
    else:
        key = group
    dead = n_keys * zbuckets
    key = jnp.where(pair_live, key, dead)  # dead pairs → overflow bucket

    # Tight trivial-reject on the surviving pairs: a pair is kept only if
    # EVERY edge's most-inside corner of the tile's sample extent is inside
    # (max over the extent of the linear e(x,y) = a·x + b·y + c ≥ 0 — the
    # standard conservative triangle/box test). The row windows above are
    # conservative in x only; this is the exact 2D corner test. The extent
    # is padded a FULL pixel past the tile's pixel centers: 0.5 px bounds
    # every MSAA sample position, and the other 0.5 px drowns f32 rounding
    # of e_max in slack worth |a| + |b| — orders beyond the folded
    # watertightness eps — so a pair whose true coverage is exactly on a
    # tile boundary can never be lost to evaluation-point rounding.
    # Rejection only ever removes work the kernels would discard
    # sample-by-sample; conservativeness is pinned against a pixel-square
    # subgrid oracle in tests/test_binning_and_skinning.py.
    ext_x0 = tile_x.astype(jnp.float32) * tile_w - 0.5
    ext_x1 = ext_x0 + (tile_w + 1.0)
    ext_y0p = tile_y.astype(jnp.float32) * tile_h - 0.5
    ext_y1p = ext_y0p + (tile_h + 1.0)
    covers = pair_live
    for e in range(3):
        a = tri_data[3 * e][tri_of_pair]
        b = tri_data[3 * e + 1][tri_of_pair]
        c = tri_data[3 * e + 2][tri_of_pair]
        e_max = (a * jnp.where(a > 0, ext_x1, ext_x0)
                 + b * jnp.where(b > 0, ext_y1p, ext_y0p) + c)
        covers &= e_max >= 0.0
    key = jnp.where(covers, key, dead)

    order = jnp.argsort(key, stable=True)
    key_sorted = key[order]
    tri_sorted = tri_of_pair[order]
    # (class, tile) group of each sorted pair; dead -> n_keys sentinel
    group_sorted = key_sorted // zbuckets if zbuckets > 1 else key_sorted

    # group boundaries: a group's keys span [g*zbuckets, (g+1)*zbuckets)
    key_range = jnp.arange(n_keys, dtype=jnp.int32)
    starts_raw = jnp.searchsorted(
        key_sorted, key_range * zbuckets).astype(jnp.int32)
    ends_raw = jnp.searchsorted(
        key_sorted, (key_range + 1) * zbuckets).astype(jnp.int32)
    counts = ends_raw - starts_raw

    # live pairs sort ahead of dead ones, so the sorted order IS the bin
    # layout: segment (class, tile) occupies columns [starts_raw, ends_raw)

    slim = tri_data[jnp.asarray(KEEP_ROWS)]  # [B_ROWS, Tc]
    rows = slim[:, tri_sorted]  # [B_ROWS, P]
    rows = rows.at[B_TID].set(tri_sorted.astype(jnp.float32))
    # dead columns are zero planes, which never rasterize
    binned = jnp.where((group_sorted < n_keys)[None], rows, 0.0)

    # Per-class overflow: pair truncation keeps the first `pair_capacity`
    # pairs in triangle-stream order, so class c (pair-space range
    # [S_c, E_c)) loses max(0, E_c − cap) − max(0, S_c − cap) pairs.
    # Pair space is the RAGGED expansion (row windows), scattered per class
    # through each row's triangle.
    class_pairs = jnp.zeros(n_classes, jnp.int32).at[cls[tri_of_row]].add(
        row_span.astype(jnp.int32), mode="drop"
    )
    e_c = jnp.cumsum(class_pairs)
    s_c = e_c - class_pairs
    cap = jnp.int32(pair_capacity)
    overflow = jnp.maximum(e_c - cap, 0) - jnp.maximum(s_c - cap, 0)
    row_overflow = jnp.maximum(row_demand - jnp.int32(row_capacity), 0)
    return (binned, starts_raw.reshape(n_classes, n_tiles),
            counts.reshape(n_classes, n_tiles), overflow.astype(jnp.int32),
            row_overflow.astype(jnp.int32), total.astype(jnp.int32),
            row_demand.astype(jnp.int32))
