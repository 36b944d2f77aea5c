"""Pallas visibility-buffer raster kernel (opaque z-max).

Replaces the Vulkan fixed-function rasterizer + depth test
[fixed-function → kernel]. Binning hands every screen tile (tile_h × tile_w
pixels) a contiguous list of the triangles that may touch it. The kernel
grid splits each bin tile into pixel blocks (bh × bw): one program owns one
block, keeps its [S, bh, bw] depth + triangle-id state in registers, loads
its own tile's (start, count) and walks that list once for every sample
position. Programs of one tile read the same list, which stays in L1/L2.
Programs are independent: the grid carries no state between steps.

Per triangle the three edge functions and the depth plane are evaluated
over the block at each sample, and the block's z-buffer is merged. Every
`sub` triangles a conservative early-depth test (the early-Z analog, see
sub_z_near) may skip the whole group.

MSAA: ALL sample positions are evaluated per streamed triangle (the
edge/depth planes at each Vulkan standard position), writing [S, bh, bw]
blocks — one pass over the binned buffer serves every sample.

Depth semantics parity: clear depth = 0.0, compare GREATER_OR_EQUAL
(reference: renderer/src/renderer/pipeline_parameters/render_passes.rs:192-197,
renderer/src/renderer/pipelines.rs:152-158); on equal depth the
later-submitted triangle wins, matching draw order. The merge is written as
a lexicographic (z, triangle-id) max — equivalent to the submission-order
semantics (stream index = submission order) and ORDER-INVARIANT, which lets
binning feed pairs nearest-first (zbuckets) so the conservative depth
rejection can skip occluded work without changing any pixel, and makes the
image independent of the tile and block shapes.

Output: per-pixel {depth f32, tri_id i32} (tri_id = -1 where uncovered); all
shading happens in the deferred stage (raster/shade.py), so raster cost is
independent of material complexity and shading cost is independent of
overdraw.

`rasterize_binned_reference` is the same computation in plain jnp/lax
(one XLA loop step per list position, every tile at once): the on-device
reference the kernel is compared with, and the XLA route it was timed
against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from renderer_tpu.raster.binning import B_ROWS, B_TID

# Warps per program on the GPU.
NUM_WARPS = 4


def block_shape(tile_h: int, tile_w: int, interpret: bool) -> tuple[int, int]:
    """Pixel block one program owns. The interpreter (CPU) takes the whole
    bin tile — fewer, wider grid steps. On the GPU it is one pixel per
    thread: NUM_WARPS rows of 32 pixels, which keeps every kernel's
    [S, (K,) bh, bw] state in registers and puts the most programs in
    flight (the fastest of 4×32 … 32×32 blocks for all three kernels on an
    H100, PERF.md). Both dimensions divide the power-of-two tile."""
    if interpret:
        return tile_h, tile_w
    return min(tile_h, NUM_WARPS), min(tile_w, 32)


def edge_cover(a, b, c, px, py):
    """Top-left fill rule [fixed-function → kernel: the Vulkan
    watertightness rule]: pixels in the ±eps boundary band of an edge belong
    to exactly one of the two triangles sharing it (ownership by the edge
    plane's coefficient signs). The band is pre-folded into C (setup.py):
    covered ⟺ e' > 0, with the owning edge keeping its boundary via the ≥
    tie-break. e is evaluated as one expression for every triangle, so the
    two triangles of a shared edge (negated planes) get exactly negated
    values under any contraction the compiler applies. Zero planes (padding
    rows) never cover."""
    e = a * px + b * py + c
    own = (a > 0.0) | ((a == 0.0) & (b > 0.0))
    return (e > 0.0) | (own & (e >= 0.0))


def fragment(t, px, py):
    """Coverage, depth and triangle id of ONE triangle whose binned plane
    rows (binning.KEEP_ROWS: edges 0-8, depth 9-11, 1/w 12-14, id B_TID)
    are read through `t(k)`. 1/w > 0 excludes the anti-triangle branch of
    near-crossing triangles; z ∈ [0, 1] is the Vulkan depth-range clip
    (= near clip under reverse-Z)."""
    cover = (edge_cover(t(0), t(1), t(2), px, py)
             & edge_cover(t(3), t(4), t(5), px, py)
             & edge_cover(t(6), t(7), t(8), px, py))
    z = t(9) * px + t(10) * py + t(11)
    inv_w = t(12) * px + t(13) * py + t(14)
    cover = cover & (inv_w > 0.0) & (z >= 0.0) & (z <= 1.0)
    return cover, z, t(B_TID).astype(jnp.int32)


def zmax_merge(cover, z, tid, depth, trid):
    """Lexicographic (z, id) max merge: on equal depth the LARGER triangle
    id wins = later submission (reference depth-tie parity), and the merge
    is order-invariant."""
    write = cover & ((z > depth) | ((z == depth) & (tid > trid)))
    return jnp.where(write, z, depth), jnp.where(write, tid, trid)


def _opaque_kernel(starts_ref, counts_ref, tri_ref, depth_ref, trid_ref, *,
                   tile_h: int, tile_w: int, bh: int, bw: int, tiles_x: int,
                   sub: int, sample_positions: tuple, row_stride: int):
    n_s = len(sample_positions)
    blocks_y = tile_h // bh
    # bins are LOCAL to this shard's tile-row range (binning tile_row_lo):
    # starts/counts are indexed by the local tile; the global tile row
    # (local row · row_stride + tile_row_offset, the offset stashed as the
    # last starts entry) only feeds the pixel coordinates.
    bi = pl.program_id(0)
    bj = pl.program_id(1)
    lty = bi // blocks_y
    tile = lty * tiles_x + bj // (tile_w // bw)
    ty = lty * row_stride + starts_ref[counts_ref.shape[0]]
    start = starts_ref[tile]
    count = counts_ref[tile]

    x0 = (bj * bw).astype(jnp.float32)
    y0 = (ty * tile_h + (bi % blocks_y) * bh).astype(jnp.float32)
    ix = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1).astype(jnp.float32)
    iy = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0).astype(jnp.float32)
    px = [x0 + dx + ix for dx, _ in sample_positions]
    py = [y0 + dy + iy for _, dy in sample_positions]

    # Conservative block extent for the early-depth test: every sample
    # position lies in [x0, x0 + bw) × [y0, y0 + bh).
    ex0, ex1 = x0, x0 + float(bw)
    ey0, ey1 = y0, y0 + float(bh)
    lane = jnp.arange(sub, dtype=jnp.int32)

    def sub_z_near(base):
        """Conservative NEAREST depth (reverse-Z max) any triangle of the
        group [base, base + sub) can write anywhere in this block:
        corner-max of each depth plane over the block extent, clamped to
        the z ≤ 1 depth-range clip. Rows past the list end load as zero
        planes and contribute 0 — never the max of a group with live work,
        and a harmless no-skip while the block still has background."""
        live = base + lane < count

        def row(k):
            return plgpu.load(tri_ref.at[k, pl.ds(start + base, sub)],
                              mask=live, other=0.0)

        za, zb, zc = row(9), row(10), row(11)
        zm = (za * jnp.where(za > 0, ex1, ex0)
              + zb * jnp.where(zb > 0, ey1, ey0) + zc)
        return jnp.max(jnp.minimum(zm, 1.0))

    def tri_body(idx, state):
        depth, trid = state
        depth, trid = list(depth), list(trid)

        def t(k):
            return tri_ref[k, idx]

        for s in range(n_s):
            cover, z, tid = fragment(t, px[s], py[s])
            depth[s], trid[s] = zmax_merge(cover, z, tid, depth[s], trid[s])
        return tuple(depth), tuple(trid)

    def group_body(g, state):
        base = g * sub
        # Early-depth rejection (the early-Z analog; reference:
        # pipelines.rs:152-158 hardware depth test): the FARTHEST depth
        # stored anywhere in the block (min over samples and pixels;
        # reverse-Z). A group whose conservative nearest depth is STRICTLY
        # farther cannot win any sample (equal depth is kept) — skip it.
        # With nearest-first pair order (binning zbuckets) a covered block
        # starts skipping after the first opaque layers.
        d_min = functools.reduce(jnp.minimum,
                                 [jnp.min(d) for d in state[0]])
        first = start + base
        last = start + jnp.minimum(base + sub, count)
        return jax.lax.cond(
            sub_z_near(base) >= d_min,
            lambda st: jax.lax.fori_loop(first, last, tri_body, st),
            lambda st: st,
            state)

    state0 = (tuple(jnp.zeros((bh, bw), jnp.float32) for _ in range(n_s)),
              tuple(jnp.full((bh, bw), -1, jnp.int32) for _ in range(n_s)))
    depth, trid = jax.lax.fori_loop(0, (count + sub - 1) // sub, group_body,
                                    state0)
    for s in range(n_s):
        depth_ref[s] = depth[s]
        trid_ref[s] = trid[s]


def _starts_plus(starts, tile_row_offset):
    """starts with the shard's first global tile row appended (read by the
    kernels as the last entry)."""
    return jnp.concatenate(
        [starts.astype(jnp.int32),
         jnp.asarray(tile_row_offset, jnp.int32).reshape(1)])


@functools.partial(
    jax.jit,
    static_argnames=("padded_height", "padded_width", "tile_h", "tile_w",
                     "sub", "sample_positions", "interpret", "row_stride",
                     "block"),
)
def rasterize_binned(
    binned: jnp.ndarray,  # [B_ROWS, Pp] f32 slim SoA from binning
    starts: jnp.ndarray,  # [tiles] i32
    counts: jnp.ndarray,  # [tiles] i32
    *,
    tile_row_offset=0,
    padded_height: int,
    padded_width: int,
    tile_h: int = 32,
    tile_w: int = 128,
    sub: int = 8,
    sample_positions: tuple = ((0.5, 0.5),),  # in-pixel positions (MSAA)
    row_stride: int = 1,  # global-row stride (interleaved sp sharding)
    interpret: bool = False,
    block: tuple | None = None,  # (bh, bw) override of block_shape
):
    """Per-tile-binned visibility raster: every program streams its tile's
    (contiguous) triangle rows ONCE and evaluates every sample position.
    Returns (depth [S, Hp, Wp], tri_id [S, Hp, Wp])."""
    assert binned.shape[0] == B_ROWS, binned.shape
    tiles_x = padded_width // tile_w
    n_s = len(sample_positions)
    bh, bw = block or block_shape(tile_h, tile_w, interpret)
    assert tile_h % bh == 0 and tile_w % bw == 0, (tile_h, tile_w, bh, bw)
    kernel = functools.partial(
        _opaque_kernel, tile_h=tile_h, tile_w=tile_w, bh=bh, bw=bw,
        tiles_x=tiles_x,
        sub=sub, sample_positions=tuple(sample_positions),
        row_stride=row_stride,
    )
    out_block = pl.BlockSpec((n_s, bh, bw), lambda i, j: (0, i, j))
    return pl.pallas_call(
        kernel,
        grid=(padded_height // bh, padded_width // bw),
        in_specs=[pl.no_block_spec] * 3,
        out_specs=(out_block, out_block),
        out_shape=(
            jax.ShapeDtypeStruct((n_s, padded_height, padded_width), jnp.float32),
            jax.ShapeDtypeStruct((n_s, padded_height, padded_width), jnp.int32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="raster_opaque",
    )(_starts_plus(starts, tile_row_offset), counts.astype(jnp.int32), binned)


def tile_rows(binned, starts, counts, i, *, tiles_y: int, tiles_x: int,
              tile_h: int, tile_w: int):
    """Row `i` of every tile's bin list, broadcast to the pixels of its
    tile: [B_ROWS, Hp, Wp] planes (zero planes — which never cover — where
    the list is shorter than i + 1)."""
    live = i < counts
    rows = jnp.where(live[None], binned[:, jnp.where(live, starts + i, 0)], 0.0)
    rows = rows.reshape(B_ROWS, tiles_y, 1, tiles_x, 1)
    return jnp.broadcast_to(
        rows, (B_ROWS, tiles_y, tile_h, tiles_x, tile_w)
    ).reshape(B_ROWS, tiles_y * tile_h, tiles_x * tile_w)


def pixel_coords(tile_row_offset, *, tiles_y: int, tile_h: int,
                 padded_width: int, row_stride: int, sample_positions):
    """Per-sample pixel coordinates of the padded shard: px [S][1, Wp],
    py [S][Hp, 1] (global rows under sharding)."""
    ty = (jnp.arange(tiles_y, dtype=jnp.int32) * row_stride
          + jnp.asarray(tile_row_offset, jnp.int32))
    gy = (ty[:, None] * tile_h
          + jnp.arange(tile_h, dtype=jnp.int32)[None]).reshape(-1)
    gy = gy.astype(jnp.float32)[:, None]
    gx = jnp.arange(padded_width, dtype=jnp.float32)[None, :]
    return ([gx + dx for dx, _ in sample_positions],
            [gy + dy for _, dy in sample_positions])


@functools.partial(
    jax.jit,
    static_argnames=("padded_height", "padded_width", "tile_h", "tile_w",
                     "sub", "sample_positions", "interpret", "row_stride",
                     "block"),
)
def rasterize_binned_reference(
    binned, starts, counts, *, tile_row_offset=0, padded_height: int,
    padded_width: int, tile_h: int = 32, tile_w: int = 128, sub: int = 8,
    sample_positions: tuple = ((0.5, 0.5),), row_stride: int = 1,
    interpret: bool = False, block: tuple | None = None,
):
    """rasterize_binned in plain jnp/lax (same signature; `sub`,
    `interpret` and `block` are ignored): one loop step per bin-list
    position, every tile at once, the [S, Hp, Wp] state read and written
    in device memory on every step."""
    del sub, interpret, block
    tiles_y = padded_height // tile_h
    tiles_x = padded_width // tile_w
    n_s = len(sample_positions)
    px, py = pixel_coords(tile_row_offset, tiles_y=tiles_y, tile_h=tile_h,
                          padded_width=padded_width, row_stride=row_stride,
                          sample_positions=sample_positions)
    st = starts.reshape(tiles_y, tiles_x)
    ct = counts.reshape(tiles_y, tiles_x)

    def body(i, state):
        depth, trid = state
        rows = tile_rows(binned, st, ct, i, tiles_y=tiles_y, tiles_x=tiles_x,
                         tile_h=tile_h, tile_w=tile_w)

        def t(k):
            return rows[k]

        out_d, out_t = [], []
        for s in range(n_s):
            cover, z, tid = fragment(t, px[s], py[s])
            d, tr = zmax_merge(cover, z, tid, depth[s], trid[s])
            out_d.append(d)
            out_t.append(tr)
        return jnp.stack(out_d), jnp.stack(out_t)

    shape = (n_s, padded_height, padded_width)
    return jax.lax.fori_loop(
        0, jnp.max(counts, initial=0), body,
        (jnp.zeros(shape, jnp.float32), jnp.full(shape, -1, jnp.int32)))
