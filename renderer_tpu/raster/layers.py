"""Layered raster kernels for non-opaque geometry [fixed-function → kernel].

The reference renders alpha-to-coverage ("masked") and blended geometry
through the same fixed-function raster path with different pipeline state
(reference: renderer/src/renderer/pipeline_parameters.rs:227-233 — a2c and
blended both inherit depth test GREATER_OR_EQUAL *and depth write* from the
opaque pipelines, drawn after opaque in pipeline order,
renderer.rs:433-441). In a visibility-buffer renderer those passes cannot be
a single winner-takes-all z-test:

- **Masked** (alpha cutoff): the fragment shader may discard, so the raster
  result is "the nearest fragment whose alpha passes". Because failed
  fragments never write depth, the result is order-independent → capture the
  top-K nearest candidate fragments per pixel (insertion sort in registers),
  alpha-test them in the deferred stage, take the nearest passer.
- **Blended**: src-alpha blending is order-dependent and depth-write prunes:
  a fragment is accepted iff its depth ≥ every previously accepted depth
  (submission order). Capture the accepted chain (up to K layers, in order)
  per pixel, shade each layer deferred, composite in order.

Both kernels walk their (binned, per-tile) triangle lists strictly in
submission order — required for insertion/ordering. Like the opaque kernel
(raster_kernel.py), a program owns one pixel block of a bin tile, keeps its
[S, K, bh, bw] layer state in registers and reads each triangle's plane rows
as scalars. MSAA: every sample position maintains its own K-layer state,
updated from ONE shared pass over the triangle list.

`rasterize_layers_reference` is the same computation in plain jnp/lax:
the on-device reference, and the XLA route the kernel was timed against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from renderer_tpu.raster.binning import B_ROWS
from renderer_tpu.raster.raster_kernel import (
    NUM_WARPS,
    _starts_plus,
    block_shape,
    fragment,
    pixel_coords,
    tile_rows,
)


def layer_update(mode: str, cover, z, tid, lz, lt, aux, cur_z):
    """Apply one fragment (coverage, depth, id) of one sample to its
    K-layer state: lz, lt are K-lists of [.., H, W] arrays, aux the
    per-pixel candidate/accept count, cur_z the running depth floor.
    Returns the updated (lz, lt, aux, cur_z)."""
    n_layers = len(lz)
    lz, lt = list(lz), list(lt)
    c = cover & (z >= cur_z)
    if mode == "masked":
        # top-K nearest insertion; ≥ keeps later-submission-wins on equal
        # depth. cur_z is the opaque depth floor. aux counts every candidate
        # so aux > K flags pixels whose K-nearest capture may have dropped
        # a passing fragment.
        cz = jnp.where(c, z, -1.0)
        ct = jnp.where(c, tid, -1)
        for k in range(n_layers):
            sw = cz >= lz[k]
            lz[k], cz = jnp.where(sw, cz, lz[k]), jnp.where(sw, lz[k], cz)
            lt[k], ct = jnp.where(sw, ct, lt[k]), jnp.where(sw, lt[k], ct)
        return lz, lt, aux + c.astype(jnp.int32), cur_z
    # blended — ordered accept: depth test vs the running chain depth,
    # accepted fragments write depth (pipeline_parameters.rs blended
    # inherits depth_write from opaque). A fragment past the K-layer
    # capacity is dropped WITHOUT writing depth: the truncation may
    # under-blend but never makes a dropped fragment occlude later geometry
    # (the reference's fixed-function blending has no layer cap,
    # pipelines.rs:112-132). aux counts all accepts, so aux > K flags
    # saturated pixels.
    for k in range(n_layers):
        put = c & (aux == k)
        lt[k] = jnp.where(put, tid, lt[k])
        lz[k] = jnp.where(put, z, lz[k])
    stored = c & (aux < n_layers)
    return lz, lt, aux + c.astype(jnp.int32), jnp.where(stored, z, cur_z)


def _layer_kernel(starts_ref, counts_ref, tri_ref, depth_in_ref,
                  lz_ref, lt_ref, aux_ref, *, mode: str, n_layers: int,
                  tile_h: int, tile_w: int, bh: int, bw: int, tiles_x: int,
                  sample_positions: tuple, row_stride: int):
    n_s = len(sample_positions)
    blocks_y = tile_h // bh
    # bins are LOCAL to this shard's tile-row range (see raster_kernel)
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

    def tri_body(idx, state):
        def t(k):
            return tri_ref[k, idx]

        out = []
        for s in range(n_s):
            cover, z, tid = fragment(t, px[s], py[s])
            out.append(tuple(layer_update(mode, cover, z, tid, *state[s])))
        return tuple(out)

    # aux: per-(sample, pixel) count of candidate (masked) / accepted
    # (blended) fragments — may exceed n_layers, flagging truncated
    # capture. The running depth starts from the (per-sample) solid depth.
    state = tuple(
        ([jnp.full((bh, bw), -1.0, jnp.float32)] * n_layers,
         [jnp.full((bh, bw), -1, jnp.int32)] * n_layers,
         jnp.zeros((bh, bw), jnp.int32),
         depth_in_ref[s])
        for s in range(n_s))
    state = jax.lax.fori_loop(start, start + count, tri_body, state)
    for s in range(n_s):
        lz, lt, aux, _ = state[s]
        for k in range(n_layers):
            lz_ref[s, k] = lz[k]
            lt_ref[s, k] = lt[k]
        aux_ref[s] = aux


@functools.partial(
    jax.jit,
    static_argnames=(
        "mode", "n_layers", "padded_height",
        "padded_width", "tile_h", "tile_w", "sample_positions", "interpret",
        "row_stride", "block",
    ),
)
def rasterize_layers(
    binned: jnp.ndarray,  # [B_ROWS, Pp] f32 slim SoA (binning output)
    starts: jnp.ndarray,
    counts: jnp.ndarray,
    depth_in: jnp.ndarray,  # [S, Hp, Wp] f32 — per-sample depth floor
    *,
    mode: str,
    n_layers: int,
    tile_row_offset=0,
    padded_height: int,
    padded_width: int,
    tile_h: int = 32,
    tile_w: int = 128,
    sample_positions: tuple = ((0.5, 0.5),),  # in-pixel positions (MSAA)
    row_stride: int = 1,  # global-row stride (interleaved sp sharding)
    interpret: bool = False,
    block: tuple | None = None,  # (bh, bw) override of block_shape
):
    """Returns (layer_z [S,K,Hp,Wp] f32, layer_tid [S,K,Hp,Wp] i32,
    aux [S,Hp,Wp] i32 — per-(sample, pixel) candidate/accept count;
    aux > n_layers marks pixels whose capture was truncated). Layer order:
    masked = nearest first; blended = acceptance (submission) order."""
    assert mode in ("masked", "blended")
    assert binned.shape[0] == B_ROWS, binned.shape
    tiles_x = padded_width // tile_w
    n_s = len(sample_positions)
    assert depth_in.shape == (n_s, padded_height, padded_width), depth_in.shape
    bh, bw = block or block_shape(tile_h, tile_w, interpret)
    assert tile_h % bh == 0 and tile_w % bw == 0, (tile_h, tile_w, bh, bw)
    kernel = functools.partial(
        _layer_kernel, mode=mode, n_layers=n_layers, tile_h=tile_h,
        tile_w=tile_w, bh=bh, bw=bw, tiles_x=tiles_x,
        sample_positions=tuple(sample_positions), row_stride=row_stride,
    )
    sample_block = pl.BlockSpec((n_s, bh, bw), lambda i, j: (0, i, j))
    layer_block = pl.BlockSpec((n_s, n_layers, bh, bw),
                               lambda i, j: (0, 0, i, j))
    layer_shape = (n_s, n_layers, padded_height, padded_width)
    return pl.pallas_call(
        kernel,
        grid=(padded_height // bh, padded_width // bw),
        in_specs=[pl.no_block_spec] * 3 + [sample_block],
        out_specs=(layer_block, layer_block, sample_block),
        out_shape=(
            jax.ShapeDtypeStruct(layer_shape, jnp.float32),
            jax.ShapeDtypeStruct(layer_shape, jnp.int32),
            jax.ShapeDtypeStruct((n_s, padded_height, padded_width), jnp.int32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=f"raster_{mode}",
    )(_starts_plus(starts, tile_row_offset), counts.astype(jnp.int32), binned,
      depth_in)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mode", "n_layers", "padded_height",
        "padded_width", "tile_h", "tile_w", "sample_positions", "interpret",
        "row_stride", "block",
    ),
)
def rasterize_layers_reference(
    binned, starts, counts, depth_in, *, mode: str, n_layers: int,
    tile_row_offset=0, padded_height: int, padded_width: int,
    tile_h: int = 32, tile_w: int = 128,
    sample_positions: tuple = ((0.5, 0.5),), row_stride: int = 1,
    interpret: bool = False, block: tuple | None = None,
):
    """rasterize_layers in plain jnp/lax (same signature; `interpret` and
    `block` are ignored): one loop step per bin-list position, every tile at
    once, the [S, K, Hp, Wp] layer state read and written in device memory
    on every step."""
    del interpret, block
    assert mode in ("masked", "blended")
    tiles_y = padded_height // tile_h
    tiles_x = padded_width // tile_w
    n_s = len(sample_positions)
    px, py = pixel_coords(tile_row_offset, tiles_y=tiles_y, tile_h=tile_h,
                          padded_width=padded_width, row_stride=row_stride,
                          sample_positions=sample_positions)
    st = starts.reshape(tiles_y, tiles_x)
    ct = counts.reshape(tiles_y, tiles_x)

    def body(i, state):
        rows = tile_rows(binned, st, ct, i, tiles_y=tiles_y, tiles_x=tiles_x,
                         tile_h=tile_h, tile_w=tile_w)

        def t(k):
            return rows[k]

        out = []
        for s in range(n_s):
            cover, z, tid = fragment(t, px[s], py[s])
            out.append(tuple(layer_update(mode, cover, z, tid, *state[s])))
        return tuple(out)

    hw = (padded_height, padded_width)
    state = tuple(
        ([jnp.full(hw, -1.0, jnp.float32)] * n_layers,
         [jnp.full(hw, -1, jnp.int32)] * n_layers,
         jnp.zeros(hw, jnp.int32),
         depth_in[s])
        for s in range(n_s))
    state = jax.lax.fori_loop(0, jnp.max(counts, initial=0), body, state)
    lz = jnp.stack([jnp.stack(st[0]) for st in state])
    lt = jnp.stack([jnp.stack(st[1]) for st in state])
    aux = jnp.stack([st[2] for st in state])
    return lz, lt, aux
