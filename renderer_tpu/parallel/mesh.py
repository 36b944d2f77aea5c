"""Multi-device frame rendering over a jax.sharding.Mesh.

The reference is strictly single-GPU (SURVEY.md §2.5); scaling here is an
addition of this renderer. The natural decomposition for a tile rasterizer:

- **tp (vertex parallel)**: the expanded vertex stream is sharded over
  devices; each device transforms VE/n vertices, then the (small) clip/attr
  arrays are `all_gather`ed between devices so every device holds the full
  post-transform vertex set.
- **sp (screen parallel)**: the framebuffer is sharded by tile rows; binning
  (the stage-1 row expansion is clipped to the shard's tile rows, so the
  O(P log P) pair sort and the bin scatter run at shard width), raster,
  deferred shading and tonemap all run entirely on the local shard — no
  communication. Rows are a contiguous band per device by default (image
  comes out pre-sharded for output) or ROUND-ROBIN interleaved
  (`interleave=True`) for content load balance — 6.50× vs 3.57× less
  binning work per device at sp=8 on the bench frame (work counted on the
  CPU by tools/shard_workcount.py), costing one final de-interleave
  reshuffle of the small u8 image.
  Triangle setup stays replicated DELIBERATELY: it is dense O(T) math
  (~40 flops/triangle), cheaper recomputed everywhere than all_gathering
  its 96 B/triangle output between devices (compute-over-communication, the
  standard mesh-parallel tradeoff).

Both ride one mesh axis ("sp"); a leading batch axis ("dp", multiple
cameras/frames) composes on top via vmap + an extra mesh dimension.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from renderer_tpu.core import constants
from renderer_tpu.core.config import RenderConfig
from renderer_tpu.raster import pipeline, vertex_stage


def _combine_shard_stats(stats, axis):
    """Reduce one shard's stats vector over the sp axis. Binning runs
    per-shard (stage-1 row expansion clipped to the shard's tile rows,
    binning.bin_triangle_classes tile_row_lo), so every COUNT stat —
    overflow [0:4], saturation pixels [4:8], total_pairs [8], and the row
    axis total_rows/row_overflow — is a partition of the single-chip value:
    psum reproduces it exactly (each (triangle, tile-row) belongs to exactly
    one shard and its x-window is shard-independent). The per-pixel demand
    PEAKS ([9:13]) are per-shard maxima and pmax. Capacity knobs
    (pair_capacity/row_capacity) are PER-DEVICE buffers under sharding, so a
    sizing loop should divide the psum'd demand by the shard count — or
    grow on any nonzero overflow, which is what the Renderer does."""
    i_demand = pipeline.STAT_NAMES.index("masked_demand_max")  # 9
    i_rows = pipeline.STAT_NAMES.index("total_rows")  # 13
    return jnp.concatenate([
        jax.lax.psum(stats[:i_demand], axis),
        jax.lax.pmax(stats[i_demand:i_rows], axis),
        jax.lax.psum(stats[i_rows:], axis),
    ])


def per_shard_config(config: RenderConfig, sp: int, *,
                     headroom: float = 2.0,
                     floor: int = 1 << 14) -> RenderConfig:
    """Size the PER-DEVICE binning buckets to the per-shard demand.

    Under sp tile-row sharding, binning is shard-local (stage-1 row
    expansion clipped to the shard's rows) and the shards partition the
    full-screen expansion EXACTLY (pinned by
    test_sharded_binning_partitions_full_screen) — so a per-device bucket
    sized for the full screen wastes sort/scatter width sp-fold. This
    derives a config whose pair/row buckets hold ceil(full/sp)·headroom,
    rounded up to a power of two (the repo's capacity-bucket discipline)
    and floored: headroom 2.0 absorbs content imbalance (the interleaved
    layout measures ≤1.23× imbalance at sp=8, tools/shard_workcount;
    contiguous bands can be worse — overflow stays LOUD + demand-fed either
    way, engine/renderer.py _grow_capacities).

    Reference analog: one consumed draw stream, not n full-size rebuilds
    (renderer/src/renderer.rs:219-256)."""
    import math
    from dataclasses import replace

    def shrink(cap: int) -> int:
        need = int(math.ceil(cap / sp * headroom))
        b = 1
        while b < need:
            b *= 2
        # floor INSIDE the cap: the full-screen bucket already bounds
        # per-shard demand, so never exceed it even when floor > need
        return min(max(b, floor), cap)

    return replace(config, pair_capacity=shrink(config.pair_capacity),
                   row_capacity=shrink(config.row_capacity)).validate()


def make_mesh(n_devices: int | None = None, axis: str = "sp") -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    assert n <= len(devices), f"requested {n} devices, have {len(devices)}"
    return Mesh(np.array(devices[:n]), (axis,))


def render_frame_sharded(
    geom: dict,
    frame: dict,
    materials: dict,
    *,
    config: RenderConfig,
    mesh: Mesh,
    has_masked: bool = True,
    has_blended: bool = True,
    morph_k: int = 0,
    joint_cap: int = constants.MAX_JOINT_COUNT,
    interleave: bool = False,
    interpret: bool = False,
):
    """The full frame step under shard_map. Inputs are replicated (they are
    small or needed everywhere); the returned u8 image is sharded by rows.
    Returns (image, stats i32[N_STATS]; count stats psum to the single-chip
    values, demand peaks pmax — _combine_shard_stats).

    `interleave=False` gives each device a CONTIGUOUS band of tile rows —
    zero output communication, but per-device work follows screen content
    (a camera concentrating geometry mid-screen loads the middle shards;
    tools/shard_workcount measures it). `interleave=True` assigns tile rows
    ROUND-ROBIN (device d owns rows {d + k·n}) — screen content spreads
    near-uniformly across shards, at the cost of one final de-interleave
    reshuffle of the small u8 image (H·W·3 bytes between devices)."""
    axis = mesh.axis_names[0]
    n = mesh.shape[axis]
    assert config.tiles_y % n == 0, (
        f"tiles_y={config.tiles_y} must divide over {n} devices"
    )
    assert config.height % n == 0, f"height={config.height} must divide over {n} devices"
    # one device renders the whole padded screen and crops like the
    # single-device frame; bands over several devices must tile the image
    assert (n == 1 and not interleave) or config.height == config.padded_height, (
        "sharded rendering over several devices requires height to be a "
        f"multiple of tile_h (height={config.height}, tile_h={config.tile_h})"
    )
    ve = geom["exp_src"].shape[0]
    assert ve % n == 0

    local_tiles_y = config.tiles_y // n
    rows_per_dev = config.height // n

    def step(geom, frame, materials):
        from renderer_tpu.scene.draw_stream import unpack_frame

        frame = unpack_frame(frame, morph_k=morph_k, joint_cap=joint_cap)
        i = jax.lax.axis_index(axis)

        # -- tp: transform a vertex shard, all_gather the results ----------
        per = ve // n
        start = i * per
        lgeom = dict(geom)
        lgeom["exp_src"] = jax.lax.dynamic_slice_in_dim(geom["exp_src"], start, per)
        lgeom["exp_draw"] = jax.lax.dynamic_slice_in_dim(geom["exp_draw"], start, per)
        vs_local = vertex_stage.run_vertex_stage(lgeom, frame, skin_start=None,
                                                 morph_k=morph_k)
        vs = {
            k: jax.lax.all_gather(v, axis, axis=0, tiled=True)
            for k, v in vs_local.items()
        }

        # -- sp: raster + shade + composite on this device's tile rows -----
        img, stats = pipeline.render_shard(
            geom, frame, materials, vs,
            config=config,
            has_masked=has_masked,
            has_blended=has_blended,
            local_tiles_y=local_tiles_y,
            tile_row_offset=(i if interleave else i * local_tiles_y),
            row_stride=(n if interleave else 1),
            out_rows=rows_per_dev,
            interpret=interpret,
        )
        return img, _combine_shard_stats(stats, axis)

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(axis, None, None), P()),
        check_vma=False,
    )
    img, stats = sharded(geom, frame, materials)
    if interleave:
        # device d's band holds global tile rows {d + k·n}: de-interleave
        # [n, L·th, W, 3] → [L, n, th, W, 3] → [H, W, 3] (XLA inserts the
        # resharding collective for the small final image)
        th = config.tile_h
        img = img.reshape(n, local_tiles_y, th, config.width, 3)
        img = img.transpose(1, 0, 2, 3, 4).reshape(
            config.height, config.width, 3)
    return img, stats


def jit_sharded_frame(config: RenderConfig, mesh: Mesh, interpret: bool = False,
                      morph_k: int = 0,
                      joint_cap: int = constants.MAX_JOINT_COUNT,
                      interleave: bool = False):
    return jax.jit(
        functools.partial(
            render_frame_sharded, config=config, mesh=mesh, interpret=interpret,
            morph_k=morph_k, joint_cap=joint_cap, interleave=interleave,
        )
    )


def make_mesh_2d(dp: int, sp: int) -> Mesh:
    """2D device mesh: 'dp' batches independent frames (multiple cameras /
    animation times), 'sp' splits each frame's tile rows."""
    devices = jax.devices()
    assert dp * sp <= len(devices), f"need {dp * sp} devices, have {len(devices)}"
    return Mesh(np.array(devices[: dp * sp]).reshape(dp, sp), ("dp", "sp"))


def render_frames_batched(
    geom: dict,
    frames: dict,  # per-frame arrays with a leading batch axis [B, ...]
    materials: dict,
    *,
    config: RenderConfig,
    mesh: Mesh,  # ('dp', 'sp') mesh with dp == B
    has_masked: bool = True,
    has_blended: bool = True,
    morph_k: int = 0,
    joint_cap: int = constants.MAX_JOINT_COUNT,
    interleave: bool = False,
    interpret: bool = False,
):
    """dp × sp frame rendering: each dp group renders one frame of the batch
    (own camera/transforms/joints over shared geometry+materials), internally
    sharded over tile rows. Returns (u8 [B, H, W, 3] sharded (dp, sp),
    stats i32 [B, N_STATS] sharded (dp,)) — per-frame stats combined over sp
    like render_frame_sharded, so overflow anywhere in the batch is loud
    (check max over the batch axis, the render_frames_device policy).

    `interleave=True` assigns each sp shard ROUND-ROBIN tile rows exactly as
    render_frame_sharded does (device d of a dp group owns rows {d + k·sp})
    — the measured 6.50×-vs-3.57× per-device load balance at sp=8
    (TIMINGS.md) applies per batched frame too, at the cost of one final
    de-interleave reshuffle of the small u8 images."""
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    batch = jax.tree_util.tree_leaves(frames)[0].shape[0]
    assert batch == dp, f"frame batch {batch} must equal dp={dp}"
    assert config.tiles_y % sp == 0 and config.height % sp == 0
    assert config.height == config.padded_height
    ve = geom["exp_src"].shape[0]
    assert ve % sp == 0

    local_tiles_y = config.tiles_y // sp
    rows_per_dev = config.height // sp

    def step(geom, frames_local, materials):
        from renderer_tpu.scene.draw_stream import unpack_frame

        frame = unpack_frame(
            jax.tree_util.tree_map(lambda a: a[0], frames_local),
            morph_k=morph_k, joint_cap=joint_cap,
        )
        i = jax.lax.axis_index("sp")

        per = ve // sp
        start = i * per
        lgeom = dict(geom)
        lgeom["exp_src"] = jax.lax.dynamic_slice_in_dim(geom["exp_src"], start, per)
        lgeom["exp_draw"] = jax.lax.dynamic_slice_in_dim(geom["exp_draw"], start, per)
        vs_local = vertex_stage.run_vertex_stage(lgeom, frame, skin_start=None,
                                                 morph_k=morph_k)
        vs = {
            k: jax.lax.all_gather(v, "sp", axis=0, tiled=True)
            for k, v in vs_local.items()
        }

        img, stats = pipeline.render_shard(
            geom, frame, materials, vs,
            config=config,
            has_masked=has_masked,
            has_blended=has_blended,
            local_tiles_y=local_tiles_y,
            tile_row_offset=(i if interleave else i * local_tiles_y),
            row_stride=(sp if interleave else 1),
            out_rows=rows_per_dev,
            interpret=interpret,
        )
        stats = _combine_shard_stats(stats, "sp")
        return img[None], stats[None]  # local [1, rows, W, 3], [1, N_STATS]

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P("dp"), P()),
        out_specs=(P("dp", "sp", None, None), P("dp", None)),
        check_vma=False,
    )
    imgs, stats = sharded(geom, frames, materials)
    if interleave:
        # each dp group's sp shard d holds global tile rows {d + k·sp}:
        # de-interleave [B, sp·L·th, W, 3] → [B, L, sp, th, W, 3] → [B, H, W, 3]
        th = config.tile_h
        imgs = imgs.reshape(dp, sp, local_tiles_y, th, config.width, 3)
        imgs = imgs.transpose(0, 2, 1, 3, 4, 5).reshape(
            dp, config.height, config.width, 3)
    return imgs, stats
