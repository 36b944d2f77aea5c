"""Frame-function assembly: the whole GPU column of the reference's frame
(vertex transform+skinning → raster/depth → shading → tonemap,
reference: renderer/src/renderer.rs:359-572 command buffer) as one jittable
function over device arrays.

Pass structure (matching the reference's pipeline iteration order,
renderer.rs:433-441 — opaque, then alpha-to-coverage, then blended — all
sharing one reverse-Z depth buffer):

1. vertex + skinning (vertex_stage)
2. triangle setup + per-tile binning (setup, binning)
3. opaque visibility raster (raster_kernel.rasterize_binned)
4. masked (alpha-cutoff) top-K layer raster (layers) → per-layer alpha test →
   merge the nearest passing fragment into the visibility buffer
5. one deferred full shade of the merged solid visibility buffer (shade)
6. blended ordered-accept layer raster (layers) → per-layer full shade →
   src-alpha composite in acceptance order (pipelines.rs:112-132)
7. ACES tonemap + sRGB encode (post)

MSAA 4× (the reference's default, examples/sandbox/src/main.rs:114-117):
VISIBILITY (steps 3, 4-raster, 6-raster) runs once per sample by evaluating
the edge/depth planes at the Vulkan standard sample positions inside the
kernels (compile-time constants; the binned buffer is shared across samples,
built with a half-pixel-padded bbox); SHADING runs once per distinct per-pixel triangle
candidate across samples/layers and is selected back per sample (hardware
MSAA's shade-per-covered-primitive; attributes interpolate at pixel centers,
so shading is a pure function of triangle id). Resolve is AVERAGE after
per-sample tonemap (render_passes.rs:28-42; the post pass runs per sample,
physical_device.rs:265-266). Alpha-to-coverage gets the per-sample coverage
thresholds a·4 > s+0.5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from renderer_tpu.core import constants
from renderer_tpu.core.config import RenderConfig
from renderer_tpu.raster import (
    binning,
    layers,
    post,
    raster_kernel,
    setup,
    shade,
    ui_stage,
    vertex_stage,
)

# Vulkan standard sample locations (spec "Multisampling" standard sample
# locations table), pixel-relative. The reference library is parameterized
# over any supported attachment_sample_count (pipelines.rs:20-27 takes it as
# a constructor argument; the sandbox picks TYPE_4 at main.rs:114-115) — the
# same counts are accepted here, with the visibility kernels evaluating the
# edge/depth planes at these positions per sample.
STANDARD_SAMPLE_POSITIONS = {
    1: ((0.5, 0.5),),
    2: ((0.75, 0.75), (0.25, 0.25)),
    4: ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875)),
    8: ((0.5625, 0.3125), (0.4375, 0.6875), (0.8125, 0.5625),
        (0.3125, 0.1875), (0.1875, 0.8125), (0.0625, 0.4375),
        (0.6875, 0.9375), (0.9375, 0.0625)),
}
MSAA4_POSITIONS = STANDARD_SAMPLE_POSITIONS[4]

# Per-frame device stats vector (i32[N_STATS]) returned next to the image —
# the analog of the reference's loud resource-exhaustion errors
# (arena/buffers.rs:126-163 reports used/total/required on OOM). Overflow
# entries count (tile, triangle) pairs dropped by binning (pair_capacity
# exceeded); saturation entries count pixels whose layered capture was
# truncated (more overlapping fragments than mask_layers/blend_layers).
STAT_NAMES = (
    "overflow_opaque",
    "overflow_masked",
    "overflow_blended",
    "overflow_ui",
    "masked_saturated_px",
    "blended_saturated_px",
    "ui_saturated_px",
    "shade_clamped_px",
    # total (tile, triangle) pairs the scene's RAGGED expansion requested
    # this frame (the per-tile-row edge-window expansion, binning stage 2 —
    # near-exact coverage, not the bbox) — the feedback signal for
    # right-sizing pair_capacity: the binning sort costs
    # O(capacity log capacity) REGARDLESS of scene size, so the Renderer
    # shrinks oversized buckets from this (like the reference's exact
    # measure-then-allocate arenas, arena/buffers.rs).
    "total_pairs",
    # Peak per-pixel layered-capture demand (max over samples and image-area
    # pixels of the aux fragment counts) for each layered class — the
    # feedback signal for right-sizing mask_layers / blend_layers / ui_layers
    # at runtime: demand > K means the K-layer capture truncated somewhere
    # (the reference's fixed-function blending is unbounded,
    # pipelines.rs:112-132, so the Renderer grows the layer count toward the
    # measured demand), demand ≤ K/2 sustained means the per-layer shading
    # passes are oversized and can shrink back.
    "masked_demand_max",
    "blended_demand_max",
    "ui_demand_max",
    # Peak per-pixel count of DISTINCT solid triangles across the MSAA
    # samples — the demand signal for msaa_shade_candidates (shading is
    # exact when the candidate set is at least this deep; the Renderer grows
    # the knob toward it, bounded by msaa_samples).
    "shade_demand_max",
    # Ragged-binning row axis (binning.bin_triangle_classes stage 1):
    # (triangle, tile-row) expansion demand and its truncation — the
    # feedback pair for row_capacity, exactly like total_pairs /
    # overflow_* for pair_capacity. Appended last so older stats vectors
    # (multi-frame scans recorded before this stat existed) keep their
    # indices.
    "total_rows",
    "row_overflow",
)
N_STATS = len(STAT_NAMES)


def _extract_candidates(tids: list, n: int) -> list:
    """Per-pixel: the first `n` DISTINCT triangle ids across the slot list
    (slot order = priority). Returns n candidate maps ([H,W] i32, -2 where
    fewer than n distinct ids exist). The -1 background sentinel is skipped —
    background samples/layers never consult the shaded candidates (their
    select is gated on tid ≥ 0), so spending a slot on -1 would only starve
    a real triangle out of the set. Pure elementwise ops — XLA fuses the
    whole extraction into one pass over the slots."""
    cands: list = []
    for _ in range(n):
        nxt = jnp.full_like(tids[0], -2)
        # reversed so the EARLIEST slot with a new value wins the overwrite
        for t in reversed(tids):
            is_new = t != -1
            for c in cands:
                is_new &= t != c
            nxt = jnp.where(is_new, t, nxt)
        cands.append(nxt)
    return cands


def _pick_strip_rows(c: int, hp: int, wp: int, tile_h: int, budget: int) -> int:
    """Strip height (pixel rows, a whole-tile-row multiple) for striped
    stacked shading: the LARGEST tile-row multiple whose [c, strip, wp]
    element count fits `budget` (RenderConfig.shade_strip_elems; 0 = never
    split). Returns hp when the whole stack fits. Strips need not divide
    the tile-row count — _shade_striped runs the equal strips under one
    lax.map body plus a shorter remainder strip as a second call (two
    traced shapes max), so a prime tile-row count (e.g. 720p's 23) splits
    into ceil-sized strips instead of collapsing to per-tile-row serial
    work (round-3 advisor finding)."""
    if budget <= 0 or c * hp * wp <= budget:
        return hp
    rows = max(budget // (c * tile_h * wp), 1)
    return min(rows * tile_h, hp)


def _shade_striped(stack, row0, strip_h: int, fn):
    """Run fn(tid [c, h, w] i32, row0 [h, 1] per-row y offset) -> pytree of
    [c, h, w, ...]
    over tile-row strips of `strip_h` pixel rows with lax.map (plus one
    direct call for a shorter remainder strip when strip_h does not divide
    the height), concatenating the results back to full height. The
    stacked deferred-shading calls gather [c, h, w, 3, 4] vertex
    attributes plus dozens of [c, h, w, 4] texture taps per strip —
    mapping over strips bounds that live set to one strip's worth (the fix
    for the 1080p x many-candidate frame exceeding a 16 GB device at XLA
    buffer assignment) while keeping at most two shading subgraphs in
    the HLO. The math is identical per pixel (shading is a pure per-pixel
    function of the candidate map and its global row); the eager/interpret
    path is pinned bit-equal, the jitted lax.map path agrees to ULP-level
    fusion differences (tests/test_engine.py strip tests)."""
    c, hp, wp = stack.shape
    if strip_h >= hp:
        return fn(stack, row0)
    if not isinstance(stack, jax.core.Tracer):
        # eager frame composition (interpret-mode tests): a concrete Python
        # loop strips the live set the same way without tracing the body
        # (the closed-over numpy frame/material tables stay host arrays;
        # lax.map tracing would index them with tracers and fail)
        # row0 is the offset a strip adds to its LOCAL arange — slicing to
        # rows [b, e) must also fold the strip base b back in (py for local
        # strip row i is (b + i) + row0[b + i])
        outs = [fn(stack[:, b:min(b + strip_h, hp)],
                   row0[b:min(b + strip_h, hp)] + b)
                for b in range(0, hp, strip_h)]
        return jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=1), *outs)
    n_full = hp // strip_h
    main_h = n_full * strip_h
    per = stack[:, :main_h].reshape(c, n_full, strip_h, wp).transpose(1, 0, 2, 3)
    bases = (jnp.arange(n_full, dtype=row0.dtype) * strip_h)[:, None, None]
    r0s = row0[:main_h].reshape(n_full, strip_h, 1) + bases
    out = jax.lax.map(lambda args: fn(args[0], args[1]), (per, r0s))
    out = jax.tree_util.tree_map(
        lambda a: jnp.moveaxis(a, 0, 1).reshape((c, main_h, wp) + a.shape[4:]),
        out,
    )
    if main_h < hp:
        tail = fn(stack[:, main_h:], row0[main_h:] + main_h)
        out = jax.tree_util.tree_map(
            lambda a, b: jnp.concatenate([a, b], axis=1), out, tail)
    return out


def _select(tid, cands: list, values: list):
    """values: list (per candidate) of arrays whose leading dims are [H, W]
    (optionally trailing channel dim). Returns (selected, unmatched mask)."""
    def pick(hit, a, b):
        if a.ndim == hit.ndim + 1:
            hit = hit[..., None]
        return jnp.where(hit, a, b)

    out = values[0]
    matched = tid == cands[0]
    for c, v in zip(cands[1:], values[1:]):
        hit = tid == c
        out = pick(hit, v, out)
        matched |= hit
    return out, ~matched


def render_shard(
    geom: dict,
    frame: dict,
    materials: dict,
    vs: dict,
    *,
    config: RenderConfig,
    has_masked: bool,
    has_blended: bool,
    local_tiles_y: int,
    tile_row_offset,  # traced i32: first global tile row of this shard
    out_rows: int,  # rows of the final image this shard produces
    row_stride: int = 1,  # static: stride between the shard's global tile
    # rows (1 = contiguous band; n_devices = interleaved sp sharding)
    interpret: bool = False,
):
    """Raster + shade + composite for a horizontal band of the image (the
    whole image on a single chip). All per-pixel math runs on the padded
    band; the crop to `out_rows`×width happens at the end.

    Returns (u8 image [out_rows, width, 3], stats i32[N_STATS] — see
    STAT_NAMES; saturation counts cover only this shard's rows)."""
    cfg = config
    shade_dt = jnp.bfloat16 if cfg.bf16_shading else jnp.float32
    pad_h = local_tiles_y * cfg.tile_h
    # per-LOCAL-row offset to the GLOBAL pixel row (py = iota + 0.5 + row0):
    # a constant column for a contiguous band, piecewise per tile row under
    # interleaved sharding. Shading/UI math adds it exactly like the old
    # scalar (bit-identical values for stride 1).
    _j = jnp.arange(pad_h, dtype=jnp.int32)
    _gy = ((jnp.asarray(tile_row_offset, jnp.int32)
            + (_j // cfg.tile_h) * row_stride) * cfg.tile_h
           + (_j % cfg.tile_h))
    row0 = (_gy - _j).astype(jnp.float32)[:, None]
    n_opaque = frame["n_opaque"]
    n_masked = frame["n_masked"]
    msaa = cfg.msaa_samples
    zero = jnp.zeros((), jnp.int32)

    tri_data = setup.triangle_setup(
        vs["clip"], geom["tri_v"], frame["num_tris"], cfg.width, cfg.height,
        bbox_pad=(0.5 if msaa > 1 else 0.0),
    )

    # One stable sort bins every alpha class at once: pairs are keyed by
    # class × tile, each class reads the shared binned buffer through its own
    # starts/counts row (binning.bin_triangle_classes). Binning covers ONLY
    # this shard's tile rows (tile_row_lo/local_tiles_y): under the multichip
    # sp decomposition each device expands, sorts and scatters only its own
    # rows' pairs — the single-chip call is the full range.
    bounds = [0, n_opaque]
    if has_masked:
        bounds.append(n_opaque + n_masked)
    if has_blended:
        bounds.append(frame["num_tris"])
    (b_all, s_all, c_all, ov_all, row_overflow, pair_demand,
     row_demand) = binning.bin_triangle_classes(
        tri_data, tuple(bounds),
        tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h,
        pair_capacity=cfg.pair_capacity, row_capacity=cfg.row_capacity,
        tile_row_lo=tile_row_offset, local_tiles_y=local_tiles_y,
        zbuckets=cfg.opaque_z_buckets, row_stride=row_stride,
    )
    bins_opaque = (b_all, s_all[0], c_all[0])
    ov_opaque = ov_all[0]
    cls_i = 1
    if has_masked:
        bins_masked, ov_masked = (b_all, s_all[cls_i], c_all[cls_i]), ov_all[cls_i]
        cls_i += 1
    else:
        bins_masked, ov_masked = None, zero
    if has_blended:
        bins_blended, ov_blended = (b_all, s_all[cls_i], c_all[cls_i]), ov_all[cls_i]
    else:
        bins_blended, ov_blended = None, zero

    def saturated_px(aux, k):
        """Pixels (inside this shard's image area) whose layered capture
        dropped fragments past the K-layer capacity in ANY sample
        (aux is [S, Hp, Wp]; the count is the union over samples, matching
        STAT_NAMES' 'pixels whose capture was truncated')."""
        return jnp.sum(
            jnp.any(aux[:, :out_rows, : cfg.width] > k, axis=0).astype(jnp.int32)
        )

    def demand_max(aux):
        """Peak per-(sample, pixel) fragment demand inside this shard's image
        area — the capacity a layered capture would need to be lossless
        (STAT_NAMES *_demand_max; feeds the Renderer's layer-count
        grow/shrink)."""
        return jnp.max(aux[:, :out_rows, : cfg.width])

    def interpolants_of(tid, r0=None):
        return shade.interpolants(
            tid, geom, vs, width=cfg.width, height=cfg.height,
            row0=(row0 if r0 is None else r0),
        )

    # Visibility (raster) runs PER SAMPLE at the shifted sample positions;
    # shading runs PER DISTINCT TRIANGLE: attributes are interpolated at
    # pixel centers regardless of sample, so a pixel's shaded color is a pure
    # function of the triangle id — candidates deduped across samples/layers
    # are shaded once and selected back per slot (the "shade once per covered
    # primitive" discipline of hardware MSAA; the 4x supersampled shading of
    # round 1 re-did identical dense work per sample). Exact whenever a pixel
    # references ≤ n_candidates distinct triangles across its slots; the rare
    # remainder falls back to the first candidate and is counted in
    # stats.shade_clamped_px.
    extra = max(cfg.msaa_shade_candidates - 1, 0) if msaa > 1 else 0
    clamp_mask = jnp.zeros((pad_h, cfg.padded_width), bool)

    # In-pixel sample positions passed into the kernels as compile-time
    # constants — ONE kernel launch and one pass over the binned lists
    # evaluates every sample (no per-sample re-streaming of the bins, no
    # per-sample 200 MB plane-shift copies at large pair capacities).
    spos = STANDARD_SAMPLE_POSITIONS[msaa]

    def raster_opaque_all():
        return raster_kernel.rasterize_binned(
            *bins_opaque,
            tile_row_offset=tile_row_offset,
            padded_height=pad_h, padded_width=cfg.padded_width,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w, sub=cfg.tri_chunk,
            sample_positions=spos, row_stride=row_stride,
            interpret=interpret,
        )

    def raster_layers_all(b, floor, mode, n_layers):
        return layers.rasterize_layers(
            *b, floor,
            mode=mode, n_layers=n_layers,
            tile_row_offset=tile_row_offset,
            padded_height=pad_h, padded_width=cfg.padded_width,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            sample_positions=spos, row_stride=row_stride,
            interpret=interpret,
        )

    def clampc(c):  # -2 candidate sentinel → background for interpolation
        return jnp.maximum(c, -1)

    def shade_candidates(cands: list) -> list:
        """Shade all candidate maps in ONE stacked [C,H,W] call (identical
        math to shading each candidate separately — interpolants/shade are
        leading-dim polymorphic — but the frame module contains a single
        shading subgraph instead of one per candidate: ~5x smaller HLO and
        proportionally faster XLA compiles). Stacks past
        cfg.shade_strip_elems shade in tile-row strips (_shade_striped) so
        the [C,H,W,3,4] gathers never exceed the memory budget."""
        stack = clampc(jnp.stack(cands))
        sh = _pick_strip_rows(stack.shape[0], stack.shape[1], stack.shape[2],
                              cfg.tile_h, cfg.shade_strip_elems)
        out = _shade_striped(
            stack, row0, sh,
            lambda tid, r0: shade.shade_interpolated(
                interpolants_of(tid, r0), vs, frame, materials,
                cfg.trilinear, cfg.aniso_samples, cfg.srgb_per_tap,
                shade_dt),
        )
        return [out[i] for i in range(len(cands))]

    # -- phase 1: opaque + masked visibility (all samples per kernel pass) ---
    mask_sat = zero
    blend_sat = zero
    mask_demand = zero
    blend_demand = zero
    ui_demand = zero
    zs, ts = raster_opaque_all()
    solid_z = [zs[s] for s in range(msaa)]
    solid_tid = [ts[s] for s in range(msaa)]
    lt_m, lz_m = [], []
    if has_masked:
        lzm, ltm, aux_m = raster_layers_all(bins_masked, zs, "masked",
                                            cfg.mask_layers)
        mask_sat = saturated_px(aux_m, cfg.mask_layers)
        mask_demand = demand_max(aux_m)
        for s in range(msaa):
            lz_m.append(lzm[s])
            lt_m.append(ltm[s])

    # -- phase 2: masked alpha test (alpha deduped per distinct tid) + merge --
    if has_masked:
        slots = [lt_m[s][k] for s in range(msaa) for k in range(cfg.mask_layers)]
        cands = _extract_candidates(slots, min(len(slots), cfg.mask_layers + extra))
        stack_m = clampc(jnp.stack(cands))
        sh_m = _pick_strip_rows(stack_m.shape[0], stack_m.shape[1],
                                stack_m.shape[2], cfg.tile_h,
                                cfg.shade_strip_elems)
        a_all, co_all = _shade_striped(
            stack_m, row0, sh_m,
            lambda tid, r0: shade.base_alpha(
                interpolants_of(tid, r0), frame, materials,
                cfg.trilinear, cfg.aniso_samples, cfg.srgb_per_tap,
                shade_dt),
        )
        alphas = [a_all[i] for i in range(len(cands))]
        cutoffs = [co_all[i] for i in range(len(cands))]
        for s in range(msaa):
            # a2c: with MSAA, alpha additionally gates per-sample coverage
            # (sample s covered iff a·S > s + 0.5).
            a2c_floor = (s + 0.5) / msaa if msaa > 1 else 0.0
            # far → near so the nearest passing fragment wins.
            for k in reversed(range(cfg.mask_layers)):
                t = lt_m[s][k]
                alpha, unmatched_a = _select(t, cands, alphas)
                cutoff, _ = _select(t, cands, cutoffs)
                live = t >= 0
                # unmatched fragments have unknown alpha → treated as failing
                # the cutoff (counted in shade_clamped_px)
                clamp_mask |= live & unmatched_a
                passes = live & ~unmatched_a & (alpha > cutoff) & (alpha > a2c_floor)
                solid_tid[s] = jnp.where(passes, t, solid_tid[s])
                solid_z[s] = jnp.where(passes, lz_m[s][k], solid_z[s])

    # -- phase 3: blended visibility (floor = merged per-sample solid depth) --
    lt_b = []
    if has_blended:
        _, ltb, aux_b = raster_layers_all(
            bins_blended, jnp.stack(solid_z), "blended", cfg.blend_layers
        )
        blend_sat = saturated_px(aux_b, cfg.blend_layers)
        blend_demand = demand_max(aux_b)
        for s in range(msaa):
            lt_b.append(ltb[s])

    # -- phase 4: solid shading, once per distinct candidate -----------------
    # demand signal: distinct REAL solid tids per pixel across samples
    # (background -1 excluded — it never consumes a candidate slot)
    if msaa > 1:
        distinct = jnp.zeros_like(solid_tid[0])
        for i, t in enumerate(solid_tid):
            is_new = t != -1
            for u in solid_tid[:i]:
                is_new &= t != u
            distinct += is_new.astype(jnp.int32)
        shade_demand = jnp.max(distinct[:out_rows, : cfg.width])
    else:
        shade_demand = zero
    n_c = min(msaa, max(cfg.msaa_shade_candidates, 1))
    cands_s = _extract_candidates(solid_tid, n_c)
    shaded_s = shade_candidates(cands_s)
    hdr = []
    for s in range(msaa):
        color, unmatched = _select(solid_tid[s], cands_s, shaded_s)
        covered_s = solid_tid[s] >= 0
        clamp_mask |= unmatched & covered_s
        # a BACKGROUND sample whose -1 didn't fit the candidate set must
        # resolve to the clear color, not candidate 0's fallback color
        # (silhouette pixels against the sky would otherwise over-opaque)
        hdr.append(jnp.where(covered_s[..., None], color[..., :3], 0.0))

    # -- phase 5: blended shading (deduped) + per-sample ordered composite ---
    if has_blended:
        slots = [lt_b[s][k] for s in range(msaa) for k in range(cfg.blend_layers)]
        cands_b = _extract_candidates(slots, min(len(slots), cfg.blend_layers + extra))
        shaded_b = shade_candidates(cands_b)
        for s in range(msaa):
            for k in range(cfg.blend_layers):
                t = lt_b[s][k]
                color_k, unmatched = _select(t, cands_b, shaded_b)
                live = (t >= 0) & ~unmatched
                clamp_mask |= (t >= 0) & unmatched
                a = jnp.where(live[..., None], color_k[..., 3:4], 0.0)
                hdr[s] = hdr[s] * (1.0 - a) + color_k[..., :3] * a

    # -- phase 6: UI overlay into the HDR buffer of every sample (the
    # reference's ImGui pipeline position: blended, no depth, last in the
    # geometry pass, BEFORE tonemap — renderer.rs:433-441) ------------------
    ov_ui = zero
    ui_sat = zero
    ui = frame.get("ui")
    if ui is not None:
        # coverage at pixel centers by default; at the MSAA sample positions
        # under cfg.ui_msaa (the reference's multisampled UI edges) — shading
        # stays at pixel centers either way (non-sample-rate shading)
        ui_spos = spos if (cfg.ui_msaa and msaa > 1) else ((0.5, 0.5),)
        lt_ui, ov_ui, aux_ui = ui_stage.rasterize_ui(
            ui, config=cfg, local_tiles_y=local_tiles_y,
            tile_row_offset=tile_row_offset, sample_positions=ui_spos,
            row_stride=row_stride, interpret=interpret,
        )
        ui_sat = saturated_px(aux_ui, cfg.ui_layers)
        ui_demand = demand_max(aux_ui)
        # ALL layers (and sample sets under ui_msaa) shaded in one stacked
        # call (shade_ui_layer is leading-dim polymorphic); the composite
        # below applies them in the same layer order as before.
        if len(ui_spos) == 1:
            rgb_all, a_all = ui_stage.shade_ui_layer(
                lt_ui[0], ui, materials, config=cfg, row0=row0
            )  # [K,H,W,3], [K,H,W]
            for k in range(cfg.ui_layers):
                a_k = a_all[k][..., None]
                for s in range(msaa):
                    hdr[s] = hdr[s] * (1.0 - a_k) + rgb_all[k] * a_k
        else:
            rgb_all, a_all = ui_stage.shade_ui_layer(
                lt_ui, ui, materials, config=cfg, row0=row0
            )  # [S,K,H,W,3], [S,K,H,W]
            for k in range(cfg.ui_layers):
                for s in range(msaa):
                    a_k = a_all[s, k][..., None]
                    hdr[s] = hdr[s] * (1.0 - a_k) + rgb_all[s, k] * a_k

    img = post.tonemap(jnp.stack(hdr) if msaa > 1 else hdr[0])
    clamped = jnp.sum(clamp_mask[:out_rows, : cfg.width].astype(jnp.int32))
    # the ragged expansion demands from binning itself — capacity must hold
    # the expansion, which the demands report UNtruncated
    total_pairs = pair_demand
    stats = jnp.stack(
        [ov_opaque, ov_masked, ov_blended, ov_ui, mask_sat, blend_sat, ui_sat,
         clamped, total_pairs, mask_demand, blend_demand, ui_demand,
         shade_demand, row_demand, row_overflow]
    ).astype(jnp.int32)
    return img[:out_rows, : cfg.width], stats


def render_frames_scan(
    geom: dict,
    blobs: jnp.ndarray,  # [K, blob_len] i32 — K packed frame blobs
    materials: dict,
    *,
    config: RenderConfig,
    skin_start: int,
    has_masked: bool = True,
    has_blended: bool = True,
    morph_k: int = 0,
    joint_cap: int = constants.MAX_JOINT_COUNT,
    interpret: bool = False,
):
    """Device-resident multi-frame rendering: ONE dispatch renders K frames
    (camera path + animation states packed host-side into stacked frame
    blobs) via lax.scan over the full single-frame pipeline. Amortizes the
    per-dispatch host overhead that bounds the interactive loop — the
    offline/flythrough throughput mode (the single-device
    analog of the dp mesh axis, parallel/mesh.render_frames_batched).
    Returns (u8 [K, H, W, 3], stats i32 [K, N_STATS])."""

    def body(carry, blob):
        img, stats = render_frame(
            geom, {"blob": blob}, materials,
            config=config, skin_start=skin_start,
            has_masked=has_masked, has_blended=has_blended,
            morph_k=morph_k, joint_cap=joint_cap, interpret=interpret,
        )
        return carry, (img, stats)

    _, (imgs, stats) = jax.lax.scan(body, 0, blobs)
    return imgs, stats


def render_frame(
    geom: dict,
    frame: dict,
    materials: dict,
    *,
    config: RenderConfig,
    skin_start: int,
    has_masked: bool = True,
    has_blended: bool = True,
    morph_k: int = 0,
    joint_cap: int = constants.MAX_JOINT_COUNT,
    interpret: bool = False,
):
    """Single-chip frame: returns (final u8 RGB image [H, W, 3],
    stats i32[N_STATS])."""
    from renderer_tpu.scene.draw_stream import unpack_frame

    frame = unpack_frame(frame, morph_k=morph_k, joint_cap=joint_cap)
    vs = vertex_stage.run_vertex_stage(geom, frame, skin_start,
                                       morph_k=morph_k)
    return render_shard(
        geom, frame, materials, vs,
        config=config,
        has_masked=has_masked,
        has_blended=has_blended,
        local_tiles_y=config.tiles_y,
        tile_row_offset=0,
        out_rows=config.height,
        interpret=interpret,
    )
