"""Observability: device-memory accounting and per-stage device timings.

Parity targets:
- VRAM atomics + startup logging (reference: renderer/src/lib.rs:75-93,
  examples/sandbox/src/main.rs:119-127 print_memory_usage,
  physical_device.rs:109-119 memory-budget query) → `memory_usage()` /
  `log_memory_usage()` over `device.memory_stats()`.
- The `Bytes` pretty-printer (lib.rs:103-128).
- Per-stage µs timings (the profile-with-tracing span tree,
  main.rs:704-847) → `device_stage_timings()` executes the frame stage by
  stage with explicit jitted boundaries and returns a table.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp


def format_bytes(n: int) -> str:
    """Bytes pretty-printer (lib.rs:103-128 prints the largest binary unit)."""
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if value < 1024.0 or unit == "TiB":
            return f"{value:.2f} {unit}" if unit != "B" else f"{int(value)} B"
        value /= 1024.0
    return f"{value:.2f} TiB"


def memory_usage(device=None) -> dict:
    """Device-memory usage for one device (the VK_EXT_memory_budget
    analog)."""
    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    return {
        "in_use": stats.get("bytes_in_use", 0),
        "peak": stats.get("peak_bytes_in_use", 0),
        "limit": stats.get("bytes_limit", 0),
    }


def log_memory_usage(tag: str, device=None) -> str:
    u = memory_usage(device)
    line = (
        f"[{tag}] device memory in use: {format_bytes(u['in_use'])}, "
        f"peak: {format_bytes(u['peak'])}, limit: {format_bytes(u['limit'])}"
    )
    print(line)
    return line


def kernel_inputs(renderer, scene) -> list[tuple]:
    """The raster kernels' inputs for one frame of `scene` at the
    renderer's config, binned exactly as pipeline.render_shard bins them.
    Returns [(name, kernel_fn, reference_fn, args, kwargs)] for the opaque,
    masked and blended kernels (classes the scene has); the layered kernels'
    depth floor is the opaque reference depth."""
    from renderer_tpu.raster import (binning, layers, pipeline, raster_kernel,
                                     setup, vertex_stage)
    from renderer_tpu.scene import draw_stream

    cfg = renderer.config
    fv = draw_stream.frame_view(scene)
    gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
    frame = draw_stream.unpack_frame(
        renderer._frame_arrays(scene, fv, gs), morph_k=gs.morph_k,
        joint_cap=renderer._joint_cap(scene))
    vs = jax.jit(functools.partial(
        vertex_stage.run_vertex_stage, skin_start=gs.skin_start,
        morph_k=gs.morph_k))(geom, frame)
    td = jax.jit(functools.partial(
        setup.triangle_setup, width=cfg.width, height=cfg.height,
        bbox_pad=(0.5 if cfg.msaa_samples > 1 else 0.0)))(
        vs["clip"], geom["tri_v"], frame["num_tris"])
    n_opaque, n_masked = gs.num_opaque_tris, gs.num_masked_tris
    bounds = [0, n_opaque]
    classes = ["opaque"]
    if n_masked:
        bounds.append(n_opaque + n_masked)
        classes.append("masked")
    if gs.num_tris > n_opaque + n_masked:
        bounds.append(gs.num_tris)
        classes.append("blended")
    binned, starts, counts = binning.bin_triangle_classes(
        td, tuple(bounds), tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h,
        pair_capacity=cfg.pair_capacity, row_capacity=cfg.row_capacity,
        zbuckets=cfg.opaque_z_buckets)[:3]
    kw = dict(padded_height=cfg.padded_height, padded_width=cfg.padded_width,
              tile_h=cfg.tile_h, tile_w=cfg.tile_w,
              sample_positions=pipeline.STANDARD_SAMPLE_POSITIONS[
                  cfg.msaa_samples])
    out = [("opaque", raster_kernel.rasterize_binned,
            raster_kernel.rasterize_binned_reference,
            (binned, starts[0], counts[0]), dict(kw, sub=cfg.tri_chunk))]
    floor = None
    for ci, mode in enumerate(classes[1:], 1):
        if floor is None:
            floor = raster_kernel.rasterize_binned_reference(
                *out[0][3], **out[0][4])[0]
        layers_kw = dict(kw, mode=mode, n_layers=(
            cfg.mask_layers if mode == "masked" else cfg.blend_layers))
        out.append((mode, layers.rasterize_layers,
                    layers.rasterize_layers_reference,
                    (binned, starts[ci], counts[ci], floor), layers_kw))
    return out


def _shade_dt(cfg):
    return jnp.bfloat16 if cfg.bf16_shading else jnp.float32


def _repeat_runner(fn, args):
    """One jitted runner evaluating `fn(*args)` `reps` times inside a SINGLE
    dispatch (lax.fori_loop with a traced trip count — one compile serves
    every rep count). Each iteration perturbs the first float input by a
    runtime-denormal derived from the previous iteration's output, so the
    iterations are data-dependent and XLA can neither hoist the stage out
    of the loop nor elide it. The outputs pass through an
    optimization_barrier BEFORE the probe is sliced out: without it XLA
    narrows the whole stage to computing the one probed element (slice
    pushdown through matmuls/elementwise turned a 137-GFLOP matmul into a
    single dot product in testing)."""
    leaves, treedef = jax.tree_util.tree_flatten(args)
    fidx = next(
        i for i, leaf in enumerate(leaves)
        if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating)
    )

    @jax.jit
    def run(reps, *ls):
        def body(_i, delta):
            perturbed = list(ls)
            perturbed[fidx] = perturbed[fidx] + delta
            out = fn(*jax.tree_util.tree_unflatten(treedef, perturbed))
            out = jax.lax.optimization_barrier(out)  # materialize EVERYTHING
            probe = jnp.float32(0.0)
            for leaf in jax.tree_util.tree_leaves(out):
                probe = probe + leaf.ravel()[0].astype(jnp.float32)
            return probe * jnp.float32(1e-38)

        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    return lambda reps: run(jnp.int32(reps), *leaves)


def _time_call(fn, *args, iters: int = 10) -> float:
    """Per-execution ms of one stage: the stage is repeated R× INSIDE one
    dispatch and the per-rep cost is the slope between two rep counts,
    ms = (t(R2) − t(R1)) / (R2 − R1). The paired subtraction cancels the
    per-dispatch overhead; the median of 3 pairs absorbs transient stalls.
    Host clock around block_until_ready."""
    run = _repeat_runner(fn, args)
    r1, r2 = 2, max(8, iters)
    run(r1).block_until_ready()  # compile + warm
    slopes = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(r1).block_until_ready()
        t1 = time.perf_counter()
        run(r2).block_until_ready()
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / (r2 - r1) * 1e3)
    slopes.sort()
    return max(slopes[1], 0.0)


def fused_frame_ms(renderer, scene, iters: int = 16) -> float:
    """Per-frame device ms of the FUSED production frame via the K-frame
    scan slope: render K identical frames in one `render_frames_scan`
    dispatch and take ms = (t(K2) − t(K1)) / (K2 − K1). One dispatch per K
    cancels the per-dispatch overhead (like _time_call), and the
    scan path's memory profile is the flythrough mode's — wrapping the
    whole 1080p msaa4 frame in _repeat_runner's fori_loop instead makes
    XLA's loop allocation exceed HBM."""
    import numpy as np

    from renderer_tpu.scene import draw_stream

    fv = draw_stream.frame_view(scene)
    gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
    blob = draw_stream.pack_frame_blob(
        fv, scene.joint_palette, renderer._proj_view(scene),
        (gs.num_tris, gs.num_opaque_tris, gs.num_masked_tris, 0),
        morph_k=gs.morph_k, joint_cap=renderer._joint_cap(scene),
    )
    mats = renderer._materials()
    kwargs = dict(
        config=renderer.config, skin_start=gs.skin_start,
        has_masked=gs.num_masked_tris > 0,
        has_blended=gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris,
        morph_k=gs.morph_k, joint_cap=renderer._joint_cap(scene),
    )

    def run(k):
        blobs = jnp.asarray(np.tile(blob[None], (k, 1)))
        # return BOTH outputs: dropping the images would let XLA dead-code
        # the entire shading/tonemap column (stats only consume counts)
        return renderer._frames_fn(geom, blobs, mats, **kwargs)

    k1, k2 = 4, max(8, iters)
    jax.block_until_ready(run(k1))  # compile + warm (two K-variants)
    jax.block_until_ready(run(k2))
    slopes = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(k1))
        t1 = time.perf_counter()
        jax.block_until_ready(run(k2))
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / (k2 - k1) * 1e3)
    slopes.sort()
    return max(slopes[1], 0.0)


def device_stage_timings(renderer, scene, iters: int = 10) -> dict[str, float]:
    """Executes the frame pipeline stage by stage (each stage its own jit,
    all data passed explicitly — nothing captured as constants) and returns
    {stage: ms}. Covers every pass the production frame runs for this scene —
    opaque, masked layer raster + alpha test, blended layer raster + shade —
    plus the fused full frame at the renderer's real MSAA config. The
    stage-sum exceeds the fused frame time (the production path is one jit);
    this mirrors the reference's per-scope µs readout."""
    from renderer_tpu.raster import (binning, layers, raster_kernel, setup,
                                     shade, post, vertex_stage)
    from renderer_tpu.core.backend import interpret_mode
    from renderer_tpu.scene import draw_stream

    cfg = renderer.config
    interp = interpret_mode()
    fv = draw_stream.frame_view(scene)
    gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
    packed = renderer._frame_arrays(scene, fv, gs)
    frame = draw_stream.unpack_frame(packed, morph_k=gs.morph_k,
                                     joint_cap=renderer._joint_cap(scene))
    mats = renderer._materials()

    timings: dict[str, float] = {}

    vs_fn = jax.jit(
        functools.partial(vertex_stage.run_vertex_stage,
                          skin_start=gs.skin_start, morph_k=gs.morph_k)
    )
    timings["vertex+skinning"] = _time_call(vs_fn, geom, frame, iters=iters)
    vs = vs_fn(geom, frame)

    setup_fn = jax.jit(
        functools.partial(setup.triangle_setup, width=cfg.width, height=cfg.height)
    )
    timings["triangle setup"] = _time_call(
        setup_fn, vs["clip"], geom["tri_v"], frame["num_tris"], iters=iters
    )
    td = setup_fn(vs["clip"], geom["tri_v"], frame["num_tris"])

    bin_fn = functools.partial(
        binning.bin_triangles,
        tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h, pair_capacity=cfg.pair_capacity,
    )
    timings["binning (opaque)"] = _time_call(bin_fn, td, 0, frame["n_opaque"], iters=iters)
    b, s, c, _ = bin_fn(td, 0, frame["n_opaque"])

    raster_fn = functools.partial(
        raster_kernel.rasterize_binned,
        padded_height=cfg.padded_height, padded_width=cfg.padded_width,
        tile_h=cfg.tile_h, tile_w=cfg.tile_w, sub=cfg.tri_chunk, interpret=interp,
    )
    timings["raster (opaque)"] = _time_call(raster_fn, b, s, c, iters=iters)
    depth, trid = raster_fn(b, s, c)
    depth1, trid = depth, trid[0]  # [1, Hp, Wp] single-sample stage timings

    def interpolants_of(t, geom_, vs_):
        return shade.interpolants(t[: cfg.height, : cfg.width], geom_, vs_,
                                  width=cfg.width, height=cfg.height)

    n_masked = gs.num_masked_tris
    n_blended = gs.num_tris - gs.num_opaque_tris - gs.num_masked_tris
    layer_fn = functools.partial(
        layers.rasterize_layers,
        padded_height=cfg.padded_height, padded_width=cfg.padded_width,
        tile_h=cfg.tile_h, tile_w=cfg.tile_w, interpret=interp,
    )

    if n_masked:
        bm = bin_fn(td, frame["n_opaque"], frame["n_opaque"] + frame["n_masked"])[:3]
        timings["raster (masked layers)"] = _time_call(
            functools.partial(layer_fn, mode="masked", n_layers=cfg.mask_layers),
            *bm, depth1, iters=iters,
        )
        lz, lt, _aux = layer_fn(*bm, depth1, mode="masked", n_layers=cfg.mask_layers)
        lt = lt[0]  # single-sample: [K, Hp, Wp]

        def alpha_fn(lt_, geom_, vs_, frame_, mats_):
            it = interpolants_of(lt_[0], geom_, vs_)
            return shade.base_alpha(it, frame_, mats_, cfg.trilinear,
                                    cfg.aniso_samples, cfg.srgb_per_tap,
                                    _shade_dt(cfg))

        timings["masked alpha test (per layer)"] = _time_call(
            jax.jit(alpha_fn), lt, geom, vs, frame, mats, iters=iters
        )

    if n_blended:
        bb = bin_fn(td, frame["n_opaque"] + frame["n_masked"], frame["num_tris"])[:3]
        timings["raster (blended layers)"] = _time_call(
            functools.partial(layer_fn, mode="blended", n_layers=cfg.blend_layers),
            *bb, depth1, iters=iters,
        )
        _lzb, ltb, _auxb = layer_fn(*bb, depth1, mode="blended",
                                    n_layers=cfg.blend_layers)
        ltb = ltb[0]

        def blend_fn(ltb_, geom_, vs_, frame_, mats_):
            return shade.shade_interpolated(
                interpolants_of(ltb_[0], geom_, vs_), vs_, frame_, mats_,
                cfg.trilinear, cfg.aniso_samples, cfg.srgb_per_tap,
                _shade_dt(cfg),
            )

        timings["blended shade (per layer)"] = _time_call(
            jax.jit(blend_fn), ltb, geom, vs, frame, mats, iters=iters
        )

    def shade_fn(trid_, geom_, vs_, frame_, mats_):
        hdr = shade.shade(
            trid_[: cfg.height, : cfg.width], geom_, vs_, frame_, mats_,
            width=cfg.width, height=cfg.height,
        )
        return post.tonemap(hdr[..., :3])

    shade_jit = jax.jit(shade_fn)
    timings["deferred shade + tonemap"] = _time_call(
        shade_jit, trid, geom, vs, frame, mats, iters=iters
    )

    # the production frame: everything above fused into one jit, at the
    # renderer's real msaa/layer config (msaa runs visibility per sample +
    # candidate-deduped shading, raster/pipeline.py) — timed via the
    # K-frame scan slope (see fused_frame_ms)
    timings[f"FULL FRAME (fused, msaa{cfg.msaa_samples})"] = fused_frame_ms(
        renderer, scene, iters=iters
    )
    return timings
