"""Renderer: the frame engine gluing scene → device arrays → jitted frame.

This is the analog of the reference's Renderer frame loop
(renderer/src/renderer.rs:130-356): `render_frame(scene)` sorts the draws,
builds the per-frame arrays (~µs of numpy, matching the reference's ~20 µs
queue cost), uploads them, and dispatches one jitted device step. Geometry
and material arrays are cached: a frame that queues the same meshes reuses
device-resident geometry (the analog of the static vertex library staying in
VRAM), so steady-state host→device traffic is just transforms + camera +
joints.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from renderer_tpu.core import backend
from renderer_tpu.core.config import RenderConfig
from renderer_tpu.engine.profiling import Profiler
from renderer_tpu.materials.atlas import build_atlas
from renderer_tpu.materials.registry import MaterialRegistry
from renderer_tpu.raster import pipeline
from renderer_tpu.scene import draw_stream
from renderer_tpu.scene.scene import Scene


def compilation_cache_dir() -> str | None:
    """Directory for the persistent compile cache to be set in code: None
    when JAX_COMPILATION_CACHE_DIR is set (JAX reads the variable itself,
    and nothing here overrides it), else the fixed `<repo>/.cache/jax` —
    the path is part of the cache key, so it must not move."""
    import os
    import pathlib

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(pathlib.Path(__file__).resolve().parents[2] / ".cache" / "jax")


def _enable_compilation_cache() -> None:
    """Persistent compile cache — the VkPipelineCache analog (the reference
    threads a pipeline cache through every recreation so resizes reuse
    compiled pipelines, pipelines.rs:164-174). Makes first frames after the
    first process start near-instant.

    The cache is NOT enabled for the CPU backend: XLA:CPU's AOT
    export/import is unsafe in this jaxlib — loading entries written on a
    different host warns "could lead to execution errors such as SIGILL",
    and SERIALIZING certain CPU executables segfaults outright (reproduced
    deterministically inside compilation_cache.put_executable_and_time
    during a full test-suite run). CPU compiles are seconds; the
    in-process jit cache covers them."""
    if getattr(_enable_compilation_cache, "_done", False):
        return
    _enable_compilation_cache._done = True
    if jax.default_backend() == "cpu":
        return
    cache_dir = compilation_cache_dir()
    if cache_dir is not None:
        import pathlib

        pathlib.Path(cache_dir).mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


MAX_PAIR_CAPACITY = 1 << 22

# Layered-capture growth ceiling: each extra layer costs one more deferred
# shade/composite pass (pipeline.render_shard phases 2/5/6) plus
# [S, K, bh, bw] registers per layer-kernel program, so runaway growth on a
# pathological stack (hundreds of coplanar translucent surfaces) must cap
# loudly rather than compile an absurd frame function.
MAX_LAYERS = 16

# stats demand entry → RenderConfig field it right-sizes
_LAYER_KNOBS = (
    ("masked_demand_max", "mask_layers"),
    ("blended_demand_max", "blend_layers"),
    ("ui_demand_max", "ui_layers"),
)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


@functools.lru_cache(maxsize=None)
def _jitted_frame_fns(interpret: bool):
    """Process-wide jitted frame functions, shared by every Renderer:
    all per-renderer state rides in the arguments (config is a static jit
    key), so two Renderers with the same config reuse one compiled
    executable — the VkPipelineCache discipline applied to traces, not just
    the persistent on-disk cache.

    Interpret mode (CPU tests) composes the frame EAGERLY instead: each
    Pallas kernel then runs as its own standalone jit. Inside one monolithic
    jitted module, XLA:CPU executes the interpret-emulated kernel ref writes
    catastrophically slowly (measured on the CPU: the mini-sandbox
    all-classes frame took 108 s/frame monolithic vs ~1 s composed of
    standalone stages — the layered-capture kernels alone accounted for all
    of it), and the monolith also recompiles per config while the eager
    glue ops cache process-wide. Same ops, same order — goldens pin the
    equivalence; the GPU path and the scan/multichip paths stay
    single-jit."""
    if interpret:
        frame_fn = functools.partial(pipeline.render_frame, interpret=True)
    else:
        frame_fn = jax.jit(
            functools.partial(pipeline.render_frame, interpret=interpret),
            static_argnames=("config", "skin_start", "has_masked",
                             "has_blended", "morph_k", "joint_cap"),
        )
    frames_fn = jax.jit(
        functools.partial(pipeline.render_frames_scan, interpret=interpret),
        static_argnames=("config", "skin_start", "has_masked", "has_blended",
                         "morph_k", "joint_cap"),
    )
    return frame_fn, frames_fn


class Renderer:
    def __init__(
        self,
        registry: MaterialRegistry,
        config: RenderConfig | None = None,
        profiler: Profiler | None = None,
        overflow_policy: str = "auto",
        shrink_after: int = 120,
        max_layers: int = MAX_LAYERS,
    ) -> None:
        """overflow_policy — what to do when the frame's stats vector reports
        dropped work (bin pair_capacity exceeded, or a layered capture
        truncated past mask_layers/blend_layers/ui_layers — the reference's
        fixed-function blending is unbounded, pipelines.rs:112-132), the
        analog of the reference's loud arena-OOM errors
        (arena/buffers.rs:126-163):
        - "auto" (default): check the PREVIOUS frame's stats after each
          dispatch (no pipeline stall on direct-attached devices), log loudly
          and regrow pair_capacity (recompile) so subsequent frames are
          complete;
        - "sync": check THIS frame's stats before returning and re-render at
          the grown capacity — the returned image is always complete;
        - "off": never read stats on the host (stats are still computed and
          available via `frame_stats()`); the caller verifies the collected
          stats itself, after its own timed loop.

        shrink_after — under "auto"/"sync", the binning pair bucket is also
        shrunk back (recompile) after this many CONSECUTIVE frames whose
        total_pairs would fit a bucket ≤ half the current one with 2×
        headroom — the binning sort costs O(capacity log capacity)
        regardless of scene size, so a bucket grown for one heavy camera
        angle would otherwise tax every later frame. Hysteresis avoids
        recompile thrash on oscillating scenes. The same streak discipline
        shrinks grown layer counts back toward their configured floor (each
        layer costs a deferred shade/composite pass per frame).

        max_layers — ceiling for the layer-count growth (see MAX_LAYERS);
        lower it when register or compile-time budgets are tighter than the
        default allows."""
        _enable_compilation_cache()
        assert overflow_policy in ("auto", "sync", "off")
        self.config = (config or RenderConfig()).validate()
        self.registry = registry
        self.profiler = profiler or Profiler(enabled=False)
        self.overflow_policy = overflow_policy
        self.shrink_after = shrink_after
        self.max_layers = max_layers
        self._skip_stat_checks = 0  # frames dispatched before a capacity change
        # capacity right-sizing state, shared by every demand-fed knob;
        # per-knob (streak length, streak peak demand) for shrink
        # hysteresis (_streak_shrink). Floors differ by knob class: the
        # LAYER/shade knobs never shrink below the configured counts (each
        # layer is a whole per-frame pass the caller opted into), while the
        # binning pair/row buckets are demand-governed in BOTH directions
        # (floor = the 1<<14 minimum bucket): an oversized sort bucket
        # taxes every frame O(capacity log capacity), so even a
        # caller-configured 1<<18 shrinks when the scene sustainedly needs
        # less — pinned by test_auto_policy_shrinks_oversized_bucket —
        # and regrows loudly on the next overflow.
        self._layer_floors = {
            field: getattr(self.config, field) for _, field in _LAYER_KNOBS
        }
        self._shade_floor = self.config.msaa_shade_candidates
        self._streaks = {field: (0, 0) for _, field in _LAYER_KNOBS}
        self._streaks["pair_capacity"] = (0, 0)
        self._streaks["row_capacity"] = (0, 0)
        self._streaks["msaa_shade_candidates"] = (0, 0)
        self._geom_cache: dict = {}
        self._mat_cache: tuple[int, dict] | None = None
        self._interpret = backend.interpret_mode()
        self._last_stats = None  # device i32[N_STATS] of the last frame
        self._frame_fn, self._frames_fn = _jitted_frame_fns(self._interpret)

    # -- frame stats / overflow recovery --------------------------------------

    @property
    def last_stats(self):
        """Device stats array of the most recent frame (NO host sync —
        np.asarray it after your timing loop)."""
        return self._last_stats

    def frame_stats(self) -> dict[str, int] | None:
        """Stats of the most recent frame (syncs on it). See
        pipeline.STAT_NAMES."""
        if self._last_stats is None:
            return None
        vals = np.asarray(self._last_stats)
        return dict(zip(pipeline.STAT_NAMES, (int(v) for v in vals)))

    def _total_overflow(self, stats_host) -> int:
        """Dropped work across every binning bucket: geometry pairs [0:3],
        UI pairs [3], and the ragged row axis (row_overflow) — anything
        nonzero means the last checked frame lost work."""
        total = int(np.sum(stats_host[:4]))
        idx = pipeline.STAT_NAMES.index("row_overflow")
        if len(stats_host) > idx:
            total += int(stats_host[idx])
        return total

    def _grow_pair_capacity(self, stats_host) -> bool:
        """Regrow whichever binning bucket overflowed — the geometry
        pair_capacity for scene overflow ([0:3]), ui_pair_capacity for UI
        overflow ([3]); each is pow-2 like every other capacity bucket.
        Recompiles the frame. Returns True if any bucket grew."""
        from dataclasses import replace

        def grown(name, current, overflow, max_cap,
                  unit="(tile, triangle) pairs"):
            needed = current + overflow
            new = current
            while new < needed and new < max_cap:
                new *= 2
            if new == current:
                print(
                    f"[renderer] bin overflow of {overflow} {unit} but "
                    f"{name} is already at the {max_cap} max; work WILL be "
                    "dropped",
                )
                return None
            print(
                f"[renderer] bin overflow: {overflow} {unit} dropped; "
                f"regrowing {name} {current} -> {new} (recompiles)",
            )
            return new

        changed = False
        geo = int(np.sum(stats_host[:3]))
        if geo > 0:
            new = grown("pair_capacity", self.config.pair_capacity, geo,
                        MAX_PAIR_CAPACITY)
            if new is not None:
                self.config = replace(self.config, pair_capacity=new).validate()
                changed = True
        ui = int(stats_host[3])
        if ui > 0:
            new = grown("ui_pair_capacity", self.config.ui_pair_capacity, ui,
                        MAX_PAIR_CAPACITY)
            if new is not None:
                self.config = replace(
                    self.config, ui_pair_capacity=new
                ).validate()
                changed = True
        ridx = pipeline.STAT_NAMES.index("row_overflow")
        rows = int(stats_host[ridx]) if len(stats_host) > ridx else 0
        if rows > 0:
            new = grown("row_capacity", self.config.row_capacity, rows,
                        MAX_PAIR_CAPACITY, unit="(triangle, tile-row) rows")
            if new is not None:
                self.config = replace(self.config, row_capacity=new).validate()
                changed = True
        if changed:
            self._streaks["pair_capacity"] = (0, 0)
            self._streaks["row_capacity"] = (0, 0)
        return changed

    def _streak_shrink(self, field: str, demand: int, bucket, floor: int,
                       what: str) -> None:
        """Shared shrink hysteresis for every demand-fed capacity knob:
        after `shrink_after` CONSECUTIVE frames whose demand fit a smaller
        bucket, shrink `field` to the bucket of the streak's PEAK demand —
        an oscillating scene (e.g. a camera swinging back to a heavy angle
        within the window) can never shrink below its own peak. `bucket(d)`
        maps a demand value to its capacity bucket; `floor` is the
        caller-configured minimum."""
        from dataclasses import replace

        cur = getattr(self.config, field)
        if max(bucket(demand), floor) >= cur:
            self._streaks[field] = (0, 0)
            return
        streak, peak = self._streaks[field]
        peak = demand if streak == 0 else max(peak, demand)
        streak += 1
        if streak < self.shrink_after:
            self._streaks[field] = (streak, peak)
            return
        # every frame in the streak individually fit under the current
        # capacity with headroom, so the peak's bucket is a strict shrink
        desired = max(bucket(peak), floor)
        if desired < cur:
            print(
                f"[renderer] {field}={cur} oversized for {streak} "
                f"consecutive frames (streak peak {what} {peak}); "
                f"shrinking to {desired} (recompiles)",
            )
            self.config = replace(self.config, **{field: desired}).validate()
        self._streaks[field] = (0, 0)

    def _grow_layer_capacity(self, stats_host) -> bool:
        """Grow mask_layers/blend_layers/ui_layers toward the measured peak
        per-pixel fragment demand (stats *_demand_max) when a layered capture
        truncated — the runtime convergence toward the reference's unbounded
        fixed-function blending (pipelines.rs:112-132). Pow-2 buckets like
        every other capacity; capped LOUDLY at MAX_LAYERS. Returns True if
        any layer count grew (recompiles).

        Note the blended demand measured under truncation can OVERCOUNT:
        fragments dropped past the capacity never write the chain depth, so
        later fragments that a complete chain would have depth-rejected
        still count. Growth is therefore conservative (may overshoot by one
        bucket); the shrink streak re-measures at the grown capacity and
        settles on the true demand's bucket."""
        from dataclasses import replace

        changed = False
        for stat, field in _LAYER_KNOBS:
            idx = pipeline.STAT_NAMES.index(stat)
            if len(stats_host) <= idx:
                return changed
            demand = int(stats_host[idx])
            cur = getattr(self.config, field)
            if demand <= cur:
                continue
            new = min(_next_pow2(demand), self.max_layers)
            if new <= cur:
                print(
                    f"[renderer] {field} saturated (peak demand {demand} "
                    f"fragments/pixel) but already at the {self.max_layers} "
                    "max; deeper stacks will under-blend (counted in "
                    "*_saturated_px)",
                )
                continue
            print(
                f"[renderer] layered capture truncated: peak demand {demand} "
                f"fragments/pixel; regrowing {field} {cur} -> {new} "
                "(recompiles)",
            )
            self.config = replace(self.config, **{field: new}).validate()
            self._streaks[field] = (0, 0)
            changed = True
        return changed

    def _maybe_shrink_layers(self, stats_host) -> None:
        """Shrink a grown layer count back toward its configured floor after
        a clean streak (see _streak_shrink) — pow-2 buckets like the growth
        side."""
        for stat, field in _LAYER_KNOBS:
            idx = pipeline.STAT_NAMES.index(stat)
            if len(stats_host) <= idx:
                return
            self._streak_shrink(field, int(stats_host[idx]), _next_pow2,
                                self._layer_floors[field],
                                "demand (fragments/pixel)")

    def _grow_shade_candidates(self, stats_host) -> bool:
        """Grow msaa_shade_candidates toward the measured peak count of
        distinct solid triangles per pixel (stats shade_demand_max, bounded
        by msaa_samples) — at that depth the shade-once MSAA dedup is exact
        for every solid pixel (pipeline.render_shard phase 4)."""
        from dataclasses import replace

        idx = pipeline.STAT_NAMES.index("shade_demand_max")
        if len(stats_host) <= idx:
            return False
        demand = int(stats_host[idx])
        cur = self.config.msaa_shade_candidates
        cap = self.config.msaa_samples
        if demand <= cur or cur >= cap:
            return False
        new = min(demand, cap)
        print(
            f"[renderer] MSAA shading candidate set saturated: up to {demand} "
            f"distinct triangles/pixel; regrowing msaa_shade_candidates "
            f"{cur} -> {new} (recompiles)",
        )
        self.config = replace(self.config, msaa_shade_candidates=new).validate()
        self._streaks["msaa_shade_candidates"] = (0, 0)
        return True

    def _maybe_shrink_shade_candidates(self, stats_host) -> None:
        """Shrink a grown candidate set back toward the configured floor
        after a clean streak. Guarded on shade_clamped_px == 0: the layered
        phases size their candidate sets from this knob too, and their
        demand is not measured separately — never shrink while any shading
        fallback is active."""
        demand_idx = pipeline.STAT_NAMES.index("shade_demand_max")
        clamp_idx = pipeline.STAT_NAMES.index("shade_clamped_px")
        if len(stats_host) <= demand_idx:
            return
        if int(stats_host[clamp_idx]) > 0:
            self._streaks["msaa_shade_candidates"] = (0, 0)
            return
        self._streak_shrink("msaa_shade_candidates",
                            int(stats_host[demand_idx]), lambda d: d,
                            self._shade_floor, "demand")

    def _grow_capacities(self, stats_host) -> bool:
        """All capacity-growth feedback for one checked stats vector:
        binning pair buckets (dropped work), layered-capture counts
        (truncated capture), MSAA shading candidates (inexact dedup).
        Returns True if anything grew (recompiles)."""
        changed = False
        if self._total_overflow(stats_host) > 0:
            changed = self._grow_pair_capacity(stats_host)
        changed = self._grow_layer_capacity(stats_host) or changed
        return self._grow_shade_candidates(stats_host) or changed

    def _maybe_shrink_capacities(self, stats_host) -> None:
        self._maybe_shrink_pair_capacity(stats_host)
        self._maybe_shrink_layers(stats_host)
        self._maybe_shrink_shade_candidates(stats_host)

    def _maybe_shrink_pair_capacity(self, stats_host) -> None:
        """Shrink the binning buckets when the scene has sustainedly needed
        ≤ half of them (with 2× headroom) — see `shrink_after` and
        _streak_shrink (sized from the streak's peak demand). Covers both
        ragged-binning axes: pair_capacity ← total_pairs and
        row_capacity ← total_rows. Guarded on row_overflow == 0: while
        rows are truncating (e.g. row_capacity pegged at its ceiling),
        total_pairs only covers the rows that fit — shrinking from that
        understated demand would drop pairs that previously fit and
        oscillate with regrowth."""
        ridx = pipeline.STAT_NAMES.index("row_overflow")
        if len(stats_host) > ridx and int(stats_host[ridx]) > 0:
            self._streaks["pair_capacity"] = (0, 0)
            self._streaks["row_capacity"] = (0, 0)
            return
        for field, stat in (("pair_capacity", "total_pairs"),
                            ("row_capacity", "total_rows")):
            idx = pipeline.STAT_NAMES.index(stat)
            if len(stats_host) <= idx:
                return
            self._streak_shrink(
                field, int(stats_host[idx]),
                lambda d: 1 << max(14, (max(d, 1) * 2 - 1).bit_length()),
                0, stat,
            )

    # -- device array preparation -------------------------------------------

    #: distinct draw-list shapes kept resident (host stream + device
    #: vertex/triangle/morph arrays each) — LRU-bounded so an app cycling
    #: scenes (level loads, visibility churn) can't grow device memory
    #: without bound; the same discipline as the loader's blocks cache
    GEOM_CACHE_MAX = 8

    def _geometry(self, scene: Scene, order, geom_key: bytes):
        cached = self._geom_cache.pop(geom_key, None)  # re-insert = LRU touch
        if cached is None:
            draws = scene.materialize(order)
            gs = draw_stream.build_geometry(draws, self.config.max_triangles)
            dev = {
                k: jnp.asarray(getattr(gs, k))
                for k in ("positions", "uvs", "normals", "tangents", "joints",
                          "weights", "exp_src", "exp_draw", "tri_v",
                          "morph_pos", "morph_nrm", "morph_row0", "morph_step")
            }
            cached = (gs, dev)
        self._geom_cache[geom_key] = cached
        while len(self._geom_cache) > self.GEOM_CACHE_MAX:
            # oldest entry first (dict preserves insertion order); dropping
            # the reference frees its device arrays
            self._geom_cache.pop(next(iter(self._geom_cache)))
        return cached

    def _use_device_atlas(self) -> bool:
        """Decode BC7 on the device (upload blocks, not decoded texels —
        materials/atlas_device.py) on the GPU; the host path stays the
        oracle (bit-parity pinned in tests/test_bc7_decode.py) and the CPU
        default (tests/interpret: no link to save, and the mmap'd host
        bundle is cheaper than a scatter compile). Override with
        RENDERER_TPU_ATLAS=device|host."""
        import os

        mode = os.environ.get("RENDERER_TPU_ATLAS", "")
        if mode in ("device", "host"):
            return mode == "device"
        return not self._interpret

    def _materials(self):
        reg = self.registry
        if self._mat_cache is not None and self._mat_cache[0] == reg.version:
            return self._mat_cache[1]
        atlas_dev = None
        if self._use_device_atlas():
            from renderer_tpu.materials.atlas_device import (
                build_atlas_plan_cached,
                realize_atlas,
            )

            plan = build_atlas_plan_cached(reg)
            host_bytes = plan.shape[0] * plan.shape[1] * 4
            if plan.upload_bytes < host_bytes:
                atlas_dev = realize_atlas(plan)
                table, srgb, wrap = plan.table, plan.srgb, plan.wrap
            else:
                # mostly non-BC7 textures: the compressed plan would ship
                # MORE bytes than the decoded atlas — use the host path (its
                # bundle cache mmaps the decoded bytes)
                print(
                    f"[renderer] device atlas plan ({plan.upload_bytes}"
                    f" B) not smaller than the decoded atlas "
                    f"({host_bytes} B); using the host path")
        if atlas_dev is None:
            at = build_atlas(reg)
            atlas_dev = jnp.asarray(at.data)
            table, srgb, wrap = at.table, at.srgb, at.wrap
        dev = {
            "base_color_factor": jnp.asarray(reg.base_color_factor),
            "emissive_occlusion": jnp.asarray(reg.emissive_occlusion),
            "alpha_rgh_mtl_normal": jnp.asarray(reg.alpha_rgh_mtl_normal),
            "tex_indices": jnp.asarray(reg.tex_indices),
            "atlas": atlas_dev,
            "atlas_table": jnp.asarray(table),
            "atlas_srgb": jnp.asarray(srgb),
        }
        if wrap.any():
            # per-texture sampler address modes (TextureWrap) — attached
            # only when some texture is non-repeat, so the common all-repeat
            # registry compiles the exact pre-wrap sampler (zero-cost)
            dev["atlas_wrap"] = jnp.asarray(wrap)
        self._mat_cache = (reg.version, dev)
        return dev

    def _joint_cap(self, scene: Scene) -> int:
        """Pow-2 joint-palette bucket for the frame blob, sized from the
        scene's exact joint cursor (measure-then-allocate, like the draw
        cap — no overflow stat needed: allocation is host-side bump, so the
        bucket can never truncate a live joint). A static jit key; consumers
        that unpack a blob this renderer packed must pass the same value."""
        return _next_pow2(max(scene._joint_cursor, 8))

    def _frame_arrays(self, scene: Scene, fv, gs, debug_mode: int = 0) -> dict:
        blob = draw_stream.pack_frame_blob(
            fv, scene.joint_palette, self._proj_view(scene),
            (gs.num_tris, gs.num_opaque_tris, gs.num_masked_tris, debug_mode),
            morph_k=gs.morph_k, joint_cap=self._joint_cap(scene),
        )
        # the HOST array goes straight into the jit call: the implicit arg
        # device_put rides the dispatch itself
        return {"blob": blob}

    # -- frame loop ----------------------------------------------------------

    def _dispatch(self, scene: Scene, debug_mode: int, ui=None):
        p = self.profiler
        with p.span("sort draws + pack"):
            fv = draw_stream.frame_view(scene)
        with p.span("geometry arrays"):
            gs, geom_dev = self._geometry(scene, fv.order, fv.geom_key)
        with p.span("frame arrays"):
            frame = self._frame_arrays(scene, fv, gs, debug_mode)
            if ui is not None:
                packed_ui = ui.pack() if hasattr(ui, "pack") else ui
                frame["ui"] = {k: jnp.asarray(v) for k, v in packed_ui.items()}
        with p.span("materials"):
            mats = self._materials()
        with p.span("dispatch jitted frame"):
            img, stats = self._frame_fn(
                geom_dev, frame, mats,
                config=self.config, skin_start=gs.skin_start,
                has_masked=gs.num_masked_tris > 0,
                has_blended=gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris,
                morph_k=gs.morph_k, joint_cap=self._joint_cap(scene),
            )
        return img, stats

    def render_frame_device(self, scene: Scene, debug_mode: int = 0,
                            ui=None) -> jnp.ndarray:
        """One frame, returned as a device u8 [H,W,3] array (no host copy).
        `ui` — optional renderer_tpu.ui.DrawList (or its packed dict): the
        overlay rendered through the raster pipeline's UI pass."""
        p = self.profiler
        with p.span("render_frame"):
            prev_stats = self._last_stats
            img, stats = self._dispatch(scene, debug_mode, ui)
            self._last_stats = stats
            if self.overflow_policy == "sync":
                # loop: regrow until the frame reports no dropped/truncated
                # work (or every growable capacity is at its max)
                for _ in range(8):
                    host = np.asarray(stats)
                    if not self._grow_capacities(host):
                        self._maybe_shrink_capacities(host)
                        break
                    img, stats = self._dispatch(scene, debug_mode, ui)
                    self._last_stats = stats
            elif self.overflow_policy == "auto" and prev_stats is not None:
                # one-frame-delayed check: the previous frame has completed by
                # now (this frame was just dispatched behind it), so this host
                # read does not stall the pipeline. A frame rendered BEFORE a
                # capacity grow still reports the old overflow — acting on it
                # would double-grow from one event, so skip its check.
                if self._skip_stat_checks > 0:
                    self._skip_stat_checks -= 1
                else:
                    host = np.asarray(prev_stats)
                    if self._grow_capacities(host):
                        self._skip_stat_checks = 1
                    else:
                        self._maybe_shrink_capacities(host)
        return img

    def render_frames_device(self, scenes, debug_mode: int = 0):
        """Device-resident multi-frame rendering: ONE dispatch renders all
        `scenes` (a camera path / animation timeline sharing one draw list)
        and returns (u8 device images [K, H, W, 3], stats [K, N_STATS]).
        Amortizes per-dispatch overhead ~K× vs. the interactive loop — the
        offline/flythrough throughput mode (no UI pass).

        Overflow policy applies to the MAX over all K frames' stats rows (no
        frame's dropped work can hide behind a clean final frame): "sync"
        re-renders the whole batch at grown capacity until clean, "auto"
        grows for the next call and logs loudly, "off" leaves verification
        to the caller via the returned stats (timed loops — any host read
        here would sync the dispatch)."""
        assert scenes, "need at least one scene"
        fvs = [draw_stream.frame_view(s) for s in scenes]
        for fv in fvs[1:]:
            assert fv.geom_key == fvs[0].geom_key, (
                "render_frames_device: all scenes must queue the same draw "
                "list (geometry stream is shared across the batch)"
            )
        gs, geom_dev = self._geometry(scenes[0], fvs[0].order, fvs[0].geom_key)
        # one blob layout for the whole batch: the widest scene's bucket
        joint_cap = max(self._joint_cap(s) for s in scenes)
        blobs = np.stack([
            draw_stream.pack_frame_blob(
                fv, scene.joint_palette, self._proj_view(scene),
                (gs.num_tris, gs.num_opaque_tris, gs.num_masked_tris,
                 debug_mode),
                morph_k=gs.morph_k, joint_cap=joint_cap,
            )
            for fv, scene in zip(fvs, scenes)
        ])
        mats = self._materials()

        def dispatch():
            return self._frames_fn(
                geom_dev, jnp.asarray(blobs), mats,
                config=self.config, skin_start=gs.skin_start,
                has_masked=gs.num_masked_tris > 0,
                has_blended=gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris,
                morph_k=gs.morph_k, joint_cap=joint_cap,
            )

        imgs, stats = dispatch()
        if self.overflow_policy != "off":
            # batch-wide overflow check: the worst frame's stats, not the
            # last frame's (a frame mid-batch must not drop work silently;
            # demand maxes over the batch are exactly the max stats rows)
            for _ in range(8):
                host = np.asarray(jnp.max(stats, axis=0))
                if not self._grow_capacities(host):
                    self._maybe_shrink_capacities(host)
                    break
                if self.overflow_policy != "sync":
                    # grown for the next call; this batch stays as-is — and
                    # its stats rows still report the OLD capacity's
                    # overflow, so the next render_frame_device's delayed
                    # check must not grow AGAIN from the same event
                    self._skip_stat_checks = 1
                    break
                imgs, stats = dispatch()
        self._last_stats = stats[-1]
        return imgs, stats

    def _proj_view(self, scene: Scene) -> np.ndarray:
        proj, view = scene.camera.proj_view(
            float(self.config.width), float(self.config.height),
            scene.world_space,
        )
        return proj @ view

    def render_frame(self, scene: Scene, debug_mode: int = 0,
                     ui=None) -> np.ndarray:
        """One frame, copied back to the host (the 'present' boundary).
        Timed loops stay on `render_frame_device` and read back once at the
        end."""
        img = self.render_frame_device(scene, debug_mode, ui)
        with self.profiler.span("present (device→host)"):
            return np.asarray(img)
