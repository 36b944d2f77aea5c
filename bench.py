"""Benchmark: frames/sec of the jitted raster loop (the original target:
≥60 FPS at 1920×1080 Sponza+skinned on one chip; BASELINE.json).

Prints ONE JSON line: {"metric": ..., "value": N, "unit": "fps",
"vs_baseline": N, "dropped_pairs": int, "dropped_rows": int,
"overflow_checked": bool, "measures": str} where vs_baseline is value / 60,
the two dropped_* integers are the verifier's per-axis binning-truncation
counts (-1 only when verification was unavailable, flagged by
overflow_checked), and "measures" states what the number is (host +
dispatch throughput: only the last frame of a pass is fenced). The benched
configuration is the DEFAULT RenderConfig,
which since round 5 is the reference device's exact sampler (per-tap sRGB +
aniso16); --fast benches the cheap opt-in sampler instead.

Renders the heaviest scene available: Sponza + Smol Ame when the glTF assets
and loader are available, otherwise the triangle demo scene. Every frame does
the FULL per-frame work of the reference's main loop (main.rs:325-640):
host-side scene re-queue, skeletal-animation evaluation (ALL of the
character's animations layered, like the demo), a moving camera, draw sort +
instance-merge + upload, then the jitted device frame. Frames are dispatched
back-to-back; only the last frame is synchronized.

Completeness verification runs apart from the timing: the deterministic
frame timeline is first replayed in a SEPARATE CPU process (--verify) that
reads the stats vector back after every frame. The timed process then runs
with ZERO device→host copies and reports the verifier's integer
dropped-pair count. Geometry is
the Sponza proxy when the glTF .bin buffers are absent from the asset mount
(see README "Benchmark honesty").
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

WARMUP = 3


def _capacity_overrides(pair_capacity, row_capacity):
    out = {}
    if pair_capacity:
        out["pair_capacity"] = pair_capacity
    if row_capacity:
        out["row_capacity"] = row_capacity
    return out


#: What the fps number measures on this runtime — carried in every JSON line
#: so the caveat cannot be lost by reading the bench output alone.
MEASURES = ("host+dispatch throughput; frames are dispatched back to back "
            "and only the last frame of a pass is fenced")


def build_triangle_bench(pair_capacity: int | None = None,
                         row_capacity: int | None = None,
                         fast: bool = False):
    import renderer_tpu as rt
    from apps.triangle import build_scene, build_triangle_assets

    registry, meshes, material = build_triangle_assets()
    # the default RenderConfig IS the reference-exact sampler (per-tap sRGB
    # + aniso16, descriptors.rs:90-105) — the canonical metric
    config = rt.RenderConfig(width=1920, height=1080)
    overrides = _capacity_overrides(pair_capacity, row_capacity)
    if overrides:
        from dataclasses import replace

        config = replace(config, **overrides)
    if fast:
        config = config.fast_sampler()
    # "off" like the sponza path: no per-frame device→host stats read in the
    # timed loop
    renderer = rt.Renderer(registry, config, overflow_policy="off")

    def make_scene(game_time: float):
        return build_scene(meshes, material)

    return ("triangle-1080p" + ("-fast" if fast else ""), renderer,
            make_scene)


def build_sponza_bench(pair_capacity: int | None = None,
                       row_capacity: int | None = None,
                       fast: bool = False):
    from apps import sandbox
    from renderer_tpu.core import math3d

    sb, renderer, name = sandbox.build_bench(for_bench=True)
    overrides = _capacity_overrides(pair_capacity, row_capacity)
    if overrides:
        from dataclasses import replace

        renderer.config = replace(renderer.config, **overrides).validate()
    if fast:
        # `python bench.py --fast` quantifies the cheap opt-in sampler
        # (decode-after-filter sRGB + aniso4) vs the exact default
        renderer.config = renderer.config.fast_sampler()
        name += "-fast"

    pooled: list = [None]

    def make_scene(game_time: float):
        # flying camera orbiting the atrium + animated Smol Ame, the same
        # per-frame host work as the reference demo's main loop — re-queued
        # into ONE long-lived Scene (the reference's per-frame reset)
        scene = pooled[0] = sb.build_scene(game_time, scene=pooled[0])
        pos, orient = sandbox.orbit_camera(0.25 * game_time)
        scene.camera.position = pos
        scene.camera.orientation = orient
        return scene

    return name, renderer, make_scene


def build_bench(pair_capacity: int | None = None,
                row_capacity: int | None = None,
                fast: bool = False):
    try:
        return build_sponza_bench(pair_capacity, row_capacity, fast)
    except Exception as e:  # noqa: BLE001 — assets/loader not ready yet
        print(f"# sponza bench unavailable ({type(e).__name__}: {e}); "
              "falling back to triangle", file=sys.stderr)
        return build_triangle_bench(pair_capacity, row_capacity, fast)


def frame_times(frames: int):
    """The canonical deterministic timeline: warmup times then the timed
    pass's times — identical in the verifier and the timed process."""
    return [0.01 * i for i in range(WARMUP)] + [
        1.0 + i / 60.0 for i in range(frames)
    ]


def verify_main(frames: int, pair_capacity: int | None,
                row_capacity: int | None = None) -> None:
    """--verify mode (run in a FRESH process, forced onto the CPU backend):
    replay the exact frame timeline through the SAME jitted
    vertex→setup→binning stages the frame function runs, and count each
    frame's (tile, triangle) pairs and overflow.

    Pair overflow is a pure function of (scene, camera, RenderConfig) —
    integer tile-span arithmetic over the setup bboxes. Every contraction
    feeding clip positions is pinned to Precision.HIGHEST (vertex_stage),
    so the CPU replay and the device run compute the same f32 program rather
    than reduced-precision matmuls; residual ULP-level elementwise
    divergence between backends is covered by the caller's brim guard
    (the timed run grows one bucket when the verified peak sits within
    4096 pairs of capacity). The CPU replay keeps every readback out of
    the timed process."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp  # noqa: F401

    from renderer_tpu.raster import binning, setup, vertex_stage
    from renderer_tpu.scene import draw_stream

    name, renderer, make_scene = build_bench(pair_capacity, row_capacity)
    cfg = renderer.config
    dropped = 0
    dropped_rows = 0
    max_pairs = 0
    max_rows = 0
    for t in frame_times(frames):
        scene = make_scene(t)
        fv = draw_stream.frame_view(scene)
        gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
        frame = draw_stream.unpack_frame(
            renderer._frame_arrays(scene, fv, gs), morph_k=gs.morph_k,
            joint_cap=renderer._joint_cap(scene),
        )
        vs = vertex_stage.run_vertex_stage(geom, frame,
                                           skin_start=gs.skin_start,
                                           morph_k=gs.morph_k)
        td = setup.triangle_setup(
            vs["clip"], geom["tri_v"], frame["num_tris"],
            cfg.width, cfg.height,
            bbox_pad=(0.5 if cfg.msaa_samples > 1 else 0.0),
        )
        bounds = [0, frame["n_opaque"]]
        if gs.num_masked_tris > 0:
            bounds.append(frame["n_opaque"] + frame["n_masked"])
        if gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris:
            bounds.append(frame["num_tris"])
        _b, _s, _counts, ov, row_ov, pair_dem, row_dem = \
            binning.bin_triangle_classes(
                td, tuple(bounds),
                tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_w, tile_h=cfg.tile_h,
                pair_capacity=cfg.pair_capacity,
                row_capacity=cfg.row_capacity,
            )
        # brim guard sizing signals = the ragged expansion demands (counts
        # are the post-reject survivors, smaller than what capacity holds)
        dropped = max(dropped, int(np.asarray(ov).sum()))
        dropped_rows = max(dropped_rows, int(np.asarray(row_ov)))
        max_pairs = max(max_pairs, int(np.asarray(pair_dem)))
        max_rows = max(max_rows, int(np.asarray(row_dem)))
    print(json.dumps({
        "metric": name,
        "dropped_pairs": dropped,
        "dropped_rows": dropped_rows,
        "max_total_pairs": max_pairs,
        "max_total_rows": max_rows,
        "pair_capacity": cfg.pair_capacity,
        "row_capacity": cfg.row_capacity,
    }), flush=True)
    os._exit(0)


def run_verifier(frames: int, pair_capacity: int | None,
                 row_capacity: int | None = None,
                 timeout_s: float = 1800.0):
    """Run the verification pass in a fresh subprocess (sequential with this
    process — the chip is never shared). Returns the parsed JSON dict or
    None when the verifier failed."""
    cmd = [sys.executable, os.path.abspath(__file__), str(frames), "--verify"]
    if pair_capacity:
        cmd += ["--pair-capacity", str(pair_capacity)]
    if row_capacity:
        cmd += ["--row-capacity", str(row_capacity)]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=timeout_s,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except subprocess.TimeoutExpired:
        print("# verifier subprocess timed out", file=sys.stderr)
        return None
    sys.stderr.write(proc.stderr)
    for line in reversed(proc.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                break
    print(f"# verifier subprocess produced no result (rc={proc.returncode})",
          file=sys.stderr)
    return None


_progress = {"t": time.time(), "label": "start",
             "dropped_pairs": -1, "dropped_rows": -1,
             "overflow_checked": False}


def _mark(label: str) -> None:
    _progress["t"] = time.time()
    _progress["label"] = label


def _start_stall_watchdog(limit_s: float) -> None:
    """Fail fast (with an honest one-line JSON) instead of hanging forever
    when the device stops making progress: a stalled device init blocks
    indefinitely with no exception. The limit is generous — it must cover a
    cold compile — and resets at every phase boundary / timing pass."""
    import threading

    def watch():
        while True:
            time.sleep(30.0)
            idle = time.time() - _progress["t"]
            if idle > limit_s:
                # carry whatever the CPU-replay verifier already proved —
                # a stalled device shouldn't discard a completed completeness
                # check
                print(json.dumps({
                    "metric": "bench-stalled",
                    "value": 0.0,
                    "unit": "fps",
                    "vs_baseline": 0.0,
                    "dropped_pairs": _progress["dropped_pairs"],
                    "dropped_rows": _progress["dropped_rows"],
                    "overflow_checked": _progress["overflow_checked"],
                    "measures": MEASURES,
                    "error": f"no progress for {int(idle)}s after "
                             f"'{_progress['label']}' — device stall",
                }), flush=True)
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def main():
    args = [a for a in sys.argv[1:]]
    pair_capacity = None
    row_capacity = None
    if "--pair-capacity" in args:
        i = args.index("--pair-capacity")
        pair_capacity = int(args[i + 1])
        del args[i : i + 2]
    if "--row-capacity" in args:
        i = args.index("--row-capacity")
        row_capacity = int(args[i + 1])
        del args[i : i + 2]
    verify = "--verify" in args
    if verify:
        args.remove("--verify")
    # The DEFAULT bench is the reference device's exact sampler (per-tap
    # sRGB + aniso16 — a plain RenderConfig since round 5). --fast benches
    # the cheap opt-in sampler; sampler state only changes shading, so the
    # completeness verifier (setup + binning replay) is shared. --exact is
    # accepted as a no-op for compatibility with round<5 invocations.
    fast = "--fast" in args
    if fast:
        args.remove("--fast")
    if "--exact" in args:
        args.remove("--exact")
    frames = int(args[0]) if args else 60

    if verify:
        verify_main(frames, pair_capacity, row_capacity)
        return

    _start_stall_watchdog(float(os.environ.get("BENCH_STALL_LIMIT", "2700")))

    # -- phase 1: completeness verification (fresh process, sequential) ------
    overflow = -1
    ov_pairs = ov_rows = -1
    result = None
    for _attempt in range(3):
        result = run_verifier(frames, pair_capacity, row_capacity)
        _mark(f"verifier attempt {_attempt + 1}")
        if result is None:
            break
        ov_pairs = int(result["dropped_pairs"])
        ov_rows = int(result.get("dropped_rows", 0))
        overflow = ov_pairs + ov_rows
        if overflow == 0:
            # brim guard: the CPU replay and the device run share program
            # semantics at pinned-precision contractions (vertex_stage._HI),
            # but elementwise FP could still diverge by ULPs between
            # backends. If a measured peak sits within a sliver of its
            # bucket, size the TIMED run one bucket up so a one-tile bbox
            # shift can never drop work that the replay proved fits.
            margin = int(result["pair_capacity"]) - int(result["max_total_pairs"])
            if margin < 4096:
                pair_capacity = int(result["pair_capacity"]) * 2
                print(f"# verified clean but only {margin} pairs of headroom;"
                      f" timed run uses pair_capacity={pair_capacity}",
                      file=sys.stderr)
            rmargin = int(result["row_capacity"]) - int(result["max_total_rows"])
            if rmargin < 4096:
                row_capacity = int(result["row_capacity"]) * 2
                print(f"# verified clean but only {rmargin} rows of headroom;"
                      f" timed run uses row_capacity={row_capacity}",
                      file=sys.stderr)
            break
        # a frame dropped binning work: grow the overflowed bucket(s) to the
        # measured demand and re-verify, so the reported number never hides
        # dropped triangles (the loud-overflow discipline)
        if ov_pairs > 0:
            need = max(int(result["max_total_pairs"]),
                       int(result["pair_capacity"]) + ov_pairs)
            cap = int(result["pair_capacity"])
            while cap < need:
                cap *= 2
            print(f"# verifier found {ov_pairs} dropped pairs; re-verifying "
                  f"at pair_capacity={cap}", file=sys.stderr)
            pair_capacity = cap
        if ov_rows > 0:
            need = max(int(result["max_total_rows"]),
                       int(result["row_capacity"]) + ov_rows)
            cap = int(result["row_capacity"])
            while cap < need:
                cap *= 2
            print(f"# verifier found {ov_rows} dropped tile-rows; "
                  f"re-verifying at row_capacity={cap}", file=sys.stderr)
            row_capacity = cap
    if result is not None and overflow > 0:
        # retries exhausted while still overflowing: time at the capacities
        # the reported overflow was actually measured at, not the once-more
        # -grown (unverified) buckets — the JSON must describe the timed run
        pair_capacity = int(result["pair_capacity"])
        row_capacity = int(result["row_capacity"])
    _mark("verifier done")
    checked = overflow >= 0
    # keep the two binning axes separate in every JSON (a row-only drop
    # reported under "dropped_pairs" would steer readers at the wrong knob)
    _progress["dropped_pairs"] = ov_pairs
    _progress["dropped_rows"] = ov_rows
    _progress["overflow_checked"] = checked
    if not checked:
        print("# completeness verification unavailable; reporting "
              "dropped_pairs=-1", file=sys.stderr)

    # -- phase 2: timed run (ZERO device→host copies, this process) ----------
    name, renderer, make_scene = build_bench(pair_capacity, row_capacity,
                                             fast)
    _mark("bench built")

    def run_pass(label: str):
        """Warmup (compile) + timed loop. NO device→host copies before or
        inside the timing; completeness was proven by the verifier
        subprocess on this exact timeline."""
        ts = frame_times(frames)
        img = None
        for t in ts[:WARMUP]:
            img = renderer.render_frame_device(make_scene(t), debug_mode=0)
        img.block_until_ready()

        t0 = time.perf_counter()
        for t in ts[WARMUP:]:
            img = renderer.render_frame_device(make_scene(t), debug_mode=0)
        img.block_until_ready()
        _mark(f"{label} done")
        return frames / (time.perf_counter() - t0)

    # Best of 3 passes; only the first pass compiles.
    fps = max(run_pass(f"pass{i + 1}") for i in range(3))

    print(
        json.dumps(
            {
                "metric": f"{name} jitted raster loop",
                "value": round(fps, 2),
                "unit": "fps",
                "vs_baseline": round(fps / 60.0, 3),
                "dropped_pairs": ov_pairs,
                "dropped_rows": ov_rows,
                "overflow_checked": checked,
                "measures": MEASURES,
            }
        ),
        flush=True,
    )
    # never let a stray handle hang process exit
    os._exit(0)


if __name__ == "__main__":
    main()
