"""The BASELINE.json benchmark-config matrix, runnable end to end.

Each entry mirrors one line of BASELINE.json `configs` (the de-facto
integration-test matrix, SURVEY.md §4): renders it, saves a PNG, and reports
the steady-state frame time.

Run: python -m apps.configs [outdir] [frames]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

import renderer_tpu as rt


def _timed(renderer, scene, mode, frames):
    """Times the jitted loop WITHOUT any device→host readback: images stay
    on device until all timing is done, and only the last frame is
    fenced."""
    img = renderer.render_frame_device(scene, mode)
    img.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(frames):
        img = renderer.render_frame_device(scene, mode)
    img.block_until_ready()
    return img, (time.perf_counter() - t0) / frames * 1e3


def run_all(outdir: str = "configs_out", frames: int = 10,
            save_images: bool = True) -> list[dict]:
    """save_images=False skips ALL device→host readbacks (tools/warm_cache
    runs the matrix purely to populate the persistent XLA compile cache via
    the production jit-call path)."""
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    from apps import triangle as tri_app
    from apps.sandbox import Sandbox, orbit_camera
    from renderer_tpu.core import math3d
    from renderer_tpu.tools.png import write_png

    results = []
    pending_images = []  # (name, device image) — read back after ALL timing

    def record(name, img, ms):
        pending_images.append((name, img))
        results.append({"config": name, "ms_per_frame": round(ms, 3),
                        "fps": round(1000.0 / ms, 1)})
        print(results[-1], flush=True)

    # 1. triangle: single hardcoded triangle, 800×600, flat color
    registry, meshes, material = tri_app.build_triangle_assets()
    renderer = rt.Renderer(registry, rt.RenderConfig(width=800, height=600),
                           overflow_policy="off")
    scene = tri_app.build_scene(meshes, material)
    img, ms = _timed(renderer, scene, 1, frames)
    record("triangle-800x600-flat", img, ms)

    # 2. static Sponza, fixed camera, base-color (albedo) @ 1280×720
    full = Sandbox(with_smol_ame=True)  # one asset load serves configs 2-5
    renderer = rt.Renderer(full.registry, rt.RenderConfig(width=1280, height=720),
                           overflow_policy="off")
    scene = rt.Scene(world_space=rt.GLTF)
    scene.camera.position = np.array([0.0, 1.6, 0.0], np.float32)
    scene.camera.orientation = math3d.quat_from_axis_angle([0, 1, 0], 1.56)
    full.sponza.queue(scene, math3d.IDENTITY)
    img, ms = _timed(renderer, scene, 1, frames)
    record("sponza-albedo-720p", img, ms)

    # 3. Sponza G-buffer sweep: draw-id / normals / rough-metal / emissive / AO
    for mode, name in ((2, "draw-id"), (3, "normals"), (4, "rough-metal"),
                       (5, "emissive"), (6, "occlusion")):
        img, ms = _timed(renderer, scene, mode, max(frames // 2, 3))
        record(f"sponza-gbuffer-{name}", img, ms)

    # 4. skinned animation: per-frame bone transforms + skinned vertex pass
    char = full.smol_ame
    char_renderer = rt.Renderer(full.registry,
                               rt.RenderConfig(width=640, height=480),
                               overflow_policy="off")
    anim = char.animations[0]
    for t in (0.0, 0.75):
        scene = rt.Scene(world_space=rt.GLTF)
        eye, orient = math3d.look_at(
            np.array([0.0, 0.6, 1.6]), np.array([0.0, 0.5, 0.0]),
            np.array([0.0, 1.0, 0.0]),
        )
        scene.camera.position, scene.camera.orientation = eye, orient
        char.queue_animated(scene, math3d.IDENTITY, [(t, anim)])
        img, ms = _timed(char_renderer, scene, 0, max(frames // 2, 3))
        record(f"skinned-anim-t{t}", img, ms)

    # 5. full sandbox: Sponza + animated character, lit, 1920×1080, 4×MSAA
    renderer = rt.Renderer(
        full.registry, rt.RenderConfig(width=1920, height=1080, msaa_samples=4),
        overflow_policy="off",
    )
    scene = full.build_scene(1.0)
    img, ms = _timed(renderer, scene, 0, frames)
    record("sandbox-lit-1080p-msaa4", img, ms)

    # 5b. the fast_sampler opt-in at the same configuration — tracks the
    # cheap mode's headroom vs the exact default (which config 5 now is)
    fast_renderer = rt.Renderer(
        full.registry,
        rt.RenderConfig(width=1920, height=1080,
                        msaa_samples=4).fast_sampler(),
        overflow_policy="off",
    )
    img, ms = _timed(fast_renderer, scene, 0, frames)
    record("sandbox-lit-1080p-msaa4-fastsampler", img, ms)

    # 6. device-resident flythrough: 16 frames (camera orbit + animation)
    # per dispatch via lax.scan — the offline-throughput mode that amortizes
    # the per-dispatch host overhead bounding config 5. Its own
    # renderer: the orbit's worst frame needs 176,269 ragged binning pairs
    # / 194,597 tile-rows (sandbox.build_bench) — the 1<<18 defaults hold.
    renderer = rt.Renderer(
        full.registry,
        rt.RenderConfig(width=1920, height=1080, msaa_samples=4),
        overflow_policy="off",
    )
    k = 16
    times = [1.0 + i / 30.0 for i in range(k)]
    scenes = [full.build_scene(t) for t in times]
    for i, (t, s) in enumerate(zip(times, scenes)):
        s.camera.position, s.camera.orientation = orbit_camera(0.25 * t)
    imgs, _stats = renderer.render_frames_device(scenes, debug_mode=0)  # compile
    imgs.block_until_ready()
    t0 = time.perf_counter()
    reps = max(frames // 4, 2)
    for _ in range(reps):
        imgs, _stats = renderer.render_frames_device(scenes, debug_mode=0)
    imgs.block_until_ready()
    ms = (time.perf_counter() - t0) / (reps * k) * 1e3
    record(f"sandbox-flythrough-batch{k}-1080p-msaa4", imgs[0], ms)

    # 7. capacity stress: >1M triangles (4x Sponza-scale) through the full
    # pipeline — exercises the max_triangles bucket and multi-million-pair
    # binning (SURVEY §5.7 scale axis)
    from renderer_tpu.assets import proxy as proxy_mod

    sreg = rt.MaterialRegistry()
    sbuilder = rt.VertexLibraryBuilder()
    smeshes, smat = proxy_mod.make_stress_field(sbuilder, sreg, n_meshes=32,
                                                tris_per_mesh=32768)
    sbuilder.build()
    stress_renderer = rt.Renderer(
        sreg,
        # 607k pairs / 604k tile-rows measured for this camera (tiny
        # triangles: the ragged expansion equals the bbox one here);
        # 1<<20 keeps 1.7x headroom on both axes
        rt.RenderConfig(width=1920, height=1080, max_triangles=1 << 21,
                        pair_capacity=1 << 20, row_capacity=1 << 20),
        overflow_policy="off",
    )
    scene = rt.Scene(world_space=rt.GLTF)
    eye = np.array([0.0, 14.0, 26.0], np.float32)
    pos, orient = math3d.look_at(eye, np.array([0.0, 0.0, 0.0], np.float32),
                                 np.array([0, 1, 0], np.float32))
    scene.camera.position, scene.camera.orientation = pos, orient
    for m in smeshes:
        scene.queue_mesh(m, smat, None, math3d.IDENTITY)
    img, ms = _timed(stress_renderer, scene, 0, max(frames // 2, 3))
    record("stress-1M-tris-1080p", img, ms)

    # 8. pair-capacity stress: ≥4M (tile, triangle) pairs — the 1M-tri field
    # PLUS an 8000-layer screen-spanning overdraw stack (pairs ≈ layers · 2 ·
    # covered tiles). Binning (expansion + one stable sort + slim-row scatter) and
    # the raster kernels' bin streams run at ~7x the Sponza-scale bench's
    # pair count; cost must track pairs ~linearly (tools/binning_scaling.py
    # measures the isolated curve).
    sreg2 = rt.MaterialRegistry()
    sbuilder2 = rt.VertexLibraryBuilder()
    omesh, omat, otransforms = proxy_mod.make_overdraw_stack(sbuilder2, sreg2)
    smeshes2, smat2 = proxy_mod.make_stress_field(sbuilder2, sreg2,
                                                  n_meshes=32,
                                                  tris_per_mesh=32768)
    sbuilder2.build()
    stress4m_renderer = rt.Renderer(
        sreg2,
        # the scene's bbox expansion is ~4.3M pairs; the ragged expansion
        # needs 1.75M pairs / 759k tile-rows for this camera (the overdraw
        # quads' row windows shed the outside-the-stack tiles) — 1<<21 /
        # 1<<20 keep ~20%/38% headroom
        rt.RenderConfig(width=1920, height=1080, max_triangles=1 << 21,
                        pair_capacity=1 << 21, row_capacity=1 << 20),
        overflow_policy="off",
    )
    scene = rt.Scene(world_space=rt.GLTF)
    scene.camera.position, scene.camera.orientation = pos, orient
    for m in smeshes2:
        scene.queue_mesh(m, smat2, None, math3d.IDENTITY)
    scene.queue_instanced(omesh, omat, otransforms)
    img, ms = _timed(stress4m_renderer, scene, 0, max(frames // 3, 2))
    record("stress-4Mpairs-1080p", img, ms)

    # 9. morph-target animation: a blend-shape sheet driven by per-frame
    # weights — the capability the reference leaves as a todo!()
    # (gltf/src/lib.rs:229). Per-frame host work = requeue with new
    # weights; the delta-bank tap runs inside the jitted vertex stage.
    mreg = rt.MaterialRegistry()
    mbuilder = rt.VertexLibraryBuilder()
    mmesh, mmat = proxy_mod.make_morph_sheet(mbuilder, mreg)
    mbuilder.build()
    morph_renderer = rt.Renderer(
        mreg, rt.RenderConfig(width=640, height=480), overflow_policy="off"
    )

    def morph_scene(t: float) -> rt.Scene:
        scene = rt.Scene(world_space=rt.GLTF)
        eye = np.array([0.0, 2.2, 2.6], np.float32)
        pos, orient = math3d.look_at(
            eye, np.array([0.0, 0.0, 0.0], np.float32),
            np.array([0, 1, 0], np.float32),
        )
        scene.camera.position, scene.camera.orientation = pos, orient
        w = np.array([0.5 + 0.5 * np.sin(2.0 * t),
                      0.5 + 0.5 * np.cos(1.3 * t)], np.float32)
        scene.queue_mesh(mmesh, mmat, None, math3d.IDENTITY, morph_weights=w)
        return scene

    img = morph_renderer.render_frame_device(morph_scene(0.0), 3)
    img.block_until_ready()
    t0 = time.perf_counter()
    nm = max(frames // 2, 3)
    for i in range(nm):
        img = morph_renderer.render_frame_device(morph_scene(0.4 * (i + 1)), 3)
    img.block_until_ready()
    record("morph-sheet-480p-normals", img,
           (time.perf_counter() - t0) / nm * 1e3)

    # 10. REAL geometry end-to-end: testbox.glb is the mount's only asset
    # with actual vertex/index/texture bytes (the Sponza .bin LFS buffers
    # are absent — configs 2-6 substitute proxy geometry). One box
    # (golden-locked, tests/test_testbox_golden.py) plus a 90-instance
    # field at Sponza-like triangle count (276,480 real tris; measured
    # demand 144k pairs / 142k tile-rows — the 1<<18 defaults hold), so
    # real index/vertex/tangent patterns run at bench scale every round,
    # bounding the proxy bench's raster-coherence optimism.
    from apps import testbox as testbox_app

    try:
        treg, _tlib, tgltf = testbox_app.load_testbox()
    except Exception as e:  # noqa: BLE001 — asset mount optional
        print(f"# testbox unavailable ({type(e).__name__}: {e}); skipping",
              flush=True)
    else:
        tb_renderer = rt.Renderer(
            treg, rt.RenderConfig(width=800, height=608),
            overflow_policy="off",
        )
        img, ms = _timed(tb_renderer, testbox_app.build_single(tgltf), 0,
                         frames)
        record("testbox-real-geometry-800x608", img, ms)
        tbf_renderer = rt.Renderer(
            treg, rt.RenderConfig(width=1920, height=1080, msaa_samples=4),
            overflow_policy="off",
        )
        img, ms = _timed(tbf_renderer, testbox_app.build_field(tgltf), 0,
                         max(frames // 2, 3))
        record("testbox-field-276k-1080p-msaa4", img, ms)

    (out / "results.json").write_text(json.dumps(results, indent=2))
    if save_images:
        # deferred readbacks (see _timed docstring)
        for name, img in pending_images:
            write_png(out / f"{name}.png", np.asarray(img))
    return results


if __name__ == "__main__":
    run_all(*(sys.argv[1:2] or ["configs_out"]),
            frames=int(sys.argv[2]) if len(sys.argv) > 2 else 10)
    import os

    os._exit(0)  # a wedged readback thread must not hang process exit
