"""Host-prologue breakdown: the per-frame CPU cost of the bench loop
BEFORE the device dispatch (scene rebuild + animation + sort/merge/pack),
the analog of the reference's ~120 µs CPU frame cost (README.md:85-87:
~20 µs queue + ~100 µs Vulkan submission).

Pure host work — forces the CPU platform and never dispatches, so it can
run without the device (and without disturbing any device timing).

Run: python -m tools.prologue_probe [reps]
"""

import json
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def median_us(fn, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e6)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    from apps import sandbox
    from renderer_tpu.core import math3d
    from renderer_tpu.scene import draw_stream

    sb, renderer, _name = sandbox.build_bench(for_bench=True)

    pooled = [None]

    def make_scene(game_time):
        scene = pooled[0] = sb.build_scene(game_time, scene=pooled[0])
        pos, orient = sandbox.orbit_camera(0.25 * game_time)
        scene.camera.position = pos
        scene.camera.orientation = orient
        return scene

    # warm every cache (compiled animations, walk arrays, draw blocks)
    scene = make_scene(1.0)
    fv = draw_stream.frame_view(scene)
    gs, _dev = renderer._geometry(scene, fv.order, fv.geom_key)
    meta = (gs.num_tris, gs.num_opaque_tris, gs.num_masked_tris, 0)
    pv = renderer._proj_view(scene)

    t = {"build_scene_us": median_us(lambda: make_scene(1.01), reps)}
    scene = make_scene(1.0)
    t["frame_view_us"] = median_us(
        lambda: draw_stream.frame_view(scene), reps
    )
    fv = draw_stream.frame_view(scene)
    jc = renderer._joint_cap(scene)
    t["pack_blob_us"] = median_us(
        lambda: draw_stream.pack_frame_blob(fv, scene.joint_palette, pv, meta,
                                            joint_cap=jc),
        reps,
    )
    t["camera_us"] = median_us(lambda: renderer._proj_view(scene), reps)

    def full():
        s = make_scene(1.02)
        f = draw_stream.frame_view(s)
        draw_stream.pack_frame_blob(
            f, s.joint_palette, renderer._proj_view(s), meta, joint_cap=jc
        )

    t["full_prologue_us"] = median_us(full, reps)
    t["draws"] = scene.draw_count
    print(json.dumps({k: round(v, 1) if isinstance(v, float) else v
                      for k, v in t.items()}), flush=True)


if __name__ == "__main__":
    main()
