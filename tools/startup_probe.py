"""Startup measurement: one JSON line of end-to-end cold/warm startup
stages for the sandbox app.

Stages: python+jax import, renderer_tpu+apps import, asset load (glTF parse
+ lazy texture headers), atlas open (bundle cache hit or full BC7 decode),
first frame dispatch (XLA compile cache decides warm/cold).

Run (GPU): python -m tools.startup_probe            # warm caches
           RENDERER_TPU_CACHE=/tmp/coldcache python -m tools.startup_probe
                                                    # cold atlas decode
"""

import json
import os
import time

t0 = time.perf_counter()
import jax  # noqa: E402

t_jax = time.perf_counter()

import renderer_tpu as rt  # noqa: E402
from apps import sandbox as sb_mod  # noqa: E402

t_imports = time.perf_counter()

sb = sb_mod.Sandbox()
t_assets = time.perf_counter()

renderer = rt.Renderer(sb.registry, rt.RenderConfig(width=1280, height=720),
                       overflow_policy="off")
renderer._materials()  # atlas open/build + upload
t_atlas = time.perf_counter()

scene = sb.build_scene(0.5)
img = renderer.render_frame_device(scene, debug_mode=0)
img.block_until_ready()
t_first = time.perf_counter()

print(json.dumps({
    "jax_import_s": round(t_jax - t0, 3),
    "renderer_imports_s": round(t_imports - t_jax, 3),
    "asset_load_s": round(t_assets - t_imports, 3),
    "atlas_s": round(t_atlas - t_assets, 3),
    "first_frame_s": round(t_first - t_atlas, 3),
    "total_s": round(t_first - t0, 3),
    "atlas_cache_root": os.environ.get("RENDERER_TPU_CACHE", "<repo>/.cache"),
}), flush=True)
os._exit(0)
