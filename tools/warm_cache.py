"""Precompile the whole config matrix into the persistent XLA compile cache.

Cold compiles of the frame function take about a minute each on the GPU;
the persistent cache (`.cache/jax` or $JAX_COMPILATION_CACHE_DIR, enabled
by every Renderer — engine/renderer.py _enable_compilation_cache) makes later
processes near-instant, but only for executables that were ACTUALLY
compiled once. This tool walks every BASELINE/apps config plus the bench
configurations through ONE real dispatch each, sequentially, so a fresh
interactive session never eats a cold compile mid-loop.

The reference analog is VkPipelineCache threaded through pipeline
recreation (renderer/src/renderer/pipelines.rs:164-174,30) — there the
cache warms as a side effect of running; here scenes×configs are known up
front, so warming is a batch job.

IMPORTANT (verified, .claude/skills/verify/SKILL.md): `jit.lower().compile()`
produces a DIFFERENT persistent-cache key than calling the jitted function,
so probe-style AOT warming always misses. This tool therefore drives the
PRODUCTION call path: apps.configs.run_all (every matrix entry renders a
frame) plus bench.build_bench for the default (exact-sampler) and --fast
bench configs.
Zero device→host readbacks (save_images=False).

Run: python -m tools.warm_cache [frames]   (default 1; run once after any
     frame-code change, then check: a second run's per-config times show
     first-frame ≈ cache-load instead of minutes)
"""

from __future__ import annotations

import sys
import tempfile
import time


def _warm_bench(fast: bool) -> dict:
    import bench

    name, renderer, make_scene = bench.build_bench(fast=fast)
    t0 = time.perf_counter()
    img = renderer.render_frame_device(make_scene(1.0), debug_mode=0)
    img.block_until_ready()
    dt = time.perf_counter() - t0
    row = {"config": f"bench:{name}", "first_frame_s": round(dt, 2)}
    print(row, flush=True)
    return row


def main(frames: int = 1) -> list[dict]:
    from apps import configs

    t0 = time.perf_counter()
    rows = []
    with tempfile.TemporaryDirectory() as td:
        # run_all's first _timed call per config compiles (or cache-loads)
        # that config's executable — the warming itself; its printed
        # ms_per_frame is the steady-state dispatch time, reported as-is
        rows.extend(configs.run_all(td, frames=frames, save_images=False))
    rows.append(_warm_bench(fast=False))
    rows.append(_warm_bench(fast=True))
    total = time.perf_counter() - t0
    print(f"# warm_cache: {len(rows)} configs in {total:.1f}s — the "
          "persistent cache now holds every matrix executable; a second "
          "run (or any fresh session on these configs) skips all cold "
          "compiles", flush=True)
    return rows


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1)
    import os

    os._exit(0)  # never hang process exit on a handle
