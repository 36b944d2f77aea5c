"""Time the raster kernel routes on the GPU: each Triton kernel against its
plain jnp/lax reference, pixel-block sizes, and binning-tile shapes end to
end, on the Sponza-scale frame (assets/synthetic.py) at 1920x1080 4xMSAA.

Every time is a host-clock median of fenced calls (block_until_ready). One
process holds the card; results also go to chiprun_out/kernel_routes.json.
Run on the card: python -m tools.kernel_routes [--tiles 32x128,16x64]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

W, H, MSAA = 1920, 1080, 4


def fenced(fn, reps: int) -> list[float]:
    import jax

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", default="32x128,16x64,16x32")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--blocks", default="4x32,8x32,16x32,32x32")
    args = ap.parse_args(argv)

    import jax

    import renderer_tpu as rt
    from chip_smoke import card_line
    from renderer_tpu.assets.synthetic import SponzaScale
    from renderer_tpu.core import backend
    from renderer_tpu.engine import stats as estats

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU, found {dev.platform}")
        return 1
    card = card_line()
    print(f"device {dev.device_kind}; card {card}", flush=True)
    world = SponzaScale(seed=0)
    results = {"card": card, "device_kind": dev.device_kind, "tiles": {},
               "kernels": {}, "blocks": {}}

    interp = backend.interpret_mode()
    for spec in args.tiles.split(","):
        th, tw = (int(v) for v in spec.split("x"))
        # start from the layer counts the default "auto" policy converges to
        # on this scene (one compile per tile shape instead of two)
        renderer = rt.Renderer(world.registry, rt.RenderConfig(
            width=W, height=H, msaa_samples=MSAA, tile_h=th, tile_w=tw,
            mask_layers=8, blend_layers=8, msaa_shade_candidates=4))
        for i in range(4):  # compile + capacity growth
            jax.block_until_ready(renderer.render_frame_device(
                world.scene(0.1 * i)))
        scenes = [world.scene(1.0 + 0.1 * i) for i in range(args.frames)]
        it = iter(scenes)
        times = fenced(lambda: renderer.render_frame_device(next(it)),
                       args.frames)
        stats = renderer.frame_stats()
        row = {"median_ms": float(np.median(times)),
               "p90_ms": float(np.percentile(times, 90)),
               "n": len(times), "total_pairs": stats["total_pairs"],
               "overflow": sum(v for k, v in stats.items()
                               if "overflow" in k)}
        # kernel times at this tile shape (Triton only, default blocks)
        kin = estats.kernel_inputs(renderer, world.scene(1.0))
        for name, kern, ref, kargs, kw in kin:
            f = jax.jit(lambda *a, kern=kern, kw=kw: kern(
                *a, interpret=interp, **kw))
            jax.block_until_ready(f(*kargs))
            row[f"{name}_ms"] = float(np.median(fenced(lambda: f(*kargs), 7)))
        results["tiles"][spec] = row
        print(f"tile {spec}: {row}", flush=True)
        if spec == args.tiles.split(",")[0]:
            for name, kern, ref, kargs, kw in kin:
                r = jax.jit(lambda *a, ref=ref, kw=kw: ref(*a, **kw))
                jax.block_until_ready(r(*kargs))
                results["kernels"][name] = {
                    "triton_ms": row[f"{name}_ms"],
                    "xla_ms": float(np.median(fenced(lambda: r(*kargs), 5)))}
                print(f"kernel {name}: {results['kernels'][name]}",
                      flush=True)
                for b in args.blocks.split(","):
                    bh, bw = (int(v) for v in b.split("x"))
                    if th % bh or tw % bw:
                        continue
                    f = jax.jit(lambda *a, kern=kern, kw=kw, blk=(bh, bw):
                                kern(*a, block=blk, interpret=interp, **kw))
                    jax.block_until_ready(f(*kargs))
                    ms = float(np.median(fenced(lambda: f(*kargs), 7)))
                    results["blocks"][f"{name} {b}"] = ms
                    print(f"block {name} {b}: {ms:.3f} ms", flush=True)
        del renderer
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "kernel_routes.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
