"""Print the per-stage device timing table.

Runs renderer_tpu.engine.stats.device_stage_timings on the bench scene at
the bench config. Host clock around block_until_ready; no device→host
copies.

Usage: python -m tools.timings_report [msaa] [pair_capacity]
(defaults match the shipped bench config: msaa4, pair_capacity 1<<20)
"""
import sys
import time

from apps import sandbox as sb_mod
from renderer_tpu.engine import stats


def main():
    msaa = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    pair_cap = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 20
    with_bf16 = "bf16" in sys.argv[3:]
    import renderer_tpu as rt

    sb = sb_mod.Sandbox(with_smol_ame=True)
    config = rt.RenderConfig(width=1920, height=1080, msaa_samples=msaa,
                             pair_capacity=pair_cap).validate()
    renderer = rt.Renderer(sb.registry, config, overflow_policy="off")
    scene = sb.build_scene(1.0)
    t0 = time.time()
    timings = stats.device_stage_timings(renderer, scene, iters=20)
    if with_bf16:
        # the bf16 shading lever: time ONLY the fused frame at bf16 (one
        # extra compile), same scene/config otherwise
        from dataclasses import replace

        r16 = rt.Renderer(
            sb.registry, replace(config, bf16_shading=True).validate(),
            overflow_policy="off",
        )
        timings[f"FULL FRAME (fused, msaa{msaa}, bf16 shading)"] = (
            stats.fused_frame_ms(r16, scene, iters=20)
        )
    total = sum(v for k, v in timings.items() if not k.startswith("FULL"))
    print(f"# measured in {time.time()-t0:.0f}s wall", flush=True)
    print("| stage | µs |")
    print("|---|---|")
    for k, v in timings.items():
        print(f"| {k} | {v*1e3:.0f} |")
    print(f"| sum (staged; the fused frame overlaps these) | {total*1e3:.0f} |")


if __name__ == "__main__":
    main()
