"""Smoke test of the renderer on one CUDA GPU, through the entry points a
user calls (`Renderer.render_frame`, `Renderer.render_frames_device`).

Phases (all run by default; `--phases a,b` picks some):
  a  device line: JAX platform, device kind and count, and the card's name
     and power limit from nvidia-smi. Fails unless the platform is gpu.
  b  each Triton raster kernel on the binned inputs of phase d's frame at
     1920x1080 4xMSAA, against its plain jnp reference on the card (must be
     bit-equal), with fenced times of both; the frame step's
     compiled.memory_analysis() and cold-compile seconds; the frame must
     run compiled (no interpreter) and contain the Triton kernels.
  c  the four mini-sandbox goldens (tests/golden/sandbox-golden.npz) at the
     test's tolerance, and tests/test_watertight.py, on the card.
  d  the main path at full width: a Sponza-scale scene built from a seed
     (assets/synthetic.py) at 1920x1080 4xMSAA with the default config and
     overflow policy: ~10 moving frames with the HUD through render_frame,
     then one 8-frame render_frames_device scan compared with render_frame
     at the same times. Zero overflow; fenced per-frame median and p90;
     peak_bytes_in_use.
  e  parallel/mesh.render_frame_sharded on a one-device mesh against the
     single-device image.
  f  the tests marked `gpu`, in this process.

Only when every phase passes is the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Run from the repository root: python chip_smoke.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

W, H, MSAA = 1920, 1080, 4
SEED = 0


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    """Name and power limit of the card, read by a child that stays off
    JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def fenced_ms(fn, reps: int = 5) -> float:
    """Median wall time of fn() with its result fenced."""
    import jax
    import numpy as np

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_b(ctx) -> None:
    import jax
    import numpy as np

    from renderer_tpu.engine import stats as estats

    renderer, scene = ctx["renderer"], ctx["scene"](0.0)
    check(renderer._interpret is False, "Renderer runs kernels interpreted")
    for name, kern, ref, args, kw in estats.kernel_inputs(renderer, scene):
        t0 = time.perf_counter()
        compiled = jax.jit(lambda *a, kern=kern, kw=kw: kern(
            *a, interpret=renderer._interpret, **kw)).lower(*args).compile()
        compile_s = time.perf_counter() - t0
        got = jax.block_until_ready(compiled(*args))
        want = jax.block_until_ready(ref(*args, **kw))
        bad = [int(np.sum(np.asarray(g) != np.asarray(w)))
               for g, w in zip(got, want)]
        counts = np.asarray(args[2])
        print(f"[b] kernel {name}: mismatches per output {bad} "
              f"(bins: {int(counts.sum())} pairs, max {int(counts.max())}"
              f"/tile); compile {compile_s:.2f} s", flush=True)
        k_ms = fenced_ms(lambda: compiled(*args))
        r_ms = fenced_ms(lambda: ref(*args, **kw))
        print(f"[b] kernel {name}: triton {k_ms:.3f} ms, plain XLA "
              f"{r_ms:.3f} ms (median of 5, fenced; {ctx['card']})",
              flush=True)
        check(sum(bad) == 0, f"kernel {name} differs from its reference")

    # the frame step, compiled cold: memory analysis + Triton kernels inside
    from renderer_tpu.scene import draw_stream

    fv = draw_stream.frame_view(scene)
    gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
    frame = renderer._frame_arrays(scene, fv, gs)
    mats = renderer._materials()
    t0 = time.perf_counter()
    lowered = renderer._frame_fn.lower(
        geom, frame, mats, config=renderer.config, skin_start=gs.skin_start,
        has_masked=gs.num_masked_tris > 0,
        has_blended=gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris,
        morph_k=gs.morph_k, joint_cap=renderer._joint_cap(scene))
    text = lowered.as_text()
    compiled = lowered.compile()
    cache = jax.config.jax_compilation_cache_dir
    print(f"[b] frame step compile {time.perf_counter() - t0:.2f} s "
          f"(first in this process; persistent cache: {cache or 'off'})",
          flush=True)
    print(f"[b] frame step memory_analysis: {compiled.memory_analysis()}",
          flush=True)
    n_triton = text.count("__gpu$xla.gpu.triton")
    print(f"[b] frame module: {n_triton} Triton kernel calls", flush=True)
    check(n_triton >= 3, "frame module lacks the compiled Triton kernels")


def phase_c(ctx) -> None:
    import numpy as np
    import pytest

    from tests import test_sandbox_golden as sg

    golden = np.load(sg.GOLDEN)
    for key, kw in (("mini-sandbox-msaa4", {}),
                    ("mini-sandbox-exact", {"msaa": 1}),
                    ("mini-sandbox-fast-msaa4", {"fast": True, "msaa": 4}),
                    ("mini-sandbox-perfwin", {"perf_window": True})):
        img, stats = sg._render(**kw)
        overflow = sum(v for k, v in stats.items() if "overflow" in k)
        diff = np.abs(img.astype(int) - golden[key].astype(int)).max(axis=-1)
        bad = float((diff > 2).mean())
        print(f"[c] golden {key}: {bad:.4%} of pixels off by > 2 levels "
              f"(max {int(diff.max())}), overflow {overflow}", flush=True)
        check(overflow == 0 and bad < 0.005, f"golden {key} drifted")
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                      "tests/test_watertight.py"])
    print(f"[c] tests/test_watertight.py on the card: exit {int(rc)}",
          flush=True)
    check(int(rc) == 0, "watertight tests failed on the card")


def phase_d(ctx) -> None:
    import jax
    import numpy as np

    from renderer_tpu.engine.profiling import Profiler
    from renderer_tpu.overlay.hud import build_hud_drawlist

    renderer, scene_at = ctx["renderer"], ctx["scene"]
    prof = Profiler(enabled=True)
    hud = build_hud_drawlist(renderer.registry, prof, ["chip smoke"],
                             max_width=W)
    times, compiles = [], []
    n_warm, n_timed = 3, 10
    for i in range(n_warm + n_timed):
        t = 0.1 * i
        t0 = time.perf_counter()
        img = renderer.render_frame(scene_at(t), ui=hud)
        dt = (time.perf_counter() - t0) * 1e3
        (compiles if i < n_warm else times).append(dt)
        check(img.shape == (H, W, 3), f"frame shape {img.shape}")
    stats = renderer.frame_stats()
    overflow = sum(v for k, v in stats.items() if "overflow" in k)
    print(f"[d] final stats: {stats}", flush=True)
    print(f"[d] warm-up frames (compiles, capacity growth): "
          f"{[round(c, 1) for c in compiles]} ms", flush=True)
    print(f"[d] render_frame {W}x{H} {MSAA}xMSAA + HUD: median "
          f"{np.median(times):.3f} ms, p90 {np.percentile(times, 90):.3f} ms "
          f"over {len(times)} fenced frames ({ctx['card']})", flush=True)
    check(overflow == 0, f"overflow {overflow}")

    ts = [1.0 + 0.1 * k for k in range(8)]
    t0 = time.perf_counter()
    imgs, scan_stats = renderer.render_frames_device([scene_at(t) for t in ts])
    imgs = np.asarray(jax.block_until_ready(imgs))
    print(f"[d] render_frames_device 8 frames: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms incl. compile",
          flush=True)
    check(int(np.asarray(scan_stats)[:, :4].sum()) == 0, "scan overflow")
    for k in (0, 7):
        single = renderer.render_frame(scene_at(ts[k]))
        agree = float((imgs[k] == single).all(axis=-1).mean())
        print(f"[d] scan frame {k} vs render_frame: {agree:.6f} of pixels "
              "equal", flush=True)
        check(agree > 0.999, f"scan frame {k} differs from render_frame")
    ctx["t_last"] = ts[7]
    mem = jax.devices()[0].memory_stats() or {}
    print(f"[d] peak_bytes_in_use {mem.get('peak_bytes_in_use')} "
          f"({ctx['card']})", flush=True)


def phase_e(ctx) -> None:
    import numpy as np

    from renderer_tpu.parallel import mesh as pmesh
    from renderer_tpu.scene import draw_stream

    renderer = ctx["renderer"]
    scene = ctx["scene"](ctx.get("t_last", 0.0))
    # the config this frame is dispatched with ("auto" may grow it after)
    config = renderer.config
    single = renderer.render_frame(scene)
    fv = draw_stream.frame_view(scene)
    gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
    frame = renderer._frame_arrays(scene, fv, gs)
    mats = renderer._materials()
    jc = renderer._joint_cap(scene)
    sharded, _ = pmesh.jit_sharded_frame(
        config, pmesh.make_mesh(1), interpret=renderer._interpret,
        morph_k=gs.morph_k, joint_cap=jc)(geom, frame, mats)
    sharded = np.asarray(sharded)
    check(sharded.shape == single.shape, f"sharded shape {sharded.shape}")
    equal = float((sharded == single).all(axis=-1).mean())
    diff = np.abs(sharded.astype(int) - single.astype(int)).max(axis=-1)
    print(f"[e] one-device mesh vs single device: {equal:.6f} of pixels "
          f"equal, max difference {int(diff.max())} levels", flush=True)
    # the repo's sharded-vs-single criterion (tests/test_multichip.py)
    check(equal > 0.999, "sharded frame differs from the single-device frame")


def phase_f(ctx) -> None:
    from pathlib import Path

    import pytest

    # collect only the files that hold card tests
    files = sorted(str(p) for p in Path("tests").glob("test_*.py")
                   if "pytest.mark.gpu" in p.read_text())
    check(bool(files), "no tests marked gpu found")
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                      "-m", "gpu", *files])
    print(f"[f] tests marked gpu in {files}: exit {int(rc)}", flush=True)
    check(int(rc) == 0, "gpu-marked tests failed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="abcdef")
    args = ap.parse_args(argv)
    phases = args.phases.replace(",", "")

    import jax

    devices = jax.devices()
    dev = devices[0]
    card = card_line()
    print(f"[a] platform {dev.platform}, device_kind {dev.device_kind}, "
          f"count {len(devices)}", flush=True)
    print(f"[a] card: {card}", flush=True)
    if dev.platform != "gpu":
        print("[a] FAIL: no GPU accelerator", flush=True)
        return 1

    import renderer_tpu as rt
    from renderer_tpu.assets.synthetic import SponzaScale

    t0 = time.perf_counter()
    world = SponzaScale(seed=SEED)
    renderer = rt.Renderer(world.registry, rt.RenderConfig(
        width=W, height=H, msaa_samples=MSAA))
    print(f"[a] scene: {len(world.draws)} draws + skinned character, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    ctx = {"renderer": renderer, "scene": world.scene, "card": card}
    for p in phases:
        if p == "a":
            continue
        fn = {"b": phase_b, "c": phase_c, "d": phase_d, "e": phase_e,
              "f": phase_f}[p]
        t0 = time.perf_counter()
        try:
            fn(ctx)
        except Exception as e:  # noqa: BLE001 — any phase failure fails
            import traceback

            traceback.print_exc()
            print(f"[{p}] FAIL: {type(e).__name__}: {e}", flush=True)
            return 1
        print(f"[{p}] ok in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
