"""Engine-level behavior: resolution changes (swapchain-recreation analog),
MSAA, profiler sections, HUD compositing, stats formatting."""

import numpy as np

import renderer_tpu as rt
from apps.triangle import build_scene, build_triangle_assets
from renderer_tpu.engine.profiling import Profiler
from renderer_tpu.engine.stats import format_bytes


def test_resolution_change_recompiles_cleanly():
    # The reference recreates swapchain/pipelines/framebuffers on resize
    # (main.rs:585-594); here a new config is simply a new static jit key.
    registry, meshes, material = build_triangle_assets()
    scene = build_scene(meshes, material)
    img1 = rt.Renderer(registry, rt.RenderConfig(width=160, height=96)).render_frame(scene, 1)
    img2 = rt.Renderer(registry, rt.RenderConfig(width=320, height=192)).render_frame(scene, 1)
    assert img1.shape == (96, 160, 3)
    assert img2.shape == (192, 320, 3)
    # same scene, double resolution → roughly 4x the covered pixels
    c1 = (img1.sum(-1) > 0).sum()
    c2 = (img2.sum(-1) > 0).sum()
    assert 3.0 < c2 / c1 < 5.0


def test_msaa4_smooths_edges():
    registry, meshes, material = build_triangle_assets()
    scene = build_scene(meshes, material)
    img1 = rt.Renderer(
        registry, rt.RenderConfig(width=160, height=96, msaa_samples=1)
    ).render_frame(scene, 1)
    img4 = rt.Renderer(
        registry, rt.RenderConfig(width=160, height=96, msaa_samples=4)
    ).render_frame(scene, 1)
    # strict interiors (eroded away from silhouettes) match
    cov = (img1.sum(-1) > 0) & (img4.sum(-1) > 0)
    interior = cov.copy()
    for dy in (-2, -1, 0, 1, 2):
        for dx in (-2, -1, 0, 1, 2):
            interior &= np.roll(np.roll(cov, dy, 0), dx, 1)
    assert interior.sum() > 500
    np.testing.assert_allclose(
        img1[interior].astype(int), img4[interior].astype(int), atol=3
    )
    # MSAA produces intermediate edge colors that 1-sample rendering cannot
    uniq1 = len(np.unique(img1.reshape(-1, 3), axis=0))
    uniq4 = len(np.unique(img4.reshape(-1, 3), axis=0))
    assert uniq4 > uniq1


def test_msaa_candidate_overflow_never_brightens():
    """When a pixel references more distinct (triangle | background) values
    across its samples than msaa_shade_candidates, the fallback must only
    ever DARKEN (unmatched covered samples fall back and are counted in
    shade_clamped_px; background samples must resolve to the clear color,
    never to a candidate's color — the over-opaque-silhouette bug)."""
    registry, meshes, material = build_triangle_assets()
    scene = build_scene(meshes, material)
    imgs = {}
    for cands in (1, 4):
        r = rt.Renderer(registry, rt.RenderConfig(
            width=160, height=96, msaa_samples=4, msaa_shade_candidates=cands
        ))
        imgs[cands] = r.render_frame(scene, 1).astype(int)
    # starved candidate set can only lose light vs the exact resolve
    assert (imgs[1] <= imgs[4] + 1).all(), (
        (imgs[1] - imgs[4]).max(), "background samples painted with a "
        "candidate's color",
    )
    # edge pixels exist where both agree and are intermediate (sanity)
    assert (imgs[4].sum(-1) > 0).any()


def test_render_frames_device_matches_single():
    """Device-resident multi-frame scan (one dispatch, K frames) must
    reproduce the per-frame path for every frame in the batch. The scan runs
    as one fused jit while interpret-mode render_frame composes stages
    eagerly; XLA:CPU contracts multiply-add chains differently across fusion
    structures (ULP-level edge-plane differences), so like test_multichip's
    sharded-vs-single check this pins near-total pixel agreement rather than
    bit equality across the two compilation structures."""
    from renderer_tpu.core import math3d

    registry, meshes, material = build_triangle_assets()
    r = rt.Renderer(registry, rt.RenderConfig(width=160, height=96))

    def scene_at(dx):
        s = build_scene(meshes, material)
        s.camera.position = s.camera.position + np.array([dx, 0, 0], np.float32)
        return s

    scenes = [scene_at(0.0), scene_at(0.15), scene_at(-0.15)]
    imgs, stats = r.render_frames_device(scenes, debug_mode=3)
    imgs = np.asarray(imgs)
    assert imgs.shape == (3, 96, 160, 3)
    assert np.asarray(stats).shape[0] == 3
    for k, s in enumerate(scenes):
        single = np.asarray(
            r.render_frame(scene_at([0.0, 0.15, -0.15][k]), debug_mode=3)
        )
        agreement = (imgs[k] == single).all(axis=-1).mean()
        assert agreement > 0.999, f"frame {k}: agreement {agreement}"


def test_profiler_sections_and_format():
    p = Profiler(enabled=True)
    with p.span("load"):
        pass
    p.snapshot("startup")
    with p.span("frame"):
        with p.span("inner"):
            pass
    text = p.format()
    assert "[startup]" in text and "load" in text
    assert "frame" in text and "inner" in text


def test_format_bytes():
    assert format_bytes(512) == "512 B"
    assert format_bytes(2048) == "2.00 KiB"
    assert format_bytes(3 * 1024**3) == "3.00 GiB"


def test_hud_span_tree_sections_and_tinting():
    """The HUD is the reference's span tree (main.rs:769-847): snapshot
    sections under collapsible [-]/[+] headers, live spans as 'latest
    frame', per-span %-of-section-root with green→red tinting, and a
    collapsed section hiding its children."""
    from renderer_tpu.overlay.hud import _pct_color, hud_tree_lines

    p = Profiler(enabled=True)
    with p.span("load assets"):
        pass
    p.snapshot("startup")
    with p.span("frame"):
        with p.span("heavy"):
            pass
        with p.span("light"):
            pass
    lines = hud_tree_lines(p, ["header"])
    texts = [t for t, _c in lines]
    assert texts[0] == "header"
    assert any(t.startswith("[-] startup") for t in texts)
    assert any(t.startswith("[-] latest frame") for t in texts)
    assert any("load assets" in t for t in texts)
    # every span line carries µs + percentage
    span_lines = [t for t in texts if "%" in t]
    assert span_lines and all("(" in t and "us" in t or "ms" in t
                              for t in span_lines)
    # root span of a section ≈ 100% of itself
    frame_line = next(t for t in texts if t.lstrip().startswith("frame:"))
    assert "(100%)" in frame_line

    # collapsing hides children but keeps the header with the [+] marker
    collapsed = hud_tree_lines(p, None, collapsed={"startup"})
    ctexts = [t for t, _c in collapsed]
    assert any(t.startswith("[+] startup") for t in ctexts)
    assert not any("load assets" in t for t in ctexts)

    # tint ramps green → yellow → red with the share of the frame
    g, y, r = _pct_color(5), _pct_color(50), _pct_color(95)
    assert g[1] > g[0]  # green-ish
    assert y[0] > 230 and y[1] > 200  # yellow-ish
    assert r[0] > 230 and r[1] < 130  # red-ish


def test_hud_draws_window():
    from renderer_tpu.overlay.hud import draw_hud

    img = np.zeros((128, 256, 3), np.uint8)
    p = Profiler(enabled=True)
    with p.span("frame"):
        pass
    out = draw_hud(img, p, ["hello"])
    assert out.shape == img.shape
    assert (out != 0).any(), "HUD must draw something"
    # original untouched
    assert (img == 0).all()


def test_profiler_chrome_trace_export(tmp_path):
    """Per-event trace retention + Chrome trace-event JSON export (the
    profile-with-tracing subscriber analog, main.rs:30-36,312-318): events
    carry µs timestamps/durations and child spans nest inside their
    parent's interval."""
    import json
    import time as _time

    p = Profiler(enabled=True, trace_events=100)
    with p.span("frame"):
        with p.span("inner"):
            _time.sleep(0.002)
    path = tmp_path / "trace.json"
    n = p.export_chrome_trace(str(path))
    assert n == 2
    data = json.loads(path.read_text())
    evs = {e["name"]: e for e in data["traceEvents"]}
    assert set(evs) == {"frame", "inner"}
    f, i = evs["frame"], evs["inner"]
    assert i["dur"] >= 2000  # slept 2 ms
    # child nests inside the parent interval
    assert f["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= f["ts"] + f["dur"] + 1.0
    # bounded retention: the deque caps at trace_events
    p2 = Profiler(enabled=True, trace_events=4)
    for k in range(10):
        with p2.span(f"s{k}"):
            pass
    assert p2.export_chrome_trace(str(tmp_path / "t2.json")) == 4


def test_pick_strip_rows_sizing():
    """Strip sizing must not collapse to per-tile-row strips when the
    tile-row count is prime (round-3 advisor: 720p = 23 tile rows made any
    over-budget stack jump from 1 strip to 23): strips are ceil-sized to
    the budget with a remainder strip, so the count tracks
    ceil(elems/budget)."""
    from renderer_tpu.raster import pipeline as pl

    # 720p-like: 736 rows = 23 tile rows of 32 (prime); c=3 candidates
    sh = pl._pick_strip_rows(3, 736, 1280, 32, 1 << 21)
    assert sh % 32 == 0 and sh > 32, sh  # several tile rows per strip
    assert 3 * sh * 1280 <= 1 << 21  # each full strip fits the budget
    assert -(-736 // sh) <= 3  # ~2 strips, not 23
    # whole stack fits -> one call
    assert pl._pick_strip_rows(1, 64, 128, 32, 1 << 21) == 64
    # degenerate budget -> per-tile-row strips (the old worst case)
    assert pl._pick_strip_rows(3, 736, 1280, 32, 1) == 32


def test_shade_strips_bit_equal():
    """Strip-mapped stacked shading (RenderConfig.shade_strip_elems) is
    bit-identical to the unstripped path across all three stacked shade
    call sites — solid candidates, the masked alpha test, and blended
    layers (pipeline._shade_striped). Shading is a pure per-pixel function
    of the candidate map + global row, so forcing per-tile-row strips with
    a tiny element budget must reproduce the unstripped bytes exactly."""
    from dataclasses import replace

    from renderer_tpu.core import math3d
    from tests.test_alpha_modes import quad

    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    back = quad(builder, 2.0, half=2.0)
    masked = quad(builder, 1.5, half=0.5)
    blended = quad(builder, 1.0, half=0.4)
    builder.build()

    m_back = registry.create_material(
        "bg", rt.PbrMaterialParameters(base_color_factor=(0.8, 0.2, 0.1, 1)))
    m_mask = registry.create_material(
        "mask",
        rt.PbrMaterialParameters(base_color_factor=(0.2, 0.9, 0.3, 0.6),
                                 alpha_cutoff=0.5,
                                 alpha_mode=rt.AlphaMode.ALPHA_TO_COVERAGE))
    m_blend = registry.create_material(
        "blend",
        rt.PbrMaterialParameters(base_color_factor=(0.1, 0.4, 0.9, 0.5),
                                 alpha_mode=rt.AlphaMode.BLENDED))

    def make_scene():
        scene = rt.Scene()
        assert scene.queue_mesh(back, m_back, None, math3d.IDENTITY)
        assert scene.queue_mesh(masked, m_mask, None, math3d.IDENTITY)
        assert scene.queue_mesh(blended, m_blend, None, math3d.IDENTITY)
        return scene

    base = rt.RenderConfig(width=128, height=96, tile_h=16, msaa_samples=4,
                           shade_strip_elems=0).validate()
    plain = np.asarray(
        rt.Renderer(registry, base).render_frame(make_scene(), debug_mode=0))
    # budget of 1 element -> every stack splits into per-tile-row strips
    striped_cfg = replace(base, shade_strip_elems=1).validate()
    striped = np.asarray(
        rt.Renderer(registry, striped_cfg).render_frame(make_scene(),
                                                        debug_mode=0))
    assert (plain == striped).all(), (
        f"stripped shading diverged on {(plain != striped).any(-1).sum()} px"
    )


def test_shade_strips_jitted_lax_map_matches():
    """The jitted strip path (tracer stacks -> lax.map over tile-row strips,
    pipeline._shade_striped) must reproduce the unstripped jitted render.
    render_frames_device always runs under jax.jit even in interpret mode,
    so it exercises the lax.map branch the GPU frame uses; stripping only
    changes fusion boundaries, so like the scan-vs-single pin this demands
    near-total pixel agreement (ULP-level XLA:CPU contraction differences
    across fusion structures)."""
    from dataclasses import replace

    registry, meshes, material = build_triangle_assets()
    cfg_p = rt.RenderConfig(width=160, height=96, msaa_samples=4,
                            shade_strip_elems=0).validate()
    cfg_s = replace(cfg_p, shade_strip_elems=1).validate()
    img_p, _ = rt.Renderer(registry, cfg_p).render_frames_device(
        [build_scene(meshes, material)], debug_mode=0)
    img_s, _ = rt.Renderer(registry, cfg_s).render_frames_device(
        [build_scene(meshes, material)], debug_mode=0)
    img_p, img_s = np.asarray(img_p)[0], np.asarray(img_s)[0]
    agreement = (img_p == img_s).all(axis=-1).mean()
    assert agreement > 0.999, f"lax.map strip agreement {agreement}"


def test_geom_cache_lru_bounded():
    """The per-draw-list geometry cache (host stream + device arrays) must
    be LRU-bounded: an app cycling scenes (level loads, visibility churn)
    must not accumulate one device geometry copy per distinct draw list
    forever (round-5 review finding)."""
    from renderer_tpu.scene import draw_stream

    registry, meshes, material = build_triangle_assets()
    r = rt.Renderer(registry, rt.RenderConfig(width=64, height=64))
    cap = rt.Renderer.GEOM_CACHE_MAX

    def geom_for(n):
        from renderer_tpu.core import math3d

        s = rt.Scene()
        for i in range(n):
            s.queue_mesh(meshes[i % len(meshes)], material, None,
                         math3d.IDENTITY)
        fv = draw_stream.frame_view(s)
        return fv.geom_key, r._geometry(s, fv.order, fv.geom_key)

    keys = []
    for n in range(1, cap + 4):  # distinct draw lists beyond the bound
        k, _ = geom_for(n)
        keys.append(k)
    assert len(set(keys)) == cap + 3  # all distinct
    assert len(r._geom_cache) == cap  # bounded
    # most-recent keys survive, oldest evicted
    assert keys[-1] in r._geom_cache and keys[0] not in r._geom_cache
    # LRU: touching the oldest RESIDENT entry protects it from the next
    # eviction (the next insert evicts the second-oldest instead)
    oldest_resident = next(iter(r._geom_cache))
    touched_n = keys.index(oldest_resident) + 1  # geom_for(n) made keys[n-1]
    second_oldest = list(r._geom_cache)[1]
    geom_for(touched_n)  # cache hit → moves to most-recent
    geom_for(cap + 5)  # new key → evicts the (un-touched) oldest
    assert oldest_resident in r._geom_cache
    assert second_oldest not in r._geom_cache
    assert len(r._geom_cache) == cap
