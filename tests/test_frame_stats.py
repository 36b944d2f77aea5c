"""Frame-stats plumbing: loud bin overflow with automatic capacity regrow,
and layered-capture saturation counters (the analog of the reference's
loud arena-OOM accounting, arena/buffers.rs:126-163 — resource exhaustion
must never silently drop work)."""

import numpy as np

import renderer_tpu as rt
from renderer_tpu.core import math3d
from tests import np_reference
from tests.test_alpha_modes import quad

W, H = 128, 96


def expected_u8(rgb):
    return np_reference.aces_srgb_u8(np.asarray(rgb, np.float64))


def _blended_assets():
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    mesh = quad(builder, 1.5, half=0.4)
    bg = quad(builder, 2.2)
    builder.build()
    red = registry.create_material(
        "red", rt.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1))
    )
    layers = [
        registry.create_material(
            f"l{i}",
            rt.PbrMaterialParameters(
                base_color_factor=c, alpha_mode=rt.AlphaMode.BLENDED
            ),
        )
        for i, c in enumerate(
            [(0, 1, 0, 0.5), (0, 0, 1, 0.5), (1, 1, 1, 0.5)]
        )
    ]
    scene = rt.Scene()
    scene.queue_mesh(bg, red, None, math3d.IDENTITY)
    # three stacked blended quads, queued far → near (each accepted fragment
    # is nearer than the previous, so the ordered-accept chain takes them all)
    for i, mat in enumerate(layers):
        dz = np.array([0, 0, 0.3 * (2 - i)], np.float32)
        scene.queue_mesh(mesh, mat, None, math3d.trs(translation=dz))
    return registry, scene, (red, layers)


class TestBlendedSaturation:
    def test_over_capacity_underblends_and_counts(self):
        registry, scene, _keep = _blended_assets()
        r = rt.Renderer(
            registry, rt.RenderConfig(width=W, height=H, blend_layers=2)
        )
        img = r.render_frame(scene, debug_mode=1)
        stats = r.frame_stats()
        assert stats["blended_saturated_px"] > 0, stats
        assert stats["overflow_opaque"] == 0
        # only the first 2 accepted layers composite; the 3rd is dropped
        # (under-blend, never mis-occlusion)
        center = img[H // 2, W // 2]
        np.testing.assert_allclose(
            center, expected_u8([0.25, 0.25, 0.5]), atol=2, err_msg=f"{center}"
        )

    def test_enough_layers_composites_all(self):
        registry, scene, _keep = _blended_assets()
        r = rt.Renderer(
            registry, rt.RenderConfig(width=W, height=H, blend_layers=4)
        )
        img = r.render_frame(scene, debug_mode=1)
        stats = r.frame_stats()
        assert stats["blended_saturated_px"] == 0, stats
        center = img[H // 2, W // 2]
        np.testing.assert_allclose(
            center, expected_u8([0.625, 0.625, 0.75]), atol=2,
            err_msg=f"{center}",
        )


class TestMaskedSaturation:
    def test_stacked_masked_counts_when_truncated(self):
        registry = rt.MaterialRegistry()
        builder = rt.VertexLibraryBuilder()
        mesh = quad(builder, 1.5, half=0.4)
        builder.build()
        mats = [
            registry.create_material(
                f"m{i}",
                rt.PbrMaterialParameters(
                    base_color_factor=(i / 2.0, 1, 0, 1.0), alpha_cutoff=0.5,
                    alpha_mode=rt.AlphaMode.ALPHA_TO_COVERAGE,
                ),
            )
            for i in range(2)
        ]
        scene = rt.Scene()
        for i, mat in enumerate(mats):
            dz = np.array([0, 0, 0.3 * i], np.float32)
            scene.queue_mesh(mesh, mat, None, math3d.trs(translation=dz))
        r1 = rt.Renderer(
            registry, rt.RenderConfig(width=W, height=H, mask_layers=1)
        )
        img = r1.render_frame(scene, debug_mode=1)
        assert r1.frame_stats()["masked_saturated_px"] > 0
        # the kept layer is the NEAREST candidate — truncation never changes
        # which fragment wins, only whether fallbacks exist
        center = img[H // 2, W // 2]
        np.testing.assert_allclose(center, expected_u8([0, 1, 0]), atol=2)

        r4 = rt.Renderer(
            registry, rt.RenderConfig(width=W, height=H, mask_layers=4)
        )
        r4.render_frame(scene, debug_mode=1)
        assert r4.frame_stats()["masked_saturated_px"] == 0


def _many_quads_scene(n=32):
    """n full-screen-ish opaque quads → n·2 triangles, each touching every
    tile: plenty of (tile, triangle) pairs to overflow a tiny capacity."""
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    meshes = [quad(builder, 1.2 + 0.02 * i, half=0.9) for i in range(n)]
    builder.build()
    mat = registry.create_material(
        "gray", rt.PbrMaterialParameters(base_color_factor=(0.5, 0.5, 0.5, 1))
    )
    scene = rt.Scene()
    for m in meshes:
        scene.queue_mesh(m, mat, None, math3d.IDENTITY)
    return registry, scene, mat


class TestTotalPairsAndShrink:
    CFG = dict(width=128, height=64, tile_h=16)

    def test_total_pairs_matches_binning(self):
        import jax

        from renderer_tpu.raster import binning, setup, vertex_stage
        from renderer_tpu.scene import draw_stream

        registry, scene, _mat = _many_quads_scene(n=4)
        cfg = rt.RenderConfig(**self.CFG)
        r = rt.Renderer(registry, cfg)
        r.render_frame(scene, debug_mode=1)
        stats = r.frame_stats()
        # oracle: bin the same setup directly and count pairs + overflow
        fv = draw_stream.frame_view(scene)
        gs, geom = r._geometry(scene, fv.order, fv.geom_key)
        frame = draw_stream.unpack_frame(r._frame_arrays(scene, fv, gs),
                                         joint_cap=r._joint_cap(scene))
        vs = vertex_stage.run_vertex_stage(geom, frame, skin_start=gs.skin_start)
        td = setup.triangle_setup(vs["clip"], geom["tri_v"], frame["num_tris"],
                                  cfg.width, cfg.height)
        _, _, counts, _ov, _rov, pair_dem, row_dem = \
            binning.bin_triangle_classes(
                td, (0, frame["num_tris"]),
                tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_w, tile_h=cfg.tile_h,
                pair_capacity=cfg.pair_capacity,
                row_capacity=cfg.row_capacity,
            )
        expect = int(np.asarray(pair_dem))
        assert stats["total_pairs"] == expect > 0, stats
        # the kept pairs can only be ≤ the expansion demand (the tight
        # reject prunes, never adds), and the row stat mirrors stage 1
        assert int(np.asarray(counts).sum()) <= expect
        assert stats["total_rows"] == int(np.asarray(row_dem)) > 0
        assert stats["row_overflow"] == 0

    def test_sync_policy_regrows_row_capacity(self):
        """End-to-end row-axis feedback: a row_capacity too small for the
        scene's (triangle, tile-row) expansion must regrow under "sync"
        until the frame reports no dropped work, and the converged image
        must equal an ample-capacity render exactly."""
        registry, scene, _mat = _many_quads_scene(n=32)
        small = rt.Renderer(
            registry, rt.RenderConfig(row_capacity=16, **self.CFG),
            overflow_policy="sync",
        )
        img = small.render_frame(scene, debug_mode=1)
        stats = small.frame_stats()
        assert stats["row_overflow"] == 0 and stats["overflow_opaque"] == 0
        assert small.config.row_capacity > 16
        ample = rt.Renderer(registry, rt.RenderConfig(**self.CFG))
        np.testing.assert_array_equal(
            img, ample.render_frame(scene, debug_mode=1)
        )

    def test_auto_policy_shrinks_oversized_bucket(self):
        registry, scene, _mat = _many_quads_scene(n=2)
        r = rt.Renderer(
            registry,
            rt.RenderConfig(pair_capacity=1 << 18, **self.CFG),
            overflow_policy="auto", shrink_after=2,
        )
        imgs = [r.render_frame(scene, debug_mode=1) for _ in range(4)]
        assert r.config.pair_capacity < (1 << 18), r.config.pair_capacity
        assert r.frame_stats()["overflow_opaque"] == 0
        # identical image before and after the shrink recompile
        np.testing.assert_array_equal(imgs[0], imgs[-1])

    def test_stable_bucket_not_shrunk(self):
        registry, scene, _mat = _many_quads_scene(n=32)
        cfg = rt.RenderConfig(pair_capacity=1 << 13, **self.CFG)
        r = rt.Renderer(registry, cfg, overflow_policy="auto", shrink_after=1)
        for _ in range(3):
            r.render_frame(scene, debug_mode=1)
        # 32 full-screen quads need more than 4096 pairs: no shrink below a
        # fitting bucket even with an aggressive shrink_after
        assert r.config.pair_capacity * 2 >= r.frame_stats()["total_pairs"]


class TestShrinkUsesStreakPeak:
    CFG = dict(width=128, height=64, tile_h=16)

    def test_oscillating_scene_never_shrinks_below_peak(self):
        """A scene alternating light/heavy within the shrink window must
        size the shrunk bucket from the streak's PEAK total_pairs — sizing
        from the last (light) frame would drop the next heavy frame's work
        (advisor finding, round 2)."""
        registry, heavy_scene, _m = _many_quads_scene(n=32)
        light = rt.Scene()  # empty: near-zero pairs
        r = rt.Renderer(
            registry,
            rt.RenderConfig(pair_capacity=1 << 18, **self.CFG),
            overflow_policy="auto", shrink_after=4,
        )
        peak = 0
        for i in range(8):
            scene = heavy_scene if i % 2 == 0 else light
            r.render_frame(scene, debug_mode=1)
            peak = max(peak, r.frame_stats()["total_pairs"])
        # shrink has happened (bucket was 8x oversized even for the peak)…
        assert r.config.pair_capacity < (1 << 18)
        # …but never below 2x the heaviest frame in any streak
        assert r.config.pair_capacity >= peak, (r.config.pair_capacity, peak)
        # and heavy frames still render complete at the shrunk capacity
        r.render_frame(heavy_scene, debug_mode=1)
        assert r.frame_stats()["overflow_opaque"] == 0


class TestBatchOverflowPolicy:
    CFG = dict(width=128, height=64, tile_h=16)

    def _scenes(self):
        """Two-scene batch sharing one draw list: frame 0 sees the quads
        (many pairs), frame 1 looks away (near-zero pairs) — overflow mid-
        batch must not hide behind the clean final frame."""
        from renderer_tpu.core import math3d as m3
        from tests.test_alpha_modes import quad

        registry = rt.MaterialRegistry()
        builder = rt.VertexLibraryBuilder()
        meshes = [quad(builder, 1.2 + 0.02 * i, half=0.9) for i in range(32)]
        builder.build()
        mat = registry.create_material(
            "gray", rt.PbrMaterialParameters(base_color_factor=(0.5, 0.5, 0.5, 1))
        )
        self._keep = (registry, meshes, mat)

        def make():
            s = rt.Scene()
            for m in meshes:
                s.queue_mesh(m, mat, None, math3d.IDENTITY)
            return s

        scene, away = make(), make()
        away.camera.orientation = m3.quat_from_axis_angle([0, 1, 0], np.pi)
        return registry, [scene, away]

    def test_sync_policy_rerenders_whole_batch(self):
        registry, scenes = self._scenes()
        r = rt.Renderer(
            registry, rt.RenderConfig(pair_capacity=32, **self.CFG),
            overflow_policy="sync",
        )
        imgs, stats = r.render_frames_device(scenes, debug_mode=1)
        assert r.config.pair_capacity > 32
        host = np.asarray(stats)
        assert host[:, :4].sum() == 0, host  # every frame complete
        ample = rt.Renderer(registry, rt.RenderConfig(**self.CFG))
        ref, _ = ample.render_frames_device(scenes, debug_mode=1)
        np.testing.assert_array_equal(np.asarray(imgs), np.asarray(ref))

    def test_auto_policy_grows_for_next_batch(self):
        registry, scenes = self._scenes()
        r = rt.Renderer(
            registry, rt.RenderConfig(pair_capacity=32, **self.CFG),
            overflow_policy="auto",
        )
        _imgs, stats = r.render_frames_device(scenes, debug_mode=1)
        # frame 0 overflowed (and the check saw it despite frame 1 being
        # clean); the NEXT batch runs at grown capacity
        assert np.asarray(stats)[0, :4].sum() > 0
        assert r.config.pair_capacity > 32
        _imgs2, stats2 = r.render_frames_device(scenes, debug_mode=1)
        assert np.asarray(stats2)[:, :4].sum() == 0


class TestBinOverflow:
    CFG = dict(width=128, height=64, tile_h=16)

    def test_sync_policy_regrows_until_complete(self):
        registry, scene, _mat = _many_quads_scene()
        r = rt.Renderer(
            registry,
            rt.RenderConfig(pair_capacity=32, **self.CFG),
            overflow_policy="sync",
        )
        img = r.render_frame(scene, debug_mode=1)
        assert r.config.pair_capacity > 32
        assert r.frame_stats()["overflow_opaque"] == 0

        ample = rt.Renderer(registry, rt.RenderConfig(**self.CFG))
        ref = ample.render_frame(scene, debug_mode=1)
        assert ample.frame_stats()["overflow_opaque"] == 0
        np.testing.assert_array_equal(img, ref)

    def test_auto_policy_detects_on_next_frame(self):
        registry, scene, _mat = _many_quads_scene()
        r = rt.Renderer(
            registry,
            rt.RenderConfig(pair_capacity=32, **self.CFG),
            overflow_policy="auto",
        )
        r.render_frame(scene, debug_mode=1)  # overflows (reported in stats)
        assert r.frame_stats()["overflow_opaque"] > 0
        r.render_frame(scene, debug_mode=1)  # detects frame 1's overflow, grows
        assert r.config.pair_capacity > 32
        img3 = r.render_frame(scene, debug_mode=1)  # rendered at grown capacity
        assert r.frame_stats()["overflow_opaque"] == 0

        ample = rt.Renderer(registry, rt.RenderConfig(**self.CFG))
        np.testing.assert_array_equal(img3, ample.render_frame(scene, 1))


class TestBatchGrowNoDoubleGrow:
    CFG = dict(width=128, height=64, tile_h=16)

    def test_auto_batch_grow_skips_next_frame_check(self):
        """A batch whose LAST frame overflowed grows once under 'auto'; the
        stored stats row still reports the OLD capacity's overflow, so the
        next render_frame_device's one-frame-delayed check must SKIP it —
        growing again from the same event would double the bucket (and the
        per-frame sort cost) for one overflow (round-5 review finding)."""
        from tests.test_alpha_modes import quad
        from renderer_tpu.core import math3d

        registry = rt.MaterialRegistry()
        builder = rt.VertexLibraryBuilder()
        meshes = [quad(builder, 1.2 + 0.02 * i, half=0.9) for i in range(32)]
        builder.build()
        mat = registry.create_material(
            "gray",
            rt.PbrMaterialParameters(base_color_factor=(0.5, 0.5, 0.5, 1)),
        )

        def make():
            s = rt.Scene()
            for m in meshes:
                s.queue_mesh(m, mat, None, math3d.IDENTITY)
            return s

        scenes = [make(), make()]  # both heavy: the LAST row overflows
        r = rt.Renderer(
            registry, rt.RenderConfig(pair_capacity=32, **self.CFG),
            overflow_policy="auto",
        )
        _imgs, stats = r.render_frames_device(scenes, debug_mode=1)
        assert np.asarray(stats)[-1, :4].sum() > 0  # last row overflowed
        grown = r.config.pair_capacity
        assert grown > 32
        # the very next interactive frame must not re-grow from the stale row
        r.render_frame_device(scenes[0], debug_mode=1)
        assert r.config.pair_capacity == grown
        # and the frame after (checking the GROWN frame's clean stats) holds
        r.render_frame_device(scenes[0], debug_mode=1)
        assert r.config.pair_capacity == grown
