"""UI overlay rendered THROUGH the raster pipeline (ImGui-path parity):
clip-rect discard, painter's-order src-alpha compositing into the HDR buffer
before tonemap, font-alpha texture kind, per-frame stats. Reference:
imgui_support.rs:107-169 + imgui.vert/frag + pipeline_parameters.rs IMGUI."""

import numpy as np

import renderer_tpu as rt
from renderer_tpu.core import math3d
from renderer_tpu.ui import DrawList, get_font
from tests import np_reference
from tests.test_alpha_modes import quad

W, H = 128, 96


def expected_u8(rgb):
    return np_reference.aces_srgb_u8(np.asarray(rgb, np.float64))


def _scene_and_renderer(**cfg_kw):
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    bg = quad(builder, 2.0)
    builder.build()
    red = registry.create_material(
        "red", rt.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1))
    )
    scene = rt.Scene()
    scene.queue_mesh(bg, red, None, math3d.IDENTITY)
    renderer = rt.Renderer(registry, rt.RenderConfig(width=W, height=H, **cfg_kw))
    return registry, renderer, scene, red


class TestUiComposite:
    def test_translucent_rect_blends_into_hdr_before_tonemap(self):
        # the background quad covers rows 29-66, cols 45-82 of the 128x96 frame
        _reg, r, scene, _red = _scene_and_renderer()
        ui = DrawList()
        ui.add_rect_filled((56, 24), (96, 72), (0, 0, 255, 128))
        img = r.render_frame(scene, debug_mode=1, ui=ui)
        a = 128 / 255.0
        # composited in LINEAR HDR space, then ACES+sRGB (the reference draws
        # ImGui into the HDR geometry pass, before the post-process)
        np.testing.assert_allclose(
            img[48, 70], expected_u8([1 - a, 0, a]), atol=2
        )
        # inside the scene quad but outside the UI rect: untouched scene
        np.testing.assert_allclose(img[48, 50], expected_u8([1, 0, 0]), atol=2)
        stats = r.frame_stats()
        assert stats["overflow_ui"] == 0 and stats["ui_saturated_px"] == 0

    def test_no_ui_is_identical_to_baseline(self):
        _reg, r, scene, _red = _scene_and_renderer()
        base = r.render_frame(scene, debug_mode=1)
        with_empty = r.render_frame(scene, debug_mode=1, ui=None)
        np.testing.assert_array_equal(base, with_empty)

    def test_clip_rect_discard(self):
        _reg, r, scene, _red = _scene_and_renderer()
        ui = DrawList()
        ui.push_clip_rect(32, 24, 64, 72)
        ui.add_rect_filled((0, 0), (W, H), (0, 255, 0, 255))
        ui.pop_clip_rect()
        img = r.render_frame(scene, debug_mode=1, ui=ui)
        # inside the clip rect: opaque green UI
        np.testing.assert_allclose(img[48, 48], expected_u8([0, 1, 0]), atol=2)
        # outside (the quad covers the full screen but is clipped away);
        # col 70 is inside the scene quad → untouched red
        np.testing.assert_allclose(img[48, 70], expected_u8([1, 0, 0]), atol=2)
        # boundary semantics (imgui.frag:28-33): clip.x < px ≤ clip.z with
        # px = column + 0.5 → columns 32..63 pass
        assert (img[48, 32] == expected_u8([0, 1, 0])).all()
        assert (img[48, 64] == expected_u8([1, 0, 0])).all()

    def test_painters_order_composite(self):
        _reg, r, scene, _red = _scene_and_renderer()
        ui = DrawList()
        ui.add_rect_filled((16, 16), (112, 80), (0, 0, 255, 128))
        ui.add_rect_filled((48, 32), (96, 64), (255, 255, 255, 128))
        img = r.render_frame(scene, debug_mode=1, ui=ui)
        a = 128 / 255.0
        first = np.array([1 - a, 0, a])  # blue over the red scene quad
        second = first * (1 - a) + a  # white over that, in submission order
        np.testing.assert_allclose(img[48, 64], expected_u8(second), atol=2)
        # first rect only (col 46 is inside the scene quad, left of rect 2)
        np.testing.assert_allclose(img[48, 46], expected_u8(first), atol=2)

    def test_layer_saturation_counted(self):
        _reg, r, scene, _red = _scene_and_renderer(ui_layers=2)
        ui = DrawList()
        for _ in range(3):
            ui.add_rect_filled((32, 24), (96, 72), (0, 0, 255, 40))
        r.render_frame(scene, debug_mode=1, ui=ui)
        assert r.frame_stats()["ui_saturated_px"] > 0

    def test_text_draws_glyphs(self):
        reg, r, scene, _red = _scene_and_renderer()
        font = get_font()
        ui = DrawList()
        ui.add_rect_filled((4, 4), (124, 40), (20, 20, 28, 166))
        ui.add_text((8, 8), "Hello GPU 123", (220, 220, 230, 255), font, reg)
        img = r.render_frame(scene, debug_mode=1, ui=ui)
        # glyph pixels are bright and neutral (the text color), distinct from
        # both the red scene and the dark window background
        box = img[8:24, 8:100].astype(int)
        bright = (box.min(axis=-1) > 100).sum()
        assert bright > 20, f"only {bright} glyph pixels found"

    def test_ui_msaa_antialiases_quarter_pixel_edge(self):
        """RenderConfig.ui_msaa: UI coverage at the MSAA sample positions
        (the reference renders ImGui into the multisampled geometry target,
        so UI edges resolve antialiased). A rect edge at x = 32.25 covers
        3 of the 4 Vulkan standard sample x-offsets of column 32
        (.375/.625/.875 yes, .125 no) → the resolved edge pixel is a 3/4
        blend, where the pixel-center default is fully covered."""
        _r0, r_exact, scene, _red = _scene_and_renderer(
            msaa_samples=4, ui_msaa=True
        )
        ui = DrawList()
        ui.add_rect_filled((32.25, 24), (96, 72), (0, 255, 0, 255))
        img = r_exact.render_frame(scene, debug_mode=1, ui=ui)

        def resolved_u8(linears, weights):
            x = np.asarray(linears, np.float64) * 0.8
            mapped = np.clip(
                (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0, 1
            )
            m = (mapped * np.asarray(weights)[:, None]).sum(0)
            enc = np.where(
                m <= 0.0031308, m * 12.92, 1.055 * m ** (1 / 2.4) - 0.055
            )
            return np.round(np.clip(enc, 0, 1) * 255).astype(np.uint8)

        green, black = [0, 1, 0], [0, 0, 0]
        # interior: full green (and identical to the pixel-center default)
        np.testing.assert_allclose(img[48, 64], expected_u8(green), atol=2)
        # edge column 32 (over the black clear background): 3/4 coverage
        np.testing.assert_allclose(
            img[48, 32],
            resolved_u8([green, green, green, black], [0.25] * 4),
            atol=2,
        )
        # the pixel-center default covers column 32 fully (center .5 ≥ .25)
        _r1, r_def, scene2, _red2 = _scene_and_renderer(msaa_samples=4)
        img_def = r_def.render_frame(scene2, debug_mode=1, ui=ui)
        np.testing.assert_allclose(img_def[48, 32], expected_u8(green), atol=2)
        # interiors agree between the two modes
        np.testing.assert_allclose(
            img[40:56, 48:80].astype(int), img_def[40:56, 48:80].astype(int),
            atol=1,
        )

    def test_msaa4_interior_matches_msaa1(self):
        _reg1, r1, s1, _ = _scene_and_renderer()
        ui = DrawList()
        ui.add_rect_filled((32, 24), (96, 72), (0, 0, 255, 128))
        img1 = r1.render_frame(s1, debug_mode=1, ui=ui)
        _reg4, r4, s4, _ = _scene_and_renderer(msaa_samples=4)
        img4 = r4.render_frame(s4, debug_mode=1, ui=ui)
        # interior pixels (away from any edge) must match exactly; UI is
        # composited into every sample pre-tonemap
        np.testing.assert_allclose(
            img1[40:56, 48:80].astype(int), img4[40:56, 48:80].astype(int),
            atol=1,
        )
