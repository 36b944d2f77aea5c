"""UI pass device stages: raster + shade of the DrawList through the same
layer machinery as blended scene geometry.

Pipeline-state parity with the reference's ImGui pipeline
(pipeline_parameters.rs IMGUI): blended src-alpha/one-minus, double-sided,
depth test/write OFF, drawn LAST in the geometry pass into the HDR target —
i.e. BEFORE tonemap (renderer.rs:433-441 pipeline order, render pass
Geometry). Fragment behavior parity with imgui.frag: clip-rect discard on
screen coordinates (:28-33), tex_kind 1 = alpha-from-R font, 2 = RGBA
modulate, else discard (:34-44).

Shape: triangles are already 2D screen-space; the ordered-accept layer
kernel (raster/layers.py "blended" mode, constant depth so every fragment
passes GE and the chain is submission order) captures up to ui_layers
fragments per pixel; each captured layer is shaded once per pixel with
2D-affine barycentrics (w = 1 → no perspective) and composited in order.
DEFAULT DEVIATION: UI coverage is evaluated at pixel centers only and the
same composite is applied to every MSAA sample (the reference's multisampled
target antialiases UI edges; UI quads are axis-aligned so the difference is
sub-pixel on glyph/border edges). `RenderConfig.ui_msaa` restores the exact
behavior: coverage at the MSAA sample positions with per-sample accept
chains, shading/attributes at pixel centers (hardware non-sample-rate
shading) — tested in tests/test_ui_overlay.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from renderer_tpu.raster import binning, layers, setup
from renderer_tpu.raster.shade import make_sampler

# f32 contractions stay f32 (a GPU may otherwise run them in TF32)
_HI = jax.lax.Precision.HIGHEST

TEX_KIND_FONT = 1
TEX_KIND_RGBA = 2


def rasterize_ui(
    ui: dict,
    *,
    config,
    local_tiles_y: int,
    tile_row_offset,
    sample_positions: tuple = ((0.5, 0.5),),
    row_stride: int = 1,
    interpret: bool = False,
):
    """Bin + layer-rasterize the UI triangles. `sample_positions` — in-pixel
    coverage evaluation points: pixel centers by default, the MSAA sample
    positions under RenderConfig.ui_msaa (the reference's multisampled UI
    edges). Returns (layer tids [S, K, Hp, Wp] i32, overflow scalar,
    aux counts [S, Hp, Wp])."""
    cfg = config
    pad_h = local_tiles_y * cfg.tile_h
    n_s = len(sample_positions)
    pos = ui["pos"]
    x = pos[:, 0] * (2.0 / cfg.width) - 1.0
    y = pos[:, 1] * (2.0 / cfg.height) - 1.0
    clip = jnp.stack(
        [x, y, jnp.full_like(x, 0.5), jnp.ones_like(x)], axis=-1
    )
    tri_data = setup.triangle_setup(
        clip, ui["tris"], ui["counts"][0], cfg.width, cfg.height,
        double_sided=True,
        bbox_pad=(0.5 if n_s > 1 else 0.0),
    )
    binned, starts, counts, overflow = binning.bin_triangles(
        tri_data, 0, None,
        tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h,
        pair_capacity=cfg.ui_pair_capacity,
        # shard-local binning like the scene classes (pipeline.render_shard)
        tile_row_lo=tile_row_offset, local_tiles_y=local_tiles_y,
        row_stride=row_stride,
    )
    # constant z = 0.5 vs floor 0.0 → every covered fragment passes GE and
    # the accept chain is pure submission (painter's) order
    floor = jnp.zeros((n_s, pad_h, cfg.padded_width), jnp.float32)
    _lz, lt, aux = layers.rasterize_layers(
        binned, starts, counts, floor,
        mode="blended", n_layers=cfg.ui_layers,
        tile_row_offset=tile_row_offset,
        padded_height=pad_h, padded_width=cfg.padded_width,
        tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        sample_positions=tuple(sample_positions), row_stride=row_stride,
        interpret=interpret,
    )
    return lt, overflow, aux


def shade_ui_layer(
    lt: jnp.ndarray,  # [..., Hp, Wp] i32 layer tids (-1 empty)
    ui: dict,
    materials: dict,
    *,
    config,
    row0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """imgui.frag for one captured layer at pixel centers. Returns
    (rgb [...,H,W,3], alpha [...,H,W]) ready for src-alpha compositing.

    Leading-dim polymorphic like shade.interpolants: the pipeline shades
    ALL captured UI layers (and MSAA sample sets under ui_msaa) in one
    stacked call, so the frame module carries one UI-shading subgraph
    instead of layers x samples copies."""
    cfg = config
    h, w = lt.shape[-2:]
    covered = lt >= 0
    t = jnp.where(covered, lt, 0)

    vid = ui["tris"][t]  # [H,W,3]
    p = ui["pos"][vid]  # [H,W,3,2]
    px = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5
    py = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5 + row0

    # 2D affine barycentrics (w = 1): g_i = cross2(p_j - pt, p_k - pt);
    # the shared denominator's sign cancels, so both windings interpolate
    # correctly (the pipeline is double-sided).
    def g(j, k):
        ax = p[..., j, 0] - px
        ay = p[..., j, 1] - py
        bx = p[..., k, 0] - px
        by = p[..., k, 1] - py
        return ax * by - ay * bx

    g0, g1, g2 = g(1, 2), g(2, 0), g(0, 1)
    s = g0 + g1 + g2
    inv_s = jnp.reciprocal(jnp.where(jnp.abs(s) > 1e-12, s, 1.0))
    lam = jnp.stack([g0, g1, g2], axis=-1) * inv_s[..., None]

    uv = jnp.einsum("...v,...vk->...k", lam, ui["uv"][vid], precision=_HI)
    col = jnp.einsum("...v,...vk->...k", lam, ui["col"][vid], precision=_HI)

    # analytic UV derivatives of the affine map (∂lam_i/∂x = a_i / s with
    # a_i from the edge vectors; Σ a_i = 0)
    a = jnp.stack(
        [p[..., 1, 1] - p[..., 2, 1], p[..., 2, 1] - p[..., 0, 1],
         p[..., 0, 1] - p[..., 1, 1]], axis=-1,
    ) * inv_s[..., None]
    b = jnp.stack(
        [p[..., 2, 0] - p[..., 1, 0], p[..., 0, 0] - p[..., 2, 0],
         p[..., 1, 0] - p[..., 0, 0]], axis=-1,
    ) * inv_s[..., None]
    uvv = ui["uv"][vid]  # [H,W,3,2]
    duv_dx = jnp.einsum("...v,...vk->...k", a, uvv, precision=_HI)
    duv_dy = jnp.einsum("...v,...vk->...k", b, uvv, precision=_HI)

    cmd = ui["tri_cmd"][t]  # [H,W]
    crect = ui["clip"][cmd]  # [H,W,4]
    # clip-rect discard on screen coords (imgui.frag:28-33)
    in_clip = (
        (crect[..., 0] < px) & (crect[..., 2] >= px)
        & (crect[..., 1] < py) & (crect[..., 3] >= py)
    )
    kind = ui["tex_kind"][cmd]
    slot = ui["tex_slot"][cmd]

    sampler = make_sampler(materials, uv, jnp.zeros_like(s), True,
                           duv_dx, duv_dy, aniso=1)
    tex = sampler(slot)

    # tex_kind 1: rgb = vertex color, alpha = vertex alpha · tex.r (R8 font);
    # tex_kind 2: full modulate; anything else discards (imgui.frag:34-44)
    rgb = jnp.where((kind == TEX_KIND_RGBA)[..., None],
                    col[..., :3] * tex[..., :3], col[..., :3])
    alpha = jnp.where(kind == TEX_KIND_FONT, col[..., 3] * tex[..., 0],
                      col[..., 3] * tex[..., 3])
    live = covered & in_clip & ((kind == TEX_KIND_FONT) | (kind == TEX_KIND_RGBA))
    return rgb, jnp.where(live, alpha, 0.0)
