"""Deferred shading: visibility buffer → HDR color.

Replaces the fragment shader (reference: renderer/shaders/glsl/main.frag) as a
dense [H, W] jnp pass: each covered pixel gathers its triangle's three
vertices, reconstructs perspective-correct barycentrics, interpolates
attributes, samples material textures, and evaluates the lighting / debug
mode. Every pixel is shaded exactly once — shading cost is independent of
overdraw, and all texture fetches across the frame batch into a handful of
large gathers.

Parity notes:
- Interpolated normals/tangents are NOT renormalized per pixel (the reference
  fragment shader uses the raw interpolated varyings, main.frag:64-67).
- Normal mapping: bitangent = tangent.w · cross(normal, tangent.xyz);
  n = TBN @ normalize(normal_tex · [scale, scale, 1]) (main.frag:64-67).
- Lit mode (main.frag:78-88): emissive override if ‖emissive‖ > 0, else
  brightness = 0.3·occlusion + 2.0·max(0, n·normalize(-1,1,1)).
- Debug modes 1-6 (main.frag:89-107); draw-id color hash
  fract(sin(d·k)·43758.5453123) evaluated per draw (main.vert:67-77).
- Texture sampling: bilinear from the packed RGBA8 atlas (materials/atlas.py)
  with per-pixel per-axis texel-space mip selection from analytic UV screen
  derivatives (the reference sampler is repeat anisotropic trilinear,
  descriptors.rs:90-105). Address mode defaults to REPEAT (the reference's
  only mode); per-texture glTF wrap modes are honored when the materials
  dict carries atlas_wrap (BEYOND parity — the reference parses glTF
  samplers and ignores them). DELIBERATE DEVIATION: sRGB decode is
  applied to the FILTERED value, not per tap (hardware decodes before
  filtering) — 4-8x fewer pow() evaluations; worst-case error is bounded and
  pinned by tests/test_srgb_filter_order.py (see PARITY.md known gaps).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from renderer_tpu.materials.atlas import MAX_MIPS


def _srgb_decode(c):
    lo = c / 12.92
    hi = jnp.power((c + 0.055) / 1.055, 2.4)
    return jnp.where(c <= 0.04045, lo, hi)


def make_sampler(materials: dict, uv, lod_base, trilinear: bool = True,
                 duv_dx=None, duv_dy=None, aniso: int = 1,
                 srgb_per_tap: bool = False, compute_dtype=jnp.float32):
    """Returns sample(slot) -> [H,W,4] linear RGBA: repeat-wrap bilinear /
    trilinear (two-mip blend) / anisotropic (N trilinear taps along the major
    UV screen-derivative axis) atlas fetch — the reference sampler is repeat
    anisotropic trilinear (descriptors.rs:90-105). The mip level comes from
    per-axis texel-space screen derivatives (duv · texture size), correct for
    non-square textures; lod_base is only the fallback when no derivatives
    are supplied.

    srgb_per_tap=True is the EXACT hardware filter order (each tap decoded
    to linear before the bilinear weights, descriptors.rs:90-105 +
    VK_FORMAT_*_SRGB semantics); False decodes the filtered value — 4-8x
    fewer pow() evaluations with a deviation bounded and pinned by
    tests/test_srgb_filter_order.py.

    compute_dtype=jnp.bfloat16 runs the FILTER ARITHMETIC (tap blending,
    sRGB decode) at bf16 for the shading-dominated frame. Texel ADDRESSING
    (uv→texel, mip LOD from derivatives) always stays f32: bf16's 8
    mantissa bits cannot index a 1k-texel texture. GPU samplers filter u8 taps at comparable internal precision."""
    atlas = materials["atlas"]  # [AH,AW] u32
    table = materials["atlas_table"]  # [T,M,4] i32
    srgb = materials["atlas_srgb"]  # [T] i32
    # per-texture per-axis address mode ([T,2] i32, TextureWrap values) —
    # BEYOND the reference, which parses glTF samplers but routes every
    # texture through one repeat sampler (descriptors.rs:90-105); absent
    # from hand-built materials dicts → pure repeat (the reference default)
    wrap_table = materials.get("atlas_wrap")
    aw = atlas.shape[1]
    atlas_flat = atlas.reshape(-1)
    table_flat = table.reshape(-1, 4)

    def apply_wrap(uvq, wm):  # uvq [H,W,2] f32; wm [H,W,2] i32 or None
        rep = uvq - jnp.floor(uvq)  # REPEAT
        if wm is None:
            return rep
        half = uvq * 0.5  # MIRRORED_REPEAT: period-2 triangle wave
        mir = 1.0 - jnp.abs(2.0 * (half - jnp.floor(half)) - 1.0)
        return jnp.where(wm == 1, jnp.clip(uvq, 0.0, 1.0),  # CLAMP_TO_EDGE
                         jnp.where(wm == 2, mir, rep))

    def sample_mip(slot, lod, uvq, wm):  # slot,lod [H,W] i32; uvq [H,W,2]
        # address-mode transform maps into [0,1]; the bilinear taps then
        # reach at most 1 texel outside the rect, where the atlas border
        # texel was written for this texture's own mode (materials/atlas.py)
        uvf = apply_wrap(uvq, wm)
        rect = table_flat[slot * MAX_MIPS + lod]  # [H,W,4]
        x0, y0 = rect[..., 0], rect[..., 1]
        w = rect[..., 2].astype(jnp.float32)
        h = rect[..., 3].astype(jnp.float32)
        uf = uvf[..., 0] * w - 0.5
        vf = uvf[..., 1] * h - 0.5
        iu = jnp.floor(uf)
        iv = jnp.floor(vf)
        fu = (uf - iu)[..., None]
        fv = (vf - iv)[..., None]
        iu = iu.astype(jnp.int32)
        iv = iv.astype(jnp.int32)

        is_srgb = (srgb[slot] > 0)[..., None]
        fu = fu.astype(compute_dtype)
        fv = fv.astype(compute_dtype)

        def decode(c):  # sRGB → linear on RGB; alpha is stored linear
            rgb = jnp.where(is_srgb, _srgb_decode(c[..., :3]), c[..., :3])
            return jnp.concatenate([rgb, c[..., 3:4]], axis=-1)

        def tap(dx, dy):
            xx = x0 + iu + dx  # border texel at -1 and w exists (wrap pad)
            yy = y0 + iv + dy
            t = atlas_flat[yy * aw + xx]
            c = jnp.stack(
                [t & 0xFF, (t >> 8) & 0xFF, (t >> 16) & 0xFF, t >> 24], axis=-1
            ).astype(compute_dtype) * compute_dtype(1.0 / 255.0)
            # exact mode: decode BEFORE the filter weights (hardware order)
            return decode(c) if srgb_per_tap else c

        t00, t10, t01, t11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
        c = (
            t00 * (1 - fu) * (1 - fv)
            + t10 * fu * (1 - fv)
            + t01 * (1 - fu) * fv
            + t11 * fu * fv
        )
        if srgb_per_tap:
            return c
        # fast mode: decode the FILTERED value — within tolerance (pinned by
        # tests/test_srgb_filter_order.py) and 4x fewer pow() evaluations.
        return decode(c)

    def sample_filtered(slot, lodf, uvq, wm):
        lodf = jnp.clip(lodf, 0.0, MAX_MIPS - 1.0)
        if not trilinear:
            return sample_mip(slot, jnp.round(lodf).astype(jnp.int32), uvq, wm)
        l0 = jnp.floor(lodf)
        frac = (lodf - l0)[..., None]
        l0 = l0.astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, MAX_MIPS - 1)
        frac = frac.astype(compute_dtype)
        return (sample_mip(slot, l0, uvq, wm) * (1.0 - frac)
                + sample_mip(slot, l1, uvq, wm) * frac)

    def sample(slot):  # slot [H,W] i32
        wm = None if wrap_table is None else wrap_table[slot]  # [H,W,2]
        if duv_dx is None:
            # no analytic derivatives available: approximate texel-space
            # footprint with the max-dimension size (flat-shade paths only)
            size0 = jnp.maximum(table[slot, 0, 2], table[slot, 0, 3]).astype(jnp.float32)
            return sample_filtered(
                slot, lod_base + jnp.log2(jnp.maximum(size0, 1.0)), uv, wm)
        # Per-axis texel-space derivatives: scale the UV derivative by the
        # texture's (w, h) BEFORE the length reduction, so non-square
        # textures get the correct LOD on both axes (the reference sampler's
        # derivatives are implicitly texel-space, descriptors.rs:90-105).
        wh = jnp.stack(
            [table[slot, 0, 2].astype(jnp.float32),
             table[slot, 0, 3].astype(jnp.float32)], axis=-1,
        )  # [H,W,2]
        lx = jnp.sqrt(jnp.sum((duv_dx * wh) ** 2, axis=-1))
        ly = jnp.sqrt(jnp.sum((duv_dy * wh) ** 2, axis=-1))
        rho_max = jnp.maximum(jnp.maximum(lx, ly), 1e-8)
        if aniso <= 1:
            return sample_filtered(slot, jnp.log2(rho_max), uv, wm)
        # anisotropy: lod from the MINOR footprint axis (clamped so the
        # major/minor ratio never exceeds the tap count), N trilinear taps
        # spread along the major axis.
        rho_min = jnp.maximum(jnp.minimum(lx, ly), rho_max / aniso)
        lodf = jnp.log2(rho_min)
        major = jnp.where((lx >= ly)[..., None], duv_dx, duv_dy)  # [H,W,2]
        if aniso <= 4:
            # low tap counts stay unrolled: XLA fuses the whole tap chain
            # with the surrounding shade math (the fast default path)
            acc = jnp.asarray(0.0, compute_dtype)
            for i in range(aniso):
                t = (i + 0.5) / aniso - 0.5
                acc = acc + sample_filtered(slot, lodf, uv + major * t, wm)
            return acc * compute_dtype(1.0 / aniso)

        # high tap counts (the exact-sampler aniso16 mode) loop in HLO:
        # unrolling 16 trilinear taps per texture made the frame module
        # ~10x larger and dominated compile time. The loop accumulates in
        # the SAME order as the unrolled path, and (i+0.5)/aniso is exact
        # in f32 for pow-2 tap counts, so results are bit-identical.
        def tap_body(i, acc):
            t = (i.astype(jnp.float32) + 0.5) / aniso - 0.5
            return acc + sample_filtered(slot, lodf, uv + major * t, wm)

        acc = jax.lax.fori_loop(
            0, aniso, tap_body,
            jnp.zeros(jnp.broadcast_shapes(uv.shape[:-1], slot.shape) + (4,),
                      compute_dtype),
        )
        return acc * compute_dtype(1.0 / aniso)

    return sample


def draw_debug_colors(debug_id: jnp.ndarray) -> jnp.ndarray:
    """Per-draw hashed debug color (main.vert:67-77): d = 1 + draw_id,
    channel = fract(sin(d·k)·43758.5453123)."""
    d = 1.0 + debug_id.astype(jnp.float32)

    def rnd(x):
        return jnp.mod(jnp.sin(x) * 43758.5453123, 1.0)

    return jnp.stack(
        [rnd(d * 641.65433), rnd(d * 1864.251623), rnd(d * 182362.365)], axis=-1
    )


def _cross(a, b):
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def interpolants(
    trid: jnp.ndarray,  # [..., H,W] i32, -1 = background
    geom: dict,
    vstage: dict,
    *,
    width: int,
    height: int,
    row0=0,  # traced scalar, or [h, 1] per-row offset to the GLOBAL pixel
    # row (interleaved sp sharding: local rows are not a contiguous band)
) -> dict:
    """Per-pixel interpolation context for a visibility buffer: gathers the
    triangle's vertices, reconstructs perspective-correct barycentrics, and
    interpolates uv/normal/tangent plus the analytic UV screen derivative
    (for mip selection). Reused by the main shade, the masked-alpha test,
    and per-layer blended shading.

    Leading-dim polymorphic: trid may carry extra leading axes (the pipeline
    stacks all shade candidates into one [C,H,W] call so the frame module
    contains ONE shading subgraph instead of one per candidate — identical
    per-element math, ~5x smaller HLO; golden-pinned)."""
    h, w = trid.shape[-2:]
    covered = trid >= 0
    t = jnp.where(covered, trid, 0)

    vid = geom["tri_v"][t]  # [...,H,W,3]
    clip = vstage["clip"][vid]  # [...,H,W,3,4]

    # Homogeneous (2DH) barycentrics — matches the raster kernels' edge
    # planes exactly and stays valid for triangles crossing w = 0: with
    # pixel-scaled u_i = (X, Y, w), perspective-correct weights are
    # g_i(p) = (u_j × u_k) · (px, py, 1), normalized.
    X = (clip[..., 0] * 0.5 + clip[..., 3] * 0.5) * width
    Y = (clip[..., 1] * 0.5 + clip[..., 3] * 0.5) * height
    Wh = clip[..., 3]

    px = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5
    py = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5 + row0

    def edge_g(j, k):
        a = Y[..., j] * Wh[..., k] - Wh[..., j] * Y[..., k]
        b = Wh[..., j] * X[..., k] - X[..., j] * Wh[..., k]
        cc = X[..., j] * Y[..., k] - Y[..., j] * X[..., k]
        return a, b, cc, a * px + b * py + cc

    a0, b0, _, g0 = edge_g(1, 2)
    a1, b1, _, g1 = edge_g(2, 0)
    a2, b2, _, g2 = edge_g(0, 1)
    gsum = g0 + g1 + g2
    inv_gsum = jnp.reciprocal(
        jnp.where(jnp.abs(gsum) > 1e-20, gsum, 1.0)
    )
    lp = jnp.stack([g0, g1, g2], axis=-1) * inv_gsum[..., None]

    def interp(attr):  # attr [VE,K] -> [...,H,W,K]
        return jnp.einsum("...v,...vk->...k", lp, attr[vid],
                          precision=jax.lax.Precision.HIGHEST)

    uv = interp(vstage["uv"])
    draw = vstage["draw"][vid[..., 0]]  # [...,H,W]

    # Analytic UV screen derivatives for mip selection:
    # d(f)/dx = Σ A_i (f_i − f) / Σ g_i (A_i = ∂g_i/∂px).
    uv_verts = vstage["uv"][vid]  # [H,W,3,2]
    duv = uv_verts - uv[..., None, :]  # [H,W,3,2]
    das = jnp.stack([a0, a1, a2], axis=-1) * inv_gsum[..., None]
    dbs = jnp.stack([b0, b1, b2], axis=-1) * inv_gsum[..., None]
    duv_dx = jnp.sum(das[..., None] * duv, axis=-2)  # [H,W,2]
    duv_dy = jnp.sum(dbs[..., None] * duv, axis=-2)
    deriv = jnp.maximum(
        jnp.max(jnp.abs(duv_dx), axis=-1), jnp.max(jnp.abs(duv_dy), axis=-1)
    )
    lod_base = jnp.log2(jnp.maximum(deriv, 1e-8))

    return {
        "covered": covered,
        "interp": interp,
        "uv": uv,
        "draw": draw,
        "lod_base": lod_base,
        "duv_dx": duv_dx,
        "duv_dy": duv_dy,
    }


def base_alpha(it: dict, frame: dict, materials: dict,
               trilinear: bool = True, aniso: int = 1,
               srgb_per_tap: bool = False,
               compute_dtype=jnp.float32) -> jnp.ndarray:
    """Base-color alpha × factor alpha, for the alpha-cutoff test
    (main.frag:42,59-62). Returns (alpha [H,W] f32, cutoff [H,W] f32)."""
    mat = frame["material_id"][it["draw"]]
    sampler = make_sampler(materials, it["uv"], it["lod_base"], trilinear,
                           it["duv_dx"], it["duv_dy"], aniso, srgb_per_tap,
                           compute_dtype)
    tex_idx = materials["tex_indices"][mat]
    a = sampler(tex_idx[..., 0])[..., 3].astype(jnp.float32) \
        * materials["base_color_factor"][mat][..., 3]
    cutoff = materials["alpha_rgh_mtl_normal"][mat][..., 0]
    return a, cutoff


def shade_interpolated(it: dict, vstage: dict, frame: dict, materials: dict,
                       trilinear: bool = True, aniso: int = 1,
                       srgb_per_tap: bool = False,
                       compute_dtype=jnp.float32) -> jnp.ndarray:
    """Full fragment shading (main.frag) on an interpolation context.

    compute_dtype=jnp.bfloat16 evaluates texture filtering and the lighting
    arithmetic at bf16 (RenderConfig.bf16_shading): geometry interpolation,
    depth and edges stay f32; the returned color is f32 for compositing.
    The 8-bit output and the tonemap make the precision loss sub-quantum
    almost everywhere (pinned by tests/test_bf16_shading.py)."""
    dt = compute_dtype
    covered = it["covered"]
    interp = it["interp"]
    uv = it["uv"]
    draw = it["draw"]

    normal = interp(vstage["normal"]).astype(dt)
    tangent4 = interp(vstage["tangent"]).astype(dt)
    tangent, tan_w = tangent4[..., :3], tangent4[..., 3]

    mat = frame["material_id"][draw]
    base_factor = materials["base_color_factor"][mat].astype(dt)  # [H,W,4]
    emis_occ = materials["emissive_occlusion"][mat].astype(dt)
    arm = materials["alpha_rgh_mtl_normal"][mat].astype(dt)
    tex_idx = materials["tex_indices"][mat]  # [H,W,5] i32

    sampler = make_sampler(materials, uv, it["lod_base"], trilinear,
                           it["duv_dx"], it["duv_dy"], aniso, srgb_per_tap,
                           dt)

    def sample(slot_col):
        return sampler(tex_idx[..., slot_col])

    base_color = sample(0) * base_factor
    mr_tex = sample(1)
    normal_tex = sample(2)[..., :3] * 2.0 - 1.0
    occ_tex = sample(3)
    emissive = sample(4)[..., :3] * emis_occ[..., :3]

    occ_strength = emis_occ[..., 3]
    rough = mr_tex[..., 1] * arm[..., 1]
    metal = mr_tex[..., 2] * arm[..., 2]
    normal_scale = arm[..., 3]
    occlusion = 1.0 + occ_strength * (occ_tex[..., 0] - 1.0)

    # TBN normal mapping (main.frag:64-67).
    bitangent = tan_w[..., None] * _cross(normal, tangent)
    nt = normal_tex * jnp.stack(
        [normal_scale, normal_scale, jnp.ones_like(normal_scale)], axis=-1
    )
    nt = nt * jnp.reciprocal(
        jnp.sqrt(jnp.maximum(jnp.sum(nt * nt, axis=-1, keepdims=True), 1e-20))
    )
    shading_normal = (
        tangent * nt[..., 0:1] + bitangent * nt[..., 1:2] + normal * nt[..., 2:3]
    )

    # Lit mode (main.frag:78-88).
    sun_dir = (jnp.asarray([-1.0, 1.0, 1.0]) / jnp.sqrt(3.0)).astype(dt)
    sun_dot = jnp.maximum(0.0, jnp.sum(shading_normal * sun_dir, axis=-1))
    brightness = 0.3 * occlusion + sun_dot * 2.0
    emissive_len = jnp.sqrt(jnp.sum(emissive * emissive, axis=-1))
    lit_rgb = jnp.where(
        (emissive_len > 0.0)[..., None],
        emissive,
        brightness[..., None] * base_color[..., :3],
    )
    lit = jnp.concatenate(
        [lit_rgb,
         jnp.where((emissive_len > 0.0)[..., None], 1.0, base_color[..., 3:4])],
        axis=-1,
    )

    debug_rgb = draw_debug_colors(frame["debug_id"][draw]).astype(dt)

    def rgba(rgb, a=None):
        if a is None:
            a = jnp.ones_like(rgb[..., :1])
        return jnp.concatenate([rgb, a], axis=-1)

    mode = frame["debug_mode"]
    candidates = [
        lit,  # 0 (and default)
        base_color,  # 1
        rgba(debug_rgb),  # 2
        rgba(shading_normal),  # 3
        rgba(jnp.stack([jnp.zeros_like(rough), rough, metal], axis=-1)),  # 4
        rgba(emissive),  # 5
        rgba(jnp.repeat(occlusion[..., None], 3, axis=-1)),  # 6
    ]
    color = candidates[0]
    for i in range(1, len(candidates)):
        color = jnp.where(mode == i, candidates[i], color)

    color = jnp.where(covered[..., None], color, jnp.zeros_like(color))
    return color.astype(jnp.float32)


def shade(
    trid: jnp.ndarray,  # [H,W] i32, -1 = background
    geom: dict,
    vstage: dict,
    frame: dict,
    materials: dict,
    *,
    width: int,
    height: int,
    row0=0,
    trilinear: bool = True,
    aniso: int = 1,
    srgb_per_tap: bool = False,
    compute_dtype=jnp.float32,
) -> jnp.ndarray:
    """Returns linear HDR [H,W,4] f32. Background pixels are the clear color
    (0,0,0,0) (render_passes.rs:192-197)."""
    it = interpolants(trid, geom, vstage, width=width, height=height, row0=row0)
    return shade_interpolated(it, vstage, frame, materials, trilinear, aniso,
                              srgb_per_tap, compute_dtype)
