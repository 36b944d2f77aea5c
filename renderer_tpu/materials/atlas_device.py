"""Device-decoded texture atlas: upload compressed blocks, decode on-chip.

The host atlas path (materials/atlas.py) decodes BC7 on the CPU and uploads
the full decoded [AH, AW] u32 atlas — ~4 bytes/texel plus packing gaps —
which dominates startup on bandwidth-constrained host→device links
(STARTUP.md: the Sponza-scale atlas is ~390 MB decoded vs ~91 MB of BC7
source). This module uploads the SOURCE instead:

- the raw BC7 block stream (1 byte/texel) in ORIGINAL rect order; the
  device derives everything else: block modes from the block bytes, the
  mode grouping via one stable argsort (each mode's group then decodes
  with a static-layout pass, materials/bc7_jax — group SIZES are static,
  computed host-side), and per-block destinations from per-RECT segment
  metadata via a device searchsorted (a few KB for the whole atlas; the
  round<5 plan uploaded a u32 placement word per 4x4 block instead —
  24 MB of the Sponza-scale upload),
- the non-BC7 rects' texels verbatim (small: fonts, embedded PNGs),
- border gather/scatter index lists replaying atlas.py's two-pass wrap
  border composition (rows per wrap_t, then columns per wrap_s INCLUDING
  the row borders, exactly np.pad's corner composition).

`realize_atlas(plan)` runs ONE jitted pass: per-mode BC7 decode → texel
scatter → raw scatter → two border passes → [AH, AW] u32 atlas,
bit-identical to materials/atlas.build_atlas(...).data (pinned by
tests/test_bc7_decode.py::test_device_atlas_matches_host). The plan is
disk-cached by texture content fingerprints like the host atlas bundle.

Reference analog: the GPU samples BC7 natively so only compressed bytes
ever cross the bus (image_loading.rs:83-237); here the decode happens once
at startup, but the LINK carries compressed bytes like the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from renderer_tpu.core import constants
from renderer_tpu.materials.atlas import (
    ATLAS_WIDTH,
    MAX_MIPS,
    Atlas,
    _atlas_cache_file,
    _pack_rgba,
    _plan_placements,
)
from renderer_tpu.materials.registry import MaterialRegistry, TextureKind

# block meta packing: flat_base << 4 | (vh-1) << 2 | (vw-1)
_META_SHIFT = 4

# BC7 decode runs in fixed-size lax.map chunks of this many blocks (see
# realize_atlas): bounds the decode body's executable size independent of
# scene scale. 2^18 blocks = 4.2M texels per chunk.
DECODE_CHUNK = 1 << 18


@dataclass
class AtlasPlan:
    shape: tuple[int, int]  # (AH, AW)
    blocks: np.ndarray  # [N, 4] u32 BC7 blocks in ORIGINAL rect order
    mode_counts: dict[int, int]  # mode -> block count (static group sizes)
    # per-RECT segment metadata (one row per (texture, mip) BC7 rect):
    seg_start: np.ndarray  # [R+1] i32 block-stream offsets (seg_start[R]=N)
    seg_base: np.ndarray   # [R] i32 atlas flat index of the rect's (+1,+1)
    seg_bw: np.ndarray     # [R] i32 blocks per rect row
    seg_w: np.ndarray      # [R] i32 rect texel width
    seg_h: np.ndarray      # [R] i32 rect texel height
    raw_tiles: np.ndarray  # [M, 16] u32 non-BC7 texels as 4x4 tiles
    raw_meta: np.ndarray  # [M] u32 packed placement (per-tile; small)
    border_src1: np.ndarray  # row pass (wrap_t)
    border_dst1: np.ndarray
    border_src2: np.ndarray  # column pass (wrap_s, sees row borders)
    border_dst2: np.ndarray
    table: np.ndarray
    srgb: np.ndarray
    flat: np.ndarray
    wrap: np.ndarray

    @property
    def upload_bytes(self) -> int:
        """Host->device payload of realize_atlas — what actually crosses
        the link (the decision signal vs the full decoded atlas)."""
        return (self.blocks.nbytes
                + self.seg_start.nbytes + self.seg_base.nbytes
                + self.seg_bw.nbytes + self.seg_w.nbytes + self.seg_h.nbytes
                + self.raw_tiles.nbytes + self.raw_meta.nbytes
                + self.border_src1.nbytes + self.border_dst1.nbytes
                + self.border_src2.nbytes + self.border_dst2.nbytes)


def _mip_shapes(h: int, w: int, n: int) -> list[tuple[int, int]]:
    return [(max(h >> m, 1), max(w >> m, 1)) for m in range(n)]


def _tile_meta(x: int, y: int, w: int, h: int, aw: int, n_tiles: int):
    """Packed placement word per 4x4 tile of a (w, h) rect at atlas
    (x+1, y+1): top-left flat index << 4 | (valid_h-1) << 2 | (valid_w-1).
    The device derives all 16 texel destinations from this one u32 —
    per-texel index uploads would cost 4 bytes/texel, defeating the point."""
    bi = np.arange(n_tiles, dtype=np.int64)
    bw = (w + 3) // 4
    by, bx = bi // bw, bi % bw
    base = (y + 1 + by * 4) * aw + (x + 1 + bx * 4)
    vw = np.minimum(w - bx * 4, 4)
    vh = np.minimum(h - by * 4, 4)
    assert base.max() < (1 << (32 - _META_SHIFT)), "atlas too tall"
    return ((base << _META_SHIFT) | ((vh - 1) << 2) | (vw - 1)).astype(
        np.uint32)


def _border_indices(x0, y0, w, h, wrap_s, wrap_t, aw):
    """Flat (src, dst) index lists replaying atlas._with_mode_border /
    native.atlas_blit_wrap: pass 1 writes the top/bottom border rows from
    the rect's interior (wrap → opposite edge, clamp/mirror-at-1 → nearest
    edge); pass 2 writes the left/right border columns over the FULL
    bordered height, reading pass-1 results at the corners."""
    xs = np.arange(w, dtype=np.int64) + (x0 + 1)
    top_src_y = y0 + h if wrap_t == 0 else y0 + 1
    bot_src_y = y0 + 1 if wrap_t == 0 else y0 + h
    dst1 = np.concatenate([y0 * aw + xs, (y0 + h + 1) * aw + xs])
    src1 = np.concatenate([top_src_y * aw + xs, bot_src_y * aw + xs])

    ys = np.arange(h + 2, dtype=np.int64) + y0
    left_src_x = x0 + w if wrap_s == 0 else x0 + 1
    right_src_x = x0 + 1 if wrap_s == 0 else x0 + w
    dst2 = np.concatenate([ys * aw + x0, ys * aw + (x0 + w + 1)])
    src2 = np.concatenate([ys * aw + left_src_x, ys * aw + right_src_x])
    return src1, dst1, src2, dst2


def build_atlas_plan(registry: MaterialRegistry) -> AtlasPlan:
    """Host phase: shelf-pack (identical layout to atlas.build_atlas via the
    shared _plan_placements), gather block streams + placement meta + border
    indices. Decodes NO BC7 except one small mip per texture for the `flat`
    mean-color fallback."""
    from renderer_tpu.assets import ntex
    from renderer_tpu.materials import bc7_jax
    from renderer_tpu.raster.post import srgb_decode_np

    texs = dict(sorted(registry.textures.items()))
    blocks_of = {slot: tex.bc7_mips for slot, tex in texs.items()}
    shapes = {}
    for slot, tex in texs.items():
        bm = blocks_of[slot]
        if bm is not None:
            shapes[slot] = _mip_shapes(tex.height, tex.width, len(bm))[:MAX_MIPS]
        else:
            shapes[slot] = [img.shape[:2] for img in tex.mips[:MAX_MIPS]]
    placements, height = _plan_placements(shapes)
    ah, aw = max(height, 8), ATLAS_WIDTH

    table = np.zeros((constants.MAX_TEXTURES, MAX_MIPS, 4), np.int32)
    srgb = np.zeros(constants.MAX_TEXTURES, np.int32)
    flat = np.zeros((constants.MAX_TEXTURES, 4), np.float32)
    wrap = np.zeros((constants.MAX_TEXTURES, 2), np.int32)

    all_blocks: list[np.ndarray] = []
    seg_start: list[int] = [0]
    seg_base: list[int] = []
    seg_bw: list[int] = []
    seg_w: list[int] = []
    seg_h: list[int] = []
    raw_tiles: list[np.ndarray] = []
    raw_meta: list[np.ndarray] = []
    b_s1: list[np.ndarray] = []
    b_d1: list[np.ndarray] = []
    b_s2: list[np.ndarray] = []
    b_d2: list[np.ndarray] = []

    for slot, tex in texs.items():
        srgb[slot] = 1 if tex.kind == TextureKind.SRGB_COLOR else 0
        wrap[slot] = (tex.wrap_s, tex.wrap_t)
        bm = blocks_of[slot]
        n_mips = len(shapes[slot])

        # mean linear color from a small mip (the flat fallback) — for
        # block textures decode ONLY that one small mip
        small_i = min(n_mips - 1, max(n_mips - 5, 0))
        if bm is not None:
            sh, sw = shapes[slot][small_i]
            small_rgba = ntex._decode_bc7(bm[small_i].tobytes(), sw, sh)
        else:
            small_rgba = tex.mips[small_i]
        mean = small_rgba.reshape(-1, 4).astype(np.float64).mean(axis=0) / 255.0
        if srgb[slot]:
            mean[:3] = srgb_decode_np(mean[:3])
        flat[slot] = mean

        for mip in range(MAX_MIPS):
            src_mip = min(mip, n_mips - 1)
            h, w = shapes[slot][src_mip]
            x, y = placements[(slot, src_mip)]
            table[slot, mip] = (x + 1, y + 1, w, h)
            if mip != src_mip:
                continue
            if bm is not None:
                blocks = bm[src_mip]
                all_blocks.append(np.ascontiguousarray(blocks).view("<u4"))
                seg_start.append(seg_start[-1] + len(blocks))
                seg_base.append((y + 1) * aw + (x + 1))
                seg_bw.append((w + 3) // 4)
                seg_w.append(w)
                seg_h.append(h)
            else:
                texels = _pack_rgba(tex.mips[src_mip])  # [h, w] u32
                bw, bh = (w + 3) // 4, (h + 3) // 4
                padded = np.zeros((bh * 4, bw * 4), np.uint32)
                padded[:h, :w] = texels
                tiles = padded.reshape(bh, 4, bw, 4).transpose(
                    0, 2, 1, 3).reshape(-1, 16)
                raw_tiles.append(tiles)
                raw_meta.append(_tile_meta(x, y, w, h, aw, len(tiles)))
            s1, d1, s2, d2 = _border_indices(x, y, w, h, tex.wrap_s,
                                             tex.wrap_t, aw)
            b_s1.append(s1)
            b_d1.append(d1)
            b_s2.append(s2)
            b_d2.append(d2)

    blocks_cat = (np.concatenate(all_blocks) if all_blocks
                  else np.zeros((0, 4), np.uint32))
    # static per-mode group sizes (values only — the grouping itself
    # happens ON DEVICE via a stable argsort in realize_atlas)
    modes = bc7_jax.block_modes(blocks_cat.view(np.uint8).reshape(-1, 16)) \
        if len(blocks_cat) else np.zeros(0, np.int32)
    assert (modes < 8).all(), "invalid BC7 block (no mode bit) in stream"
    mode_counts = {int(m): int(c)
                   for m, c in zip(*np.unique(modes, return_counts=True))}

    def cat(parts, dtype):
        return (np.concatenate(parts).astype(dtype) if parts
                else np.zeros(0, dtype))

    return AtlasPlan(
        shape=(ah, aw),
        blocks=blocks_cat,
        mode_counts=mode_counts,
        seg_start=np.asarray(seg_start, np.int32),
        seg_base=np.asarray(seg_base if seg_base else [0], np.int32),
        seg_bw=np.asarray(seg_bw if seg_bw else [1], np.int32),
        seg_w=np.asarray(seg_w if seg_w else [4], np.int32),
        seg_h=np.asarray(seg_h if seg_h else [4], np.int32),
        raw_tiles=(np.concatenate(raw_tiles) if raw_tiles
                   else np.zeros((0, 16), np.uint32)),
        raw_meta=cat(raw_meta, np.uint32),
        border_src1=cat(b_s1, np.int32), border_dst1=cat(b_d1, np.int32),
        border_src2=cat(b_s2, np.int32), border_dst2=cat(b_d2, np.int32),
        table=table, srgb=srgb, flat=flat, wrap=wrap,
    )


def realize_atlas(plan: AtlasPlan):
    """One jitted device pass: derive modes + grouping + destinations on
    device, per-mode BC7 decode → scatter → borders. Returns the [AH, AW]
    u32 atlas ON DEVICE (never materialized on host).

    The block stream arrives in ORIGINAL rect order; the device computes
    each block's mode from its bytes, groups by mode with ONE stable
    argsort (group sizes are the static `mode_counts`, so every decode
    slice is static-shape), and derives each block's destination from the
    per-rect segment table with a searchsorted — no per-block metadata
    crosses the link (ROADMAP backlog D: this replaced 4 B/block of
    placement words, 24 MB at Sponza scale).

    Every plan array is device_put EXPLICITLY before the jit call; the
    zero-initialized atlas buffer is created
    outside the trace so the executable never embeds a huge constant
    (donating it is not possible — XLA picks a different internal
    layout)."""
    import functools

    import jax
    import jax.numpy as jnp

    from renderer_tpu.materials import bc7_jax

    ah, aw = plan.shape
    n_flat = ah * aw

    def scatter(flat, tiles, base, vw, vh):
        """Scatter [M, 16] texel tiles to base + tile-local offsets
        (valid-extent texels only; edge-crop texels land on the dump slot
        n_flat)."""
        t = jnp.arange(16, dtype=jnp.int32)
        ty, tx = t // 4, t % 4
        dest = base[:, None] + ty[None, :] * aw + tx[None, :]
        oob = (ty[None, :] >= vh[:, None]) | (tx[None, :] >= vw[:, None])
        dest = jnp.minimum(jnp.where(oob, n_flat, dest), n_flat)
        return flat.at[dest.reshape(-1)].set(tiles.reshape(-1))

    def scatter_meta(flat, tiles, meta):
        base = (meta >> np.uint32(_META_SHIFT)).astype(jnp.int32)
        vh = ((meta >> np.uint32(2)) & np.uint32(3)).astype(jnp.int32) + 1
        vw = (meta & np.uint32(3)).astype(jnp.int32) + 1
        return scatter(flat, tiles, base, vw, vh)

    @functools.partial(jax.jit, static_argnames=("counts",))
    def _realize(flat, blocks, seg_start, seg_base, seg_bw, seg_w, seg_h,
                 raw_tiles, raw_meta, bs1, bd1, bs2, bd2, counts: tuple):
        if blocks.shape[0]:
            # per-block mode = lowest set bit of byte 0 (bc7_jax.block_modes
            # semantics); host asserted every block has one
            byte0 = blocks[:, 0] & jnp.uint32(0xFF)
            bits = (byte0[:, None] >> jnp.arange(8, dtype=jnp.uint32)) & 1
            mode = jnp.argmax(bits, axis=1).astype(jnp.int32)
            # ONE stable sort groups the stream by mode; static counts make
            # each group a static slice
            perm = jnp.argsort(mode, stable=True)
            grouped = blocks[perm]
            off = 0
            for m, n_m in counts:
                seg = grouped[off:off + n_m]
                orig = perm[off:off + n_m]
                k = -(-n_m // DECODE_CHUNK)
                if k <= 1:
                    tex = bc7_jax.decode_mode(seg, m)
                else:
                    # fixed-size chunks under lax.map: the decode body is
                    # traced ONCE at DECODE_CHUNK width, so the compiled
                    # executable (and its compile-cache entry) does not
                    # grow with the number of decoded blocks
                    pad = k * DECODE_CHUNK - n_m
                    seg = jnp.pad(seg, ((0, pad), (0, 0)))
                    tex = jax.lax.map(
                        lambda b, m=m: bc7_jax.decode_mode(b, m),
                        seg.reshape(k, DECODE_CHUNK, 4),
                    ).reshape(-1, 16)[:n_m]
                # destination from the per-rect segment table
                r = jnp.searchsorted(seg_start, orig, side="right") - 1
                local = orig - seg_start[r]
                by = local // seg_bw[r]
                bx = local - by * seg_bw[r]
                base = seg_base[r] + by * 4 * aw + bx * 4
                vw = jnp.minimum(seg_w[r] - bx * 4, 4)
                vh = jnp.minimum(seg_h[r] - by * 4, 4)
                flat = scatter(flat, tex, base, vw, vh)
                off += n_m
        if raw_tiles.shape[0]:
            flat = scatter_meta(flat, raw_tiles, raw_meta)
        if bs1.shape[0]:
            flat = flat.at[bd1].set(flat[bs1])
            flat = flat.at[bd2].set(flat[bs2])
        return flat[:n_flat].reshape(ah, aw)

    counts = tuple(sorted((int(m), int(c))
                          for m, c in plan.mode_counts.items()))
    put = jnp.asarray  # explicit upload (see docstring)
    flat0 = jnp.zeros(n_flat + 1, jnp.uint32)
    return _realize(flat0, put(np.ascontiguousarray(plan.blocks)),
                    put(plan.seg_start), put(plan.seg_base),
                    put(plan.seg_bw), put(plan.seg_w), put(plan.seg_h),
                    put(plan.raw_tiles), put(plan.raw_meta),
                    put(plan.border_src1), put(plan.border_dst1),
                    put(plan.border_src2), put(plan.border_dst2),
                    counts=counts)


def _plan_cache_dir(registry: MaterialRegistry):
    base = _atlas_cache_file(registry)
    return base.with_name(base.name + "-plan")


def build_atlas_plan_cached(registry: MaterialRegistry) -> AtlasPlan:
    """Disk-cached plan (keyed by texture content fingerprints like the
    host atlas bundle): a warm startup reads raw arrays — no ntex parsing,
    no PIL, no packing."""
    import json

    cdir = _plan_cache_dir(registry)
    names = ("seg_start", "seg_base", "seg_bw", "seg_w", "seg_h",
             "raw_tiles", "raw_meta", "border_src1", "border_dst1",
             "border_src2", "border_dst2", "table", "srgb", "flat", "wrap")
    if cdir.is_dir():
        try:
            meta = json.loads((cdir / "meta.json").read_text())
            if meta.get("version") != 2:
                raise ValueError("plan cache format changed")
            kw = {n: np.load(cdir / f"{n}.npy", allow_pickle=False)
                  for n in names}
            blocks = np.load(cdir / "blocks.npy", mmap_mode="r",
                             allow_pickle=False)
            return AtlasPlan(
                shape=tuple(meta["shape"]), blocks=blocks,
                mode_counts={int(m): int(c)
                             for m, c in meta["mode_counts"].items()},
                **kw)
        except Exception:
            pass  # corrupt/stale/old-format → rebuild

    plan = build_atlas_plan(registry)
    try:
        import os

        cdir.parent.mkdir(parents=True, exist_ok=True)
        tmp = cdir.with_name(f"{cdir.name}.tmp{os.getpid()}")
        tmp.mkdir(exist_ok=True)
        for n in names:
            np.save(tmp / f"{n}.npy", getattr(plan, n), allow_pickle=False)
        np.save(tmp / "blocks.npy", plan.blocks, allow_pickle=False)
        (tmp / "meta.json").write_text(json.dumps(
            {"version": 2, "shape": list(plan.shape),
             "mode_counts": {str(m): int(c)
                             for m, c in plan.mode_counts.items()}}))
        try:
            os.replace(tmp, cdir)
        except OSError:
            # os.replace cannot overwrite a NON-EMPTY dir (ENOTEMPTY) — a
            # stale old-format cache would otherwise wedge the rebuild loop
            # forever: evict it and retry once.
            import shutil

            try:
                shutil.rmtree(cdir, ignore_errors=True)
                os.replace(tmp, cdir)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)
    except Exception:
        pass  # cache is an optimization only
    return plan
