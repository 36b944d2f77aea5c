"""Device-side BC7 decode: spec-table provenance, bit-parity with the
reference decoder (Pillow's bcn) for every mode, and the device-decoded
atlas reproducing the host atlas byte-for-byte."""

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import renderer_tpu as rt
from renderer_tpu.materials import bc7_jax

REF = Path("/root/reference/examples/sandbox/src")
needs_assets = pytest.mark.skipif(not REF.exists(),
                                  reason="reference assets not mounted")


def _pil_available() -> bool:
    try:
        from tools.extract_bc7_tables import decode_block

        decode_block(bytes([0x20] + [0] * 15))
        return True
    except Exception:
        return False


needs_bcn = pytest.mark.skipif(not _pil_available(),
                               reason="Pillow bcn decoder unavailable")


@needs_bcn
def test_tables_match_reference_extraction():
    """The committed bc7_tables.py literals must equal a fresh extraction
    from Pillow's reference decoder (tools/extract_bc7_tables) — the
    generated file can never drift silently."""
    from renderer_tpu.materials import bc7_tables as committed
    from tools.extract_bc7_tables import extract_all

    for name, arr in extract_all().items():
        np.testing.assert_array_equal(arr, getattr(committed, name), name)


@needs_bcn
def test_all_modes_bit_parity_fuzz():
    """Random blocks of EVERY mode (any bit pattern after the mode prefix is
    a valid block) must decode bit-identically to Pillow."""
    from tools.extract_bc7_tables import decode_block

    rng = np.random.default_rng(11)
    for m in range(8):
        n = 128
        blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
        blocks[:, 0] = ((1 << m) | (blocks[:, 0] << (m + 1))) & 0xFF
        ours = bc7_jax.decode_blocks_np(blocks)
        for i in range(n):
            ref = np.ascontiguousarray(
                decode_block(blocks[i].tobytes()).reshape(16, 4)
            ).view("<u4")[:, 0]
            np.testing.assert_array_equal(ours[i], ref, f"mode {m} block {i}")


def _pil_decode_bc7(block_data: bytes, width: int, height: int):
    """The reference decoder (Pillow's bcn) for a whole BC7 image: the test
    oracle of ntex._decode_bc7."""
    from PIL import Image

    # Pillow requires dimensions ≥ block size for bcn; pad and crop.
    pw = max(4, (width + 3) // 4 * 4)
    ph = max(4, (height + 3) // 4 * 4)
    img = Image.frombytes("RGBA", (pw, ph), block_data, "bcn", (7, ""))
    return np.asarray(img)[:height, :width]


@needs_bcn
def test_ntex_bc7_image_decode_matches_pillow():
    """ntex's BC7 image decode (bc7_jax blocks + block-grid placement +
    crop) equals Pillow's on random blocks of every mode at sizes that are
    not multiples of the block size."""
    from renderer_tpu.assets import ntex

    rng = np.random.default_rng(5)
    for h, w in ((13, 22), (4, 4), (2, 9), (1, 1)):
        nb = max(1, -(-h // 4)) * max(1, -(-w // 4))
        blocks = rng.integers(0, 256, (nb, 16), dtype=np.uint8)
        m = rng.integers(0, 8, nb)
        blocks[:, 0] = ((1 << m) | (blocks[:, 0] << (m + 1))) & 0xFF
        np.testing.assert_array_equal(
            ntex._decode_bc7(blocks.tobytes(), w, h),
            _pil_decode_bc7(blocks.tobytes(), w, h), f"{h}x{w}")


@needs_assets
@needs_bcn
def test_real_ntex_mips_bit_parity():
    """Real Sponza BC7 data (intel_tex 'slow' encoder output uses all 8
    modes) must decode identically to Pillow's decode of the same mips."""
    from renderer_tpu.assets import ntex

    f = sorted((REF / "sponza/glTF").glob("*.ntex"))[0]
    data = f.read_bytes()
    header, mips = ntex.decode(data)
    _, blocks = ntex.read_blocks(data)
    assert blocks is not None
    for mip in (0, 3, len(mips) - 1):
        h, w = mips[mip].shape[:2]
        ref = _pil_decode_bc7(blocks[mip].tobytes(), w, h)
        np.testing.assert_array_equal(mips[mip], ref, f"mip {mip}")


def _checker(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[..., 3] = 255
    return img


def _bc7_texture(name, h, w, kind, wrap_s=0, wrap_t=0, seed=0):
    """A synthetic BC7-backed Texture: mips encoded with the repo's mode-6
    encoder; the decoded-mips loader decodes the same blocks so host and
    device paths see identical content."""
    from renderer_tpu.assets import ntex
    from renderer_tpu.tools import native

    blocks = []
    shapes = []
    mh, mw = h, w
    while True:
        img = _checker(mh, mw, seed + len(blocks))
        blocks.append(native.bc7_encode_mode6(img).reshape(-1, 16))
        shapes.append((mh, mw))
        if mh == 1 and mw == 1:
            break
        mh, mw = max(mh // 2, 1), max(mw // 2, 1)

    def load_mips():
        return [ntex._decode_bc7(b.tobytes(), sw, sh)
                for b, (sh, sw) in zip(blocks, shapes)]

    return rt.Texture(None, kind, name=name, loader=load_mips,
                      shape=(h, w), fingerprint=f"test:{name}",
                      wrap_s=wrap_s, wrap_t=wrap_t,
                      blocks_loader=lambda: blocks)


def _device_atlas_vs_host(registry):
    from renderer_tpu.materials.atlas import _build_atlas_uncached
    from renderer_tpu.materials.atlas_device import (
        build_atlas_plan,
        realize_atlas,
    )

    host = _build_atlas_uncached(registry)
    plan = build_atlas_plan(registry)
    dev = np.asarray(realize_atlas(plan))
    assert dev.shape == host.data.shape
    np.testing.assert_array_equal(plan.table, host.table)
    np.testing.assert_array_equal(plan.srgb, host.srgb)
    np.testing.assert_array_equal(plan.wrap, host.wrap)
    np.testing.assert_allclose(plan.flat, host.flat, atol=1e-6)
    mismatch = (dev != host.data).sum()
    assert mismatch == 0, f"{mismatch} atlas texels differ"


@needs_bcn
def test_device_atlas_matches_host_synthetic():
    """Device-decoded atlas == host atlas, byte for byte: BC7 textures with
    non-block-aligned dims (edge-crop scatter), every wrap-mode border
    composition, and a plain RGBA texture through the raw-texel path."""
    registry = rt.MaterialRegistry()
    registry.register_texture(_bc7_texture("a", 37, 29, rt.TextureKind.SRGB_COLOR, seed=1))
    registry.register_texture(_bc7_texture("b", 16, 64, rt.TextureKind.LINEAR_COLOR,
                                           wrap_s=1, wrap_t=2, seed=2))
    registry.register_texture(_bc7_texture("c", 4, 4, rt.TextureKind.NORMAL_MAP,
                                           wrap_s=2, wrap_t=0, seed=3))
    mips = [_checker(24, 24, 9)]
    while mips[-1].shape[0] > 1:
        mips.append(mips[-1][::2, ::2])
    registry.register_texture(
        rt.Texture(mips, rt.TextureKind.SRGB_COLOR, name="raw", wrap_s=1))
    _device_atlas_vs_host(registry)


@needs_assets
@needs_bcn
def test_device_atlas_matches_host_real_ntex():
    """Same equality on real Sponza ntex textures (all 8 BC7 modes, full
    mip chains, lazy loaders)."""
    from renderer_tpu.assets import ntex

    registry = rt.MaterialRegistry()
    for i, f in enumerate(sorted((REF / "sponza/glTF").glob("*.ntex"))[:3]):
        header = ntex.decode_header_file(f)
        registry.register_texture(rt.Texture(
            None, rt.TextureKind.SRGB_COLOR, name=f.name,
            loader=lambda p=f: ntex.decode_file(p, cache=False)[1],
            shape=(header.height, header.width),
            fingerprint=ntex.file_fingerprint(f),
            blocks_loader=lambda p=f: ntex.read_blocks_file(p)[1],
        ))
    _device_atlas_vs_host(registry)


@needs_bcn
def test_renderer_device_atlas_renders_identically(monkeypatch):
    """End to end: RENDERER_TPU_ATLAS=device must produce the same frame as
    the host path (the Renderer integration, incl. the sampler consuming
    the device-realized atlas)."""
    from renderer_tpu.core import math3d

    def build(mode):
        monkeypatch.setenv("RENDERER_TPU_ATLAS", mode)
        registry = rt.MaterialRegistry()
        tex = _bc7_texture("t", 32, 32, rt.TextureKind.SRGB_COLOR, seed=5)
        registry.register_texture(tex)
        builder = rt.VertexLibraryBuilder()
        half, z = 0.8, 1.2
        p = np.array([[-half, half, z], [half, half, z],
                      [-half, -half, z], [half, -half, z]], np.float32)
        uv = np.array([[0, 1], [1, 1], [0, 0], [1, 0]], np.float32)
        nrm = np.tile([0, 0, -1.0], (4, 1)).astype(np.float32)
        t4 = np.tile([1, 0, 0, 1.0], (4, 1)).astype(np.float32)
        idx = np.array([0, 1, 2, 2, 1, 3], np.uint32)
        mesh = builder.add_mesh(p, uv, nrm, t4, idx)
        builder.build()
        mat = registry.create_material(
            "m", rt.PbrMaterialParameters(base_color=tex))
        scene = rt.Scene()
        scene.queue_mesh(mesh, mat, None, math3d.IDENTITY)
        r = rt.Renderer(registry,
                        rt.RenderConfig(width=128, height=64, tile_h=16))
        return r.render_frame(scene, debug_mode=1)

    np.testing.assert_array_equal(build("host"), build("device"))


@needs_bcn
def test_plan_cache_evicts_stale_format_dir(monkeypatch, tmp_path):
    """A stale old-format plan-cache directory must be REPLACED on rebuild,
    not wedge the cache forever: os.replace cannot overwrite a non-empty
    dir (ENOTEMPTY), so without explicit eviction every startup would pay
    the full plan rebuild while the v1 dir persists (regression: round-5
    version bump to 2)."""
    from renderer_tpu.materials import atlas_device

    monkeypatch.setenv("RENDERER_TPU_CACHE", str(tmp_path))
    registry = rt.MaterialRegistry()
    registry.register_texture(
        _bc7_texture("t", 16, 16, rt.TextureKind.SRGB_COLOR, seed=9))

    cdir = atlas_device._plan_cache_dir(registry)
    cdir.mkdir(parents=True)
    (cdir / "meta.json").write_text('{"version": 1}')
    (cdir / "stale.npy").write_bytes(b"junk")  # non-empty → ENOTEMPTY

    import json
    plan1 = atlas_device.build_atlas_plan_cached(registry)
    meta = json.loads((cdir / "meta.json").read_text())
    assert meta["version"] == 2, "stale cache dir was not replaced"
    assert not (cdir / "stale.npy").exists()

    # second call must LOAD the v2 cache (never rebuild): poison the
    # builder so a rebuild would fail loudly
    monkeypatch.setattr(atlas_device, "build_atlas_plan",
                        lambda r: (_ for _ in ()).throw(
                            AssertionError("cache miss: rebuild ran")))
    plan2 = atlas_device.build_atlas_plan_cached(registry)
    np.testing.assert_array_equal(np.asarray(plan1.blocks),
                                  np.asarray(plan2.blocks))
    np.testing.assert_array_equal(plan1.table, plan2.table)
    assert plan1.mode_counts == plan2.mode_counts
