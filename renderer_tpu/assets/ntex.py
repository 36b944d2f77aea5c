"""ntex texture container decoder.

Parity: renderer/src/image_loading/ntex.rs — 1024-byte header (40-byte magic
string, then w/h/depth/mips/VkFormat/block dims at offsets 992-1024), followed
by tightly packed mip levels. The reference samples BC7 blocks directly in
its fixed-function sampler; this renderer's software sampler reads RGBA8, so
mips are decoded at load time (BC7 through materials/bc7_jax.py, the same
decoder the device-decode atlas path runs).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = b"The GPU decodable image container format"

# VkFormat ids used by ntex files (physical_device.rs:18-19 TEXTURE_FORMATS).
VK_FORMAT_R8_UNORM = 9
VK_FORMAT_R8G8B8A8_UNORM = 37
VK_FORMAT_R8G8B8A8_SRGB = 43
VK_FORMAT_BC7_UNORM = 145
VK_FORMAT_BC7_SRGB = 146


class NtexDecodeError(Exception):
    pass


@dataclass
class NtexHeader:
    width: int
    height: int
    depth: int
    mip_levels: int
    vk_format: int
    block_width: int
    block_height: int
    block_size: int

    def mip_ranges(self) -> list[tuple[int, int]]:
        """Byte ranges of each mip relative to the pixel data (ntex.rs:60-72)."""
        ranges = []
        offset = 0
        for mip in range(self.mip_levels):
            mw = self.width >> mip
            mh = self.height >> mip
            size = (
                int(np.ceil(mw / self.block_width))
                * int(np.ceil(mh / self.block_height))
                * self.block_size
            )
            ranges.append((offset, offset + size))
            offset += size
        return ranges


def decode_header(data: bytes) -> NtexHeader:
    if len(data) < 1024 or data[:40] != MAGIC:
        raise NtexDecodeError("invalid ntex header")
    w, h, d, mips, fmt, bw, bh, bs = struct.unpack("<8I", data[992:1024])
    if d != 1:
        raise NtexDecodeError(f"ntex depth {d} not supported")
    return NtexHeader(w, h, d, mips, fmt, bw, bh, bs)


def _decode_bc7(block_data: bytes, width: int, height: int) -> np.ndarray:
    """BC7 blocks (row-major over the 4×4 block grid) → [h, w, 4] u8."""
    from renderer_tpu.materials.bc7_jax import decode_blocks_np

    bw = max(1, (width + 3) // 4)
    bh = max(1, (height + 3) // 4)
    blocks = np.frombuffer(block_data, np.uint8).reshape(bh * bw, 16)
    texels = decode_blocks_np(blocks)  # [nb, 16] u32 RGBA, texel = 4y + x
    img = texels.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3)
    img = np.ascontiguousarray(img).reshape(bh * 4, bw * 4)
    rgba = img.astype("<u4").view(np.uint8).reshape(bh * 4, bw * 4, 4)
    return rgba[:height, :width].copy()


def decode(data: bytes) -> tuple[NtexHeader, list[np.ndarray]]:
    """Returns (header, [mip0, mip1, ...]) with each mip an [h, w, 4] u8 RGBA
    array (R8 broadcast to RGB with alpha=R for font-style textures; the
    reference binds R8 directly and the imgui shader reads .r)."""
    header = decode_header(data)
    pixels = data[1024:]
    ranges = header.mip_ranges()
    expected = ranges[-1][1]
    if len(pixels) != expected:
        raise NtexDecodeError(
            f"ntex length mismatch: expected {expected + 1024}, got {len(data)}"
        )

    mips = []
    for mip, (start, end) in enumerate(ranges):
        mw = max(header.width >> mip, 1)
        mh = max(header.height >> mip, 1)
        raw = pixels[start:end]
        if header.vk_format in (VK_FORMAT_BC7_UNORM, VK_FORMAT_BC7_SRGB):
            mips.append(_decode_bc7(raw, mw, mh))
        elif header.vk_format in (VK_FORMAT_R8G8B8A8_UNORM, VK_FORMAT_R8G8B8A8_SRGB):
            mips.append(np.frombuffer(raw, np.uint8).reshape(mh, mw, 4).copy())
        elif header.vk_format == VK_FORMAT_R8_UNORM:
            r = np.frombuffer(raw, np.uint8).reshape(mh, mw)
            rgba = np.empty((mh, mw, 4), np.uint8)
            rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = r
            rgba[..., 3] = r
            mips.append(rgba)
        else:
            raise NtexDecodeError(f"unsupported VkFormat {header.vk_format}")
    return header, mips


def read_blocks(data: bytes) -> tuple[NtexHeader, list[np.ndarray] | None]:
    """Raw compressed mip payloads WITHOUT decoding: returns (header,
    [blocks_u8 [nb, 16] per mip]) for BC7 files, (header, None) for
    non-block formats. The device-side decode path
    (materials/bc7_jax + atlas_device) uploads these 1-byte/texel blocks
    and decodes on-chip instead of uploading 4-byte/texel decoded RGBA."""
    header = decode_header(data)
    if header.vk_format not in (VK_FORMAT_BC7_UNORM, VK_FORMAT_BC7_SRGB):
        return header, None
    pixels = data[1024:]
    ranges = header.mip_ranges()
    if len(pixels) != ranges[-1][1]:
        raise NtexDecodeError(
            f"ntex length mismatch: expected {ranges[-1][1] + 1024}, "
            f"got {len(data)}"
        )
    mips = [
        np.frombuffer(pixels[start:end], np.uint8).reshape(-1, 16)
        for start, end in ranges
    ]
    return header, mips


def read_blocks_file(path) -> tuple[NtexHeader, list[np.ndarray] | None]:
    with open(path, "rb") as f:
        return read_blocks(f.read())


def is_srgb_format(vk_format: int) -> bool:
    return vk_format in (VK_FORMAT_BC7_SRGB, VK_FORMAT_R8G8B8A8_SRGB)


# -- decoded-texture cache (SURVEY §5.4: the reference ships textures
# pre-compressed so startup never encodes; the software sampler additionally
# can't SAMPLE BC7, so the analog is shipping them pre-DECODED — a per-file npz
# of RGBA8 mips keyed by (path, size, mtime), turning the BC7 decode of a
# Sponza startup into a handful of mmap'd reads) ---------------------------

def _cache_dir():
    import os
    from pathlib import Path

    root = os.environ.get("RENDERER_TPU_CACHE")
    if root:
        return Path(root) / "ntex"
    return Path(__file__).resolve().parents[2] / ".cache" / "ntex"


def decode_header_file(path) -> NtexHeader:
    """Header-only read (the reference's measure-phase mmap of the first
    1 KiB, gltf/src/lib.rs:393-409) — no pixel decode."""
    with open(path, "rb") as f:
        return decode_header(f.read(2048))


def file_fingerprint(path) -> str:
    """Cheap content identity for cache keys: absolute path + size + mtime."""
    from pathlib import Path

    p = Path(path)
    st = p.stat()
    return f"{p.resolve()}|{st.st_size}|{st.st_mtime_ns}"


def decode_file(path, cache: bool = True) -> tuple[NtexHeader, list[np.ndarray]]:
    """decode() for an on-disk ntex file, with a decoded-mips disk cache."""
    import hashlib
    from pathlib import Path

    path = Path(path)
    if not cache:
        return decode(path.read_bytes())
    st = path.stat()
    fp = f"{path.resolve()}|{st.st_size}|{st.st_mtime_ns}|v1"
    cdir = _cache_dir()
    cfile = cdir / (hashlib.sha1(fp.encode()).hexdigest() + ".npz")
    if cfile.exists():
        try:
            with np.load(cfile, allow_pickle=False) as z:
                meta = z["header"]
                header = NtexHeader(*(int(v) for v in meta))
                mips = [z[f"mip{i}"] for i in range(header.mip_levels)]
            return header, mips
        except Exception:
            pass  # corrupt/stale cache entry → fall through to re-decode
    header, mips = decode(path.read_bytes())
    try:
        cdir.mkdir(parents=True, exist_ok=True)
        tmp = cfile.with_suffix(".tmp.npz")
        meta = np.array(
            [header.width, header.height, header.depth, header.mip_levels,
             header.vk_format, header.block_width, header.block_height,
             header.block_size], np.int64,
        )
        np.savez(tmp, header=meta,
                 **{f"mip{i}": m for i, m in enumerate(mips)})
        tmp.replace(cfile)
    except Exception:
        pass  # cache is an optimization only
    return header, mips
