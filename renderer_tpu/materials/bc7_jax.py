"""BC7 block decode as pure JAX integer ops — texture decompression ON the
device.

The reference samples BC7 natively all frame (the GPU's texture units
decode per tap — renderer/src/image_loading.rs:83-237,
physical_device.rs:18-19 list BC7 among the required formats). The
software sampler has no texture units, so this engine decodes ONCE at
startup into the RGBA atlas — but decoding on the HOST means uploading the
4x-larger decoded texels through the host→device link. This module moves
the decode to the device: upload the compressed block stream (1
byte/texel), decode every block in one jitted pass (vectorized bit plucking
+ integer interpolation — elementwise work), and scatter straight into the
packed atlas (materials/atlas_device.py).

Decode is EXACT by construction (the BC7 spec is integer-deterministic):
bit-parity with Pillow's reference bcn decoder is pinned for every mode by
tests/test_bc7_decode.py (constructed blocks for all 8 modes + real Sponza
ntex blocks). The partition/anchor constants live in bc7_tables.py,
recovered from the reference decoder with loud consistency checks
(tools/extract_bc7_tables.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from renderer_tpu.materials import bc7_tables as T

# Interpolation weight tables (BC7 spec): color = (lo*(64-w) + hi*w + 32)>>6
WEIGHTS = {
    2: np.array([0, 21, 43, 64], np.int32),
    3: np.array([0, 9, 18, 27, 37, 46, 55, 64], np.int32),
    4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60,
                 64], np.int32),
}

# Per-mode field parameters (BC7 spec layout, LSB-first):
# (subsets, partition bits, rotation bits, index-selection bits, color bits,
#  alpha bits, p-bit kind, index bits, secondary index bits)
MODES = {
    0: (3, 4, 0, 0, 4, 0, "unique", 3, 0),
    1: (2, 6, 0, 0, 6, 0, "shared", 3, 0),
    2: (3, 6, 0, 0, 5, 0, "none", 2, 0),
    3: (2, 6, 0, 0, 7, 0, "unique", 2, 0),
    4: (1, 0, 2, 1, 5, 6, "none", 2, 3),
    5: (1, 0, 2, 0, 7, 8, "none", 2, 2),
    6: (1, 0, 0, 0, 7, 7, "unique", 4, 0),
    7: (2, 6, 0, 0, 5, 5, "unique", 2, 0),
}


def block_modes(blocks_u8: np.ndarray) -> np.ndarray:
    """Host-side: the mode of each 16-byte block (index of the lowest set
    bit of byte 0; 8 = invalid all-zero byte, treated as mode-8 'reserved'
    which the spec decodes as transparent black — mapped to mode None)."""
    b0 = np.asarray(blocks_u8)[:, 0].astype(np.uint8)
    mode = np.full(b0.shape, 8, np.int32)
    for m in range(7, -1, -1):
        mode = np.where(
            (b0 & ((1 << (m + 1)) - 1)) == (1 << m), m, mode
        )
    return mode


def _get(blocks, off: int, n: int):
    """Static-offset field extraction: blocks [N, 4] u32 (128-bit block as
    4 LE words), returns [N] u32 of the n bits at LSB-first offset off."""
    w, s = off // 32, off % 32
    v = blocks[:, w] >> np.uint32(s)
    if s and s + n > 32:
        v = v | (blocks[:, w + 1] << np.uint32(32 - s))
    return v & np.uint32((1 << n) - 1)


def _get_dyn(blocks, off, width):
    """Dynamic field extraction: off/width [N, 16] i32 (per-texel index
    fields whose offsets depend on the block's partition via the anchor
    tables). Width ≤ 4 so a field spans at most 2 words."""
    word = off >> 5
    s = (off & 31).astype(jnp.uint32)
    w0 = jnp.take_along_axis(blocks, word, axis=1)
    w1 = jnp.take_along_axis(blocks, jnp.minimum(word + 1, 3), axis=1)
    lo = w0 >> s
    hi = jnp.where(s == 0, jnp.uint32(0),
                   w1 << ((np.uint32(32) - s) & np.uint32(31)))
    mask = (jnp.uint32(1) << width.astype(jnp.uint32)) - jnp.uint32(1)
    return (lo | hi) & mask


def _expand(v, n: int):
    """Endpoint dequantization: left-align the n-bit value to 8 bits and
    replicate the top bits (v8 = v<<(8-n) | v>>(2n-8); exact spec rule —
    every BC7 endpoint incl. p-bit is 5-8 bits, so 2n-8 >= 2 or n == 8)."""
    assert 5 <= n <= 8, n
    v = v.astype(jnp.uint32)
    return (v << np.uint32(8 - n)) | (v >> np.uint32(2 * n - 8))


def _texel_index_fields(part, anchors, ibits: int, idx_start: int):
    """Per-texel (offset, width) of the primary index fields: anchors
    (texel 0 + the partition's anchor positions) drop their MSB."""
    n = part.shape[0]
    t = jnp.arange(16, dtype=jnp.int32)[None, :]
    width = jnp.full((n, 16), ibits, jnp.int32)
    width = jnp.where(t == 0, ibits - 1, width)
    for a in anchors:
        width = jnp.where(t == a[:, None], ibits - 1, width)
    off = idx_start + jnp.cumsum(width, axis=1) - width
    return off, width


@functools.partial(jax.jit, static_argnames=("mode",))
def decode_mode(blocks: jnp.ndarray, mode: int) -> jnp.ndarray:
    """Decode [N, 4] u32 blocks of ONE static mode → [N, 16] u32 RGBA8
    texels in 4x4 raster order."""
    (ns, pb, rb, isb, cb, ab, pkind, ib, ib2) = MODES[mode]
    blocks = blocks.astype(jnp.uint32)
    n = blocks.shape[0]
    cur = mode + 1

    part = _get(blocks, cur, pb).astype(jnp.int32) if pb else jnp.zeros(
        n, jnp.int32)
    cur += pb
    rot = _get(blocks, cur, rb).astype(jnp.int32) if rb else None
    cur += rb
    ism = _get(blocks, cur, isb).astype(jnp.int32) if isb else None
    cur += isb

    # endpoints: channel-major, then per-endpoint p-bits
    ne = 2 * ns
    channels = 3 + (1 if ab else 0)
    raw = []  # [channels][ne] of [N] u32
    for c in range(channels):
        bits = ab if c == 3 else cb
        row = []
        for _e in range(ne):
            row.append(_get(blocks, cur, bits))
            cur += bits
        raw.append(row)
    if pkind == "unique":
        pbits = []
        for _e in range(ne):
            pbits.append(_get(blocks, cur, 1))
            cur += 1
    elif pkind == "shared":
        shared = []
        for _s in range(ns):
            shared.append(_get(blocks, cur, 1))
            cur += 1
        pbits = [shared[e // 2] for e in range(ne)]
    else:
        pbits = None

    # dequantize to 8 bits
    ep = np.empty((channels, ne), object)
    for c in range(channels):
        bits = ab if c == 3 else cb
        for e in range(ne):
            v = raw[c][e]
            if pbits is not None:
                v = (v << np.uint32(1)) | pbits[e]
                ep[c, e] = _expand(v, bits + 1)
            else:
                ep[c, e] = _expand(v, bits)

    # index fields
    if ns == 1:
        anchors = []
    elif ns == 2:
        anchors = [jnp.asarray(T.ANCHOR_2)[part]]
    else:
        anchors = [jnp.asarray(T.ANCHOR_3_2)[part],
                   jnp.asarray(T.ANCHOR_3_3)[part]]
    off, width = _texel_index_fields(part, anchors, ib, cur)
    idx = _get_dyn(blocks, off, width).astype(jnp.int32)  # [N, 16]
    cur += 16 * ib - 1 - len(anchors)
    if ib2:
        off2, width2 = _texel_index_fields(part, [], ib2, cur)
        idx2 = _get_dyn(blocks, off2, width2).astype(jnp.int32)
    else:
        idx2 = None

    # subset of each texel
    if ns == 1:
        sub = jnp.zeros((n, 16), jnp.int32)
    elif ns == 2:
        sub = jnp.asarray(T.PARTITION_2)[part]
    else:
        sub = jnp.asarray(T.PARTITION_3)[part]

    def interp(channel: int, indices, ibits_used: int):
        lo = jnp.stack([ep[channel, 2 * s] for s in range(ns)], axis=1)
        hi = jnp.stack([ep[channel, 2 * s + 1] for s in range(ns)], axis=1)
        lo = jnp.take_along_axis(lo.astype(jnp.int32), sub, axis=1)
        hi = jnp.take_along_axis(hi.astype(jnp.int32), sub, axis=1)
        w = jnp.asarray(WEIGHTS[ibits_used])[indices]
        return (lo * (64 - w) + hi * w + 32) >> 6  # [N, 16] i32

    if mode == 4:
        # index-selection bit: 0 → color from the 2-bit set, alpha from the
        # 3-bit set; 1 → swapped
        c2 = [interp(c, idx, ib) for c in range(3)]
        c3 = [interp(c, idx2, ib2) for c in range(3)]
        a2 = interp(3, idx, ib)
        a3 = interp(3, idx2, ib2)
        swap = (ism == 1)[:, None]
        rgb = [jnp.where(swap, c3[c], c2[c]) for c in range(3)]
        alpha = jnp.where(swap, a2, a3)
    elif mode == 5:
        rgb = [interp(c, idx, ib) for c in range(3)]
        alpha = interp(3, idx2, ib2)
    else:
        rgb = [interp(c, idx, ib) for c in range(3)]
        alpha = (interp(3, idx, ib) if ab
                 else jnp.full((n, 16), 255, jnp.int32))

    if rot is not None:
        # rotation swaps alpha with one color channel (modes 4/5)
        r = rot[:, None]
        out_rgb = []
        for c in range(3):
            out_rgb.append(jnp.where(r == c + 1, alpha, rgb[c]))
        alpha = jnp.where(
            r == 0, alpha,
            jnp.where(r == 1, rgb[0], jnp.where(r == 2, rgb[1], rgb[2])),
        )
        rgb = out_rgb

    out = (rgb[0].astype(jnp.uint32)
           | (rgb[1].astype(jnp.uint32) << np.uint32(8))
           | (rgb[2].astype(jnp.uint32) << np.uint32(16))
           | (alpha.astype(jnp.uint32) << np.uint32(24)))
    return out


def decode_blocks_np(blocks_u8: np.ndarray) -> np.ndarray:
    """Host convenience (tests): decode a [N, 16] u8 block array of mixed
    modes → [N, 16] u32 texels, dispatching per mode; reserved/invalid
    blocks decode to transparent black (spec behavior)."""
    blocks_u8 = np.ascontiguousarray(blocks_u8, np.uint8)
    words = blocks_u8.view("<u4")  # [N, 4]
    modes = block_modes(blocks_u8)
    out = np.zeros((blocks_u8.shape[0], 16), np.uint32)
    for m in range(8):
        sel = np.nonzero(modes == m)[0]
        if sel.size:
            out[sel] = np.asarray(decode_mode(jnp.asarray(words[sel]), m))
    return out
