"""Independent pure-numpy reference rasterizer — the test oracle.

Deliberately written with different code paths than the renderer (per-pixel
barycentric point-in-triangle loops instead of edge-plane kernels) so golden
comparisons cross-validate the JAX implementation rather than echo it.
"""

from __future__ import annotations

import numpy as np


def project(clip: np.ndarray, width: int, height: int):
    """clip [N,4] → (screen xy [N,2], ndc depth [N], w [N])."""
    w = clip[:, 3]
    ndc = clip[:, :3] / w[:, None]
    x = (ndc[:, 0] * 0.5 + 0.5) * width
    y = (ndc[:, 1] * 0.5 + 0.5) * height
    return np.stack([x, y], axis=1), ndc[:, 2], w


def rasterize(
    tri_verts_clip: np.ndarray,  # [T,3,4] clip-space triangles
    width: int,
    height: int,
    cull_backface: bool = True,
    sample_offset: tuple = (0.5, 0.5),  # in-pixel evaluation point (MSAA)
):
    """Returns (tri_id [H,W] (-1 background), depth [H,W], bary [H,W,3]
    perspective-correct). Front face = negative shoelace area in y-down
    screen coords (Vulkan CCW). `sample_offset` moves the per-pixel
    evaluation point off the center (call once per MSAA sample position)."""
    tri_id = np.full((height, width), -1, np.int64)
    depth = np.zeros((height, width), np.float64)
    bary = np.zeros((height, width, 3), np.float64)

    for t in range(tri_verts_clip.shape[0]):
        c = tri_verts_clip[t].astype(np.float64)
        if np.any(c[:, 3] <= 1e-6):
            continue
        xy, z, w = project(c, width, height)
        # shoelace (y-down): front faces are negative
        a2 = (
            (xy[0, 0] * xy[1, 1] - xy[1, 0] * xy[0, 1])
            + (xy[1, 0] * xy[2, 1] - xy[2, 0] * xy[1, 1])
            + (xy[2, 0] * xy[0, 1] - xy[0, 0] * xy[2, 1])
        )
        if cull_backface and a2 >= 0:
            continue
        x0 = max(int(np.floor(xy[:, 0].min())), 0)
        x1 = min(int(np.ceil(xy[:, 0].max())), width - 1)
        y0 = max(int(np.floor(xy[:, 1].min())), 0)
        y1 = min(int(np.ceil(xy[:, 1].max())), height - 1)
        for py in range(y0, y1 + 1):
            for px in range(x0, x1 + 1):
                p = np.array([px + sample_offset[0], py + sample_offset[1]])
                # barycentric via sub-triangle areas
                def tri_area(a, b):
                    return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])

                e0 = tri_area(xy[1], xy[2])
                e1 = tri_area(xy[2], xy[0])
                e2 = tri_area(xy[0], xy[1])
                if not ((e0 <= 0 and e1 <= 0 and e2 <= 0) or (e0 >= 0 and e1 >= 0 and e2 >= 0)):
                    continue
                s = e0 + e1 + e2
                if s == 0:
                    continue
                lam = np.array([e0, e1, e2]) / s
                zp = float(lam @ z)
                if zp < 0.0 or zp > 1.0:
                    continue
                if zp >= depth[py, px] and (tri_id[py, px] >= 0 or zp >= 0.0):
                    if tri_id[py, px] < 0 or zp >= depth[py, px]:
                        depth[py, px] = zp
                        tri_id[py, px] = t
                        lp = lam / w
                        bary[py, px] = lp / lp.sum()
    return tri_id, depth, bary


def aces_srgb_u8(linear_rgb: np.ndarray, exposure: float = 0.8) -> np.ndarray:
    x = linear_rgb * exposure
    mapped = np.clip((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0, 1)
    enc = np.where(mapped <= 0.0031308, mapped * 12.92, 1.055 * mapped ** (1 / 2.4) - 0.055)
    return np.round(np.clip(enc, 0, 1) * 255).astype(np.uint8)
