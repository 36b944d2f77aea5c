"""A Sponza-scale demo scene generated from a seed, with no outside file.

Shape source: the reference sandbox's demo (examples/sandbox/src/main.rs:
Sponza + the animated Smol Ame at 4×MSAA) as this repo records it — Sponza's
26 draws and 263k triangles (README), the skinned character with two layered
animations (assets/proxy.make_skinned_character). The demo's own assets are
not in the repository, so:

- geometry: 26 coherent procedural patches (assets/proxy._patch_geometry)
  laid out as an atrium — floor, walls, arcades, columns — with per-draw
  triangle counts drawn from the seed and summing to SPONZA_TRIANGLES;
- textures: procedural sRGB base colours, tangent-space normal maps and
  metallic-roughness maps, each with a full mip chain; one base colour is
  BC7-encoded in-process (renderer_tpu.tools.native), so the device BC7
  decode runs;
- alpha classes: opaque, alpha-to-coverage (foliage-like cut-outs) and
  blended draws, where the blended panes stack deeper than the default 4
  captured layers.
"""

from __future__ import annotations

import numpy as np

from renderer_tpu.assets import proxy
from renderer_tpu.core import math3d
from renderer_tpu.geometry.vertex_library import VertexLibraryBuilder
from renderer_tpu.materials.registry import (
    AlphaMode,
    MaterialRegistry,
    PbrMaterialParameters,
    Texture,
    TextureKind,
)

SPONZA_DRAWS = 26
SPONZA_TRIANGLES = 263_000
N_MASKED = 3
N_BLENDED = 3
BLEND_PANES = 6  # translucent panes per blended draw (stack depth)
TEXTURE_SETS = 8


def _mips(base: np.ndarray) -> list[np.ndarray]:
    """Full 2×2 box-filtered mip chain down to 1×1."""
    mips = [base]
    m = base.astype(np.float32)
    while m.shape[0] > 1 or m.shape[1] > 1:
        h, w = max(m.shape[0] // 2, 1), max(m.shape[1] // 2, 1)
        m = m[: h * 2, : w * 2].reshape(h, m.shape[0] // h, w,
                                        m.shape[1] // w, 4).mean(axis=(1, 3))
        mips.append(np.round(m).astype(np.uint8))
    return mips


def _base_color(rng, size: int, alpha_holes: bool = False) -> np.ndarray:
    """Stone/brick-like albedo: tinted brick rows with per-brick noise."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    rows = 8 + int(rng.integers(0, 8))
    brick_y = np.floor(yy * rows)
    brick_x = np.floor(xx * rows / 2 + 0.5 * (brick_y % 2))
    mortar = ((yy * rows) % 1.0 < 0.06) | ((xx * rows / 2 + 0.5 * (brick_y % 2)) % 1.0 < 0.03)
    tint = rng.uniform(0.35, 0.9, 3)
    hash_ = np.sin(brick_x * 12.9898 + brick_y * 78.233) * 43758.5453
    jitter = (hash_ - np.floor(hash_))[..., None] * 0.3 + 0.7
    noise = rng.uniform(0.9, 1.1, (size, size, 1))
    rgb = np.where(mortar[..., None], 0.8, tint * jitter * noise)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    if alpha_holes:
        # leaf-like cut-outs: alpha from a low-frequency sine field
        f = (np.sin(xx * 23.0 + 3.0 * np.sin(yy * 11.0))
             * np.sin(yy * 19.0 + 2.0 * np.cos(xx * 7.0)))
        img[..., 3] = np.clip((f * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    else:
        img[..., 3] = 255
    return img


def _normal_map(rng, size: int) -> np.ndarray:
    """Tangent-space normals of a bumpy height field."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    k1, k2 = rng.uniform(8.0, 24.0, 2)
    dx = 0.35 * np.cos(xx * k1 * np.pi) * np.cos(yy * k2 * np.pi)
    dy = -0.35 * np.sin(xx * k1 * np.pi) * np.sin(yy * k2 * np.pi)
    n = np.stack([-dx, -dy, np.ones_like(dx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.round((n * 0.5 + 0.5) * 255.0).astype(np.uint8)
    img[..., 3] = 255
    return img


def _metal_rough(rng, size: int) -> np.ndarray:
    """glTF metallic-roughness: G = roughness, B = metallic."""
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = rng.integers(120, 240, (size, size), dtype=np.uint8)
    img[..., 2] = rng.integers(0, 40, (size, size), dtype=np.uint8)
    img[..., 3] = 255
    return img


def bc7_texture(rgba: np.ndarray, kind: str, name: str) -> Texture:
    """A BC7-backed texture: every mip encoded in-process, and the decoded
    mips taken from those same blocks, so the host atlas and the device
    decode see identical texels."""
    from renderer_tpu.assets import ntex
    from renderer_tpu.tools import native

    blocks, shapes = [], []
    for mip in _mips(rgba):
        h, w = mip.shape[:2]
        ph, pw = max(4, -(-h // 4) * 4), max(4, -(-w // 4) * 4)
        padded = np.zeros((ph, pw, 4), np.uint8)
        padded[:h, :w] = mip
        padded[h:, :w] = mip[-1:]
        padded[:, w:] = padded[:, w - 1:w]
        blocks.append(native.bc7_encode(padded).reshape(-1, 16))
        shapes.append((h, w))
    mips = [ntex._decode_bc7(b.tobytes(), w, h)
            for b, (h, w) in zip(blocks, shapes)]
    return Texture(mips, kind, name=name, blocks_loader=lambda: blocks)


def _pane_stack(n: int, size: float):
    """`n` parallel square panes 0.15 apart (one mesh): positions, uvs,
    normals, tangents, indices."""
    pos, uv, idx = [], [], []
    h = size / 2
    for i in range(n):
        z = 0.15 * i
        base = len(pos)
        pos += [[-h, -h, z], [h, -h, z], [h, h, z], [-h, h, z]]
        uv += [[0, 1], [1, 1], [1, 0], [0, 0]]
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    pos = np.asarray(pos, np.float32)
    nrm = np.tile(np.array([0, 0, 1], np.float32), (len(pos), 1))
    tan = np.tile(np.array([1, 0, 0, 1], np.float32), (len(pos), 1))
    return (pos, np.asarray(uv, np.float32), nrm, tan,
            np.asarray(idx, np.uint32))


class SponzaScale:
    """The scene: build once, then `scene(t)` per frame (camera on an
    elliptical orbit through the atrium, character animations at t)."""

    def __init__(self, seed: int = 0, texture_size: int = 512,
                 triangles: int = SPONZA_TRIANGLES):
        rng = np.random.default_rng(seed)
        self.registry = registry = MaterialRegistry()
        builder = VertexLibraryBuilder()

        sets = []
        for i in range(TEXTURE_SETS):
            if i == 0:
                # BC7-encoded in-process (half size: encoding is host work)
                base_tex = bc7_texture(_base_color(rng, texture_size // 2),
                                       TextureKind.SRGB_COLOR, "bc7-base")
            else:
                base_tex = Texture(_mips(_base_color(rng, texture_size)),
                                   TextureKind.SRGB_COLOR, f"base{i}")
            normal = Texture(_mips(_normal_map(rng, texture_size // 2)),
                             TextureKind.NORMAL_MAP, f"normal{i}")
            mr = Texture(_mips(_metal_rough(rng, texture_size // 2)),
                         TextureKind.LINEAR_COLOR, f"mr{i}")
            sets.append((base_tex, normal, mr))
        leaf = Texture(_mips(_base_color(rng, texture_size // 2,
                                         alpha_holes=True)),
                       TextureKind.SRGB_COLOR, "leaf")

        n_opaque = SPONZA_DRAWS - N_MASKED - N_BLENDED
        weights = rng.uniform(0.3, 1.7, SPONZA_DRAWS - N_BLENDED)
        counts = np.floor(weights / weights.sum()
                          * (triangles - N_BLENDED * 2 * BLEND_PANES))
        counts = counts.astype(np.int64)
        counts[0] += triangles - N_BLENDED * 2 * BLEND_PANES - counts.sum()
        boxes = self._atrium_boxes(rng, SPONZA_DRAWS - N_BLENDED)

        self.draws = []  # (mesh, material, transform)
        for d in range(SPONZA_DRAWS - N_BLENDED):
            tris = int(counts[d])
            lo, hi = boxes[d]
            verts = tris // 2 + 2 * int(np.sqrt(tris)) + 16
            p, uv, n, t, idx = proxy._patch_geometry(verts, tris * 3, lo, hi,
                                                     seed=seed * 1000 + d)
            mesh = builder.add_mesh(p, uv, n, t, idx)
            if d < n_opaque:
                base_tex, normal, mr = sets[d % TEXTURE_SETS]
                params = PbrMaterialParameters(
                    base_color=base_tex, normal=normal, metallic_roughness=mr,
                    roughness_factor=1.0, metallic_factor=1.0)
            else:
                params = PbrMaterialParameters(
                    base_color=leaf, alpha_cutoff=0.5,
                    alpha_mode=AlphaMode.ALPHA_TO_COVERAGE)
            material = registry.create_material(f"draw{d}", params)
            self.draws.append((mesh, material, math3d.IDENTITY))

        panes = _pane_stack(BLEND_PANES, 2.5)
        for b in range(N_BLENDED):
            mesh = builder.add_mesh(*panes)
            color = tuple(float(c) for c in rng.uniform(0.3, 0.9, 3))
            material = registry.create_material(
                f"glass{b}", PbrMaterialParameters(
                    base_color_factor=color + (0.3,),
                    alpha_mode=AlphaMode.BLENDED))
            transform = math3d.trs(
                translation=np.array([-4.0 + 4.0 * b, 2.0, -1.0], np.float32))
            self.draws.append((mesh, material, transform))

        self.character = proxy.make_skinned_character(
            builder, registry, textures=[sets[1][0]])
        self.library = builder.build()
        self._character_transform = math3d.trs(
            translation=np.array([3.0, 0.0, -0.5], np.float32),
            rotation=math3d.quat_from_axis_angle([0, 1, 0], -np.pi / 2),
            scale=np.array([1.4, 1.4, 1.4], np.float32),
        )

    @staticmethod
    def _atrium_boxes(rng, n: int):
        """AABBs of the patches: floor, two long walls, two arcade levels
        and columns, inside a 24 × 12 × 10 m atrium."""
        boxes = [([-12.0, 0.0, -5.0], [12.0, 0.3, 5.0])]  # floor
        boxes.append(([-12.0, 0.0, -5.2], [12.0, 10.0, -4.8]))  # walls
        boxes.append(([-12.0, 0.0, 4.8], [12.0, 10.0, 5.2]))
        while len(boxes) < n:
            k = len(boxes)
            if k % 3 == 0:  # column
                x = rng.uniform(-10.0, 10.0)
                z = rng.choice([-3.5, 3.5])
                boxes.append(([x - 0.4, 0.0, z - 0.4], [x + 0.4, 8.0, z + 0.4]))
            else:  # arcade band along one wall
                y = rng.uniform(1.0, 8.0)
                z = rng.choice([-4.4, 4.4])
                boxes.append(([-11.0, y, z - 0.4], [11.0, y + 1.5, z + 0.4]))
        return boxes[:n]

    def camera_at(self, t: float):
        """Elliptical orbit through the atrium, eye height 1.8, facing the
        center: (position, orientation)."""
        ang = 0.35 * t
        eye = np.array([8.0 * np.cos(ang), 1.8, 3.0 * np.sin(ang)],
                       np.float32)
        target = np.array([0.0, 2.0, 0.0], np.float32)
        return math3d.look_at(eye, target, np.array([0, 1, 0], np.float32))

    def scene(self, t: float):
        import renderer_tpu as rt

        scene = rt.Scene(world_space=rt.GLTF)
        scene.camera.position, scene.camera.orientation = self.camera_at(t)
        for mesh, material, transform in self.draws:
            scene.queue_mesh(mesh, material, None, transform)
        playing = [(t % a.end_time, a) for a in self.character.animations]
        self.character.queue_animated(scene, self._character_transform,
                                      playing)
        return scene
