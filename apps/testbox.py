"""Testbox demo — the reference mount's only asset with REAL geometry bytes
(`examples/sandbox/src/testbox/testbox.glb`, 892 KB GLB with embedded
buffers + PNG texture): unlike the Sponza configs (whose `.bin` LFS buffers
are absent from the mount, substituted by assets/proxy.py), every index,
position, tangent and texel here flows from the reference's actual bytes
through vertex stage → raster → shade.

Two scenes:
- `build_single`: one testbox, fixed camera — the real-byte golden config.
- `build_field`: an instanced grid of testboxes at Sponza-like triangle
  count (~276k tris from 90 instances x 3,072 tris) — real index/vertex
  patterns at bench scale, bounding the proxy-geometry optimism of the
  headline bench (testbox topology is real mesh data, not raster-coherent
  synthetic patches).

Run: python -m apps.testbox [out.png] [debug_mode]
"""

from __future__ import annotations

import sys

import numpy as np

import renderer_tpu as rt
from renderer_tpu.assets.gltf_loader import load_gltf
from renderer_tpu.core import math3d

from apps.sandbox import ASSET_ROOT

TESTBOX = ASSET_ROOT / "testbox/testbox.glb"


def load_testbox():
    """Returns (registry, library, gltf) for the testbox asset."""
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    gltf = load_gltf(TESTBOX, builder, registry)
    library = builder.build()
    return registry, library, gltf


def _aim(scene: rt.Scene, eye, target) -> None:
    pos, orient = math3d.look_at(
        np.asarray(eye, np.float32), np.asarray(target, np.float32),
        np.array([0.0, 1.0, 0.0], np.float32),
    )
    scene.camera.position, scene.camera.orientation = pos, orient


def build_single(gltf) -> rt.Scene:
    """One testbox, deterministic camera (golden-locked,
    tests/test_testbox_golden.py). The box spans ~[-0.84, 0.84]^3."""
    scene = rt.Scene(world_space=rt.GLTF)
    _aim(scene, [0.95, 0.7, 1.3], [0.0, 0.0, 0.0])
    gltf.queue(scene, math3d.IDENTITY)
    return scene


def build_field(gltf, nx: int = 9, nz: int = 10) -> rt.Scene:
    """nx x nz grid of testboxes (default 90 instances = 276,480 real
    triangles, the Sponza-scale stress shape with real geometry bytes)."""
    scene = rt.Scene(world_space=rt.GLTF)
    ex = 2.2 * (nx - 1) / 2
    ez = 2.2 * (nz - 1) / 2
    _aim(scene, [ex * 1.4, max(ex, ez) * 1.1, ez * 2.4], [0.0, 0.0, 0.0])
    for ix in range(nx):
        for iz in range(nz):
            tr = math3d.trs(translation=np.array(
                [ix * 2.2 - ex, 0.0, iz * 2.2 - ez], np.float32))
            if not gltf.queue(scene, tr):
                raise RuntimeError("draw budget exhausted")
    return scene


def main(out_path: str = "testbox.png", debug_mode: int = 0) -> np.ndarray:
    registry, _library, gltf = load_testbox()
    renderer = rt.Renderer(registry, rt.RenderConfig(width=800, height=608))
    img = renderer.render_frame(build_single(gltf), debug_mode=debug_mode)
    from renderer_tpu.tools.png import write_png

    write_png(out_path, img)
    print(f"wrote {out_path} ({img.shape[1]}x{img.shape[0]})")
    return img


if __name__ == "__main__":
    main(*sys.argv[1:3])
