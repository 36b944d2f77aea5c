"""What the renderer needs from its installation: no Pillow on the main
path, and the persistent compile cache where JAX_COMPILATION_CACHE_DIR
says."""

import subprocess
import sys
from pathlib import Path

import numpy as np

from renderer_tpu.engine import renderer as engine

REPO = Path(__file__).resolve().parents[1]

_NO_PIL_FRAME = """
import sys
sys.modules["PIL"] = None  # any `import PIL...` now raises ImportError
import numpy as np
import renderer_tpu as rt
from apps.triangle import build_scene, build_triangle_assets
from renderer_tpu.assets import ntex
from renderer_tpu.engine.profiling import Profiler
from renderer_tpu.overlay.hud import build_hud_drawlist
from renderer_tpu.tools.png import encode_png

registry, meshes, material = build_triangle_assets()
hud = build_hud_drawlist(registry, Profiler(enabled=True), ["no pillow"])
r = rt.Renderer(registry, rt.RenderConfig(width=96, height=64))
img = r.render_frame(build_scene(meshes, material), ui=hud)
assert img.shape == (64, 96, 3) and img.any()
blocks = np.zeros((4, 16), np.uint8)
blocks[:, 0] = 0x40  # mode 6, all-zero endpoints
assert ntex._decode_bc7(blocks.tobytes(), 8, 8).shape == (8, 8, 4)
assert encode_png(img)[:8] == b"\\x89PNG\\r\\n\\x1a\\n"
print("ok")
"""


def test_hud_frame_renders_without_pillow():
    """Import renderer_tpu, render a frame with the HUD overlay, decode BC7
    and write a PNG with Pillow unimportable."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_PIL_FRAME], cwd=REPO, capture_output=True,
        text=True, timeout=600,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": str(REPO)})
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), (
        out.stdout[-2000:] + out.stderr[-4000:])


def test_compile_cache_dir_defers_to_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the renderer sets no cache
    directory of its own (JAX reads the variable)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert engine.compilation_cache_dir() is None


def test_compile_cache_dir_default_is_fixed_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert engine.compilation_cache_dir() == str(REPO / ".cache" / "jax")


def test_png_writer_round_trips():
    """The numpy+zlib PNG writer's output decodes to the same pixels (zlib
    inflate + scanline filter bytes checked by hand, no image library)."""
    import struct
    import zlib

    from renderer_tpu.tools.png import encode_png

    img = np.random.default_rng(3).integers(0, 256, (5, 7, 3), np.uint8)
    data = encode_png(img)
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (7, 5)
    idat_len = struct.unpack(">I", data[33:37])[0]
    raw = zlib.decompress(data[41:41 + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(5, 1 + 7 * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), img)
