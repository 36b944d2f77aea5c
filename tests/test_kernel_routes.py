"""The raster kernels' routes: the Pallas Triton kernels (run here in
interpret mode) against their plain jnp/lax references, the pixel-block
split, the lowering for the GPU, and the backend decision that picks
between interpret and compiled kernels."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from renderer_tpu.core import backend
from renderer_tpu.raster import binning, layers, pipeline, raster_kernel
from renderer_tpu.raster.setup import EPS_ROW, VALID_ROW
from tests.test_binning_and_skinning import _fake_tri_data

TILES_X, TILES_Y, TILE_W, TILE_H = 2, 2, 64, 16
HP, WP = TILES_Y * TILE_H, TILES_X * TILE_W


def _plane_soup(seed: int, n: int = 120, tc: int = 256):
    """Random edge/depth/1w planes binned into a 2×2 tile grid: a fair
    share of pixels covered, depth-contested and stacked."""
    rng = np.random.default_rng(seed)
    td = _fake_tri_data(rng, n, tc, TILES_X, TILES_Y, TILE_W, TILE_H)
    for r in range(15):
        td[r, :n] = (rng.normal(size=n) * 0.05).astype(np.float32)
    for r in (2, 5, 8):  # edge C offsets: keep many triangles open
        td[r, :n] += 2.0
    td[11, :n] = rng.uniform(0.0, 1.0, n)  # depth plane C in range
    td[14, :n] = 1.0  # 1/w positive
    td[EPS_ROW, :n] = 1e-5
    td[VALID_ROW, :n] = 1.0
    binned, starts, counts, ov = binning.bin_triangles(
        jnp.asarray(td), 0, n, tiles_x=TILES_X, tiles_y=TILES_Y,
        tile_w=TILE_W, tile_h=TILE_H, pair_capacity=2048)
    assert int(ov) == 0
    return binned, starts, counts


def _run(fn, mode, msaa, **extra):
    binned, starts, counts = _plane_soup(7 + msaa)
    spos = pipeline.STANDARD_SAMPLE_POSITIONS[msaa]
    kw = dict(padded_height=HP, padded_width=WP, tile_h=TILE_H,
              tile_w=TILE_W, sample_positions=spos, **extra)
    if mode == "opaque":
        return fn["opaque"](binned, starts, counts, **kw)
    floor = jnp.full((msaa, HP, WP), 0.2, jnp.float32)
    return fn["layers"](binned, starts, counts, floor, mode=mode,
                        n_layers=3, **kw)


KERNELS = {"opaque": raster_kernel.rasterize_binned,
           "layers": layers.rasterize_layers}
REFERENCES = {"opaque": raster_kernel.rasterize_binned_reference,
              "layers": layers.rasterize_layers_reference}
MODES = ("opaque", "masked", "blended")


@pytest.mark.parametrize("msaa", (1, 4))
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain_reference(mode, msaa):
    """Each interpret-mode kernel is bit-equal to its plain jnp reference:
    opaque depth + ids, layer depths + ids + aux counts."""
    got = _run(KERNELS, mode, msaa, interpret=True)
    want = _run(REFERENCES, mode, msaa)
    ids = got[1]
    assert (np.asarray(ids) >= 0).sum() > 200, "scene degenerate"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("mode", MODES)
def test_pixel_block_split_is_invisible(mode):
    """Splitting a bin tile over several programs (the GPU block shape)
    gives the same result as one program per tile."""
    whole = _run(KERNELS, mode, 4, interpret=True)
    split = _run(KERNELS, mode, 4, interpret=True, block=(4, 32))
    for a, b in zip(whole, split):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode", MODES)
def test_kernel_lowers_to_triton_for_gpu(mode):
    """Each kernel lowers through Pallas' Triton route for CUDA (compiling
    the Triton IR needs the card; lowering does not)."""
    binned, starts, counts = _plane_soup(1)
    spos = pipeline.STANDARD_SAMPLE_POSITIONS[4]
    kw = dict(padded_height=HP, padded_width=WP, tile_h=TILE_H,
              tile_w=TILE_W, sample_positions=spos, interpret=False)
    if mode == "opaque":
        fn = lambda b, s, c: raster_kernel.rasterize_binned(b, s, c, **kw)
        args = (binned, starts, counts)
    else:
        fn = lambda b, s, c, f: layers.rasterize_layers(
            b, s, c, f, mode=mode, n_layers=4, **kw)
        args = (binned, starts, counts, jnp.zeros((4, HP, WP), jnp.float32))
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


def test_backend_decision_cpu_interprets():
    assert backend.interpret_mode() is True
    assert backend.interpret_mode("cpu") is True


def test_backend_decision_gpu_compiles(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.interpret_mode() is False


@pytest.mark.parametrize("platform", ("rocm", "metal", "neuron"))
def test_backend_decision_other_platforms_raise(platform):
    with pytest.raises(RuntimeError, match="no raster kernel route"):
        backend.interpret_mode(platform)


@pytest.mark.gpu
@pytest.mark.parametrize("msaa", (1, 4))
@pytest.mark.parametrize("mode", MODES)
def test_compiled_kernel_matches_plain_reference_on_card(mode, msaa):
    """On the card: each Triton-compiled kernel is bit-equal to its plain
    jnp reference compiled by XLA."""
    got = _run(KERNELS, mode, msaa, interpret=False)
    want = _run(REFERENCES, mode, msaa)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.gpu
def test_renderer_takes_compiled_route_on_card():
    """On the card the Renderer takes the compiled route: no interpreter,
    and its frame function is one jit."""
    import renderer_tpu as rt

    assert backend.interpret_mode() is False
    r = rt.Renderer(rt.MaterialRegistry(), rt.RenderConfig(width=64,
                                                           height=32))
    assert r._interpret is False
    assert hasattr(r._frame_fn, "lower")
