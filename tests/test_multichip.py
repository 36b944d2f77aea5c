"""Sharded (multi-device) frame rendering on the 8-device virtual CPU mesh:
the tp-over-vertices + sp-over-tile-rows decomposition must produce the same
image as the single-device path."""

import numpy as np
import pytest

import renderer_tpu as rt
from apps.triangle import build_scene, build_triangle_assets
from renderer_tpu.core import backend
from renderer_tpu.parallel import mesh as pmesh
from renderer_tpu.raster import pipeline
from renderer_tpu.scene import draw_stream

W, H = 128, 128  # H = padded height (multiple of tile_h) and of 8 devices


@pytest.fixture(scope="module")
def config():
    return rt.RenderConfig(width=W, height=H, tile_h=16, tile_w=128).validate()


def _device_inputs(config):
    import jax.numpy as jnp

    registry, meshes, material = build_triangle_assets()
    scene = build_scene(meshes, material)
    renderer = rt.Renderer(registry, config)
    fv = draw_stream.frame_view(scene)
    gs, geom_dev = renderer._geometry(scene, fv.order, fv.geom_key)
    frame = renderer._frame_arrays(scene, fv, gs, debug_mode=3)
    mats = renderer._materials()
    return renderer, gs, geom_dev, frame, mats, renderer._joint_cap(scene)


def test_sharded_matches_single_device(config):
    import jax

    renderer, gs, geom, frame, mats, jc = _device_inputs(config)
    single, single_stats = pipeline.render_frame(
        geom, frame, mats, config=config, skin_start=gs.skin_start,
        joint_cap=jc, interpret=backend.interpret_mode(),
    )
    mesh = pmesh.make_mesh(8)
    # jit the sharded step — eager shard_map dispatches per-op multi-device
    # compiles (minutes); one fused compile takes seconds
    sharded, sharded_stats = pmesh.jit_sharded_frame(
        config, mesh, interpret=backend.interpret_mode(), joint_cap=jc
    )(geom, frame, mats)
    np.testing.assert_array_equal(
        np.asarray(single_stats), np.asarray(sharded_stats)
    )
    single = np.asarray(single)
    sharded = np.asarray(sharded)
    assert sharded.shape == single.shape
    agreement = (single == sharded).all(axis=-1).mean()
    assert agreement > 0.999, f"sharded/single agreement {agreement}"


def test_one_device_mesh_unpadded_height_matches_single():
    """A one-device mesh renders a height that is not a multiple of tile_h
    (e.g. 1080 rows over 32-row tiles) like the single-device frame."""
    cfg = rt.RenderConfig(width=128, height=120, tile_h=16).validate()
    assert cfg.height != cfg.padded_height
    renderer, gs, geom, frame, mats, jc = _device_inputs(cfg)
    single, single_stats = pipeline.render_frame(
        geom, frame, mats, config=cfg, skin_start=gs.skin_start,
        joint_cap=jc, interpret=backend.interpret_mode(),
    )
    sharded, sharded_stats = pmesh.jit_sharded_frame(
        cfg, pmesh.make_mesh(1), interpret=backend.interpret_mode(),
        joint_cap=jc)(geom, frame, mats)
    np.testing.assert_array_equal(np.asarray(single_stats),
                                  np.asarray(sharded_stats))
    single, sharded = np.asarray(single), np.asarray(sharded)
    assert sharded.shape == single.shape == (120, 128, 3)
    agreement = (single == sharded).all(axis=-1).mean()
    assert agreement > 0.999, f"sharded/single agreement {agreement}"


def test_dp_batch_matches_single(config):
    """dp×sp (frame batch × tile rows) must reproduce the single-device
    render for every frame in the batch (here: two different debug modes)."""
    import jax
    import jax.numpy as jnp

    renderer, gs, geom, frame, mats, jc = _device_inputs(config)
    singles = []
    frames = []
    for mode in (1, 3):
        f = dict(frame)
        # the blob is a HOST array (it rides the dispatch as an implicit
        # device_put); counts[3] = debug mode slot
        blob = np.array(f["blob"])
        blob[-1] = mode
        f["blob"] = blob
        frames.append(f)
        singles.append(
            np.asarray(
                pipeline.render_frame(
                    geom, f, mats, config=config, skin_start=gs.skin_start,
                    joint_cap=jc, interpret=backend.interpret_mode(),
                )[0]
            )
        )
    import functools

    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
    mesh2 = pmesh.make_mesh_2d(2, 4)
    out, bstats = jax.jit(
        functools.partial(
            pmesh.render_frames_batched,
            config=config, mesh=mesh2, joint_cap=jc,
            interpret=backend.interpret_mode(),
        )
    )(geom, batched, mats)
    out = np.asarray(out)
    bstats = np.asarray(bstats)
    assert bstats.shape == (2, pipeline.N_STATS)
    assert (bstats[:, :4] == 0).all()  # no overflow anywhere in the batch
    assert out.shape == (2, H, W, 3)
    for b in range(2):
        agreement = (out[b] == singles[b]).all(axis=-1).mean()
        assert agreement > 0.999, f"frame {b} agreement {agreement}"


def test_interleaved_sharded_matches_single_device(config):
    """Round-robin tile-row assignment (interleave=True — the load-balanced
    sp layout) must reproduce the single-device image and stats exactly,
    like the contiguous-band layout."""
    renderer, gs, geom, frame, mats, jc = _device_inputs(config)
    single, single_stats = pipeline.render_frame(
        geom, frame, mats, config=config, skin_start=gs.skin_start,
        joint_cap=jc, interpret=backend.interpret_mode(),
    )
    mesh = pmesh.make_mesh(8)
    sharded, sharded_stats = pmesh.jit_sharded_frame(
        config, mesh, interpret=backend.interpret_mode(), joint_cap=jc,
        interleave=True,
    )(geom, frame, mats)
    np.testing.assert_array_equal(
        np.asarray(single_stats), np.asarray(sharded_stats)
    )
    single = np.asarray(single)
    assert (single.sum(-1) > 0).mean() > 0.05
    agreement = (single == np.asarray(sharded)).all(axis=-1).mean()
    assert agreement > 0.999, f"interleaved/single agreement {agreement}"


def test_dp_batch_interleaved_right_sized_matches_single(config):
    """The dp×sp batch path with BOTH round-robin tile-row interleaving
    (the load-balanced layout, same as render_frame_sharded) AND per-device
    binning buckets sized to the per-shard max (pmesh.per_shard_config)
    must still reproduce the single-device render for every frame."""
    import functools

    import jax
    import jax.numpy as jnp

    renderer, gs, geom, frame, mats, jc = _device_inputs(config)
    singles = []
    frames = []
    for mode in (1, 3):
        f = dict(frame)
        blob = np.array(f["blob"])
        blob[-1] = mode
        f["blob"] = blob
        frames.append(f)
        singles.append(
            np.asarray(
                pipeline.render_frame(
                    geom, f, mats, config=config, skin_start=gs.skin_start,
                    joint_cap=jc, interpret=backend.interpret_mode(),
                )[0]
            )
        )
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
    mesh2 = pmesh.make_mesh_2d(2, 4)
    shard_cfg = pmesh.per_shard_config(config, 4)
    assert shard_cfg.pair_capacity < config.pair_capacity  # actually shrunk
    out, bstats = jax.jit(
        functools.partial(
            pmesh.render_frames_batched,
            config=shard_cfg, mesh=mesh2, joint_cap=jc, interleave=True,
            interpret=backend.interpret_mode(),
        )
    )(geom, batched, mats)
    out = np.asarray(out)
    bstats = np.asarray(bstats)
    # Shrunk buckets must not truncate EITHER binning axis: the four
    # per-class pair-overflow stats AND the row-expansion overflow
    # (row_capacity was shrunk too; a silent row truncation is exactly the
    # failure mode this test exists to catch).
    i_row_ovf = pipeline.STAT_NAMES.index("row_overflow")
    assert (bstats[:, :4] == 0).all()  # pair buckets did not overflow
    assert (bstats[:, i_row_ovf] == 0).all()  # row bucket did not overflow
    assert out.shape == (2, H, W, 3)
    for b in range(2):
        assert (singles[b].sum(-1) > 0).mean() > 0.02
        agreement = (out[b] == singles[b]).all(axis=-1).mean()
        assert agreement > 0.999, f"frame {b} agreement {agreement}"


def test_per_shard_config_sizing():
    cfg = rt.RenderConfig(pair_capacity=1 << 18, row_capacity=1 << 18)
    c8 = pmesh.per_shard_config(cfg, 8)
    # ceil(2^18/8 * 2.0) = 2^16
    assert c8.pair_capacity == 1 << 16 and c8.row_capacity == 1 << 16
    # floor: never below 1<<14; cap: never above the full-screen bucket
    tiny = pmesh.per_shard_config(rt.RenderConfig(pair_capacity=1 << 14,
                                                  row_capacity=1 << 14), 8)
    assert tiny.pair_capacity == 1 << 14
    assert pmesh.per_shard_config(cfg, 1).pair_capacity == 1 << 18
    # cap BEATS floor: a full-screen bucket below the floor already bounds
    # per-shard demand — the "shrunk" config must never exceed it
    sub = pmesh.per_shard_config(rt.RenderConfig(pair_capacity=1 << 13,
                                                 row_capacity=1 << 13), 8)
    assert sub.pair_capacity == 1 << 13 and sub.row_capacity == 1 << 13


def test_dp_batch_overflow_detected():
    """A frame mid-batch must not drop work silently: force pair overflow in
    frame 0 of a dp×sp batch (tiny pair_capacity, camera on the triangles)
    while frame 1 looks away (zero demand) — the returned [B, N_STATS] stats
    must flag frame 0's overflow and report frame 1 clean (the
    render_frames_device batch-max policy has a real signal to act on)."""
    import functools

    import jax
    import jax.numpy as jnp

    cfg = rt.RenderConfig(width=256, height=128, tile_h=16, tile_w=128,
                          pair_capacity=4, row_capacity=1 << 12).validate()
    registry, meshes, material = build_triangle_assets()
    scene0 = build_scene(meshes, material)
    scene1 = build_scene(meshes, material)
    # camera past the triangles (z = 0.8), looking further +z: nothing binned
    scene1.camera.position = np.array([0.0, 0.0, 2.0], np.float32)
    renderer = rt.Renderer(registry, cfg, overflow_policy="off")
    frames = []
    fv0 = draw_stream.frame_view(scene0)
    gs, geom = renderer._geometry(scene0, fv0.order, fv0.geom_key)
    jc = renderer._joint_cap(scene0)
    for scene in (scene0, scene1):
        fv = draw_stream.frame_view(scene)
        assert fv.geom_key == fv0.geom_key
        frames.append(renderer._frame_arrays(scene, fv, gs, debug_mode=3))
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
    mesh2 = pmesh.make_mesh_2d(2, 4)
    _imgs, bstats = jax.jit(
        functools.partial(
            pmesh.render_frames_batched,
            config=cfg, mesh=mesh2, joint_cap=jc,
            interpret=backend.interpret_mode(),
        )
    )(geom, batched, mats := renderer._materials())
    bstats = np.asarray(bstats)
    assert bstats.shape == (2, pipeline.N_STATS)
    assert bstats[0, :3].sum() > 0, f"frame 0 overflow not detected: {bstats[0]}"
    assert bstats[1, :4].sum() == 0, f"frame 1 should be clean: {bstats[1]}"
    # the batch-max policy signal (render_frames_device checks max over rows)
    assert np.max(bstats[:, :4].sum(axis=1)) > 0


def test_morph_sharded_matches_single_device(config):
    """Morph-target displacement under the tp×sp decomposition: the morph
    bank is replicated like every vertex attribute; the per-draw weights
    ride the frame blob's morph section (morph_k static key)."""
    from renderer_tpu.core import math3d

    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    half, z = 0.6, 1.5
    p = np.array([[-half, half, z], [half, half, z],
                  [-half, -half, z], [half, -half, z]], np.float32)
    uv = np.array([[0, 1], [1, 1], [0, 0], [1, 0]], np.float32)
    n = np.tile([0, 0, -1.0], (4, 1)).astype(np.float32)
    t = np.tile([1, 0, 0, 1.0], (4, 1)).astype(np.float32)
    idx = np.array([0, 1, 2, 2, 1, 3], np.uint32)
    delta = np.zeros((4, 3), np.float32)
    delta[:, 0] = 0.5
    dn = np.tile([0.5, 0, 0], (4, 1)).astype(np.float32)
    mesh_m = builder.add_mesh(p, uv, n, t, idx, morph_targets=[(delta, dn)])
    builder.build()
    mat = registry.create_material(
        "morph-mc", rt.PbrMaterialParameters(base_color_factor=(1, 1, 1, 1))
    )
    scene = rt.Scene()
    scene.queue_mesh(mesh_m, mat, None, math3d.IDENTITY,
                     morph_weights=np.array([0.5], np.float32))
    renderer = rt.Renderer(registry, config)
    fv = draw_stream.frame_view(scene)
    gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
    assert gs.morph_k == 1
    frame = renderer._frame_arrays(scene, fv, gs, debug_mode=3)
    mats = renderer._materials()
    jc = renderer._joint_cap(scene)
    single, single_stats = pipeline.render_frame(
        geom, frame, mats, config=config, skin_start=gs.skin_start,
        morph_k=gs.morph_k, joint_cap=jc, interpret=backend.interpret_mode(),
    )
    mesh = pmesh.make_mesh(8)
    sharded, sharded_stats = pmesh.jit_sharded_frame(
        config, mesh, interpret=backend.interpret_mode(), morph_k=gs.morph_k,
        joint_cap=jc,
    )(geom, frame, mats)
    np.testing.assert_array_equal(
        np.asarray(single_stats), np.asarray(sharded_stats)
    )
    single = np.asarray(single)
    assert (single.sum(-1) > 0).mean() > 0.05  # the morphed quad covers
    agreement = (single == np.asarray(sharded)).all(axis=-1).mean()
    assert agreement > 0.999, f"sharded/single agreement {agreement}"


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import jax

    import __graft_entry__ as ge

    fn, args = ge.entry()
    jax.jit(fn).lower(*args)


def test_skinned_sharded_matches_single_device():
    """Skinned geometry under the tp×sp decomposition: the multichip vertex
    stage runs with skin_start=None (skinning computed for every vertex,
    selected by the per-draw flag) and gathers the joint palette from the
    REPLICATED frame blob — the sharded image must reproduce the
    single-device render on the real-skin loader fixture (2 skins,
    animated pose)."""
    from renderer_tpu.core import math3d
    from tests.make_loader_fixture import GLTF_PATH
    from renderer_tpu.assets.gltf_loader import load_gltf

    cfg = rt.RenderConfig(width=128, height=64, tile_h=8,
                          tile_w=128).validate()
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    gltf = load_gltf(GLTF_PATH, builder, registry)
    builder.build()
    scene = rt.Scene(world_space=rt.GLTF)
    pos, orient = math3d.look_at(
        np.array([0.3, 1.2, 4.0], np.float32),
        np.array([0.3, 0.5, 0.0], np.float32),
        np.array([0.0, 1.0, 0.0], np.float32),
    )
    scene.camera.position = pos
    scene.camera.orientation = orient
    gltf.queue_animated(
        scene, math3d.IDENTITY,
        [(0.7 % a.end_time, a) for a in gltf.animations],
    )
    renderer = rt.Renderer(registry, cfg)
    fv = draw_stream.frame_view(scene)
    gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
    assert gs.skin_start < geom["exp_src"].shape[0]  # skinned draws present
    frame = renderer._frame_arrays(scene, fv, gs, debug_mode=0)
    mats = renderer._materials()
    jc = renderer._joint_cap(scene)
    single, single_stats = pipeline.render_frame(
        geom, frame, mats, config=cfg, skin_start=gs.skin_start,
        morph_k=gs.morph_k, joint_cap=jc, interpret=backend.interpret_mode(),
    )
    mesh = pmesh.make_mesh(8)
    sharded, sharded_stats = pmesh.jit_sharded_frame(
        cfg, mesh, interpret=backend.interpret_mode(), morph_k=gs.morph_k,
        joint_cap=jc,
    )(geom, frame, mats)
    np.testing.assert_array_equal(
        np.asarray(single_stats), np.asarray(sharded_stats)
    )
    single = np.asarray(single)
    assert (single.sum(-1) > 0).mean() > 0.05  # the fixture scene covers
    agreement = (single == np.asarray(sharded)).all(axis=-1).mean()
    assert agreement > 0.999, f"skinned sharded/single agreement {agreement}"
