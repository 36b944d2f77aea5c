"""Multi-device binning work-count probe (CPU, no accelerator needed).

Measures how the binning work (the one frame stage that used to be fully
replicated across devices) divides under the sp tile-row sharding
(parallel/mesh.py + binning.bin_triangle_classes tile_row_lo): for the
canonical bench frame, bins the full screen and then each shard's tile-row
range for sp in {2, 4, 8}, reporting per-device (triangle, tile-row) and
(tile, triangle) expansion demands — the widths the per-device O(P log P)
pair sort and bin scatter actually run at. The shards partition the
full-screen expansion exactly (pinned by
tests/test_binning_and_skinning.py::test_sharded_binning_partitions_full_screen),
so the max-per-device column is the honest per-device cost.

Reference analog: the one sorted draw stream consumed once
(renderer/src/renderer.rs:219-256) — not rebuilt n times.

Run: python -m tools.shard_workcount [sp ...]   (default 2 4 8)
"""

from __future__ import annotations

import sys


def main(shard_counts=(2, 4, 8)) -> list[dict]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import bench
    from renderer_tpu.raster import binning, setup, vertex_stage
    from renderer_tpu.scene import draw_stream

    name, renderer, make_scene = bench.build_bench(None, None)
    # the sharded mode requires height == padded_height divisible by the
    # shard count (parallel/mesh.py asserts); 1920x1024 is the multichip
    # bench shape (32 tile rows: divides 2/4/8)
    from dataclasses import replace

    cfg = replace(renderer.config, height=1024).validate()
    kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
              tile_h=cfg.tile_h, pair_capacity=cfg.pair_capacity,
              row_capacity=cfg.row_capacity)

    def frame_demands(t: float):
        """Returns demands(tile_row_lo, local_tiles_y, row_stride) for the
        frame at timeline time t."""
        scene = make_scene(t)
        fv = draw_stream.frame_view(scene)
        gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
        frame = draw_stream.unpack_frame(
            renderer._frame_arrays(scene, fv, gs), morph_k=gs.morph_k,
            joint_cap=renderer._joint_cap(scene),
        )
        vs = vertex_stage.run_vertex_stage(
            geom, frame, skin_start=gs.skin_start, morph_k=gs.morph_k)
        td = setup.triangle_setup(
            vs["clip"], geom["tri_v"], frame["num_tris"],
            cfg.width, cfg.height,
            bbox_pad=(0.5 if cfg.msaa_samples > 1 else 0.0),
        )
        bounds = [0, frame["n_opaque"]]
        if gs.num_masked_tris > 0:
            bounds.append(frame["n_opaque"] + frame["n_masked"])
        if gs.num_tris > gs.num_opaque_tris + gs.num_masked_tris:
            bounds.append(frame["num_tris"])

        def demands(tile_row_lo, local_tiles_y, row_stride=1):
            out = binning.bin_triangle_classes(
                td, tuple(bounds), tile_row_lo=tile_row_lo,
                local_tiles_y=local_tiles_y, row_stride=row_stride, **kw)
            _b, _s, _c, ov, row_ov, pair_dem, row_dem = out
            assert int(np.asarray(ov).sum()) == 0 and int(row_ov) == 0
            return int(pair_dem), int(row_dem)

        return demands

    demands = frame_demands(1.0)  # first timed frame of the canonical timeline
    full_pairs, full_rows = demands(0, cfg.tiles_y)
    rows = [{"sp": 1, "pairs_per_dev_max": full_pairs,
             "rows_per_dev_max": full_rows, "pairs_sum": full_pairs,
             "speedup_vs_replicated": 1.0}]
    print(f"# scene {name}: frame t=1.0, {cfg.tiles_y} tile rows, "
          f"full-screen demand {full_pairs} pairs / {full_rows} tile-rows")
    print(f"{'sp':>3} {'layout':>12} {'pairs/dev (max)':>16} "
          f"{'rows/dev (max)':>15} {'sum(pairs)':>11} "
          f"{'work vs replicated':>19}")
    print(f"{1:>3} {'-':>12} {full_pairs:>16} {full_rows:>15} "
          f"{full_pairs:>11} {'1.00x (baseline)':>19}")
    for sp in shard_counts:
        if cfg.tiles_y % sp:
            print(f"{sp:>3}  (skipped: {cfg.tiles_y} tile rows not divisible)")
            continue
        local = cfg.tiles_y // sp
        for layout, per in (
            ("contiguous", [demands(k * local, local) for k in range(sp)]),
            ("interleaved", [demands(k, local, sp) for k in range(sp)]),
        ):
            pmax = max(p for p, _ in per)
            rmax = max(r for _, r in per)
            psum = sum(p for p, _ in per)
            assert psum == full_pairs, (psum, full_pairs)  # exact partition
            assert sum(r for _, r in per) == full_rows
            rows.append({"sp": sp, "layout": layout,
                         "pairs_per_dev_max": pmax,
                         "rows_per_dev_max": rmax, "pairs_sum": psum,
                         "speedup_vs_replicated": round(full_pairs / pmax, 2)})
            print(f"{sp:>3} {layout:>12} {pmax:>16} {rmax:>15} {psum:>11} "
                  f"{full_pairs / pmax:>17.2f}x")

    # dp×sp: each dp group runs the SAME sp sharding on its OWN frame
    # (render_frames_batched), so per-device demand is the max over the
    # batch's frames — here dp=2 frames of the canonical timeline — and
    # per_shard_config's bucket suggestion must hold that max.
    from renderer_tpu.parallel.mesh import per_shard_config

    dp = 2
    sp = max(s for s in shard_counts if cfg.tiles_y % s == 0) // dp
    if sp >= 2:
        local = cfg.tiles_y // sp
        d2 = frame_demands(2.0)  # a second camera/animation time
        for layout, stride in (("contiguous", 1), ("interleaved", sp)):
            per = []
            for dem in (demands, d2):
                per += [dem(k * (local if stride == 1 else 1), local, stride)
                        for k in range(sp)]
            pmax = max(p for p, _ in per)
            rmax = max(r for _, r in per)
            shard_cfg = per_shard_config(cfg, sp)
            fits = (pmax <= shard_cfg.pair_capacity
                    and rmax <= shard_cfg.row_capacity)
            rows.append({"dp": dp, "sp": sp, "layout": layout,
                         "pairs_per_dev_max": pmax,
                         "rows_per_dev_max": rmax,
                         "per_shard_pair_capacity": shard_cfg.pair_capacity,
                         "per_shard_fits": fits})
            print(f"dp×sp=({dp},{sp}) {layout:>12} {pmax:>16} {rmax:>15} "
                  f"{'':>11} per-shard bucket {shard_cfg.pair_capacity}"
                  f" {'OK' if fits else 'OVERFLOWS'}")
    return rows


if __name__ == "__main__":
    main(tuple(int(a) for a in sys.argv[1:]) or (2, 4, 8))
