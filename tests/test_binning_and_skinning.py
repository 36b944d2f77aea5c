"""Unit tests: tile binning against a brute-force oracle, and the skinning
vertex path against a numpy reimplementation."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from renderer_tpu.raster import binning, setup, vertex_stage
from renderer_tpu.raster.binning import B_TID
from renderer_tpu.raster.setup import BBOX_ROWS, ROWS, VALID_ROW


def _fake_tri_data(rng, n, tc, tiles_x, tiles_y, tile_w, tile_h):
    """Random valid bboxes inside the screen; only rows used by binning are
    populated."""
    td = np.zeros((ROWS, tc), np.float32)
    w, h = tiles_x * tile_w, tiles_y * tile_h
    x0 = rng.uniform(0, w - 1, n)
    y0 = rng.uniform(0, h - 1, n)
    bw = rng.uniform(0.5, w / 3, n)
    bh = rng.uniform(0.5, h / 3, n)
    td[BBOX_ROWS[0], :n] = x0
    td[BBOX_ROWS[1], :n] = y0
    td[BBOX_ROWS[2], :n] = np.minimum(x0 + bw, w)
    td[BBOX_ROWS[3], :n] = np.minimum(y0 + bh, h)
    td[VALID_ROW, :n] = 1.0
    return td


class TestBinning:
    def test_trivial_reject_vs_coverage(self):
        """The tight edge-plane trivial-reject must be CONSERVATIVE: on real
        setup-produced triangles, every (tile, triangle) pair whose edge
        test passes anywhere inside the tile's pixel squares (a superset of
        every possible sample position) must survive binning — while thin
        diagonal triangles must actually shed a large share of their bbox
        pairs (the point of the reject)."""
        tiles_x, tiles_y, tile_w, tile_h = 4, 4, 128, 32
        W, H = tiles_x * tile_w, tiles_y * tile_h
        rng = np.random.default_rng(7)
        n = 80
        # random CCW-ish triangles in clip space (w = 1), plus a thin
        # diagonal sliver spanning the whole screen
        pts = rng.uniform(-1.2, 1.2, (n, 3, 2)).astype(np.float32)
        pts[0] = [[-1.1, -1.1], [1.1, 1.05], [1.1, 1.1]]  # the sliver
        clip = np.zeros((3 * n, 4), np.float32)
        clip[:, :2] = pts.reshape(-1, 2)
        clip[:, 2] = 0.5
        clip[:, 3] = 1.0
        tri_v = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
        td = np.asarray(setup.triangle_setup(
            jnp.asarray(clip), jnp.asarray(tri_v), n, W, H, bbox_pad=0.5,
        ))
        binned, starts, counts, overflow = binning.bin_triangles(
            jnp.asarray(td), 0, n,
            tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
            pair_capacity=1 << 14,
        )
        binned = np.asarray(binned)
        starts, counts = np.asarray(starts), np.asarray(counts)
        assert int(np.asarray(overflow)) == 0

        # pixel-square subgrid oracle: positions cover every point a sample
        # could take (offsets within ±0.5 of the pixel center)
        sub = np.linspace(-0.5, 0.5, 5)
        live = 0
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                tile = ty * tiles_x + tx
                got = set(
                    binned[B_TID, starts[tile]: starts[tile] + counts[tile]]
                    .astype(int)
                )
                live += len(got)
                xs = (np.arange(tx * tile_w, tx * tile_w + tile_w) + 0.5)
                ys = (np.arange(ty * tile_h, ty * tile_h + tile_h) + 0.5)
                px = (xs[:, None] + sub[None, :]).reshape(-1)
                py = (ys[:, None] + sub[None, :]).reshape(-1)
                for t in range(n):
                    if td[VALID_ROW, t] <= 0 or t in got:
                        continue
                    # culled pair: NO point in any pixel square may pass
                    e = np.ones((len(py), len(px)), bool)
                    for k in range(3):
                        a, b, c = td[3 * k, t], td[3 * k + 1, t], td[3 * k + 2, t]
                        e &= (a * px[None, :] + b * py[:, None] + c) >= 0
                    assert not e.any(), (
                        f"tile {tile} wrongly culled triangle {t}"
                    )

        # effectiveness: the sliver's bbox spans every tile, its coverage
        # only the diagonal band — well under half its bbox pairs may survive
        tx0 = np.clip(np.ceil((td[BBOX_ROWS[0]] + 0.5) / tile_w - 1.0),
                      0, tiles_x - 1)
        tx1 = np.clip(np.floor((td[BBOX_ROWS[2]] - 0.5) / tile_w),
                      0, tiles_x - 1)
        ty0 = np.clip(np.ceil((td[BBOX_ROWS[1]] + 0.5) / tile_h - 1.0),
                      0, tiles_y - 1)
        ty1 = np.clip(np.floor((td[BBOX_ROWS[3]] - 0.5) / tile_h),
                      0, tiles_y - 1)
        bbox_pairs = int(np.where(
            td[VALID_ROW] > 0,
            np.maximum(tx1 - tx0 + 1, 0) * np.maximum(ty1 - ty0 + 1, 0), 0,
        ).sum())
        assert live < bbox_pairs, (live, bbox_pairs)
        sliver_tiles = sum(
            1 for tile in range(tiles_x * tiles_y)
            if 0 in set(binned[B_TID,
                               starts[tile]: starts[tile] + counts[tile]]
                        .astype(int))
        )
        assert sliver_tiles < tiles_x * tiles_y / 2

    def test_matches_bruteforce(self):
        rng = np.random.default_rng(3)
        tiles_x, tiles_y, tile_w, tile_h = 3, 4, 128, 32
        n, tc = 200, 256
        td = _fake_tri_data(rng, n, tc, tiles_x, tiles_y, tile_w, tile_h)
        binned, starts, counts, overflow = binning.bin_triangles(
            jnp.asarray(td), 0, n,
            tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
            pair_capacity=4096,
        )
        binned, starts, counts = (np.asarray(a) for a in (binned, starts, counts))
        assert int(overflow) == 0

        for ty in range(tiles_y):
            for tx in range(tiles_x):
                tile = ty * tiles_x + tx
                # brute force: pixel-center overlap of bbox and tile
                cx0, cx1 = tx * tile_w + 0.5, tx * tile_w + tile_w - 0.5
                cy0, cy1 = ty * tile_h + 0.5, ty * tile_h + tile_h - 0.5
                expect = [
                    t for t in range(n)
                    if td[BBOX_ROWS[0], t] <= cx1 and td[BBOX_ROWS[2], t] >= cx0
                    and td[BBOX_ROWS[1], t] <= cy1 and td[BBOX_ROWS[3], t] >= cy0
                ]
                got = binned[B_TID, starts[tile] : starts[tile] + counts[tile]]
                assert list(got.astype(int)) == expect, f"tile {tile}"
                # packed layout: each tile's segment starts where the
                # previous tile's ends
                assert starts[tile] == counts[:tile].sum()

    def test_range_limits(self):
        rng = np.random.default_rng(5)
        td = _fake_tri_data(rng, 100, 256, 2, 2, 128, 32)
        _, _, counts_all, _ = binning.bin_triangles(
            jnp.asarray(td), 0, 100,
            tiles_x=2, tiles_y=2, tile_w=128, tile_h=32, pair_capacity=2048,
        )
        binned, starts, counts, _ = binning.bin_triangles(
            jnp.asarray(td), 30, 60,
            tiles_x=2, tiles_y=2, tile_w=128, tile_h=32, pair_capacity=2048,
        )
        tids = np.asarray(binned)[B_TID]
        starts, counts = np.asarray(starts), np.asarray(counts)
        for tile in range(4):
            got = tids[starts[tile] : starts[tile] + counts[tile]].astype(int)
            assert ((got >= 30) & (got < 60)).all()
        assert np.asarray(counts_all).sum() > counts.sum() > 0

    def test_sharded_binning_partitions_full_screen(self):
        """Shard-local binning (tile_row_lo/local_tiles_y) must PARTITION
        the full-screen expansion: per-shard pair/row demands sum EXACTLY to
        the single-chip totals (each (triangle, tile-row) belongs to exactly
        one shard and its edge-plane x-window is shard-independent), each
        shard's per-tile counts equal the matching rows of the full-screen
        counts, and each shard's binned content matches tile-for-tile —
        i.e. the multichip sp path sorts/scatters only its own rows' pairs
        instead of rebuilding the full screen n times."""
        tiles_x, tiles_y, tile_w, tile_h = 4, 8, 128, 16
        W, H = tiles_x * tile_w, tiles_y * tile_h
        rng = np.random.default_rng(23)
        n = 120
        pts = rng.uniform(-1.3, 1.3, (n, 3, 2)).astype(np.float32)
        pts[0] = [[-1.1, -1.1], [1.1, 1.05], [1.1, 1.1]]  # screen-wide sliver
        clip = np.zeros((3 * n, 4), np.float32)
        clip[:, :2] = pts.reshape(-1, 2)
        clip[:, 2] = rng.uniform(0.1, 0.9, 3 * n)
        clip[:, 3] = 1.0
        # a few near-plane-crossing triangles (full-screen conservative bbox)
        clip[9:18, 3] = rng.uniform(-0.5, 1.5, 9)
        tri_v = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
        td = jnp.asarray(np.asarray(setup.triangle_setup(
            jnp.asarray(clip), jnp.asarray(tri_v), n, W, H, bbox_pad=0.5,
        )))
        kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
                  tile_h=tile_h, pair_capacity=1 << 14,
                  row_capacity=1 << 14)
        bounds = (0, n)
        b_f, s_f, c_f, ov_f, rov_f, pd_f, rd_f = binning.bin_triangle_classes(
            td, bounds, **kw)
        assert int(np.asarray(ov_f).sum()) == 0 and int(rov_f) == 0
        b_f, s_f, c_f = (np.asarray(a) for a in (b_f, s_f, c_f))
        c_f2 = c_f.reshape(tiles_y, tiles_x)
        s_f2 = s_f.reshape(tiles_y, tiles_x)
        shards, local = 4, tiles_y // 4
        pd_sum = rd_sum = 0
        for k in range(shards):
            b_k, s_k, c_k, ov_k, rov_k, pd_k, rd_k = (
                binning.bin_triangle_classes(
                    td, bounds, tile_row_lo=k * local, local_tiles_y=local,
                    **kw))
            assert int(np.asarray(ov_k).sum()) == 0 and int(rov_k) == 0
            pd_sum += int(pd_k)
            rd_sum += int(rd_k)
            b_k, s_k, c_k = (np.asarray(a) for a in (b_k, s_k, c_k))
            c_k2 = c_k.reshape(local, tiles_x)
            s_k2 = s_k.reshape(local, tiles_x)
            np.testing.assert_array_equal(
                c_k2, c_f2[k * local:(k + 1) * local])
            for ly in range(local):
                for tx in range(tiles_x):
                    cnt = c_k2[ly, tx]
                    np.testing.assert_allclose(
                        b_k[:, s_k2[ly, tx]:s_k2[ly, tx] + cnt],
                        b_f[:, s_f2[k * local + ly, tx]:
                            s_f2[k * local + ly, tx] + cnt],
                    )
        assert pd_sum == int(pd_f) > 0
        assert rd_sum == int(rd_f) > 0

        # INTERLEAVED (round-robin, row_stride=n) shards must partition the
        # expansion exactly too, and each shard's per-tile counts must equal
        # the strided rows of the full-screen counts
        pd_sum = rd_sum = 0
        for k in range(shards):
            _b, _s, c_k, ov_k, rov_k, pd_k, rd_k = (
                binning.bin_triangle_classes(
                    td, bounds, tile_row_lo=k, local_tiles_y=local,
                    row_stride=shards, **kw))
            assert int(np.asarray(ov_k).sum()) == 0 and int(rov_k) == 0
            pd_sum += int(pd_k)
            rd_sum += int(rd_k)
            np.testing.assert_array_equal(
                np.asarray(c_k).reshape(local, tiles_x),
                c_f2[k::shards])
        assert pd_sum == int(pd_f)
        assert rd_sum == int(rd_f)

    def test_overflow_reported(self):
        rng = np.random.default_rng(7)
        td = _fake_tri_data(rng, 200, 256, 4, 4, 128, 32)
        _, _, _, overflow = binning.bin_triangles(
            jnp.asarray(td), 0, 200,
            tiles_x=4, tiles_y=4, tile_w=128, tile_h=32, pair_capacity=64,
        )
        assert int(overflow) > 0

    def test_classes_match_per_class_runs(self):
        """The production path (one sort for all alpha classes,
        bin_triangle_classes) must produce, per class, exactly the bins a
        standalone run over that class range produces."""
        rng = np.random.default_rng(19)
        tiles_x, tiles_y, tile_w, tile_h = 5, 4, 128, 32
        n_tiles = tiles_x * tiles_y
        td = _fake_tri_data(rng, 280, 300, tiles_x, tiles_y, tile_w, tile_h)
        kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
                  tile_h=tile_h, pair_capacity=4096)
        bounds = (0, 200, 250, 300)
        bc, sc, cc, oc = binning.bin_triangle_classes(
            jnp.asarray(td), bounds, **kw
        )[:4]
        bc, sc, cc = (np.asarray(a) for a in (bc, sc, cc))
        assert sc.shape == (3, n_tiles) and cc.shape == (3, n_tiles)
        assert np.asarray(oc).sum() == 0
        for ci in range(3):
            b1, s1, c1, _ = binning.bin_triangles(
                jnp.asarray(td), bounds[ci], bounds[ci + 1], **kw
            )
            b1, s1, c1 = (np.asarray(a) for a in (b1, s1, c1))
            np.testing.assert_array_equal(c1, cc[ci])
            for t in range(n_tiles):
                # packed (class, tile) segments in key order
                assert sc[ci, t] == cc.ravel()[:ci * n_tiles + t].sum()
                np.testing.assert_allclose(
                    b1[:, s1[t] : s1[t] + c1[t]],
                    bc[:, sc[ci, t] : sc[ci, t] + cc[ci, t]],
                )

    def test_randomized_scenes_full_parity(self):
        """Randomized multi-class scenes across seeds and tile grids: every
        (class, tile) segment of the slim binned buffer must list exactly
        the stream-order oracle's triangles AND carry each triangle's setup
        rows verbatim (the kernel-consumed KEEP_ROWS payload)."""
        from renderer_tpu.raster.binning import B_TID, KEEP_ROWS

        for seed in range(4):
            rng = np.random.default_rng(100 + seed)
            tiles_x = int(rng.integers(2, 6))
            tiles_y = int(rng.integers(2, 6))
            tile_w, tile_h = 128, 32
            n = int(rng.integers(50, 300))
            tc = n + int(rng.integers(0, 60))
            td = _fake_tri_data(rng, n, tc, tiles_x, tiles_y, tile_w, tile_h)
            # populate every kernel-consumed row with recognizable values so
            # the payload check is meaningful; edge planes (rows 0-8) must
            # ACCEPT everywhere (a = b = 0, c > 0 → e ≡ c > 0) so the tight
            # trivial-reject keeps every bbox pair and this test stays a
            # pure bin-mechanics oracle (the reject itself is validated
            # against real coverage in test_trivial_reject_vs_coverage)
            for r in range(15):
                td[r, :n] = rng.normal(size=n).astype(np.float32)
            for e in range(3):
                td[3 * e, :n] = 0.0
                td[3 * e + 1, :n] = 0.0
                td[3 * e + 2, :n] = rng.uniform(0.1, 1.0, n).astype(np.float32)
            from renderer_tpu.raster.setup import EPS_ROW

            td[EPS_ROW, :n] = rng.uniform(1e-6, 1e-3, n).astype(np.float32)
            # a random subset is invalid (culled) — never binned
            invalid = rng.random(n) < 0.15
            td[VALID_ROW, :n] = np.where(invalid, 0.0, 1.0)
            b0 = int(rng.integers(0, n // 2))
            b1 = int(rng.integers(b0, n))
            bounds = (b0, b1, n)
            binned, starts, counts, overflow = binning.bin_triangle_classes(
                jnp.asarray(td), bounds,
                tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
                tile_h=tile_h, pair_capacity=1 << 14,
            )[:4]
            binned, starts, counts = (
                np.asarray(a) for a in (binned, starts, counts)
            )
            assert np.asarray(overflow).sum() == 0
            slim_src = td[list(KEEP_ROWS)]  # ground-truth payload per tid
            for ci, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
                for ty in range(tiles_y):
                    for tx in range(tiles_x):
                        tile = ty * tiles_x + tx
                        cx0 = tx * tile_w + 0.5
                        cx1 = tx * tile_w + tile_w - 0.5
                        cy0 = ty * tile_h + 0.5
                        cy1 = ty * tile_h + tile_h - 0.5
                        expect = [
                            t for t in range(lo, hi)
                            if not invalid[t]
                            and td[BBOX_ROWS[0], t] <= cx1
                            and td[BBOX_ROWS[2], t] >= cx0
                            and td[BBOX_ROWS[1], t] <= cy1
                            and td[BBOX_ROWS[3], t] >= cy0
                        ]
                        s, c = starts[ci, tile], counts[ci, tile]
                        seg = binned[:, s : s + c]
                        assert list(seg[B_TID].astype(int)) == expect, (
                            f"seed {seed} class {ci} tile {tile}"
                        )
                        if expect:
                            want = slim_src[:, expect].copy()
                            want[B_TID] = expect  # binning stamps the tid row
                            np.testing.assert_array_equal(seg, want)

    def test_classes_overflow_accounting(self):
        """Per-class overflow + stored counts must add up to each class's
        true pair total, with truncation dropping from the last class first
        (stream order opaque|masked|blended)."""
        rng = np.random.default_rng(23)
        tiles_x, tiles_y, tile_w, tile_h = 5, 4, 128, 96
        td = _fake_tri_data(rng, 280, 300, tiles_x, tiles_y, tile_w, tile_h)
        cap = 64
        # ample row bucket: this test pins PAIR-truncation accounting; row
        # truncation has its own loud scalar (row_overflow)
        _, _, cc, oc = binning.bin_triangle_classes(
            jnp.asarray(td), (0, 200, 250, 300),
            tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
            pair_capacity=cap, row_capacity=1 << 14,
        )[:4]
        cc, oc = np.asarray(cc), np.asarray(oc)
        # oracle pair totals per class
        xmin, ymin, xmax, ymax = (td[k] for k in BBOX_ROWS)
        tx0 = np.clip(np.ceil((xmin + 0.5) / tile_w - 1.0), 0, tiles_x - 1)
        tx1 = np.clip(np.floor((xmax - 0.5) / tile_w), 0, tiles_x - 1)
        ty0 = np.clip(np.ceil((ymin + 0.5) / tile_h - 1.0), 0, tiles_y - 1)
        ty1 = np.clip(np.floor((ymax - 0.5) / tile_h), 0, tiles_y - 1)
        npairs = np.where(
            td[VALID_ROW] > 0,
            np.maximum(tx1 - tx0 + 1, 0) * np.maximum(ty1 - ty0 + 1, 0), 0,
        ).astype(int)
        totals = np.array(
            [npairs[0:200].sum(), npairs[200:250].sum(), npairs[250:300].sum()]
        )
        np.testing.assert_array_equal(cc.sum(axis=1) + oc, totals)
        assert oc.sum() == totals.sum() - cap
        # earlier classes only overflow once later ones are fully dropped
        assert oc[0] == max(0, totals[0] - cap)

    def test_scaling_tool_workload_is_real(self):
        """tools/binning_scaling.py's synthetic workload must consist of
        triangles that SURVIVE triangle_setup (winding/front-face — a
        regression here silently measures an empty stream) and calibrate
        the ragged pair demand to its target within tolerance."""
        from tools.binning_scaling import _make_tri_data, synthetic_tri_data

        tiles_x, tiles_y, tile_w, tile_h = 15, 34, 128, 32
        W, H = tiles_x * tile_w, tiles_y * tile_h
        rng = np.random.default_rng(3)
        clip, tri_v = _make_tri_data(64, W, H, rng)
        td = np.asarray(setup.triangle_setup(clip, tri_v, 64, W, H))
        assert td[VALID_ROW].sum() == 64  # every synthetic triangle is live

        target = 50_000
        td2, _n = synthetic_tri_data(target, tiles_x, tiles_y, tile_w, tile_h)
        cap = 1 << 17
        out = binning.bin_triangle_classes(
            td2, (0, td2.shape[1]),
            tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
            pair_capacity=cap, row_capacity=cap,
        )
        demand = int(np.asarray(out[5]))
        assert 0.5 * target <= demand <= 1.5 * target, demand


class TestSkinning:
    def _geom_frame(self, rng, skinned_flag):
        nv = 8
        geom = {
            "positions": jnp.asarray(rng.normal(size=(nv, 3)).astype(np.float32)),
            "uvs": jnp.zeros((nv, 2), jnp.float32),
            "normals": jnp.asarray(rng.normal(size=(nv, 3)).astype(np.float32)),
            "tangents": jnp.asarray(rng.normal(size=(nv, 4)).astype(np.float32)),
            "joints": jnp.asarray(rng.integers(0, 4, (nv, 4)).astype(np.int32)),
            "weights": jnp.asarray(
                rng.dirichlet(np.ones(4), nv).astype(np.float32)
            ),
            "exp_src": jnp.arange(nv, dtype=jnp.int32),
            "exp_draw": jnp.zeros(nv, jnp.int32),
            "tri_v": jnp.zeros((256, 3), jnp.int32),
        }
        model = np.eye(3, 4, dtype=np.float32)
        model[:, 3] = [1, 2, 3]
        palette = rng.normal(size=(8, 3, 4)).astype(np.float32)
        frame = {
            "transforms": jnp.asarray(model[None]),
            "normal_mats": jnp.asarray(np.eye(3, dtype=np.float32)[None]),
            "joints_offset": jnp.asarray([2], jnp.int32),
            "joint_palette": jnp.asarray(palette),
            "skinned": jnp.asarray([skinned_flag], jnp.int32),
            "proj_view": jnp.eye(4),
        }
        return geom, frame, model, palette

    def _expected_world(self, geom, model, palette):
        pos = np.asarray(geom["positions"])
        joints = np.asarray(geom["joints"]) + 2
        weights = np.asarray(geom["weights"])
        out = []
        for i in range(pos.shape[0]):
            skin = sum(weights[i, j] * palette[joints[i, j]] for j in range(4))
            m = model[:, :3] @ skin  # [3,4]
            world = m[:, :3] @ pos[i] + m[:, 3] + model[:, 3]
            out.append(world)
        return np.stack(out)

    def test_partitioned_matches_numpy(self):
        rng = np.random.default_rng(11)
        geom, frame, model, palette = self._geom_frame(rng, 1)
        vs = vertex_stage.run_vertex_stage(geom, frame, skin_start=0)
        got = np.asarray(vs["clip"][:, :3])  # proj_view = identity → world
        np.testing.assert_allclose(
            got, self._expected_world(geom, model, palette), rtol=2e-5, atol=2e-5
        )

    def test_flag_mode_matches_partitioned(self):
        rng = np.random.default_rng(13)
        geom, frame, model, palette = self._geom_frame(rng, 1)
        a = vertex_stage.run_vertex_stage(geom, frame, skin_start=0)
        b = vertex_stage.run_vertex_stage(geom, frame, skin_start=None)
        np.testing.assert_allclose(
            np.asarray(a["clip"]), np.asarray(b["clip"]), atol=1e-6
        )

    def test_static_ignores_palette(self):
        rng = np.random.default_rng(17)
        geom, frame, model, _ = self._geom_frame(rng, 0)
        vs = vertex_stage.run_vertex_stage(geom, frame, skin_start=None)
        pos = np.asarray(geom["positions"])
        expected = pos @ model[:, :3].T + model[:, 3]
        np.testing.assert_allclose(
            np.asarray(vs["clip"][:, :3]), expected, rtol=1e-6, atol=1e-6
        )
