"""Binning cost vs pair count — the scale-axis measurement (VERDICT r2 #1).

Times `bin_triangle_classes` (and its argsort in isolation) at pair
capacities 1M/2M/4M/8M, with the synthetic workload sized so the ACTUAL
pair count tracks capacity (~60% full — the steady state the Renderer's
auto grow/shrink maintains). Uses the fori_loop slope harness
(engine/stats._time_call): each timing repeats the stage inside ONE dispatch
and subtracts a paired shorter dispatch, cancelling dispatch overhead.

What this demonstrates: the sort is a minor, near-linear term — the binned
payload gather/scatter (O(pairs · B_ROWS) HBM traffic) dominates, so total
binning cost tracks ACTUAL PAIRS ~linearly. The stable argsort gives the
stable ranks the order-dependent classes need; what matters for the scale
axis is that its share stays small.

Run: python -m tools.binning_scaling [reps] [cpu]

`cpu` forces the CPU backend: the CPU curve validates the algorithm's
complexity — the same XLA program structure runs on both backends.
"""

from __future__ import annotations

import json
import sys

import numpy as np

import jax
import jax.numpy as jnp

from renderer_tpu.engine.stats import _time_call
from renderer_tpu.raster import binning
from renderer_tpu.raster.setup import triangle_setup


def _make_tri_data(n: int, w: int, h: int, rng) -> tuple:
    """n random triangles through the REAL `triangle_setup` (screen-space,
    w = 1): a mix of small (sub-tile) and medium (several-tile) right
    triangles, each covering ~half its bbox — so the ragged expansion's
    per-row edge windows and the trivial reject see authentic planes."""
    x0 = rng.uniform(0, w - 2, n)
    y0 = rng.uniform(0, h - 2, n)
    medium = rng.random(n) < 0.2
    bw = np.where(medium, rng.uniform(128, 3 * 128, n), rng.uniform(2, 64, n))
    bh = np.where(medium, rng.uniform(32, 4 * 32, n), rng.uniform(2, 32, n))
    bw = np.minimum(bw, w - x0)
    bh = np.minimum(bh, h - y0)
    # right triangle on the bbox: (x0,y0) (x0+bw,y0) (x0,y0+bh); the vertex
    # order that survives setup's front-face test was checked empirically
    px = np.stack([x0, x0, x0 + bw], axis=1).ravel()
    py = np.stack([y0, y0 + bh, y0], axis=1).ravel()
    clip = np.zeros((3 * n, 4), np.float32)
    clip[:, 0] = 2.0 * px / w - 1.0  # setup: xs = (X/W·0.5+0.5)·width, W=1
    clip[:, 1] = 2.0 * py / h - 1.0
    clip[:, 2] = rng.uniform(0.05, 0.95, 3 * n)
    clip[:, 3] = 1.0
    tri_v = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return jnp.asarray(clip), jnp.asarray(tri_v)


def synthetic_tri_data(n_pairs_target: int, tiles_x: int, tiles_y: int,
                       tile_w: int, tile_h: int, seed: int = 11):
    """Triangle-setup output whose RAGGED expansion demand (the quantity
    pair_capacity holds) is ~n_pairs_target. Demand per triangle depends on
    the edge-plane row windows, so it is calibrated empirically: generate a
    probe batch, measure its demand with a tiny `bin_triangle_classes`
    readback, then scale the triangle count."""
    rng = np.random.default_rng(seed)
    w, h = tiles_x * tile_w, tiles_y * tile_h

    def setup(n):
        clip, tri_v = _make_tri_data(n, w, h, rng)
        return triangle_setup(clip, tri_v, n, w, h)

    probe_n = 4096
    td = setup(probe_n)
    cap = 1 << 20
    out = binning.bin_triangle_classes(
        td, (0, probe_n), tiles_x=tiles_x, tiles_y=tiles_y,
        tile_w=tile_w, tile_h=tile_h, pair_capacity=cap, row_capacity=cap)
    probe_demand = int(np.asarray(out[5]))
    assert probe_demand > 0, "synthetic workload produced no coverage"
    n = int(round(n_pairs_target * probe_n / probe_demand))
    return setup(n), n


def main():
    if "cpu" in sys.argv[1:]:
        jax.config.update("jax_platforms", "cpu")
    reps = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 16
    tiles_x, tiles_y, tile_w, tile_h = 15, 34, 128, 32  # the 1080p grid
    rows = []
    for cap_log2 in (20, 21, 22, 23):  # 1M, 2M, 4M, 8M
        cap = 1 << cap_log2
        td, n_tris = synthetic_tri_data(int(cap * 0.6), tiles_x, tiles_y,
                                        tile_w, tile_h)

        def bin_fn(td_):
            return binning.bin_triangle_classes(
                td_, (0, n_tris),
                tiles_x=tiles_x, tiles_y=tiles_y,
                tile_w=tile_w, tile_h=tile_h, pair_capacity=cap,
                row_capacity=cap,
            )

        # actual expansion demand for the honesty column (tiny readback;
        # done before any timing in this process would matter —
        # binning_scaling is a measurement tool, not a bench)
        _b, _s, counts, ov, _rov, pair_dem, _rd = bin_fn(td)
        actual = int(np.asarray(pair_dem))

        ms_total = _time_call(bin_fn, td, iters=reps)

        # the sort alone, same key distribution
        key = np.random.default_rng(3).integers(
            0, tiles_x * tiles_y, cap
        ).astype(np.int32)
        key_dev = jnp.asarray(key)

        def sort_fn(k):
            return jnp.argsort(k.astype(jnp.int32), stable=True)

        # argsort input must be int; _time_call perturbs the first FLOAT
        # leaf, so wrap with a float carrier
        def sort_wrapped(kf):
            return sort_fn(kf.astype(jnp.int32))

        ms_sort = _time_call(sort_wrapped, key_dev.astype(jnp.float32),
                             iters=reps)

        rows.append({
            "pair_capacity": cap,
            "triangles": n_tris,
            "actual_pairs": actual,
            "binning_ms": round(ms_total, 4),
            "argsort_ms": round(ms_sort, 4),
            "sort_share": round(ms_sort / max(ms_total, 1e-9), 3),
        })
        print(json.dumps(rows[-1]), flush=True)

    base = rows[0]
    print("\n| capacity | actual pairs | binning ms | argsort ms | "
          "scale vs 1M |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['pair_capacity'] >> 20}M | {r['actual_pairs']} | "
              f"{r['binning_ms']:.3f} | {r['argsort_ms']:.3f} | "
              f"{r['binning_ms'] / base['binning_ms']:.2f}x |")
    import os

    os._exit(0)  # never hang on teardown


if __name__ == "__main__":
    main()
