"""The ray timing tool (``python -m wayverb_tpu_torch.tools.rays_timing``) on
the CPU, at a small size: its trace rows through every backend, and its
kernel mode's plain path (the recorded queries, the gate's work per ray
tile, the comparison to the bit).  Its times here are the host's; on the card
it times the kernels.  No JAX."""

from unittest import mock

import pytest
import torch

from wayverb_tpu_torch.raytracer import mt_kernels as mk
from wayverb_tpu_torch.tools import rays_timing as rt


def test_trace_rows_agree_across_backends():
    """``mt``, ``dense`` and ``grid`` trace the same rays of the model hall
    and deposit the same energy (a hit on a shared edge may take either
    triangle: 1e-3, as the card test of the MT kernels against the DDA);
    so do the culled and all-pairs tables of the large hall."""
    rows = rt.main(["--device", "cpu", "--rays", "256", "--depth", "2",
                    "--reps", "1"])
    by = {r["backend"]: r for r in rows}
    assert list(by) == ["mt", "dense", "grid", "large_b4",
                        "large_all_pairs"]
    for r in rows:
        assert r["rays"] == 256 and r["bounces"] == 2
        assert r["ray_bounces_per_s"] == pytest.approx(512 / r["seconds"])
        assert r["energy"] > 0
        # CPU tensors take the plain versions: no kernel launches
        assert not any(r["launches"].values())
    for a, b in (("mt", "dense"), ("mt", "grid"),
                 ("large_b4", "large_all_pairs")):
        assert by[a]["energy"] == pytest.approx(by[b]["energy"], rel=1e-3)
    assert by["large_b4"]["triangles"] > mk.CULL_MIN_TRIS


def test_kernel_mode_counts_the_gate_per_ray_tile():
    """``--kernel b4``'s plain path: bit-equal on both recorded queries,
    and the triangle tiles each ray tile scanned equal a recount of the
    plain version run on that ray tile's rays alone."""
    rows = rt.main(["--device", "cpu", "--kernel", "b4", "--rays", "700",
                    "--late-bounce", "2", "--reps", "1"])
    (row,) = rows
    assert row["key"] == "b4" and row["max_abs_err"] == 0.0
    stats = row["tile_stats"]
    tiles = stats["triangle_tiles"]
    assert stats["ray_tiles"] == 2 and sum(stats["histogram_by_tenths"]) == 2
    assert row["scanned_tile_pairs"] == pytest.approx(
        stats["mean"] * stats["ray_tiles"])
    assert 0 < stats["max"] <= tiles
    assert row["tile_pairs_run"] == pytest.approx(
        row["scanned_tile_pairs"] / (2 * tiles))
    assert row["bound"][0] > 1e6 * rt.MT_OPS_PER_PAIR * mk.RB * mk.TB \
        * row["scanned_tile_pairs"] / rt.roofline.F32_FLOP_PER_S

    soup = rt.procedural_hall_large(shell_div=30, n_columns=6)[0]
    tris = mk.build_mt_triangles(soup, cull=True)
    o, d, ex = rt.record_queries(soup, tris, rt.SRC, rt.RCV, {4},
                                 num_rays=700)[4]
    real = (mk._mt_tile, mk._ray_blocks)
    (t, i), counts = rt.plain_with_tile_counts(tris, o, d, ex)
    assert (mk._mt_tile, mk._ray_blocks) == real
    assert sum(counts) == row["scanned_tile_pairs"]
    for k, r0 in enumerate(range(0, 700, mk.RB)):
        sl = slice(r0, r0 + mk.RB)
        with mock.patch.object(mk, "_mt_tile", wraps=mk._mt_tile) as tile:
            tk, ik = mk._closest_culled_plain(o[sl], d[sl], ex[sl], tris)
        assert tile.call_count == counts[k]
        assert torch.equal(tk, t[sl]) and torch.equal(ik, i[sl])


def test_tile_stats_and_the_counting_wrapper():
    stats = rt.tile_stats([0, 10, 10, 5, 95, 95], 95)
    assert stats["max"] == 95 and stats["min"] == 0
    assert stats["mean"] == pytest.approx(215 / 6)
    assert stats["histogram_by_tenths"] == [2, 2, 0, 0, 0, 0, 0, 0, 0, 2]
    assert stats["percentiles"][4] == pytest.approx(10.0)
    # the wrapper restores the module's functions when the plain run fails
    real = (mk._mt_tile, mk._ray_blocks)
    tris = mk.build_mt_triangles(rt.procedural_hall(2, 0, 1)[0], cull=True)
    with pytest.raises(Exception):
        rt.plain_with_tile_counts(tris, torch.zeros(3, 3), torch.zeros(3, 2),
                                  torch.zeros(3, dtype=torch.int32))
    assert (mk._mt_tile, mk._ray_blocks) == real


def test_the_card_mode_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA"):
        rt.main(["--kernel", "b4"])


def test_bounds_share_one_rule():
    """B3's and B4's bounds come from ``tools.roofline``: the larger of the
    bytes over the memory rate and the operations over the float32 rate."""
    from wayverb_tpu_torch.tools import roofline
    assert roofline.bound_us(3.35e6, 0) == (pytest.approx(1.0), "bytes")
    assert roofline.bound_us(0, 67e6) == (pytest.approx(1.0), "operations")
    assert roofline.bound_us(3.35e6, 67e6)[1] == "bytes"
    tris = mk.build_mt_triangles(rt.procedural_hall(2, 0, 1)[0], cull=True)
    rays, pairs = 700, 3
    n_bytes = 36 * rays + 4 * (tris.packed.numel() + tris.tile_boxes.numel())
    ops = rt.SLAB_OPS_PER_TILE * rays * tris.tile_boxes.shape[0] \
        + rt.MT_OPS_PER_PAIR * mk.RB * mk.TB * pairs
    assert rt.bound_us(rays, tris, pairs) == roofline.bound_us(n_bytes, ops)


def test_kernel_mode_b3_reads_the_skip_tests():
    """``--kernel b3``'s plain path on both halls: bit-equal on both
    queries, and the skip tests' shares, in the tracer's order, equal to a
    recount per warp over the whole table."""
    rows = rt.main(["--device", "cpu", "--kernel", "b3", "--rays", "128",
                    "--late-bounce", "2", "--reps", "1"])
    assert [r["key"] for r in rows] == ["b3", "b3_large"]
    for row in rows:
        assert row["max_abs_err"] == 0.0 and row["plain_us"] > 0
        for query in ("closest", "visibility"):
            sh = row["skip_shares"][query]
            assert sh["warp_triangle_pairs"] == 4 * (
                5448 if row["key"] == "b3" else 13392)
            assert 0.0 <= sh["test1_drops"] <= sh["test1_or_2_drops"] <= 1.0

    soup = rt.procedural_hall()[0]
    tris = mk.build_mt_triangles(soup, cull=False)
    o, d, _ = rt.record_queries(soup, tris, rt.MODEL_SRC, rt.MODEL_RCV, {4},
                                num_rays=100)[4]
    got = rt.skip_shares(o, d, tris, chunk=64)
    pad = torch.nn.functional.pad
    pass_u, pass_uv = mk._skip_tests_plain(pad(o, (0, 0, 0, 28)),
                                           pad(d, (0, 0, 0, 28)),
                                           tris.packed[:, :tris.num])
    for key, passed in (("test1_drops", pass_u),
                        ("test1_or_2_drops", pass_uv)):
        kept = passed.view(4, 32, tris.num).any(1)
        assert got[key] == pytest.approx(1.0 - float(kept.float().mean()))
