"""The rate and idle arithmetic on synthetic intervals."""

import pytest

from portbench.harness import timing


def test_rate_counts_only_requests_inside_the_window():
    rate, done = timing.closed_loop_rate(10.0, [11.0, 12.0, 13.0, 14.5],
                                         4.0, 2.0)
    assert done == 3 and rate == pytest.approx(3 * 2.0 / 3.0)


def test_a_stall_inside_the_window_lowers_the_rate():
    steady, _ = timing.closed_loop_rate(0.0, [1.0, 2.0, 3.0, 4.0], 5.0, 1.0)
    stalled, _ = timing.closed_loop_rate(0.0, [1.0, 2.0, 3.6, 4.6], 5.0, 1.0)
    assert stalled < steady
    assert stalled == pytest.approx(4 / 4.6)


def test_rate_reader_takes_the_window_of_a_run():
    from portbench.harness import manifest, readers
    ctx = {"setup_s": 3.5, "window": {
        "start": 0.0, "requests": [(0.0, 1.0), (1.0, 2.0), (2.0, 3.6)],
        "seconds": 5.0, "work_each": 2.0}}
    assert readers.rate(ctx) == pytest.approx(6.0 / 3.6)
    for name in ("box_wg_gnodes_per_s", "general_wg_gnodes_per_s",
                 "fit_iters_per_s"):
        assert manifest.module("end_to_end", name).read(ctx) == \
            pytest.approx(6.0 / 3.6)
    assert manifest.module("end_to_end", "setup_s").read(ctx) == 3.5


def test_no_request_inside_the_window_gives_no_rate():
    assert timing.closed_loop_rate(0.0, [6.0], 5.0, 1.0) == (None, 0)


def test_busy_is_the_union_and_idle_the_rest():
    ops = [(0.1, 0.3), (0.2, 0.4), (0.6, 0.7), (0.95, 1.2)]
    assert timing.busy(ops, 0.0, 1.0) == pytest.approx(0.45)
    gaps = timing.gaps(ops, 0.0, 1.0)
    assert gaps == [(0.0, 0.1), (0.4, 0.6), (0.7, 0.95)]
    assert sum(e - s for s, e in gaps) == pytest.approx(0.55)


def test_idle_gaps_take_the_innermost_span():
    spans = [(0.0, 1.0, "render"), (0.35, 0.65, "sync")]
    out = timing.idle_by_label([(0.1, 0.4), (0.6, 0.9)], 0.0, 1.0,
                               lambda t: timing.label_at(spans, t))
    assert dict(out) == pytest.approx({"render": 0.2, "sync": 0.2})


def test_top_ops_sum_by_name():
    ops = [("a", 0.0, 0.2), ("b", 0.2, 0.3), ("a", 0.3, 0.4)]
    assert timing.top_ops(ops) == [["a", pytest.approx(0.3)],
                                   ["b", pytest.approx(0.1)]]


def test_readers_on_a_synthetic_slice():
    from portbench.harness import readers
    ops = [("void mesh_weighted_step_kernel(float const*)", 0.0, 0.1),
           ("elementwise", 0.1, 0.15), ("mesh_weighted_step_kernel", 0.5,
                                        0.6)]
    ctx = {"slice": {"ops": ops, "lo": 0.0, "hi": 1.0, "steps": 2},
           "shape": {"dims": (100, 100, 100), "order": 6, "taps": 7,
                     "chunk": 128}}
    assert readers.idle_pct(ctx) == pytest.approx(75.0)
    assert readers.launches_per_step(ctx) == pytest.approx(1.5)
    assert readers.other_device_us_per_step(ctx, ["b8"]) == \
        pytest.approx(25000.0)
    bound = 16e6 / 3.35e12            # B8 on 1e6 nodes is bound by bytes
    assert readers.roofline_pct(ctx, ["b8"]) == pytest.approx(
        100 * 2 * bound / 0.2)
    assert readers.roofline_pct({"slice": None}, ["b8"]) is None
