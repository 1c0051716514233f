"""The readers of the program's spans on slices built by hand: host spans,
nested spans, spans on two threads and device operations across a span's
edges."""

import pytest

from portbench.harness import manifest, program_spans

NEW = ("replay_taps_ms.box", "replay_idle_ms.box", "mega_forward_ms.box",
       "theta_grads_ms.fit", "theta_grads_idle_ms.fit", "chunk_bwd_ms.fit",
       "setup_regions_s", "setup_kernels_s")


def _read(name, ctx):
    return manifest.module("metrics", name).read(ctx)


def _render_slice():
    """Two renders: each a canonical span holding a forward span and a
    replay span, with the harness's own host ops beside them."""
    host = [(0.0, 1.0, "wayverb.canonical"),
            (0.0, 0.1, "wayverb.mega.forward"),
            (0.1, 0.9, "wayverb.mega.replay_taps"),
            (0.2, 0.3, "aten::mul"),
            (1.0, 2.0, "wayverb.canonical"),
            (1.05, 1.15, "wayverb.mega.forward"),
            (1.2, 1.8, "wayverb.mega.replay_taps")]
    # the chunks run 0.05-0.5 (across the replay's start) and 1.1-1.4;
    # one op 0.85-0.95 crosses the first replay's end
    ops = [("mega_chunk_kernel", 0.05, 0.5), ("elementwise", 0.85, 0.95),
           ("mega_chunk_kernel", 1.1, 1.4), ("elementwise", 1.3, 1.35)]
    return {"slice": {"host": sorted(host), "ops": ops, "spans": [],
                      "lo": 0.0, "hi": 2.0, "steps": 2},
            "timings": {}}


def _fit_slice():
    """One iteration: a backward span on another thread's clock holding two
    chunk_bwd and two theta_grads spans, the forward before it."""
    host = [(0.0, 0.1, "wayverb.mega.forward"),
            (0.2, 1.2, "wayverb.mega.backward"),
            (0.2, 0.25, "wayverb.mega.chunk_bwd"),
            (0.25, 0.65, "wayverb.mega.theta_grads"),
            (0.65, 0.7, "wayverb.mega.chunk_bwd"),
            (0.7, 1.1, "wayverb.mega.theta_grads"),
            (0.3, 0.31, "autograd::engine::evaluate_function: MulBackward0")]
    ops = [("mega_chunk_bwd_kernel", 0.22, 0.4),
           ("elementwise", 0.5, 0.55), ("elementwise", 0.6, 0.75),
           ("elementwise", 1.0, 1.3)]
    return {"slice": {"host": sorted(host), "ops": ops, "spans": [],
                      "lo": 0.0, "hi": 1.3, "steps": 1},
            "timings": {}}


def test_seconds_count_and_idle_of_a_name():
    ctx = _render_slice()
    assert program_spans.count(ctx, "canonical") == 2
    assert program_spans.seconds(ctx, "mega.replay_taps") == \
        pytest.approx(0.8 + 0.6)
    # replay 0.1-0.9: busy 0.1-0.5 and 0.85-0.9 -> idle 0.8 - 0.45
    # replay 1.2-1.8: busy 1.2-1.4 -> idle 0.6 - 0.2
    assert program_spans.idle_seconds(ctx, "mega.replay_taps") == \
        pytest.approx(0.35 + 0.4)
    assert program_spans.seconds(ctx, "mega.nothing") is None
    assert program_spans.idle_seconds(ctx, "mega.nothing") is None
    assert program_spans.ms_per(ctx, 1.0, "mega.nothing") is None


def test_render_readers():
    ctx = _render_slice()
    assert _read("replay_taps_ms.box", ctx) == pytest.approx(1e3 * 1.4 / 2)
    assert _read("replay_idle_ms.box", ctx) == pytest.approx(1e3 * 0.75 / 2)
    assert _read("mega_forward_ms.box", ctx) == pytest.approx(1e3 * 0.2 / 2)
    for name in ("theta_grads_ms.fit", "chunk_bwd_ms.fit",
                 "theta_grads_idle_ms.fit"):
        assert _read(name, ctx) is None


def test_fit_readers_nested_under_the_backward():
    ctx = _fit_slice()
    assert program_spans.count(ctx, "mega.backward") == 1
    assert _read("theta_grads_ms.fit", ctx) == pytest.approx(1e3 * 0.8)
    assert _read("chunk_bwd_ms.fit", ctx) == pytest.approx(1e3 * 0.1)
    # theta 0.25-0.65: busy 0.25-0.4, 0.5-0.55, 0.6-0.65 -> idle 0.4 - 0.25
    # theta 0.7-1.1: busy 0.7-0.75, 1.0-1.1 -> idle 0.4 - 0.15
    assert _read("theta_grads_idle_ms.fit", ctx) == \
        pytest.approx(1e3 * (0.15 + 0.25))
    for name in ("replay_taps_ms.box", "replay_idle_ms.box",
                 "mega_forward_ms.box"):
        assert _read(name, ctx) is None


def test_a_program_without_spans_reads_nothing():
    """The slice of a program that records no span of its own."""
    ctx = _render_slice()
    ctx["slice"]["host"] = [h for h in ctx["slice"]["host"]
                            if not h[2].startswith("wayverb.")]
    for name in NEW[:6]:
        assert _read(name, ctx) is None


def test_setup_readers():
    from wayverb_tpu_torch.utils import events
    ctx = {"timings": {"regions_s": 0.75}}
    assert _read("setup_regions_s", ctx) == 0.75
    assert _read("setup_regions_s", {"timings": {}}) is None
    events.reset_totals()
    try:
        ctx = _render_slice()
        assert _read("setup_kernels_s", ctx) is None
        with events.span("kernels.load:box_mega_chunk") as a:
            with events.span("kernels.build:box_mega_chunk"):
                pass
        with events.span("kernels.load:box_fused_step") as b:
            pass
        with events.span("canonical"):
            pass
        assert _read("setup_kernels_s", ctx) == pytest.approx(
            a.seconds + b.seconds)
        assert _read("setup_kernels_s", {"timings": {}}) is None
    finally:
        events.reset_totals()


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_from_an_empty_context(name):
    assert _read(name, {"timings": {}}) is None
