"""The port's event hub, phase timer, spans, field-snapshot stream and
profiler trace, against the JAX reference's ``utils.events`` on the CPU.

The snapshot stream runs on a mesh carried across from the reference's
(``convert.mesh_from_numpy``): each yielded field within 2e-5 of the
reference's field's peak (the float32 bound of ``test_torch_canonical.py``
against the reference's fused multiply-adds).
"""

import json
import os
import sys
import threading
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayverb_tpu.core.geometry import Box as JBox
from wayverb_tpu.utils import events as jev
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu.waveguide.receivers import NodeReceiver as JNodeReceiver
from wayverb_tpu.waveguide.sources import HardSource as JHardSource
from wayverb_tpu.waveguide.sources import impulse_signal as j_impulse
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.utils import events
from wayverb_tpu_torch.utils.events import (STATES, EventHub, PhaseTimer,
                                            iter_pressure_fields,
                                            profiler_trace)
from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
from wayverb_tpu_torch.waveguide.receivers import NodeReceiver
from wayverb_tpu_torch.waveguide.sources import HardSource, impulse_signal

torch.set_num_threads(2)

FS = 3333.33
DX = grid_spacing(340.0, 1.0 / FS)


def test_event_hub_connect_fire_disconnect():
    assert STATES == jev.STATES
    hub = EventHub()
    got = []
    fn = hub.connect("engine_state_changed", lambda s, p: got.append((s, p)))
    hub.fire("engine_state_changed", STATES[2], 0.5)
    hub.disconnect("engine_state_changed", fn)
    hub.fire("engine_state_changed", STATES[3], 0.7)
    hub.disconnect("never_connected", fn)
    assert got == [("starting_raytracer", 0.5)]


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("setup"):
        pass
    with t.phase("run"):
        pass
    with t.phase("run"):
        pass
    assert t.counts == {"setup": 1, "run": 2}
    assert all(v >= 0.0 for v in t.timings.values())
    assert "run" in t.report() and "(2x)" in t.report()
    with t.phase("setup") as took:
        pass
    assert took.seconds >= 0.0 and t.counts["setup"] == 2


@pytest.fixture
def clean_totals():
    events.reset_totals()
    yield
    events.reset_totals()


def test_span_adds_to_totals_and_nests(clean_totals):
    with events.span("outer") as outer:
        with events.span("inner") as inner:
            pass
        with events.span("inner"):
            pass
    totals = events.totals()
    assert set(totals) == {"outer", "inner"}
    assert totals["outer"][1] == 1 and totals["inner"][1] == 2
    assert totals["outer"][0] == outer.seconds >= inner.seconds >= 0.0
    assert totals["outer"][0] >= totals["inner"][0]
    events.reset_totals()
    assert events.totals() == {}


def _profiled_spans(prof):
    """(name, start ns, end ns) of the profiler's ``wayverb.*`` events."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(events.SPAN_PREFIX)]


def test_span_is_a_profiler_range_while_one_records(clean_totals):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with events.span("outer"):
            torch.ones(8) + 1
            with events.span("inner"):
                torch.ones(8) * 2
    spans = _profiled_spans(prof)
    assert Counter(n for n, _, _ in spans) == {"wayverb.outer": 1,
                                               "wayverb.inner": 1}
    (_, o0, o1), = [s for s in spans if s[0] == "wayverb.outer"]
    (_, i0, i1), = [s for s in spans if s[0] == "wayverb.inner"]
    assert o0 <= i0 <= i1 <= o1
    assert events.totals()["outer"][1] == 1


def test_span_enters_no_range_without_a_profiler(clean_totals, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for _ in range(3):
        with events.span("quiet"):
            pass
    assert entered == [] and events.totals()["quiet"][1] == 3
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with events.span("loud"):
            pass
    assert entered == ["wayverb.loud"]


def test_span_totals_lose_no_entry_across_threads(clean_totals):
    """More threads than cores end spans of one name at once."""
    n_threads, n_spans = 2 * (os.cpu_count() or 4), 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with events.span("shared"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert events.totals()["shared"][1] == n_threads * n_spans


def test_field_snapshot_stream_matches_reference():
    jm = j_run.shoebox_mesh(JBox((0, 0, 0), (1.2, 1.3, 1.4)),
                            np.full((1, 8), 0.1), DX, FS)
    d, s = jm.descriptor, jm.box_spec
    tm = convert.mesh_from_numpy({
        "min_corner": np.asarray(d.min_corner),
        "dimensions": np.asarray(d.dimensions), "spacing": d.spacing,
        "inside": np.asarray(jm.inside),
        "coef_b": np.asarray(jm.structure.coef_b),
        "coef_a": np.asarray(jm.structure.coef_a),
        "room_volume": jm.room_volume,
        "box_dims": np.asarray(s.dims), "box_ilo": np.asarray(s.ilo),
        "box_ihi": np.asarray(s.ihi),
        "box_face_surface": np.asarray(s.face_surface)}, device="cpu")
    src = d.flat_index(jm.require_inside((0.6, 0.6, 0.4)))
    rcv = d.flat_index(jm.require_inside((0.6, 0.6, 1.0)))
    steps = 24
    want = list(jev.iter_pressure_fields(
        jm, JHardSource(node_idx=jnp.asarray(src, jnp.int32),
                        signal=j_impulse(steps, 1.0)),
        JNodeReceiver(node_idx=jnp.asarray(rcv, jnp.int32)), steps, every=8))
    got = list(iter_pressure_fields(
        tm, HardSource(node_idx=int(src),
                       signal=impulse_signal(steps, 1.0, "cpu")),
        NodeReceiver(node_idx=torch.tensor(int(rcv))), steps, every=8))
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == [8, 16, 24]
    for (_, gf, go), (_, wf, wo) in zip(got, want):
        wf = np.asarray(wf)
        assert tuple(gf.shape) == wf.shape == d.dimensions
        assert bool(torch.any(gf != 0))     # the wavefront is visible
        np.testing.assert_allclose(gf.numpy(), wf, rtol=0,
                                   atol=2e-5 * np.abs(wf).max())
        np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=0,
                                   atol=2e-5 * np.abs(wf).max())


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiler_trace(log_dir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert len(prof.key_averages()) > 0
