"""The port's chunked waveguide runner against one continuous run and
against the JAX reference's ``checkpoint``, on the CPU.

The reference's four tests are ported as they are.  Then, on all three
routes (the fused box body, the region body of a box too thin for the plane
solver, the general body): chunks equal one continuous run of the route's
``run_*`` function to the bit; a state saved and loaded, and a cancelled
run resumed, continue to the bit; states and snapshots do not alias the
buffers of later chunks; a NaN born inside a chunk clears ``stable``.
Across the packages: a state made by the reference's ``run_chunk`` and
carried over with ``convert.waveguide_state_from_numpy`` resumes in the
port, and a snapshot written by the port's ``save_state`` loads in the
reference's ``load_state``; both continue within 2e-5 of the outputs' peak
(the bound of ``test_torch_canonical.py`` against the default float32
reference, whose fused multiply-adds round differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayverb_tpu.core.geometry import Box as JBox
from wayverb_tpu.waveguide import checkpoint as jck
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu.waveguide.receivers import NodeReceiver as JNodeReceiver
from wayverb_tpu.waveguide.sources import HardSource as JHardSource
from wayverb_tpu.waveguide.sources import impulse_signal as j_impulse
from wayverb_tpu_torch import convert
from wayverb_tpu_torch.core.geometry import Box
from wayverb_tpu_torch.waveguide import checkpoint as ck
from wayverb_tpu_torch.waveguide import run as wgrun
from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
from wayverb_tpu_torch.waveguide.receivers import (DirectionalReceiver,
                                                   NodeReceiver,
                                                   make_directional_receiver)
from wayverb_tpu_torch.waveguide.setup import GENERAL_TABLE_DTYPES
from wayverb_tpu_torch.waveguide.sources import (HardSource, SoftSource,
                                                 impulse_signal)

torch.set_num_threads(2)

FS = 3333.33
DX = grid_spacing(340.0, 1.0 / FS)
BOX = ((0.0, 0.0, 0.0), (1.4, 1.6, 1.8))
SRC, RCV = (0.7, 0.8, 0.5), (0.7, 0.8, 1.3)
PARITY_REL = 2e-5
ROUTES = ["box", "regions", "general"]


def _setup():
    box = Box(*BOX)
    mesh = wgrun.shoebox_mesh(box, np.full((1, 8), 0.1), DX, FS,
                              device="cpu")
    desc = mesh.descriptor
    src = desc.flat_index(mesh.require_inside(SRC))
    rcv = desc.flat_index(mesh.require_inside(RCV))
    steps = 90
    source = HardSource(node_idx=src, signal=impulse_signal(steps, 1.0,
                                                            "cpu"))
    receiver = NodeReceiver(node_idx=torch.tensor(rcv))
    return mesh, source, receiver, steps


def _routed(mesh, route):
    if route == "box":
        return mesh
    if route == "regions":
        return dataclasses.replace(mesh, box_spec=None)
    return dataclasses.replace(mesh, box_spec=None, regions=None)


def _continuous(mesh, source, receiver, steps):
    """The route's own ``run_*`` function."""
    if mesh.box_spec is not None:
        return wgrun.run_waveguide_box(mesh.structure, mesh.box_spec, source,
                                       receiver, steps)
    dims = mesh.descriptor.dimensions
    if mesh.regions is not None:
        return wgrun.run_waveguide_regions(mesh.structure, dims, source,
                                           receiver, steps, mesh.regions)
    return wgrun.run_waveguide(mesh.structure, dims, source, receiver, steps)


def _equal(a, b):
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


# --- the reference's four tests, ported --------------------------------------

def test_chunked_equals_continuous():
    mesh, source, receiver, steps = _setup()
    ref = wgrun.execute(mesh, source, receiver, steps)["outputs"]
    state = ck.initial_state(mesh, receiver)
    pieces = []
    for chunk in (30, 30, 30):
        state, out = ck.run_chunk(mesh, source, receiver, state, chunk)
        pieces.append(out)
    assert torch.equal(torch.cat(pieces), ref)
    assert bool(state.stable)


def test_save_load_roundtrip(tmp_path):
    mesh, source, receiver, steps = _setup()
    state = ck.initial_state(mesh, receiver)
    state, out1 = ck.run_chunk(mesh, source, receiver, state, 40)
    path = str(tmp_path / "snap.npz")
    ck.save_state(path, state)
    restored = ck.load_state(path, mesh, receiver)
    assert restored.step == 40
    state_b, out2a = ck.run_chunk(mesh, source, receiver, state, 50)
    restored, out2b = ck.run_chunk(mesh, source, receiver, restored, 50)
    assert torch.equal(out2a, out2b)


class TestCancellable:
    def test_cancel_mid_run_and_resume(self):
        mesh, source, receiver, _ = _setup()
        steps = 24
        _, full_out = ck.run_cancellable(mesh, source, receiver, steps,
                                         keep_going=lambda: True, chunk=8)
        calls = {"n": 0}

        def kg():
            calls["n"] += 1
            return calls["n"] <= 2          # allow two chunks, then stop

        with pytest.raises(ck.Cancelled) as exc:
            ck.run_cancellable(mesh, source, receiver, steps, keep_going=kg,
                               chunk=8)
        part = exc.value
        assert part.state.step == 16
        assert torch.equal(part.outputs, full_out[:16])
        state, rest = ck.run_cancellable(
            mesh, source, receiver, steps - part.state.step,
            keep_going=lambda: True, chunk=8, state=part.state)
        assert torch.equal(rest, full_out[16:])
        assert state.step == steps

    def test_progress_callback(self):
        mesh, source, receiver, _ = _setup()
        seen = []
        ck.run_cancellable(mesh, source, receiver, 24,
                           keep_going=lambda: True, chunk=10,
                           on_progress=lambda s, t: seen.append((s, t)))
        assert seen[-1] == (24, 24)
        assert [s for s, _ in seen] == [10, 20, 24]


# --- every route, to the bit -------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_chunks_equal_the_routes_continuous_run(route):
    """Uneven chunks against the route's ``run_*`` function, with a
    directional receiver (a receiver state) and a soft source."""
    mesh, _, _, steps = _setup()
    mesh = _routed(mesh, route)
    desc = mesh.descriptor
    source = SoftSource(node_idx=desc.flat_index(mesh.require_inside(SRC)),
                        signal=impulse_signal(steps, 1.0, "cpu"))
    receiver = make_directional_receiver(
        desc, FS, 1.225, desc.position(mesh.require_inside(RCV)), "cpu")
    assert isinstance(receiver, DirectionalReceiver)
    want = _continuous(mesh, source, receiver, steps)
    state = ck.initial_state(mesh, receiver)
    pieces = []
    for chunk in (1, 36, 17, 36):
        state, out = ck.run_chunk(mesh, source, receiver, state, chunk)
        pieces.append(out)
    got = tuple(torch.cat(p) for p in zip(*pieces))
    assert _equal(got, want["outputs"])
    assert bool(state.stable) and bool(want["stable"])
    assert state.step == steps


@pytest.mark.parametrize("route", ROUTES)
def test_save_load_and_cancel_resume_bit_exact(route, tmp_path):
    mesh, source, receiver, steps = _setup()
    mesh = _routed(mesh, route)
    want = _continuous(mesh, source, receiver, steps)["outputs"]
    state, first = ck.run_chunk(mesh, source, receiver,
                                ck.initial_state(mesh, receiver), 40)
    path = str(tmp_path / f"{route}.npz")
    ck.save_state(path, state)
    restored = ck.load_state(path, mesh, receiver, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(ck.state_leaves(restored),
                                                  ck.state_leaves(state)))
    _, rest = ck.run_chunk(mesh, source, receiver, restored, steps - 40)
    assert torch.equal(torch.cat([first, rest]), want)

    calls = iter([True, True, False])
    with pytest.raises(ck.Cancelled) as exc:
        ck.run_cancellable(mesh, source, receiver, steps,
                           keep_going=lambda: next(calls), chunk=25)
    assert exc.value.state.step == 50
    _, tail = ck.run_cancellable(mesh, source, receiver, steps - 50,
                                 keep_going=lambda: True, chunk=25,
                                 state=exc.value.state)
    assert torch.equal(torch.cat([exc.value.outputs, tail]), want)


@pytest.mark.parametrize("route", ROUTES)
def test_states_and_snapshots_do_not_alias(route):
    """Every snapshot and state is collected first and compared after all
    chunks have run: each equals a fresh run to its step, and running twice
    from one state leaves it as it was and gives the same bits."""
    from wayverb_tpu_torch.utils.events import iter_pressure_fields
    mesh, source, receiver, _ = _setup()
    mesh = _routed(mesh, route)
    snaps = list(iter_pressure_fields(mesh, source, receiver, 30, every=6))
    assert [s for s, _, _ in snaps] == [6, 12, 18, 24, 30]
    for step, field, outputs in snaps:
        fresh, out = ck.run_chunk(mesh, source, receiver,
                                  ck.initial_state(mesh, receiver), step)
        assert torch.equal(field, fresh.current)
        assert torch.equal(outputs, out[-6:])
    fields = [f for _, f, _ in snaps]
    assert all(bool(torch.any(f != 0)) for f in fields)
    assert all(not torch.equal(a, b) for a, b in zip(fields, fields[1:]))

    s1, _ = ck.run_chunk(mesh, source, receiver,
                         ck.initial_state(mesh, receiver), 10)
    kept = [x.clone() for x in ck.state_leaves(s1)]
    s2a, oa = ck.run_chunk(mesh, source, receiver, s1, 10)
    s2b, ob = ck.run_chunk(mesh, source, receiver, s1, 10)
    s3, _ = ck.run_chunk(mesh, source, receiver, s2a, 10)
    assert all(torch.equal(a, b) for a, b in zip(ck.state_leaves(s1), kept))
    assert torch.equal(oa, ob)
    assert all(torch.equal(a, b) for a, b in zip(ck.state_leaves(s2a),
                                                  ck.state_leaves(s2b)))


@pytest.mark.parametrize("route", ROUTES)
def test_nan_inside_a_chunk_clears_stable(route):
    """A NaN injected deep inside the room at step 5 of a 10-step chunk,
    before it reaches a wall: ``stable`` goes False in that chunk."""
    mesh, _, receiver, _ = _setup()
    mesh = _routed(mesh, route)
    signal = impulse_signal(20, 1.0, "cpu").clone()
    signal[5] = float("nan")
    centre = tuple(np.asarray(mesh.descriptor.dimensions) // 2)
    source = HardSource(node_idx=mesh.descriptor.flat_index(centre),
                        signal=signal)
    state, _ = ck.run_chunk(mesh, source, receiver,
                            ck.initial_state(mesh, receiver), 4)
    assert bool(state.stable)
    state, _ = ck.run_chunk(mesh, source, receiver, state, 10)
    assert not bool(state.stable)
    assert bool(torch.isnan(state.current).any())


# --- across the packages -----------------------------------------------------

def _port_mesh(jm):
    """The port's Mesh from every table of the reference's."""
    d, s = jm.descriptor, jm.box_spec
    tables = {k: np.asarray(getattr(jm.structure, k))
              for k in GENERAL_TABLE_DTYPES}
    return convert.mesh_from_numpy({
        "min_corner": np.asarray(d.min_corner),
        "dimensions": np.asarray(d.dimensions), "spacing": d.spacing,
        "inside": np.asarray(jm.inside),
        "coef_b": np.asarray(jm.structure.coef_b),
        "coef_a": np.asarray(jm.structure.coef_a),
        "room_volume": jm.room_volume,
        "box_dims": np.asarray(s.dims), "box_ilo": np.asarray(s.ilo),
        "box_ihi": np.asarray(s.ihi),
        "box_face_surface": np.asarray(s.face_surface),
        "regions": [(r.start, r.size, r.inner_dirs, r.slot_coefs)
                    for r in jm.regions], **tables}, device="cpu")


@pytest.fixture(scope="module")
def both_meshes():
    jm = j_run.shoebox_mesh(JBox(*BOX), np.full((1, 8), 0.1), DX, FS)
    return jm, _port_mesh(jm)


def _problems(jm, steps):
    desc = jm.descriptor
    src = desc.flat_index(jm.require_inside(SRC))
    rcv = desc.flat_index(jm.require_inside(RCV))
    jprob = (JHardSource(node_idx=jnp.asarray(src, dtype=jnp.int32),
                         signal=j_impulse(steps, 1.0)),
             JNodeReceiver(node_idx=jnp.asarray(rcv, dtype=jnp.int32)))
    tprob = (HardSource(node_idx=int(src),
                        signal=impulse_signal(steps, 1.0, "cpu")),
             NodeReceiver(node_idx=torch.tensor(int(rcv))))
    return jprob, tprob


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=PARITY_REL * np.abs(want).max())


@pytest.mark.parametrize("route", ["box", "general"])
def test_reference_state_resumes_in_the_port(both_meshes, route):
    jm, tm = both_meshes
    if route == "general":
        jm = dataclasses.replace(jm, box_spec=None, regions=None)
        tm = _routed(tm, route)
    (jsrc, jrcv), (tsrc, trcv) = _problems(jm, 90)
    jstate, jfirst = jck.run_chunk(jm, jsrc, jrcv,
                                   jck.initial_state(jm, jrcv), 40)
    _, jrest = jck.run_chunk(jm, jsrc, jrcv, jstate, 50)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (jstate.current, jstate.previous, jstate.boundary_state,
         jstate.receiver_state, jstate.stable))]
    state = convert.waveguide_state_from_numpy(leaves, jstate.step, tm,
                                               trcv, device="cpu")
    assert state.step == 40 and len(ck.state_leaves(state)) == len(leaves)
    for got, want in zip(ck.state_leaves(state), leaves):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    _, rest = ck.run_chunk(tm, tsrc, trcv, state, 50)
    _close(rest, jrest)


@pytest.mark.parametrize("route", ["box", "general"])
def test_port_snapshot_loads_in_the_reference(both_meshes, route,
                                              tmp_path):
    jm, tm = both_meshes
    if route == "general":
        jm = dataclasses.replace(jm, box_spec=None, regions=None)
        tm = _routed(tm, route)
    (jsrc, jrcv), (tsrc, trcv) = _problems(jm, 90)
    state, first = ck.run_chunk(tm, tsrc, trcv,
                                ck.initial_state(tm, trcv), 40)
    path = str(tmp_path / "port.npz")
    ck.save_state(path, state)
    jstate = jck.load_state(path, jm, jrcv)
    assert jstate.step == 40
    for got, want in zip(jax.tree_util.tree_leaves(
            (jstate.current, jstate.previous, jstate.boundary_state,
             jstate.receiver_state, jstate.stable)),
            ck.state_leaves(state)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    _, jrest = jck.run_chunk(jm, jsrc, jrcv, jstate, 50)
    _, rest = ck.run_chunk(tm, tsrc, trcv, state, 50)
    _close(rest, jrest)
    _, jfirst = jck.run_chunk(jm, jsrc, jrcv, jck.initial_state(jm, jrcv),
                              40)
    _close(first, jfirst)


def test_a_card_state_needs_the_card(tmp_path):
    """Loading a snapshot onto the card with no GPU raises; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card runs are chip_smoke.py's")
    mesh, _, receiver, _ = _setup()
    path = str(tmp_path / "snap.npz")
    ck.save_state(path, ck.initial_state(mesh, receiver))
    with pytest.raises((RuntimeError, AssertionError)):
        ck.load_state(path, mesh, receiver, device="cuda")
