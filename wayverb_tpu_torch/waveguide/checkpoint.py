"""Checkpoint/resume for long waveguide runs.

Port of ``wayverb_tpu.waveguide.checkpoint``.  The time loop runs in chunks
with the full solver state (pressure ping-pong, boundary filter state,
receiver integrator, step counter) between them; a state can be written to
an ``.npz`` and restored bit-exactly, and a chunked run equals one
continuous run to the bit.

Each chunk drives the per-step body of the route a continuous run takes,
from ``run.py`` and ``box_fused.py``, with ``run._run_loop``: a box with a
plane-solver spec takes the fused body (``box_fused.make_box_body``, the
fused step kernel), a box too thin for it the region body
(``run.make_region_body``, the masked interior kernel), any other scene the
general body (``run.make_general_body``, the weighted-step kernel).  The
multi-step chunk kernel of ``execute``'s CUDA box route is not used here,
as the reference's ``run_chunk`` does not use its counterpart.

A state is a value: ``run_chunk`` copies the two fields of the state it is
given before the bodies rotate their buffers in place, so a state, a
snapshot of its field and the outputs handed out stay what they were when
they were made, whatever runs later.

The snapshot file holds the reference's leaves in the reference's order
(``step``, ``num_leaves``, ``leaf_i``), so a snapshot written by either
package loads in the other.  The general body also carries the boundary
pressures of its two fields; they are gathered again from the fields when
a chunk starts (``run.general_carry``), which is exactly what the body
carries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from wayverb_tpu_torch.waveguide.box_fused import (initial_box_boundary,
                                                   make_box_body,
                                                   requires_grad)
from wayverb_tpu_torch.waveguide.box_boundary import initial_region_states
from wayverb_tpu_torch.waveguide.box_mega import _stack_outputs
from wayverb_tpu_torch.waveguide.run import (Mesh, _run_loop, general_carry,
                                             make_general_body,
                                             make_region_body)


@dataclasses.dataclass
class WaveguideState:
    current: Any            # (X, Y, Z) field
    previous: Any           # (X, Y, Z) field
    boundary_state: Any     # box carry OR tuple of region states OR compact
    receiver_state: Any
    step: int
    stable: Any             # () bool tensor


def _route(mesh: Mesh) -> str:
    if mesh.box_spec is not None:
        return "box"
    return "regions" if mesh.regions is not None else "general"


def initial_state(mesh: Mesh, receiver, dtype=torch.float32
                  ) -> WaveguideState:
    """The zero state on the mesh's device."""
    device = mesh.device
    dims = mesh.descriptor.dimensions
    order = mesh.structure.filter_order
    route = _route(mesh)
    if route == "box":
        bstate = initial_box_boundary(mesh.box_spec, order, dtype, None,
                                      device)
    elif route == "regions":
        bstate = tuple(initial_region_states(list(mesh.regions), order,
                                             dtype, device))
    else:
        bstate = mesh.structure.initial_filter_state(dtype)
    return WaveguideState(
        current=torch.zeros(dims, dtype=dtype, device=device),
        previous=torch.zeros(dims, dtype=dtype, device=device),
        boundary_state=bstate,
        receiver_state=receiver.init_state(dtype, device),
        step=0,
        stable=torch.ones((), dtype=torch.bool, device=device))


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(x) for x in tree)
    return tree


def run_chunk(mesh: Mesh, source, receiver, state: WaveguideState,
              num_steps: int, kernel_inject: bool = True
              ) -> Tuple[WaveguideState, Any]:
    """Advance ``num_steps`` from ``state``; returns (new_state, outputs).

    ``state`` is not written; the new state's tensors are the chunk's own.
    ``kernel_inject`` is the fused body's (box route only).
    """
    structure = mesh.structure
    dims = mesh.descriptor.dimensions
    grad = requires_grad(structure, source, receiver)
    current, previous, bstate, rstate, ok = _clone(
        (state.current, state.previous, state.boundary_state,
         state.receiver_state, state.stable))
    route = _route(mesh)
    if route == "box":
        body = make_box_body(structure, mesh.box_spec, source, receiver,
                             kernel_inject=kernel_inject)
        carry = (current, previous, bstate, rstate, ok,
                 None if grad else torch.zeros_like(current))
    elif route == "regions":
        body = make_region_body(structure, dims, source, receiver,
                                mesh.regions)
        carry = (current, previous, list(bstate), rstate, ok,
                 None if grad else torch.zeros_like(current))
    else:
        body = make_general_body(structure, dims, source, receiver)
        carry = general_carry(structure, current, previous, bstate, rstate,
                              ok)
    carry, per_step = _run_loop(body, carry, num_steps, 0, grad,
                                start=state.step)
    current, previous, bstate, rstate = carry[:4]
    ok = carry[6] if route == "general" else carry[4]
    if route == "box":
        # the fused body checks the boundary planes each step; a NaN born
        # in the interior persists in the field, so one full-field check a
        # chunk catches it (run_waveguide_box checks once at the end)
        ok = ok & torch.all(torch.isfinite(current))
    elif route == "regions":
        bstate = tuple(bstate)
    return WaveguideState(current=current, previous=previous,
                          boundary_state=bstate, receiver_state=rstate,
                          step=state.step + num_steps, stable=ok), \
        _stack_outputs(per_step)


def _flatten(tree) -> list:
    """Tensor leaves in the reference's pytree order (tuples depth first;
    an empty tuple has none)."""
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _flatten(x)]
    return [tree]


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def state_leaves(state: WaveguideState) -> list:
    """The state's tensors in the order of the reference's leaves."""
    return _flatten((state.current, state.previous, state.boundary_state,
                     state.receiver_state, state.stable))


def _state_from_leaves(leaves, step: int, mesh: Mesh, receiver,
                       dtype=torch.float32, *, device=None
                       ) -> WaveguideState:
    """A state from leaves in the reference's order (numpy arrays), on
    ``device`` (default: the mesh's); ``convert.waveguide_state_from_numpy``
    is the public entry."""
    device = mesh.device if device is None else torch.device(device)
    template = initial_state(mesh, receiver, dtype)
    parts = (template.current, template.previous, template.boundary_state,
             template.receiver_state, template.stable)
    if len(leaves) != len(_flatten(parts)):
        raise ValueError(f"{len(leaves)} leaves for a state of "
                         f"{len(_flatten(parts))}")
    leaves = [torch.tensor(np.asarray(x)).to(device) for x in leaves]
    current, previous, bstate, rstate, stable = _unflatten(parts, leaves)
    return WaveguideState(current=current, previous=previous,
                          boundary_state=bstate, receiver_state=rstate,
                          step=int(step), stable=stable)


def save_state(path: str, state: WaveguideState) -> None:
    leaves = state_leaves(state)
    np.savez(path, step=state.step, num_leaves=len(leaves),
             **{f"leaf_{i}": leaf.detach().cpu().numpy()
                for i, leaf in enumerate(leaves)})


def load_state(path: str, mesh: Mesh, receiver, dtype=torch.float32, *,
               device=None) -> WaveguideState:
    """Restore a snapshot onto ``device`` (default: the mesh's); the mesh
    and the receiver give the state's structure."""
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(int(data["num_leaves"]))]
        step = int(data["step"])
    return _state_from_leaves(leaves, step, mesh, receiver, dtype,
                              device=device)


class Cancelled(Exception):
    """Raised by run_cancellable when keep_going() goes False; carries the
    resumable state and the outputs accumulated so far."""

    def __init__(self, state: WaveguideState, outputs):
        super().__init__(f"cancelled at step {state.step}")
        self.state = state
        self.outputs = outputs


def _cat(chunks):
    if not chunks:
        return None
    if isinstance(chunks[0], tuple):
        return tuple(torch.cat(parts, dim=0) for parts in zip(*chunks))
    return torch.cat(chunks, dim=0)


def run_cancellable(mesh: Mesh, source, receiver, num_steps: int,
                    keep_going, chunk: int = 512,
                    state: Optional[WaveguideState] = None,
                    on_progress=None, dtype=torch.float32,
                    kernel_inject: bool = True):
    """Chunked solve with COOPERATIVE CANCELLATION between chunks — the
    reference's ``std::atomic_bool keep_going`` analogue
    (``waveguide/waveguide.h:80``, ``threaded_engine.cpp:55-57``).

    ``keep_going``: zero-arg callable polled before every chunk.  On False
    the run raises :class:`Cancelled` carrying the RESUMABLE state (feed it
    back via ``state=`` to continue, or ``save_state`` it) plus the outputs
    accumulated so far.

    ``on_progress(step, target)`` fires after each chunk.
    Returns ``(state, outputs)`` with outputs concatenated over chunks.
    """
    if state is None:
        state = initial_state(mesh, receiver, dtype)
    target = state.step + num_steps
    pieces = []
    while state.step < target:
        if not keep_going():
            raise Cancelled(state, _cat(pieces))
        n = min(chunk, target - state.step)
        state, out = run_chunk(mesh, source, receiver, state, n,
                               kernel_inject=kernel_inject)
        pieces.append(out)
        if on_progress is not None:
            on_progress(state.step, target)
    return state, _cat(pieces)
