"""Waveguide execution: the time loop and the canonical driver.

Port of ``wayverb_tpu.waveguide.run``.  The reference's ``lax.scan``
becomes a Python loop; every value stays on the device until the run
finishes (the stability flag is a device tensor read once, after the loop).

``execute`` routes as the reference does.  A shoebox on a CUDA device that
``box_mega.mega_supported`` accepts takes the multi-step mega chunk path;
other shoeboxes (CPU tensors, ``kernel_inject=False``) take the fused
streaming step.  A box too thin for the plane solver takes the region path
(``run_waveguide_regions``: the masked interior kernel plus 26 slice
updates).  Any other scene, built by ``compute_mesh`` without ``scene_box``,
takes the general path (``run_waveguide``: the dense weighted-step kernel
plus the compact boundary pass of ``stencil.py``).

All routes differentiate: the mega path through its chunk-level
``torch.autograd.Function`` (gradients with respect to the filter
coefficients and the source signal), the fused and the general path through
their step's Function and plain autograd (everything, positions included,
with optional checkpointing).

Canonical driver parity: ``waveguide/canonical.h:30-124`` (hard source with
calibrated impulse at the source node, directional receiver at the receiver
node, steps = ⌈time·fs⌉); ``canonical_multiband``
(``canonical.h:141-177``) runs it once per band with flat boundaries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from wayverb_tpu_torch.core.environment import Environment
from wayverb_tpu_torch.signal.multiband import band_edges
from wayverb_tpu_torch.core.geometry import (Box, TriangleSoup, box_scene,
                                             scene_aabb)
from wayverb_tpu_torch.waveguide import boundary as bdry
from wayverb_tpu_torch.waveguide.box_boundary import (apply_regions,
                                                      initial_region_states,
                                                      shoebox_regions)
from wayverb_tpu_torch.waveguide.box_fused import (BoxSpec, initial_box_carry,
                                                   make_box_body,
                                                   requires_grad,
                                                   spec_from_inside)
from wayverb_tpu_torch.waveguide.box_mega import (_stack_outputs,
                                                  mega_supported,
                                                  run_waveguide_box_mega)
from wayverb_tpu_torch.waveguide.descriptor import (MeshDescriptor,
                                                    compute_adjusted_boundary,
                                                    default_alignment,
                                                    descriptor_for_box)
from wayverb_tpu_torch.waveguide.receivers import make_directional_receiver
from wayverb_tpu_torch.waveguide.setup import (MeshStructure,
                                               _closest_triangle_surface,
                                               build_structure,
                                               classify_inside_scene,
                                               classify_inside_shoebox,
                                               estimate_volume)
from wayverb_tpu_torch.waveguide.sources import (HardSource, impulse_signal,
                                                 rectilinear_calibration_factor)
from wayverb_tpu_torch.waveguide.stencil import (boundary_pressures,
                                                 expand_boundary_coefficients,
                                                 prepare_boundary_tables,
                                                 waveguide_step_carried)
from wayverb_tpu_torch.waveguide.stencil_kernels import interior_step
from wayverb_tpu_torch.utils import events


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Descriptor + structure + bookkeeping for one scene.

    ``box_spec``: for shoebox scenes, the static geometry driving the fused
    plane-boundary solver (box_fused.py); None for a general scene and for
    a box too thin for that solver.
    ``regions``: for shoebox scenes, the gather-free region decomposition
    (box_boundary.py): the path of a thin box and a second oracle for the
    plane path.
    """

    descriptor: MeshDescriptor
    structure: MeshStructure
    inside: np.ndarray       # host copy for placement checks
    room_volume: float
    regions: Optional[list] = None
    box_spec: Optional[BoxSpec] = None

    @property
    def device(self) -> torch.device:
        return self.structure.coef_b.device

    def require_inside(self, position) -> np.ndarray:
        loc = self.descriptor.locator(position)
        in_bounds = np.all(loc >= 0) and np.all(
            loc < np.asarray(self.descriptor.dimensions))
        if not in_bounds or not bool(self.inside[tuple(loc)]):
            raise RuntimeError(
                f"position {position} does not map to an inside mesh node")
        return loc


def compute_mesh(soup: TriangleSoup, surface_absorption, spacing: float,
                 sample_rate: float, scene_box: Optional[Box] = None,
                 anchor=None, align=None, *, device,
                 timings: Optional[dict] = None) -> Mesh:
    """Build a mesh for a scene.

    ``surface_absorption``: (S, bands) per-material absorption →
    per-material order-6 impedance filters fitted at the mesh rate, placed
    on ``device``.  ``scene_box`` enables the analytic shoebox inside test
    and the box solvers; without it the scene is any closed triangle soup,
    classified by the 32-ray parity vote (``classify_inside_scene``: the
    native runtime, else ``points_inside`` on ``device``).  ``anchor``: the
    point that lands exactly on a node (default: the centre of the box or
    of the scene's bounding box).  ``align``: None keeps
    ``default_alignment()`` (which pads nothing); an (ax, ay, az) tuple
    rounds each grid dimension up to that multiple, with the extra nodes
    outside the scene (a sharded run pads x to a multiple of its shard
    count).

    ``timings``: optional dictionary that receives the host seconds of the
    three setup stages (``classify_s``, ``fit_s``, ``structure_s``), the
    classifier that ran (``classifier``) and, for a box, the seconds of its
    face surfaces, regions and plane spec (``regions_s``).  Each stage is a
    span (``utils.events.span``: ``setup.classify``, ``setup.fit``,
    ``setup.structure``, ``setup.regions``).
    """
    aabb = scene_box if scene_box is not None else scene_aabb(soup)
    if anchor is None:
        anchor = tuple(np.asarray(aabb.centre()))
    adjusted = compute_adjusted_boundary(aabb, anchor, spacing)
    desc = descriptor_for_box(
        adjusted, spacing,
        align=default_alignment() if align is None else tuple(align))

    with events.span("setup.classify") as classify:
        if scene_box is not None:
            inside = classify_inside_shoebox(desc, scene_box)
            classifier = "shoebox"
        else:
            inside = classify_inside_scene(desc, soup, device=device)
            classifier = classify_inside_scene.last_backend

    with events.span("setup.fit") as fit:
        surface_absorption = np.asarray(surface_absorption)
        coeffs = [bdry.compute_boundary_coefficients(surface_absorption[i],
                                                     sample_rate)
                  for i in range(surface_absorption.shape[0])]
        coef_b, coef_a = bdry.coefficient_table(coeffs)
    with events.span("setup.structure") as built:
        structure = build_structure(desc, inside, soup, coef_b, coef_a,
                                    device)
    if timings is not None:
        timings.update(classify_s=classify.seconds, fit_s=fit.seconds,
                       structure_s=built.seconds, classifier=classifier)

    regions = None
    box_spec = None
    if scene_box is not None:
        with events.span("setup.regions") as placed:
            # surface per face from the closest triangle to each face centre
            centre = np.asarray(scene_box.centre())
            dims_m = np.asarray(scene_box.max_corner) - \
                np.asarray(scene_box.min_corner)
            face_centres = np.tile(centre, (6, 1))
            for axis in range(3):
                face_centres[2 * axis, axis] -= dims_m[axis] / 2
                face_centres[2 * axis + 1, axis] += dims_m[axis] / 2
            face_surfaces = _closest_triangle_surface(face_centres, soup)
            regions = shoebox_regions(inside, face_surfaces)
            try:
                box_spec = spec_from_inside(inside, face_surfaces)
            except ValueError:
                box_spec = None   # degenerate box: the region path runs it
        if timings is not None:
            timings["regions_s"] = placed.seconds

    return Mesh(descriptor=desc, structure=structure, inside=inside,
                room_volume=estimate_volume(desc, inside), regions=regions,
                box_spec=box_spec)


@dataclasses.dataclass
class WaveguideOutput:
    pressure: Any          # (T,) at the output node
    intensity: Any         # (T, 3) directional intensity
    sample_rate: float
    stable: Any            # () bool tensor: no NaN/Inf during the run


def _run_loop(body, carry, num_steps: int, checkpoint_every: int,
              grad: bool, start: int = 0):
    """Drive ``body(carry, t) → (carry, outputs)`` for steps ``start`` ..
    ``start + num_steps - 1``; returns (carry, per-step outputs).  With
    ``checkpoint_every`` and a gradient required, the carry is saved only
    every that many steps and each segment is recomputed in the backward
    pass (``torch.utils.checkpoint``)."""
    per_step = []
    stop = start + num_steps
    if checkpoint_every and num_steps > checkpoint_every and grad:
        from torch.utils.checkpoint import checkpoint

        def segment(carry, t0):
            outs = []
            for t in range(t0, min(t0 + checkpoint_every, stop)):
                carry, outputs = body(carry, t)
                outs.append(outputs)
            return carry, outs

        for t0 in range(start, stop, checkpoint_every):
            carry, outs = checkpoint(segment, carry, t0, use_reentrant=False)
            per_step.extend(outs)
    else:
        for t in range(start, stop):
            carry, outputs = body(carry, t)
            per_step.append(outputs)
    return carry, per_step


def run_waveguide_box(structure: MeshStructure, spec: BoxSpec, source,
                      receiver, num_steps: int, dtype=torch.float32,
                      state_dtype=None, checkpoint_every: int = 0,
                      kernel_inject: bool = True) -> dict:
    """Run the fused plane-boundary solver for ``num_steps`` steps.

    Boundary work is one stacked plane update (plain torch) and the interior
    stencil + plane splice is one kernel per step (``box_fused.fused_step``).
    ``state_dtype`` optionally runs the IIR filter state in a wider dtype
    than the field (the reference C++ keeps filter state in double,
    ``cl/filter_structs.h:14``).  ``kernel_inject=False`` injects point
    sources into the field before the step instead of inside it
    (differentiable with respect to the source signal; the in-step
    injection stops signal gradients at a hard source, while material
    gradients are exact either way).

    ``checkpoint_every``: when a gradient is required, save the carry only
    every that many steps and recompute each segment in the backward pass
    (``torch.utils.checkpoint``), trading one more forward for
    ``checkpoint_every`` times fewer stored fields.

    Returns {"outputs": stacked receiver outputs, "stable": () bool tensor}.
    """
    body = make_box_body(structure, spec, source, receiver,
                         kernel_inject=kernel_inject)
    carry = initial_box_carry(structure, spec, receiver, dtype, state_dtype)
    carry, per_step = _run_loop(body, carry, num_steps, checkpoint_every,
                                requires_grad(structure, source, receiver))
    # the per-step check covers the boundary planes only (O(n²)); a NaN
    # born in the interior persists in the field, so one final full-field
    # reduction catches it
    stable = carry[4] & torch.all(torch.isfinite(carry[0]))
    return {"outputs": _stack_outputs(per_step), "stable": stable}


def _require_general_tables(structure: MeshStructure):
    if not structure.has_general_tables:
        raise ValueError(
            "this MeshStructure was built without the general-path tables "
            "(weight_code, interior_mask, b_*): build it with "
            "build_structure, or pass the tables to convert.mesh_from_numpy")


def make_general_body(structure: MeshStructure, dims, source, receiver):
    """One step of the general mesh: (carry, t) → (carry, outputs).

    carry: (cur, prev, fstate, rstate, pb, bp_last, ok); ``pb`` and
    ``bp_last`` are the boundary pressures of ``prev`` and of ``cur``
    (``general_carry``).  Each step is one dense kernel
    (``stencil_kernels.weighted_step``) and the compact boundary pass.
    Without a gradient the step writes the next field over ``prev`` and
    injects into ``cur`` in place; when the coefficients, the source or the
    receiver require grad every step allocates its field and injects into a
    copy.
    """
    _require_general_tables(structure)
    dims = tuple(int(d) for d in dims)
    num_nodes = dims[0] * dims[1] * dims[2]
    grad = requires_grad(structure, source, receiver)
    expanded = expand_boundary_coefficients(structure)
    tables = prepare_boundary_tables(structure, expanded)

    # boundary previous-pressure carry: previous_t[b] equals last step's
    # computed boundary pressures plus the injection's effect, so sources
    # exposing ``patch_tap`` (exact compact injection mirror) skip one
    # sparse gather per step; others re-gather (always correct)
    patch_tap = getattr(source, "patch_tap", None)

    def body(carry, t: int):
        current, previous, fstate, rstate, pb, bp_last, ok = carry
        flat = current.reshape(num_nodes)
        cur_flat = source.inject(flat.clone() if grad else flat, t)
        current = cur_flat.view(dims)
        rstate, outputs = receiver.tap(cur_flat, rstate)
        if patch_tap is not None:
            pb_next = patch_tap(structure.b_node_idx, bp_last, t)
            prev_b = pb
        else:
            pb_next = pb            # unused placeholder
            prev_b = None           # gather inside the step
        nxt, fstate, bp = waveguide_step_carried(
            current, previous, prev_b, fstate, structure, expanded, tables,
            out=None if grad else previous)
        ok = ok & torch.all(torch.isfinite(nxt))
        return (nxt, current, fstate, rstate, pb_next, bp, ok), outputs

    return body


def general_carry(structure: MeshStructure, current, previous, fstate,
                  rstate, ok):
    """The general body's carry for a solver state: the boundary pressures
    it carries are gathered from the two fields, which is what the body
    carries forward (its ``bp`` is scattered into the next field as is, and
    ``patch_tap`` mirrors the injection exactly)."""
    return (current, previous, fstate, rstate,
            boundary_pressures(previous, structure),
            boundary_pressures(current, structure), ok)


def initial_general_carry(structure: MeshStructure, dims, receiver,
                          dtype=torch.float32):
    device = structure.device
    field = lambda: torch.zeros(tuple(dims), dtype=dtype,  # noqa: E731
                                device=device)
    return general_carry(structure, field(), field(),
                         structure.initial_filter_state(dtype),
                         receiver.init_state(dtype, device),
                         torch.ones((), dtype=torch.bool, device=device))


def run_waveguide(structure: MeshStructure, dims, source, receiver,
                  num_steps: int, dtype=torch.float32,
                  checkpoint_every: int = 0) -> dict:
    """Run the general mesh for ``num_steps`` steps (``make_general_body``
    from ``initial_general_carry``).

    ``source`` must expose ``inject(field_flat, t)``; ``receiver`` must
    expose ``init_state(dtype, device)`` and ``tap(field_flat, state)``.

    ``checkpoint_every``: when > 0 and a gradient is required, reverse-mode
    memory drops from O(num_steps) pressure fields to O(num_steps/k + k) at
    the cost of one forward recompute.

    Returns {"outputs": stacked receiver outputs, "stable": () bool tensor}.
    """
    body = make_general_body(structure, dims, source, receiver)
    init = initial_general_carry(structure, dims, receiver, dtype)
    carry, per_step = _run_loop(body, init, num_steps, checkpoint_every,
                                requires_grad(structure, source, receiver))
    return {"outputs": _stack_outputs(per_step), "stable": carry[6]}


def make_region_body(structure: MeshStructure, dims, source, receiver,
                     regions):
    """One step of the region path (shoebox meshes): (carry, t) → (carry,
    outputs).

    carry: (cur, prev, region states, rstate, ok, spare).  ``regions``:
    sequence of ``box_boundary.Region`` (static).  Each step is the masked
    interior kernel (``stencil_kernels.interior_step``) and the 26 region
    updates as slice arithmetic.  Three field buffers rotate when no
    gradient is required (the regions still read the previous field after
    the interior pass, so it cannot take the result); with a gradient
    ``spare`` is None and every step allocates.
    """
    _require_general_tables(structure)
    dims = tuple(int(d) for d in dims)
    num_nodes = dims[0] * dims[1] * dims[2]
    regions = list(regions)
    grad = requires_grad(structure, source, receiver)

    def body(carry, t: int):
        current, previous, states, rstate, ok, spare = carry
        flat = current.reshape(num_nodes)
        cur_flat = source.inject(flat.clone() if grad else flat, t)
        current = cur_flat.view(dims)
        rstate, outputs = receiver.tap(cur_flat, rstate)
        nxt = interior_step(current, previous, structure.interior_mask,
                            out=spare)
        nxt, states = apply_regions(nxt, current, previous, states, regions,
                                    structure.coef_b, structure.coef_a)
        ok = ok & torch.all(torch.isfinite(nxt))
        return (nxt, current, states, rstate, ok,
                None if grad else previous), outputs

    return body


def initial_region_carry(structure: MeshStructure, dims, receiver, regions,
                         dtype=torch.float32, grad: bool = False):
    device = structure.device
    field = lambda: torch.zeros(tuple(dims), dtype=dtype,  # noqa: E731
                                device=device)
    return (field(), field(),
            initial_region_states(list(regions), structure.filter_order,
                                  dtype, device),
            receiver.init_state(dtype, device),
            torch.ones((), dtype=torch.bool, device=device),
            None if grad else field())


def run_waveguide_regions(structure: MeshStructure, dims, source, receiver,
                          num_steps: int, regions, dtype=torch.float32
                          ) -> dict:
    """Run using the gather-free region boundary path (shoebox meshes):
    ``make_region_body`` from ``initial_region_carry``."""
    grad = requires_grad(structure, source, receiver)
    body = make_region_body(structure, dims, source, receiver, regions)
    init = initial_region_carry(structure, dims, receiver, regions, dtype,
                                grad)
    carry, per_step = _run_loop(body, init, num_steps, 0, grad)
    return {"outputs": _stack_outputs(per_step), "stable": carry[4]}


def execute(mesh: Mesh, source, receiver, num_steps: int,
            dtype=torch.float32, kernel_inject: bool = True) -> dict:
    """Run the mesh with the fastest applicable boundary path.

    A float32 shoebox on a CUDA device whose chunk state fits the card
    routes to the mega chunk path (box_mega.py); other shoeboxes, CPU
    tensors among them, take the fused streaming step.  ``kernel_inject=
    False`` is the reference's escape hatch to the fused path with the
    source injected into the field before each step (exact gradients with
    respect to the source signal).  A box too thin for the plane solver
    (no ``box_spec``) takes the region path; a general scene (neither
    ``box_spec`` nor ``regions``) takes ``run_waveguide``.  Every route
    differentiates except the region path on a CUDA device: inputs that
    require grad take the same route and get their gradients through the
    route's adjoint kernels.
    """
    if mesh.box_spec is not None:
        if kernel_inject and dtype == torch.float32 and mega_supported(
                mesh.box_spec, source, receiver, mesh.device,
                filter_order=mesh.structure.filter_order,
                num_steps=num_steps,
                grad=requires_grad(mesh.structure, source)):
            return run_waveguide_box_mega(mesh.structure, mesh.box_spec,
                                          source, receiver, num_steps)
        return run_waveguide_box(mesh.structure, mesh.box_spec, source,
                                 receiver, num_steps, dtype,
                                 kernel_inject=kernel_inject)
    if mesh.regions is not None:
        return run_waveguide_regions(
            mesh.structure, mesh.descriptor.dimensions, source, receiver,
            num_steps, mesh.regions, dtype)
    return run_waveguide(mesh.structure, mesh.descriptor.dimensions, source,
                         receiver, num_steps, dtype)


def canonical_problem(mesh: Mesh, source_position, receiver_position,
                      simulation_time: float,
                      environment: Environment = Environment()):
    """The canonical run's (source, receiver, num_steps, sample_rate): a
    hard source with the calibrated impulse at the source node and a
    directional receiver at the receiver node, on the mesh's device."""
    desc = mesh.descriptor
    fs = desc.sample_rate(environment.speed_of_sound)
    num_steps = int(math.ceil(fs * simulation_time))
    if num_steps <= 0:
        raise ValueError(
            f"simulation_time {simulation_time} yields no steps at fs {fs}")

    src_loc = mesh.require_inside(source_position)
    rcv_loc = mesh.require_inside(receiver_position)

    amplitude = rectilinear_calibration_factor(
        desc.spacing, environment.acoustic_impedance)
    source = HardSource(node_idx=desc.flat_index(src_loc),
                        signal=impulse_signal(num_steps, amplitude,
                                              mesh.device))
    receiver = make_directional_receiver(
        desc, fs, environment.ambient_density, desc.position(rcv_loc),
        mesh.device)
    return source, receiver, num_steps, fs


def canonical(mesh: Mesh, source_position, receiver_position,
              simulation_time: float, environment: Environment = Environment(),
              dtype=torch.float32) -> WaveguideOutput:
    """Calibrated impulse → directional receiver output, one band, on the
    mesh's device (through ``execute``); one ``canonical`` span."""
    with events.span("canonical"):
        source, receiver, num_steps, fs = canonical_problem(
            mesh, source_position, receiver_position, simulation_time,
            environment)
        result = execute(mesh, source, receiver, num_steps, dtype)
    intensity, pressure = result["outputs"]
    return WaveguideOutput(pressure=pressure, intensity=intensity,
                           sample_rate=fs, stable=result["stable"])


def canonical_multiband(mesh: Mesh, soup_surface_absorption, source_position,
                        receiver_position, simulation_time: float,
                        num_bands: int,
                        environment: Environment = Environment(),
                        dtype=torch.float32, use_vmap: bool = True,
                        device_mesh=None):
    """Per-band runs with flat (frequency-independent) boundaries.

    Parity: reference ``canonical.h:141-177`` — band b uses
    ``to_flat_coefficients(absorption[:, b])`` per surface and covers the
    hrtf band-edge range [edge_b, edge_{b+1}] Hz of the absorption's band
    count, whatever the mesh rate (the top bands may lie above it, as in
    the reference).  Returns a list of ``postprocess.BandpassBand``, each
    with its run's ``stable``.

    Only the (S, order+1) coefficient tables change from band to band: each
    band runs ``canonical`` on the mesh with those two tables replaced, so
    it takes the route one band takes (B2 on a CUDA shoebox, B8 on a
    general mesh, B12 on a thin box, the plain versions on the CPU) and
    frees its fields before the next band starts.  With a ``device_mesh``
    every band runs ``canonical_sharded`` (shoebox) or
    ``canonical_general_sharded``.  ``use_vmap`` is accepted for the
    reference's signature and changes nothing: the reference's vmapped and
    looped forms compute the same bands, and here both are this loop.
    """
    from wayverb_tpu_torch.parallel.box_sharded import canonical_sharded
    from wayverb_tpu_torch.parallel.general_sharded import \
        canonical_general_sharded
    from wayverb_tpu_torch.waveguide.postprocess import BandpassBand

    absorption = np.asarray(soup_surface_absorption)   # (S, bands)
    edges = band_edges(absorption.shape[1])
    valid = [(float(edges[b]), float(edges[b + 1])) for b in range(num_bands)]
    out = []
    for b in range(num_bands):
        coef_b, coef_a = bdry.coefficient_table(
            [bdry.to_flat_coefficients(float(absorption[s, b]))
             for s in range(absorption.shape[0])])
        band_mesh = dataclasses.replace(mesh, structure=dataclasses.replace(
            mesh.structure, coef_b=torch.as_tensor(coef_b, device=mesh.device),
            coef_a=torch.as_tensor(coef_a, device=mesh.device)))
        args = (band_mesh, source_position, receiver_position,
                simulation_time)
        if device_mesh is None:
            result = canonical(*args, environment, dtype)
        elif mesh.box_spec is not None:
            result = canonical_sharded(*args, device_mesh, environment, dtype)
        else:
            result = canonical_general_sharded(*args, device_mesh,
                                               environment, dtype)
        out.append(BandpassBand(
            pressure=result.pressure, intensity=result.intensity,
            sample_rate=result.sample_rate, valid_hz=valid[b],
            stable=result.stable))
    return out


def shoebox_mesh(box: Box, absorption, spacing: float, sample_rate: float,
                 anchor=None, *, device) -> Mesh:
    """Mesh for a rectangular room with one material on all walls."""
    soup = box_scene(box)
    absorption = np.atleast_2d(np.asarray(absorption))
    return compute_mesh(soup, absorption, spacing, sample_rate,
                        scene_box=box, anchor=anchor, device=device)
