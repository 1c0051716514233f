"""Waveguide execution: the time loop and the canonical driver.

Port of the shoebox path of ``wayverb_tpu.waveguide.run``.  The reference's
``lax.scan`` becomes a Python loop over ``box_fused.make_box_body``; every
value stays on the device until the run finishes (the stability flag is a
device tensor read once, after the loop).

``execute`` routes as the reference does: a shoebox on a CUDA device that
``box_mega.mega_supported`` accepts takes the multi-step mega chunk path;
CPU tensors, and ``kernel_inject=False``, take the fused streaming step.
Both routes differentiate: the mega path through its chunk-level
``torch.autograd.Function`` (gradients with respect to the filter
coefficients and the source signal), the fused path through the fused
step's Function and plain autograd (everything, positions included, with
optional checkpointing).  The general (non-shoebox) mesh path is a later
slice of the port (ROADMAP queue A).

Canonical driver parity: ``waveguide/canonical.h:30-124`` (hard source with
calibrated impulse at the source node, directional receiver at the receiver
node, steps = ⌈time·fs⌉).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from wayverb_tpu_torch.core.environment import Environment
from wayverb_tpu_torch.core.geometry import Box, TriangleSoup, box_scene
from wayverb_tpu_torch.waveguide import boundary as bdry
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
                                               classify_inside_shoebox,
                                               estimate_volume)
from wayverb_tpu_torch.waveguide.sources import (HardSource, impulse_signal,
                                                 rectilinear_calibration_factor)

_GENERAL_MESH = ("general (non-shoebox) meshes are not ported yet: ROADMAP "
                 "queue A, 'Arbitrary geometry'")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Descriptor + structure + bookkeeping for one scene.

    ``box_spec``: for shoebox scenes, the static geometry driving the fused
    plane-boundary solver (box_fused.py); None for a general scene.
    """

    descriptor: MeshDescriptor
    structure: MeshStructure
    inside: np.ndarray       # host copy for placement checks
    room_volume: float
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
                 anchor=None, *, device) -> Mesh:
    """Build a mesh for a shoebox scene (``scene_box`` given).

    ``surface_absorption``: (S, bands) per-material absorption →
    per-material order-6 impedance filters fitted at the mesh rate, placed
    on ``device``.  ``anchor``: the point that lands exactly on a node
    (default: the box centre).
    """
    if scene_box is None:
        raise NotImplementedError(_GENERAL_MESH)
    if anchor is None:
        anchor = tuple(np.asarray(scene_box.centre()))
    adjusted = compute_adjusted_boundary(scene_box, anchor, spacing)
    desc = descriptor_for_box(adjusted, spacing, align=default_alignment())
    inside = classify_inside_shoebox(desc, scene_box)

    surface_absorption = np.asarray(surface_absorption)
    coeffs = [bdry.compute_boundary_coefficients(surface_absorption[i],
                                                 sample_rate)
              for i in range(surface_absorption.shape[0])]
    coef_b, coef_a = bdry.coefficient_table(coeffs)
    structure = build_structure(desc, inside, soup, coef_b, coef_a, device)

    # surface per face from the closest triangle to each face centre
    centre = np.asarray(scene_box.centre())
    dims_m = np.asarray(scene_box.max_corner) - \
        np.asarray(scene_box.min_corner)
    face_centres = np.tile(centre, (6, 1))
    for axis in range(3):
        face_centres[2 * axis, axis] -= dims_m[axis] / 2
        face_centres[2 * axis + 1, axis] += dims_m[axis] / 2
    face_surfaces = _closest_triangle_surface(face_centres, soup)
    try:
        box_spec = spec_from_inside(inside, face_surfaces)
    except ValueError:
        box_spec = None   # degenerate box: execute raises for it

    return Mesh(descriptor=desc, structure=structure, inside=inside,
                room_volume=estimate_volume(desc, inside), box_spec=box_spec)


@dataclasses.dataclass
class WaveguideOutput:
    pressure: Any          # (T,) at the output node
    intensity: Any         # (T, 3) directional intensity
    sample_rate: float
    stable: Any            # () bool tensor: no NaN/Inf during the run


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
    per_step = []
    if checkpoint_every and num_steps > checkpoint_every and requires_grad(
            structure, source, receiver):
        from torch.utils.checkpoint import checkpoint

        def segment(carry, t0):
            outs = []
            for t in range(t0, min(t0 + checkpoint_every, num_steps)):
                carry, outputs = body(carry, t)
                outs.append(outputs)
            return carry, outs

        for t0 in range(0, num_steps, checkpoint_every):
            carry, outs = checkpoint(segment, carry, t0, use_reentrant=False)
            per_step.extend(outs)
    else:
        for t in range(num_steps):
            carry, outputs = body(carry, t)
            per_step.append(outputs)
    # the per-step check covers the boundary planes only (O(n²)); a NaN
    # born in the interior persists in the field, so one final full-field
    # reduction catches it
    stable = carry[4] & torch.all(torch.isfinite(carry[0]))
    return {"outputs": _stack_outputs(per_step), "stable": stable}


def execute(mesh: Mesh, source, receiver, num_steps: int,
            dtype=torch.float32, kernel_inject: bool = True) -> dict:
    """Run the mesh with the fastest applicable boundary path.

    A float32 shoebox on a CUDA device whose chunk state fits the card
    routes to the mega chunk path (box_mega.py); other shoeboxes, CPU
    tensors among them, take the fused streaming step.  ``kernel_inject=
    False`` is the reference's escape hatch to the fused path with the
    source injected into the field before each step (exact gradients with
    respect to the source signal).  Both routes differentiate: inputs that
    require grad take the same route and get their gradients through the
    route's adjoint kernels.  Non-box meshes raise
    NotImplementedError (their path is not ported yet).
    """
    if mesh.box_spec is None:
        raise NotImplementedError(_GENERAL_MESH)
    if kernel_inject and dtype == torch.float32 and mega_supported(
            mesh.box_spec, source, receiver, mesh.device,
            filter_order=mesh.structure.filter_order, num_steps=num_steps,
            grad=requires_grad(mesh.structure, source)):
        return run_waveguide_box_mega(mesh.structure, mesh.box_spec, source,
                                      receiver, num_steps)
    return run_waveguide_box(mesh.structure, mesh.box_spec, source, receiver,
                             num_steps, dtype, kernel_inject=kernel_inject)


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
    mesh's device (through ``execute``)."""
    source, receiver, num_steps, fs = canonical_problem(
        mesh, source_position, receiver_position, simulation_time,
        environment)
    result = execute(mesh, source, receiver, num_steps, dtype)
    intensity, pressure = result["outputs"]
    return WaveguideOutput(pressure=pressure, intensity=intensity,
                           sample_rate=fs, stable=result["stable"])


def shoebox_mesh(box: Box, absorption, spacing: float, sample_rate: float,
                 anchor=None, *, device) -> Mesh:
    """Mesh for a rectangular room with one material on all walls."""
    soup = box_scene(box)
    absorption = np.atleast_2d(np.asarray(absorption))
    return compute_mesh(soup, absorption, spacing, sample_rate,
                        scene_box=box, anchor=anchor, device=device)
