"""The general-mesh FDTD step: dense weighted stencil + compact boundary pass.

Port of ``wayverb_tpu.waveguide.stencil``.

Physics (parity: reference ``waveguide/src/program.cpp``):
 * interior / reentrant:  p⁺ = (Σ₆ neighbours)/3 − p⁻        (:393-412)
 * d-dim boundary node (d = 1, 2, 3) with inner directions D (:331-388):
     csw = λ²·( Σ_{i∈D} 2·p[inner_i] + Σ_{surrounding} p[s] )
     fw  = λ²·Σ_{i∈D} m_i[0]/b0_i
     cw  = λ ·Σ_{i∈D} a0_i/b0_i
     p⁺  = (csw + fw + (cw−1)·p⁻) / (1 + cw)
   then per inner slot the ghost-point filter state advances with input
   −( a0·(p⁻ − p⁺)/(b0·λ) + m0/b0 ) through the canonical DF2T step
   (:150-174, filters.cpp), output discarded.
 * λ = 1/√3 (Courant number, :12-13); outside nodes stay at 0.

One dense kernel (``stencil_kernels.weighted_step``) yields the interior
update and every boundary node's weighted neighbour sum; the irregular
boundary work is a compact gather → arithmetic → scatter over the B boundary
nodes, O(surface) not O(volume): plain tensor code on (B, 3[, order])
tensors.  The boundary pressures are scattered into the dense result in
place when no gradient is required and out of place when one is.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from wayverb_tpu_torch.waveguide.box_fused import requires_grad
from wayverb_tpu_torch.waveguide.descriptor import COURANT, COURANT_SQ
from wayverb_tpu_torch.waveguide.setup import MeshStructure
from wayverb_tpu_torch.waveguide.stencil_kernels import (
    interior_step, weighted_step, weighted_step_sharded)


def expand_boundary_coefficients(s: MeshStructure):
    """Per-node (B, 3, order+1) coefficient tables.

    Hoist this OUT of the time loop: the (S, o+1) → (B, 3, o+1) gather is
    constant across a run.  Gradients with respect to ``coef_b``/``coef_a``
    still flow (the gather transposes to one scatter-add per run).

    The gather is ``index_select``, whose adjoint is ``index_add_`` (atomic
    adds).  The adjoint of ``table[idx]`` sorts the indices and walks equal
    ones serially, and here a million slots share a handful of surfaces.
    """
    slots = s.b_slot_coef.reshape(-1)
    shape = s.b_slot_coef.shape + (s.coef_b.shape[1],)
    return (torch.index_select(s.coef_b, 0, slots).reshape(shape),
            torch.index_select(s.coef_a, 0, slots).reshape(shape))


def prepare_boundary_tables(s: MeshStructure, expanded=None):
    """Per-node derived coefficient tables, hoisted OUT of the time loop.

    Everything here is constant across a run (but still a function of
    ``coef_b``/``coef_a``, so coefficient gradients flow); computing the
    divisions and the static ``cw`` once instead of per step removes most of
    the compact boundary pass's elementwise work.
    """
    bc, ac = expanded if expanded is not None \
        else expand_boundary_coefficients(s)                    # (B, 3, o+1)
    b0 = bc[..., 0]
    a0 = ac[..., 0]
    mask = s.b_slot_mask                                        # (B, 3)
    inv_b0m = mask / b0                                         # (B, 3)
    cw = COURANT * torch.sum(mask * a0 / b0, dim=-1)            # (B,) static
    k_delta = a0 / (b0 * COURANT)                               # (B, 3)
    r_out = b0 / a0                                             # (B, 3)
    inv_a0 = 1.0 / a0
    return (bc, ac, inv_b0m, cw, k_delta, r_out, inv_a0, mask)


def boundary_update(csw, prev, filter_state, s: MeshStructure,
                    expanded=None, tables=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boundary-node pressures + advanced filter state, given each node's
    weighted neighbour sum ``csw`` (B,) and previous pressure ``prev`` (B,).

    ``expanded``: optional precomputed ``expand_boundary_coefficients(s)``;
    ``tables``: optional precomputed ``prepare_boundary_tables`` (hoist it
    out of the loop, see there).
    Returns (new_pressures (B,), new_filter_state (B, 3, order)).
    """
    if tables is None:
        tables = prepare_boundary_tables(s, expanded)
    bc, ac, inv_b0m, cw, k_delta, r_out, inv_a0, mask = tables
    m0 = filter_state[..., 0]                                   # (B, 3)

    fw = COURANT_SQ * torch.sum(m0 * inv_b0m, dim=-1)
    new_p = (csw + fw + (cw - 1.0) * prev) / (1.0 + cw)

    # ghost-point filter update per slot (output discarded)
    filt_in = -(k_delta * (prev - new_p)[:, None] + m0 * inv_b0m)
    out = filt_in * r_out + m0 * inv_a0                         # (B, 3)
    shifted = F.pad(filter_state[..., 1:], (0, 1))
    new_state = shifted + bc[..., 1:] * filt_in[..., None] \
        - ac[..., 1:] * out[..., None]
    new_state = torch.where(mask[..., None] > 0, new_state, filter_state)
    return new_p, new_state


def boundary_step(current_flat, previous_flat, filter_state,
                  s: MeshStructure) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather-based boundary pass (the original slow path, kept as the
    oracle for ``waveguide_step``'s fused formulation)."""
    neigh = current_flat[s.b_neighbor_idx]                      # (B, 6)
    csw = COURANT_SQ * torch.sum(neigh * s.b_neighbor_w, dim=-1)
    prev = previous_flat[s.b_node_idx]                          # (B,)
    return boundary_update(csw, prev, filter_state, s)


def _scatter_boundary(dense_flat, s: MeshStructure, bp, in_place: bool):
    """``dense_flat`` with the boundary pressures written at the boundary
    nodes (``b_node_idx`` is sorted and unique)."""
    bp = bp.to(dense_flat.dtype)
    if in_place:
        return dense_flat.index_copy_(0, s.b_node_idx, bp)
    return dense_flat.index_copy(0, s.b_node_idx, bp)


def waveguide_step_reference(current, previous, filter_state,
                             s: MeshStructure):
    """One full mesh update via the (B, 6) gather boundary pass.

    Kept as a parity oracle; ``waveguide_step`` below is the fast path.
    """
    nxt = interior_step(current, previous, s.interior_mask)
    n = current.numel()
    bp, new_state = boundary_step(current.reshape(n), previous.reshape(n),
                                  filter_state, s)
    in_place = not requires_grad(nxt, bp)
    nxt_flat = _scatter_boundary(nxt.reshape(n), s, bp, in_place)
    return nxt_flat.reshape(current.shape), new_state


def waveguide_step(current, previous, filter_state, s: MeshStructure,
                   expanded=None):
    """One full mesh update (fused general path).

    The dense weighted pass (``stencil_kernels.weighted_step``, driven by
    the packed ``s.weight_code`` bitfield) yields the interior update AND
    every boundary node's weighted neighbour sum in one kernel; the compact
    pass then only gathers one value per boundary node, advances the
    impedance filters, and scatters the corrected pressures — the (B, 6)
    neighbour gather of ``waveguide_step_reference`` disappears (the
    reference C++'s one-kernel-per-step treatment is
    ``program.cpp:393-487``).

    Returns (next_field, new_filter_state).
    """
    nxt, new_state, _ = waveguide_step_carried(
        current, previous, None, filter_state, s, expanded)
    return nxt, new_state


def boundary_pressures(field, s: MeshStructure):
    """(B,) pressures at the boundary nodes of a dense field (a 1-D index
    gather: a copy, never a view of the field)."""
    return field.reshape(field.numel())[s.b_node_idx]


def waveguide_step_carried(current, previous, prev_b, filter_state,
                           s: MeshStructure, expanded=None, tables=None,
                           out=None, halos=None):
    """``waveguide_step`` with the boundary-node previous pressures carried
    compactly: ``prev_b`` is last step's returned ``bp`` (the values this
    step would otherwise re-gather from ``previous``), saving one sparse
    gather per step.  Pass ``prev_b=None`` to gather instead (first step /
    compatibility).

    ``out``: optional buffer for the next field (``weighted_step``'s
    ``out``: not ``current``, possibly ``previous``), for time loops that
    rotate two buffers; only when no gradient is required.

    ``halos``: for one x-shard of a decomposed grid (``parallel/``), the
    (hlo, hhi) neighbour rows; the dense pass is then
    ``weighted_step_sharded`` and ``s`` holds the shard's tables.

    Returns (next_field, new_filter_state, bp) — carry ``bp`` forward.
    """
    if prev_b is None:
        # before the dense pass: ``out`` may be ``previous``
        prev_b = boundary_pressures(previous, s)
    if halos is None:
        dense = weighted_step(current, previous, s.weight_code, out=out)
    else:
        dense = weighted_step_sharded(current, previous, s.weight_code,
                                      halos, out=out)
    dense_flat = dense.reshape(dense.numel())
    csw = dense_flat[s.b_node_idx]                              # (B,)
    bp, new_state = boundary_update(csw, prev_b, filter_state, s,
                                    expanded, tables)
    in_place = not requires_grad(dense, bp)
    nxt_flat = _scatter_boundary(dense_flat, s, bp, in_place)
    return nxt_flat.reshape(current.shape), new_state, bp
