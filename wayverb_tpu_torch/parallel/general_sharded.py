"""Sharded GENERAL-mesh waveguide: the fused weight-code solver on x-shards.

Port of ``wayverb_tpu.parallel.general_sharded``.  The grid is split along
x over a ``DeviceMesh`` (``sharding.py``) and each shard runs the same fused
general step as ``run.run_waveguide``:

 * the dense pass is ``stencil_kernels.weighted_step_sharded`` — kernel B10
   on a CUDA tensor — with the neighbours' edge rows as its (1, Y, Z) halo
   inputs at local x = −1 and x = xl; its adjoint (B11) emits the halo
   cotangents, which autograd routes back through the exchange (a slice of
   the neighbour's field);
 * the compact boundary pass needs nothing from other shards: every
   boundary node's weighted sum comes from the local dense output, and its
   filter state, coefficients and previous pressure are partitioned to the
   owning shard at setup (``shard_general``);
 * receivers read the owning shards' taps (``box_sharded._ShardView``);
   sources inject locally;
 * on a mesh whose shards span processes (``distributed.py``) the halo
   rows, the taps, the replicated inputs' cotangents and ``stable`` cross
   between processes through ``sharding.shard_comm``; under
   ``checkpoint_every`` the recomputed segments replay the forward's
   messages from the transport's cache.

The halo rows enter B10's running sum where B8 would read the neighbour, so
the sharded run equals the single-device run to the bit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from wayverb_tpu_torch.core.environment import Environment
from wayverb_tpu_torch.parallel.box_sharded import (_inject_local,
                                                    _local_source,
                                                    _ShardView, _to_device)
from wayverb_tpu_torch.parallel.sharding import (DeviceMesh, _host,
                                                 replicate_fields, shard_comm)
from wayverb_tpu_torch.waveguide.box_fused import requires_grad
from wayverb_tpu_torch.waveguide.box_mega import _stack_outputs
from wayverb_tpu_torch.waveguide.setup import MeshStructure
from wayverb_tpu_torch.waveguide.stencil import (boundary_pressures,
                                                 expand_boundary_coefficients,
                                                 prepare_boundary_tables,
                                                 waveguide_step_carried)


@dataclasses.dataclass(frozen=True)
class ShardedGeneral:
    """Per-shard general-mesh tables; leading axis = shard, on the host."""

    weight_code: torch.Tensor    # (n, xl, Y, Z) int32
    b_node_local: torch.Tensor   # (n, B) int64 flat into (xl, Y, Z); pad = size
    b_node_global: torch.Tensor  # (n, B) int64 global flat (source patch_tap)
    b_slot_mask: torch.Tensor    # (n, B, 3) f32
    b_slot_coef: torch.Tensor    # (n, B, 3) int64
    b_valid: torch.Tensor        # (n, B) f32
    coef_b: torch.Tensor         # (S, o+1) replicated
    coef_a: torch.Tensor


def shard_general(structure: MeshStructure, dims: Tuple[int, int, int],
                  num_shards: int) -> ShardedGeneral:
    """Partition a general MeshStructure along x (host-side numpy).

    Requires ``dims[0] % num_shards == 0`` (build the mesh with
    ``compute_mesh(…, align=(num_shards, 1, 1))``)."""
    X, Y, Z = dims
    if X % num_shards:
        raise ValueError(f"x dim {X} not divisible by {num_shards}")
    xl = X // num_shards
    size = xl * Y * Z

    node = _host(structure.b_node_idx)
    gx, rem = np.divmod(node, Y * Z)
    shard_of = gx // xl
    counts = np.bincount(shard_of, minlength=num_shards)
    B = max(int(counts.max()), 1)

    b_local = np.full((num_shards, B), size, np.int64)   # pad → dropped
    b_global = np.zeros((num_shards, B), np.int64)
    smask = np.zeros((num_shards, B, 3), np.float32)
    scoef = np.zeros((num_shards, B, 3), np.int64)
    valid = np.zeros((num_shards, B), np.float32)
    m = _host(structure.b_slot_mask)
    c = _host(structure.b_slot_coef)
    for s in range(num_shards):
        sel = np.nonzero(shard_of == s)[0]
        k = len(sel)
        if k == 0:
            continue
        b_local[s, :k] = (gx[sel] - s * xl) * Y * Z + rem[sel]
        b_global[s, :k] = node[sel]
        smask[s, :k] = m[sel]
        scoef[s, :k] = c[sel]
        valid[s, :k] = 1.0

    wcode = _host(structure.weight_code).reshape(num_shards, xl, Y, Z)
    return ShardedGeneral(
        weight_code=torch.from_numpy(np.ascontiguousarray(wcode)),
        b_node_local=torch.from_numpy(b_local),
        b_node_global=torch.from_numpy(b_global),
        b_slot_mask=torch.from_numpy(smask),
        b_slot_coef=torch.from_numpy(scoef),
        b_valid=torch.from_numpy(valid),
        coef_b=structure.coef_b,
        coef_a=structure.coef_a,
    )


def _shard_structure(sg: ShardedGeneral, s: int, device):
    """Shard ``s`` as a ``MeshStructure`` of its valid rows on ``device``
    (``b_node_idx`` local), and its boundary nodes' global indices."""
    k = int(sg.b_valid[s].sum())
    structure = MeshStructure(
        coef_b=sg.coef_b.to(device), coef_a=sg.coef_a.to(device),
        b_node_idx=sg.b_node_local[s, :k].to(device),
        b_slot_mask=sg.b_slot_mask[s, :k].to(device),
        b_slot_coef=sg.b_slot_coef[s, :k].to(device),
        weight_code=sg.weight_code[s].to(device))
    return structure, sg.b_node_global[s, :k].to(device)


def run_waveguide_general_sharded(device_mesh: DeviceMesh, structure, dims,
                                  source, receiver, num_steps: int,
                                  dtype=torch.float32,
                                  checkpoint_every: int = 0) -> dict:
    """Sharded equivalent of ``run.run_waveguide`` (same outputs contract) on
    the fused general path.

    ``dims[0]`` must divide over ``device_mesh``.  ``receiver`` must expose
    ``tap_nodes()``.  Without a gradient each shard rotates two field
    buffers; ``checkpoint_every`` as for ``run_waveguide``.  On a mesh whose
    shards span processes, each process runs its own shards and gets the
    whole result.

    Returns {"outputs": stacked receiver outputs on the receiver's device,
    "stable": () bool tensor}.
    """
    from wayverb_tpu_torch.waveguide.run import (_require_general_tables,
                                                 _run_loop)
    _require_general_tables(structure)
    dims = tuple(int(d) for d in dims)
    X, Y, Z = dims
    devices = device_mesh.devices
    n = len(devices)
    sg = shard_general(structure, dims, n)
    xl = X // n
    grad = requires_grad(structure, source, receiver)
    comm = shard_comm(device_mesh, grad, recompute=bool(
        grad and checkpoint_every and num_steps > checkpoint_every))
    sg = replicate_fields(comm, sg, ("coef_b", "coef_a"))
    source = replicate_fields(comm, source)
    view = _ShardView(receiver, xl, dims, devices, comm)
    shards = [_shard_structure(sg, s, devices[s]) for s in comm.local]
    expanded = [expand_boundary_coefficients(st) for st, _ in shards]
    tables = [prepare_boundary_tables(st, ex)
              for (st, _), ex in zip(shards, expanded)]
    local = [_local_source(source, s * xl, xl, dims, devices[s])
             for s in comm.local]
    # carried boundary previous-pressures (one sparse gather per step saved,
    # as in run_waveguide); ``patch_tap`` reads GLOBAL indices
    patched = [_to_device(source, devices[s]) for s in comm.local] \
        if hasattr(source, "patch_tap") else None

    def body(carry, t: int):
        cur, prev, fstate, rstate, pb, bp_last, ok = carry
        cur = [_inject_local(src, c, t, grad) for src, c in zip(local, cur)]
        rstate, outputs = receiver.tap(view(cur, t), rstate)
        halos = comm.halos(t, [(cur, 0)])[0]
        steps = []
        for s, (st, b_global) in enumerate(shards):
            if patched is not None:
                pb_next = patched[s].patch_tap(b_global, bp_last[s], t)
                prev_b = pb[s]
            else:
                pb_next, prev_b = pb[s], None
            nxt, fs, bp = waveguide_step_carried(
                cur[s], prev[s], prev_b, fstate[s], st, expanded[s],
                tables[s], out=None if grad else prev[s], halos=halos[s])
            steps.append((nxt, fs, pb_next, bp,
                          ok[s] & torch.all(torch.isfinite(nxt))))
        nxt, fs, pb_next, bp, ok = (list(v) for v in zip(*steps))
        return (nxt, cur, fs, rstate, pb_next, bp, ok), outputs

    fields = lambda: [torch.zeros((xl, Y, Z), dtype=dtype,  # noqa: E731
                                  device=devices[s]) for s in comm.local]
    cur, prev = fields(), fields()
    init = (cur, prev, [st.initial_filter_state(dtype) for st, _ in shards],
            receiver.init_state(dtype, view.device),
            [boundary_pressures(p, st) for p, (st, _) in zip(prev, shards)],
            [boundary_pressures(c, st) for c, (st, _) in zip(cur, shards)],
            [torch.ones((), dtype=torch.bool, device=devices[s])
             for s in comm.local])
    carry, per_step = _run_loop(body, init, num_steps, checkpoint_every,
                                grad)
    stable = torch.ones((), dtype=torch.bool, device=view.device)
    for ok in carry[6]:
        stable = stable & ok.to(view.device)
    return {"outputs": _stack_outputs(per_step),
            "stable": comm.all_true(stable)}


def canonical_general_sharded(mesh, source_position, receiver_position,
                              simulation_time: float, device_mesh: DeviceMesh,
                              environment: Environment = Environment(),
                              dtype=torch.float32):
    """Sharded twin of ``run.canonical`` for a GENERAL (non-shoebox) mesh:
    calibrated impulse → directional receiver on the fused weight-code
    solver split over ``device_mesh``."""
    from wayverb_tpu_torch.waveguide.run import (WaveguideOutput,
                                                 canonical_problem)
    source, receiver, num_steps, fs = canonical_problem(
        mesh, source_position, receiver_position, simulation_time,
        environment)
    result = run_waveguide_general_sharded(
        device_mesh, mesh.structure, mesh.descriptor.dimensions, source,
        receiver, num_steps, dtype)
    intensity, pressure = result["outputs"]
    return WaveguideOutput(pressure=pressure, intensity=intensity,
                           sample_rate=fs, stable=result["stable"])
