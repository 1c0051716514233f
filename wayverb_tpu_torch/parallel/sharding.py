"""Spatial domain decomposition of the FDTD mesh over a mesh of devices, and
data parallelism for rays.

Port of ``wayverb_tpu.parallel.sharding``.  The reference runs one
``shard_map`` program over a ``jax.sharding.Mesh`` of one host's devices.
The port's counterpart is a single-process mesh (``DeviceMesh``): an ordered
tuple of ``torch.device``s, one per x-shard, driven shard after shard from
one host thread.  A device may repeat (``["cuda:0"] * 4``, ``["cpu"] * 8``),
as the reference's tests run on eight virtual CPU devices, so one card runs
a grid split into shards with real halos.  The collectives become tensor
code, and autograd transposes them, so a shard's halo cotangents flow back
to the neighbour's edge rows with no hand-written adjoint of the exchange:

 * ``ppermute`` of an edge row → a slice of the neighbour shard's field,
   moved with ``.to(device)`` when the devices differ;
 * ``psum`` → a sum (or a gather) of the per-shard tensors on one device.

Here: ``shard_structure`` partitions the boundary nodes per shard (padded to
the largest shard's count, as the reference's static shapes need), with
neighbour gathers indexing the halo-extended local block, and
``sharded_run_waveguide`` runs the gather stencil on that layout, the oracle
of the fused sharded paths (``general_sharded.py``, ``box_sharded.py``);
``sharded_trace`` shards rays as a batch axis and sums the histograms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wayverb_tpu_torch.waveguide.descriptor import COURANT, COURANT_SQ
from wayverb_tpu_torch.waveguide.setup import MeshStructure
from wayverb_tpu_torch.waveguide.stencil import expand_boundary_coefficients


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh of devices: shard ``i`` of the grid's x axis lives on
    ``devices[i]``.  ``size`` and ``shape[axis]`` read as the reference's
    ``Mesh`` does (``mesh.devices.size``, ``mesh.shape["x"]``)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("x",)

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        if not self.devices:
            raise ValueError("a DeviceMesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError(f"a DeviceMesh is 1-D, got axes "
                             f"{self.axis_names}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}


def make_device_mesh(n_devices: Optional[int] = None, axis_name: str = "x",
                     devices: Optional[Sequence] = None) -> DeviceMesh:
    """A ``DeviceMesh`` over ``axis_name``.

    Without ``devices``: the first ``n_devices`` CUDA devices (all of them
    when None); raises if fewer exist.  ``devices``: an explicit list, in
    shard order, that may repeat a device (``["cuda:0"] * 4`` splits a grid
    into four shards on one card, ``["cpu"] * 8`` into eight on the host);
    ``n_devices`` then takes its first ``n_devices`` entries.
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else int(n_devices)
        if n < 1 or n > count:
            raise RuntimeError(
                f"make_device_mesh: {n_devices} CUDA devices requested, "
                f"{count} available; pass devices= (a device may repeat, "
                "e.g. ['cpu'] * 8) to shard over other devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = list(devices)
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(f"make_device_mesh: {n_devices} devices "
                                 f"requested from a list of {len(devices)}")
            devices = devices[:n_devices]
    return DeviceMesh(tuple(devices), (axis_name,))


def _check_axis(mesh: DeviceMesh, axis_name: str):
    if axis_name not in mesh.axis_names:
        raise ValueError(f"axis {axis_name!r} is not an axis of the mesh "
                         f"{mesh.axis_names}")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@dataclasses.dataclass(frozen=True)
class ShardedStructure:
    """Per-shard boundary data; leading axis = shard.

    Local pressure blocks are halo-extended along x by one plane on each
    side; all flat indices below index that extended (lx+2, Y, Z) block.
    The tables live on the host; a run moves each shard's rows to its
    device.
    """

    interior_mask: torch.Tensor   # (n, lx, Y, Z) f32
    b_node_idx: torch.Tensor      # (n, B) int64 into the extended block
    b_neighbor_idx: torch.Tensor  # (n, B, 6) int64
    b_neighbor_w: torch.Tensor    # (n, B, 6) f32
    b_slot_mask: torch.Tensor     # (n, B, 3) f32
    b_slot_coef: torch.Tensor     # (n, B, 3) int64
    b_valid: torch.Tensor         # (n, B) f32 — padding rows are 0
    coef_b: torch.Tensor          # (S, o+1) replicated
    coef_a: torch.Tensor          # (S, o+1)


def shard_structure(structure: MeshStructure, dims: Tuple[int, int, int],
                    num_shards: int) -> Tuple[ShardedStructure, tuple]:
    """Partition a MeshStructure along x (host-side, numpy).

    Returns (sharded_structure, padded_dims).  The grid is zero-padded so
    x divides evenly; padded nodes are outside (inactive).
    """
    X, Y, Z = dims
    lx = -(-X // num_shards)
    Xp = lx * num_shards

    interior = np.zeros((Xp, Y, Z), dtype=np.float32)
    interior[:X] = _host(structure.interior_mask)
    interior = interior.reshape(num_shards, lx, Y, Z)

    node = _host(structure.b_node_idx)
    gx, rem = np.divmod(node, Y * Z)
    gy, gz = np.divmod(rem, Z)
    shard_of = gx // lx
    x_local = gx - shard_of * lx

    ngx, nrem = np.divmod(_host(structure.b_neighbor_idx), Y * Z)
    ngy, ngz = np.divmod(nrem, Z)

    counts = np.bincount(shard_of, minlength=num_shards)
    B = max(int(counts.max()), 1)

    def ext_flat(xl, y, z):
        """Flat index into the halo-extended (lx+2, Y, Z) block."""
        return ((xl + 1) * Y + y) * Z + z

    sh = {
        "b_node_idx": np.zeros((num_shards, B), np.int64),
        "b_neighbor_idx": np.zeros((num_shards, B, 6), np.int64),
        "b_neighbor_w": np.zeros((num_shards, B, 6), np.float32),
        "b_slot_mask": np.zeros((num_shards, B, 3), np.float32),
        "b_slot_coef": np.zeros((num_shards, B, 3), np.int64),
        "b_valid": np.zeros((num_shards, B), np.float32),
    }
    w = _host(structure.b_neighbor_w)
    smask = _host(structure.b_slot_mask)
    scoef = _host(structure.b_slot_coef)
    for s in range(num_shards):
        sel = np.nonzero(shard_of == s)[0]
        k = len(sel)
        if k == 0:
            continue
        sh["b_node_idx"][s, :k] = ext_flat(x_local[sel], gy[sel], gz[sel])
        nxl = ngx[sel] - s * lx      # may be -1 or lx (halo planes)
        sh["b_neighbor_idx"][s, :k] = ext_flat(nxl, ngy[sel], ngz[sel])
        sh["b_neighbor_w"][s, :k] = w[sel]
        sh["b_slot_mask"][s, :k] = smask[sel]
        sh["b_slot_coef"][s, :k] = scoef[sel]
        sh["b_valid"][s, :k] = 1.0

    return ShardedStructure(
        interior_mask=torch.from_numpy(interior),
        **{k: torch.from_numpy(v) for k, v in sh.items()},
        coef_b=structure.coef_b, coef_a=structure.coef_a,
    ), (Xp, Y, Z)


def _halo_exchange(fields, i: int):
    """Shard ``i``'s block with one x-plane from each neighbour appended:
    (lx, Y, Z) → (lx+2, Y, Z); zero planes at the grid ends."""
    field = fields[i]
    zero = torch.zeros_like(field[:1])
    low = fields[i - 1][-1:].to(field.device) if i > 0 else zero
    high = fields[i + 1][:1].to(field.device) if i < len(fields) - 1 \
        else zero
    return torch.cat([low, field, high])


def _shard_tables(sharded: ShardedStructure, s: int,
                  device) -> MeshStructure:
    """Shard ``s``'s valid rows of the tables, on ``device`` (flat indices
    into its halo-extended block)."""
    k = int(sharded.b_valid[s].sum())
    rows = {name: getattr(sharded, name)[s, :k].to(device)
            for name in ("b_node_idx", "b_neighbor_idx", "b_neighbor_w",
                         "b_slot_mask", "b_slot_coef")}
    return MeshStructure(coef_b=sharded.coef_b.to(device),
                         coef_a=sharded.coef_a.to(device),
                         interior_mask=sharded.interior_mask[s].to(device),
                         **rows)


def _local_step(ext, prev, fstate, s: MeshStructure):
    """One FDTD step of one shard, given its halo-extended block ``ext``
    (``_halo_exchange``) and the shard's tables ``s`` (``_shard_tables``).

    prev: (lx, Y, Z).  Returns (next (lx, Y, Z), new filter state).
    """
    lx = ext.shape[0] - 2
    inner = ext[1:-1]
    # interior: 6-neighbour sum on the extended block
    total = (ext[:-2] + ext[2:]
             + F.pad(inner[:, :-1], (0, 0, 1, 0))
             + F.pad(inner[:, 1:], (0, 0, 0, 1))
             + F.pad(inner[:, :, :-1], (1, 0))
             + F.pad(inner[:, :, 1:], (0, 1)))
    nxt = (COURANT_SQ * total - prev) * s.interior_mask

    # boundary pass on the extended flat block
    ext_flat = ext.reshape(-1)
    neigh = ext_flat[s.b_neighbor_idx]                   # (B, 6)
    csw = COURANT_SQ * torch.sum(neigh * s.b_neighbor_w, dim=-1)

    bc, ac = expand_boundary_coefficients(s)
    b0, a0 = bc[..., 0], ac[..., 0]
    m0 = fstate[..., 0]
    mask = s.b_slot_mask
    fw = COURANT_SQ * torch.sum(mask * m0 / b0, dim=-1)
    cw = COURANT * torch.sum(mask * a0 / b0, dim=-1)

    prev_b = F.pad(prev, (0, 0, 0, 0, 1, 1)).reshape(-1)[s.b_node_idx]
    new_p = (csw + fw + (cw - 1.0) * prev_b) / (1.0 + cw)

    filt_in = -((a0 * (prev_b - new_p)[:, None]) / (b0 * COURANT) + m0 / b0)
    out = (filt_in * b0 + m0) / a0
    shifted = F.pad(fstate[..., 1:], (0, 1))
    new_state = shifted + bc[..., 1:] * filt_in[..., None] \
        - ac[..., 1:] * out[..., None]
    new_state = torch.where(mask[..., None] > 0, new_state, fstate)

    nxt_ext = F.pad(nxt, (0, 0, 0, 0, 1, 1)).reshape(-1)
    nxt_ext = nxt_ext.index_copy(0, s.b_node_idx, new_p)
    return nxt_ext.reshape(ext.shape)[1:lx + 1], new_state


def sharded_run_waveguide(mesh: DeviceMesh, axis_name: str,
                          sharded: ShardedStructure,
                          padded_dims: Tuple[int, int, int],
                          source_flat_idx: int, receiver_flat_idx: int,
                          signal, num_steps: int):
    """Run the sharded gather-stencil mesh; returns (T,) pressure at the
    receiver node, on the first shard's device.

    Source/receiver flat indices are GLOBAL (into the padded grid); the
    owning shard applies them.  Each step exchanges one halo plane with
    each neighbour, and every operation is out of place, so the run
    differentiates (with respect to ``sharded.coef_b`` and ``coef_a``).
    """
    _check_axis(mesh, axis_name)
    Xp, Y, Z = padded_dims
    n = mesh.size
    lx = Xp // n
    src_shard, src_rem = divmod(int(source_flat_idx), lx * Y * Z)
    rcv_shard, rcv_rem = divmod(int(receiver_flat_idx), lx * Y * Z)

    tables = [_shard_tables(sharded, s, dev)
              for s, dev in enumerate(mesh.devices)]
    dtype = sharded.coef_b.dtype
    signal = torch.as_tensor(signal, dtype=dtype).to(mesh.devices[src_shard])
    zeros = lambda s, *shape: torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=mesh.devices[s])
    cur = [zeros(s, lx, Y, Z) for s in range(n)]
    prev = [zeros(s, lx, Y, Z) for s in range(n)]
    fstate = [t.initial_filter_state(dtype) for t in tables]
    src_idx = torch.tensor([src_rem], device=mesh.devices[src_shard])

    taps = []
    for t in range(num_steps):
        flat = cur[src_shard].reshape(-1).index_put((src_idx,),
                                                    signal[t:t + 1])
        cur[src_shard] = flat.reshape(lx, Y, Z)
        taps.append(cur[rcv_shard].reshape(-1)[rcv_rem:rcv_rem + 1])
        steps = [_local_step(_halo_exchange(cur, s), prev[s], fstate[s],
                             tables[s]) for s in range(n)]
        prev = cur
        cur = [nxt for nxt, _ in steps]
        fstate = [state for _, state in steps]
    return torch.cat(taps).to(mesh.devices[0])


# ---------------------------------------------------------------------------
# data-parallel rays

def sharded_trace(mesh: DeviceMesh, axis_name: str, soup, surfaces, source,
                  receiver, generator: Optional[torch.Generator],
                  rays_per_device: int, depth: int, max_time: float,
                  **kwargs):
    """Trace ``rays_per_device`` rays on each device of ``mesh``; the
    histograms, normalised to the global ray count, are summed on the first
    device.

    Shard ``i`` takes the ``i``-th successive draws of ``generator`` (the
    reference folds its key with ``i``; torch cannot reproduce ``jax.random``
    either way).  ``kwargs`` go to ``tracer.trace``.
    """
    from wayverb_tpu_torch.raytracer import tracer

    _check_axis(mesh, axis_name)
    total_rays = rays_per_device * mesh.size
    hist = None
    for device in mesh.devices:
        res = tracer.trace(soup.to(device), surfaces.to(device), source,
                           receiver, generator, num_rays=rays_per_device,
                           depth=depth, max_time=max_time, **kwargs)
        # per-ray energy was normalised by rays_per_device; rescale to the
        # global count and sum across devices
        part = (res.histogram * (rays_per_device / total_rays)).to(
            mesh.devices[0])
        hist = part if hist is None else hist + part
    return hist
