"""Spatial domain decomposition of the FDTD mesh over a mesh of devices, and
data parallelism for rays.

Port of ``wayverb_tpu.parallel.sharding``.  The reference runs one
``shard_map`` program over a ``jax.sharding.Mesh``.  The port's counterpart
is a ``DeviceMesh``: an ordered tuple of ``torch.device``s, one per x-shard.
A device may repeat (``["cuda:0"] * 4``, ``["cpu"] * 8``), as the
reference's tests run on eight virtual CPU devices, so one card runs a grid
split into shards with real halos.

Without ``owners`` one process drives every shard, shard after shard from
one host thread, and the collectives become tensor code that autograd
transposes, so a shard's halo cotangents flow back to the neighbour's edge
rows with no hand-written adjoint of the exchange:

 * ``ppermute`` of an edge row → a slice of the neighbour shard's field,
   moved with ``.to(device)`` when the devices differ;
 * ``psum`` → a sum (or a gather) of the per-shard tensors on one device.

With ``owners`` (``distributed.global_device_mesh``) the shards span
processes: each process runs its own shards, and what crosses between them
goes through ``torch.distributed`` (``shard_comm``), each part an autograd
``Function`` where it carries a gradient:

 * the halo exchange posts the own edge rows to each neighbour shard on
   another process and receives theirs; its backward sends the received
   rows' cotangents back and adds those that arrive into the own edge rows
   (the transpose of ``ppermute``).  A neighbour on the same process keeps
   the slice;
 * the tap reduction sums each process's reads of the taps it owns (zeros
   elsewhere) across processes, so the outputs are replicated in tap order,
   as the reference's psum leaves them; its backward is the identity on
   the local reads;
 * replicated inputs (filter tables, source signal and positions) pass
   forward unchanged and sum their cotangents across processes, so
   ``loss.backward()`` gives every process the full gradient;
 * ``stable`` is a minimum across processes.

The backward's messages are ordered by a token that every collective takes
and passes on, so each process runs them in the same order, and a run that
recomputes its segments (``checkpoint_every``) replays the forward's
messages from a cache instead of sending them again.  With the ``gloo``
backend, device tensors are staged through host buffers; the bytes and
seconds are counted in ``transport_stats``.

Here: ``shard_structure`` partitions the boundary nodes per shard (padded to
the largest shard's count, as the reference's static shapes need), with
neighbour gathers indexing the halo-extended local block, and
``sharded_run_waveguide`` runs the gather stencil on that layout, the oracle
of the fused sharded paths (``general_sharded.py``, ``box_sharded.py``);
``sharded_trace`` shards rays as a batch axis and sums the histograms.
"""

from __future__ import annotations

import dataclasses
import time
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
    ``Mesh`` does (``mesh.devices.size``, ``mesh.shape["x"]``).

    ``owners``: the process (``torch.distributed`` rank) that runs each
    shard, and ``rank`` this process's; None (the default): this process
    runs every shard.  A process's devices are its own; the entries of
    other processes' shards only name theirs.
    """

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("x",)
    owners: Optional[Tuple[int, ...]] = None
    rank: int = 0

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        if not self.devices:
            raise ValueError("a DeviceMesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError(f"a DeviceMesh is 1-D, got axes "
                             f"{self.axis_names}")
        if self.owners is not None:
            owners = tuple(int(o) for o in self.owners)
            object.__setattr__(self, "owners", owners)
            if len(owners) != len(self.devices):
                raise ValueError(f"{len(owners)} owners for "
                                 f"{len(self.devices)} shards")
            if self.rank not in owners:
                raise ValueError(f"process {self.rank} owns no shard of "
                                 f"the mesh (owners {owners})")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    @property
    def local_shards(self) -> Tuple[int, ...]:
        """The shards this process runs, in x order."""
        if self.owners is None:
            return tuple(range(self.size))
        return tuple(i for i, o in enumerate(self.owners) if o == self.rank)


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


def exchange_halos(blocks, i: int, dim: int = 0):
    """(lo, hi): the neighbours' edge slices of ``blocks[i]`` along
    ``dim`` (its rows beyond the shard; zeros at the grid ends), on
    ``blocks[i]``'s device; every block on this process."""
    own = blocks[i]
    zero = torch.zeros_like(own.narrow(dim, 0, 1))
    n = blocks[i - 1].shape[dim] if i > 0 else 0
    lo = blocks[i - 1].narrow(dim, n - 1, 1).to(own.device) if i > 0 \
        else zero
    hi = blocks[i + 1].narrow(dim, 0, 1).to(own.device) \
        if i < len(blocks) - 1 else zero
    return lo, hi


# ---------------------------------------------------------------------------
# the transport between processes

transport_stats = {"bytes_sent": 0, "bytes_received": 0, "staging_s": 0.0,
                   "wait_s": 0.0, "messages": 0, "reductions": 0}


def reset_transport_stats():
    """Zero ``transport_stats``: the bytes this process sent and received
    point to point, the seconds spent copying to and from host buffers
    (``gloo``) and waiting, and the counts of messages and reductions."""
    transport_stats.update(bytes_sent=0, bytes_received=0, staging_s=0.0,
                           wait_s=0.0, messages=0, reductions=0)


def shard_comm(mesh: DeviceMesh, grad: bool = False,
               recompute: bool = False):
    """The transport of one run over ``mesh``: ``_LocalComm`` when one
    process runs every shard, else ``_ProcessComm``.  ``grad``: the run
    builds a backward; ``recompute``: it recomputes checkpointed segments in
    the backward."""
    if mesh.owners is None:
        return _LocalComm(mesh)
    return _ProcessComm(mesh, grad, recompute)


class _LocalComm:
    """Every shard on this process: slices, no messages."""

    distributed = False

    def __init__(self, mesh: DeviceMesh):
        self.local = tuple(range(mesh.size))

    def replicate(self, tensors):
        return list(tensors)

    def halos(self, t: int, groups):
        """For each (blocks, dim) of ``groups`` (one block per local shard),
        each local shard's (lo, hi) halo slices."""
        return [[exchange_halos(blocks, k, dim) for k in range(len(blocks))]
                for blocks, dim in groups]

    def all_true(self, flag):
        return flag


def _tag(t: int, group: int, shard: int, side: int, n: int) -> int:
    """The message tag of the halo of ``shard``'s ``side`` (0: its low x
    neighbour's row, 1: its high one) in exchange ``group`` of step ``t``;
    the backward's reply adds 1."""
    return ((((t * 2 + group) * n + shard) * 2) + side) * 2


class _ProcessComm:
    """Shards on several processes: ``torch.distributed`` point to point
    for the halos, all-reduces for the taps, the replicated inputs'
    cotangents and ``stable``."""

    distributed = True

    def __init__(self, mesh: DeviceMesh, grad: bool, recompute: bool):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("a DeviceMesh with owners needs "
                               "torch.distributed: call "
                               "distributed.initialize first")
        self.dist = dist
        self.mesh = mesh
        self.local = mesh.local_shards
        self._pos = {s: k for k, s in enumerate(self.local)}
        self.stage = dist.get_backend() == "gloo"
        self._cache = {} if grad and recompute else None
        self.token = torch.zeros((), device=mesh.devices[self.local[0]],
                                 requires_grad=True) if grad else None

    # -- the wire ----------------------------------------------------------

    def post(self, sends, send_to, recv_from):
        """Post every send and receive of one exchange at once and wait for
        them all.  ``send_to``: (rank, tag) per tensor of ``sends``;
        ``recv_from``: (rank, tag, shape, dtype, device) per received
        tensor.  Returns the received tensors on their devices."""
        dist = self.dist
        t0 = time.perf_counter()
        bufs = [x.detach().to("cpu" if self.stage else x.device)
                .contiguous() for x in sends]
        rbufs = [torch.empty(shape, dtype=dtype,
                             device="cpu" if self.stage else device)
                 for _, _, shape, dtype, device in recv_from]
        t1 = time.perf_counter()
        ops = [dist.P2POp(dist.isend, b, peer, tag=tag)
               for b, (peer, tag) in zip(bufs, send_to)]
        ops += [dist.P2POp(dist.irecv, b, peer, tag=tag)
                for b, (peer, tag, *_) in zip(rbufs, recv_from)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        t2 = time.perf_counter()
        out = [b.to(spec[4]) for b, spec in zip(rbufs, recv_from)]
        t3 = time.perf_counter()
        stats = transport_stats
        stats["staging_s"] += (t1 - t0) + (t3 - t2) if self.stage else 0.0
        stats["wait_s"] += t2 - t1
        stats["messages"] += len(ops)
        stats["bytes_sent"] += sum(b.numel() * b.element_size() for b in bufs)
        stats["bytes_received"] += sum(b.numel() * b.element_size()
                                       for b in rbufs)
        return out

    def reduce(self, x, op=None):
        """``x`` summed (or reduced by ``op``) across processes, on its
        device."""
        dist = self.dist
        t0 = time.perf_counter()
        buf = x.detach().to("cpu" if self.stage else x.device,
                            copy=True).contiguous()
        t1 = time.perf_counter()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM if op is None else op)
        t2 = time.perf_counter()
        out = buf.to(x.device)
        t3 = time.perf_counter()
        if self.stage:
            transport_stats["staging_s"] += (t1 - t0) + (t3 - t2)
        transport_stats["wait_s"] += t2 - t1
        transport_stats["reductions"] += 1
        return out

    def _cached(self, key, make):
        """``make()``'s tensors, or on a recomputation of the same step
        (``checkpoint_every``) copies of what it gave the first time."""
        if self._cache is None:
            return make()
        if key in self._cache:
            return [x.clone() for x in self._cache[key]]
        out = make()
        self._cache[key] = [x.detach() for x in out]
        return out

    # -- the run's collectives --------------------------------------------

    def replicate(self, tensors):
        """``tensors`` as inputs every process holds whole: those that
        require grad pass through ``_Replicate`` (their cotangents summed
        across processes); the others as they are."""
        out = list(tensors)
        if self.token is None:
            return out
        idx = [i for i, x in enumerate(tensors)
               if isinstance(x, torch.Tensor) and x.requires_grad]
        if idx:
            *reps, self.token = _Replicate.apply(
                self, self.token, *[tensors[i] for i in idx])
            for i, r in zip(idx, reps):
                out[i] = r
        return out

    def halos(self, t: int, groups):
        """As ``_LocalComm.halos``; the rows of neighbour shards on other
        processes go through ``_Exchange``, one for all ``groups``."""
        mesh, n = self.mesh, self.mesh.size
        owners, rank = mesh.owners, mesh.rank
        out = [[None] * len(self.local) for _ in groups]
        sends, send_to, recv_from, slots = [], [], [], []
        for g, (blocks, dim) in enumerate(groups):
            for k, s in enumerate(self.local):
                own = blocks[k]
                pair = []
                for side, nb in ((0, s - 1), (1, s + 1)):
                    if nb < 0 or nb >= n:
                        pair.append(torch.zeros_like(own.narrow(dim, 0, 1)))
                    elif owners[nb] == rank:
                        other = blocks[self._pos[nb]]
                        row = other.narrow(
                            dim, other.shape[dim] - 1 if side == 0 else 0, 1)
                        pair.append(row.to(own.device))
                    else:
                        edge = own.narrow(
                            dim, 0 if side == 0 else own.shape[dim] - 1, 1)
                        sends.append(edge)
                        send_to.append((owners[nb],
                                        _tag(t, g, nb, 1 - side, n)))
                        recv_from.append((owners[nb], _tag(t, g, s, side, n),
                                          tuple(edge.shape), edge.dtype,
                                          own.device))
                        slots.append((g, k, side))
                        pair.append(None)
                out[g][k] = pair
        if slots:
            if self.token is None:
                recvs = self.post(sends, send_to, recv_from)
            else:
                *recvs, self.token = _Exchange.apply(
                    self, ("halo", t), send_to, recv_from, self.token,
                    *sends)
            for (g, k, side), r in zip(slots, recvs):
                out[g][k][side] = r
        return [[tuple(p) for p in grp] for grp in out]

    def taps(self, t: int, values, positions, n_taps: int, device):
        """The (n_taps,) taps in tap order on every process: this
        process's ``values`` at ``positions``, the others' elsewhere."""
        full = torch.zeros(n_taps, dtype=values.dtype, device=device)
        if len(values):
            full = full.index_put((positions,), values.to(device))
        if self.token is None:
            return self.reduce(full)
        taps, self.token = _TapSum.apply(self, ("taps", t), self.token, full)
        return taps

    def all_true(self, flag):
        """``flag`` (a bool tensor) and every other process's."""
        low = self.reduce(flag.to(torch.int32).reshape(1),
                          self.dist.ReduceOp.MIN)
        return low.reshape(()).to(torch.bool)


class _Exchange(torch.autograd.Function):
    """The halo rows between processes; backward: the transpose."""

    @staticmethod
    def forward(ctx, comm, key, send_to, recv_from, token, *sends):
        ctx.comm, ctx.send_to, ctx.recv_from = comm, send_to, recv_from
        ctx.send_like = [(tuple(x.shape), x.dtype, x.device) for x in sends]
        recvs = comm._cached(key, lambda: comm.post(sends, send_to,
                                                    recv_from))
        return (*recvs, token.clone())

    @staticmethod
    def backward(ctx, *grads):
        back_to = [(peer, tag + 1) for peer, tag, *_ in ctx.recv_from]
        back_from = [(peer, tag + 1, *like) for (peer, tag), like
                     in zip(ctx.send_to, ctx.send_like)]
        g_sends = ctx.comm.post(list(grads[:-1]), back_to, back_from)
        return (None, None, None, None, torch.zeros_like(grads[-1]),
                *g_sends)


class _TapSum(torch.autograd.Function):
    """The taps summed across processes; backward: the identity."""

    @staticmethod
    def forward(ctx, comm, key, token, full):
        taps = comm._cached(key, lambda: [comm.reduce(full)])[0]
        return taps, token.clone()

    @staticmethod
    def backward(ctx, g_taps, g_token):
        return None, None, torch.zeros_like(g_token), g_taps


class _Replicate(torch.autograd.Function):
    """Inputs every process holds; backward: cotangents summed across
    processes."""

    @staticmethod
    def forward(ctx, comm, token, *tensors):
        ctx.comm = comm
        return (*[x.clone() for x in tensors], token.clone())

    @staticmethod
    def backward(ctx, *grads):
        summed = [ctx.comm.reduce(g) for g in grads[:-1]]
        return (None, torch.zeros_like(grads[-1]), *summed)


def replicate_fields(comm, obj, names=None):
    """``obj`` (a dataclass) with its tensor fields (or those in ``names``)
    passed through ``comm.replicate`` in one call."""
    if not comm.distributed or obj is None:
        return obj
    fields = [f.name for f in dataclasses.fields(obj)
              if (names is None or f.name in names)
              and isinstance(getattr(obj, f.name), torch.Tensor)]
    reps = comm.replicate([getattr(obj, name) for name in fields])
    return dataclasses.replace(obj, **dict(zip(fields, reps)))


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
    receiver node, on the first shard's device (the first of this
    process's shards).

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

    dtype = sharded.coef_b.dtype
    signal = torch.as_tensor(signal, dtype=dtype)
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (sharded.coef_b, sharded.coef_a, signal))
    comm = shard_comm(mesh, grad)
    local = comm.local
    sharded = replicate_fields(comm, sharded, ("coef_b", "coef_a"))
    [signal] = comm.replicate([signal])
    tables = [_shard_tables(sharded, s, mesh.devices[s]) for s in local]
    out_device = mesh.devices[local[0]]
    pos = {s: k for k, s in enumerate(local)}
    src_k, rcv_k = pos.get(src_shard), pos.get(rcv_shard)
    zeros = lambda s, *shape: torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=mesh.devices[s])
    cur = [zeros(s, lx, Y, Z) for s in local]
    prev = [zeros(s, lx, Y, Z) for s in local]
    fstate = [t.initial_filter_state(dtype) for t in tables]
    if src_k is not None:
        signal = signal.to(mesh.devices[src_shard])
        src_idx = torch.tensor([src_rem], device=mesh.devices[src_shard])
    rcv_pos = torch.zeros(1, dtype=torch.int64, device=out_device)

    taps = []
    for t in range(num_steps):
        if src_k is not None:
            flat = cur[src_k].reshape(-1).index_put((src_idx,),
                                                    signal[t:t + 1])
            cur[src_k] = flat.reshape(lx, Y, Z)
        if rcv_k is not None:
            tap = cur[rcv_k].reshape(-1)[rcv_rem:rcv_rem + 1]
        else:
            tap = torch.zeros(0, dtype=dtype, device=out_device)
        taps.append(comm.taps(t, tap, rcv_pos, 1, out_device)
                    if comm.distributed else tap)
        halos = comm.halos(t, [(cur, 0)])[0]
        steps = [_local_step(torch.cat([lo, c, hi]), prev[k], fstate[k],
                             tables[k])
                 for k, (c, (lo, hi)) in enumerate(zip(cur, halos))]
        prev = cur
        cur = [nxt for nxt, _ in steps]
        fstate = [state for _, state in steps]
    return torch.cat(taps).to(out_device)


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

    On a mesh whose shards span processes each process traces its own
    shards and draws (and drops) the others' directions from ``generator``,
    which every process must seed alike; the parts are summed across
    processes and then in shard order, so every process holds the
    histogram of a one-process run with the same generator.
    """
    from wayverb_tpu_torch.core.orientation import random_unit_vectors
    from wayverb_tpu_torch.raytracer import tracer

    _check_axis(mesh, axis_name)
    comm = shard_comm(mesh)
    drop_draws = comm.distributed and "directions" not in kwargs
    if drop_draws and generator is None:
        raise ValueError("sharded_trace across processes needs a generator "
                         "(seeded alike on every process) or directions=")
    total_rays = rays_per_device * mesh.size
    device = mesh.devices[comm.local[0]]
    parts = []
    for s, dev in enumerate(mesh.devices):
        local = s in comm.local
        draws = {}
        if drop_draws:
            # the directions trace would draw, drawn here so that the
            # shards of other processes advance the generator too
            at = dev if local else None
            draws["directions"] = (
                random_unit_vectors(rays_per_device, generator, at),
                torch.stack([random_unit_vectors(rays_per_device, generator,
                                                 at)
                             for _ in range(depth)]))
        if not local:
            parts.append(None)
            continue
        res = tracer.trace(soup.to(dev), surfaces.to(dev), source, receiver,
                           generator, num_rays=rays_per_device, depth=depth,
                           max_time=max_time, **kwargs, **draws)
        # per-ray energy was normalised by rays_per_device; rescale to the
        # global count and sum across devices
        parts.append((res.histogram
                      * (rays_per_device / total_rays)).to(device))
    if comm.distributed:
        zero = torch.zeros_like(parts[comm.local[0]])
        parts = list(comm.reduce(torch.stack(
            [zero if p is None else p for p in parts])))
    hist = parts[0]
    for part in parts[1:]:
        hist = hist + part
    return hist
