"""Sharded shoebox waveguide: the fused solver on x-shards of the grid.

Port of ``wayverb_tpu.parallel.box_sharded`` in its serial step order
(``step_serial``): the x axis of the grid is split over a ``DeviceMesh``
(``sharding.py``), and each step of each shard is

 * the source injected where the shard owns its nodes;
 * the exchange: the neighbours' edge field rows (the halos of the fused
   step) and their edge rows of the four y/z boundary planes (the halos of
   the in-plane u shift);
 * the receiver taps, gathered from the owning shards;
 * the boundary-plane update, sharded as the field is: each shard updates
   only its own rows of the four y/z planes (whose u axis is the grid's x
   axis); the two x planes are computed on every shard from its own rows,
   and only the shard that owns an x plane's coordinate splices it;
 * ``box_fused.fused_step(…, halos=)`` — kernel B1 with real halos on a CUDA
   tensor, and under a gradient its adjoint B5 with halo cotangents, which
   autograd routes back through the exchange.

The reference's overlapped order (``step_overlap``, ``yz_edge_rows_fix``)
schedules the same function so that XLA can hide the exchange behind the
kernel; it is a speed item and is not ported, nor are ``fake_collectives``
and ``band_stacks``.  ``overlap_supported`` is.

Sources inject locally (a shard drops the nodes it does not own); receivers
read through ``_ShardView``, so ``NodeReceiver``, ``MultiNodeReceiver``,
``DirectionalReceiver`` and ``InterpolatedReceiver`` work unchanged.
Everything differentiates.  On a mesh whose shards span processes
(``distributed.py``) each process steps its own shards, and the exchange,
the taps, the replicated inputs' cotangents and ``stable`` go through
``sharding.shard_comm``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from wayverb_tpu_torch.core.environment import Environment
from wayverb_tpu_torch.parallel.sharding import (DeviceMesh, replicate_fields,
                                                shard_comm)
from wayverb_tpu_torch.waveguide import sources as src_mod
from wayverb_tpu_torch.waveguide.box_fused import (PLANES, _other_axes,
                                                   face_coefficients,
                                                   fused_step, requires_grad)
from wayverb_tpu_torch.waveguide.box_mega import _SeqTapView, _stack_outputs
from wayverb_tpu_torch.waveguide.descriptor import COURANT, COURANT_SQ


def _to_device(obj, device):
    """A source or receiver dataclass with every tensor field moved to
    ``device`` (differentiably)."""
    moved = {f.name: getattr(obj, f.name).to(device)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **moved)


class _ShardView:
    """The receiver's reads resolved over the shards' local blocks.

    The tap nodes (GLOBAL flat indices, ``receiver.tap_nodes()``) are split
    by owning shard once; each step gathers this process's shards' values,
    moves them to the receiver's device and puts them in tap order, which a
    ``_SeqTapView`` hands to ``receiver.tap`` (the reference's psum of
    masked per-shard reads).  With shards on other processes the reads are
    summed across processes (``comm.taps``), so every process gets every
    tap.
    """

    def __init__(self, receiver, xl: int, dims, devices, comm):
        if not hasattr(receiver, "tap_nodes"):
            raise TypeError("the sharded paths need receiver.tap_nodes()")
        nodes = receiver.tap_nodes()
        self.device = nodes.device
        self._comm = comm
        idx = nodes.detach().cpu().numpy().reshape(-1)
        block = xl * dims[1] * dims[2]
        shard = idx // block
        if np.any((idx < 0) | (shard >= len(devices))):
            raise ValueError("a tap node lies outside the grid")
        self._local, order = [], []
        for s in comm.local:
            sel = np.nonzero(shard == s)[0]
            self._local.append(torch.as_tensor(idx[sel] - s * block,
                                               device=devices[s])
                               if len(sel) else None)
            order.append(sel)
        perm = np.concatenate(order)
        if comm.distributed:
            self._n = len(idx)
            self._positions = torch.as_tensor(perm, device=self.device)
            return
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        self._inv = torch.as_tensor(inv, device=self.device)

    def __call__(self, fields, t: int = 0) -> _SeqTapView:
        parts = [f.reshape(-1)[i].to(self.device)
                 for f, i in zip(fields, self._local) if i is not None]
        if not self._comm.distributed:
            return _SeqTapView(torch.cat(parts)[self._inv])
        values = torch.cat(parts) if parts else torch.zeros(
            0, dtype=fields[0].dtype, device=self.device)
        return _SeqTapView(self._comm.taps(t, values, self._positions,
                                           self._n, self.device))


def _local_source(source, off: int, xl: int, dims, device):
    """``source`` restricted to the shard of rows [off, off + xl), with
    LOCAL flat indices and its tensors on ``device``; None when the shard
    owns none of its nodes."""
    yz = dims[1] * dims[2]
    if isinstance(source, (src_mod.HardSource, src_mod.SoftSource)):
        if not off <= source.node_idx // yz < off + xl:
            return None
        return dataclasses.replace(_to_device(source, device),
                                   node_idx=source.node_idx - off * yz)
    if isinstance(source, (src_mod.GaussianSource,
                           src_mod.PositionGaussianSource)):
        idx = source.node_indices.detach().cpu().numpy()
        sel = np.nonzero((idx // yz >= off) & (idx // yz < off + xl))[0]
        if len(sel) == 0:
            return None
        moved = _to_device(source, device)
        sel_t = torch.as_tensor(sel, device=device)
        fields = {"node_indices": torch.as_tensor(idx[sel] - off * yz,
                                                  device=device)}
        if isinstance(source, src_mod.GaussianSource):
            fields["weight"] = moved.weight[sel_t]
        else:
            fields["node_positions"] = moved.node_positions[sel_t]
        return dataclasses.replace(moved, **fields)
    raise TypeError(f"unsupported sharded source {type(source)}")


def _inject_local(local, field, t: int, grad: bool):
    """Apply a ``_local_source`` to a shard's (xl, Y, Z) field: in place,
    or on a copy when a gradient is required."""
    if local is None:
        return field
    flat = field.reshape(-1)
    return local.inject(flat.clone() if grad else flat, t).view(field.shape)


def _patch_inner_yz(local, in_yz, spec, dims, t: int):
    """Mirror the injection onto the carried y/z inner planes ((4, xl,
    Vmax) local rows), out of place.  The x inner planes need no patch: they
    are sliced from the already-injected field each step."""
    if local is None:
        return in_yz
    Y, Z = dims[1], dims[2]
    planes = [(q, a, spec.ilo[a] if side == 0 else spec.ihi[a])
              for q, (a, side) in enumerate(PLANES[2:])]
    if isinstance(local, (src_mod.HardSource, src_mod.SoftSource)):
        # a point source: its node and the planes it lies on are host ints
        x, rem = divmod(local.node_idx, Y * Z)
        y, z = divmod(rem, Z)
        targets = [(q, z if a == 1 else y) for q, a, coord in planes
                   if (y if a == 1 else z) == coord]
        if not targets:
            return in_yz
        in_yz = in_yz.clone()
        val = local.signal[t].to(in_yz.dtype)
        for q, v in targets:
            if isinstance(local, src_mod.HardSource):
                in_yz[q, x, v] = val
            else:
                in_yz[q, x, v] += val
        return in_yz
    idx = local.node_indices
    val = (local.weights() * local.signal[t]).to(in_yz.dtype)
    x, rem = idx // (Y * Z), idx % (Y * Z)
    y, z = rem // Z, rem % Z
    for q, a, coord in planes:
        on = (y if a == 1 else z) == coord
        in_yz = in_yz.index_put(
            (torch.full_like(x, q), x, z if a == 1 else y),
            torch.where(on, val, torch.zeros_like(val)), accumulate=True)
    return in_yz


def _shift_u(rows, halo_lo, halo_hi, delta: int):
    """Shift a (xl, V) row block along u with shard halo rows."""
    if delta == -1:
        return torch.cat([halo_lo, rows[:-1]])
    return torch.cat([rows[1:], halo_hi])


def _shift_v(rows, delta: int):
    if delta == -1:
        return F.pad(rows[:, :-1], (1, 0))
    return F.pad(rows[:, 1:], (0, 1))


def _shift_rows_full(arr, delta: int):
    """Zero-fill row shift for the replicated (Y, Z) x planes."""
    if delta == -1:
        return F.pad(arr[:-1], (0, 0, 1, 0))
    return F.pad(arr[1:], (0, 0, 0, 1))


def yz_line_contrib(spec, st_yz, off: int, xl: int):
    """This shard's contribution to the (4, 2, Vmax) m₀ lines of the four
    y/z planes at the two x-end coordinates: its own rows there, zeros
    where another shard owns the coordinate."""
    blo0, bhi0 = spec.ilo[0] - 1, spec.ihi[0] + 1

    def owned_row(q, coord):
        c = coord - off
        row = st_yz[0, q, min(max(c, 0), xl - 1)]
        return row if 0 <= c < xl else torch.zeros_like(row)

    return torch.stack([torch.stack([owned_row(q, blo0), owned_row(q, bhi0)])
                        for q in range(4)])


@dataclasses.dataclass(frozen=True)
class _RowMasks:
    """Static masks of one plane on a block of rows: the active region, the
    four in-plane neighbour weights and, per edge coupling, the one-hot
    row or column mask (in the order ``_plane_rows_update`` walks them)."""

    act: torch.Tensor
    w_um: torch.Tensor
    w_up: torch.Tensor
    w_vm: torch.Tensor
    w_vp: torch.Tensor
    edges: tuple


@functools.lru_cache(maxsize=256)
def _row_masks(spec, pi: int, u0: int, rows: int, V: int, device,
               dtype) -> _RowMasks:
    """``_RowMasks`` of plane ``pi`` on the rows u0 .. u0+rows−1 (global
    in-plane u), made once per geometry and shard."""
    a, _ = PLANES[pi]
    a1, a2 = _other_axes(a)
    blo = tuple(spec.ilo[x] - 1 for x in range(3))
    bhi = tuple(spec.ihi[x] + 1 for x in range(3))
    u = (u0 + np.arange(rows))[:, None]
    v = np.arange(V)[None, :]
    dev = lambda x: torch.as_tensor(  # noqa: E731
        np.array(x, dtype=np.float64), dtype=dtype, device=device)
    weights = lambda c, lo, hi, first: np.where(  # noqa: E731
        c == lo, 0.0 if first else 2.0,
        np.where(c == hi, 2.0 if first else 0.0, 1.0))
    edges = []
    for edge_axis, on_rows in ((a1, True), (a2, False)):
        for s2 in (0, 1):
            qc = blo[edge_axis] if s2 == 0 else bhi[edge_axis]
            edges.append(dev(u == qc) if on_rows else dev(v == qc))
    return _RowMasks(
        act=dev((u >= blo[a1]) & (u <= bhi[a1]) & (v >= blo[a2])
                & (v <= bhi[a2])),
        w_um=dev(np.broadcast_to(weights(u, blo[a1], bhi[a1], True),
                                 (rows, V))),
        w_up=dev(np.broadcast_to(weights(u, blo[a1], bhi[a1], False),
                                 (rows, V))),
        w_vm=dev(np.broadcast_to(weights(v, blo[a2], bhi[a2], True),
                                 (rows, V))),
        w_vp=dev(np.broadcast_to(weights(v, blo[a2], bhi[a2], False),
                                 (rows, V))),
        edges=tuple(edges))


def _plane_rows_update(spec, pi: int, masks: _RowMasks, pl_p, s_um, s_up,
                       in_p, prev_p, st_src, st_x, lines_yz, yz_col, fb, fa):
    """One plane's update on a block of rows.

    ``masks``: the rows' ``_row_masks`` (the reference passes the rows'
    global coordinate grids u, v and forms them each step);
    ``pl_p``/``in_p``/``prev_p``: (R, V) pressures; ``s_um``/``s_up``:
    (R, V) pre-shifted u-neighbour pressures (halo handling is the
    caller's); ``st_src``: (order, R, V) DF2T state; ``st_x``: (2, Y, Z)
    x-plane m₀ pair (zero off the owner shards); ``lines_yz``: the
    (4, 2, Vmax) y/z m₀ lines at the x ends (x planes only);
    ``yz_col(qi, pc) -> (R,)``: the opposite-type y/z plane's m₀ column at
    this plane's own coordinate.

    Same equations as ``box_fused.plane_boundary_step_stacked``
    (program.cpp:331-388 + canonical DF2T).  Returns ``(new_p, newst)``.
    """
    X, Y, Z = spec.dims
    a, side = PLANES[pi]
    a1, a2 = _other_axes(a)
    order = st_src.shape[0]
    blo = tuple(spec.ilo[x] - 1 for x in range(3))
    bhi = tuple(spec.ihi[x] + 1 for x in range(3))
    b0, a0 = fb[:, 0], fa[:, 0]
    Vq = {2: Z, 3: Z, 4: Y, 5: Y}
    pc = blo[a] if side == 0 else bhi[a]
    m0 = st_src[0]

    csw = COURANT_SQ * (2.0 * in_p
                        + masks.w_um * s_um + masks.w_up * s_up
                        + masks.w_vm * _shift_v(pl_p, -1)
                        + masks.w_vp * _shift_v(pl_p, +1))

    fw = m0 / b0[pi]
    cw = torch.zeros_like(m0) + a0[pi] / b0[pi]
    k = 0
    for edge_axis, on_rows in ((a1, True), (a2, False)):
        for s2 in (0, 1):
            qi = PLANES.index((edge_axis, s2))
            qa = _other_axes(edge_axis)
            if qi < 2:
                m0q = st_x[qi]
                raw = m0q[pc, :] if a == qa[0] else m0q[:, pc]
            elif a == 0:
                # x plane pi coupling to y/z plane qi: the m0 row at x = pc
                # lives on the owner shard
                raw = lines_yz[qi - 2, side, :Vq[qi]]
            else:
                # y/z ↔ y/z coupling: column over local u rows
                raw = yz_col(qi, pc)
            line = raw[None, :] if on_rows else raw[:, None]
            mask = masks.edges[k]
            k += 1
            fw = fw + mask * (line / b0[qi])
            cw = cw + mask * (a0[qi] / b0[qi])
    cw = COURANT * cw

    new_p = masks.act * (csw + COURANT_SQ * fw + (cw - 1.0) * prev_p) \
        / (1.0 + cw)
    delta = prev_p - new_p
    filt_in = -((a0[pi] * delta) / (b0[pi] * COURANT) + m0 / b0[pi])
    out = (filt_in * b0[pi] + m0) / a0[pi]

    slots = [(st_src[j + 1] if j + 1 < order
              else torch.zeros_like(filt_in))
             + fb[pi, j + 1] * filt_in - fa[pi, j + 1] * out
             for j in range(order)]
    return new_p, torch.stack(slots)


def plane_step_sharded(spec, off: int, xl: int,
                       pl_x, in_x, prev_x, st_x,
                       pl_yz, in_yz, prev_yz, st_yz,
                       halo_lo, halo_hi, lines_yz, fb, fa):
    """Sharded boundary-plane update of one shard.

    x planes (axes (y, z)) replicated: ``pl_x``/``in_x``/``prev_x``
    (2, Y, Z), ``st_x`` (order, 2, Y, Z).  y/z planes (u axis = grid x)
    row-sharded: ``pl_yz``/``in_yz``/``prev_yz`` (4, xl, Vmax), ``st_yz``
    (order, 4, xl, Vmax); ``halo_lo``/``halo_hi``: (4, 1, Vmax) neighbour
    rows of ``pl_yz`` for the in-plane u shift.

    The cross-plane coupling lines follow the sharded layout: x-plane m₀
    lines are replicated; y/z m₀ rows at the two x-end coordinates live on
    the x-end owner shards; y/z↔y/z column lines are row-local.
    Returns (pplus_x, newst_x, pplus_yz, newst_yz).
    """
    X, Y, Z = spec.dims
    Vmax = pl_yz.shape[-1]
    device, dtype = pl_yz.device, st_yz.dtype

    pplus_x, newst_x = [], []
    pplus_yz, newst_yz = [], []
    for pi in range(6):
        U, V = spec.plane_shape(pi)
        if pi < 2:
            pl_p, in_p, prev_p = pl_x[pi], in_x[pi], prev_x[pi]
            st_src = st_x[:, pi]
            masks = _row_masks(spec, pi, 0, U, V, device, dtype)
            s_um = _shift_rows_full(pl_p, -1)
            s_up = _shift_rows_full(pl_p, +1)
            yz_col = None
        else:
            q = pi - 2
            pl_p = pl_yz[q, :, :V]
            in_p = in_yz[q, :, :V]
            prev_p = prev_yz[q, :, :V]
            st_src = st_yz[:, q, :, :V]
            masks = _row_masks(spec, pi, off, xl, V, device, dtype)
            s_um = _shift_u(pl_p, halo_lo[q, :, :V], halo_hi[q, :, :V], -1)
            s_up = _shift_u(pl_p, halo_lo[q, :, :V], halo_hi[q, :, :V], +1)
            yz_col = lambda qi, pc: st_yz[0, qi - 2, :, pc]  # noqa: E731

        new_p, newst = _plane_rows_update(
            spec, pi, masks, pl_p, s_um, s_up, in_p, prev_p, st_src,
            st_x[0], lines_yz, yz_col, fb, fa)

        if pi < 2:
            pplus_x.append(new_p)
            newst_x.append(newst)
        else:
            pplus_yz.append(F.pad(new_p, (0, Vmax - V)))
            newst_yz.append(F.pad(newst, (0, Vmax - V)))
    return (torch.stack(pplus_x), torch.stack(newst_x, dim=1),
            torch.stack(pplus_yz), torch.stack(newst_yz, dim=1))


def overlap_supported(spec, xl: int) -> bool:
    """Static eligibility for the reference's overlapped (halo-hiding) step
    order, which the port does not run: (a) the x inner/boundary planes
    never straddle a shard boundary and (b) the x-plane splice/coupling
    rows are never shard-edge rows.  Standard alignment (ilo = 2, xl a
    multiple of 8) qualifies; padded grids whose ihi+1 lands exactly on a
    shard boundary do not.
    """
    ilo0, ihi0 = spec.ilo[0], spec.ihi[0]
    blo0, bhi0 = ilo0 - 1, ihi0 + 1
    if xl < 3:
        return False
    for coord in (ilo0, blo0):
        if coord % xl == 0 and coord >= xl:      # straddle / own row 0
            return False
    for coord in (ihi0, bhi0):
        if (coord + 1) % xl == 0:                # own row xl−1
            return False
        if coord % xl == 0 and coord >= xl:      # own row 0
            return False
    return True


@dataclasses.dataclass(frozen=True)
class _BoxShard:
    """What one shard of the box run holds for the whole run."""

    off: int
    geom: tuple
    source: object          # the ``_local_source``, or None
    fb: torch.Tensor        # (6, order+1) face coefficients on the device
    fa: torch.Tensor


def run_waveguide_box_sharded(device_mesh: DeviceMesh, structure, spec,
                              source, receiver, num_steps: int,
                              dtype=torch.float32, state_dtype=None) -> dict:
    """Sharded equivalent of ``run.run_waveguide_box(kernel_inject=False)``
    (same outputs contract): the source is injected into the field before
    each step, so the run differentiates with respect to everything.

    ``state_dtype``: the dtype of the shards' boundary-filter state (the x
    and y/z plane states), as ``run_waveguide_box``'s; the fields stay in
    ``dtype``.  None keeps the state in ``dtype``.

    ``device_mesh``: a ``DeviceMesh``; the grid's x axis divides over it
    (``spec.dims[0] % n == 0``: build the mesh with ``compute_mesh(…,
    align=(n, 1, 1))``).  On a mesh whose shards span processes, each
    process runs its own shards and gets the whole result.

    Returns {"outputs": stacked receiver outputs on the receiver's device,
    "stable": () bool tensor}.
    """
    from wayverb_tpu_torch.waveguide.run import _run_loop
    devices = device_mesh.devices
    n = len(devices)
    dims = tuple(spec.dims)
    X, Y, Z = dims
    if X % n:
        raise ValueError(f"grid x dim {X} not divisible by {n} shards")
    xl = X // n
    sdtype = state_dtype if state_dtype is not None else dtype
    order = structure.filter_order
    Vmax = max(Y, Z)
    grad = requires_grad(structure, source, receiver)
    comm = shard_comm(device_mesh, grad)
    structure = replicate_fields(comm, structure, ("coef_b", "coef_a"))
    source = replicate_fields(comm, source)
    face_b, face_a = face_coefficients(structure, spec)
    view = _ShardView(receiver, xl, dims, devices, comm)
    shards = [_BoxShard(off=s * xl, geom=spec.geom_array(x_offset=s * xl),
                        source=_local_source(source, s * xl, xl, dims,
                                             devices[s]),
                        fb=face_b.to(devices[s]), fa=face_a.to(devices[s]))
              for s in comm.local]

    def plane_updates(sh, cur, bstate, halos, ph_lo, ph_hi, t):
        pl_x, pl_yz, in_yz, prev_x, prev_yz, st_x, st_yz = bstate

        # x inner planes from the resident rows (post-injection): owned
        # row, or the neighbour's exchanged edge row when the inner plane is
        # the first row of the next shard
        def x_row(coord, halo, halo_cond):
            c = coord - sh.off
            if 0 <= c < xl:
                return cur[c]
            return halo[0] if halo_cond else torch.zeros_like(cur[0])

        in_x = torch.stack([
            x_row(spec.ilo[0], halos[1], spec.ilo[0] == sh.off + xl),
            x_row(spec.ihi[0], halos[0], spec.ihi[0] == sh.off - 1)])
        lines_yz = yz_line_contrib(spec, st_yz, sh.off, xl).to(dtype)
        in_yz_p = _patch_inner_yz(sh.source, in_yz, spec, dims, t)
        px_new, stx_new, pyz_new, styz_new = plane_step_sharded(
            spec, sh.off, xl, pl_x, in_x, prev_x, st_x,
            pl_yz, in_yz_p, prev_yz, st_yz, ph_lo, ph_hi, lines_yz,
            sh.fb, sh.fa)
        return (px_new.to(dtype), stx_new, pyz_new.to(dtype), styz_new)

    def body(carry, t: int):
        cur, prev, bstates, rstate, ok = carry
        cur = [_inject_local(sh.source, c, t, grad)
               for sh, c in zip(shards, cur)]
        rstate, outputs = receiver.tap(view(cur, t), rstate)
        field_halos, plane_halos = comm.halos(
            t, [(cur, 0), ([b[1] for b in bstates], 1)])
        nxt_all, b_all, ok_all = [], [], []
        for s, sh in enumerate(shards):
            halos = field_halos[s]
            ph_lo, ph_hi = plane_halos[s]
            px_new, stx_new, pyz_new, styz_new = plane_updates(
                sh, cur[s], bstates[s], halos, ph_lo, ph_hi, t)
            local_planes = (px_new[0], px_new[1],
                            pyz_new[0, :, :Z], pyz_new[1, :, :Z],
                            pyz_new[2, :, :Y], pyz_new[3, :, :Y])
            nxt, in6 = fused_step(sh.geom, cur[s], prev[s], local_planes,
                                  halos=halos)
            # next inner planes: y/z stay LOCAL (the x planes are read
            # straight from the resident field rows next step)
            in_yz_next = torch.stack([
                F.pad(in6[2], (0, Vmax - Z)), F.pad(in6[3], (0, Vmax - Z)),
                F.pad(in6[4], (0, Vmax - Y)), F.pad(in6[5], (0, Vmax - Y))])
            ok_all.append(ok[s] & torch.isfinite(torch.sum(px_new))
                          & torch.isfinite(torch.sum(pyz_new)))
            pl_x, pl_yz = bstates[s][0], bstates[s][1]
            b_all.append((px_new, pyz_new, in_yz_next, pl_x, pl_yz,
                          stx_new.to(sdtype), styz_new.to(sdtype)))
            nxt_all.append(nxt)
        return (nxt_all, cur, b_all, rstate, ok_all), outputs

    def zeros(dev, *shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    local_devices = [devices[s] for s in comm.local]
    init = ([zeros(d, xl, Y, Z) for d in local_devices],
            [zeros(d, xl, Y, Z) for d in local_devices],
            [(zeros(d, 2, Y, Z), zeros(d, 4, xl, Vmax), zeros(d, 4, xl, Vmax),
              zeros(d, 2, Y, Z), zeros(d, 4, xl, Vmax),
              zeros(d, order, 2, Y, Z, dt=sdtype),
              zeros(d, order, 4, xl, Vmax, dt=sdtype))
             for d in local_devices],
            receiver.init_state(dtype, view.device),
            [torch.ones((), dtype=torch.bool, device=d)
             for d in local_devices])
    carry, per_step = _run_loop(body, init, num_steps, 0, grad)
    # the per-step check covers the boundary planes only; one final
    # full-field reduction per shard catches a NaN born in the interior
    stable = torch.ones((), dtype=torch.bool, device=view.device)
    for field, ok in zip(carry[0], carry[4]):
        stable = stable & (ok & torch.all(torch.isfinite(field))).to(
            view.device)
    return {"outputs": _stack_outputs(per_step),
            "stable": comm.all_true(stable)}


def canonical_sharded(mesh, source_position, receiver_position,
                      simulation_time: float, device_mesh: DeviceMesh,
                      environment: Environment = Environment(),
                      dtype=torch.float32):
    """Sharded twin of ``run.canonical`` for a shoebox: calibrated impulse →
    directional receiver, on the fused solver split over ``device_mesh``."""
    from wayverb_tpu_torch.waveguide.run import (WaveguideOutput,
                                                 canonical_problem)
    if mesh.box_spec is None:
        raise ValueError("canonical_sharded requires a shoebox mesh "
                         "(box_spec); general meshes use "
                         "general_sharded.canonical_general_sharded")
    source, receiver, num_steps, fs = canonical_problem(
        mesh, source_position, receiver_position, simulation_time,
        environment)
    result = run_waveguide_box_sharded(device_mesh, mesh.structure,
                                       mesh.box_spec, source, receiver,
                                       num_steps, dtype)
    intensity, pressure = result["outputs"]
    return WaveguideOutput(pressure=pressure, intensity=intensity,
                           sample_rate=fs, stable=result["stable"])
