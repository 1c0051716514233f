"""The plain reference of the benchmark: a rectilinear FDTD waveguide with
frequency-dependent boundaries in a room made of axis-aligned boxes, written
from the update equations alone.

It takes what the harness hands both sides (the room's boxes, the wall
absorption, the mesh rate, the positions, the source signal, a target) and
works out again everything the program derives from them: the grid, which
nodes are inside, the boundary category and inner directions of each
boundary node, the wall filters (``filters.py``), the node indices of source
and receiver, the receiver's taps and its directional intensity.  It imports
nothing of the program.

Update (Courant number 1/sqrt(3)), per step: the hard source overwrites its
node with signal[t]; the receiver reads its node and six neighbours; then
 * inside and reentrant nodes: next = (sum of six neighbours) / 3 - prev;
 * a boundary node with d inner directions D (d = 1, 2, 3):
     csw = (sum over D of 2 p[inner] + sum over the other axes' ports) / 3,
     fw = (sum over D of m_s[0] / b0) / 3, cw = sqrt(1/3) sum over D of a0/b0,
     next = (csw + fw + (cw - 1) prev) / (1 + cw),
   and each inner slot's filter state takes one transposed direct-form II
   step with input -(a0 (prev - next) / (b0 sqrt(1/3)) + m_s[0] / b0);
 * every other node stays 0.
The directional receiver integrates the central pressure difference into a
velocity, v -= grad p / (rho fs), and reports intensity v p and pressure p.

All arithmetic is plain torch, on whatever device the caller's tensors are,
in the dtype asked for (float32 is the configuration's precision; bfloat16
is the control).  Gradients come from autograd with checkpointed segments.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference import filters

COURANT = 1.0 / math.sqrt(3.0)
COURANT_SQ = 1.0 / 3.0
OFFSETS = np.asarray([[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0],
                      [0, 0, -1], [0, 0, 1]], dtype=np.int64)
AXIS = np.asarray([0, 0, 1, 1, 2, 2])
DIAG2 = [(0, 2), (0, 3), (1, 2), (1, 3), (0, 4), (0, 5), (1, 4), (1, 5),
         (2, 4), (2, 5), (3, 4), (3, 5)]
DIAG3 = [(0, 2, 4), (0, 2, 5), (0, 3, 4), (0, 3, 5), (1, 2, 4), (1, 2, 5),
         (1, 3, 4), (1, 3, 5)]


def grid_spacing(speed_of_sound: float, sample_rate: float) -> float:
    return speed_of_sound * (1.0 / sample_rate) * math.sqrt(3.0)


def mesh_rate(speed_of_sound: float, spacing: float) -> float:
    return 1.0 / (spacing / (speed_of_sound * math.sqrt(3.0)))


@dataclasses.dataclass(frozen=True)
class Grid:
    min_corner: np.ndarray     # (3,) float64
    dims: tuple
    spacing: float

    def locator(self, position) -> np.ndarray:
        return np.round((np.asarray(position) - self.min_corner)
                        / self.spacing).astype(np.int64)

    def flat(self, loc) -> int:
        return int(np.ravel_multi_index(tuple(int(v) for v in loc),
                                        self.dims))

    def axis_positions(self, axis: int) -> np.ndarray:
        return self.min_corner[axis] + np.arange(self.dims[axis]) \
            * self.spacing


def make_grid(shell_lo, shell_hi, spacing: float) -> Grid:
    """The grid over the room's bounding box: its centre, taken in float32
    as scene coordinates are, lands on a node, and every side gets at least
    one node of margin beyond the walls."""
    lo = np.asarray(shell_lo, dtype=np.float64)
    hi = np.asarray(shell_hi, dtype=np.float64)
    anchor = (np.float32(0.5) * (hi.astype(np.float32) + lo.astype(
        np.float32))).astype(np.float64)
    new_lo = anchor - (np.ceil((anchor - lo) / spacing) + 1) * spacing
    new_hi = new_lo + (np.ceil((hi - new_lo) / spacing) + 1) * spacing
    dims = tuple(int(d) for d in
                 np.floor((new_hi - new_lo) / spacing * (1 + 1e-9)) + 1)
    return Grid(new_lo, dims, float(spacing))


def inside_mask(grid: Grid, shell, holes, device) -> torch.Tensor:
    """(X, Y, Z) bool: strictly inside the shell box and not inside any of
    the hole boxes (the columns).  A node within a millionth of a spacing
    of a hole's face has no clear side; such a room is refused."""
    axes = [grid.axis_positions(a) for a in range(3)]
    ins = [(p > shell[0][a]) & (p < shell[1][a])
           for a, p in enumerate(axes)]
    mask = torch.as_tensor(ins[0][:, None, None] & ins[1][None, :, None]
                           & ins[2][None, None, :], device=device)
    tol = 1e-6 * grid.spacing
    for lo, hi in holes:
        for a, p in enumerate(axes):
            if np.any(np.abs(p - lo[a]) < tol) or np.any(
                    np.abs(p - hi[a]) < tol):
                raise ValueError("a node lies on a column's face")
        inh = [torch.as_tensor((p > lo[a]) & (p < hi[a]), device=device)
               for a, p in enumerate(axes)]
        mask &= ~(inh[0][:, None, None] & inh[1][None, :, None]
                  & inh[2][None, None, :])
    return mask


def _shifted(mask: torch.Tensor, offset) -> torch.Tensor:
    """[i] = mask[i + offset], False beyond the grid."""
    out = torch.zeros_like(mask)
    src, dst = [slice(None)] * 3, [slice(None)] * 3
    for ax, o in enumerate(offset):
        n = mask.shape[ax]
        if o == 1:
            dst[ax], src[ax] = slice(0, n - 1), slice(1, n)
        elif o == -1:
            dst[ax], src[ax] = slice(1, n), slice(0, n - 1)
    out[tuple(dst)] = mask[tuple(src)]
    return out


@dataclasses.dataclass
class Structure:
    """What one step needs: the interior mask and, per boundary node, its
    flat index, its six neighbours' indices and weights (2 on an inner
    direction, 1 on a port of another axis, else 0) and which of its three
    filter slots are in use."""

    dims: tuple
    interior: torch.Tensor     # (X, Y, Z) float, 1 on inside and reentrant
    node: torch.Tensor         # (B,) int64
    neighbour: torch.Tensor    # (B, 6) int64
    weight: torch.Tensor       # (B, 6) float
    slot: torch.Tensor         # (B, 3) float, 1 where the slot is used


def build_structure(inside: torch.Tensor) -> Structure:
    """Boundary categories from the inside mask: an outside node with
    exactly one inside port is 1D, with more it is reentrant; with none, one
    inside diagonal pair makes it 2D, more reentrant; with none of those,
    one inside corner makes it 3D, more reentrant.  The first inside
    combination, in the port-pair and port-triple order above, gives the
    inner directions."""
    dev = inside.device
    dims = tuple(inside.shape)
    outside = ~inside
    ports = torch.stack([_shifted(inside, o) for o in OFFSETS], -1)
    n1 = ports.sum(-1)
    cat = torch.zeros(dims, dtype=torch.int8, device=dev)
    inner = torch.full(dims + (3,), -1, dtype=torch.int64, device=dev)
    cat[inside | (outside & (n1 > 1))] = 1
    d1 = outside & (n1 == 1)
    cat[d1] = 2
    inner[..., 0] = torch.where(d1, ports.to(torch.int8).argmax(-1),
                                inner[..., 0])
    del ports
    open2 = outside & (n1 == 0)
    pairs = torch.stack([_shifted(inside, OFFSETS[i] + OFFSETS[j])
                         for i, j in DIAG2], -1)
    n2 = pairs.sum(-1)
    d2 = open2 & (n2 == 1)
    cat[d2] = 3
    cat[open2 & (n2 > 1)] = 1
    first = pairs.to(torch.int8).argmax(-1)
    table = torch.as_tensor(DIAG2, device=dev)
    for s in range(2):
        inner[..., s] = torch.where(d2, table[first, s], inner[..., s])
    del pairs, first
    open3 = open2 & (n2 == 0)
    corners = torch.stack([_shifted(inside,
                                    OFFSETS[i] + OFFSETS[j] + OFFSETS[k])
                           for i, j, k in DIAG3], -1)
    n3 = corners.sum(-1)
    d3 = open3 & (n3 == 1)
    cat[d3] = 4
    cat[open3 & (n3 > 1)] = 1
    first = corners.to(torch.int8).argmax(-1)
    table = torch.as_tensor(DIAG3, device=dev)
    for s in range(3):
        inner[..., s] = torch.where(d3, table[first, s], inner[..., s])
    del corners, first

    boundary = cat >= 2
    loc = torch.nonzero(boundary)                                # (B, 3)
    dirs = inner[boundary]                                       # (B, 3)
    size = torch.as_tensor(dims, device=dev)
    stride = torch.as_tensor([dims[1] * dims[2], dims[2], 1], device=dev)
    nloc = loc[:, None, :] + torch.as_tensor(OFFSETS, device=dev)[None]
    valid = ((nloc >= 0) & (nloc < size)).all(-1)                # (B, 6)
    neighbour = torch.where(valid, (nloc * stride).sum(-1), 0)
    used = dirs >= 0
    axis = torch.as_tensor(AXIS, device=dev)
    is_inner = torch.zeros(loc.shape[0], 6, dtype=torch.bool, device=dev)
    axis_used = torch.zeros(loc.shape[0], 3, dtype=torch.bool, device=dev)
    for s in range(3):
        d = dirs[:, s].clamp(min=0)
        is_inner |= used[:, s:s + 1] & (torch.arange(6, device=dev) ==
                                        d[:, None])
        axis_used |= used[:, s:s + 1] & (torch.arange(3, device=dev) ==
                                         axis[d][:, None])
    other = ~is_inner & ~axis_used[:, axis]
    weight = (2.0 * is_inner + 1.0 * other) * valid
    return Structure(dims=dims, interior=(cat == 1).to(torch.float32),
                     node=(loc * stride).sum(-1), neighbour=neighbour,
                     weight=weight.to(torch.float32),
                     slot=used.to(torch.float32))


@dataclasses.dataclass
class Room:
    """A room as the harness describes it, and what the reference derives
    from it."""

    grid: Grid
    structure: Structure
    sample_rate: float
    coef_b: np.ndarray          # (1, order+1) float32
    coef_a: np.ndarray


def build_room(shell, holes, absorption, sample_rate: float,
               speed_of_sound: float, device) -> Room:
    """``shell``: (lo, hi) of the room's box; ``holes``: the (lo, hi) of
    each column; ``absorption``: the 8 band absorptions of the one material
    on every wall."""
    spacing = grid_spacing(speed_of_sound, sample_rate)
    grid = make_grid(shell[0], shell[1], spacing)
    structure = build_structure(inside_mask(grid, shell, holes, device))
    cb, ca = filters.coefficient_tables([absorption], sample_rate)
    return Room(grid, structure, mesh_rate(speed_of_sound, spacing), cb, ca)


def tap_nodes(room: Room, position) -> torch.Tensor:
    """The receiver's node and its six neighbours, as flat indices."""
    loc = room.grid.locator(position)
    return torch.as_tensor([room.grid.flat(loc)] + [
        room.grid.flat(loc + o) for o in OFFSETS])


def _step(cur, prev, mem, s: Structure, cb, ca, out=None):
    """One update: returns (next, next filter state)."""
    nxt = torch.zeros_like(cur) if out is None else out
    c = cur
    total = c[:-2, 1:-1, 1:-1] + c[2:, 1:-1, 1:-1]
    total = total + c[1:-1, :-2, 1:-1]
    total = total + c[1:-1, 2:, 1:-1]
    total = total + c[1:-1, 1:-1, :-2]
    total = total + c[1:-1, 1:-1, 2:]
    inner = (total / 3.0 - prev[1:-1, 1:-1, 1:-1]) \
        * s.interior[1:-1, 1:-1, 1:-1]
    nxt[1:-1, 1:-1, 1:-1] = inner

    flat_c, flat_p = cur.reshape(-1), prev.reshape(-1)
    csw = COURANT_SQ * (flat_c[s.neighbour] * s.weight).sum(-1)
    b0, a0 = cb[0], ca[0]
    m0 = mem[:, :, 0]                                   # (B, 3)
    fw = COURANT_SQ * (s.slot * (m0 / b0)).sum(-1)
    cw = COURANT * (s.slot * (a0 / b0)).sum(-1)
    p = flat_p[s.node]
    new_p = (csw + fw + (cw - 1.0) * p) / (1.0 + cw)
    filt_in = -((a0 * (p - new_p))[:, None] / (b0 * COURANT) + m0 / b0)
    filt_out = (filt_in * b0 + m0) / a0
    fi, fo = filt_in[..., None], filt_out[..., None]
    shifted = torch.cat([mem[..., 1:], torch.zeros_like(mem[..., :1])], -1)
    new_mem = (cb[1:] * fi - ca[1:] * fo + shifted) * s.slot[..., None]
    if out is None:
        nxt = nxt.reshape(-1).index_put((s.node,), new_p).reshape(cur.shape)
    else:
        nxt.reshape(-1)[s.node] = new_p
    return nxt, new_mem


def _segment(room, cur, prev, mem, cb, ca, sig, src, taps_idx, t0, t1,
             grad):
    """Steps t0 .. t1 - 1; returns (cur, prev, mem, taps (t1 - t0, 7))."""
    s = room.structure
    rows = []
    spare = None
    for t in range(t0, t1):
        flat = cur.reshape(-1)
        if grad:
            flat = flat.index_put((src,), sig[t - t0].reshape(1))
        else:
            flat[src] = sig[t - t0]
        cur = flat.reshape(cur.shape)
        rows.append(flat[taps_idx])
        if not grad and spare is None:
            spare = torch.zeros_like(cur)
        nxt, mem = _step(cur, prev, mem, s, cb, ca, out=spare)
        spare = None if grad else prev
        prev, cur = cur, nxt
    return cur, prev, mem, torch.stack(rows)


def run(room: Room, source_position, receiver_position, signal, num_steps,
        dtype=torch.float32, coef=None, segment: int = 0):
    """Taps (num_steps, 7) of the receiver's node and six neighbours, and
    whether the run stayed finite.  ``signal``: (num_steps,) on the run's
    device; ``coef``: (b, a) tables to use in place of the room's (for
    gradients); ``segment``: with a gradient, the steps each checkpointed
    segment recomputes in the backward."""
    dev = signal.device
    s = room.structure
    if coef is None:
        coef = (torch.as_tensor(room.coef_b, device=dev),
                torch.as_tensor(room.coef_a, device=dev))
    cb, ca = (c[0].to(dtype) for c in coef)
    s_dt = dataclasses.replace(s, interior=s.interior.to(dtype),
                               weight=s.weight.to(dtype),
                               slot=s.slot.to(dtype))
    room_dt = dataclasses.replace(room, structure=s_dt)
    src = torch.as_tensor([room.grid.flat(room.grid.locator(
        source_position))], device=dev)
    taps_idx = tap_nodes(room, receiver_position).to(dev)
    cur = torch.zeros(s.dims, dtype=dtype, device=dev)
    prev = torch.zeros_like(cur)
    mem = torch.zeros(s.node.shape[0], 3, filters.ORDER, dtype=dtype,
                      device=dev)
    sig = signal.to(dtype)
    grad = torch.is_grad_enabled() and (sig.requires_grad or
                                        cb.requires_grad or
                                        ca.requires_grad)
    blocks = []
    seg = segment if (grad and segment) else num_steps
    for t0 in range(0, num_steps, seg):
        t1 = min(t0 + seg, num_steps)
        args = (room_dt, cur, prev, mem, cb, ca, sig[t0:t1], src, taps_idx,
                t0, t1, grad)
        if grad and segment:
            from torch.utils.checkpoint import checkpoint
            cur, prev, mem, taps = checkpoint(_segment, *args,
                                              use_reentrant=False)
        else:
            cur, prev, mem, taps = _segment(*args)
        blocks.append(taps)
    taps = torch.cat(blocks)
    stable = bool(torch.isfinite(cur).all()) and bool(
        torch.isfinite(taps).all())
    return taps, stable


def directional(taps: np.ndarray, spacing: float, sample_rate: float,
                density: float):
    """(pressure (T,), intensity (T, 3)) of a directional receiver from its
    taps (T, 7): node, then the ports -x, +x, -y, +y, -z, +z.  float32, the
    velocity summed step by step."""
    taps = np.asarray(taps, dtype=np.float32)
    h = np.float32(spacing)
    k = np.float32(1.0 / (density * sample_rate))
    p = taps[:, 0]
    surrounding = (taps[:, 1:] - p[:, None]) / h
    gradient = np.float32(0.5) * (surrounding[:, 1::2] - surrounding[:, 0::2])
    velocity = np.cumsum(-(gradient * k), axis=0, dtype=np.float32)
    return p, velocity * p[:, None]
