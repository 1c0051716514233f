"""Fused shoebox waveguide step: plane boundaries + one stencil kernel.

Port of ``wayverb_tpu.waveguide.box_fused``.  For a
shoebox every boundary node lies in one of six grid planes, so the boundary
work is a dense update of six (U, V) planes (``plane_boundary_step_stacked``,
plain torch), and the interior stencil, the splice of the six boundary planes
into the next field and the extraction of the six inner planes are one
kernel (``fused_step``): hand-written CUDA for Hopper
(``csrc/box_fused_step.cu``) on CUDA tensors, its plain torch version
``_fused_step_plain`` on CPU tensors.

The step is linear in (cur, prev, planes, halos).  When any of them requires
grad, ``fused_step`` goes through a ``torch.autograd.Function`` whose
backward is the hand-written adjoint ``fused_step_bwd``: CUDA
(``csrc/box_fused_step_bwd.cu``) on CUDA tensors, ``_fused_step_bwd_plain``
on CPU tensors.  The Function saves no field.

The time loop (``make_box_body``) is a Python loop that keeps everything on
the device: injection values are views of a device table, the stability
flag accumulates as a device tensor, and three field buffers rotate (next,
cur, prev) so that no field is allocated per step.  When a gradient is
required the loop allocates ``next`` afresh and injects out of place
instead: autograd must see every field it differentiates through.

Parity: reference ``src/waveguide/src/program.cpp:331-388`` boundary update
+ ``filters.cpp`` canonical DF2T ghost-point advance; oracle
``wayverb_tpu.waveguide.box_fused._jnp_forward``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wayverb_tpu_torch.waveguide.descriptor import COURANT, COURANT_SQ

# planes in port order: (axis, side) with side 0 = low wall, 1 = high wall.
# Plane index == face index in the (nx, px, ny, py, nz, pz) convention used
# by run.compute_mesh's face_surfaces.
PLANES: Tuple[Tuple[int, int], ...] = (
    (0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1))


def _other_axes(axis: int) -> Tuple[int, int]:
    return tuple(a for a in range(3) if a != axis)


@dataclasses.dataclass(frozen=True)
class BoxSpec:
    """Static shoebox mesh geometry (node-coordinate box bounds).

    ``ilo``/``ihi``: first/last INSIDE node per axis.  Boundary planes sit at
    ``ilo−1`` and ``ihi+1``, and at least one all-outside plane remains at
    each grid extreme (ilo ≥ 2, ihi ≤ dim−3).
    """

    dims: Tuple[int, int, int]
    ilo: Tuple[int, int, int]
    ihi: Tuple[int, int, int]
    face_surface: Tuple[int, int, int, int, int, int]

    def __post_init__(self):
        for a in range(3):
            if not (1 <= self.ilo[a] - 1 and
                    self.ihi[a] + 1 <= self.dims[a] - 2):
                raise ValueError(
                    f"axis {a}: boundary planes [{self.ilo[a]-1}, "
                    f"{self.ihi[a]+1}] must leave one outside plane at each "
                    f"grid end (dims {self.dims})")
            if self.ihi[a] - self.ilo[a] < 2:
                raise ValueError("box interior too thin for the plane path")

    def plane_shape(self, plane_idx: int) -> Tuple[int, int]:
        a1, a2 = _other_axes(PLANES[plane_idx][0])
        return (self.dims[a1], self.dims[a2])

    def geom_array(self, x_offset: int = 0) -> Tuple[int, ...]:
        """The step's geometry vector (x offset, y and z offsets = 0, then
        ilo/ihi per axis), as host ints: the kernel takes them by value."""
        return (x_offset, 0, 0,
                self.ilo[0], self.ihi[0], self.ilo[1], self.ihi[1],
                self.ilo[2], self.ihi[2])


def spec_from_inside(inside: np.ndarray, face_surfaces=None) -> BoxSpec:
    """Build a BoxSpec from a solid-box inside mask."""
    idx = np.argwhere(inside)
    lo = idx.min(axis=0)
    hi = idx.max(axis=0)
    if int(np.prod(hi - lo + 1)) != len(idx):
        raise ValueError("inside mask is not a solid box")
    if face_surfaces is None:
        face_surfaces = (0,) * 6
    return BoxSpec(dims=tuple(int(d) for d in inside.shape),
                   ilo=tuple(int(v) for v in lo),
                   ihi=tuple(int(v) for v in hi),
                   face_surface=tuple(int(s) for s in face_surfaces))


# ---------------------------------------------------------------------------
# boundary planes (plain torch)

def stacked_plane_shape(spec: BoxSpec) -> Tuple[int, int]:
    """Uniform (Umax, Vmax) every plane pads to for the stacked update."""
    shapes = [spec.plane_shape(p) for p in range(6)]
    return (max(s[0] for s in shapes), max(s[1] for s in shapes))


def stack_planes(planes6, spec: BoxSpec, dtype=None):
    """6-tuple of (U_p, V_p[, ...]) planes → one (6, Umax, Vmax[, ...])."""
    Umax, Vmax = stacked_plane_shape(spec)

    def pad(x, p):
        U, V = spec.plane_shape(p)
        if dtype is not None:
            x = x.to(dtype)
        trailing = (0, 0) * (x.dim() - 2)
        return F.pad(x, trailing + (0, Vmax - V, 0, Umax - U))

    return torch.stack([pad(planes6[p], p) for p in range(6)])


def unstack_planes(stack, spec: BoxSpec, dtype=None):
    """(6, Umax, Vmax[, ...]) → 6-tuple of true-shape planes (views)."""
    out = []
    for p in range(6):
        U, V = spec.plane_shape(p)
        x = stack[p, :U, :V]
        out.append(x.to(dtype) if dtype is not None else x)
    return tuple(out)


def _stacked_masks(spec: BoxSpec, Umax: int, Vmax: int):
    """Static per-plane masks for the stacked update.

    act: active-region mask; w_um/up/vm/vp: neighbour weights encoding the
    2×-ghost closure at in-plane box edges (program.cpp:331-388)."""
    blo = tuple(spec.ilo[a] - 1 for a in range(3))
    bhi = tuple(spec.ihi[a] + 1 for a in range(3))
    act = np.zeros((6, Umax, Vmax), np.float32)
    w = {k: np.zeros((6, Umax, Vmax), np.float32)
         for k in ("um", "up", "vm", "vp")}
    u = np.arange(Umax)[:, None]
    v = np.arange(Vmax)[None, :]
    for pi, (a, side) in enumerate(PLANES):
        a1, a2 = _other_axes(a)
        act[pi] = ((u >= blo[a1]) & (u <= bhi[a1]) &
                   (v >= blo[a2]) & (v <= bhi[a2]))
        w["um"][pi] = np.where(u == blo[a1], 0, np.where(u == bhi[a1], 2, 1))
        w["up"][pi] = np.where(u == blo[a1], 2, np.where(u == bhi[a1], 0, 1))
        w["vm"][pi] = np.where(v == blo[a2], 0, np.where(v == bhi[a2], 2, 1))
        w["vp"][pi] = np.where(v == blo[a2], 2, np.where(v == bhi[a2], 0, 1))
    return act, w


@dataclasses.dataclass(frozen=True)
class _PlaneTables:
    act: torch.Tensor                 # (6, Umax, Vmax)
    w: dict                           # um/up/vm/vp → (6, Umax, Vmax)
    # per plane, its four edge couplings (q, line_on_rows, addr, mask): the
    # neighbouring plane q, whether q's filter-state line at this plane's
    # coordinate is a row of q, whether it lands on a row or a column here,
    # and the one-hot (Umax, 1) row or (1, Vmax) column mask
    edges: tuple


@functools.lru_cache(maxsize=16)
def _plane_tables(spec: BoxSpec, Umax: int, Vmax: int, dtype,
                  device) -> _PlaneTables:
    """Device copies of the static plane masks, made once per geometry (the
    reference bakes them in as compile-time constants)."""
    blo = tuple(spec.ilo[a] - 1 for a in range(3))
    bhi = tuple(spec.ihi[a] + 1 for a in range(3))
    act_np, w_np = _stacked_masks(spec, Umax, Vmax)
    dev = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    edges = []
    for a, side in PLANES:
        a1, a2 = _other_axes(a)
        plane_edges = []
        for edge_axis, addr in ((a1, "row"), (a2, "col")):
            for s2 in (0, 1):
                q = PLANES.index((edge_axis, s2))
                qc = blo[edge_axis] if s2 == 0 else bhi[edge_axis]
                if addr == "row":
                    mask = dev((np.arange(Umax) == qc)[:, None])
                else:
                    mask = dev((np.arange(Vmax) == qc)[None, :])
                line_on_rows = a == _other_axes(edge_axis)[0]
                plane_edges.append((q, line_on_rows, addr, mask))
        edges.append(tuple(plane_edges))
    return _PlaneTables(act=dev(act_np),
                        w={k: dev(v) for k, v in w_np.items()},
                        edges=tuple(edges))


def _shift_s(arr, axis: int, delta: int):
    """Stacked shift on (6, U, V) with zero fill: result[i] = arr[i − 1]
    for delta = −1, arr[i + 1] for delta = +1 (axis ∈ {1, 2})."""
    n = arr.shape[axis]
    if axis == 1:
        return F.pad(arr[:, :n - 1], (0, 0, 1, 0)) if delta == -1 \
            else F.pad(arr[:, 1:], (0, 0, 0, 1))
    return F.pad(arr[:, :, :n - 1], (1, 0)) if delta == -1 \
        else F.pad(arr[:, :, 1:], (0, 1))


def _fit_line(raw, length: int):
    """Truncate or zero-pad a 1-D line to ``length``."""
    if raw.shape[0] == length:
        return raw
    raw = raw[:length]
    return F.pad(raw, (0, length - raw.shape[0]))


def plane_boundary_step_stacked(pl_s, in_s, prev_s, st_s, spec: BoxSpec,
                                face_b, face_a):
    """All six boundary-plane updates on stacked (6, Umax, Vmax) arrays.

    The reference's per-plane ghost-point math in one batched form: every
    elementwise op covers all six planes, the edge/corner coupling between
    planes is static one-hot masks times lines of the neighbouring planes'
    filter state, and the padded region stays zero.

    ``face_b``/``face_a``: (6, order+1) per-face impedance coefficients.
    Returns (pplus_s (6, Umax, Vmax), new_st_s (6, Umax, Vmax, order)), in
    the filter-state dtype of ``st_s``.
    """
    sdtype = st_s.dtype
    Umax, Vmax = pl_s.shape[1], pl_s.shape[2]
    blo = tuple(spec.ilo[a] - 1 for a in range(3))
    bhi = tuple(spec.ihi[a] + 1 for a in range(3))
    tabs = _plane_tables(spec, Umax, Vmax, sdtype, st_s.device)
    w = tabs.w

    pl_s = pl_s.to(sdtype)
    in_s = in_s.to(sdtype)
    prev_s = prev_s.to(sdtype)

    csw = COURANT_SQ * (2.0 * in_s
                        + w["um"] * _shift_s(pl_s, 1, -1)
                        + w["up"] * _shift_s(pl_s, 1, +1)
                        + w["vm"] * _shift_s(pl_s, 2, -1)
                        + w["vp"] * _shift_s(pl_s, 2, +1))

    b0 = face_b[:, 0].to(sdtype)           # (6,)
    a0 = face_a[:, 0].to(sdtype)
    m0 = st_s[..., 0]                      # (6, Umax, Vmax)

    fw_planes, cw_planes = [], []
    for pi, (a, side) in enumerate(PLANES):
        pc = blo[a] if side == 0 else bhi[a]
        fw_p = m0[pi] / b0[pi]
        cw_p = (a0[pi] / b0[pi]).expand(Umax, Vmax)
        for q, line_on_rows, addr, mask in tabs.edges[pi]:
            raw = m0[q, pc, :] if line_on_rows else m0[q, :, pc]
            if addr == "row":
                line_b = _fit_line(raw, Vmax)[None, :]
            else:
                line_b = _fit_line(raw, Umax)[:, None]
            fw_p = fw_p + mask * (line_b / b0[q])
            cw_p = cw_p + mask * (a0[q] / b0[q])
        fw_planes.append(fw_p)
        cw_planes.append(cw_p)
    fw = torch.stack(fw_planes)
    cw = COURANT * torch.stack(cw_planes)

    new_p = tabs.act * (csw + COURANT_SQ * fw + (cw - 1.0) * prev_s) \
        / (1.0 + cw)

    # ghost-point DF2T state advance (each plane advances its own slot)
    a0b = a0[:, None, None]
    b0b = b0[:, None, None]
    delta = prev_s - new_p
    filt_in = -((a0b * delta) / (b0b * COURANT) + m0 / b0b)
    out = (filt_in * b0b + m0) / a0b
    bq = face_b[:, 1:].to(sdtype)[:, None, None, :]
    aq = face_a[:, 1:].to(sdtype)[:, None, None, :]
    shifted = F.pad(st_s[..., 1:], (0, 1))
    new_st = shifted + bq * filt_in[..., None] - aq * out[..., None]
    return new_p, new_st


# ---------------------------------------------------------------------------
# fused stencil + splice + inner-plane extraction

NO_INJECT = ((0, 0, 0, 0), None)


def _plane_shapes(X, Y, Z):
    return ((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y))


def _neighbor_sum(field):
    """Σ of the six face neighbours, zero outside the grid (order x−, x+,
    y−, y+, z−, z+ as the reference's stencil sums them)."""
    total = torch.zeros_like(field)
    for axis in range(3):
        n = field.shape[axis]
        pad_lo = [0, 0] * 3
        pad_hi = [0, 0] * 3
        # F.pad lists the last axis first
        pad_lo[2 * (2 - axis)] = 1
        pad_hi[2 * (2 - axis) + 1] = 1
        total = total + F.pad(field.narrow(axis, 0, n - 1), pad_lo)
        total = total + F.pad(field.narrow(axis, 1, n - 1), pad_hi)
    return total


def _inside_mask(gx, gy, gz, geom):
    return ((gx >= geom[3]) & (gx <= geom[4]) &
            (gy >= geom[5]) & (gy <= geom[6]) &
            (gz >= geom[7]) & (gz <= geom[8]))


def _fused_step_plain(geom, cur, prev, planes, inj_idx=NO_INJECT[0],
                      inj_val=None, halos=None):
    """The plain torch version of the fused step: a transcription of the
    reference's ``_jnp_forward``.  Returns (next, inner_planes)."""
    X, Y, Z = cur.shape
    dev = cur.device
    gx = geom[0] + torch.arange(X, device=dev).view(X, 1, 1)
    gy = geom[1] + torch.arange(Y, device=dev).view(1, Y, 1)
    gz = geom[2] + torch.arange(Z, device=dev).view(1, 1, Z)
    sx, sy, sz, mode = inj_idx
    if mode > 0:
        oh = (gx == sx) & (gy == sy) & (gz == sz)
        v_now = inj_val[0].to(cur.dtype)
        v_prev = inj_val[1].to(cur.dtype)
        if mode == 1:
            cur = torch.where(oh, v_now, cur)
            prev = torch.where(oh, v_prev, prev)
        else:
            cur = torch.where(oh, cur + v_now, cur)
            prev = torch.where(oh, prev + v_prev, prev)
    ns = _neighbor_sum(cur)
    if halos is not None:
        ns[0] += halos[0][0]
        ns[-1] += halos[1][0]
    res = torch.where(_inside_mask(gx, gy, gz, geom),
                      COURANT_SQ * ns - prev, torch.zeros_like(ns))
    pxlo, pxhi, pylo, pyhi, pzlo, pzhi = planes
    res = torch.where(gy == geom[5] - 1, pylo[:, None, :], res)
    res = torch.where(gy == geom[6] + 1, pyhi[:, None, :], res)
    res = torch.where(gz == geom[7] - 1, pzlo[:, :, None], res)
    res = torch.where(gz == geom[8] + 1, pzhi[:, :, None], res)
    res = torch.where(gx == geom[3] - 1, pxlo[None, :, :], res)
    res = torch.where(gx == geom[4] + 1, pxhi[None, :, :], res)
    # inner-plane coords are global; the local index subtracts the offset
    # and clamps into the grid, as the reference's dynamic index does
    inner = tuple(
        res.select(a, _clamp(geom[3 + 2 * a + s_] - geom[a], res.shape[a]))
        .clone() for (a, s_) in PLANES)
    return res, inner


def _clamp(i: int, n: int) -> int:
    return min(max(i, 0), n - 1)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from wayverb_tpu_torch._build import load
    lib = load("box_fused_step")
    p = ctypes.c_void_p
    lib.wv_box_fused_step_f32.argtypes = [
        p, p, p, p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, p, p]
    lib.wv_box_fused_step_f32.restype = ctypes.c_int
    lib.wv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _occupancy(lib, entry: str, device, dims) -> dict:
    """``entry(dims, out)`` of ``lib`` on ``device``: registers a thread,
    local memory (spills) a thread in bytes, CTAs resident on one SM,
    threads a CTA, and the CTAs one launch takes on a field of ``dims``."""
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = fn((ctypes.c_int * 3)(*dims), out)
    if err != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.wv_cuda_error_string(err).decode())
    return dict(zip(("registers", "local_bytes", "ctas_per_sm", "threads",
                     "grid"), out))


def step_occupancy(device="cuda", dims=(224, 224, 256)) -> dict:
    """What the card makes of the step kernel B1 (``_occupancy``)."""
    return _occupancy(_kernel_lib(), "wv_box_fused_step_occupancy", device,
                      dims)


def _check_field(name, t, ref):
    if t.device != ref.device or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"fused_step: {name} must be a contiguous float32 "
                         f"tensor on {ref.device}, got {t.dtype} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")


def _fused_step_cuda(geom, cur, prev, planes, inj_idx, inj_val, halos, out):
    """Launch the CUDA kernel (csrc/box_fused_step.cu) on cur's stream."""
    X, Y, Z = cur.shape
    _check_field("cur", cur, cur)
    _check_field("prev", prev, cur)
    if prev.shape != cur.shape:
        raise ValueError(f"fused_step: prev {tuple(prev.shape)} != cur "
                         f"{tuple(cur.shape)}")
    if geom[1] != 0 or geom[2] != 0:
        raise ValueError("fused_step: y/z offsets must be zero")
    shapes = _plane_shapes(X, Y, Z)
    for p, (pl, shp) in enumerate(zip(planes, shapes)):
        if tuple(pl.shape) != shp or pl.device != cur.device \
                or pl.dtype != torch.float32 or pl.stride(1) != 1:
            raise ValueError(f"fused_step: plane {p} must be a float32 "
                             f"{shp} tensor on {cur.device} with unit "
                             f"column stride")
    if halos is not None:
        for h in halos:
            _check_field("halo", h, cur)
            if tuple(h.shape) != (1, Y, Z):
                raise ValueError("fused_step: halos must be (1, Y, Z)")
    nxt = torch.empty_like(cur) if out is None else out
    _check_field("out", nxt, cur)
    if nxt.shape != cur.shape:
        raise ValueError("fused_step: out must have cur's shape")
    sx, sy, sz, mode = inj_idx
    src = -1
    if mode > 0:
        _check_field("inj_val", inj_val, cur)
        lx = sx - geom[0]
        if 0 <= lx < X and 0 <= sy < Y and 0 <= sz < Z:
            src = (lx * Y + sy) * Z + sz
    inner = tuple(torch.empty(s, dtype=cur.dtype, device=cur.device)
                  for s in shapes)

    ptrs6 = ctypes.c_void_p * 6
    lib = _kernel_lib()
    err = lib.wv_box_fused_step_f32(
        cur.data_ptr(), prev.data_ptr(), nxt.data_ptr(),
        halos[0].data_ptr() if halos is not None else None,
        halos[1].data_ptr() if halos is not None else None,
        ptrs6(*[pl.data_ptr() for pl in planes]),
        (ctypes.c_longlong * 6)(*[pl.stride(0) for pl in planes]),
        ptrs6(*[t.data_ptr() for t in inner]),
        (ctypes.c_int * 10)(X, Y, Z, geom[0], *geom[3:9]),
        src, mode, inj_val.data_ptr() if src >= 0 else None,
        torch.cuda.current_stream(cur.device).cuda_stream)
    if err != 0:
        raise RuntimeError("box_fused_step launch failed: "
                           + lib.wv_cuda_error_string(err).decode())
    fused_step.launches += 1
    return nxt, inner


def _span(t):
    """[first, last) byte addresses of the elements of ``t``."""
    if t.numel() == 0:
        return (0, 0)
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return (t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size())


def _refuse_overlap(out, inputs):
    """Raise if ``out`` shares a byte with one of ``inputs``: the kernel
    writes ``next`` through a restrict pointer, while it still reads
    them."""
    lo, hi = _span(out)
    for t in inputs:
        if t is not None and t.device == out.device:
            a, b = _span(t)
            if a < hi and lo < b:
                raise ValueError("fused_step: out must not overlap cur, "
                                 "prev, a plane, a halo or inj_val")


def _fused_step_forward(geom, cur, prev, planes, inj_idx, inj_val, halos,
                        out):
    """The step without autograd: kernel on CUDA tensors, plain on CPU."""
    if out is not None:
        _refuse_overlap(out, (cur, prev, *planes, *(halos or ()), inj_val))
    if cur.is_cuda:
        return _fused_step_cuda(geom, cur, prev, planes, inj_idx, inj_val,
                                halos, out)
    if cur.device.type != "cpu":
        raise ValueError(f"fused_step: no kernel for device {cur.device}")
    res, inner = _fused_step_plain(geom, cur, prev, planes, inj_idx,
                                   inj_val, halos)
    if out is None:
        return res, inner
    return out.copy_(res), inner


def fused_step(geom, cur, prev, planes, inj_idx=NO_INJECT[0], inj_val=None,
               halos=None, out=None):
    """(next, inner_planes) = stencil + splice + inner-plane extraction.

    ``geom``: ``BoxSpec.geom_array(x_offset)`` (host ints; y/z offsets must
    be zero).  ``planes``: the six boundary-plane pressures in PLANES order,
    shapes (Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y).
    ``inj_idx`` = (x, y, z, mode) host ints with mode 0 none / 1 hard /
    2 soft and ``inj_val`` = (value_now, value_prev) as a (2,) tensor fold
    the point-source injection into the step.  ``halos``: optional (hlo,
    hhi) pair of (1, Y, Z) cur rows at local x = −1 / x = X (zeros when
    omitted).

    ``out``: optional preallocated buffer for ``next``.  Unlike the
    reference's pure arrays, the step then writes into it in place, so a
    time loop can rotate three field buffers and allocate no field per step.
    ``out`` must not overlap any input (cur, prev, a plane, a halo,
    ``inj_val``): a ``ValueError`` otherwise.

    CPU tensors run the plain version ``_fused_step_plain``; CUDA tensors
    launch the CUDA kernel (counted in ``fused_step.launches``) or raise.

    Linear in (cur, prev, planes, halos).  When grad mode is on and one of
    them, or ``inj_val``, requires grad, the step runs under a
    ``torch.autograd.Function`` whose backward is ``fused_step_bwd``
    (``out`` must then be None).  The backward gives the injection VALUES a
    zero gradient and zeroes the cur/prev cotangent at a hard-set node;
    differentiate through ``make_box_body(kernel_inject=False)`` for
    gradients with respect to the source signal.
    """
    diff = (cur, prev, *planes, *(halos or ()))
    if inj_val is not None:
        diff += (inj_val,)
    if torch.is_grad_enabled() and any(t.requires_grad for t in diff):
        if out is not None:
            raise ValueError("fused_step: out= cannot take the result when "
                             "a gradient is required")
        hlo, hhi = halos if halos is not None else (None, None)
        res = _FusedStep.apply(
            tuple(geom), tuple(int(v) for v in inj_idx), inj_val, cur, prev,
            hlo, hhi, *planes)
        return res[0], tuple(res[1:])
    return _fused_step_forward(geom, cur, prev, planes, inj_idx, inj_val,
                               halos, out)


fused_step.launches = 0


# ---------------------------------------------------------------------------
# the adjoint of the fused step

def _fused_step_bwd_plain(geom, g, ginner, inj_idx=NO_INJECT[0]):
    """The plain torch version of the step's adjoint: a transcription of
    the reference's ``_fused_bwd``.  Returns (gcur, gprev, gplanes6,
    (ghlo, ghhi))."""
    X, Y, Z = g.shape
    dev = g.device
    gx = geom[0] + torch.arange(X, device=dev).view(X, 1, 1)
    gy = geom[1] + torch.arange(Y, device=dev).view(1, Y, 1)
    gz = geom[2] + torch.arange(Z, device=dev).view(1, 1, Z)
    zero = torch.zeros((), dtype=g.dtype, device=dev)
    G = g
    G = G + torch.where(gx == geom[3], ginner[0][None, :, :], zero)
    G = G + torch.where(gx == geom[4], ginner[1][None, :, :], zero)
    G = G + torch.where(gy == geom[5], ginner[2][:, None, :], zero)
    G = G + torch.where(gy == geom[6], ginner[3][:, None, :], zero)
    G = G + torch.where(gz == geom[7], ginner[4][:, :, None], zero)
    G = G + torch.where(gz == geom[8], ginner[5][:, :, None], zero)
    # unmasked: the inner-plane extraction also covers nodes that lie on
    # boundary planes, e.g. (ilo_x, blo_y, z), so the cotangents of the
    # splice values include the inner contributions
    Gtot = G
    G = torch.where(_inside_mask(gx, gy, gz, geom), G, zero)
    gcur = COURANT_SQ * _neighbor_sum(G)
    gprev = -G
    ghalos = (COURANT_SQ * G[0:1], COURANT_SQ * G[-1:])

    blo = (geom[3] - 1, geom[5] - 1, geom[7] - 1)
    bhi = (geom[4] + 1, geom[6] + 1, geom[8] + 1)

    def plane_grad(axis, coord, kill):
        # a plane whose coordinate lies outside this shard gets a ZERO
        # cotangent; ``kill``: (slice axis, local coordinate) lines that a
        # later splice overwrites (precedence y < z < x)
        c = coord - geom[axis]
        shape = tuple(n for a, n in enumerate(Gtot.shape) if a != axis)
        if not 0 <= c < Gtot.shape[axis]:
            return torch.zeros(shape, dtype=g.dtype, device=dev)
        sl = Gtot.select(axis, c).clone()
        for k_axis, k_coord in kill:
            if 0 <= k_coord < shape[k_axis]:
                sl.select(k_axis, k_coord).zero_()
        return sl

    xlo_l, xhi_l = blo[0] - geom[0], bhi[0] - geom[0]
    y_kill = ((0, xlo_l), (0, xhi_l), (1, blo[2]), (1, bhi[2]))
    z_kill = ((0, xlo_l), (0, xhi_l))
    gplanes = (plane_grad(0, blo[0], ()), plane_grad(0, bhi[0], ()),
               plane_grad(1, blo[1], y_kill), plane_grad(1, bhi[1], y_kill),
               plane_grad(2, blo[2], z_kill), plane_grad(2, bhi[2], z_kill))
    # a hard-set injection overwrites cur/prev at the source node, so no
    # cotangent flows through the pre-injection values there
    sx, sy, sz, mode = inj_idx
    lx = sx - geom[0]
    if mode == 1 and 0 <= lx < X and 0 <= sy < Y and 0 <= sz < Z:
        gcur[lx, sy, sz] = 0.0
        gprev[lx, sy, sz] = 0.0
    return gcur, gprev, gplanes, ghalos


@functools.cache
def _bwd_kernel_lib() -> ctypes.CDLL:
    from wayverb_tpu_torch._build import load
    lib = load("box_fused_step_bwd")
    p = ctypes.c_void_p
    lib.wv_box_fused_step_bwd_f32.argtypes = [
        p, p, p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, p]
    lib.wv_box_fused_step_bwd_f32.restype = ctypes.c_int
    lib.wv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def step_bwd_occupancy(device="cuda", dims=(224, 224, 256)) -> dict:
    """What the card makes of the adjoint kernel B5 (``_occupancy``)."""
    return _occupancy(_bwd_kernel_lib(), "wv_box_fused_step_bwd_occupancy",
                      device, dims)


# x rows a thread of the adjoint kernel walks (kWalk of
# csrc/box_fused_step_bwd.cu)
BWD_WALK = 2


def _bwd_geometry(X, Y, Z):
    """Why the adjoint kernel's launch, CTAs of (y, z) nodes each walking
    ``BWD_WALK`` x rows on a grid of (⌈Y·Z/CTA⌉, ⌈X/BWD_WALK⌉) with 32-bit
    node indices, cannot cover a field of (X, Y, Z), or None."""
    if X * Y * Z == 0:
        return "is empty"
    if X * Y * Z >= 2 ** 31:
        return "has 2^31 nodes or more; the kernel's indices are 32-bit"
    if -(-X // BWD_WALK) > 65535:
        return "is outside what the kernel's launch geometry covers"
    return None


def _fused_step_bwd_cuda(geom, g, ginner, inj_idx):
    """Launch the adjoint kernel (csrc/box_fused_step_bwd.cu) on g's
    stream."""
    X, Y, Z = g.shape
    if g.dtype != torch.float32:
        raise ValueError(f"fused_step_bwd: g must be float32, got {g.dtype}")
    why = _bwd_geometry(X, Y, Z)
    if why is not None:
        raise ValueError(f"fused_step_bwd: a field of {(X, Y, Z)} {why}")
    if geom[1] != 0 or geom[2] != 0:
        raise ValueError("fused_step_bwd: y/z offsets must be zero")
    shapes = _plane_shapes(X, Y, Z)
    g = g.contiguous()
    ginner = tuple(t.contiguous() for t in ginner)
    for p, (t, shp) in enumerate(zip(ginner, shapes)):
        if tuple(t.shape) != shp or t.device != g.device \
                or t.dtype != torch.float32:
            raise ValueError(f"fused_step_bwd: inner-plane cotangent {p} "
                             f"must be a float32 {shp} tensor on {g.device}")
    new = lambda *s: torch.empty(s, dtype=g.dtype,  # noqa: E731
                                 device=g.device)
    gcur, gprev = new(X, Y, Z), new(X, Y, Z)
    gplanes = tuple(new(*s) for s in shapes)
    ghalos = (new(1, Y, Z), new(1, Y, Z))
    sx, sy, sz, mode = inj_idx
    lx = sx - geom[0]
    src = -1
    if mode == 1 and 0 <= lx < X and 0 <= sy < Y and 0 <= sz < Z:
        src = (lx * Y + sy) * Z + sz
    ptrs6 = ctypes.c_void_p * 6
    lib = _bwd_kernel_lib()
    err = lib.wv_box_fused_step_bwd_f32(
        g.data_ptr(), ptrs6(*[t.data_ptr() for t in ginner]),
        gcur.data_ptr(), gprev.data_ptr(),
        ptrs6(*[t.data_ptr() for t in gplanes]),
        ghalos[0].data_ptr(), ghalos[1].data_ptr(),
        (ctypes.c_int * 10)(X, Y, Z, geom[0], *geom[3:9]),
        src, mode, torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError("box_fused_step_bwd launch failed: "
                           + lib.wv_cuda_error_string(err).decode())
    fused_step_bwd.launches += 1
    return gcur, gprev, gplanes, ghalos


def fused_step_bwd(geom, g, ginner, inj_idx=NO_INJECT[0]):
    """The adjoint of ``fused_step`` in (cur, prev, planes, halos).

    ``g``: cotangent of ``next`` (X, Y, Z); ``ginner``: the six inner-plane
    cotangents (the shapes of ``planes``).  With G = g plus the inner-plane
    cotangents placed at the inner coordinates and M the inside mask:
    ĝcur = λ² Σ₆ shift(M ⊙ G), ĝprev = −M ⊙ G, the six boundary-plane
    cotangents are the unmasked G at the plane coordinates, zeroed where a
    later splice overwrites the plane (precedence y < z < x) and for an x
    plane that this shard does not own, and the halo cotangents are
    λ² M ⊙ G at the first and last local row.  ``inj_idx``: a hard-set
    (mode 1) source node gets zero ĝcur and ĝprev.

    Returns (gcur, gprev, gplanes6, (ghlo, ghhi)).  CPU tensors run
    ``_fused_step_bwd_plain``; CUDA tensors launch the CUDA kernel (counted
    in ``fused_step_bwd.launches``) or raise, as for a field of 2^31 nodes
    or more (``_bwd_geometry``).
    """
    if g.is_cuda:
        return _fused_step_bwd_cuda(geom, g, ginner, inj_idx)
    if g.device.type != "cpu":
        raise ValueError(f"fused_step_bwd: no kernel for device {g.device}")
    return _fused_step_bwd_plain(geom, g, ginner, inj_idx)


fused_step_bwd.launches = 0


class _FusedStep(torch.autograd.Function):
    """``fused_step`` with its hand-written adjoint.  Nothing is saved: the
    step is linear and its adjoint needs only the static geometry."""

    @staticmethod
    def forward(ctx, geom, inj_idx, inj_val, cur, prev, hlo, hhi, *planes):
        ctx.geom, ctx.inj_idx, ctx.has_halos = geom, inj_idx, hlo is not None
        ctx.inj_meta = ((inj_val.shape, inj_val.dtype, inj_val.device)
                        if ctx.needs_input_grad[2] else None)
        nxt, inner = _fused_step_forward(
            geom, cur, prev, planes, inj_idx, inj_val,
            (hlo, hhi) if hlo is not None else None, None)
        return (nxt, *inner)

    @staticmethod
    def backward(ctx, g, *ginner):
        gcur, gprev, gplanes, ghalos = fused_step_bwd(ctx.geom, g, ginner,
                                                      ctx.inj_idx)
        if not ctx.has_halos:
            ghalos = (None, None)
        # the injection values get a zero gradient, so a run in which only
        # the source signal requires grad still has a graph
        ginj = None
        if ctx.inj_meta is not None:
            shape, dtype, device = ctx.inj_meta
            ginj = torch.zeros(shape, dtype=dtype, device=device)
        return (None, None, ginj, gcur, gprev, *ghalos, *gplanes)


# ---------------------------------------------------------------------------
# time-loop machinery shared by run.run_waveguide_box

class _InjectedView:
    """Read-only view of the flat field with the pending in-kernel injection
    applied to every read.

    In kernel-inject mode the field the receiver taps is PRE-injection (the
    kernel applies the source while computing the next step), so receiver
    reads route through ``source.patch_tap`` to see post-injection values.
    """

    def __init__(self, field_flat, source, t):
        self._field = field_flat
        self._source = source
        self._t = t

    def __getitem__(self, idx):
        return self._source.patch_tap(idx, self._field[idx], self._t)


def initial_box_boundary(spec: BoxSpec, order: int, dtype, state_dtype,
                         device):
    """Boundary carry: (pl_s, in6, prev_pl_s, st_s).

    ``pl_s``: stacked (6, Umax, Vmax) field values at the six boundary
    planes (== last step's pplus); ``in6``: 6-tuple of field values at the
    inner planes (kernel-extracted, true shapes); ``prev_pl_s``: previous
    field's boundary-plane values (stacked); ``st_s``: stacked
    (6, Umax, Vmax, order) IIR ghost-point state in ``state_dtype``.
    """
    sdtype = state_dtype if state_dtype is not None else dtype
    Umax, Vmax = stacked_plane_shape(spec)
    zstack = torch.zeros((6, Umax, Vmax), dtype=dtype, device=device)
    in6 = tuple(torch.zeros(spec.plane_shape(p), dtype=dtype, device=device)
                for p in range(6))
    return (zstack, in6, zstack,
            torch.zeros((6, Umax, Vmax, order), dtype=sdtype, device=device))


def face_coefficients(structure, spec: BoxSpec):
    """(face_b, face_a): the (6, order+1) filter coefficients of the six
    walls, in PLANES order."""
    idx = torch.tensor(spec.face_surface, dtype=torch.long,
                       device=structure.coef_b.device)
    return structure.coef_b[idx], structure.coef_a[idx]


def requires_grad(*objs) -> bool:
    """True when grad mode is on and a tensor among ``objs`` requires grad.
    An object that is not a tensor is searched through its dataclass fields
    (sources, receivers and mesh structures are dataclasses of tensors)."""
    if not torch.is_grad_enabled():
        return False
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            if obj.requires_grad:
                return True
        elif dataclasses.is_dataclass(obj):
            if requires_grad(*(getattr(obj, f.name)
                               for f in dataclasses.fields(obj))):
                return True
    return False


def make_box_body(structure, spec: BoxSpec, source, receiver,
                  kernel_inject: bool = True):
    """One step of the fused box solver: (carry, t) → (carry, outputs).

    carry: (cur, prev, (pl_s, in6, prev_pl_s, st_s), rstate, ok, spare),
    where ``spare`` is the free field buffer the step writes ``next`` into;
    the step returns (next, cur, ..., prev) so three buffers rotate.

    When the filter coefficients, the source or the receiver require grad
    (and grad mode is on), nothing is written in place: ``next`` is a new
    tensor each step, the injection works on a copy of the field, and the
    carry's ``spare`` is None.

    ``kernel_inject``: point sources inject inside the fused step (the
    default; its adjoint treats the injected values as constants, so
    material gradients are exact and signal gradients stop at a hard
    source); False injects into the field before the step, which
    differentiates with respect to everything.
    """
    dims = spec.dims
    num_nodes = dims[0] * dims[1] * dims[2]
    face_b, face_a = face_coefficients(structure, spec)
    geom = spec.geom_array()
    use_kernel_inject = kernel_inject and hasattr(source, "kernel_injection")
    grad = requires_grad(face_b, face_a, source, receiver)

    def body(carry, t: int):
        current, previous, bcarry, rstate, ok, spare = carry
        pl_s, in6, prev_pl_s, st_s = bcarry
        fdtype = current.dtype

        if use_kernel_inject:
            inj_idx, inj_val = source.kernel_injection(dims, t)
            tap_field = _InjectedView(current.view(num_nodes), source, t)
        else:
            inj_idx, inj_val = NO_INJECT
            flat = current.reshape(num_nodes)
            tap_field = source.inject(flat.clone() if grad else flat, t)
            current = tap_field.view(dims)

        # mirror the injection onto the carried inner planes (a source at
        # an inner-layer node must be visible to the boundary update)
        in_s = source.patch_planes_stacked(
            stack_planes(in6, spec, dtype=fdtype), spec, dims, t)
        rstate, outputs = receiver.tap(tap_field, rstate)

        pplus_s, st_s = plane_boundary_step_stacked(
            pl_s, in_s, prev_pl_s, st_s, spec, face_b, face_a)
        pplus_s = pplus_s.to(fdtype)
        nxt, in6_next = fused_step(geom, current, previous,
                                   unstack_planes(pplus_s, spec), inj_idx,
                                   inj_val, out=None if grad else spare)
        # instability shows at the boundary planes first, so a plane-sum
        # check is the O(n²) per-step stand-in for the reference's per-node
        # error flag; run_waveguide_box adds one full-field check at the end
        ok = ok & torch.isfinite(torch.sum(pplus_s))
        return ((nxt, current, (pplus_s, in6_next, pl_s, st_s), rstate, ok,
                 None if grad else previous), outputs)

    return body


def initial_box_carry(structure, spec: BoxSpec, receiver, dtype=torch.float32,
                      state_dtype=None):
    device = structure.coef_b.device
    field = lambda: torch.zeros(spec.dims, dtype=dtype,  # noqa: E731
                                device=device)
    return (field(), field(),
            initial_box_boundary(spec, structure.filter_order, dtype,
                                 state_dtype, device),
            receiver.init_state(dtype, device),
            torch.ones((), dtype=torch.bool, device=device), field())
