"""Multi-step shoebox waveguide: the mega chunk path and its adjoint.

Port of ``wayverb_tpu.waveguide.box_mega``.  One call of
the chunk runner (``mega_chunk``) advances the shoebox field K leapfrog
sub-steps.  Each sub-step does the source injection, the receiver taps of
the post-injection field into row t of a (K, k) block, the injection
mirrored onto the carried inner planes, the six DF2T boundary-plane updates,
a non-finite count of each plane's sum, then the masked 7-point stencil with
the plane splices and the inner-plane extraction.  The chunk carries
``cur``, ``prev``, the filter state (order, 6, Umax, Vmax) and the planes
(3, 6, Umax, Vmax) = PL, INS, PRVP across calls, as the reference does.

``mega_chunk`` launches the hand-written CUDA kernel
(``csrc/box_mega_chunk.cu``) on CUDA tensors and runs its plain torch
version ``_mega_chunk_plain`` on CPU tensors.  The receiver's own arithmetic
replays over the tap block afterwards (``replay_taps``).

The TPU kernel keeps the field resident in VMEM; on the H100 the field of a
hall does not fit in L2, so the CUDA chunk streams it through device memory
each sub-step: one persistent cooperative launch a chunk, the plane pass and
a 2.5D stencil march per sub-step between grid barriers (see the kernel's
notes; ``chunk_occupancy`` reads its residency on the card).

Gradients.  The whole run is one ``torch.autograd.Function``
(``_MegaRun``) in (face_b, face_a, signal).  When one of them requires grad
its forward runs the chunks in grad mode (``mega_chunk(grad=True)``), which
also writes the residual block (K, 4, 6, Umax, Vmax) = PL, patched INS, PRVP
and the old first state slot per sub-step.  Its backward walks the chunks in
reverse with ``mega_chunk_bwd``, the adjoint leapfrog (CUDA:
``csrc/box_mega_chunk_bwd.cu``, one persistent cooperative launch a chunk
on two fields in place; plain: ``_mega_chunk_bwd_plain``), which
returns the field and state cotangents, the signal cotangent and the streams
of plane cotangents (ĝpplus, ĝst′).  The plane step is linear in pressures
and state, so the kernel transposes it at zero primals and needs no
residual; the coefficient gradients come from plain autograd of
⟨(ĝpplus, ĝst′), plane_step(residuals; θ)⟩ (``_chunk_theta_grads``).

Parity: reference ``src/waveguide/src/program.cpp:331-388`` boundary update
+ ``filters.cpp`` canonical DF2T ghost-point advance; oracle
``wayverb_tpu.waveguide.box_mega.run_waveguide_box_mega``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from wayverb_tpu_torch.waveguide.box_fused import (PLANES, BoxSpec,
                                                   _fused_step_plain,
                                                   _inside_mask,
                                                   _neighbor_sum, _other_axes,
                                                   face_coefficients,
                                                   requires_grad,
                                                   stack_planes,
                                                   stacked_plane_shape,
                                                   unstack_planes)
from wayverb_tpu_torch.waveguide.descriptor import COURANT, COURANT_SQ
from wayverb_tpu_torch.utils import events

DEFAULT_CHUNK = 128      # the reference's default K (swept on TPU only)


# ---------------------------------------------------------------------------
# boundary-plane step on natural-shape planes (plain torch)

def _shift2(arr, axis: int, delta: int):
    """arr[i] = arr_old[i + delta] along ``axis`` (0 = rows, 1 = columns) of
    a plane (..., U, V), zero fill."""
    axis -= 2
    n = arr.shape[axis]
    body = arr.narrow(axis, 0, n - 1) if delta == -1 \
        else arr.narrow(axis, 1, n - 1)
    pad = (0, 0, 1, 0) if axis == -2 else (1, 0)
    if delta == +1:
        pad = (0, 0, 0, 1) if axis == -2 else (0, 1)
    return F.pad(body, pad)


def plane_step_one(spec: BoxSpec, pi: int, pl_p, in_p, prev_p, m0_6, st_hi,
                   fb, fa):
    """ONE plane's boundary update on natural-shape tensors.

    ``pl_p``/``in_p``/``prev_p``: (U, V) pressures at plane ``pi``'s
    boundary / first-inside / previous-boundary planes; ``m0_6``: 6-tuple of
    every plane's first DF2T state slot (the edge coupling reads the
    neighbours'); ``st_hi``: plane ``pi``'s higher slots (order−1, U, V);
    ``fb``/``fa``: (6, order+1) per-face impedance filter coefficients.
    Every plane may carry leading batch dimensions, (..., U, V) and
    (order−1, ..., U, V).

    Returns ``(new_p, newst)`` with ``newst`` (order, ..., U, V), in the
    reference's order of operations.
    """
    order = st_hi.shape[0] + 1
    blo = tuple(spec.ilo[a] - 1 for a in range(3))
    bhi = tuple(spec.ihi[a] + 1 for a in range(3))
    b0 = [fb[p, 0] for p in range(6)]
    a0 = [fa[p, 0] for p in range(6)]

    a, side = PLANES[pi]
    a1, a2 = _other_axes(a)
    U, V = spec.plane_shape(pi)
    pc = blo[a] if side == 0 else bhi[a]
    m0 = m0_6[pi]
    dev, dt = pl_p.device, pl_p.dtype

    u = torch.arange(U, device=dev).view(U, 1)
    v = torch.arange(V, device=dev).view(1, V)
    act = ((u >= blo[a1]) & (u <= bhi[a1]) &
           (v >= blo[a2]) & (v <= bhi[a2])).to(dt)

    def weight(idx, lo_w, hi_w, lo, hi):
        return torch.where(idx == lo, lo_w, torch.where(idx == hi, hi_w, 1.0)
                           ).to(dt)

    w_um = weight(u, 0.0, 2.0, blo[a1], bhi[a1])
    w_up = weight(u, 2.0, 0.0, blo[a1], bhi[a1])
    w_vm = weight(v, 0.0, 2.0, blo[a2], bhi[a2])
    w_vp = weight(v, 2.0, 0.0, blo[a2], bhi[a2])

    csw = COURANT_SQ * (2.0 * in_p
                        + w_um * _shift2(pl_p, 0, -1)
                        + w_up * _shift2(pl_p, 0, +1)
                        + w_vm * _shift2(pl_p, 1, -1)
                        + w_vp * _shift2(pl_p, 1, +1))

    fw = m0 / b0[pi]
    cw = (a0[pi] / b0[pi]).expand(U, V)
    # edge/corner coupling: nodes on this plane's in-plane box edges also
    # belong to the neighbouring plane(s); the ghost closure sums each
    # member plane's filter contribution
    for edge_axis, on_rows in ((a1, True), (a2, False)):
        for s2 in (0, 1):
            q = PLANES.index((edge_axis, s2))
            qc = blo[edge_axis] if s2 == 0 else bhi[edge_axis]
            qa = _other_axes(edge_axis)
            line = (m0_6[q][..., pc:pc + 1, :] if a == qa[0]
                    else m0_6[q][..., :, pc:pc + 1])
            if on_rows:
                mask = (u == qc).to(dt)
                if line.shape[-2] != 1:
                    line = line.transpose(-1, -2)
            else:
                mask = (v == qc).to(dt)
                if line.shape[-1] != 1:
                    line = line.transpose(-1, -2)
            fw = fw + mask * (line / b0[q])
            cw = cw + mask * (a0[q] / b0[q])
    cw = COURANT * cw

    new_p = act * (csw + COURANT_SQ * fw + (cw - 1.0) * prev_p) \
        / (1.0 + cw)
    delta = prev_p - new_p
    filt_in = -((a0[pi] * delta) / (b0[pi] * COURANT) + m0 / b0[pi])
    out = (filt_in * b0[pi] + m0) / a0[pi]

    slots = []
    for j in range(order):
        nxt = st_hi[j] if j + 1 < order else torch.zeros_like(filt_in)
        slots.append(nxt + fb[pi, j + 1] * filt_in - fa[pi, j + 1] * out)
    return new_p, torch.stack(slots, dim=0)


def plane_step_natural(spec: BoxSpec, pl6, in6, prev6, st6, fb, fa):
    """The six boundary-plane updates on natural-shape tensors (see
    :func:`plane_step_one`).  ``st6``: 6-tuple of (order, U, V) states."""
    pplus, newst = [], []
    m0_6 = tuple(st6[p][0] for p in range(6))
    for pi in range(6):
        new_p, ns = plane_step_one(spec, pi, pl6[pi], in6[pi], prev6[pi],
                                   m0_6, st6[pi][1:], fb, fa)
        pplus.append(new_p)
        newst.append(ns)
    return tuple(pplus), tuple(newst)


# ---------------------------------------------------------------------------
# the chunk: plain version, CUDA kernel, wrapper

def _inner_plane_source(spec: BoxSpec, src):
    """[(plane, u, v)] of each carried inner plane the source lies on."""
    sx, sy, sz, mode = src
    out = []
    if mode == 0:
        return out
    xyz = (sx, sy, sz)
    for pi, (a, side) in enumerate(PLANES):
        if xyz[a] == (spec.ilo[a] if side == 0 else spec.ihi[a]):
            a1, a2 = _other_axes(a)
            out.append((pi, xyz[a1], xyz[a2]))
    return out


def _mega_chunk_plain(spec: BoxSpec, sig, face_b, face_a, cur, prev, st, pln,
                      src, tap_idx, grad: bool = False):
    """The plain torch version of one chunk; returns new tensors
    (cur, prev, st, pln, taps (K, k), bad (1,)), and with ``grad`` the
    residual block (K, 4, 6, Umax, Vmax) as a seventh.

    Per sub-step: ``plane_step_natural`` for the six planes, the fused
    step's plain stencil (``_fused_step_plain``) for the stencil, splices
    and extraction, and the taps and the non-finite counts.  The residuals
    of a sub-step are the plane step's inputs: PL, INS after the injection
    patch, PRVP and the old first state slot."""
    K = sig.shape[0]
    _, Y, Z = spec.dims
    geom = spec.geom_array()
    shp = [spec.plane_shape(p) for p in range(6)]
    sx, sy, sz, mode = src
    src_flat = (sx * Y + sy) * Z + sz
    ins_targets = _inner_plane_source(spec, src)
    A, B = cur.clone(), prev.clone()
    st = st.clone()
    PL, INS, PRVP = (pln[r].clone() for r in range(3))
    bad = torch.zeros(1, dtype=torch.float32, device=cur.device)
    rows, res = [], []
    for t in range(K):
        s_t = sig[t]
        flat = A.view(-1)
        if mode == 1:
            flat[src_flat] = s_t
        elif mode == 2:
            flat[src_flat] += s_t
        rows.append(flat[tap_idx])

        in6 = list(unstack_planes(INS, spec))
        for pi, u, v in ins_targets:
            in6[pi] = in6[pi].clone()
            in6[pi][u, v] = s_t if mode == 1 else in6[pi][u, v] + s_t
        if grad:
            res.append(torch.stack([PL, stack_planes(in6, spec), PRVP,
                                    st[0]]))
        st6 = tuple(st[:, p, :U, :V] for p, (U, V) in enumerate(shp))
        pplus, newst = plane_step_natural(
            spec, unstack_planes(PL, spec), tuple(in6),
            unstack_planes(PRVP, spec), st6, face_b, face_a)
        for p in range(6):
            bad += (~torch.isfinite(torch.sum(pplus[p]))).to(bad.dtype)
        st = stack_planes(tuple(s.permute(1, 2, 0) for s in newst),
                          spec).permute(3, 0, 1, 2).contiguous()
        PRVP, PL = PL, stack_planes(pplus, spec)
        B, inner = _fused_step_plain(geom, A, B, pplus)
        INS = stack_planes(inner, spec)
        A, B = B, A
    out = (A, B, st, torch.stack([PL, INS, PRVP]), torch.stack(rows), bad)
    return out + (torch.stack(res),) if grad else out


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from wayverb_tpu_torch._build import load
    lib = load("box_mega_chunk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wv_box_mega_chunk_f32.argtypes = [
        p, p, p, p, p, p, p, p, i, p, p, p, p, p, p, p, ctypes.c_longlong, i,
        p, ctypes.c_float, ctypes.c_float, p]
    lib.wv_box_mega_chunk_f32.restype = ctypes.c_int
    lib.wv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _occupancy(lib, entry: str, device) -> dict:
    """Registers, local bytes, CTAs an SM and the cooperative grid of a
    chunk kernel, from its C entry ``entry``."""
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device):
        err = fn(*(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.wv_cuda_error_string(err).decode())
    return dict(zip(("registers", "local_bytes", "ctas_per_sm", "grid"),
                    (x.value for x in out)))


def chunk_occupancy(device="cuda") -> dict:
    """What the card makes of the chunk kernel: registers a thread, local
    memory (spills) a thread in bytes, CTAs resident on one SM, and the
    cooperative grid (CTAs) one chunk launches."""
    return _occupancy(_kernel_lib(), "wv_box_mega_chunk_occupancy", device)


def _check(name, t, device, shape=None, dtype=torch.float32):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(
            f"mega_chunk: {name} must be a contiguous {dtype} tensor"
            f"{'' if shape is None else ' of shape ' + str(tuple(shape))} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _chunk_geometry(spec: BoxSpec, order: int, K: int):
    """The 13 ints both chunk kernels take: X, Y, Z, ilo/ihi per axis, Umax,
    Vmax, order, K."""
    Umax, Vmax = stacked_plane_shape(spec)
    return (ctypes.c_int * 13)(
        *spec.dims, spec.ilo[0], spec.ihi[0], spec.ilo[1], spec.ihi[1],
        spec.ilo[2], spec.ihi[2], Umax, Vmax, order, K)


def _mega_chunk_cuda(spec: BoxSpec, sig, face_b, face_a, cur, prev, st, pln,
                     src, tap_idx, grad):
    """Launch the chunk (csrc/box_mega_chunk.cu) on cur's stream, in place
    on cur, prev, st and pln; returns (cur, prev, st, pln, taps, bad) and,
    in grad mode, the residual block."""
    dev = cur.device
    K = sig.shape[0]
    order = st.shape[0]
    Umax, Vmax = stacked_plane_shape(spec)
    if K % 2 or K < 2:
        raise ValueError(f"mega_chunk: chunk length {K} must be even")
    _check("cur", cur, dev, spec.dims)
    _check("prev", prev, dev, spec.dims)
    _check("st", st, dev, (order, 6, Umax, Vmax))
    _check("pln", pln, dev, (3, 6, Umax, Vmax))
    _check("sig", sig, dev, (K,))
    _check("face_b", face_b, dev, (6, order + 1))
    _check("face_a", face_a, dev, (6, order + 1))
    _check("tap_idx", tap_idx, dev, dtype=torch.int64)
    if tap_idx.dim() != 1 or tap_idx.numel() < 1:
        raise ValueError("mega_chunk: tap_idx must be a non-empty 1-D index")
    k = tap_idx.numel()
    _, Y, Z = spec.dims
    sx, sy, sz, mode = src
    src_flat = (sx * Y + sy) * Z + sz if mode > 0 else -1
    ins_uv = [-1] * 12
    for pi, u, v in _inner_plane_source(spec, src):
        ins_uv[2 * pi], ins_uv[2 * pi + 1] = u, v

    new = lambda *s: torch.empty(s, dtype=torch.float32,  # noqa: E731
                                 device=dev)
    taps = new(K, k)
    bad = torch.zeros(1, dtype=torch.float32, device=dev)
    sums = torch.zeros(6, dtype=torch.float32, device=dev)
    st_spare = torch.empty_like(st)
    pln_spare = torch.zeros((6, Umax, Vmax), dtype=torch.float32, device=dev)
    res = new(K, 4, 6, Umax, Vmax) if grad else None
    lib = _kernel_lib()
    err = lib.wv_box_mega_chunk_f32(
        cur.data_ptr(), prev.data_ptr(), st.data_ptr(), st_spare.data_ptr(),
        pln.data_ptr(), pln_spare.data_ptr(), sig.data_ptr(),
        tap_idx.data_ptr(), k, taps.data_ptr(), bad.data_ptr(),
        sums.data_ptr(), res.data_ptr() if grad else None,
        face_b.data_ptr(), face_a.data_ptr(),
        _chunk_geometry(spec, order, K), src_flat, mode,
        (ctypes.c_int * 12)(*ins_uv), float(np.float32(COURANT)),
        float(np.float32(COURANT_SQ)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("box_mega_chunk launch failed: "
                           + lib.wv_cuda_error_string(err).decode())
    if grad:
        mega_chunk.grad_launches += 1
        return cur, prev, st, pln, taps, bad, res
    mega_chunk.launches += 1
    return cur, prev, st, pln, taps, bad


def mega_chunk(spec: BoxSpec, sig, face_b, face_a, cur, prev, st, pln, src,
               tap_idx, grad: bool = False):
    """Advance the shoebox field ``sig.shape[0]`` (even) sub-steps.

    ``sig``: (K,) source signal for the chunk; ``face_b``/``face_a``:
    (6, order+1) per-face filter coefficients; ``cur``/``prev``: (X, Y, Z)
    fields; ``st``: (order, 6, Umax, Vmax) filter state; ``pln``:
    (3, 6, Umax, Vmax) carried planes PL, INS, PRVP, zero in the padding;
    ``src``: host ints (x, y, z, mode) with mode 0 none / 1 hard / 2 soft;
    ``tap_idx``: (k,) int64 flat node indices, in the receiver's read order.

    Returns (cur, prev, st, pln, taps (K, k), bad (1,)), where ``bad``
    counts the (plane, sub-step) pairs whose plane sum was not finite.
    ``grad=True`` also returns the residual block (K, 4, 6, Umax, Vmax): per
    sub-step PL, INS after the injection patch, PRVP and the old first state
    slot, the plane step's inputs that ``_chunk_theta_grads`` needs; the
    other outputs are the same to the bit.

    CUDA tensors launch the kernel (counted in ``mega_chunk.launches``, or
    in ``mega_chunk.grad_launches`` in grad mode), updating cur, prev, st
    and pln in place, or raise; CPU tensors run the plain version
    ``_mega_chunk_plain``, which returns new tensors.  The call itself
    records no autograd graph: ``_MegaRun`` differentiates the run.
    """
    if cur.is_cuda:
        return _mega_chunk_cuda(spec, sig, face_b, face_a, cur, prev, st, pln,
                                src, tap_idx, grad)
    if cur.device.type != "cpu":
        raise ValueError(f"mega_chunk: no kernel for device {cur.device}")
    return _mega_chunk_plain(spec, sig, face_b, face_a, cur, prev, st, pln,
                             src, tap_idx, grad)


mega_chunk.launches = 0
mega_chunk.grad_launches = 0


# ---------------------------------------------------------------------------
# the chunk's adjoint: plain version, CUDA kernel, wrapper

def _plane_coord(spec: BoxSpec, pi: int, inner: bool = False) -> int:
    """Grid coordinate of boundary plane ``pi`` (or of its inner plane)."""
    a, side = PLANES[pi]
    if inner:
        return spec.ilo[a] if side == 0 else spec.ihi[a]
    return spec.ilo[a] - 1 if side == 0 else spec.ihi[a] + 1


def _mega_chunk_bwd_plain(spec: BoxSpec, face_b, face_a, gtaps, gnext, gcur,
                          gst, src, tap_idx):
    """The plain torch version of the chunk's adjoint (see
    :func:`mega_chunk_bwd`); returns new tensors.

    Tensor code for the stencil transpose, the extraction and the scatters;
    the transpose of the six plane updates is autograd's, taken once per
    call through ``plane_step_natural`` at zero primals (the plane step is
    linear in pressures and state, so its transpose does not depend on
    them) and replayed for each sub-step."""
    K = gtaps.shape[0]
    X, Y, Z = spec.dims
    dev, dt = gnext.device, gnext.dtype
    order = gst.shape[0]
    shp = [spec.plane_shape(p) for p in range(6)]
    sx, sy, sz, mode = src
    geom = spec.geom_array()
    ar = lambda n, shape: torch.arange(n, device=dev).view(shape)  # noqa
    inside = _inside_mask(ar(X, (X, 1, 1)), ar(Y, (1, Y, 1)),
                             ar(Z, (1, 1, Z)), geom)
    blo = [_plane_coord(spec, 2 * a) for a in range(3)]
    bhi = [_plane_coord(spec, 2 * a + 1) for a in range(3)]

    with torch.enable_grad():
        fb, fa = face_b.detach(), face_a.detach()
        zeros = lambda *lead: tuple(  # noqa: E731
            torch.zeros(lead + s, dtype=dt, device=dev, requires_grad=True)
            for s in shp)
        pl6, in6, prev6, st6 = zeros(), zeros(), zeros(), zeros(order)
        pplus, newst = plane_step_natural(spec, pl6, in6, prev6, st6, fb, fa)
    primals = (*pl6, *in6, *prev6, *st6)

    P, Q = gnext.clone(), gcur.clone()
    gst = gst.clone()
    gsig = torch.zeros(K, dtype=dt, device=dev)
    gp_stream, gstin_stream = [None] * K, [None] * K
    for t in range(K - 1, -1, -1):
        # 1. stencil transpose, and ĝpplus from the raw P̂ under the splice
        # precedence y < z < x
        MP = torch.where(inside, P, torch.zeros((), dtype=dt, device=dev))
        Q = Q + COURANT_SQ * _neighbor_sum(MP)
        gp6 = []
        for pi, (a, _) in enumerate(PLANES):
            sl = P.select(a, _plane_coord(spec, pi)).clone()
            if a > 0:                      # an x plane overwrites this one
                sl[blo[0]] = 0.0
                sl[bhi[0]] = 0.0
            if a == 1:                     # and a z plane a y plane
                sl[:, blo[2]] = 0.0
                sl[:, bhi[2]] = 0.0
            gp6.append(sl)
        gp_stream[t] = stack_planes(gp6, spec)
        gstin_stream[t] = gst
        # 2. the transpose of the six plane updates
        gst6 = tuple(gst[:, p, :U, :V] for p, (U, V) in enumerate(shp))
        grads = torch.autograd.grad((*pplus, *newst), primals,
                                    (*gp6, *gst6), retain_graph=True)
        gpl6, gin6, gprev6, gst6 = (grads[6 * i:6 * i + 6] for i in range(4))
        gst = stack_planes(tuple(s.permute(1, 2, 0) for s in gst6),
                           spec).permute(3, 0, 1, 2).contiguous()
        # 3. scatters: Q̂ += ĝpl, ĝin at the plane and inner coordinates;
        # P̂ ← −M ⊙ P̂ + ĝprev at the plane coordinates
        newP = -MP
        for pi, (a, _) in enumerate(PLANES):
            Q.select(a, _plane_coord(spec, pi)).add_(gpl6[pi])
            Q.select(a, _plane_coord(spec, pi, inner=True)).add_(gin6[pi])
            newP.select(a, _plane_coord(spec, pi)).add_(gprev6[pi])
        Q.view(-1).index_add_(0, tap_idx, gtaps[t])
        if mode > 0:
            gsig[t] = Q[sx, sy, sz]
            if mode == 1:
                Q[sx, sy, sz] = 0.0
        P, Q = Q, newP
    return (P, Q, gst, gsig, torch.stack(gp_stream),
            torch.stack(gstin_stream))


@functools.cache
def _bwd_kernel_lib() -> ctypes.CDLL:
    from wayverb_tpu_torch._build import load
    lib = load("box_mega_chunk_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wv_box_mega_chunk_bwd_f32.argtypes = [
        p, p, p, p, p, p, p, i, p, p, p, p, p, p, ctypes.c_longlong, i,
        ctypes.c_float, ctypes.c_float, p]
    lib.wv_box_mega_chunk_bwd_f32.restype = ctypes.c_int
    lib.wv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def chunk_bwd_occupancy(device="cuda") -> dict:
    """What the card makes of the adjoint chunk kernel (B7), as
    :func:`chunk_occupancy` reads the forward's."""
    return _occupancy(_bwd_kernel_lib(), "wv_box_mega_chunk_bwd_occupancy",
                      device)


def _mega_chunk_bwd_cuda(spec: BoxSpec, face_b, face_a, gtaps, gnext, gcur,
                         gst, src, tap_idx):
    """Launch the chunk's adjoint (csrc/box_mega_chunk_bwd.cu) on gnext's
    stream: one cooperative launch of K sub-steps on two fields in place.
    gnext, gcur and gst are consumed: the kernel works in their storage,
    the cotangent of the chunk's input ``cur`` comes back in gnext's and
    that of its input ``prev`` in a new field."""
    dev = gnext.device
    K, k = gtaps.shape
    order = gst.shape[0]
    Umax, Vmax = stacked_plane_shape(spec)
    if K % 2 or K < 2:
        raise ValueError(f"mega_chunk_bwd: chunk length {K} must be even")
    _check("gnext", gnext, dev, spec.dims)
    _check("gcur", gcur, dev, spec.dims)
    _check("gst", gst, dev, (order, 6, Umax, Vmax))
    _check("gtaps", gtaps, dev, (K, k))
    _check("face_b", face_b, dev, (6, order + 1))
    _check("face_a", face_a, dev, (6, order + 1))
    _check("tap_idx", tap_idx, dev, (k,), dtype=torch.int64)
    if gnext.data_ptr() == gcur.data_ptr():
        raise ValueError("mega_chunk_bwd: gnext and gcur must be separate "
                         "buffers")
    X, Y, Z = spec.dims
    sx, sy, sz, mode = src
    src_flat = (sx * Y + sy) * Z + sz if mode > 0 else -1
    new = lambda *s: torch.empty(s, dtype=torch.float32,  # noqa: E731
                                 device=dev)
    spare = new(*spec.dims)      # takes the cotangent of the input prev
    gsig = new(K)
    gp_stream = new(K, 6, Umax, Vmax)
    gstin_stream = new(K, order, 6, Umax, Vmax)
    # D, ĝprev twice (by sub-step parity), then one byte a (x, y) row
    scratch = new(3 * 6 * Umax * Vmax + -(-X * Y // 4))
    lib = _bwd_kernel_lib()
    err = lib.wv_box_mega_chunk_bwd_f32(
        gnext.data_ptr(), gcur.data_ptr(), spare.data_ptr(), gst.data_ptr(),
        scratch.data_ptr(), gtaps.data_ptr(), tap_idx.data_ptr(), k,
        gsig.data_ptr(), gp_stream.data_ptr(), gstin_stream.data_ptr(),
        face_b.data_ptr(), face_a.data_ptr(),
        _chunk_geometry(spec, order, K), src_flat, mode,
        float(np.float32(COURANT)), float(np.float32(COURANT_SQ)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("box_mega_chunk_bwd launch failed: "
                           + lib.wv_cuda_error_string(err).decode())
    mega_chunk_bwd.launches += 1
    return gnext, spare, gst, gsig, gp_stream, gstin_stream


def mega_chunk_bwd(spec: BoxSpec, face_b, face_a, gtaps, gnext, gcur, gst,
                   src, tap_idx):
    """The adjoint of one chunk of ``mega_chunk``: K reverse sub-steps of
    the adjoint leapfrog.

    ``gtaps``: (K, k) cotangent of the chunk's tap block; ``gnext``/
    ``gcur``: (X, Y, Z) cotangents of the chunk's returned ``cur`` and
    ``prev``; ``gst``: (order, 6, Umax, Vmax) cotangent of the returned
    filter state.  The carried planes are copies of field values, so their
    cotangents travel inside the field cotangents.  Carrying P̂ (cotangent
    of the newer field) and Q̂ (partial cotangent of the older), sub-step
    t = K−1 … 0 does

      Q̂ += λ² Σ₆ shift(M ⊙ P̂)              the stencil's transpose
      ĝpplus = P̂ at the plane coordinates, under the splice precedence
      (ĝpl, ĝin, ĝprev, ĝst) = the plane updates' transpose of (ĝpplus, ĝst′)
      Q̂ += ĝpl at the plane, ĝin at the inner coordinates;  Q̂[taps] += ĝtaps_t
      P̂ ← −M ⊙ P̂ + ĝprev at the plane coordinates
      ĝsig_t = Q̂[src];  a hard source zeroes Q̂[src];  swap(P̂, Q̂)

    Returns (gnext, gcur, gst, gsig (K,), gp_stream (K, 6, Umax, Vmax),
    gstin_stream (K, order, 6, Umax, Vmax)): the cotangents of the chunk's
    input ``cur``, ``prev`` and state, of its signal, and per sub-step (in
    forward time) ĝpplus and the ĝst′ that entered the plane transpose,
    which ``_chunk_theta_grads`` pairs with the residuals.

    CUDA tensors launch the kernel (counted in ``mega_chunk_bwd.launches``)
    and consume gnext, gcur and gst, or raise; CPU tensors run
    ``_mega_chunk_bwd_plain``, which returns new tensors.
    """
    if gnext.is_cuda:
        return _mega_chunk_bwd_cuda(spec, face_b, face_a, gtaps, gnext, gcur,
                                    gst, src, tap_idx)
    if gnext.device.type != "cpu":
        raise ValueError(f"mega_chunk_bwd: no kernel for device "
                         f"{gnext.device}")
    return _mega_chunk_bwd_plain(spec, face_b, face_a, gtaps, gnext, gcur,
                                 gst, src, tap_idx)


mega_chunk_bwd.launches = 0


def _chunk_theta_grads(spec: BoxSpec, face_b, face_a, res, gp_stream,
                       gstin_stream):
    """(ĝface_b, ĝface_a) of one chunk: the gradient of the inner product
    ⟨(ĝpplus, ĝst′), plane_step_natural(residuals; θ)⟩ with respect to θ,
    with the higher state slots zero (exact: gθ = ∂θ⟨ĝ, f(x₀, θ)⟩, and the
    plane step's outputs depend on the higher slots only by an addition).
    One autograd graph on (K, U, V) tensors covers the chunk's K sub-steps.
    """
    order = gstin_stream.shape[1]
    K = res.shape[0]
    shp = [spec.plane_shape(p) for p in range(6)]
    with torch.enable_grad():
        fb = face_b.detach().requires_grad_(True)
        fa = face_a.detach().requires_grad_(True)
        role = lambda r: tuple(res[:, r, p, :U, :V]  # noqa: E731
                               for p, (U, V) in enumerate(shp))
        st6 = tuple(torch.cat(
            [res[:, 3, p, :U, :V][None],
             res.new_zeros((order - 1, K, U, V))]) for p, (U, V) in
            enumerate(shp))
        pplus, newst = plane_step_natural(spec, role(0), role(1), role(2),
                                          st6, fb, fa)
        acc = res.new_zeros(())
        for p, (U, V) in enumerate(shp):
            acc = acc + torch.sum(gp_stream[:, p, :U, :V] * pplus[p])
            acc = acc + torch.sum(
                gstin_stream[:, :, p, :U, :V].transpose(0, 1) * newst[p])
        return torch.autograd.grad(acc, (fb, fa))


# ---------------------------------------------------------------------------
# eligibility

def mega_device_bytes(spec: BoxSpec, order: int, num_steps: int = 0,
                      grad: bool = False) -> int:
    """Device memory the chunk path holds: two fields, the filter state and
    its ping-pong twin, and four stacked plane buffers.  With ``grad``, also
    the residuals of every chunk of the run (they stay until the backward
    pass), the backward's spare field and state cotangent, and one chunk's
    cotangent streams and plane scratch."""
    X, Y, Z = spec.dims
    Umax, Vmax = stacked_plane_shape(spec)
    plane = 6 * Umax * Vmax
    total = 2 * X * Y * Z + (2 * order + 4) * plane
    if grad:
        chunk = DEFAULT_CHUNK
        nchunks = -(-num_steps // chunk)
        total += nchunks * chunk * 4 * plane          # residuals
        total += X * Y * Z + order * plane            # spare field, ĝst
        total += chunk * (1 + order) * plane          # streams
        total += 3 * plane + -(-X * Y // 4)           # scratch, row flags
    return 4 * total


def mega_supported(spec: Optional[BoxSpec], source, receiver, device,
                   filter_order: int = 6, num_steps: int = 0,
                   grad: bool = False) -> bool:
    """Mega-path eligibility on the H100: a CUDA device, a kernel-injectable
    point source, a receiver with tap nodes, and the chunk's device memory
    (``mega_device_bytes``, with the residuals and cotangent streams of a
    ``num_steps`` run when ``grad``) within the free memory
    ``torch.cuda.mem_get_info`` reports.  The chunk runs in float32 only;
    ``run.execute`` routes other dtypes away before asking.  The reference's
    tile alignment and VMEM budget are TPU rules and do not apply."""
    device = torch.device(device)
    if spec is None or device.type != "cuda":
        return False
    if not hasattr(source, "kernel_injection"):
        return False
    if not hasattr(receiver, "tap_nodes"):
        return False
    free, _ = torch.cuda.mem_get_info(device)
    return mega_device_bytes(spec, filter_order, num_steps, grad) <= free


# ---------------------------------------------------------------------------
# tap replay and the runner

def _stack_outputs(per_step):
    """Per-step receiver outputs (tensors or tuples of tensors) → stacked."""
    first = per_step[0]
    if isinstance(first, tuple):
        return tuple(torch.stack([o[k] for o in per_step])
                     for k in range(len(first)))
    return torch.stack(per_step)


class _SeqTapView:
    """Sequential flat-field stand-in for replaying ``receiver.tap`` over a
    (k,) row of kernel-extracted pressures.

    Receivers read the field with one or more ``field[idx]`` gathers whose
    index tensors, concatenated in read order, equal ``tap_nodes()``; each
    ``__getitem__`` hands out the next segment of the row.
    """

    def __init__(self, row):
        self._row = row
        self._pos = 0

    def __getitem__(self, idx):
        n = idx.numel()
        seg = self._row[self._pos:self._pos + n]
        self._pos += n
        return seg.reshape(idx.shape)


def replay_taps(receiver, taps):
    """Run the receiver's per-step arithmetic over the (T, k) tap series;
    returns the stacked per-step outputs (as ``run.run_waveguide_box``);
    one ``mega.replay_taps`` span."""
    with events.span("mega.replay_taps"):
        state = receiver.init_state(taps.dtype, taps.device)
        per_step = []
        for t in range(taps.shape[0]):
            state, out = receiver.tap(_SeqTapView(taps[t]), state)
            per_step.append(out)
        return _stack_outputs(per_step)


class _MegaRun(torch.autograd.Function):
    """(taps (T, k), stable) = the whole chunked run, differentiable in
    (face_b, face_a, sig) at chunk level.

    The forward runs plain chunks when no input requires grad (``grad``
    False) and grad-mode chunks otherwise, keeping each chunk's residuals.  The backward walks
    the chunks in reverse with ``mega_chunk_bwd``, sums the coefficient
    gradients of ``_chunk_theta_grads`` (skipped when neither coefficient
    table requires grad) and puts ĝsig back in time order.
    ``stable`` is not differentiable."""

    @staticmethod
    def forward(ctx, face_b, face_a, sig, spec, chunk, src, tap_idx, grad):
        dev = sig.device
        order = face_b.shape[1] - 1
        nchunks = sig.shape[0] // chunk
        Umax, Vmax = stacked_plane_shape(spec)
        zeros = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                       device=dev)
        cur, prev = zeros(*spec.dims), zeros(*spec.dims)
        st, pln = zeros(order, 6, Umax, Vmax), zeros(3, 6, Umax, Vmax)
        bad = zeros(1)
        blocks, residuals = [], []
        with events.span("mega.forward"):
            for c in range(nchunks):
                out = mega_chunk(spec, sig[c * chunk:(c + 1) * chunk],
                                 face_b, face_a, cur, prev, st, pln, src,
                                 tap_idx, grad=grad)
                cur, prev, st, pln, taps, b = out[:6]
                blocks.append(taps)
                residuals.extend(out[6:])
                bad = bad + b
        stable = (bad[0] == 0) & torch.all(torch.isfinite(cur))
        ctx.save_for_backward(face_b, face_a)
        ctx.residuals = residuals
        ctx.run = (spec, chunk, src, tap_idx)
        ctx.mark_non_differentiable(stable)
        return torch.cat(blocks), stable

    @staticmethod
    def backward(ctx, gtaps, _gstable):
        with events.span("mega.backward"):
            face_b, face_a = ctx.saved_tensors
            spec, chunk, src, tap_idx = ctx.run
            residuals = ctx.residuals
            if residuals is None:
                raise RuntimeError(
                    "mega run: backward a second time, but the chunk "
                    "residuals were already freed by the first; run the "
                    "forward again")
            ctx.residuals = None
            need_theta = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
            dev = gtaps.device
            order = face_b.shape[1] - 1
            Umax, Vmax = stacked_plane_shape(spec)
            zeros = lambda *s: torch.zeros(  # noqa: E731
                s, dtype=torch.float32, device=dev)
            gnext, gcur = zeros(*spec.dims), zeros(*spec.dims)
            gst = zeros(order, 6, Umax, Vmax)
            gfb = gfa = None
            if need_theta:
                gfb = torch.zeros_like(face_b)
                gfa = torch.zeros_like(face_a)
            gtaps = gtaps.to(torch.float32)
            gsig = [None] * len(residuals)
            for c in range(len(residuals) - 1, -1, -1):
                with events.span("mega.chunk_bwd"):
                    gnext, gcur, gst, gsig[c], gp_s, gstin_s = \
                        mega_chunk_bwd(
                            spec, face_b, face_a,
                            gtaps[c * chunk:(c + 1) * chunk].contiguous(),
                            gnext, gcur, gst, src, tap_idx)
                if need_theta:
                    with events.span("mega.theta_grads"):
                        gfb_c, gfa_c = _chunk_theta_grads(
                            spec, face_b, face_a, residuals[c], gp_s,
                            gstin_s)
                        gfb += gfb_c
                        gfa += gfa_c
                residuals[c] = None
            return gfb, gfa, torch.cat(gsig), None, None, None, None, None


def mega_canonical_loss_fn(structure, spec: BoxSpec, source, receiver,
                           num_steps: int, chunk: int = DEFAULT_CHUNK):
    """Differentiable (face_b, face_a, signal) → (taps, stable) closure on
    the mega path, for gradient-based workflows.

    Returns ``f(face_b, face_a, sig)``; the caller builds its loss on the
    (num_steps, k) tap block (for example by replaying a receiver over it)
    and differentiates straight through the chunk-level adjoint.  Trailing
    steps are padded with zero signal and their taps discarded.  Nothing is
    read back to the host: the source coordinates are host ints and the tap
    indices stay on the device.
    """
    src = tuple(int(v) for v in source.kernel_injection(spec.dims, 0)[0])
    tap_idx = receiver.tap_nodes().reshape(-1).to(torch.int64).contiguous()
    nchunks = -(-num_steps // chunk)

    def f(face_b, face_a, sig):
        sigp = F.pad(sig[:num_steps].to(torch.float32),
                     (0, nchunks * chunk - num_steps))
        taps, stable = _MegaRun.apply(
            face_b.to(torch.float32).contiguous(),
            face_a.to(torch.float32).contiguous(), sigp, spec, chunk, src,
            tap_idx, requires_grad(face_b, face_a, sig))
        return taps[:num_steps], stable

    return f


def run_waveguide_box_mega(structure, spec: BoxSpec, source, receiver,
                           num_steps: int, chunk: int = DEFAULT_CHUNK) -> dict:
    """Mega-path twin of ``run.run_waveguide_box`` (same outputs contract),
    in float32.

    ``chunk``: sub-steps per ``mega_chunk`` call (even).  Differentiable
    with respect to the structure's filter coefficients and the source
    signal (``mega_canonical_loss_fn``), and through the receiver's replay
    with respect to whatever the receiver's arithmetic depends on.
    """
    face_b, face_a = face_coefficients(structure, spec)
    core = mega_canonical_loss_fn(structure, spec, source, receiver,
                                  num_steps, chunk)
    taps, stable = core(face_b, face_a, source.signal)
    return {"outputs": replay_taps(receiver, taps), "stable": stable}
