"""Multi-step shoebox waveguide: the mega chunk path, forward only.

Port of the forward half of ``wayverb_tpu.waveguide.box_mega``.  One call of
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
each sub-step (two launches per sub-step, see the kernel's notes).  What it
saves over the fused path is the host's eager plane-step launches.

The grad-mode forward, the backward kernel and ``mega_canonical_loss_fn``
wait for the gradients slice.

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
                                                   _other_axes,
                                                   face_coefficients,
                                                   stack_planes,
                                                   stacked_plane_shape,
                                                   unstack_planes)
from wayverb_tpu_torch.waveguide.descriptor import COURANT, COURANT_SQ

DEFAULT_CHUNK = 128      # the reference's default K (swept on TPU only)


# ---------------------------------------------------------------------------
# boundary-plane step on natural-shape planes (plain torch)

def _shift2(arr, axis: int, delta: int):
    """arr[i] = arr_old[i + delta] along ``axis`` of a 2-D plane, zero fill."""
    n = arr.shape[axis]
    body = arr.narrow(axis, 0, n - 1) if delta == -1 \
        else arr.narrow(axis, 1, n - 1)
    pad = (0, 0, 1, 0) if axis == 0 else (1, 0)
    if delta == +1:
        pad = (0, 0, 0, 1) if axis == 0 else (0, 1)
    return F.pad(body, pad)


def plane_step_one(spec: BoxSpec, pi: int, pl_p, in_p, prev_p, m0_6, st_hi,
                   fb, fa):
    """ONE plane's boundary update on natural-shape tensors.

    ``pl_p``/``in_p``/``prev_p``: (U, V) pressures at plane ``pi``'s
    boundary / first-inside / previous-boundary planes; ``m0_6``: 6-tuple of
    every plane's first DF2T state slot (the edge coupling reads the
    neighbours'); ``st_hi``: plane ``pi``'s higher slots (order−1, U, V);
    ``fb``/``fa``: (6, order+1) per-face impedance filter coefficients.

    Returns ``(new_p, newst)`` with ``newst`` (order, U, V), in the
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
            line = (m0_6[q][pc:pc + 1, :] if a == qa[0]
                    else m0_6[q][:, pc:pc + 1])
            if on_rows:
                mask = (u == qc).to(dt)
                if line.shape[0] != 1:
                    line = line.T
            else:
                mask = (v == qc).to(dt)
                if line.shape[1] != 1:
                    line = line.T
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
                      src, tap_idx):
    """The plain torch version of one chunk; returns new tensors
    (cur, prev, st, pln, taps (K, k), bad (1,)).

    Per sub-step: ``plane_step_natural`` for the six planes, the fused
    step's plain stencil (``_fused_step_plain``) for the stencil, splices
    and extraction, and the taps and the non-finite counts."""
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
    rows = []
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
    return A, B, st, torch.stack([PL, INS, PRVP]), torch.stack(rows), bad


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from wayverb_tpu_torch._build import load
    lib = load("box_mega_chunk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wv_box_mega_chunk_f32.argtypes = [
        p, p, p, p, p, p, p, p, i, p, p, p, p, p, p, ctypes.c_longlong, i, p,
        ctypes.c_float, ctypes.c_float, p]
    lib.wv_box_mega_chunk_f32.restype = ctypes.c_int
    lib.wv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, device, shape=None, dtype=torch.float32):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(
            f"mega_chunk: {name} must be a contiguous {dtype} tensor"
            f"{'' if shape is None else ' of shape ' + str(tuple(shape))} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _mega_chunk_cuda(spec: BoxSpec, sig, face_b, face_a, cur, prev, st, pln,
                     src, tap_idx):
    """Launch the chunk (csrc/box_mega_chunk.cu) on cur's stream, in place
    on cur, prev, st and pln; returns (cur, prev, st, pln, taps, bad)."""
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
    X, Y, Z = spec.dims
    sx, sy, sz, mode = src
    src_flat = (sx * Y + sy) * Z + sz if mode > 0 else -1
    ins_uv = [-1] * 12
    for pi, u, v in _inner_plane_source(spec, src):
        ins_uv[2 * pi], ins_uv[2 * pi + 1] = u, v

    taps = torch.empty((K, k), dtype=torch.float32, device=dev)
    bad = torch.zeros(1, dtype=torch.float32, device=dev)
    sums = torch.zeros(6, dtype=torch.float32, device=dev)
    st_spare = torch.empty_like(st)
    pln_spare = torch.zeros((6, Umax, Vmax), dtype=torch.float32, device=dev)
    geom = (X, Y, Z, spec.ilo[0], spec.ihi[0], spec.ilo[1], spec.ihi[1],
            spec.ilo[2], spec.ihi[2], Umax, Vmax, order, K)
    lib = _kernel_lib()
    err = lib.wv_box_mega_chunk_f32(
        cur.data_ptr(), prev.data_ptr(), st.data_ptr(), st_spare.data_ptr(),
        pln.data_ptr(), pln_spare.data_ptr(), sig.data_ptr(),
        tap_idx.data_ptr(), k, taps.data_ptr(), bad.data_ptr(),
        sums.data_ptr(), face_b.data_ptr(), face_a.data_ptr(),
        (ctypes.c_int * 13)(*geom), src_flat, mode,
        (ctypes.c_int * 12)(*ins_uv), float(np.float32(COURANT)),
        float(np.float32(COURANT_SQ)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("box_mega_chunk launch failed: "
                           + lib.wv_cuda_error_string(err).decode())
    mega_chunk.launches += 1
    return cur, prev, st, pln, taps, bad


def mega_chunk(spec: BoxSpec, sig, face_b, face_a, cur, prev, st, pln, src,
               tap_idx):
    """Advance the shoebox field ``sig.shape[0]`` (even) sub-steps.

    ``sig``: (K,) source signal for the chunk; ``face_b``/``face_a``:
    (6, order+1) per-face filter coefficients; ``cur``/``prev``: (X, Y, Z)
    fields; ``st``: (order, 6, Umax, Vmax) filter state; ``pln``:
    (3, 6, Umax, Vmax) carried planes PL, INS, PRVP, zero in the padding;
    ``src``: host ints (x, y, z, mode) with mode 0 none / 1 hard / 2 soft;
    ``tap_idx``: (k,) int64 flat node indices, in the receiver's read order.

    Returns (cur, prev, st, pln, taps (K, k), bad (1,)), where ``bad``
    counts the (plane, sub-step) pairs whose plane sum was not finite.
    CUDA tensors launch the kernel (counted in ``mega_chunk.launches``),
    updating cur, prev, st and pln in place, or raise; CPU tensors run the
    plain version ``_mega_chunk_plain``, which returns new tensors.
    """
    if cur.is_cuda:
        return _mega_chunk_cuda(spec, sig, face_b, face_a, cur, prev, st, pln,
                                src, tap_idx)
    if cur.device.type != "cpu":
        raise ValueError(f"mega_chunk: no kernel for device {cur.device}")
    return _mega_chunk_plain(spec, sig, face_b, face_a, cur, prev, st, pln,
                             src, tap_idx)


mega_chunk.launches = 0


# ---------------------------------------------------------------------------
# eligibility

def mega_device_bytes(spec: BoxSpec, order: int) -> int:
    """Device memory the chunk path holds: two fields, the filter state and
    its ping-pong twin, and four stacked plane buffers."""
    X, Y, Z = spec.dims
    Umax, Vmax = stacked_plane_shape(spec)
    return 4 * (2 * X * Y * Z + (2 * order + 4) * 6 * Umax * Vmax)


def mega_supported(spec: Optional[BoxSpec], source, receiver, device,
                   filter_order: int = 6) -> bool:
    """Mega-path eligibility on the H100: a CUDA device, a kernel-injectable
    point source, a receiver with tap nodes, and the chunk's device memory
    (``mega_device_bytes``) within the free memory ``torch.cuda.mem_get_info``
    reports.  The chunk runs in float32 only; ``run.execute`` routes other
    dtypes away before asking.  The reference's tile alignment and VMEM
    budget are TPU rules and do not apply."""
    device = torch.device(device)
    if spec is None or device.type != "cuda":
        return False
    if not hasattr(source, "kernel_injection"):
        return False
    if not hasattr(receiver, "tap_nodes"):
        return False
    free, _ = torch.cuda.mem_get_info(device)
    return mega_device_bytes(spec, filter_order) <= free


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
    returns the stacked per-step outputs (as ``run.run_waveguide_box``)."""
    state = receiver.init_state(taps.dtype, taps.device)
    per_step = []
    for t in range(taps.shape[0]):
        state, out = receiver.tap(_SeqTapView(taps[t]), state)
        per_step.append(out)
    return _stack_outputs(per_step)


def run_waveguide_box_mega(structure, spec: BoxSpec, source, receiver,
                           num_steps: int, chunk: int = DEFAULT_CHUNK) -> dict:
    """Mega-path twin of ``run.run_waveguide_box`` (same outputs contract),
    in float32.

    ``chunk``: sub-steps per ``mega_chunk`` call (even).  Trailing steps are
    padded with zero signal and their taps discarded.  Nothing is read back
    to the host: the source coordinates are host ints and the tap indices
    stay on the device.
    """
    dims = spec.dims
    device = structure.coef_b.device
    order = structure.filter_order
    face_b, face_a = (c.to(torch.float32)
                      for c in face_coefficients(structure, spec))
    src = tuple(int(v) for v in source.kernel_injection(dims, 0)[0])
    nchunks = -(-num_steps // chunk)
    sig = torch.zeros(nchunks * chunk, dtype=torch.float32, device=device)
    sig[:num_steps] = source.signal[:num_steps].to(torch.float32)
    tap_idx = receiver.tap_nodes().reshape(-1).to(torch.int64).contiguous()

    Umax, Vmax = stacked_plane_shape(spec)
    cur = torch.zeros(dims, dtype=torch.float32, device=device)
    prev = torch.zeros_like(cur)
    st = torch.zeros((order, 6, Umax, Vmax), dtype=torch.float32,
                     device=device)
    pln = torch.zeros((3, 6, Umax, Vmax), dtype=torch.float32, device=device)
    bad = torch.zeros(1, dtype=torch.float32, device=device)
    blocks = []
    for c in range(nchunks):
        cur, prev, st, pln, taps, b = mega_chunk(
            spec, sig[c * chunk:(c + 1) * chunk], face_b, face_a, cur, prev,
            st, pln, src, tap_idx)
        blocks.append(taps)
        bad = bad + b
    taps = torch.cat(blocks)[:num_steps]
    outputs = replay_taps(receiver, taps)
    stable = (bad[0] == 0) & torch.all(torch.isfinite(cur))
    return {"outputs": outputs, "stable": stable}
