"""Slow per-node reference implementation of the waveguide update.

Port of ``wayverb_tpu.waveguide.naive``, in numpy on the host as there.  A
direct, readable transcription of the update equations in
``reference src/waveguide/src/program.cpp`` (per-node switch over boundary
category, ghost-point IIR state update).  Used only by the parity tests to
validate the vectorized stencil, a third oracle beside the plain step and
the kernels — never on the hot path.  It keeps the reference's loop order.
"""

from __future__ import annotations

import numpy as np

from wayverb_tpu_torch.waveguide.descriptor import (COURANT, COURANT_SQ,
                                              DIRECTION_OFFSETS)

_AXIS = [0, 0, 1, 1, 2, 2]


def naive_step(cur, prev, fmem, category, inner, slot_coef, coef_b, coef_a):
    """One update on numpy arrays.

    cur/prev: (X,Y,Z); fmem: dict node-loc → (3, order) arrays;
    category/inner from setup.classify_boundaries; slot_coef: (X,Y,Z,3).
    Returns (next, fmem updated in place).
    """
    dims = cur.shape
    nxt = np.zeros_like(cur)

    def neighbor(loc, d):
        n = tuple(np.asarray(loc) + DIRECTION_OFFSETS[d])
        if any(i < 0 for i in n) or any(i >= s for i, s in zip(n, dims)):
            return None
        return n

    for loc in np.ndindex(dims):
        c = category[loc]
        if c == 0:
            continue
        if c == 1:
            total = 0.0
            for d in range(6):
                n = neighbor(loc, d)
                if n is not None:
                    total += cur[n]
            nxt[loc] = total / 3.0 - prev[loc]
            continue

        # boundary node of dimensionality c-1
        dims_count = c - 1
        inner_dirs = [int(inner[loc][i]) for i in range(dims_count)]
        inner_axes = {_AXIS[d] for d in inner_dirs}

        total = 0.0
        for d in inner_dirs:
            total += 2.0 * cur[neighbor(loc, d)]
        for d in range(6):
            if d not in inner_dirs and _AXIS[d] not in inner_axes:
                n = neighbor(loc, d)
                total += cur[n] if n is not None else 0.0
        csw = COURANT_SQ * total

        mem = fmem[loc]
        fw = 0.0
        cw = 0.0
        for s in range(dims_count):
            ci = slot_coef[loc][s]
            fw += mem[s][0] / coef_b[ci][0]
            cw += coef_a[ci][0] / coef_b[ci][0]
        fw *= COURANT_SQ
        cw *= COURANT

        p = prev[loc]
        new_p = (csw + fw + (cw - 1.0) * p) / (1.0 + cw)
        nxt[loc] = new_p

        for s in range(dims_count):
            ci = slot_coef[loc][s]
            b = coef_b[ci]
            a = coef_a[ci]
            m = mem[s]
            filt_in = -((a[0] * (p - new_p)) / (b[0] * COURANT) + m[0] / b[0])
            out = (filt_in * b[0] + m[0]) / a[0]
            order = len(m)
            new_m = np.zeros_like(m)
            for i in range(order - 1):
                new_m[i] = b[i + 1] * filt_in - a[i + 1] * out + m[i + 1]
            new_m[order - 1] = b[order] * filt_in - a[order] * out
            fmem[loc] = np.stack(
                [new_m if s2 == s else fmem[loc][s2] for s2 in range(3)])

    return nxt
