"""The dense stencil kernels of the general (arbitrary-geometry) mesh.

Port of ``wayverb_tpu.waveguide.stencil_pallas`` (the reference names the
module after its Pallas TPU kernels): the fused weighted step driven by the
packed per-node bitfield ``MeshStructure.weight_code``, its adjoint, the
masked interior step, and the weighted step of one x-shard of a decomposed
grid with its adjoint (``weighted_step_sharded``, ``parallel/``).

    weighted_step:  out[x] = λ²·Σ_d w_d(x)·cur[x+e_d] − bit12(x)·prev[x]
                    w_d(x) = bit(d) + bit(6+d) of weight_code[x] ∈ {0, 1, 2}
    interior_step:  out = (λ²·Σ₆ cur − prev)·mask

Direction order d = 0..5 ↔ (−x, +x, −y, +y, −z, +z), matching
``descriptor.DIRECTION_OFFSETS``; neighbours beyond the grid read as zero.
One dense pass of ``weighted_step`` yields the interior update and every
boundary node's weighted neighbour sum.

Each function has a hand-written CUDA kernel for Hopper and a plain torch
version beside it.  CUDA tensors launch the kernel
(``csrc/mesh_weighted_step.cu``, ``csrc/mesh_weighted_step_bwd.cu``,
``csrc/mesh_interior_step.cu``, ``csrc/mesh_weighted_step_haloed.cu``,
``csrc/mesh_weighted_step_haloed_bwd.cu``; float32, any dims) or raise; CPU
tensors run the plain version.  Launches are counted in
``weighted_step.launches``, ``weighted_step_bwd.launches``,
``interior_step.launches``, ``weighted_step_sharded.launches`` and
``weighted_step_sharded_bwd.launches``.

``weighted_step`` is linear in (cur, prev), ``weighted_step_sharded`` in
(cur, prev, halos).  When one of them requires grad the step goes through a
``torch.autograd.Function`` whose backward is the adjoint kernel for ``cur``
(and the halos) and the elementwise ``−bit12·g`` for ``prev``; it saves
nothing but the weight code.
"""

from __future__ import annotations

import ctypes

import torch

from wayverb_tpu_torch._build import load, load_entry
from wayverb_tpu_torch.waveguide.box_fused import _neighbor_sum
from wayverb_tpu_torch.waveguide.descriptor import (COURANT_SQ,
                                                    DIRECTION_OFFSETS)

_OPPOSITE = (1, 0, 3, 2, 5, 4)


def _weight(code, d: int, dtype):
    return (((code >> d) & 1) + ((code >> (6 + d)) & 1)).to(dtype)


def _is_interior(code, dtype):
    return ((code >> 12) & 1).to(dtype)


def _shifted(field, d: int):
    """field[x + e_d], zero where x + e_d lies beyond the grid."""
    off = DIRECTION_OFFSETS[d]
    axis = int(abs(off).argmax())
    n = field.shape[axis]
    out = torch.zeros_like(field)
    if off[axis] == 1:
        out.narrow(axis, 0, n - 1).copy_(field.narrow(axis, 1, n - 1))
    else:
        out.narrow(axis, 1, n - 1).copy_(field.narrow(axis, 0, n - 1))
    return out


def _weighted_step_plain(current, previous, weight_code):
    """The plain torch version of the weighted step: a transcription of the
    reference's ``weighted_step_jnp``."""
    acc = torch.zeros_like(current)
    for d in range(6):
        acc = acc + _weight(weight_code, d, current.dtype) \
            * _shifted(current, d)
    return COURANT_SQ * acc \
        - _is_interior(weight_code, current.dtype) * previous


def _weighted_step_bwd_plain(g, weight_code):
    """The plain torch version of the weighted step's adjoint in ``cur``:
    the transpose written out in the reference's ``_weighted_bwd`` (the
    product w_opp(dd)·g is formed at each site, then shifted)."""
    acc = torch.zeros_like(g)
    for dd in range(6):
        acc = acc + _shifted(
            _weight(weight_code, _OPPOSITE[dd], g.dtype) * g, dd)
    return COURANT_SQ * acc


def _prev_cotangent(g, weight_code):
    """ĝprev = −bit12·g: the adjoint of both weighted steps in ``prev``,
    elementwise plain tensor code, as in the TPU version."""
    return -_is_interior(weight_code, g.dtype) * g


def _interior_step_plain(current, previous, interior_mask):
    """The plain torch version of the masked 7-point update (includes
    reentrant nodes): the reference's ``stencil.interior_step``."""
    return (COURANT_SQ * _neighbor_sum(current) - previous) * interior_mask


# ---------------------------------------------------------------------------
# launching

def _check(what: str, name: str, t, ref, dtype=torch.float32):
    if t.device != ref.device or t.dtype != dtype or not t.is_contiguous() \
            or t.shape != ref.shape:
        raise ValueError(
            f"{what}: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(ref.shape)} on {ref.device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


# x rows a thread walks in the kernels on x-walks (kWalk of
# csrc/mesh_weighted_step_bwd.cu, csrc/mesh_weighted_step_haloed_bwd.cu and
# csrc/mesh_weighted_step_haloed.cu)
BWD_WALK = 8
SHARD_BWD_WALK = 4
SHARD_FWD_WALK = 2


def _stencil_geometry(X, Y, Z):
    """Why ``mesh_stencil.cuh``'s launch, CTAs of 128 z × 2 y of one x row
    on a grid of (⌈Z/128⌉, ⌈Y/2⌉, X), cannot cover the grid, or None."""
    if X > 65535 or (Y + 1) // 2 > 65535:
        return "is outside what the kernel's launch geometry covers"
    return None


def _adjoint_geometry(walk: int):
    """``geometry(X, Y, Z)``: why the x-walk's launch (``mesh_adjoint.cuh``'s
    ``adjoint_grid``, B9, B10 and B11), CTAs of (y, z) nodes each walking
    ``walk`` x rows on a grid of (⌈Y·Z/CTA⌉, ⌈X/walk⌉) with 32-bit node
    indices, cannot cover the grid, or None."""
    def geometry(X, Y, Z):
        if X * Y * Z >= 2 ** 31:
            return "has 2^31 nodes or more; the kernel's indices are 32-bit"
        if -(-X // walk) > 65535:
            return "is outside what the kernel's launch geometry covers"
        return None
    return geometry


def _launch(what: str, name: str, entry: str, tensors,
            geometry=_stencil_geometry):
    """Launch ``entry`` of ``csrc/<name>.cu`` on ``tensors`` (inputs, then
    outputs; the first is (X, Y, Z) and sets the grid), on the current
    stream of their device.  ``geometry(X, Y, Z)`` says why the kernel's
    launch cannot cover a grid (None when it can)."""
    ref = tensors[0]
    if ref.dim() != 3:
        raise ValueError(f"{what}: fields must be (X, Y, Z), got "
                         f"{tuple(ref.shape)}")
    X, Y, Z = ref.shape
    why = "is empty" if X * Y * Z == 0 else geometry(X, Y, Z)
    if why is not None:
        raise ValueError(f"{what}: grid {(X, Y, Z)} {why}")
    lib = load_entry(name, entry, len(tensors))
    err = getattr(lib, entry)(
        *(t.data_ptr() for t in tensors), X, Y, Z,
        torch.cuda.current_stream(ref.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.wv_cuda_error_string(err).decode())


def _out_buffer(what: str, out, current):
    """The output buffer: fresh, or the caller's ``out`` (never ``cur``)."""
    if out is None:
        return torch.empty_like(current)
    _check(what, "out", out, current)
    if out.data_ptr() == current.data_ptr():
        raise ValueError(f"{what}: out must not alias cur (six neighbours "
                         "of cur are read)")
    return out


def _weighted_step_forward(current, previous, weight_code, out):
    """The step without autograd: kernel on CUDA tensors, plain on CPU."""
    if current.is_cuda:
        what = "weighted_step"
        _check(what, "cur", current, current)
        _check(what, "prev", previous, current)
        _check(what, "weight_code", weight_code, current, torch.int32)
        res = _out_buffer(what, out, current)
        _launch(what, "mesh_weighted_step", "wv_mesh_weighted_step_f32",
                (current, previous, weight_code, res))
        weighted_step.launches += 1
        return res
    if current.device.type != "cpu":
        raise ValueError(f"weighted_step: no kernel for device "
                         f"{current.device}")
    res = _weighted_step_plain(current, previous, weight_code)
    return res if out is None else out.copy_(res)


def weighted_step(current, previous, weight_code, out=None):
    """Dense fused step: interior update + boundary weighted neighbour sums
    in one pass over (X, Y, Z) fields.

    ``out``: optional preallocated result buffer; it must not be ``current``
    and may be ``previous`` (each node reads only its own ``previous``), so
    a time loop can rotate two field buffers.  Unlike the reference's pure
    arrays the step then writes in place.

    CPU tensors run ``_weighted_step_plain``; CUDA tensors launch the kernel
    (counted in ``weighted_step.launches``) or raise.  When grad mode is on
    and ``current`` or ``previous`` requires grad, the step runs under a
    ``torch.autograd.Function`` (``out`` must then be None).
    """
    if torch.is_grad_enabled() and (current.requires_grad
                                    or previous.requires_grad):
        if out is not None:
            raise ValueError("weighted_step: out= cannot take the result "
                             "when a gradient is required")
        return _WeightedStep.apply(current, previous, weight_code)
    return _weighted_step_forward(current, previous, weight_code, out)


weighted_step.launches = 0


def weighted_step_bwd(g, weight_code):
    """ĝcur = λ²·Σ_dd w_opp(dd)(y+e_dd)·g[y+e_dd]: the transpose of
    ``weighted_step`` in ``cur``, reading the neighbour's weight code.

    CPU tensors run ``_weighted_step_bwd_plain``; CUDA tensors launch the
    kernel (counted in ``weighted_step_bwd.launches``) or raise.
    """
    if g.is_cuda:
        what = "weighted_step_bwd"
        g = g.contiguous()
        _check(what, "g", g, g)
        _check(what, "weight_code", weight_code, g, torch.int32)
        res = torch.empty_like(g)
        _launch(what, "mesh_weighted_step_bwd",
                "wv_mesh_weighted_step_bwd_f32", (g, weight_code, res),
                _adjoint_geometry(BWD_WALK))
        weighted_step_bwd.launches += 1
        return res
    if g.device.type != "cpu":
        raise ValueError(f"weighted_step_bwd: no kernel for device "
                         f"{g.device}")
    return _weighted_step_bwd_plain(g, weight_code)


weighted_step_bwd.launches = 0


class _WeightedStep(torch.autograd.Function):
    """``weighted_step`` with its hand-written adjoint.  The step is linear
    in (cur, prev), so only the weight code is kept for the backward."""

    @staticmethod
    def forward(ctx, current, previous, weight_code):
        ctx.save_for_backward(weight_code)
        return _weighted_step_forward(current, previous, weight_code, None)

    @staticmethod
    def backward(ctx, g):
        weight_code, = ctx.saved_tensors
        gcur = weighted_step_bwd(g, weight_code) \
            if ctx.needs_input_grad[0] else None
        gprev = _prev_cotangent(g, weight_code) \
            if ctx.needs_input_grad[1] else None
        return gcur, gprev, None


def interior_step(current, previous, interior_mask, out=None):
    """Masked 7-point update of (X, Y, Z) fields (interior and reentrant
    nodes; 0 elsewhere).

    ``out``: optional preallocated result buffer (not ``current``; it may be
    ``previous``).  CPU tensors run ``_interior_step_plain``, which plain
    autograd differentiates; CUDA tensors launch the kernel (counted in
    ``interior_step.launches``) or raise, and a CUDA tensor that requires
    grad raises: the TPU kernel this replaces has no adjoint either.
    """
    if current.is_cuda:
        what = "interior_step"
        if torch.is_grad_enabled() and (current.requires_grad
                                        or previous.requires_grad):
            raise ValueError("interior_step: the kernel has no adjoint; "
                             "differentiate through weighted_step")
        _check(what, "cur", current, current)
        _check(what, "prev", previous, current)
        _check(what, "interior_mask", interior_mask, current)
        res = _out_buffer(what, out, current)
        _launch(what, "mesh_interior_step", "wv_mesh_interior_step_f32",
                (current, previous, interior_mask, res))
        interior_step.launches += 1
        return res
    if current.device.type != "cpu":
        raise ValueError(f"interior_step: no kernel for device "
                         f"{current.device}")
    res = _interior_step_plain(current, previous, interior_mask)
    return res if out is None else out.copy_(res)


interior_step.launches = 0


# ---------------------------------------------------------------------------
# one x-shard of a decomposed grid: explicit x-halo rows

def _halo_shifted(field, d: int, halo):
    """field[x + e_d] for d ∈ {0, 1} (the x directions), with ``halo``, a
    (1, Y, Z) row, standing for the row beyond the shard."""
    if d == 0:
        return torch.cat([halo, field[:-1]])
    return torch.cat([field[1:], halo])


def _weighted_step_sharded_plain(current, previous, weight_code, halos):
    """The plain torch version of the shard step.  The halo rows enter the
    running sum as the d = 0 and d = 1 terms, in the order of
    ``_weighted_step_plain``, so with the neighbours' edge rows as halos the
    shards give the unsplit grid's step to the bit (the reference's
    ``_weighted_sharded_jnp`` adds the halo terms after the sum)."""
    acc = torch.zeros_like(current)
    for d in range(6):
        s = _halo_shifted(current, d, halos[d]) if d < 2 \
            else _shifted(current, d)
        acc = acc + _weight(weight_code, d, current.dtype) * s
    return COURANT_SQ * acc \
        - _is_interior(weight_code, current.dtype) * previous


def _weighted_step_sharded_bwd_plain(g, weight_code):
    """The plain torch version of the shard step's adjoint in (cur, halos):
    ĝcur is the unsplit adjoint on the shard (ḡ = 0 beyond it), and the halo
    rows feed only local row 0 through d = 0 and the last row through
    d = 1."""
    ghlo = COURANT_SQ * _weight(weight_code[:1], 0, g.dtype) * g[:1]
    ghhi = COURANT_SQ * _weight(weight_code[-1:], 1, g.dtype) * g[-1:]
    return _weighted_step_bwd_plain(g, weight_code), (ghlo, ghhi)


def _check_halos(what: str, halos, current):
    if len(halos) != 2:
        raise ValueError(f"{what}: halos must be a pair (hlo, hhi)")
    for name, h in zip(("hlo", "hhi"), halos):
        _check(what, name, h, current[:1])


def _weighted_step_sharded_forward(current, previous, weight_code, halos,
                                   out):
    """The shard step without autograd: kernel on CUDA tensors, plain on
    CPU."""
    if current.is_cuda:
        what = "weighted_step_sharded"
        _check(what, "cur", current, current)
        _check(what, "prev", previous, current)
        _check(what, "weight_code", weight_code, current, torch.int32)
        _check_halos(what, halos, current)
        res = _out_buffer(what, out, current)
        if any(res.data_ptr() == h.data_ptr() for h in halos):
            raise ValueError(f"{what}: out must not alias a halo row")
        _launch(what, "mesh_weighted_step_haloed",
                "wv_mesh_weighted_step_haloed_f32",
                (current, previous, weight_code, *halos, res),
                _adjoint_geometry(SHARD_FWD_WALK))
        weighted_step_sharded.launches += 1
        return res
    if current.device.type != "cpu":
        raise ValueError(f"weighted_step_sharded: no kernel for device "
                         f"{current.device}")
    res = _weighted_step_sharded_plain(current, previous, weight_code, halos)
    return res if out is None else out.copy_(res)


def weighted_step_sharded(current, previous, weight_code, halos, out=None):
    """``weighted_step`` on one x-shard (xl, Y, Z) of a decomposed grid.

    ``halos``: (hlo, hhi), the (1, Y, Z) ``current`` rows at local x = −1
    and x = xl from the neighbouring shards (zeros at the global grid
    ends, which reproduces ``weighted_step`` on the shard exactly).  ``out``
    as for ``weighted_step`` (not ``current`` nor a halo row; it may be
    ``previous``).

    CPU tensors run ``_weighted_step_sharded_plain``; CUDA tensors launch
    the kernel (counted in ``weighted_step_sharded.launches``) or raise.
    When grad mode is on and ``current``, ``previous`` or a halo requires
    grad, the step runs under a ``torch.autograd.Function`` whose backward
    gives the halo cotangents too (``out`` must then be None), so autograd
    routes them back through the exchange to the neighbours' edge rows.
    """
    hlo, hhi = halos
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (current, previous, hlo, hhi)):
        if out is not None:
            raise ValueError("weighted_step_sharded: out= cannot take the "
                             "result when a gradient is required")
        return _WeightedStepSharded.apply(current, previous, weight_code,
                                          hlo, hhi)
    return _weighted_step_sharded_forward(current, previous, weight_code,
                                          (hlo, hhi), out)


weighted_step_sharded.launches = 0


def weighted_step_sharded_bwd(g, weight_code):
    """(ĝcur, (ĝhlo, ĝhhi)): the transpose of ``weighted_step_sharded`` in
    (cur, halos).  ĝcur = λ²·Σ_dd w_opp(dd)(y+e_dd)·g[y+e_dd] with g = 0
    beyond the shard; ĝhlo = λ²·w₀(row 0)·g[0], ĝhhi = λ²·w₁(row xl−1)·
    g[xl−1].

    CPU tensors run ``_weighted_step_sharded_bwd_plain``; CUDA tensors
    launch the kernel (counted in ``weighted_step_sharded_bwd.launches``)
    or raise.
    """
    if g.is_cuda:
        what = "weighted_step_sharded_bwd"
        g = g.contiguous()
        _check(what, "g", g, g)
        _check(what, "weight_code", weight_code, g, torch.int32)
        gcur = torch.empty_like(g)
        ghlo, ghhi = torch.empty_like(g[:1]), torch.empty_like(g[:1])
        _launch(what, "mesh_weighted_step_haloed_bwd",
                "wv_mesh_weighted_step_haloed_bwd_f32",
                (g, weight_code, gcur, ghlo, ghhi),
                _adjoint_geometry(SHARD_BWD_WALK))
        weighted_step_sharded_bwd.launches += 1
        return gcur, (ghlo, ghhi)
    if g.device.type != "cpu":
        raise ValueError(f"weighted_step_sharded_bwd: no kernel for device "
                         f"{g.device}")
    return _weighted_step_sharded_bwd_plain(g, weight_code)


weighted_step_sharded_bwd.launches = 0


def _occupancy(name: str, device, dims) -> dict:
    """What the card makes of the kernel of ``csrc/<name>.cu`` (its entry
    ``wv_<name>_occupancy``): registers a thread, local memory (spills) a
    thread in bytes, CTAs resident on one SM, threads a CTA, and the CTAs
    one launch runs on a grid of ``dims``."""
    lib = load(name)
    fn = getattr(lib, f"wv_{name}_occupancy")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    lib.wv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wv_cuda_error_string.restype = ctypes.c_char_p
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = fn((ctypes.c_int * 3)(*dims), out)
    if err != 0:
        raise RuntimeError(f"wv_{name}_occupancy failed: "
                           + lib.wv_cuda_error_string(err).decode())
    return dict(zip(("registers", "local_bytes", "ctas_per_sm", "threads",
                     "grid"), out))


def bwd_occupancy(device="cuda", dims=(343, 139, 259)) -> dict:
    """``_occupancy`` of the adjoint's kernel (B9) on a grid of ``dims``
    (default: the columns hall's)."""
    return _occupancy("mesh_weighted_step_bwd", device, dims)


def shard_fwd_occupancy(device="cuda", dims=(86, 139, 259)) -> dict:
    """``_occupancy`` of the shard step's kernel (B10) on a shard of
    ``dims`` (default: the columns hall's shard)."""
    return _occupancy("mesh_weighted_step_haloed", device, dims)


def shard_bwd_occupancy(device="cuda", dims=(86, 139, 259)) -> dict:
    """``_occupancy`` of the shard adjoint's kernel (B11) on a shard of
    ``dims`` (default: the columns hall's shard)."""
    return _occupancy("mesh_weighted_step_haloed_bwd", device, dims)


class _WeightedStepSharded(torch.autograd.Function):
    """``weighted_step_sharded`` with its hand-written adjoint.  Linear in
    (cur, prev, hlo, hhi), so only the weight code is kept."""

    @staticmethod
    def forward(ctx, current, previous, weight_code, hlo, hhi):
        ctx.save_for_backward(weight_code)
        return _weighted_step_sharded_forward(current, previous, weight_code,
                                              (hlo, hhi), None)

    @staticmethod
    def backward(ctx, g):
        weight_code, = ctx.saved_tensors
        need = ctx.needs_input_grad
        gcur = ghlo = ghhi = None
        if need[0] or need[3] or need[4]:
            gcur, (ghlo, ghhi) = weighted_step_sharded_bwd(g, weight_code)
        gprev = _prev_cotangent(g, weight_code) if need[1] else None
        return (gcur if need[0] else None, gprev, None,
                ghlo if need[3] else None, ghhi if need[4] else None)
