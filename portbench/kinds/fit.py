"""A closed loop of value and gradient on the shoebox's mega route:
``waveguide.box_mega.mega_canonical_loss_fn`` and ``loss.backward()``, the
loss sum (taps - target)^2 in the wall filters (``coef_b``, ``coef_a``) and
the source signal, one plain normalised gradient step on the signal between
calls.  The target is rendered once at set-up with the absorption drawn
from the seed.

The check: set-up runs the first iterations through the window's own call,
and the plain reference follows them from the same inputs: each iteration's
loss, the first gradient of each leaf by its norm (the gap of the norms
over the leaf's own reference norm; a leaf whose reference norm is under a
thousandth of the median leaf's is rounding and is left out), the norm of
the signal's change after them, and every iteration's ``stable``.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from portbench.harness import check, generator, loops, profile, scenes

LEAVES = ("coef_b", "coef_a", "signal")
# each a planted fault: that leaf's gradient 1 % off as it is produced
FAULTS = tuple(f"{leaf}_grad" for leaf in LEAVES)


def inputs(config, traffic, seed):
    """The fit's one source and receiver, its length, the target's
    absorption and the starting signal."""
    inp = loops.Inputs(config, traffic, seed)
    inp.steps = config["fit_steps"]
    inp.src, inp.rcv = next(inp.positions)
    inp.target_absorption = generator.target_absorption(
        traffic, seed, len(config["absorption"]))
    inp.signal0 = generator.impulse(config, inp.spacing, inp.steps)
    inp.eta = traffic["signal_step"]
    return inp


def signal_step(torch, sig, eta):
    """sig -= eta |sig| g / |g|, in place; every gradient is dropped."""
    with torch.no_grad():
        g = sig.grad
        sig.sub_(eta * torch.linalg.vector_norm(sig)
                 / torch.linalg.vector_norm(g).clamp_min(1e-30) * g)


class Cell:
    def __init__(self, torch, inp, device="cuda"):
        from wayverb_tpu_torch.waveguide import boundary as bdry
        from wayverb_tpu_torch.waveguide import run as wgrun
        from wayverb_tpu_torch.waveguide.box_fused import face_coefficients
        from wayverb_tpu_torch.waveguide.box_mega import (
            DEFAULT_CHUNK, mega_canonical_loss_fn)
        self.torch, self.inp, self.device = torch, inp, device
        self.face_coefficients = face_coefficients
        self.chunk = int(DEFAULT_CHUNK)
        self.timings = {}
        self.mesh = scenes.program_mesh(inp.config, inp.fs, device,
                                        self.timings)
        self.work_each = 1.0
        source, receiver, n, _ = wgrun.canonical_problem(
            self.mesh, inp.src, inp.rcv, (inp.steps - 0.5) / inp.fs_mesh)
        if n != inp.steps:
            raise RuntimeError(f"{n} steps where {inp.steps} were due")
        self.f = mega_canonical_loss_fn(self.mesh.structure,
                                        self.mesh.box_spec, source, receiver,
                                        n)
        tb, ta = bdry.coefficient_table([bdry.compute_boundary_coefficients(
            inp.target_absorption, inp.fs)])
        target_structure = dataclasses.replace(
            self.mesh.structure, coef_b=torch.as_tensor(tb, device=device),
            coef_a=torch.as_tensor(ta, device=device))
        with torch.no_grad():
            self.target = self.f(*face_coefficients(
                target_structure, self.mesh.box_spec),
                torch.as_tensor(inp.signal0, device=device))[0].detach()
        s = self.mesh.structure
        self.cb = s.coef_b.detach().clone().requires_grad_(True)
        self.ca = s.coef_a.detach().clone().requires_grad_(True)
        self.sig = torch.as_tensor(inp.signal0,
                                   device=device).clone().requires_grad_(True)
        self.structure = dataclasses.replace(s, coef_b=self.cb,
                                             coef_a=self.ca)
        self.losses, self.stables = [], []
        self.fwd_s, self.bwd_s = [], []
        # the first iterations, through the window's own call, are the
        # warm-up and what the reference follows
        for k in range(inp.traffic["checked_iterations"]):
            loss, stable = self.iterate(keep=k == 0)
            self.losses.append(loss)
            self.stables.append(stable)
        loops.sync(torch, device)
        self.signal_after = self.sig.detach().clone()

    def iterate(self, keep=False, timed=False, traced=False):
        torch = self.torch
        t0 = time.perf_counter()
        with profile.span("forward", traced):
            fb, fa = self.face_coefficients(self.structure,
                                            self.mesh.box_spec)
            taps, stable = self.f(fb, fa, self.sig)
            loss = torch.sum((taps - self.target) ** 2)
        if timed:
            loops.sync(torch, self.device)
            t1 = time.perf_counter()
        with profile.span("backward", traced):
            loss.backward()
        if timed:
            loops.sync(torch, self.device)
            self.fwd_s.append(t1 - t0)
            self.bwd_s.append(time.perf_counter() - t1)
        if keep:
            self.grads0 = tuple(t.grad.detach().clone()
                                for t in (self.cb, self.ca, self.sig))
        with profile.span("update", traced):
            self.step()
        return loss.detach(), stable

    def step(self):
        """The signal's gradient step; the coefficient gradients are
        dropped."""
        signal_step(self.torch, self.sig, self.inp.eta)
        for t in (self.cb, self.ca, self.sig):
            t.grad = None

    def request(self, traced=False, timed=False):
        out = self.iterate(timed=timed, traced=traced)
        with profile.span("sync", traced):
            loops.sync(self.torch, self.device)
        return out

    def record(self, result):
        self.stables.append(result[1])

    def traced_slice(self) -> int:
        for _ in range(self.inp.traffic["traced_iterations"]):
            self.request(traced=True)
        return self.inp.traffic["traced_iterations"] * self.inp.steps

    def context(self) -> dict:
        return {"timings": self.timings,
                "shape": loops.shape(self.inp, self.chunk),
                "fit": {"fwd_s": self.fwd_s, "bwd_s": self.bwd_s}}

    def failed(self) -> int:
        return sum(not bool(s) for s in self.stables)

    def hand_over(self, seed):
        held = {"losses": [float(x) for x in self.losses],
                "grads0": tuple(g.cpu() for g in self.grads0),
                "signal_after": self.signal_after.cpu(),
                "unstable": self.failed()}
        self.f = self.mesh = self.structure = self.grads0 = None
        return held


def reference_fit(torch, inp, device, dtype=None, segment=64,
                  grad_scale=(1.0, 1.0, 1.0)):
    """The reference's first iterations of the fit, as a held program
    output: losses, first gradients (coef_b, coef_a, signal), the signal
    after them.  ``grad_scale`` plants a fault: each leaf's gradient times
    its factor as the backward produces it."""
    dtype = dtype or torch.float32
    ref, room = check.reference_room(torch, inp.config, inp.fs, device)
    tb, ta = ref.filters.coefficient_tables([inp.target_absorption], inp.fs)
    sig0 = torch.as_tensor(generator.impulse(inp.config, room.grid.spacing,
                                             inp.steps), device=device)
    with torch.no_grad():
        target, _ = ref.run(room, inp.src, inp.rcv, sig0, inp.steps,
                            dtype=dtype,
                            coef=(torch.as_tensor(tb, device=device),
                                  torch.as_tensor(ta, device=device)))
    target = target.float()
    cb = torch.as_tensor(room.coef_b, device=device).requires_grad_(True)
    ca = torch.as_tensor(room.coef_a, device=device).requires_grad_(True)
    sig = sig0.clone().requires_grad_(True)
    losses, grads0, stables = [], None, []
    for k in range(inp.traffic["checked_iterations"]):
        taps, stable = ref.run(room, inp.src, inp.rcv, sig, inp.steps,
                               dtype=dtype, coef=(cb, ca), segment=segment)
        loss = torch.sum((taps.float() - target) ** 2)
        loss.backward()
        for t, scale in zip((cb, ca, sig), grad_scale):
            if scale != 1.0:
                t.grad.mul_(scale)
        losses.append(float(loss.detach()))
        stables.append(bool(stable))
        if k == 0:
            grads0 = tuple(t.grad.detach().cpu().clone()
                           for t in (cb, ca, sig))
        signal_step(torch, sig, inp.eta)
        for t in (cb, ca, sig):
            t.grad = None
    return {"losses": losses, "grads0": grads0,
            "signal_after": sig.detach().cpu(),
            "unstable": sum(not s for s in stables)}


def compare(torch, program, reference, signal0, leaves=None) -> dict:
    """The numbers of a held program output against the reference's;
    ``leaves``, a dict, receives each leaf's reference norm and gap."""
    def norm(t):
        return float(torch.linalg.vector_norm(t.double().cpu()))

    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(program["losses"], reference["losses"]))
    r_norms = [norm(g) for g in reference["grads0"]]
    median = float(np.median(r_norms))
    gaps = []
    for leaf, got, rn in zip(LEAVES, program["grads0"], r_norms):
        counted = rn >= 1e-3 * median
        g = abs(norm(got) - rn) / rn if counted else None
        print(f"leaf {leaf} reference_norm {rn!r} gap {g!r}"
              f"{'' if counted else ' (rounding, left out)'}",
              file=sys.stderr)
        if counted:
            gaps.append(g)
        if leaves is not None:
            leaves[leaf] = {"reference_norm": rn, "gap": g}
    s0 = torch.as_tensor(signal0).double()
    p_change = norm(program["signal_after"].double() - s0)
    r_change = norm(reference["signal_after"].double() - s0)
    return {"loss_gap": loss_gap, "grad_gap": max(gaps),
            "change_gap": abs(p_change - r_change) / max(r_change, 1e-30),
            "unstable_iterations": program["unstable"]}


def numbers(torch, inp, held, device) -> dict:
    return compare(torch, held, reference_fit(torch, inp, device),
                   inp.signal0)


def control(torch, inp, device, fault=None) -> dict:
    """The reference in bfloat16 in the program's place, or with ``fault``
    the float32 reference with that leaf's gradient 1 % off as it is
    produced; judged against the float32 reference."""
    if fault is None:
        program = reference_fit(torch, inp, device, dtype=torch.bfloat16)
    else:
        scale = [1.0, 1.0, 1.0]
        scale[FAULTS.index(fault)] = 1.01
        program = reference_fit(torch, inp, device, grad_scale=scale)
    return compare(torch, program, reference_fit(torch, inp, device),
                   inp.signal0)
