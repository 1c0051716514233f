"""Back-to-back renders through ``waveguide.run.canonical``, each with a fresh
source and receiver, at the configuration's IR length.

The check: a sample of the window's renders, drawn from the seed, is
rendered again by the plain reference from the same inputs; the largest gap
of the pressure and of the intensity over the reference's peak, and every
render's ``stable``.
"""

from __future__ import annotations

import sys

from portbench.harness import check, generator, loops, profile, scenes

FAULTS = ()


def inputs(config, traffic, seed):
    """The warm-up's draw, then the window's, and the IR's length."""
    inp = loops.Inputs(config, traffic, seed)
    inp.sim_time = generator.simulation_time(config, inp.fs_mesh)
    inp.steps = generator.steps(inp.fs_mesh, inp.sim_time)
    inp.warm = next(inp.positions)
    return inp


class Cell:
    def __init__(self, torch, inp, device="cuda"):
        from wayverb_tpu_torch.waveguide import run as wgrun
        from wayverb_tpu_torch.waveguide.box_mega import DEFAULT_CHUNK
        self.torch, self.inp, self.device = torch, inp, device
        self.wgrun = wgrun
        self.chunk = int(DEFAULT_CHUNK)
        self.timings = {}
        self.mesh = scenes.program_mesh(inp.config, inp.fs, device,
                                        self.timings)
        self.work_each = inp.nodes * inp.steps / 1e9        # Gnode updates
        warm = wgrun.canonical(self.mesh, *inp.warm,
                               (min(128, inp.steps) - 0.5) / inp.fs_mesh)
        loops.sync(torch, device)
        del warm
        self.done = []          # (source, receiver, output) in the window

    def request(self, traced=False, timed=False):
        src, rcv = next(self.inp.positions)
        with profile.span("render", traced):
            out = self.wgrun.canonical(self.mesh, src, rcv, self.inp.sim_time)
        with profile.span("sync", traced):
            loops.sync(self.torch, self.device)
        return src, rcv, out

    def record(self, result):
        out = result[2]
        if out.pressure.shape[0] != self.inp.steps:
            raise RuntimeError(f"the program ran {out.pressure.shape[0]} "
                               f"steps where {self.inp.steps} were due")
        self.done.append(result)

    def traced_slice(self) -> int:
        for _ in range(self.inp.traffic["traced_renders"]):
            self.request(traced=True)
        return self.inp.traffic["traced_renders"] * self.inp.steps

    def context(self) -> dict:
        return {"timings": self.timings,
                "shape": loops.shape(self.inp, self.chunk)}

    def failed(self) -> int:
        return sum(not bool(out.stable) for _, _, out in self.done)

    def hand_over(self, seed):
        which = generator.sample(seed, len(self.done),
                                 self.inp.traffic["checked_renders"])
        held = {"outputs": [(src, rcv, out.pressure.cpu().numpy(),
                             out.intensity.cpu().numpy())
                            for src, rcv, out in (self.done[i]
                                                  for i in which)],
                "unstable": self.failed()}
        self.mesh = self.done = None
        return held


def numbers(torch, inp, held, device, dtype=None) -> dict:
    """Gaps of the sampled renders' outputs from the reference's (in
    ``dtype``, float32 unless given)."""
    dtype = dtype or torch.float32
    ref, room = check.reference_room(torch, inp.config, inp.fs, device)
    steps = generator.steps(room.sample_rate, inp.sim_time)
    sig = torch.as_tensor(generator.impulse(inp.config, room.grid.spacing,
                                            steps), device=device)
    worst_p = worst_i = 0.0
    for src, rcv, pressure, intensity in held["outputs"]:
        with torch.no_grad():
            taps, stable = ref.run(room, src, rcv, sig, steps, dtype=dtype)
        if not stable:
            print("the reference's render is unstable", file=sys.stderr)
            worst_p = worst_i = float("inf")
            break
        p, i = ref.directional(taps.float().cpu().numpy(), room.grid.spacing,
                               room.sample_rate, inp.density)
        worst_p = max(worst_p, check.gap(pressure, p))
        worst_i = max(worst_i, check.gap(intensity, i))
    return {"pressure_gap": worst_p, "intensity_gap": worst_i,
            "unstable_renders": held["unstable"]}


def control(torch, inp, device, fault=None) -> dict:
    """The reference in bfloat16 in the program's place, on the window's
    first render, judged against the float32 reference."""
    ref, room = check.reference_room(torch, inp.config, inp.fs, device)
    src, rcv = next(inp.positions)
    steps = generator.steps(room.sample_rate, inp.sim_time)
    sig = torch.as_tensor(generator.impulse(inp.config, room.grid.spacing,
                                            steps), device=device)
    with torch.no_grad():
        taps, stable = ref.run(room, src, rcv, sig, steps,
                               dtype=torch.bfloat16)
    p, i = ref.directional(taps.float().cpu().numpy(), room.grid.spacing,
                           room.sample_rate, inp.density)
    return numbers(torch, inp, {"outputs": [(src, rcv, p, i)],
                                "unstable": int(not stable)}, device)
