"""The all-pairs render driver: validate placements, run every
source×receiver pair, render every capsule, normalize jointly, write files.

Port of ``wayverb_tpu.combined.complete``.  It keeps the reference's
quirks: ``waveguide.mode`` and ``bands`` of the project are not read (one
band at the project's cutoff), the channels are normalised jointly by the
largest peak, and the files are WAV whatever the extension.

Random numbers: the reference folds its key per pair and per capsule; the
port draws from one ``torch.Generator`` in succession (each pair's trace,
then each of its capsules' tails), or takes the draws as tensors:
``directions`` per pair and ``draws`` per (pair, capsule), so a test can
feed the reference's.

Parity: reference ``combined/threaded_engine.cpp:60-280`` (complete_engine)
— minus the background thread (call it from your own executor if needed)
and plus progress callbacks as plain callables.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from wayverb_tpu_torch.combined import engine as eng
from wayverb_tpu_torch.combined.model import Project, compute_output_path
from wayverb_tpu_torch.combined.validate import validate_placements
from wayverb_tpu_torch.core.environment import Environment
from wayverb_tpu_torch.core.geometry import Box, TriangleSoup
from wayverb_tpu_torch.utils.audio import write_wav


@dataclasses.dataclass
class RenderedChannel:
    source: str
    receiver: str
    capsule: str
    path: str
    signal: np.ndarray
    scale: float = 1.0      # the joint normalisation the signal carries


def run_project(project: Project, soup: TriangleSoup,
                generator: Optional[torch.Generator] = None,
                environment: Environment = Environment(),
                scene_box: Optional[Box] = None,
                write_files: bool = True,
                state_callback: Callable[[str, float], None] = lambda s, p:
                None, *, device="cuda",
                directions: Optional[Sequence] = None,
                draws: Optional[Sequence[Sequence]] = None
                ) -> List[RenderedChannel]:
    """Render the whole project on ``device`` (the card unless the caller
    asks for the CPU; without a GPU the default raises, as ``Engine``
    does); returns the per-channel signals, jointly normalised.

    ``generator``: the source of every random draw, used in succession.
    ``directions``: optional per-pair ray directions for ``Engine.run``
    (pairs in source-major order); ``draws``: optional per-pair lists of
    per-capsule (uniforms, signs) for ``render``.
    ``state_callback(state, progress)`` mirrors the reference's engine-state
    event stream (engine.h:38-48).
    """
    surfaces = project.surface_table(device="cpu")
    state_callback("initialising", 0.0)
    e = eng.Engine(
        soup, surfaces,
        eng.WaveguideParameters(cutoff=project.waveguide.cutoff,
                                usable_portion=(
                                    project.waveguide.usable_portion)),
        environment=environment, scene_box=scene_box, device=device)

    validate_placements([s.position for s in project.sources],
                        [r.position for r in project.receivers], e.mesh)

    rt_params = eng.RaytracerParameters(
        rays=project.raytracer.rays,
        maximum_image_source_order=(
            project.raytracer.maximum_image_source_order),
        receiver_radius=project.raytracer.receiver_radius,
        histogram_sample_rate=project.raytracer.histogram_sample_rate)

    signals, names = [], []
    pairs = [(s, r) for s in project.sources for r in project.receivers]
    for i, (src, rcv) in enumerate(pairs):
        base = i / max(len(pairs), 1)
        state_callback(f"rendering {src.name} -> {rcv.name}", base)
        results = e.run(
            src.position, rcv.position, generator, rt_params,
            state_callback=lambda ph, base=base, src=src, rcv=rcv:
            state_callback(f"{ph} {src.name} -> {rcv.name}", base),
            directions=None if directions is None else directions[i])
        for j, capsule in enumerate(rcv.capsules):
            method = capsule.build(rcv.pointing)
            signals.append(eng.render(
                results, method, project.output.sample_rate, generator,
                None if draws is None else draws[i][j]))
            names.append((src, rcv, capsule))

    # joint peak normalization (threaded_engine.cpp:241-260), one read back
    peak = max((float(torch.max(torch.abs(s))) for s in signals),
               default=1.0)
    scale = 1.0 / max(peak, 1e-12)
    channels = [RenderedChannel(
        source=src.name, receiver=rcv.name, capsule=capsule.name,
        path=compute_output_path(src, rcv, capsule, project.output),
        signal=s.cpu().numpy() * scale, scale=scale)
        for s, (src, rcv, capsule) in zip(signals, names)]

    if write_files:
        state_callback("writing files", 1.0)
        for c in channels:
            write_wav(c.path, c.signal, project.output.sample_rate,
                      bit_depth=project.output.bit_depth)
    state_callback("done", 1.0)
    return channels
