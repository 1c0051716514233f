"""The hybrid engine: one source–receiver pair, all three solvers, combined.

Port of ``wayverb_tpu.combined.engine``.  Flow (parity: reference
``combined/engine.cpp:90-188`` + ``full_run.h``):
 1. build the waveguide mesh for the scene (voxelise + classify + fit
    boundary filters) on the engine's device,
 2. run the ray tracer (stochastic histogram + traced image-source paths +
    direct line-of-sight),
 3. run the waveguide for the duration the stochastic tail indicates (on a
    CUDA device a shoebox takes the mega chunk kernel, any other scene the
    general weighted-step kernel),
 4. per capsule: postprocess both solvers to the output rate, crossover at
    the waveguide cutoff, window to the direct arrival.

Random numbers come from a ``torch.Generator``; the ray directions and the
dirac draws can also be passed in, so a test can feed the reference's
``jax.random`` draws.  With ``scene_box`` the scene is a shoebox; without
it, any closed triangle soup (``core.scene.load_scene`` reads one from a
model file).  Above 100 triangles the ray tracer takes the backend
``raytracer.accel.auto_accel`` picks for the engine's device; image sources
are validated on the dense broadcast whatever the backend.  With a
``device_mesh`` (``parallel.sharding.DeviceMesh``) the waveguide leg runs on
x-shards of the grid (``parallel.box_sharded`` for a shoebox,
``parallel.general_sharded`` for any other scene); the ray leg stays on the
engine's device.  ``WaveguideParameters(bands=k)`` with k > 1 runs the
multiband waveguide (``waveguide.run.canonical_multiband``: one run per
band with flat boundaries at the band's absorption, each on the route one
band takes), and every capsule renders: ``Null``, ``Microphone`` and the
two-eared ``Hrtf``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from wayverb_tpu_torch.combined.postprocess import (crossover_filter,
                                                    window_direct_arrival)
from wayverb_tpu_torch.core.environment import Environment
from wayverb_tpu_torch.core.geometry import Box, TriangleSoup
from wayverb_tpu_torch.core.impulse import Impulses, apply_distance_pressure
from wayverb_tpu_torch.core.surfaces import Surface
from wayverb_tpu_torch.imagesource import exact
from wayverb_tpu_torch.imagesource.postprocess import \
    postprocess as is_postprocess
from wayverb_tpu_torch.imagesource.tree import find_image_source_impulses
from wayverb_tpu_torch.parallel.box_sharded import canonical_sharded
from wayverb_tpu_torch.parallel.general_sharded import \
    canonical_general_sharded
from wayverb_tpu_torch.raytracer import stochastic, tracer
from wayverb_tpu_torch.raytracer.accel import auto_accel
from wayverb_tpu_torch.waveguide import run as wgrun
from wayverb_tpu_torch.waveguide.descriptor import (compute_sampling_frequency,
                                                    grid_spacing)
from wayverb_tpu_torch.waveguide.postprocess import BandpassBand
from wayverb_tpu_torch.waveguide.postprocess import \
    postprocess as wg_postprocess


@dataclasses.dataclass(frozen=True)
class RaytracerParameters:
    """Parity: raytracer/simulation_parameters.h:9-34."""

    rays: int = 1 << 16
    maximum_image_source_order: int = 4
    receiver_radius: float = 0.1
    histogram_sample_rate: float = 1000.0
    max_time: float = 4.0


@dataclasses.dataclass(frozen=True)
class WaveguideParameters:
    """Parity: waveguide/simulation_parameters.h — ``bands=1`` is the
    single-band mode (fitted boundary filters, valid up to ``cutoff``);
    ``bands=k`` > 1 runs the first k of the absorption's hrtf bands with
    flat boundaries (``canonical_multiband``)."""

    cutoff: float = 500.0
    usable_portion: float = 0.6
    bands: int = 1

    @property
    def sample_rate(self) -> float:
        return compute_sampling_frequency(self.cutoff, self.usable_portion)


@dataclasses.dataclass
class CombinedResults:
    """Raw solver outputs for one src–rcv pair, before capsule rendering."""

    image_source: Impulses            # includes direct; 1/r applied
    stochastic_histogram: Any         # (bins, 20, 9, bands)
    histogram_sample_rate: float
    waveguide_bands: List[BandpassBand]
    room_volume: float
    source: Any
    receiver: Any
    environment: Environment


def optimum_depth(surfaces: Surface) -> int:
    """The bounce count the engine traces: the optimum reflection number,
    rounded up to a multiple of 8 as the reference rounds it."""
    min_absorption = float(torch.min(surfaces.absorption))
    depth = tracer.compute_optimum_reflection_number(
        max(min_absorption, 1e-3))
    return -(-depth // 8) * 8


class Engine:
    """Reusable per-scene state: mesh + materials (reference engine ctor)."""

    def __init__(self, soup: TriangleSoup, surfaces: Surface,
                 waveguide_params: WaveguideParameters = WaveguideParameters(),
                 environment: Environment = Environment(),
                 scene_box: Optional[Box] = None, device_mesh=None, *,
                 device="cuda"):
        """``device``: where the mesh, the ray leg and the results live (the
        card unless the caller asks for the CPU).  ``device_mesh``: optional
        ``DeviceMesh``; the waveguide leg then runs on its x-shards, with
        the grid's x dim padded to divide over it."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Engine: device {device!r} needs an NVIDIA GPU and none is "
                "available; pass device='cpu' to run on the CPU")
        self.soup = soup.to(self.device)
        self.surfaces = surfaces.to(self.device)
        self.environment = environment
        self.waveguide_params = waveguide_params
        self.device_mesh = device_mesh
        spacing = grid_spacing(environment.speed_of_sound,
                               1.0 / waveguide_params.sample_rate)
        align = None if device_mesh is None else (device_mesh.size, 1, 1)
        self.absorption = surfaces.absorption.cpu().numpy()   # (S, bands)
        self.mesh = wgrun.compute_mesh(
            soup.to("cpu"), self.absorption, spacing,
            waveguide_params.sample_rate, scene_box=scene_box, align=align,
            device=self.device)
        self.ray_grid = auto_accel(soup, self.device)

    def run(self, source, receiver, generator: Optional[torch.Generator],
            raytracer_params: RaytracerParameters = RaytracerParameters(),
            waveguide_time: Optional[float] = None,
            time_quantum: float = 0.1, state_callback=None,
            directions=None) -> CombinedResults:
        """``waveguide_time``: fix the waveguide duration; when None it is
        derived from the trace (one read back to the host) and rounded UP
        to ``time_quantum``.

        ``state_callback(state)``: optional per-phase hook mirroring the
        reference engine's state enum (``engine.h:38-48``); raise from it to
        abort between phases.  ``directions``: optional ray directions for
        ``tracer.trace`` (initial (R, 3), per-bounce (depth, R, 3)).
        """
        def phase(name):
            if state_callback is not None:
                state_callback(name)

        env = self.environment
        depth = optimum_depth(self.surfaces)

        phase("running_raytracer")
        trace_res = tracer.trace_jit(
            self.soup, self.surfaces, source, receiver, generator,
            num_rays=raytracer_params.rays, depth=depth,
            max_time=raytracer_params.max_time, environment=env,
            receiver_radius=raytracer_params.receiver_radius,
            histogram_sample_rate=raytracer_params.histogram_sample_rate,
            max_image_source_order=(
                raytracer_params.maximum_image_source_order),
            accel=self.ray_grid, directions=directions)

        phase("finding_image_sources")
        image_source = find_image_source_impulses(
            trace_res.triangle_history, self.soup, self.surfaces,
            source, receiver,
            max_order=raytracer_params.maximum_image_source_order)
        direct = exact.get_direct(source, receiver, self.soup,
                                  bands=self.surfaces.absorption.shape[-1])
        image_source = apply_distance_pressure(
            image_source.concatenate(direct), env.acoustic_impedance)

        if waveguide_time is not None:
            max_stochastic_time = waveguide_time
        else:
            max_stochastic_time = time_quantum * math.ceil(
                trace_res.max_time() / time_quantum)

        phase("running_waveguide")
        if self.waveguide_params.bands > 1:
            bands = wgrun.canonical_multiband(
                self.mesh, self.absorption, source, receiver,
                max_stochastic_time, self.waveguide_params.bands, env,
                device_mesh=self.device_mesh)
        else:
            if self.device_mesh is None:
                wg_out = wgrun.canonical(self.mesh, source, receiver,
                                         max_stochastic_time, env)
            elif self.mesh.box_spec is not None:
                wg_out = canonical_sharded(self.mesh, source, receiver,
                                           max_stochastic_time,
                                           self.device_mesh, env)
            else:
                wg_out = canonical_general_sharded(
                    self.mesh, source, receiver, max_stochastic_time,
                    self.device_mesh, env)
            bands = [BandpassBand(
                pressure=wg_out.pressure, intensity=wg_out.intensity,
                sample_rate=wg_out.sample_rate,
                valid_hz=(0.0, self.waveguide_params.cutoff),
                stable=wg_out.stable)]

        phase("finishing")
        f32 = lambda p: torch.as_tensor(  # noqa: E731
            np.asarray(p, dtype=np.float32), device=self.device)
        return CombinedResults(
            image_source=image_source,
            stochastic_histogram=trace_res.histogram,
            histogram_sample_rate=trace_res.histogram_sample_rate,
            waveguide_bands=bands,
            room_volume=self.mesh.room_volume,
            source=f32(source), receiver=f32(receiver),
            environment=env)


def render(results: CombinedResults, method, output_sample_rate: float,
           generator: Optional[torch.Generator] = None, draws=None):
    """Capsule rendering: combined broadband IR at the output rate.

    ``draws``: optional (uniforms, signs) for the stochastic tail's dirac
    sequence; otherwise they come from ``generator``.
    Parity: ``combined/postprocess.h:72-136``.
    """
    env = results.environment
    head = is_postprocess(results.image_source, method, results.receiver,
                          env.speed_of_sound, output_sample_rate)
    tail = stochastic.postprocess(
        results.stochastic_histogram, results.histogram_sample_rate, method,
        results.room_volume, env, output_sample_rate, generator, draws)
    n = max(head.shape[-1], tail.shape[-1])
    geometric = F.pad(head, (0, n - head.shape[-1])) \
        + F.pad(tail, (0, n - tail.shape[-1]))

    low = wg_postprocess(results.waveguide_bands, method,
                         env.acoustic_impedance, output_sample_rate)
    cutoff = max(hi for _, hi in
                 [b.valid_hz for b in results.waveguide_bands])
    combined = crossover_filter(low, geometric, cutoff / output_sample_rate)
    return window_direct_arrival(combined, results.source, results.receiver,
                                 output_sample_rate, env.speed_of_sound)


def render_all(results: CombinedResults, methods: Sequence,
               generator: Optional[torch.Generator] = None,
               output_sample_rate: float = 44100.0, normalize: bool = True,
               draws=None):
    """Render every capsule; optionally peak-normalize jointly (reference
    complete_engine, threaded_engine.cpp:241-260).  ``draws``: optional
    per-method (uniforms, signs); otherwise each capsule takes the next
    draws of ``generator``."""
    outs = [render(results, method, output_sample_rate, generator,
                   None if draws is None else draws[i])
            for i, method in enumerate(methods)]
    n = max(o.shape[-1] for o in outs)
    stacked = torch.stack([F.pad(o, (0, n - o.shape[-1])) for o in outs])
    if normalize:
        stacked = stacked / torch.clamp(torch.max(torch.abs(stacked)),
                                        min=1e-12)
    return stacked
