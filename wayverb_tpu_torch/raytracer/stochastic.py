"""Late-field synthesis: directional energy histogram → pressure tail.

Port of ``wayverb_tpu.raytracer.stochastic``.  Pipeline (parity: reference
``raytracer/stochastic/postprocessing.{h,cpp}`` and
``stochastic/postprocess.h``):
 1. attenuate the 20×9 directional histogram per direction bin by the
    capsule's squared gain (energy domain) and sum → (bins, bands),
 2. synthesize a Poisson dirac sequence with rate min(4πc³t²/V, 10⁴)
    starting at t₀ = (2ln2/rate_constant)^{1/3},
 3. weight each histogram bin's worth of sequence samples so its energy
    matches the histogram (pressure = √(E/Σδ²·Z)),
 4. multiband filter + mixdown.

The dirac sequence is per-sample Bernoulli thinning of the inhomogeneous
Poisson process, and the binwise weighting is a segment sum.  Its random
numbers — (n,) uniforms and (n,) signs — come from a ``torch.Generator``,
or are passed in so a test can feed the reference's draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from wayverb_tpu_torch.core.attenuator import Null
from wayverb_tpu_torch.core.environment import Environment
from wayverb_tpu_torch.core.pressure import intensity_to_pressure
from wayverb_tpu_torch.raytracer.histogram import scatter_add_drop
from wayverb_tpu_torch.signal.multiband import multiband_filter_and_mixdown

MAX_EVENT_RATE = 10000.0


def constant_mean_event_occurrence(speed_of_sound: float,
                                   room_volume: float) -> float:
    return 4.0 * math.pi * speed_of_sound ** 3 / room_volume


def mean_event_occurrence(constant, t):
    return torch.clamp(constant * t * t, max=MAX_EVENT_RATE)


def t0(constant: float) -> float:
    return (2.0 * math.log(2.0) / constant) ** (1.0 / 3.0)


def dirac_draws(n: int, generator: Optional[torch.Generator], device):
    """(uniforms (n,), signs (n,) of ±1) for ``generate_dirac_sequence``,
    drawn on the generator's device (torch's default generator of
    ``device`` when None) and moved to ``device``."""
    gdev = generator.device if generator is not None else device
    uniforms = torch.rand(n, generator=generator, device=gdev)
    signs = torch.randint(0, 2, (n,), generator=generator, device=gdev)
    return uniforms.to(device), (2.0 * signs - 1.0).to(torch.float32) \
        .to(device)


def generate_dirac_sequence(speed_of_sound: float, room_volume: float,
                            sample_rate: float, max_time: float, draws):
    """±1 dirac train from the inhomogeneous Poisson model, (n,) float.

    ``draws``: (uniforms (n,), signs (n,)) with n = ⌈max_time·sample_rate⌉.
    """
    constant = constant_mean_event_occurrence(speed_of_sound, room_volume)
    n = int(math.ceil(max_time * sample_rate))
    uniforms, signs = draws
    if uniforms.shape != (n,) or signs.shape != (n,):
        raise ValueError(f"dirac draws must be ({n},), got "
                         f"{tuple(uniforms.shape)} and {tuple(signs.shape)}")
    t = torch.arange(n, dtype=torch.float32, device=uniforms.device) \
        / sample_rate
    rate = mean_event_occurrence(constant, t)
    p_event = 1.0 - torch.exp(-rate / sample_rate)
    events = (uniforms < p_event) & (t >= t0(constant))
    return torch.where(events, signs, torch.zeros_like(signs))


def bin_pointing(num_az: int = 20, num_el: int = 9, device="cpu"):
    """(az, el, 3) centre directions of the histogram's angle bins."""
    az = torch.arange(num_az, device=device) * (2.0 * math.pi / num_az)
    el = (torch.arange(num_el, device=device) - num_el // 2) \
        * (math.pi / num_el)
    azg, elg = torch.meshgrid(az, el, indexing="ij")
    # inverse of orientation.azimuth/elevation: az = atan2(x, z), el = asin(y)
    return torch.stack([torch.cos(elg) * torch.sin(azg), torch.sin(elg),
                        torch.cos(elg) * torch.cos(azg)], dim=-1)


def attenuate_histogram(directional_hist, method):
    """(bins, az, el, bands) → (bins, bands) with squared capsule gains."""
    if isinstance(method, Null):
        return torch.sum(directional_hist, dim=(1, 2))
    pointing = bin_pointing(directional_hist.shape[1],
                            directional_hist.shape[2],
                            directional_hist.device)       # (az, el, 3)
    att = method.attenuation(pointing)                     # (az,el) or +bands
    if att.dim() == 2:
        att = att[..., None]
    factor = att * att                                     # energy domain
    return torch.sum(directional_hist * factor[None], dim=(1, 2))


def weight_sequence(histogram, histogram_sr: float, sequence,
                    sequence_sr: float, acoustic_impedance: float):
    """Scale the dirac train so each histogram bin carries its energy.

    histogram: (bins, bands); sequence: (N,).  Returns (N, bands).
    """
    bins = histogram.shape[0]
    n = sequence.shape[0]
    sample_bin = torch.floor(
        torch.arange(n, dtype=torch.float32, device=sequence.device)
        * histogram_sr / sequence_sr).to(torch.int64)
    sq = scatter_add_drop(bins, sample_bin, sequence * sequence)   # (bins,)
    scale = torch.where(
        sq[:, None] > 0,
        intensity_to_pressure(
            histogram / torch.clamp(sq[:, None], min=1e-30),
            acoustic_impedance),
        torch.zeros_like(histogram))                       # (bins, bands)
    # an index past the last bin reads the last bin, as the reference's
    # clamped gather does
    return sequence[:, None] * scale[torch.clamp(sample_bin, max=bins - 1)]


def postprocess(directional_hist, histogram_sr: float, method, room_volume,
                environment: Environment, output_sample_rate: float,
                generator: Optional[torch.Generator] = None, draws=None):
    """Directional histogram → broadband pressure tail at the output rate.

    ``draws``: optional (uniforms, signs) for the dirac sequence; otherwise
    they come from ``generator`` (``dirac_draws``).
    """
    summed = attenuate_histogram(directional_hist, method)
    max_time = summed.shape[0] / histogram_sr
    if draws is None:
        n = int(math.ceil(max_time * output_sample_rate))
        draws = dirac_draws(n, generator, summed.device)
    else:
        draws = tuple(torch.as_tensor(d, dtype=torch.float32,
                                      device=summed.device) for d in draws)
    sequence = generate_dirac_sequence(
        environment.speed_of_sound, float(room_volume), output_sample_rate,
        max_time, draws)
    weighted = weight_sequence(summed, histogram_sr, sequence,
                               output_sample_rate,
                               environment.acoustic_impedance)
    return multiband_filter_and_mixdown(weighted.T, output_sample_rate)
