"""Image-source impulses → broadband early IR.

Port of ``wayverb_tpu.imagesource.postprocess`` (parity: reference
``raytracer/image_source/postprocess.h:22-42``, ``raytracer/attenuator.h``):
attenuate per impulse by the capsule model → windowed-sinc deposit into an
8-band time histogram → multiband filter + mixdown to one pressure signal.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from wayverb_tpu_torch.core.attenuator import Hrtf, Microphone, Null
from wayverb_tpu_torch.core.geometry import norm3
from wayverb_tpu_torch.core.impulse import Impulses
from wayverb_tpu_torch.raytracer.histogram import sinc_histogram
from wayverb_tpu_torch.signal.multiband import multiband_filter_and_mixdown


def attenuate(method, receiver_position, impulses: Impulses):
    """Apply a capsule model; returns (volumes (N, bands), distances (N,)).

    For HRTF the listening position shifts to the ear, changing both gain
    direction and distance (interaural time difference), as in the
    reference.
    """
    receiver_position = torch.as_tensor(receiver_position,
                                        dtype=torch.float32,
                                        device=impulses.volume.device)
    if isinstance(method, Null):
        return impulses.volume, impulses.distance
    if isinstance(method, Microphone):
        att = method.attenuation(impulses.position - receiver_position)
        return impulses.volume * att[:, None], impulses.distance
    if isinstance(method, Hrtf):
        direction = impulses.position - method.ear_position(
            receiver_position)
        att = method.attenuation(direction)               # (N, bands)
        return (impulses.volume * att,
                norm3(direction))
    raise TypeError(f"unknown capsule method {type(method)}")


def postprocess(impulses: Impulses, method, receiver_position,
                speed_of_sound, sample_rate,
                num_bins: Optional[int] = None):
    """Early-reflection pressure IR of length ``num_bins`` samples (by
    default up to the last impulse: one read back to the host)."""
    volumes, distances = attenuate(method, receiver_position, impulses)
    # a tensor divisor: the card divides by a host scalar as a multiply by
    # its reciprocal, which the CPU does not, and a time one ulp off moves
    # the sinc deposit
    times = distances / torch.full_like(distances, speed_of_sound)
    if num_bins is None:
        num_bins = int(math.floor(float(torch.max(times)) * sample_rate)) + 1
    hist = sinc_histogram(times, volumes, sample_rate, num_bins)  # (T, b)
    return multiband_filter_and_mixdown(hist.T, sample_rate)      # (T,)
