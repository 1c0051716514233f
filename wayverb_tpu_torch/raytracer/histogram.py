"""IR assembly: deposit impulse batches into time histograms.

Port of ``wayverb_tpu.raytracer.histogram``.  Two deposit modes (parity:
reference ``raytracer/histogram.h``):
 * dirac — add the whole volume into one bin (energy histograms),
 * windowed sinc — fu2015 §2.2.2 band-limited deposit over a 400-sample
   Hann-windowed sinc (pressure IRs from the image-source solver).

Each is one ``index_add_`` over the impulses.  Indices follow the
reference's scatter in ``mode="drop"``: an index in [-n, -1] wraps to the
end (JAX normalises negative indices before the bounds check), anything
else outside [0, n) is dropped.  The dropped entries go to a spare last row,
so the scatter needs no host round trip.
"""

from __future__ import annotations

import math

import torch

SINC_WIDTH = 400  # samples — reference histogram.h:107


def scatter_add_drop(num_rows: int, idx, values):
    """(num_rows, ...) zeros + ``values`` (N, ...) scattered at ``idx`` (N,),
    with the reference's drop-mode index rules (see the module notes)."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + num_rows, idx)
    idx = torch.where((idx < 0) | (idx >= num_rows),
                      torch.full_like(idx, num_rows), idx)
    out = torch.zeros((num_rows + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    out.index_add_(0, idx, values)
    return out[:num_rows]


def dirac_histogram(times, volumes, sample_rate, num_bins: int):
    """Scatter volumes (N, ...) into bins (num_bins, ...) by floor(t·sr)."""
    idx = torch.floor(times * sample_rate).to(torch.int64)
    return scatter_add_drop(num_bins, idx, volumes)


def sinc_histogram(times, volumes, sample_rate, num_bins: int,
                   width: int = SINC_WIDTH):
    """Band-limited deposit: Hann-windowed sinc of ``width`` samples.

    times (N,), volumes (N, bands) → (num_bins, bands).
    """
    centre = times * sample_rate                                 # (N,)
    start = torch.floor(centre - width / 2).to(torch.int64)
    k = torch.arange(width + 1, dtype=torch.int64, device=times.device)
    j = start[:, None] + k[None, :]                              # (N, W)
    rel = j.to(volumes.dtype) - centre[:, None]
    envelope = 0.5 * (1.0 + torch.cos(2.0 * math.pi * rel / width))
    weights = envelope * torch.sinc(rel)                         # (N, W)
    vals = volumes[:, None, :] * weights[:, :, None]             # (N, W, b)
    return scatter_add_drop(num_bins, j.reshape(-1),
                            vals.reshape(-1, *volumes.shape[1:]))
