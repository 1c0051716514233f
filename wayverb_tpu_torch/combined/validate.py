"""Placement validation for sources/receivers.

Port of ``wayverb_tpu.combined.validate`` (numpy on the host, the same
error strings).

Parity: reference ``combined/validate_placements.h`` +
``threaded_engine.cpp:101-141`` — all pairwise spacings must exceed
min_spacing (reference uses 0.2 m — 2× receiver radius) and every position
must map to an inside mesh node.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

MIN_SPACING = 0.2


def is_pairwise_distance_acceptable(positions: Sequence,
                                    min_spacing: float = MIN_SPACING) -> bool:
    pos = np.asarray(positions, dtype=np.float64)
    for i in range(len(pos)):
        for j in range(i + 1, len(pos)):
            if np.linalg.norm(pos[i] - pos[j]) < min_spacing:
                return False
    return True


def validate_placements(sources: Sequence, receivers: Sequence, mesh,
                        min_spacing: float = MIN_SPACING) -> None:
    """Raise RuntimeError on invalid placements (reference error strings)."""
    if not is_pairwise_distance_acceptable(
            list(sources) + list(receivers), min_spacing):
        raise RuntimeError("source and receiver positions are too close "
                           "together")
    for p in list(sources) + list(receivers):
        mesh.require_inside(p)
