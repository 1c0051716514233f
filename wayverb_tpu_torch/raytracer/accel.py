"""Ray-intersection backend choice.

Port of ``wayverb_tpu.raytracer.accel.auto_accel``, its dense branch only:
scenes of at most 100 triangles (every shoebox, and the small procedural
halls of ``raytracer.scenes``) stay on the dense (R, T) broadcast of
``core.geometry.scene_intersection``.  The voxel DDA and the Möller–Trumbore
kernels for larger scenes are not ported yet (ROADMAP A.5b).
"""

from __future__ import annotations

from wayverb_tpu_torch.core.geometry import TriangleSoup

DENSE_MAX_TRIANGLES = 100


def auto_accel(soup: TriangleSoup):
    """None (the dense broadcast) for scenes of ≤ 100 triangles."""
    if soup.num_triangles <= DENSE_MAX_TRIANGLES:
        return None
    raise NotImplementedError(
        f"scenes above {DENSE_MAX_TRIANGLES} triangles need the voxel DDA or "
        "the Möller–Trumbore kernels, not ported yet: ROADMAP queue A, "
        "item A.5b")
