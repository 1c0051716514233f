"""The benchmark's copies of the kernels' operation and byte counts equal the
port's tools at the cells' shapes."""

import pytest

from portbench.harness import manifest

HALL = (224, 224, 256)
COLUMNS = (343, 139, 259)


def _shape(dims):
    return {"dims": dims, "order": 6, "taps": 7, "chunk": 128}


def _per_step_us(name, dims):
    """A launch's bound over its steps: a chunk kernel's launch runs
    ``chunk`` sub-steps, B8's one step."""
    peaks = manifest.module("rooflines", "peaks")
    shape = _shape(dims)
    ops, nbytes = manifest.module("rooflines", name).launch(shape)
    k = 1 if name == "b8" else shape["chunk"]
    return peaks.bound_us(nbytes / k, ops / k)


@pytest.mark.parametrize("kernel", ["b2", "b6", "b7"])
def test_chunk_kernels_match_chip_smoke(kernel):
    import chip_smoke
    from wayverb_tpu_torch.waveguide.box_fused import BoxSpec
    spec = BoxSpec(dims=HALL, ilo=(2, 2, 2), ihi=(221, 221, 253),
                   face_surface=(0,) * 6)
    want_ms, want_by = chip_smoke.kernel_bounds(spec, 6, 7)[kernel]
    got_us, got_by = _per_step_us(kernel, HALL)
    assert got_us == pytest.approx(1e3 * want_ms, rel=1e-12)
    assert got_by == want_by


def test_b8_matches_mesh_timing():
    from wayverb_tpu_torch.tools.mesh_timing import mesh_bounds
    assert _per_step_us("b8", COLUMNS) == pytest.approx(
        mesh_bounds(COLUMNS)["b8"], rel=1e-12)


def test_chunk_launch_counts_fields_once():
    """Twice the sub-steps a launch: twice the operations, and the fields'
    bytes still counted once."""
    one, two = _shape(HALL), dict(_shape(HALL), chunk=256)
    for kernel in ("b2", "b6", "b7"):
        mod = manifest.module("rooflines", kernel)
        (ops1, by1), (ops2, by2) = mod.launch(one), mod.launch(two)
        assert ops2 == 2 * ops1
        assert by1 < by2 < 2 * by1


def test_peaks_match_the_tool():
    from wayverb_tpu_torch.tools import roofline
    peaks = manifest.module("rooflines", "peaks")
    for args in ((1e9, 1e6), (1e3, 1e12)):
        assert peaks.bound_us(*args) == roofline.bound_us(*args)
