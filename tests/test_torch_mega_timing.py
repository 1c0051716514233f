"""The shoebox timing tool (``python -m
wayverb_tpu_torch.tools.mega_timing``) on the CPU: B5's bound, the paths
of its warps, its comparison to the bit and the tool's arguments.  It times
only on the card.  No JAX, no hall-sized field."""

from unittest import mock

import pytest
import torch

from wayverb_tpu_torch.tools import mega_timing as mt
from wayverb_tpu_torch.tools import roofline
from wayverb_tpu_torch.waveguide import box_fused as tbf

# the concert-hall shoebox of bench.py: the box runs from 2 to 221, 221, 253
HALL = tbf.BoxSpec(dims=(224, 224, 256), ilo=(2, 2, 2), ihi=(221, 221, 253),
                   face_surface=(0,) * 6)


def test_b5_bound_at_the_hall_and_its_shard():
    """B5 moves g in and gcur, gprev out (12 B a node), the six inner and
    six plane cotangents and the two halo rows: 46.94 µs by bytes at 3.35
    TB/s at the hall, 12.04 µs at its (56, 224, 256) shard."""
    hall = mt.b5_bound((224, 224, 256))
    assert hall[1] == "bytes"
    assert hall[0] == pytest.approx(46.94, abs=5e-3)
    assert mt.b5_bound((56, 224, 256))[0] == pytest.approx(12.04, abs=5e-3)
    n, Y, Z = 3 * 7 * 9, 7, 9
    natural = 2 * (Y * Z + 3 * Z + 3 * Y)
    assert mt.b5_bound((3, 7, 9)) == roofline.bound_us(
        4 * (3 * n + 2 * natural + 2 * Y * Z), 8 * n)


@pytest.mark.parametrize("x_off,rows", [(0, 224), (56, 56)])
def test_b5_warp_shares_at_the_hall(x_off, rows):
    """At the hall and at its second shard, 69.7 % of B5's (warp, row)
    pairs run bare, 23.2 % z only (the warps of z 0–31 and 224–255), 2.6 %
    x only (bare warps in the rows near the x walls or in rows 0 and X − 1
    of the shard) and 4.4 % general (the other warps of those rows, the
    rows near the y walls, the source's warp): 7.0 % would be general with
    three paths."""
    src = (x_off + rows // 2, 112, 128, 1)
    shares = mt.b5_warp_shares(HALL.geom_array(x_off), (rows, 224, 256),
                               src)
    assert shares["bare"] == pytest.approx(0.697, abs=5e-4)
    assert shares["z_only"] == pytest.approx(0.232, abs=5e-4)
    assert shares["x_only"] == pytest.approx(0.026, abs=5e-4)
    assert shares["general"] == pytest.approx(0.044, abs=5e-4)
    assert sum(shares.values()) == pytest.approx(1.0)


def test_b5_warp_paths_on_a_small_block():
    """A (10, 9, 40) grid with the box [2, 7] x [2, 6] x [2, 37]: rows 4
    and 5 lie two or more inside in x, only y = 4 in y, z 4–35 in z.  Warp
    5 holds the nodes 160–191, y = 4 and z 0–31, so it runs z only in
    those rows and is general in the others; every other (warp, row) pair
    is general (warp 6 mixes y = 4 and 5, the last warp has dead lanes).
    No warp is bare, so none is x only."""
    geom = (0, 0, 0, 2, 7, 2, 6, 2, 37)
    paths = mt.b5_warp_paths(geom, (10, 9, 40))
    assert paths.shape == (10, -(-9 * 40 // 32))
    want = torch.full(paths.shape, 3)
    want[4:6, 5] = 1
    assert torch.equal(paths, want)
    # a hard source in warp 5 of row 4 takes that pair to the general path
    paths = mt.b5_warp_paths(geom, (10, 9, 40), (4, 4, 10, 1))
    want[4, 5] = 3
    assert torch.equal(paths, want)
    # a soft source does not, nor a hard one outside the shard
    for src in ((4, 4, 10, 2), (12, 4, 10, 1)):
        assert torch.equal(mt.b5_warp_paths(geom, (10, 9, 40), src),
                           mt.b5_warp_paths(geom, (10, 9, 40)))
    nodes = mt.b5_node_paths(geom, (10, 9, 40))
    assert nodes.shape == (10, 9, 40)
    assert bool((nodes[4:6, 4, :32] == 1).all())
    assert int((nodes != 3).sum()) == 2 * 32
    # with Z = 96 and the box to z = 93, warp 13 (y = 4, z 32–63) is bare
    # in rows 4 and 5 and x only in the other rows
    paths = mt.b5_warp_paths((0, 0, 0, 2, 7, 2, 6, 2, 93), (10, 9, 96))
    assert paths[:, 13].tolist() == [2, 2, 2, 2, 0, 0, 2, 2, 2, 2]
    assert paths[:, 12].tolist() == [3, 3, 3, 3, 1, 1, 3, 3, 3, 3]
    assert mt.B5_PATHS[2] == "x_only"


def test_b5_equal_on_the_cpu_takes_the_plain_version():
    """``b5_equal`` compares the wrapper with the plain version; on CPU
    tensors both are the plain version, on every kind of cotangent."""
    spec = tbf.BoxSpec(dims=(20, 16, 40), ilo=(2, 2, 2), ihi=(17, 13, 37),
                       face_surface=(0,) * 6)
    gen = torch.Generator().manual_seed(3)
    for kind in ("random", "1e38 inf nan", "all -0"):
        args = mt.b5_case(spec, 5, 5, gen, kind)
        assert args[3] == (7, 8, 20, 1)
        assert mt.b5_equal(args) == {"equal": True, "differ": [],
                                     "max_abs_err": 0.0}


def test_arguments_and_the_card():
    assert mt.parse_args([]).kernel == "b2"
    for kernel in ("b1", "b2", "b5", "b7"):
        assert mt.parse_args(["--kernel", kernel]).kernel == kernel
    with pytest.raises(SystemExit):
        mt.parse_args(["--kernel", "b9"])
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        for kernel in ("b5", "b1"):
            with pytest.raises(SystemExit, match="CUDA"):
                mt.main(["--kernel", kernel])
