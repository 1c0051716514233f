"""The general-mesh timing tool (``python -m
wayverb_tpu_torch.tools.mesh_timing``) on the CPU: its bounds, its
comparison to the bit and its arguments.  It times only on the card.  No
JAX, no hall-sized mesh."""

from unittest import mock

import pytest
import torch

from wayverb_tpu_torch.tools import mesh_timing as mt
from wayverb_tpu_torch.tools import roofline


def test_shard_bounds_at_the_columns_hall_shard():
    """B11 at (86, 139, 259): g and the code in, ĝcur out (12 B a node)
    and the two halo rows out, 11.18 µs by bytes at 3.35 TB/s; B10 16 B a
    node and the two halo rows in, 14.87 µs."""
    b = mt.shard_bounds((86, 139, 259))
    n, row = 86 * 139 * 259, 139 * 259
    assert b["b11"] == roofline.bound_us(12 * n + 8 * row, 13 * n + 4 * row)
    assert b["b11"][1] == "bytes"
    assert b["b11"][0] == pytest.approx(11.18, abs=5e-3)
    assert b["b10"][0] == pytest.approx(14.87, abs=5e-3)
    assert mt.shard_bounds((1, 7, 9))["b11"][0] == pytest.approx(
        1e6 * 4 * (3 * 63 + 2 * 63) / roofline.HBM_BYTES_PER_S)


def test_mesh_bounds_at_the_columns_hall():
    """B9 at (343, 139, 259): g and the code in, ĝcur out (12 B a node),
    44.23 µs by bytes at 3.35 TB/s; B8 and B12 16 B a node, 58.98 µs; the
    per-node counts of ``chip_smoke.py`` phase 18."""
    n = 343 * 139 * 259
    b = mt.mesh_bounds((343, 139, 259))
    assert b["b9"] == roofline.bound_us(12 * n, 13 * n)
    assert b["b9"][1] == "bytes"
    assert b["b9"][0] == pytest.approx(44.23, abs=5e-3)
    assert b["b8"] == roofline.bound_us(16 * n, 15 * n)
    assert b["b12"] == roofline.bound_us(16 * n, 9 * n)
    assert b["b8"][0] == pytest.approx(58.98, abs=5e-3)
    # the shard adjoint's ĝcur moves B9's bytes; the halo rows add to them
    xl = mt.shard_bounds((86, 139, 259))["b11"][0]
    assert xl > mt.mesh_bounds((86, 139, 259))["b9"][0]


def test_case_g_kinds():
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(mt.case_g("all -0", (2, 3, 4), gen).view(torch.int32),
                       torch.full((2, 3, 4), -0.0).view(torch.int32))
    g = mt.case_g("1e38 inf nan", (3, 5, 7), gen).view(-1)
    assert torch.isnan(g[::13]).all() and float(g[11]) == float("-inf")
    assert float(g[7]) == float("inf")
    finite = g[torch.isfinite(g)]
    assert float(finite.abs().max()) > 1e37
    r = mt.case_g("random", (4, 4), gen)
    assert r.shape == (4, 4) and bool(torch.isfinite(r).all())
    with pytest.raises(ValueError):
        mt.case_g("ones", (2,), gen)


def test_bits_equal_tells_signed_zeros_apart_and_matches_nans():
    a = torch.tensor([0.0, 1.0, float("nan"), float("inf")])
    assert mt.bits_equal(a, a.clone())
    assert not mt.bits_equal(a, torch.tensor([-0.0, 1.0, float("nan"),
                                              float("inf")]))
    assert not mt.bits_equal(a, torch.tensor([0.0, 1.0, 2.0, float("inf")]))
    assert not mt.bits_equal(a, a[:3])


def test_arguments_and_the_card():
    assert mt.parse_args([]).kernel == "b11"
    assert mt.parse_args(["--kernel", "b11"]).kernel == "b11"
    assert mt.parse_args(["--kernel", "b9"]).kernel == "b9"
    assert mt.parse_args(["--kernel", "b10"]).kernel == "b10"
    with pytest.raises(SystemExit):
        mt.parse_args(["--kernel", "b8"])
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        for kernel in ("b9", "b10", "b11"):
            with pytest.raises(SystemExit, match="CUDA"):
                mt.main(["--kernel", kernel])


def test_b9_equal_on_the_cpu_takes_the_plain_version():
    """``b9_equal`` compares the wrapper with the plain version; on CPU
    tensors both are the plain version."""
    gen = torch.Generator().manual_seed(4)
    g = mt.case_g("1e38 inf nan", (3, 5, 40), gen)
    code = torch.full((3, 5, 40), 0x103F, dtype=torch.int32)
    with mock.patch.object(torch.cuda, "synchronize"):
        out = mt.b9_equal(g, code)
    assert out == {"equal": True, "max_abs_err": 0.0}


def test_b11_equal_on_the_cpu_takes_the_plain_version():
    """``b11_equal`` compares the wrapper with the plain version; on CPU
    tensors both are the plain version."""
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(3, 5, 40, generator=gen)
    code = torch.full((3, 5, 40), 0x103F, dtype=torch.int32)
    with mock.patch.object(torch.cuda, "synchronize"):
        out = mt.b11_equal(g, code)
    assert all(v["equal"] and v["max_abs_err"] == 0.0 for v in out.values())


def test_bare_warps_on_a_block():
    """A block of interior code 0x103F: in (3, 4, 40) only row 1 has nodes
    with six neighbours in the grid, at y = 1, 2 and z = 1 … 38, and no
    warp of 32 consecutive (y, z) nodes holds only such nodes; in (3, 4,
    130) they are the nodes 131 … 258 and 261 … 388 of row 1, so warps 5–7
    and 9–11.  Bit 12 (the node's own interior flag) plays no part; a
    neighbour of weight 2 or 0 in any direction takes the warps of its six
    neighbours off the bare path."""
    block = torch.full((3, 4, 40), 0x103F, dtype=torch.int32)
    assert mt.bare_warps(block).shape == (3, 5)
    assert not mt.bare_warps(block).any()
    big = torch.full((3, 4, 130), 0x103F, dtype=torch.int32)
    want = torch.zeros((3, 17), dtype=torch.bool)
    want[1, [5, 6, 7, 9, 10, 11]] = True
    assert torch.equal(mt.bare_warps(big), want)
    assert torch.equal(mt.bare_warps(big & 0xFFF), want)
    # (1, 1, 45) is node 175 (warp 5); its y + 1 neighbour is node 305
    want[1, [5, 9]] = False
    for changed in (0x103F | 1 << 7, 0x103F & ~(1 << 3)):
        big[1, 1, 45] = changed
        assert torch.equal(mt.bare_warps(big), want)


def test_b10_equal_on_the_cpu_takes_the_plain_version():
    """``b10_equal`` compares the wrapper with the plain version, into a
    fresh output and into ``out=prev``; on CPU tensors both are the plain
    version.  ``b10_inputs`` makes cur, prev and the two halo rows."""
    gen = torch.Generator().manual_seed(6)
    code = torch.full((3, 5, 40), 0x103F, dtype=torch.int32)
    for what in ("random", "1e38 inf nan", "all -0"):
        cur, prev, halos = mt.b10_inputs(what, (3, 5, 40), gen)
        assert cur.shape == prev.shape == (3, 5, 40)
        assert [h.shape for h in halos] == [(1, 5, 40)] * 2
        with mock.patch.object(torch.cuda, "synchronize"):
            out = mt.b10_equal(cur, prev, code, halos)
        assert out == {"equal": True, "equal_out_prev": True,
                       "max_abs_err": 0.0}, what


def test_forward_bare_warps_on_a_hand_made_code():
    """B10's warp rule: 32 consecutive nodes of a row of the flattened
    (y, z) plane, bare where each node's own code is 0x103F (six weights
    of 1 and bit 12), whatever its neighbours' codes.  In (3, 4, 40) the
    plane has 160 nodes: warps 0–4 bare in every row; CTAs of 128 launch
    two CTAs a row, eight warps, of which the last three hold no node and
    are not bare.  One node of weight 2 or 0, or without bit 12, spoils
    its own warp only; a plane's last partial warp is not bare."""
    code = torch.full((3, 4, 40), 0x103F, dtype=torch.int32)
    want = torch.zeros((3, 8), dtype=torch.bool)
    want[:, :5] = True
    assert torch.equal(mt.forward_bare_warps(code, 128), want)
    assert torch.equal(mt.forward_bare_warps(code, 32), want[:, :5])
    # node (1, 2, 7) is p = 87, lane 23 of warp 2
    for changed in (0x103F | 1 << 7, 0x103F & ~(1 << 3), 0x3F):
        c = code.clone()
        c[1, 2, 7] = changed
        w = want.clone()
        w[1, 2] = False
        assert torch.equal(mt.forward_bare_warps(c, 128), w), changed
    # a plane of 5 x 9 = 45 nodes: warp 1 holds 13 and is not bare
    part = torch.full((2, 5, 9), 0x103F, dtype=torch.int32)
    assert torch.equal(mt.forward_bare_warps(part, 64),
                       torch.tensor([[True, False]] * 2))
    with pytest.raises(ValueError, match="warps"):
        mt.forward_bare_warps(part, 48)
