"""The port's scene loaders against the reference's, file for file.

Each case of ``tests/test_scene_formats.py`` writes its model file once and
reads it with both packages: vertices, triangles, surface ids and material
names must be equal exactly.  A hall written by ``save_obj`` and read back by
``load_scene`` must be simulation-ready in the port.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_scene_formats import (BOX, DAE_DOC, DXF_DOC, _assert_same_geometry,
                                _box_arrays, _fbx_doc)
from wayverb_tpu.core import scene as jscene
from wayverb_tpu.core.surfaces import Surface as JSurface
from wayverb_tpu_torch.core import scene as tscene
from wayverb_tpu_torch.core.surfaces import Surface
from wayverb_tpu_torch.raytracer import scenes as tscenes

torch.set_num_threads(2)


def _ply_header(n_verts, n_tris, fmt="ascii"):
    return (f"ply\nformat {fmt} 1.0\ncomment box\n"
            f"element vertex {n_verts}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {n_tris}\n"
            "property list uchar int vertex_indices\nend_header\n")


def _write_ply_ascii(path):
    verts, tris = _box_arrays()
    with open(path, "w") as f:
        f.write(_ply_header(len(verts), len(tris)))
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def _write_ply_binary(path):
    verts, tris = _box_arrays()
    with open(path, "wb") as f:
        f.write(_ply_header(len(verts), len(tris),
                            "binary_little_endian").encode())
        f.write(verts.astype("<f4").tobytes())
        for t in tris:
            f.write(struct.pack("<B3i", 3, *t))


def _write_ply_shuffled(path):
    path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 3\n"
        "property float confidence\n"
        "property float z\nproperty float x\nproperty float y\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n0.9 30 10 20\n0.9 31 11 21\n0.9 32 12 22\n3 0 1 2\n")


def _write_stl_binary(path):
    verts, tris = _box_arrays()
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0, 0, 0))
            for vi in t:
                f.write(verts[vi].astype("<f4").tobytes())
            f.write(struct.pack("<H", 0))


def _write_stl_ascii(path):
    verts, tris = _box_arrays()
    with open(path, "w") as f:
        f.write("solid box\n")
        for t in tris:
            f.write("facet normal 0 0 0\nouter loop\n")
            for vi in t:
                v = verts[vi]
                f.write(f"vertex {v[0]} {v[1]} {v[2]}\n")
            f.write("endloop\nendfacet\n")
        f.write("endsolid box\n")


def _write_off(path):
    verts, tris = _box_arrays()
    with open(path, "w") as f:
        f.write(f"OFF\n{len(verts)} {len(tris) - 1} 0\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        f.write("# a quad, fan-triangulated\n")
        for t in tris[:-2]:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
        a, b, c = tris[-2]
        f.write(f"4 {a} {b} {c} {tris[-1][2]}\n")


def _write_obj(path):
    """Two materials, a quad, a negative (relative) index, v/vt/vn tokens."""
    path.write_text(
        "# a floor quad and a wall triangle\n"
        "v 0 0 0\nv 2 0 0\nv 2 1 0\nv 0 1 0\nv 0 0 3\n"
        "usemtl floor\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "usemtl wall\nf 1 2 -1\nusemtl floor\nf 3 4 5\n")


# (file name, writer, loader name, triangles, material names, is the box)
CASES = [
    ("box_ascii.ply", _write_ply_ascii, "load_ply", 12, ["default"], True),
    ("box_binary.ply", _write_ply_binary, "load_ply", 12, ["default"], True),
    ("shuffled.ply", _write_ply_shuffled, "load_ply", 1, ["default"], False),
    ("box_binary.stl", _write_stl_binary, "load_stl", 12, ["default"], True),
    ("box_ascii.stl", _write_stl_ascii, "load_stl", 12, ["default"], True),
    ("box.off", _write_off, "load_off", 12, ["default"], True),
    ("room.obj", _write_obj, "load_obj", 4, ["default", "floor", "wall"],
     False),
    ("room.dae", lambda p: p.write_text(DAE_DOC), "load_dae", 3,
     ["wall", "floor"], False),
    ("room.dxf", lambda p: p.write_text(DXF_DOC), "load_dxf", 3,
     ["wall", "floor"], False),
    ("room.fbx", lambda p: p.write_bytes(_fbx_doc()), "load_fbx", 2,
     ["geometry_0"], False),
    ("room75.fbx", lambda p: p.write_bytes(_fbx_doc(7500)), "load_fbx", 2,
     ["geometry_0"], False),
]


@pytest.mark.parametrize("name,write,loader,n_tris,materials,is_box", CASES,
                         ids=[c[0] for c in CASES])
def test_loader_matches_reference(tmp_path, name, write, loader, n_tris,
                                  materials, is_box):
    path = tmp_path / name
    write(path)
    want = getattr(jscene, loader)(str(path))
    for got in (getattr(tscene, loader)(str(path)),
                tscene.load_scene(str(path))):
        assert got.material_names == want.material_names == materials
        for f in ("vertices", "triangles", "surfaces"):
            g, w = getattr(got.soup, f), np.asarray(getattr(want.soup, f))
            assert g.device.type == "cpu" and g.numpy().dtype == w.dtype, f
            assert np.array_equal(g.numpy(), w), f
        assert got.soup.num_triangles == n_tris
    if is_box:
        verts, tris = _box_arrays()
        _assert_same_geometry(got.soup, verts, tris)


@pytest.mark.parametrize("name,content,match", [
    ("scene.xyz", None, "unsupported scene format"),
    ("x.3ds", None, "dae"),
    ("room.fbx", b"; FBX 7.4.0 project file (ASCII)", "binary"),
    ("bad.ply", b"plx\n", "not a PLY"),
    ("bad.off", b"COFF\n0 0 0\n", "not an OFF"),
    ("range.obj", b"v 0 0 0\nv 1 0 0\nf 1 2 7\n", "out of range"),
    ("empty.dxf", b"0\nSECTION\n0\nEOF\n", "no 3DFACE"),
    ("listskip.ply",
     ("ply\nformat binary_little_endian 1.0\nelement custom 1\n"
      "property list uchar int stuff\nelement vertex 3\n"
      "property float x\nproperty float y\nproperty float z\n"
      "element face 1\nproperty list uchar int vertex_indices\n"
      "end_header\n").encode() + struct.pack("<Bi", 1, 7)
     + struct.pack("<9f", *range(9)) + struct.pack("<B3i", 3, 0, 1, 2),
     "list property"),
])
def test_malformed_files_raise_as_in_reference(tmp_path, name, content,
                                               match):
    path = tmp_path / name
    if content is not None:
        path.write_bytes(content)
    for load in (jscene.load_scene, tscene.load_scene):
        with pytest.raises(ValueError, match=match):
            load(str(path))


def test_with_surfaces_matches_reference(tmp_path):
    path = tmp_path / "room.obj"
    _write_obj(path)
    jsd, tsd = jscene.load_obj(str(path)), tscene.load_obj(str(path))
    rng = np.random.default_rng(1)
    tables = {n: (rng.uniform(0.05, 0.5, 8).astype(np.float32),
                  rng.uniform(0.05, 0.5, 8).astype(np.float32))
              for n in tsd.material_names}
    want = jsd.with_surfaces({n: JSurface(jnp.asarray(a), jnp.asarray(s))
                              for n, (a, s) in tables.items()})
    got = tsd.with_surfaces({n: Surface(torch.from_numpy(a),
                                        torch.from_numpy(s))
                             for n, (a, s) in tables.items()})
    assert np.array_equal(got.absorption.numpy(), np.asarray(want.absorption))
    assert np.array_equal(got.scattering.numpy(), np.asarray(want.scattering))
    a, s = tables["wall"]
    one = tsd.with_surfaces(Surface(torch.from_numpy(a), torch.from_numpy(s)))
    assert one.absorption.shape == (3, 8)
    assert np.array_equal(one.scattering.numpy(), np.tile(s, (3, 1)))
    with pytest.raises(KeyError, match="floor"):
        tsd.with_surfaces({"default": one, "wall": one})


def test_saved_hall_loads_back_simulation_ready(tmp_path):
    """A hall above 100 triangles written by ``save_obj`` and read by
    ``load_scene`` (of either package) is the same soup, and the port's
    engine accepts it: a general mesh, the voxel DDA on the CPU."""
    from wayverb_tpu_torch.combined import engine as teng
    from wayverb_tpu_torch.raytracer.accel import RayGrid
    soup, n = tscenes.procedural_hall(3, 2, 1)
    path = tmp_path / "hall.obj"
    tscene.save_obj(str(path), tscene.SceneData(soup, ["default"]))
    back = tscene.load_scene(str(path))
    assert back.material_names == ["default"]
    for f in ("vertices", "triangles", "surfaces"):
        assert torch.equal(getattr(back.soup, f), getattr(soup, f)), f
    ref = jscene.load_scene(str(path))
    assert np.array_equal(np.asarray(ref.soup.vertices),
                          back.soup.vertices.numpy())
    # the reference writes the same file but for its banner line
    jpath = tmp_path / "hall_ref.obj"
    jscene.save_obj(str(jpath), ref)
    assert path.read_text().splitlines()[1:] == \
        jpath.read_text().splitlines()[1:]
    surfaces = back.with_surfaces(Surface.uniform(0.1, 0.1))
    e = teng.Engine(back.soup, surfaces,
                    teng.WaveguideParameters(cutoff=200.0,
                                             usable_portion=0.6),
                    device="cpu")
    assert e.mesh.box_spec is None and isinstance(e.ray_grid, RayGrid)
    volume = float(np.prod((20.0, 8.0, 15.0)))
    assert e.mesh.room_volume == pytest.approx(volume, rel=0.05)


def test_loaded_box_voxelises_like_the_programmatic_one(tmp_path):
    """The reference's simulation-ready case on the port: a loaded PLY box
    classifies to the box's volume."""
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    path = tmp_path / "box.ply"
    _write_ply_ascii(path)
    scene = tscene.load_scene(str(path))
    fs = 3333.33
    mesh = wgrun.compute_mesh(scene.soup, np.full((1, 8), 0.1),
                              grid_spacing(340.0, 1.0 / fs), fs, device="cpu")
    d = np.subtract(BOX.max_corner, BOX.min_corner)
    np.testing.assert_allclose(mesh.room_volume, float(np.prod(d)), rtol=0.15)
