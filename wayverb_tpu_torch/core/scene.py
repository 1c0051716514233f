"""Scene loading: model files → TriangleSoup + material table.

Port of ``wayverb_tpu.core.scene`` (host-only parsing; the soups lie on the
CPU).  The reference C++ uses assimp for many formats
(``core/scene_data_loader.h``); here are dependency-free parsers for
OBJ/MTL (the format of the reference's own test models), PLY, STL, OFF,
COLLADA, DXF and binary FBX.  Polygonal faces are fan-triangulated.
Materials map to surface indices in declaration order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from wayverb_tpu_torch.core.geometry import TriangleSoup
from wayverb_tpu_torch.core.surfaces import Surface


@dataclasses.dataclass
class SceneData:
    """Geometry + named material slots (the editable scene model)."""

    soup: TriangleSoup
    material_names: List[str]

    def with_surfaces(self, surfaces: Dict[str, Surface] | Surface) -> Surface:
        """Build the (num_materials, bands) surface table.

        Accepts either one Surface applied to every material or a dict from
        material name to Surface.
        """
        if isinstance(surfaces, Surface):
            n = len(self.material_names)
            return Surface(surfaces.absorption[None, :].repeat(n, 1),
                           surfaces.scattering[None, :].repeat(n, 1))
        missing = [n for n in self.material_names if n not in surfaces]
        if missing:
            raise KeyError(f"no surface given for materials {missing}")
        absorption = torch.stack(
            [surfaces[n].absorption for n in self.material_names])
        scattering = torch.stack(
            [surfaces[n].scattering for n in self.material_names])
        return Surface(absorption, scattering)


def load_obj(path: str) -> SceneData:
    """Parse an OBJ file into a SceneData (vertices, triangles, materials)."""
    vertices: List[Tuple[float, float, float]] = []
    triangles: List[Tuple[int, int, int]] = []
    tri_materials: List[int] = []
    material_names: List[str] = []
    mat_index: Dict[str, int] = {}
    current_material = _get_material(mat_index, material_names, "default")

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                vertices.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "usemtl":
                name = parts[1] if len(parts) > 1 else "default"
                current_material = _get_material(
                    mat_index, material_names, name)
            elif tag == "f":
                idx = [_vertex_index(p, len(vertices)) for p in parts[1:]]
                for i in range(1, len(idx) - 1):
                    triangles.append((idx[0], idx[i], idx[i + 1]))
                    tri_materials.append(current_material)

    tri_arr = np.asarray(triangles, dtype=np.int32)
    if tri_arr.size and (tri_arr.min() < 0 or tri_arr.max() >= len(vertices)):
        raise ValueError(
            f"{path}: face references vertex index out of range "
            f"(have {len(vertices)} vertices)")
    return _scene(vertices, tri_arr, tri_materials, material_names)


def save_obj(path: str, scene: SceneData) -> None:
    """Write geometry back out as OBJ (re-export parity with the reference)."""
    soup = scene.soup
    verts = soup.vertices.cpu().numpy()
    tris = soup.triangles.cpu().numpy()
    mats = soup.surfaces.cpu().numpy()
    with open(path, "w") as f:
        f.write("# exported by wayverb_tpu_torch\n")
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        last_mat = -1
        for t, m in zip(tris, mats):
            if m != last_mat:
                f.write(f"usemtl {scene.material_names[m]}\n")
                last_mat = m
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


def _get_material(index: Dict[str, int], names: List[str], name: str) -> int:
    if name not in index:
        index[name] = len(names)
        names.append(name)
    return index[name]


def _vertex_index(token: str, num_vertices: int) -> int:
    i = int(token.split("/")[0])
    return i - 1 if i > 0 else num_vertices + i


# ---------------------------------------------------------------------------
# additional mesh formats (reference: assimp handles obj/ply/stl/off/dae…,
# ``core/src/scene_data_loader.cpp:100``; these dependency-free parsers
# cover the common interchange formats so scene import does not hinge on
# OBJ alone)

def load_ply(path: str) -> SceneData:
    """Parse a PLY file (ascii or binary_little/big_endian, triangulated
    or polygonal faces — fan-triangulated like the OBJ path)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str, str]]]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    # ("list", count_type, index_type)
                    elements[-1][2].append(("list", parts[2], parts[3]))
                else:
                    # ("scalar", name, type)
                    elements[-1][2].append(("scalar", parts[-1], parts[1]))
            elif parts[0] == "end_header":
                break
        if fmt is None:
            raise ValueError(f"{path}: PLY header has no format line")

        _T = {"char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
              "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
              "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
              "float": "f4", "float32": "f4",
              "double": "f8", "float64": "f8"}
        endian = {"ascii": "=", "binary_little_endian": "<",
                  "binary_big_endian": ">"}[fmt]

        vertices = None
        faces: List[List[int]] = []
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    if any(p[0] == "list" for p in props):
                        raise ValueError(
                            f"{path}: PLY vertex element with a list "
                            "property is unsupported (token positions "
                            "would be ambiguous)")
                    # column index BY NAME — a file declaring properties
                    # in a non-(x, y, z) order must not scramble
                    # coordinates
                    col = {pr[1]: i for i, pr in enumerate(props)}
                    for ax in ("x", "y", "z"):
                        if ax not in col:
                            raise ValueError(
                                f"{path}: vertex element lacks '{ax}'")
                    vertices = np.asarray(
                        [[float(r[col[ax]]) for ax in ("x", "y", "z")]
                         for r in rows], dtype=np.float32)
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        faces.append([int(v) for v in r[1:1 + n]])
            else:
                if name == "vertex":
                    if not all(p[0] == "scalar" for p in props):
                        raise ValueError(
                            f"{path}: PLY vertex element with a list "
                            "property is unsupported")
                    dt = np.dtype([(p[1], endian + _T[p[2]])
                                   for p in props])
                    data = np.frombuffer(f.read(dt.itemsize * count), dt)
                    vertices = np.stack(
                        [data["x"], data["y"], data["z"]],
                        axis=-1).astype(np.float32)
                elif name == "face":
                    for _ in range(count):
                        # per-row read: list lengths may vary
                        ldt = np.dtype(endian + _T[props[0][1]])
                        n = int(np.frombuffer(f.read(ldt.itemsize),
                                              ldt)[0])
                        idt = np.dtype(endian + _T[props[0][2]])
                        faces.append(np.frombuffer(
                            f.read(idt.itemsize * n), idt).tolist())
                else:
                    # skip unneeded elements — but only when their size
                    # is knowable: a list property would desynchronize
                    # the stream and silently corrupt later elements
                    if any(p[0] == "list" for p in props):
                        raise ValueError(
                            f"{path}: cannot skip PLY element "
                            f"'{name}' containing a list property")
                    size = sum(np.dtype(endian + _T[p[2]]).itemsize
                               for p in props)
                    f.read(size * count)

    if vertices is None:
        raise ValueError(f"{path}: PLY file has no vertex element")
    triangles = []
    for face in faces:
        for i in range(1, len(face) - 1):
            triangles.append((face[0], face[i], face[i + 1]))
    return _soup_scene(vertices, triangles, path)


def load_stl(path: str) -> SceneData:
    """Parse an STL file (ascii or binary), welding duplicate vertices so
    the soup is usable for inside/outside classification."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        data = f.read()
    is_ascii = head == b"solid" and b"facet" in data[:1000]
    tris = []
    if is_ascii:
        cur: List[Tuple[float, float, float]] = []
        for line in data.decode("ascii", "replace").splitlines():
            parts = line.split()
            if parts[:1] == ["vertex"]:
                cur.append(tuple(float(x) for x in parts[1:4]))
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
    else:
        if len(data) < 84:
            raise ValueError(f"{path}: truncated binary STL")
        n = int(np.frombuffer(data[80:84], "<u4")[0])
        rec = np.dtype([("normal", "<f4", 3), ("v", "<f4", (3, 3)),
                        ("attr", "<u2")])
        body = np.frombuffer(data[84:84 + rec.itemsize * n], rec)
        tris = body["v"].tolist()
    flat = np.asarray(tris, dtype=np.float32).reshape(-1, 3)
    verts, inverse = np.unique(flat, axis=0, return_inverse=True)
    triangles = inverse.reshape(-1, 3).tolist()
    return _soup_scene(verts.astype(np.float32), triangles, path)


def load_off(path: str) -> SceneData:
    """Parse an OFF file (ascii)."""
    with open(path) as f:
        tokens: List[str] = []
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                tokens.extend(line.split())
    if not tokens or tokens[0] != "OFF":
        raise ValueError(f"{path}: not an OFF file")
    nv, nf = int(tokens[1]), int(tokens[2])
    pos = 4
    vertices = np.asarray(tokens[pos:pos + 3 * nv],
                          dtype=np.float32).reshape(nv, 3)
    pos += 3 * nv
    triangles = []
    for _ in range(nf):
        n = int(tokens[pos])
        face = [int(t) for t in tokens[pos + 1:pos + 1 + n]]
        pos += 1 + n
        for i in range(1, len(face) - 1):
            triangles.append((face[0], face[i], face[i + 1]))
    return _soup_scene(vertices, triangles, path)


def load_dae(path: str) -> SceneData:
    """COLLADA (.dae) loader: <library_geometries> triangles/polylist
    primitives with per-primitive material slots (reference loads DAE via
    assimp, ``src/core/src/scene_data_loader.cpp:100``; this is a direct
    stdlib-XML reader for the geometry subset a room model needs —
    <triangles> and convex <polylist> fan-triangulated, Y-up/Z-up spaces
    passed through untransformed)."""
    import xml.etree.ElementTree as ET

    tree = ET.parse(path)
    root = tree.getroot()
    # namespace-agnostic tag matcher (COLLADA 1.4/1.5 namespaces differ)
    def tag(e):
        return e.tag.rsplit("}", 1)[-1]

    def findall(e, name):
        return [c for c in e.iter() if tag(c) == name]

    vertices = []
    triangles = []
    surfaces = []
    material_names = []
    mat_slot = {}

    def slot(name):
        if name not in mat_slot:
            mat_slot[name] = len(material_names)
            material_names.append(name)
        return mat_slot[name]

    for geom in findall(root, "geometry"):
        meshes = findall(geom, "mesh")
        if not meshes:
            continue
        mesh = meshes[0]
        # id -> float_array positions
        sources = {}
        for src in findall(mesh, "source"):
            arrs = findall(src, "float_array")
            if arrs:
                sources["#" + src.get("id", "")] = np.array(
                    (arrs[0].text or "").split(),
                    dtype=np.float64).reshape(-1, 3)
        # <vertices> indirection
        vert_src = {}
        for v in findall(mesh, "vertices"):
            for inp in findall(v, "input"):
                if inp.get("semantic") == "POSITION":
                    vert_src["#" + v.get("id", "")] = sources.get(
                        inp.get("source"), np.zeros((0, 3)))

        for prim in list(mesh):
            name = tag(prim)
            if name not in ("triangles", "polylist"):
                continue
            pos = None
            stride = 1
            offset = 0
            for inp in findall(prim, "input"):
                stride = max(stride, int(inp.get("offset", 0)) + 1)
                if inp.get("semantic") == "VERTEX":
                    offset = int(inp.get("offset", 0))
                    pos = vert_src.get(inp.get("source")) \
                        if inp.get("source") in vert_src \
                        else sources.get(inp.get("source"))
            if pos is None or pos.size == 0:
                continue
            base = len(vertices)
            vertices.extend(pos.tolist())
            sid = slot(prim.get("material") or "default")
            ps = findall(prim, "p")
            if not ps or not ps[0].text:
                continue
            idx = np.array(ps[0].text.split(), dtype=np.int64)
            vidx = idx[offset::stride]
            if name == "triangles":
                faces = vidx.reshape(-1, 3)
                for f in faces:
                    triangles.append((base + f[0], base + f[1],
                                      base + f[2]))
                    surfaces.append(sid)
            else:                              # polylist: fan-triangulate
                counts = np.array(
                    findall(prim, "vcount")[0].text.split(),
                    dtype=np.int64)
                k = 0
                for c in counts:
                    poly = vidx[k:k + c]
                    k += c
                    for i in range(1, int(c) - 1):
                        triangles.append((base + poly[0], base + poly[i],
                                          base + poly[i + 1]))
                        surfaces.append(sid)

    if not triangles:
        raise ValueError(f"{path}: no triangle geometry found")
    tri_arr = np.asarray(triangles, dtype=np.int32)
    if tri_arr.min() < 0 or tri_arr.max() >= len(vertices):
        raise ValueError(f"{path}: face references out-of-range vertex")
    return _scene(vertices, tri_arr, surfaces,
                  material_names or ["default"])


def load_dxf(path: str) -> SceneData:
    """AutoCAD DXF loader: 3DFACE entities (+ closed POLYLINE meshes are
    out of scope) — the common interchange form for room shells
    (reference loads DXF via assimp, ``scene_data_loader.cpp:100``).
    DXF is group-code/value pairs; a 3DFACE carries four corners
    (10/20/30 .. 13/23/33); triangular faces repeat the last corner.
    Faces map to material slots by their layer name (group 8)."""
    vertices = []
    triangles = []
    surfaces = []
    material_names = []
    mat_slot = {}

    def slot(name):
        if name not in mat_slot:
            mat_slot[name] = len(material_names)
            material_names.append(name)
        return mat_slot[name]

    with open(path, "r", errors="replace") as fh:
        lines = [ln.strip() for ln in fh]
    i = 0
    n = len(lines)
    while i + 1 < n:
        code, value = lines[i], lines[i + 1]
        i += 2
        if code != "0" or value.upper() != "3DFACE":
            continue
        corners = {}
        layer = "default"
        while i + 1 < n:
            code, value = lines[i], lines[i + 1]
            if code == "0":
                break
            i += 2
            if code == "8":
                layer = value or "default"
                continue
            try:
                gc = int(code)
            except ValueError:
                continue
            if 10 <= gc <= 13 or 20 <= gc <= 23 or 30 <= gc <= 33:
                corners[gc] = float(value)
        pts = []
        for k in range(4):
            if 10 + k in corners:
                pts.append((corners.get(10 + k, 0.0),
                            corners.get(20 + k, 0.0),
                            corners.get(30 + k, 0.0)))
        if len(pts) < 3:
            continue
        sid = slot(layer)
        base = len(vertices)
        vertices.extend(pts)
        triangles.append((base, base + 1, base + 2))
        surfaces.append(sid)
        if len(pts) == 4 and pts[3] != pts[2]:
            triangles.append((base, base + 2, base + 3))
            surfaces.append(sid)

    if not triangles:
        raise ValueError(f"{path}: no 3DFACE geometry found")
    return _scene(vertices, np.asarray(triangles, dtype=np.int32), surfaces,
                  material_names or ["default"])


def load_fbx(path: str) -> SceneData:
    """Binary FBX (Kaydara 7.x) loader: Geometry nodes' ``Vertices`` +
    ``PolygonVertexIndex`` records, fan-triangulated (negative index =
    XOR-complemented last corner of a polygon, per the format).  Handles
    the 7.5+ 64-bit record headers and zlib-compressed array properties
    with stdlib ``zlib`` (reference loads FBX via assimp,
    ``scene_data_loader.cpp:100``).  Each Geometry maps to one material
    slot (per-polygon material layers are collapsed)."""
    import struct
    import zlib

    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(b"Kaydara FBX Binary"):
        raise ValueError(f"{path}: not a binary FBX file (ASCII FBX is "
                         "not supported; re-export as binary)")
    version = struct.unpack("<I", data[23:27])[0]
    wide = version >= 7500            # 7.5+: 64-bit record headers
    word = "<QQQ" if wide else "<III"
    wlen = 25 if wide else 13

    def read_array(buf, off, fmt, size):
        n, enc, comp = struct.unpack("<III", buf[off:off + 12])
        off += 12
        if enc == 0:
            raw = buf[off:off + n * size]
            off += n * size
        else:
            raw = zlib.decompress(buf[off:off + comp])
            off += comp
        return list(struct.unpack(f"<{n}{fmt}", raw)), off

    def read_props(buf, off, count):
        props = []
        for _ in range(count):
            t = buf[off:off + 1]
            off += 1
            if t in (b"Y",):
                props.append(struct.unpack("<h", buf[off:off + 2])[0])
                off += 2
            elif t in (b"C",):
                props.append(bool(buf[off]))
                off += 1
            elif t in (b"I",):
                props.append(struct.unpack("<i", buf[off:off + 4])[0])
                off += 4
            elif t in (b"F",):
                props.append(struct.unpack("<f", buf[off:off + 4])[0])
                off += 4
            elif t in (b"D",):
                props.append(struct.unpack("<d", buf[off:off + 8])[0])
                off += 8
            elif t in (b"L",):
                props.append(struct.unpack("<q", buf[off:off + 8])[0])
                off += 8
            elif t in (b"S", b"R"):
                n = struct.unpack("<I", buf[off:off + 4])[0]
                props.append(buf[off + 4:off + 4 + n])
                off += 4 + n
            elif t == b"f":
                arr, off = read_array(buf, off, "f", 4)
                props.append(arr)
            elif t == b"d":
                arr, off = read_array(buf, off, "d", 8)
                props.append(arr)
            elif t == b"i":
                arr, off = read_array(buf, off, "i", 4)
                props.append(arr)
            elif t == b"l":
                arr, off = read_array(buf, off, "q", 8)
                props.append(arr)
            elif t == b"b":
                arr, off = read_array(buf, off, "b", 1)
                props.append(arr)
            else:
                raise ValueError(f"{path}: unknown FBX property "
                                 f"type {t!r}")
        return props, off

    def read_node(buf, off):
        end, num_props, _plen = struct.unpack(word,
                                              buf[off:off + 3 * (8 if wide
                                                                 else 4)])
        off += 3 * (8 if wide else 4)
        if end == 0:
            return None, off
        name_len = buf[off]
        off += 1
        name = buf[off:off + name_len].decode("ascii", "replace")
        off += name_len
        props, off = read_props(buf, off, num_props)
        children = []
        while off < end - wlen:
            child, off = read_node(buf, off)
            if child is None:
                break
            children.append(child)
        if off < end:
            off = end                  # skip the null sentinel
        return (name, props, children), off

    off = 27
    top = []
    while off < len(data) - wlen:
        node, off = read_node(data, off)
        if node is None:
            break
        top.append(node)

    def iter_named(nodes, name):
        for n in nodes:
            if n[0] == name:
                yield n
            yield from iter_named(n[2], name)

    vertices = []
    triangles = []
    surfaces = []
    material_names = []
    for gi, geom in enumerate(iter_named(top, "Geometry")):
        verts = polys = None
        for child in geom[2]:
            if child[0] == "Vertices" and child[1]:
                verts = child[1][0]
            elif child[0] == "PolygonVertexIndex" and child[1]:
                polys = child[1][0]
        if not verts or not polys:
            continue
        base = len(vertices)
        vertices.extend(np.asarray(verts, dtype=np.float64)
                        .reshape(-1, 3).tolist())
        sid = len(material_names)
        material_names.append(f"geometry_{gi}")
        poly = []
        for idx in polys:
            last = idx < 0
            poly.append(~idx if last else idx)
            if last:
                for i in range(1, len(poly) - 1):
                    triangles.append((base + poly[0], base + poly[i],
                                      base + poly[i + 1]))
                    surfaces.append(sid)
                poly = []

    if not triangles:
        raise ValueError(f"{path}: no polygon geometry found")
    tri_arr = np.asarray(triangles, dtype=np.int32)
    if tri_arr.min() < 0 or tri_arr.max() >= len(vertices):
        raise ValueError(f"{path}: face references out-of-range vertex")
    return _scene(vertices, tri_arr, surfaces,
                  material_names or ["default"])


_LOADERS = {".obj": load_obj, ".ply": load_ply, ".stl": load_stl,
            ".off": load_off, ".dae": load_dae, ".dxf": load_dxf,
            ".fbx": load_fbx}


def load_scene(path: str) -> SceneData:
    """Load a scene by file extension (obj/ply/stl/off/dae/dxf/fbx)."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in _LOADERS:
        raise ValueError(
            f"unsupported scene format {ext!r} (have {sorted(_LOADERS)})")
    return _LOADERS[ext](path)


def _soup_scene(vertices, triangles, path) -> SceneData:
    tri_arr = np.asarray(triangles, dtype=np.int32).reshape(-1, 3)
    if tri_arr.size and (tri_arr.min() < 0
                         or tri_arr.max() >= len(vertices)):
        raise ValueError(f"{path}: face references out-of-range vertex")
    return _scene(vertices, tri_arr, np.zeros(tri_arr.shape[0], np.int32),
                  ["default"])


def _scene(vertices, triangles, surfaces, material_names) -> SceneData:
    """A SceneData on the CPU from (V, 3) vertices, (T, 3) int32 vertex
    indices and (T,) material indices."""
    soup = TriangleSoup(
        vertices=torch.from_numpy(
            np.asarray(vertices, dtype=np.float32).reshape(-1, 3)),
        triangles=torch.from_numpy(
            np.asarray(triangles, dtype=np.int32).reshape(-1, 3)),
        surfaces=torch.from_numpy(np.asarray(surfaces, dtype=np.int32)))
    return SceneData(soup=soup, material_names=list(material_names))
