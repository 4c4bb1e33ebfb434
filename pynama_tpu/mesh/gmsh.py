"""Gmsh .msh reader (ASCII, MSH 2.2 and 4.1) for the unstructured path.

Replacement for the reference's `DMPlex.createFromFile` gmsh
import (`src/domain/dmplex.py:390-394` GmshDom). The parser extracts what
spectral-element quad/hex meshes need: vertex coordinates, quad (type 3) /
hex (type 5) corner connectivity, and physical-group-labeled boundary
entities (lines in 2D, surface quads in 3D) — everything else (parametric
coords, higher-order gmsh nodes) is ignored or rejected with a clear error.

Output contract (`GmshData`):
  2D: vertices (V,2), quads (C,4) CCW cells, lines {name: (B,2) segments}
  3D: vertices (V,3), hexes (C,8) gmsh corner order,
      surfaces {name: (B,4) boundary quads}
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: gmsh element type -> number of nodes (only the ones we care about)
_GMSH_LINE = 1
_GMSH_QUAD = 3
_GMSH_HEX = 5
_GMSH_NNODES = {1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5, 8: 3, 9: 6,
                10: 9, 11: 10, 15: 1, 16: 8, 17: 20}


@dataclasses.dataclass
class GmshData:
    vertices: np.ndarray    # (V, 2) for 2D quad meshes, (V, 3) for hexes
    quads: np.ndarray       # 2D: (C, 4) cells; 3D: unused (see surfaces)
    lines: dict             # 2D: name -> (B, 2) boundary segments
    hexes: np.ndarray = None        # 3D: (C, 8) hex cells
    surfaces: dict = None           # 3D: name -> (B, 4) boundary quads

    @property
    def is_3d(self) -> bool:
        return self.hexes is not None and len(self.hexes)


def read_msh(path: str) -> GmshData:
    """Parse an ASCII .msh file (auto-detects MSH 2.2 vs 4.1)."""
    with open(path) as f:
        text = f.read()
    sections = _split_sections(text)
    if "MeshFormat" not in sections:
        raise ValueError(f"{path}: not a gmsh file (no $MeshFormat)")
    version = float(sections["MeshFormat"][0].split()[0])
    phys = _parse_physical_names(sections.get("PhysicalNames"))
    if version >= 4.0:
        return _parse_v4(sections, phys)
    return _parse_v2(sections, phys)


def _split_sections(text: str) -> dict:
    sections = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            end = f"$End{name}"
            j = i + 1
            body = []
            while j < len(lines) and lines[j].strip() != end:
                body.append(lines[j].strip())
                j += 1
            sections[name] = body
            i = j + 1
        else:
            i += 1
    return sections


def _parse_physical_names(body) -> dict:
    """-> {(dim, tag): name}"""
    if not body:
        return {}
    out = {}
    for line in body[1:]:
        parts = line.split(None, 2)
        if len(parts) < 3:
            continue
        d, tag = int(parts[0]), int(parts[1])
        out[(d, tag)] = parts[2].strip().strip('"')
    return out


# --------------------------------------------------------------- MSH 2.2
def _parse_v2(sections, phys) -> GmshData:
    node_body = sections["Nodes"]
    n = int(node_body[0])
    tags = np.empty(n, dtype=np.int64)
    xyz = np.empty((n, 3))
    for k, line in enumerate(node_body[1:1 + n]):
        parts = line.split()
        tags[k] = int(parts[0])
        xyz[k] = [float(v) for v in parts[1:4]]
    tag2idx = {int(t): k for k, t in enumerate(tags)}

    quads, lines_acc, hexes, quad_names = [], {}, [], []
    elem_body = sections["Elements"]
    ne = int(elem_body[0])
    for line in elem_body[1:1 + ne]:
        parts = [int(v) for v in line.split()]
        etype, ntags = parts[1], parts[2]
        ptag = parts[3] if ntags >= 1 else 0
        conn = parts[3 + ntags:]
        if etype == _GMSH_QUAD:
            quads.append([tag2idx[c] for c in conn[:4]])
            quad_names.append(phys.get((2, ptag), "boundary"))
        elif etype == _GMSH_HEX:
            hexes.append([tag2idx[c] for c in conn[:8]])
        elif etype == _GMSH_LINE:
            name = phys.get((1, ptag), "boundary")
            lines_acc.setdefault(name, []).append(
                [tag2idx[c] for c in conn[:2]])
    return _finish(xyz, tags, quads, lines_acc, hexes, quad_names)


# --------------------------------------------------------------- MSH 4.1
def _parse_v4(sections, phys) -> GmshData:
    # entity tag -> physical tags (curves dim 1, surfaces dim 2)
    curve_phys, surf_phys = {}, {}
    ent = sections.get("Entities")
    if ent:
        counts = [int(v) for v in ent[0].split()]
        np_, nc, ns = counts[0], counts[1], counts[2]
        for line in ent[1 + np_:1 + np_ + nc]:
            parts = line.split()
            tag = int(parts[0])
            nphys = int(parts[7])
            ptags = [int(v) for v in parts[8:8 + nphys]]
            if ptags:
                curve_phys[tag] = ptags[0]
        for line in ent[1 + np_ + nc:1 + np_ + nc + ns]:
            parts = line.split()
            tag = int(parts[0])
            nphys = int(parts[7])
            ptags = [int(v) for v in parts[8:8 + nphys]]
            if ptags:
                surf_phys[tag] = ptags[0]

    node_body = sections["Nodes"]
    hdr = [int(v) for v in node_body[0].split()]
    nblocks, ntotal = hdr[0], hdr[1]
    tags = np.empty(ntotal, dtype=np.int64)
    xyz = np.empty((ntotal, 3))
    i, k = 1, 0
    for _ in range(nblocks):
        bn = int(node_body[i].split()[3])
        for b in range(bn):
            tags[k + b] = int(node_body[i + 1 + b])
        for b in range(bn):
            xyz[k + b] = [float(v)
                          for v in node_body[i + 1 + bn + b].split()[:3]]
        k += bn
        i += 1 + 2 * bn
    tag2idx = {int(t): j for j, t in enumerate(tags)}

    quads, lines_acc, hexes, quad_names = [], {}, [], []
    elem_body = sections["Elements"]
    hdr = [int(v) for v in elem_body[0].split()]
    nblocks = hdr[0]
    i = 1
    for _ in range(nblocks):
        edim, etag, etype, bn = [int(v) for v in elem_body[i].split()]
        nn = _GMSH_NNODES.get(etype)
        if nn is None:
            raise ValueError(f"unsupported gmsh element type {etype}")
        for b in range(bn):
            parts = [int(v) for v in elem_body[i + 1 + b].split()]
            conn = parts[1:1 + nn]
            if etype == _GMSH_QUAD:
                quads.append([tag2idx[c] for c in conn[:4]])
                ptag = surf_phys.get(etag)
                quad_names.append(
                    phys.get((2, ptag), "boundary") if ptag else "boundary")
            elif etype == _GMSH_HEX:
                hexes.append([tag2idx[c] for c in conn[:8]])
            elif etype == _GMSH_LINE:
                ptag = curve_phys.get(etag)
                name = phys.get((1, ptag), "boundary") if ptag else "boundary"
                lines_acc.setdefault(name, []).append(
                    [tag2idx[c] for c in conn[:2]])
        i += 1 + bn
    return _finish(xyz, tags, quads, lines_acc, hexes, quad_names)


def _finish(xyz, tags, quads, lines_acc, hexes=(), quad_names=()) -> GmshData:
    if len(hexes):
        # 3D hex mesh: the quads are boundary faces, grouped by their
        # physical surface name
        surfaces = {}
        for q, name in zip(quads, quad_names):
            surfaces.setdefault(name, []).append(q)
        return GmshData(
            vertices=xyz.copy(),
            quads=np.zeros((0, 4), dtype=np.int32),
            lines={},
            hexes=np.asarray(hexes, dtype=np.int32),
            surfaces={k: np.asarray(v, dtype=np.int32)
                      for k, v in surfaces.items()})
    if not quads:
        raise ValueError("no quad (type-3) or hex (type-5) elements found; "
                         "only quad/hex meshes are supported")
    z = xyz[:, 2]
    if np.abs(z - z[0]).max() > 1e-12:
        raise ValueError("2D mesh is not planar (and no hex cells found)")
    lines = {k: np.asarray(v, dtype=np.int32) for k, v in lines_acc.items()}
    return GmshData(vertices=xyz[:, :2].copy(),
                    quads=np.asarray(quads, dtype=np.int32),
                    lines=lines)
