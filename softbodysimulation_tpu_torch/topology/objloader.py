"""Minimal Wavefront OBJ loader (vertices + triangulated faces).

The reference ships OBJ assets (LowResBunny.obj: 2503 v / 4968 f, spot.obj)
loaded by Unity's importer; this is our importer.  Supports `v` and `f`
records, 1-based and negative indices, `v/vt/vn` forms, and fan-triangulates
polygons.
"""

from __future__ import annotations

import numpy as np

from .mesh import TriMesh


def load_obj(path: str) -> TriMesh:
    verts = []
    faces = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                parts = line.split()[1:]
                idx = []
                for p in parts:
                    s = p.split("/")[0]
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts:
        raise ValueError(f"no vertices in OBJ file {path!r}")
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))
