"""Artifact I/O: PLY point clouds and voxel-grid npy/npz files.

The on-disk contracts mirror the reference exactly so artifacts interoperate:
  * semantic/material PLY vertex schema
    (pixie/voxel/segmentation.py:349-355, map_pred_to_coords.py:224-231):
    x,y,z f4 | red,green,blue,alpha u1 | part_label i4 | density,E,nu f4 |
    material_id i4 | [conf f4]
  * voxel artifacts: clip_features_features.npy (D,D,D,768 fp16),
    clip_features_mask.npy (D,D,D), clip_features_rgb.npy, clip_features_alphas.npy,
    material_grid.npy (D,D,D,4: density,E,nu,material_id)
    (pixie/voxel/voxelize.py:86-141, segmentation.py:416-472).

PLY support is self-contained (binary_little_endian 1.0 and ascii) since the
``plyfile`` package is not a dependency.

Carried over unchanged from pixie_tpu/utils/io.py (host numpy).
"""

from __future__ import annotations

import io as _io
from pathlib import Path

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}

# Exact vertex schema of the reference's material PLYs.
MATERIAL_PLY_DTYPE = np.dtype(
    [
        ("x", "f4"), ("y", "f4"), ("z", "f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"), ("alpha", "u1"),
        ("part_label", "i4"), ("density", "f4"), ("E", "f4"), ("nu", "f4"),
        ("material_id", "i4"), ("conf", "f4"),
    ]
)


def read_ply(path: str | Path) -> dict[str, np.ndarray]:
    """Read a PLY file, returning {element_name: structured array}."""
    path = Path(path)
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: missing 'ply' magic")

    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    for line in header[1:]:
        parts = line.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                raise NotImplementedError("PLY list properties are not supported")
            elements[-1][2].append((parts[2], _PLY_TO_NP[parts[1]]))

    out: dict[str, np.ndarray] = {}
    if fmt == "binary_little_endian":
        offset = 0
        for name, count, props in elements:
            dt = np.dtype([(p, "<" + t) for p, t in props])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
            offset += dt.itemsize * count
            out[name] = arr
    elif fmt == "ascii":
        text = body.decode("ascii")
        rows = [r.split() for r in text.splitlines() if r.strip()]
        idx = 0
        for name, count, props in elements:
            dt = np.dtype(props)
            arr = np.empty(count, dtype=dt)
            for i in range(count):
                for (p, _), v in zip(props, rows[idx + i]):
                    arr[p][i] = np.array(v).astype(arr[p].dtype)
            idx += count
            out[name] = arr
    else:
        raise NotImplementedError(f"PLY format {fmt!r} not supported")
    return out


def write_ply(path: str | Path, vertex: np.ndarray, text: bool = False) -> None:
    """Write a structured array as the 'vertex' element of a PLY file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    assert vertex.dtype.names, "write_ply expects a structured array"
    lines = ["ply"]
    lines.append("format ascii 1.0" if text else "format binary_little_endian 1.0")
    lines.append(f"element vertex {len(vertex)}")
    for name in vertex.dtype.names:
        kind = vertex.dtype[name].str.lstrip("<>|=")
        lines.append(f"property {_NP_TO_PLY[kind]} {name}")
    lines.append("end_header")
    header = ("\n".join(lines) + "\n").encode("ascii")

    with open(path, "wb") as f:
        f.write(header)
        if text:
            buf = _io.StringIO()
            for row in vertex:
                buf.write(" ".join(str(v) for v in row) + "\n")
            f.write(buf.getvalue().encode("ascii"))
        else:
            # ensure little-endian, packed layout
            dt = np.dtype([(n, vertex.dtype[n].str.replace(">", "<")) for n in vertex.dtype.names])
            f.write(np.ascontiguousarray(vertex.astype(dt)).tobytes())


def make_material_vertex(
    coords: np.ndarray,
    density: np.ndarray,
    E: np.ndarray,
    nu: np.ndarray,
    material_id: np.ndarray,
    part_label: np.ndarray | None = None,
    conf: np.ndarray | None = None,
    colors: np.ndarray | None = None,
) -> np.ndarray:
    """Build the reference-schema vertex array for a material point cloud."""
    n = len(coords)
    v = np.zeros(n, dtype=MATERIAL_PLY_DTYPE)
    v["x"], v["y"], v["z"] = coords[:, 0], coords[:, 1], coords[:, 2]
    if colors is None:
        v["red"] = v["green"] = v["blue"] = 255
    else:
        v["red"], v["green"], v["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
    v["alpha"] = 255
    v["part_label"] = 0 if part_label is None else part_label
    v["density"], v["E"], v["nu"] = density, E, nu
    v["material_id"] = material_id
    v["conf"] = 1.0 if conf is None else conf
    return v


def load_material_ply(path: str | Path) -> dict[str, np.ndarray]:
    """Load a material PLY into plain arrays (gs_simulation.py:108-202 contract)."""
    vertex = read_ply(path)["vertex"]
    names = vertex.dtype.names
    pos = np.column_stack([vertex["x"], vertex["y"], vertex["z"]]).astype(np.float32)
    out = {
        "pos": pos,
        "density": np.asarray(vertex["density"], dtype=np.float32),
        "E": np.asarray(vertex["E"], dtype=np.float32),
        "nu": np.asarray(vertex["nu"], dtype=np.float32),
        "material_id": np.asarray(vertex["material_id"]),
        # part_label falls back to material_id (gs_simulation.py:174-178)
        "part_labels": np.asarray(
            vertex["part_label"] if "part_label" in names else vertex["material_id"]
        ),
        "conf": np.asarray(vertex["conf"], dtype=np.float32)
        if "conf" in names
        else np.ones(len(pos), dtype=np.float32),
    }
    if all(c in names for c in ("red", "green", "blue")):
        out["colors"] = np.column_stack(
            [vertex["red"], vertex["green"], vertex["blue"]]
        ).astype(np.float32) / 255.0
    return out
