"""Paint material predictions onto a mesh (apply_feature_colors equivalent).

Copied from pixie_tpu/utils/mesh_paint.py (host only), unchanged apart from its imports.

The reference's data_curation/apply_feature_colors.py (~1460 LoC) loads the
object's GLB inside Blender, KD-tree-looks-up each mesh vertex against the
`mapped_preds.ply` point cloud, colors vertices by material class / density /
E / nu colormaps and renders turntable videos.  This is the Blender-free
core: a minimal GLB vertex parser (GLB = 12-byte header + JSON chunk + BIN
chunk; we walk mesh primitive POSITION accessors), a brute-force-chunked
nearest-neighbor lookup (numpy; meshes are <1M vertices), the same four
coloring modes, and colored-PLY / turntable-frame outputs via utils.viz.
Blender-based video rendering stays in the reference's domain; everything a
downstream tool needs (colored vertices) is produced here.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from pixie_tpu_torch.utils.io import load_material_ply, write_ply
from pixie_tpu_torch.utils.viz import compile_video, render_pointcloud_image

# material id -> RGB (matches the class palette used by the reference's
# apply_feature_colors + viz_utils semantic renders)
MATERIAL_COLORS = np.array(
    [
        [0.90, 0.30, 0.30],  # 0 jelly
        [0.62, 0.62, 0.70],  # 1 metal
        [0.85, 0.70, 0.35],  # 2 sand
        [0.55, 0.35, 0.75],  # 3 visplas (excluded)
        [0.25, 0.55, 0.95],  # 4 fluid (excluded)
        [0.95, 0.95, 0.98],  # 5 snow
        [0.35, 0.35, 0.35],  # 6 stationary
        [0.10, 0.10, 0.10],  # 7 background
    ],
    np.float32,
)

_COMPONENT_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}
_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}


def load_glb_vertices(path: str | Path) -> np.ndarray:
    """All mesh-primitive POSITION vertices of a .glb, world-ish model space
    (node transforms applied where present), concatenated (N, 3) float32."""
    raw = Path(path).read_bytes()
    magic, _version, _length = struct.unpack_from("<III", raw, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError(f"{path} is not a binary glTF (GLB) file")
    off = 12
    gltf = None
    binary = b""
    while off < len(raw):
        chunk_len, chunk_type = struct.unpack_from("<II", raw, off)
        data = raw[off + 8 : off + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # JSON
            gltf = json.loads(data)
        elif chunk_type == 0x004E4942:  # BIN
            binary = data
        off += 8 + chunk_len

    if gltf is None:
        raise ValueError(f"{path}: no JSON chunk")

    def read_accessor(idx):
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        dtype = _COMPONENT_DTYPE[acc["componentType"]]
        ncomp = _COMPONENT_COUNT[acc["type"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or ncomp * np.dtype(dtype).itemsize
        count = acc["count"]
        buf = np.frombuffer(binary, np.uint8,
                            count * stride - (stride - ncomp * np.dtype(dtype).itemsize),
                            start)
        rows = np.lib.stride_tricks.as_strided(
            buf, (count, ncomp * np.dtype(dtype).itemsize), (stride, 1)
        )
        return rows.copy().view(dtype).reshape(count, ncomp)

    # node world transforms (column-major glTF matrices)
    def node_matrix(node):
        if "matrix" in node:
            return np.array(node["matrix"], np.float32).reshape(4, 4).T
        m = np.eye(4, dtype=np.float32)
        if "scale" in node:
            m[:3, :3] *= np.array(node["scale"], np.float32)
        if "rotation" in node:
            qx, qy, qz, qw = node["rotation"]
            r = np.array([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
            ], np.float32)
            m[:3, :3] = r @ m[:3, :3]
        if "translation" in node:
            m[:3, 3] = node["translation"]
        return m

    out = []

    def visit(node_idx, parent):
        node = gltf["nodes"][node_idx]
        world = parent @ node_matrix(node)
        if "mesh" in node:
            for prim in gltf["meshes"][node["mesh"]].get("primitives", []):
                if "POSITION" not in prim.get("attributes", {}):
                    continue
                v = read_accessor(prim["attributes"]["POSITION"]).astype(np.float32)
                vh = np.concatenate([v, np.ones((len(v), 1), np.float32)], 1)
                out.append((vh @ world.T)[:, :3])
        for child in node.get("children", []):
            visit(child, world)

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    for root in scene.get("nodes", range(len(gltf.get("nodes", [])))):
        visit(root, np.eye(4, dtype=np.float32))
    if not out:
        raise ValueError(f"{path}: no POSITION data in any mesh primitive")
    return np.concatenate(out, 0)


def nearest_neighbor_indices(query: np.ndarray, points: np.ndarray,
                             chunk: int = 4096) -> np.ndarray:
    """argmin_j |query_i - points_j| per query row, chunked brute force."""
    idx = np.empty(len(query), np.int64)
    for s in range(0, len(query), chunk):
        q = query[s : s + chunk]
        d = ((q[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        idx[s : s + chunk] = d.argmin(1)
    return idx


def _scalar_colormap(values: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """viridis-ish 3-stop colormap without matplotlib."""
    t = np.clip((values - lo) / max(hi - lo, 1e-12), 0.0, 1.0)[:, None]
    c0 = np.array([0.267, 0.005, 0.329], np.float32)
    c1 = np.array([0.128, 0.567, 0.551], np.float32)
    c2 = np.array([0.993, 0.906, 0.144], np.float32)
    return np.where(t < 0.5, c0 + (c1 - c0) * (2 * t), c1 + (c2 - c1) * (2 * t - 1))


def color_by_property(mat: dict[str, np.ndarray], mode: str) -> np.ndarray:
    """(N,3) float colors for mode in {material, density, E, nu}."""
    if mode == "material":
        ids = np.clip(mat["material_id"].astype(np.int64), 0,
                      len(MATERIAL_COLORS) - 1)
        return MATERIAL_COLORS[ids]
    vals = mat[mode].astype(np.float64)
    if mode in ("density", "E"):
        vals = np.log10(np.maximum(vals, 1e-12))
    lo, hi = np.percentile(vals, 1.0), np.percentile(vals, 99.0)
    return _scalar_colormap(vals, float(lo), float(hi)).astype(np.float32)


def paint_mesh_with_predictions(
    mesh_path: str | Path,
    preds_ply_path: str | Path,
    out_dir: str | Path,
    modes: tuple[str, ...] = ("material", "density", "E", "nu"),
    turntable_frames: int = 0,
    fps: int = 15,
) -> dict[str, Path]:
    """Color mesh vertices by the nearest predicted particle's properties.

    mesh_path: .glb (parsed directly) or .ply (vertex cloud).  Writes one
    colored PLY per mode (+ optional matplotlib turntable video) and returns
    the output paths.  Mirrors apply_feature_colors.py's KD-tree lookup with
    a chunked exact NN (meshes here are small; no sklearn requirement).
    """
    mesh_path = Path(mesh_path)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if mesh_path.suffix.lower() == ".glb":
        verts = load_glb_vertices(mesh_path)
    else:
        from pixie_tpu_torch.utils.io import read_ply

        v = read_ply(mesh_path)["vertex"]
        verts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)

    mat = load_material_ply(preds_ply_path)
    pts = mat["pos"].astype(np.float32)

    # match scales: predictions live in the normalized [-0.5, 0.5] cube;
    # re-center/scale mesh verts into the prediction cloud's bounding box
    vc = (verts - verts.mean(0)) / max(np.abs(verts - verts.mean(0)).max(), 1e-9)
    pc_center = (pts.max(0) + pts.min(0)) / 2
    pc_half = np.abs(pts - pc_center).max()
    vq = vc * pc_half + pc_center

    nn = nearest_neighbor_indices(vq, pts)
    outputs: dict[str, Path] = {}
    for mode in modes:
        src = {k: v[nn] for k, v in mat.items() if k != "pos"}
        colors = color_by_property(src, mode)
        rgb = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        vertex = np.zeros(len(verts), dtype=[
            ("x", "f4"), ("y", "f4"), ("z", "f4"),
            ("red", "u1"), ("green", "u1"), ("blue", "u1"),
        ])
        vertex["x"], vertex["y"], vertex["z"] = verts.T
        vertex["red"], vertex["green"], vertex["blue"] = rgb.T
        ply_out = out_dir / f"colored_{mode}.ply"
        write_ply(ply_out, vertex)
        outputs[mode] = ply_out

        if turntable_frames > 0:
            from PIL import Image

            frame_dir = out_dir / f"turntable_{mode}"
            frame_dir.mkdir(exist_ok=True)
            centered = vq - vq.mean(0)
            for f in range(turntable_frames):
                ang = 2 * np.pi * f / turntable_frames
                ca, sa = np.cos(ang), np.sin(ang)
                rot = centered.copy()
                rot[:, 0] = ca * centered[:, 0] - sa * centered[:, 1]
                rot[:, 1] = sa * centered[:, 0] + ca * centered[:, 1]
                img = render_pointcloud_image(rot, colors=colors)
                Image.fromarray((img * 255).astype(np.uint8)).save(
                    frame_dir / f"frame_{f:04d}.png")
            video = out_dir / f"turntable_{mode}.mp4"
            compile_video(frame_dir, video, fps=fps)
            outputs[f"{mode}_video"] = video
    return outputs
