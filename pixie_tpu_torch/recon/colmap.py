"""COLMAP sparse-reconstruction ingestion for real-scene captures (port of
pixie_tpu/recon/colmap.py, host numpy code copied unchanged apart from this
note).

The reference trains f3rm and 3DGS on real captures through the COLMAP
dataparser (f3rm/f3rm_config.py:40-52 ``USE_COLMAP_DATAPARSER``;
gaussian-splatting/scene/__init__.py + scene/colmap_loader.py;
nbs/real_scene.ipynb).  This module is the rebuild's real-scene entry:

  * parsers for the public COLMAP sparse-model format (cameras / images /
    points3D, binary and text variants — format spec:
    colmap/src/base/reconstruction.cc, mirrored by the reference's
    scene/colmap_loader.py:83-273);
  * COLMAP (OpenCV: x right, y down, z forward) world-to-camera extrinsics
    -> NeRF/Blender-convention c2w poses (the convention
    load_blender_dataset already returns, so both trainers consume either
    source unchanged);
  * nerfstudio-semantics auto orient/center/scale (colmap_dataparser.py
    defaults: orientation "up", center "poses", auto-scale 1/max|t|),
    recorded as the ``dataparser_transforms.json`` contract
    ({"transform": (3,4), "scale": s}) that voxel/map_pred_to_coords.py
    and recon/field_adapter.py already consume: train-space point
    p_train = scale * (transform @ [p_world, 1]).

Everything here is host-side file IO + small-pose numpy math — no device
work (the TPU path starts at the trainers this feeds).
"""

from __future__ import annotations

import json
import logging
import struct
from pathlib import Path

import numpy as np

# model_id -> (name, num_params); public COLMAP camera-model table
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_IDS = {name: mid for mid, (name, _) in _CAMERA_MODELS.items()}


def qvec2rotmat(q) -> np.ndarray:
    """COLMAP wxyz quaternion -> rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


# --------------------------------------------------------------------------
# sparse-model parsers (binary + text)
# --------------------------------------------------------------------------

def read_cameras_bin(path) -> dict:
    """cameras.bin -> {camera_id: {model, width, height, params}}."""
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = _CAMERA_MODELS[mid]
            params = struct.unpack(f"<{np_}d", f.read(8 * np_))
            cams[cid] = {"model": name, "width": int(w), "height": int(h),
                         "params": np.asarray(params)}
    return cams


def read_cameras_text(path) -> dict:
    cams = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cams[int(parts[0])] = {
            "model": parts[1], "width": int(parts[2]), "height": int(parts[3]),
            "params": np.asarray([float(p) for p in parts[4:]]),
        }
    return cams


def read_images_bin(path) -> dict:
    """images.bin -> {image_id: {qvec, tvec, camera_id, name}} (the 2D-point
    tracks are skipped — pose ingestion doesn't need them)."""
    images = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            vals = struct.unpack("<7d", f.read(56))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (n2d,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n2d, 1)  # skip (x, y, point3D_id) tracks
            images[iid] = {
                "qvec": np.asarray(vals[:4]), "tvec": np.asarray(vals[4:7]),
                "camera_id": cam_id, "name": name.decode("utf-8"),
            }
    return images


def read_images_text(path) -> dict:
    images = {}
    lines = [ln.strip() for ln in Path(path).read_text().splitlines()
             if ln.strip() and not ln.startswith("#")]
    # records alternate: pose line, then 2D-points line
    for ln in lines[0::2]:
        parts = ln.split()
        images[int(parts[0])] = {
            "qvec": np.asarray([float(v) for v in parts[1:5]]),
            "tvec": np.asarray([float(v) for v in parts[5:8]]),
            "camera_id": int(parts[8]), "name": parts[9],
        }
    return images


def read_points3d_bin(path):
    """points3D.bin -> (xyz (N,3) f64, rgb (N,3) u8).  Single-pass over the
    raw buffer with vectorized field extraction per record (tracks vary in
    length, so record offsets are walked, but no per-record struct calls
    for the track payloads)."""
    buf = Path(path).read_bytes()
    (n,) = struct.unpack_from("<Q", buf, 0)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    off = 8
    for i in range(n):
        # id(q) xyz(3d) rgb(3B) error(d) = 43 bytes, then track len + 8*len
        x, y, z = struct.unpack_from("<3d", buf, off + 8)
        r, g, b = struct.unpack_from("<3B", buf, off + 32)
        (tl,) = struct.unpack_from("<Q", buf, off + 43)
        xyz[i] = (x, y, z)
        rgb[i] = (r, g, b)
        off += 51 + 8 * tl
    return xyz, rgb


def read_points3d_text(path):
    xyz, rgb = [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        p = line.split()
        xyz.append([float(v) for v in p[1:4]])
        rgb.append([int(v) for v in p[4:7]])
    return np.asarray(xyz, np.float64), np.asarray(rgb, np.uint8)


def _find_sparse_dir(data_dir: Path) -> Path | None:
    for cand in (data_dir / "sparse" / "0", data_dir / "sparse",
                 data_dir / "colmap" / "sparse" / "0", data_dir):
        if (cand / "cameras.bin").exists() or (cand / "cameras.txt").exists():
            return cand
    return None


def is_colmap_capture(data_dir) -> bool:
    return _find_sparse_dir(Path(data_dir)) is not None


def read_sparse_model(sparse_dir):
    """Read a COLMAP sparse model dir (binary preferred, text fallback)."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "cameras.bin").exists():
        cams = read_cameras_bin(sparse_dir / "cameras.bin")
        images = read_images_bin(sparse_dir / "images.bin")
        pts_path = sparse_dir / "points3D.bin"
        pts = read_points3d_bin(pts_path) if pts_path.exists() else (None, None)
    else:
        cams = read_cameras_text(sparse_dir / "cameras.txt")
        images = read_images_text(sparse_dir / "images.txt")
        pts_path = sparse_dir / "points3D.txt"
        pts = read_points3d_text(pts_path) if pts_path.exists() else (None, None)
    return cams, images, pts


# --------------------------------------------------------------------------
# pose conventions + auto orient/center/scale
# --------------------------------------------------------------------------

def _intrinsics_from_camera(cam: dict):
    model, params = cam["model"], cam["params"]
    if model == "SIMPLE_PINHOLE":
        f, cx, cy = params[:3]
        return float(f), float(f), float(cx), float(cy)
    if model == "PINHOLE":
        fx, fy, cx, cy = params[:4]
        return float(fx), float(fy), float(cx), float(cy)
    if model in ("SIMPLE_RADIAL", "RADIAL", "OPENCV"):
        # distortion ignored: captures are expected undistorted (the
        # reference asserts the same — dataset_readers.py:95)
        logging.warning("COLMAP model %s: ignoring distortion params", model)
        if model == "OPENCV":
            fx, fy, cx, cy = params[:4]
            return float(fx), float(fy), float(cx), float(cy)
        f, cx, cy = params[:3]
        return float(f), float(f), float(cx), float(cy)
    raise ValueError(
        f"unsupported COLMAP camera model {model}; undistort the capture "
        f"to SIMPLE_PINHOLE/PINHOLE first")


def colmap_c2w_nerf(qvec, tvec) -> np.ndarray:
    """COLMAP w2c (OpenCV axes) -> NeRF/Blender-convention c2w (y up,
    camera looks down -z)."""
    r = qvec2rotmat(qvec)
    c2w = np.eye(4)
    c2w[:3, :3] = r.T
    c2w[:3, 3] = -r.T @ np.asarray(tvec, np.float64)
    c2w[:3, 1:3] *= -1.0  # OpenCV (y down, z fwd) -> NeRF (y up, z back)
    return c2w


def auto_orient_and_center(c2w: np.ndarray):
    """nerfstudio camera_utils.auto_orient_and_center_poses semantics
    (orientation "up", center "poses", auto_scale_poses=True):

      * rotate the mean camera up-vector to +z;
      * translate the mean camera position to the origin;
      * scale by 1 / max |translation|.

    Returns (c2w' (N,4,4), transform (3,4), scale) with
    p_train = scale * (transform @ [p_world, 1])."""
    c2w = np.asarray(c2w, np.float64)
    up = c2w[:, :3, 1].mean(axis=0)
    up = up / max(np.linalg.norm(up), 1e-12)
    # minimal rotation taking `up` to +z
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(up, z)
    s, c = np.linalg.norm(v), float(up @ z)
    if s < 1e-12:
        rot = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        rot = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))
    center = (rot @ c2w[:, :3, 3].mean(axis=0))
    transform = np.concatenate([rot, -center[:, None]], axis=1)  # (3,4)

    out = c2w.copy()
    out[:, :3, :3] = np.einsum("ij,njk->nik", rot, c2w[:, :3, :3])
    out[:, :3, 3] = c2w[:, :3, 3] @ rot.T - center
    scale = 1.0 / max(float(np.abs(out[:, :3, 3]).max()), 1e-12)
    out[:, :3, 3] *= scale
    return out.astype(np.float32), transform, scale


def apply_dataparser_transform(points: np.ndarray, transform, scale):
    """world -> train-space points (the forward of
    map_pred_to_coords.transform_nerf_to_world)."""
    t = np.asarray(transform, np.float64)
    p = np.asarray(points, np.float64)
    return ((p @ t[:, :3].T + t[:, 3]) * scale).astype(np.float32)


def write_dataparser_transforms(path, transform, scale):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"transform": np.asarray(transform, float).tolist(),
                   "scale": float(scale)}, f, indent=2)


# --------------------------------------------------------------------------
# dataset loader (same contract as train_field.load_blender_dataset)
# --------------------------------------------------------------------------

def load_colmap_dataset(data_dir: str | Path, max_images: int | None = None,
                        downscale: int = 1):
    """Load a COLMAP capture: {images, c2w, intrinsics, hw} exactly like
    load_blender_dataset, plus {points3d, points3d_rgb, dataparser_transform,
    dataparser_scale}.  Poses and seed points are auto-oriented/centered/
    scaled into the train space; the inverse map is the returned
    dataparser transform (write it with write_dataparser_transforms for the
    downstream voxel/map stages)."""
    from PIL import Image  # noqa: PLC0415

    data_dir = Path(data_dir)
    sparse = _find_sparse_dir(data_dir)
    if sparse is None:
        raise FileNotFoundError(f"no COLMAP sparse model under {data_dir}")
    cams, images_meta, (pts, pts_rgb) = read_sparse_model(sparse)

    img_dir = data_dir / (f"images_{downscale}" if downscale > 1 else "images")
    native_downscale = img_dir.exists()
    if not native_downscale:
        img_dir = data_dir / "images"

    order = sorted(images_meta.values(), key=lambda m: m["name"])
    if max_images is not None:
        order = order[:max_images]

    imgs, poses = [], []
    fx = fy = cx = cy = None
    for meta in order:
        p = img_dir / meta["name"]
        if not p.exists():
            logging.warning("missing image %s; skipping", p)
            continue
        img = Image.open(p).convert("RGB")
        cam = cams[meta["camera_id"]]
        fx, fy, cx, cy = _intrinsics_from_camera(cam)
        sc = 1.0
        if downscale > 1 and not native_downscale:
            img = img.resize((img.width // downscale, img.height // downscale),
                             Image.LANCZOS)
            sc = 1.0 / downscale
        elif native_downscale:
            sc = img.width / cam["width"]
        imgs.append(np.asarray(img, np.float32) / 255.0)
        poses.append(colmap_c2w_nerf(meta["qvec"], meta["tvec"]))
        fx, fy, cx, cy = fx * sc, fy * sc, cx * sc, cy * sc
    if not imgs:
        raise FileNotFoundError(f"no readable images under {img_dir}")

    c2w, transform, scale = auto_orient_and_center(np.stack(poses))
    out = {
        "images": np.stack(imgs),
        "c2w": c2w,
        "intrinsics": (fx, fy, cx, cy),
        "hw": imgs[0].shape[:2],
        "dataparser_transform": transform,
        "dataparser_scale": scale,
    }
    if pts is not None:
        out["points3d"] = apply_dataparser_transform(pts, transform, scale)
        out["points3d_rgb"] = (np.asarray(pts_rgb, np.float32) / 255.0)
    return out
