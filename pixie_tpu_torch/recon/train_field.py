"""Capture loading of the feature-field trainer (port of
pixie_tpu/recon/train_field.py:83-145): ``load_blender_dataset`` and
``load_dataset``, host numpy and PIL code copied unchanged apart from their
imports.  The 3DGS trainer reads its captures through them.  The rest of
``train_field.py`` is field training, which waits for the field-training
slice (ROADMAP.md 'Next slices' (d)).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def load_blender_dataset(data_dir: str | Path, max_images: int | None = None):
    """Load a BlenderNeRF/Blender-format dataset: transforms.json + images.

    Returns dict with images (N,H,W,3) float32 in [0,1], c2w (N,4,4),
    intrinsics (fx, fy, cx, cy) and optional per-image feature maps.
    """
    from PIL import Image  # noqa: PLC0415

    data_dir = Path(data_dir)
    tf_path = None
    for cand in ("transforms.json", "transforms_train.json"):
        if (data_dir / cand).exists():
            tf_path = data_dir / cand
            break
    if tf_path is None:
        raise FileNotFoundError(f"no transforms json in {data_dir}")
    meta = json.loads(tf_path.read_text())

    frames = meta["frames"][:max_images]
    images, poses = [], []
    for fr in frames:
        p = data_dir / fr["file_path"]
        if not p.suffix:
            p = p.with_suffix(".png")
        img = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        images.append(img)
        poses.append(np.asarray(fr["transform_matrix"], np.float32))
    images = np.stack(images)
    poses = np.stack(poses)
    h, w = images.shape[1:3]

    if "camera_angle_x" in meta:
        fx = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
        fy = fx
    else:
        fx, fy = meta["fl_x"], meta["fl_y"]
    cx = meta.get("cx", w / 2.0)
    cy = meta.get("cy", h / 2.0)
    return {
        "images": images, "c2w": poses,
        "intrinsics": (float(fx), float(fy), float(cx), float(cy)),
        "hw": (h, w),
    }


def load_dataset(data_dir: str | Path, max_images: int | None = None):
    """Capture-format dispatcher: Blender/BlenderNeRF ``transforms.json``
    or a COLMAP sparse model (real-scene captures — the reference's
    USE_COLMAP_DATAPARSER switch, f3rm/f3rm_config.py:40-52).  Both return
    the same {images, c2w, intrinsics, hw} contract; COLMAP adds the
    dataparser transform/scale + seed points3d."""
    data_dir = Path(data_dir)
    for cand in ("transforms.json", "transforms_train.json"):
        if (data_dir / cand).exists():
            return load_blender_dataset(data_dir, max_images)
    from pixie_tpu_torch.recon.colmap import (  # noqa: PLC0415
        is_colmap_capture, load_colmap_dataset)

    if is_colmap_capture(data_dir):
        return load_colmap_dataset(data_dir, max_images)
    raise FileNotFoundError(
        f"{data_dir}: neither a transforms.json capture nor a COLMAP "
        f"sparse model")
