"""Capture loading and the field checkpoint of the feature-field trainer
(port of pixie_tpu/recon/train_field.py:83-145 and :450-468).

``load_blender_dataset`` and ``load_dataset`` are host numpy and PIL code
copied unchanged apart from their imports; the 3DGS trainer reads its
captures through them.  ``save_field_checkpoint`` / ``load_field_checkpoint``
write and read ``checkpoints/field.pth``, a torch state dict of ``nerf`` and
``feat``, beside the JAX package's ``field_meta.json`` keys.  The JAX package
writes an orbax directory ``checkpoints/field/`` instead, which this port
does not read (``recon.field.state_dict_from_jax`` converts its parameters).
Field training itself waits for the field-training slice.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

FIELD_CKPT = Path("checkpoints") / "field.pth"


def save_field_checkpoint(output_dir: str | Path, params: dict, feature_dim: int = 768,
                          encoding: str = "mxu") -> Path:
    """Write ``params`` ({"nerf": ..., "feat": ...}, each an ``nn.Module`` or
    a state dict) to ``output_dir/checkpoints/field.pth`` and the meta
    ``field_meta.json`` (feature_dim, with_features, encoding); returns the
    checkpoint's path."""
    path = Path(output_dir) / FIELD_CKPT
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {}
    for name, p in params.items():
        sd = p.state_dict() if isinstance(p, nn.Module) else p
        state[name] = {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}
    torch.save(state, path)
    meta = {"feature_dim": feature_dim, "with_features": "feat" in params, "encoding": encoding}
    (path.parent / "field_meta.json").write_text(json.dumps(meta))
    return path


def load_field_checkpoint(output_dir: str | Path) -> dict:
    """{"nerf": state dict, "feat": state dict (if saved)} from
    ``output_dir/checkpoints/field.pth``; raises FileNotFoundError where the
    directory holds only the JAX package's orbax checkpoint."""
    path = Path(output_dir) / FIELD_CKPT
    if not path.exists():
        orbax = path.parent / "field"
        if orbax.is_dir():
            raise FileNotFoundError(
                f"{path} not found; {orbax} is an orbax checkpoint of the JAX package, which "
                f"this port does not read (convert its params with "
                f"pixie_tpu_torch.recon.field.state_dict_from_jax)")
        raise FileNotFoundError(f"no field checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


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
