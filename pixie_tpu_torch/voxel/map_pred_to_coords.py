"""Map U-Net predictions to a material point cloud (PLY).

Port of pixie/voxel/map_pred_to_coords.py:128-283 (``map_pred_to_ply``):
unscale the (3+K, D, D, D) prediction, argmax the material channels, mask
with occupancy, emit the reference-schema PLY with per-point confidence
(max class probability), optionally transformed to world space via
``dataparser_transforms.json``.

Carried over from pixie_tpu/voxel/map_pred_to_coords.py (host numpy).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from pixie_tpu_torch.utils.io import MATERIAL_PLY_DTYPE, read_ply, write_ply
from pixie_tpu_torch.utils.norm import NormalizationRanges, unscale_prediction


def get_mat_id(seg: np.ndarray) -> np.ndarray:
    """(1,D,D,D) class indices pass through; (K,D,D,D) one-hot -> argmax
    (map_pred_to_coords.py:122-127)."""
    if seg.shape[0] == 1:
        return seg[0]
    return np.argmax(seg, axis=0)


def map_pred_to_ply(
    pred_path: str | Path,
    mask_path: str | Path,
    grid_feature_path: str | Path,
    output_path: str | Path,
    obj_id: str,
    ranges: NormalizationRanges,
    world_output_path: str | Path | None = None,
    dataparser_path: str | Path | None = None,
) -> np.ndarray:
    """Returns the written vertex array (also saved to output_path)."""
    metadata = np.load(grid_feature_path)
    min_bounds = metadata["min_bounds"]
    max_bounds = metadata["max_bounds"]
    grid_shape = metadata["grid_shape"]

    scaled_pred = np.load(pred_path)
    pred = unscale_prediction(scaled_pred, ranges)
    mask = np.load(mask_path)

    if not np.array_equal(pred.shape[1:4], grid_shape):
        raise ValueError(
            f"Prediction spatial dimensions {pred.shape[1:4]} do not match grid shape {grid_shape}"
        )
    if not np.array_equal(mask.shape, grid_shape):
        raise ValueError(f"Mask shape {mask.shape} does not match grid shape {grid_shape}")

    cont = pred[:3]
    seg = pred[3:]
    material_id = get_mat_id(seg)

    axes = [
        np.linspace(min_bounds[i], max_bounds[i], grid_shape[i]) for i in range(3)
    ]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    coords = np.stack([gx, gy, gz], axis=-1)

    valid = mask > 0
    valid_coords = coords[valid]
    n = len(valid_coords)

    vertex = np.zeros(n, dtype=MATERIAL_PLY_DTYPE)
    vertex["x"], vertex["y"], vertex["z"] = (
        valid_coords[:, 0], valid_coords[:, 1], valid_coords[:, 2],
    )
    vertex["red"] = vertex["green"] = vertex["blue"] = vertex["alpha"] = 255
    vertex["part_label"] = material_id[valid]
    vertex["density"] = cont[0][valid]
    vertex["E"] = cont[1][valid]
    vertex["nu"] = cont[2][valid]
    vertex["material_id"] = material_id[valid]
    if seg.shape[0] > 1:
        vertex["conf"] = np.max(seg, axis=0)[valid]
    else:
        vertex["conf"] = 1.0

    write_ply(output_path, vertex)
    logging.info("Saved PLY file to %s from %s", output_path, pred_path)

    if world_output_path is not None:
        if dataparser_path is None:
            dataparser_path = Path(grid_feature_path).parent / "dataparser_transforms.json"
            if not Path(dataparser_path).exists():
                raise FileNotFoundError(
                    f"Could not find dataparser_transforms.json at {dataparser_path}"
                )
        transform_nerf_to_world(output_path, dataparser_path, world_output_path)
    return vertex


def transform_nerf_to_world(
    ply_path: str | Path, dataparser_path: str | Path, world_output_path: str | Path
) -> None:
    """NeRF-train-space -> world-space PLY (map_pred_to_coords.py:77-120):
    divide by scale, apply inverse of the (3,4) dataparser transform."""
    vertex = read_ply(ply_path)["vertex"].copy()
    with open(dataparser_path) as f:
        dp = json.load(f)
    scale = float(dp["scale"])
    transform = np.asarray(dp["transform"], dtype=np.float32)

    t = np.eye(4, dtype=np.float32)
    t[:3, :] = transform
    t_inv = np.linalg.inv(t)

    coords = np.column_stack([vertex["x"], vertex["y"], vertex["z"]]).astype(np.float32)
    coords = coords / scale
    coords_h = np.concatenate([coords, np.ones((len(coords), 1), np.float32)], axis=1)
    world = (t_inv @ coords_h.T).T[:, :3]

    vertex["x"], vertex["y"], vertex["z"] = world[:, 0], world[:, 1], world[:, 2]
    write_ply(world_output_path, vertex)
    logging.info("Saved WORLD-frame PLY to %s", world_output_path)
