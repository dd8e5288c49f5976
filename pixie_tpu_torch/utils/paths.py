"""Filesystem layout: single source of truth for per-object artifact paths.

Mirrors pixie/utils.py:296-363 (``resolve_paths`` / ``get_output_paths``):
    data/{obj_id}                      Blender images + transforms
    models/{obj_id}/{f3rm,gs}          reconstruction checkpoints
    render_outputs/{obj_id}            voxel grids + segmentations
    mpm_sim_outputs/{mode}/{obj_id}    simulation frames / ply

Carried over from pixie_tpu/utils/paths.py (host only), with the config
functions of pixie_tpu_torch.config.core.
"""

from __future__ import annotations

import os
from pathlib import Path

from pixie_tpu_torch.config.core import Config, _resolve


def resolve_paths(cfg: Config) -> Config:
    """Fill in base_path (cwd default) and derived inference dir, re-resolve."""
    if not cfg.paths.base_path or str(cfg.paths.base_path) == "None":
        cfg.paths.base_path = os.getcwd()
    if not cfg.paths.get("inference_results_dir"):
        cfg.paths.inference_results_dir = (
            f"inference_combined_mse_{cfg.training.feature_type}_results"
        )
    _resolve(cfg, cfg)
    return cfg


def get_output_paths(cfg: Config, obj_id: str) -> dict[str, str]:
    """All output paths for one object (pixie/utils.py:323-363)."""
    base = cfg.paths
    paths = {
        "data_dir": os.path.join(base.data_dir, obj_id),
        "nerf_output": os.path.join(base.outputs_dir, obj_id, "f3rm"),
        "gs_output": os.path.join(base.outputs_dir, obj_id, "gs"),
        "render_output": os.path.join(base.render_outputs_dir, obj_id),
        "physgaussian_output": os.path.join(
            base.physgaussian_output_dir, cfg.material_mode, obj_id
        ),
        "blender_output": os.path.join(base.blender_output_dir, obj_id),
    }
    if cfg.material_mode == "neural":
        paths["neural_base_dir"] = os.path.join(
            base.base_path, base.inference_results_dir, obj_id
        )
    elif cfg.material_mode == "vlm":
        paths["vlm_base_dir"] = os.path.join(base.vlm_seg_mat_sample_results_dir, obj_id)
    return paths


def voxel_artifact_paths(render_output: str) -> dict[str, str]:
    """Paths of the voxel-stage artifacts inside render_outputs/{obj_id}."""
    r = Path(render_output)
    return {
        "npz": str(r / "clip_features.npz"),
        "features": str(r / "clip_features_features.npy"),
        "alphas": str(r / "clip_features_alphas.npy"),
        "rgb": str(r / "clip_features_rgb.npy"),
        "mask": str(r / "clip_features_mask.npy"),
        "pc_ply": str(r / "clip_features_pc.ply"),
    }


def sample_dir(render_output: str, sample_id: int = 0) -> str:
    return os.path.join(render_output, f"sample_{sample_id}")


def create_directories(paths: dict[str, str]) -> None:
    for p in paths.values():
        if p:
            Path(p).mkdir(parents=True, exist_ok=True)
