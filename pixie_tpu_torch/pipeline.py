"""The stages of ``pipeline.py`` that the port holds:

  train_gaussians              — the object's multi-view capture ->
      3DGS training -> gs/point_cloud/iteration_K/point_cloud.ply
      (pipeline.py:130-140)
  generate_neural_segmentation — clip_features_{features,mask}.npy +
      clip_features.npz -> both U-Nets -> sample_{k}_pred.npy ->
      denormalization -> mapped_preds.ply  (pipeline.py:187-317)
  run_physics_simulation       — mapped_preds.ply -> MPM rollout ->
      ply_files/frame_%04d.ply + sim_info.json  (pipeline.py:328-375)

The stage functions take explicit arguments (no config tree needed);
``main(argv)`` composes the same ``key=value`` overrides as ``pipeline.py``
through ``pixie_tpu_torch.config`` (over the shared YAML tree) and runs the
three stages.  The Blender render stage that writes the capture, field
training, the voxelizer and U-Net training are not in this port.

Run: ``python -m pixie_tpu_torch.pipeline obj_id=<id> paths.base_path=<dir>``
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.train.inference import (
    CombinedInference, infer_single_device, load_params,
)
from pixie_tpu_torch.utils.norm import load_normalization_ranges
from pixie_tpu_torch.utils.paths import voxel_artifact_paths
from pixie_tpu_torch.voxel.map_pred_to_coords import map_pred_to_ply

REPO_NORMALIZATION = (Path(__file__).resolve().parent.parent / "normalization_stats"
                      / "normalization_ranges.yaml")


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    """Highest ``epoch_k.pth`` file: the reference's checkpoint names, the
    only format ``train.inference.load_params`` reads.  The JAX package's
    pixie_tpu/train/trainer.py:latest_checkpoint picks the highest orbax
    ``epoch_k`` directory instead, which this port cannot load."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    candidates = []
    for p in ckpt_dir.glob("epoch_*.pth"):
        k = p.stem.split("_", 1)[1]
        if p.is_file() and k.isdigit():
            candidates.append((int(k), p))
    return max(candidates)[1] if candidates else None


def has_capture(data_dir: str | Path) -> bool:
    """Whether ``data_dir`` holds a capture ``load_dataset`` reads: a
    ``transforms*.json`` or a COLMAP sparse model."""
    from pixie_tpu_torch.recon.colmap import is_colmap_capture  # noqa: PLC0415

    data_dir = Path(data_dir)
    return (any((data_dir / n).exists() for n in ("transforms.json", "transforms_train.json"))
            or is_colmap_capture(data_dir))


def train_gaussians(
    data_dir: str | Path,
    gs_output: str | Path,
    iterations: int = 10000,
    overwrite: bool = False,
    device: str | torch.device = "cuda",
) -> dict | None:
    """3DGS training of the capture in ``data_dir`` into ``gs_output``;
    returns the trained parameters, or None when ``gs_output/point_cloud``
    exists and ``overwrite`` is off, or when ``data_dir`` holds no capture
    (the Blender render stage that writes one is not ported)."""
    from pixie_tpu_torch.recon.train_gaussians import (  # noqa: PLC0415
        train_gaussian_splatting,
    )

    out = Path(gs_output)
    if (out / "point_cloud").exists() and not overwrite:
        logging.info("[gs] checkpoint exists, skipping")
        return None
    if not has_capture(data_dir):
        logging.info("[gs] no capture (transforms*.json or COLMAP model) in %s: "
                     "3DGS training skipped", data_dir)
        return None
    return train_gaussian_splatting(data_dir, out, iterations=iterations, device=device)


def generate_neural_segmentation(
    render_output: str | Path,
    neural_dir: str | Path,
    obj_id: str,
    seg_ckpt_dir: str | Path,
    cont_ckpt_dir: str | Path,
    ranges_path: str | Path | None = None,
    sample_id: int = 0,
    grid_size: int = 64,
    feature_channels: int = 768,
    num_classes: int = 8,
    background_id: int = 7,
    model_kwargs: dict | None = None,
    overwrite: bool = False,
    device: str | torch.device = "cuda",
) -> Path:
    """U-Net inference on the voxel grid -> ``mapped_preds.ply``; returns its path."""
    render_output = Path(render_output)
    mapped_ply = render_output / f"sample_{sample_id}" / "mapped_preds.ply"
    if mapped_ply.exists() and not overwrite:
        logging.info("[neural] %s exists, skipping", mapped_ply)
        return mapped_ply
    if ranges_path is None or not Path(ranges_path).exists():
        ranges_path = REPO_NORMALIZATION
    ranges = load_normalization_ranges(ranges_path)

    seg_ckpt = latest_checkpoint(seg_ckpt_dir)
    cont_ckpt = latest_checkpoint(cont_ckpt_dir)
    if seg_ckpt is None or cont_ckpt is None:
        raise FileNotFoundError(
            f"U-Net checkpoints not found under {seg_ckpt_dir} / {cont_ckpt_dir}")

    art = voxel_artifact_paths(str(render_output))
    feats = np.load(art["features"])
    want = (grid_size,) * 3 + (feature_channels,)
    if feats.shape != want:
        raise ValueError(f"voxel grid {feats.shape} != {want} expected by the U-Net")
    infer = CombinedInference(
        load_params(seg_ckpt), load_params(cont_ckpt), grid_size=grid_size,
        feature_channels=feature_channels, num_classes=num_classes,
        background_id=background_id, model_kwargs=model_kwargs, device=device)
    infer_single_device(infer, torch.as_tensor(feats, device=infer.device),
                        np.load(art["mask"]), obj_id, sample_id, neural_dir)
    mapped_ply.parent.mkdir(parents=True, exist_ok=True)
    map_pred_to_ply(
        pred_path=Path(neural_dir) / obj_id / f"sample_{sample_id}_pred.npy",
        mask_path=art["mask"], grid_feature_path=art["npz"],
        output_path=mapped_ply, obj_id=obj_id, ranges=ranges)
    return mapped_ply


def run_physics_simulation(
    material_ply: str | Path,
    sim_config: str | Path,
    output_dir: str | Path,
    n_frames: int | None = None,
    save_ply: bool = True,
    debug: bool = False,
    gaussian_checkpoint: str | Path | None = None,
    render_img: bool = False,
    compile_video: bool = False,
    white_bg: bool = False,
    overwrite: bool = False,
    device: str | torch.device = "cuda",
    fused: bool | None = None,
) -> dict | None:
    """MPM rollout of the material PLY's vertices, or of the gaussians of
    ``gaussian_checkpoint`` with the PLY as their material source (rendered
    per frame with ``render_img``); returns sim info, or None when
    ``sim_info.json`` exists and ``overwrite`` is off.  ``fused`` selects
    the fused-substep frames (None: ``PIXIE_FUSED``, default off)."""
    from pixie_tpu_torch.sim.driver import run_simulation  # noqa: PLC0415

    output_dir = Path(output_dir)
    if (output_dir / "sim_info.json").exists() and not overwrite:
        logging.info("[sim] %s exists, skipping", output_dir)
        return None
    if not Path(sim_config).exists():
        raise FileNotFoundError(f"physics config not found: {sim_config}")
    return run_simulation(point_cloud_path=material_ply, config_path=sim_config,
                          output_dir=output_dir, n_frames=n_frames, save_ply=save_ply,
                          debug=debug, gaussian_checkpoint=gaussian_checkpoint,
                          render_img=render_img, compile_video=compile_video,
                          white_bg=white_bg, device=device, fused=fused)


def main(argv=None, device: str | torch.device = "cuda"):
    """``pipeline.py``'s 3DGS training and neural slice with its
    ``key=value`` overrides."""
    from pixie_tpu_torch.config import compose  # noqa: PLC0415
    from pixie_tpu_torch.utils.paths import (  # noqa: PLC0415
        create_directories, get_output_paths, resolve_paths,
    )

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    cfg = compose(overrides=list(sys.argv[1:] if argv is None else argv))
    if not cfg.obj_id:
        raise ValueError("obj_id is required: python -m pixie_tpu_torch.pipeline obj_id=...")
    if cfg.material_mode != "neural":
        raise NotImplementedError(f"material_mode={cfg.material_mode!r} is not ported")
    cfg = resolve_paths(cfg)
    paths = get_output_paths(cfg, cfg.obj_id)
    create_directories(paths)

    t0 = time.time()
    train_gaussians(paths["data_dir"], paths["gs_output"],
                    iterations=cfg.training_3d.gs_iterations,
                    overwrite=bool(cfg.overwrite), device=device)
    tr = cfg.training
    # the U-Net width of the config tree (defaults: the shipped nets)
    model_kwargs = dict(cond_dim=tr.cond_dim, model_channels=tr.training.unet_model_channels,
                        num_res_blocks=tr.training.unet_num_res_blocks,
                        channel_mult=tuple(tr.training.unet_channel_mult),
                        attention_resolutions=tuple(tr.training.attention_resolutions))
    material_ply = generate_neural_segmentation(
        paths["render_output"], paths["neural_base_dir"], cfg.obj_id,
        cfg.paths.discrete_checkpoint_dir, cfg.paths.continuous_checkpoint_dir,
        ranges_path=Path(cfg.paths.normalization_stats_dir) / "normalization_ranges.yaml",
        sample_id=cfg.physics.sample_id, grid_size=tr.default_grid_size,
        feature_channels=tr.feature_channels, num_classes=tr.num_material_classes,
        background_id=tr.background_id, model_kwargs=model_kwargs,
        overwrite=bool(cfg.overwrite), device=device)
    # config resolution of pipeline.py:338-348
    if cfg.get("is_objaverse_object", True):
        sim_cfg = (Path(cfg.paths.physgaussian_config_dir) / "objaverse"
                   / f"custom_{cfg.obj_class or 'tree'}_config.json")
    else:
        sim_cfg = (Path(cfg.paths.physgaussian_config_dir) / "real_scene"
                   / f"custom_{cfg.obj_id}_config.json")
    # the GS checkpoint's gaussians are simulated and rendered when one
    # exists (pipeline.py:351-372); should_use_white_bg (pixie/utils.py:378-382)
    gs_ckpt = Path(paths["gs_output"])
    has_gs = (gs_ckpt / "point_cloud").is_dir()
    white_bg = bool(cfg.physics.white_bg)
    if (cfg.material_mode == "neural"
            and cfg.obj_class in list(cfg.physics.get("no_white_bg_classes", []))):
        white_bg = False
    run_physics_simulation(
        material_ply, sim_cfg,
        Path(paths["physgaussian_output"]) / f"sample_{cfg.physics.sample_id}",
        n_frames=cfg.physics.get("n_frames"), save_ply=cfg.physics.save_ply,
        debug=cfg.physics.debug, gaussian_checkpoint=gs_ckpt if has_gs else None,
        render_img=bool(cfg.physics.get("render_img", True)) and has_gs,
        compile_video=bool(cfg.physics.get("compile_video", True)), white_bg=white_bg,
        overwrite=bool(cfg.overwrite), device=device)
    logging.info("pipeline stages complete in %.1fs", time.time() - t0)


if __name__ == "__main__":
    main()
