"""The stages of ``pipeline.py`` that the port holds:

  train_gaussians              — the object's multi-view capture ->
      3DGS training -> gs/point_cloud/iteration_K/point_cloud.ply
      (pipeline.py:130-140)
  generate_voxels              — the field checkpoint (f3rm/checkpoints/
      field.pth) -> 64^3 feature grid + occupancy mask, the clip_features*
      artifacts, and the feature grid left on the device (pipeline.py:143-172)
  generate_neural_segmentation — the feature grid (on the device from
      generate_voxels, else clip_features_features.npy) + mask + npz -> both
      U-Nets -> sample_{k}_pred.npy -> denormalization -> mapped_preds.ply
      (pipeline.py:187-317)
  run_physics_simulation       — mapped_preds.ply -> MPM rollout ->
      ply_files/frame_%04d.ply + sim_info.json  (pipeline.py:328-375)

The stage functions take explicit arguments (no config tree needed);
``main(argv)`` composes the same ``key=value`` overrides as ``pipeline.py``
through ``pixie_tpu_torch.config`` (over the shared YAML tree) and runs the
stages, joining the voxelizer's feature write before it returns
(pipeline.py:175-185, 408-410).  The Blender render stage that writes the
capture, field training and U-Net training are not in this port.

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


def generate_voxels(
    nerf_output: str | Path,
    render_output: str | Path,
    bounds=((-0.5, 0.5), (-0.5, 0.5), (-0.5, 0.5)),
    grid_size: int = 64,
    batch_size: int = 4096,
    alpha_weighted: bool = True,
    alpha_threshold_for_mask: float = 0.01,
    gray_threshold: float = 0.05,
    overwrite: bool = False,
    device: str | torch.device = "cuda",
) -> dict | None:
    """The field checkpoint of ``nerf_output`` -> the voxel artifacts of
    ``render_output``; returns the voxelizer's path dict (with
    ``features_dev`` and ``wait``: pass it to ``finish_voxel_fetch``), or
    None when the features and mask exist and ``overwrite`` is off.
    ``batch_size`` is the config tree's (voxelization.batch_size, 4096)."""
    from pixie_tpu_torch.recon.field_adapter import load_field_adapter  # noqa: PLC0415
    from pixie_tpu_torch.voxel.voxelize import extract_feature_voxel_grid  # noqa: PLC0415

    art = voxel_artifact_paths(str(render_output))
    if all(Path(art[k]).exists() for k in ("features", "mask")) and not overwrite:
        logging.info("[voxels] artifacts exist, skipping")
        return None
    field = load_field_adapter(nerf_output, device=device)
    return extract_feature_voxel_grid(
        field, art["npz"], bounds=tuple(tuple(b) for b in bounds),
        voxel_size=(bounds[0][1] - bounds[0][0]) / grid_size, batch_size=batch_size,
        alpha_weighted=alpha_weighted, alpha_threshold_for_mask=alpha_threshold_for_mask,
        gray_threshold_for_mask=gray_threshold, expected_grid=grid_size, device=device)


def finish_voxel_fetch(vox: dict | None) -> None:
    """Join the voxelizer's background feature write (once); call it before
    anything reads clip_features_features.npy."""
    if vox and "wait" in vox:
        t = vox.pop("wait")()
        logging.info("[voxels] feature npy written (fetch %.2fs, save %.2fs)",
                     t.get("fetch_bg_s", 0.0), t.get("save_feat_s", 0.0))


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
    features_dev: torch.Tensor | None = None,
) -> Path:
    """U-Net inference on the voxel grid -> ``mapped_preds.ply``; returns its
    path.  ``features_dev``: the (D,D,D,C) grid ``generate_voxels`` left on
    the device, used in place of the npy, which may still be being written."""
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
    feats = np.load(art["features"]) if features_dev is None else features_dev
    want = (grid_size,) * 3 + (feature_channels,)
    if tuple(feats.shape) != want:
        raise ValueError(f"voxel grid {tuple(feats.shape)} != {want} expected by the U-Net")
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
    """``pipeline.py``'s 3DGS training, voxelizer and neural slice with its
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
    vc = cfg.voxelization
    b = vc.scene_bounds
    vox = generate_voxels(
        paths["nerf_output"], paths["render_output"],
        bounds=(tuple(b.x_bound), tuple(b.y_bound), tuple(b.z_bound)),
        grid_size=vc.grid_size, batch_size=vc.batch_size, alpha_weighted=vc.alpha_weighted,
        alpha_threshold_for_mask=vc.alpha_threshold_for_mask, gray_threshold=vc.gray_threshold,
        overwrite=bool(cfg.overwrite or cfg.overwrite_voxel), device=device)
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
        overwrite=bool(cfg.overwrite), device=device,
        features_dev=(vox or {}).get("features_dev"))
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
    # the feature npy may still be being written behind the later stages
    finish_voxel_fetch(vox)
    logging.info("pipeline stages complete in %.1fs", time.time() - t0)


if __name__ == "__main__":
    main()
