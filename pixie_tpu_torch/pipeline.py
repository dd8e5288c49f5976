"""The stages of ``pipeline.py`` that the port holds:

  train_nerf                   — the object's multi-view capture (+ CLIP
      patch features of its views, extracted and cached as
      clip_patch_features.npy) -> the distilled feature field ->
      f3rm/checkpoints/field.pth  (pipeline.py:86-127)
  train_gaussians              — the object's multi-view capture ->
      3DGS training -> gs/point_cloud/iteration_K/point_cloud.ply
      (pipeline.py:130-140)
  generate_voxels              — the field checkpoint (f3rm/checkpoints/
      field.pth) -> 64^3 feature grid + occupancy mask, the clip_features*
      artifacts, and the feature grid left on the device (pipeline.py:143-172)
  generate_neural_segmentation — the feature grid (on the device from
      generate_voxels; else clip_features_features.npy read through
      MaterialVoxelDataset and run_inference, with an occupancy placeholder
      for a missing material_grid.npy) + mask + npz -> both U-Nets ->
      sample_{k}_pred.npy -> denormalization -> mapped_preds.ply
      (pipeline.py:187-317)
  run_physics_simulation       — mapped_preds.ply -> MPM rollout ->
      ply_files/frame_%04d.ply + sim_info.json  (pipeline.py:328-375)

The stage functions take explicit arguments (no config tree needed);
``main(argv)`` composes the same ``key=value`` overrides as ``pipeline.py``
through ``pixie_tpu_torch.config`` (over the shared YAML tree) and runs the
stages, joining the voxelizer's feature write before it returns
(pipeline.py:175-185, 408-410).  The Blender render stage that writes the
capture is not in this port.  The U-Nets the neural stage reads are
trained by ``pixie_tpu_torch.train.trainer.train_loop``, as in the JAX
package, outside the pipeline.

Run: ``python -m pixie_tpu_torch.pipeline obj_id=<id> paths.base_path=<dir>``
"""

from __future__ import annotations

import logging
import sys
import time
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.train.data import MaterialVoxelDataset
from pixie_tpu_torch.train.inference import (
    CombinedInference, infer_single_device, load_params, run_inference,
)
from pixie_tpu_torch.train.trainer import latest_checkpoint
from pixie_tpu_torch.utils.norm import load_normalization_ranges
from pixie_tpu_torch.utils.paths import voxel_artifact_paths
from pixie_tpu_torch.voxel.map_pred_to_coords import map_pred_to_ply

REPO_NORMALIZATION = (Path(__file__).resolve().parent.parent / "normalization_stats"
                      / "normalization_ranges.yaml")


def has_capture(data_dir: str | Path) -> bool:
    """Whether ``data_dir`` holds a capture ``load_dataset`` reads: a
    ``transforms*.json`` or a COLMAP sparse model."""
    from pixie_tpu_torch.recon.colmap import is_colmap_capture  # noqa: PLC0415

    data_dir = Path(data_dir)
    return (any((data_dir / n).exists() for n in ("transforms.json", "transforms_train.json"))
            or is_colmap_capture(data_dir))


def train_nerf(
    data_dir: str | Path,
    nerf_output: str | Path,
    training_3d: Mapping | None = None,
    overwrite: bool = False,
    device: str | torch.device = "cuda",
    on_step=None,
) -> dict | None:
    """Field training of the capture in ``data_dir`` into ``nerf_output``
    (``checkpoints/field.pth``); returns the fields, or None when the
    checkpoint exists and ``overwrite`` is off, or when ``data_dir`` holds
    no capture.  ``training_3d`` is the config tree's node, or some of its
    keys over the shipped tree's.  With ``distill_features`` and no
    ``clip_features_path``, the CLIP features of the capture's PNGs are
    extracted into ``nerf_output/clip_patch_features.npy`` first; where no
    CLIP weights are found the field trains RGB-only.  ``on_step(it, loss)``
    is passed to the trainer."""
    from pixie_tpu_torch.recon.field import RenderConfig  # noqa: PLC0415
    from pixie_tpu_torch.recon.train_field import (  # noqa: PLC0415
        FIELD_CKPT, FieldTrainConfig, train_feature_field,
    )

    out = Path(nerf_output)
    if (out / FIELD_CKPT).exists() and not overwrite:
        logging.info("[nerf] checkpoint exists, skipping")
        return None
    if not has_capture(data_dir):
        logging.info("[nerf] no capture (transforms*.json or COLMAP model) in %s: "
                     "field training skipped", data_dir)
        return None
    from pixie_tpu_torch.config import compose  # noqa: PLC0415

    t3 = {**compose().training_3d, **(training_3d or {})}
    # the CLIP distillation target: an explicit path, else extracted from the
    # training views (the f3rm method's datamanager behavior; cached)
    features_path = t3.get("clip_features_path")
    if features_path is None and t3.get("distill_features", True):
        cache = out / "clip_patch_features.npy"
        if not cache.exists():
            from pixie_tpu_torch.recon.clip_features import (  # noqa: PLC0415
                CLIPWeightsUnavailable, extract_clip_features,
            )

            try:
                extract_clip_features(sorted(Path(data_dir).glob("*.png")), cache_path=cache,
                                      device=device)
            except CLIPWeightsUnavailable as e:
                logging.warning("[nerf] CLIP extraction unavailable (%s); training without "
                                "feature distillation", e)
        if cache.exists():
            features_path = cache
    cfg = FieldTrainConfig(
        max_iterations=t3["nerf_max_num_iterations"], rays_per_batch=t3["nerf_rays_per_batch"],
        render=RenderConfig(n_coarse=t3["nerf_n_coarse"], n_fine=t3["nerf_n_fine"]))
    return train_feature_field(data_dir, out, cfg=cfg, features_path=features_path,
                               device=device, on_step=on_step)


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
    feature_type: str = "clip",
    batch_size: int = 4,
) -> Path:
    """U-Net inference on the voxel grid -> ``mapped_preds.ply``; returns its
    path.  ``features_dev``: the (D,D,D,C) grid ``generate_voxels`` left on
    the device, used in place of the npy, which may still be being written.
    Without it the object is read from ``render_output`` as a dataset item
    (``feature_type``'s file) and run through ``run_inference`` in batches
    of ``batch_size`` (the config's ``training.inference.batch_size``), as
    the JAX pipeline's file path does: an object without a
    ``sample_{k}/material_grid.npy`` gets an occupancy placeholder first, so
    its ``_gt.npy`` and ``metrics.json`` carry no meaning."""
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
    if features_dev is not None:
        want = (grid_size,) * 3 + (feature_channels,)
        if tuple(features_dev.shape) != want:
            raise ValueError(f"voxel grid {tuple(features_dev.shape)} != {want} expected by "
                             f"the U-Net")
        infer = CombinedInference(
            load_params(seg_ckpt), load_params(cont_ckpt), grid_size=grid_size,
            feature_channels=feature_channels, num_classes=num_classes,
            background_id=background_id, model_kwargs=model_kwargs, device=device)
        infer_single_device(infer, torch.as_tensor(features_dev, device=infer.device),
                            np.load(art["mask"]), obj_id, sample_id, neural_dir)
    else:
        _write_placeholder_material_grid(render_output, art["mask"], sample_id,
                                         background_id)
        dataset = MaterialVoxelDataset(
            render_output.parent, ranges, grid_size=grid_size,
            feature_channels=feature_channels, num_material_classes=num_classes,
            background_id=background_id, feature_type=feature_type, sample_id=sample_id,
            enforce_mask_consistency=False)  # inference has no GT material grid
        obj_indices = [i for i, s in enumerate(dataset.samples) if s.obj_id == obj_id]
        if not obj_indices:
            raise RuntimeError(
                f"{obj_id} failed dataset validation (wrong feature dim or grid size? "
                f"expected ({grid_size}^3, {feature_channels}))")
        run_inference(dataset, seg_ckpt, cont_ckpt, neural_dir, batch_size=batch_size,
                      indices=obj_indices, model_kwargs=model_kwargs, device=device)
    mapped_ply.parent.mkdir(parents=True, exist_ok=True)
    map_pred_to_ply(
        pred_path=Path(neural_dir) / obj_id / f"sample_{sample_id}_pred.npy",
        mask_path=art["mask"], grid_feature_path=art["npz"],
        output_path=mapped_ply, obj_id=obj_id, ranges=ranges)
    return mapped_ply


def _write_placeholder_material_grid(render_output: Path, mask_path, sample_id: int,
                                     background_id: int) -> None:
    """Fresh (unlabeled) objects have no GT material_grid.npy, which the
    dataset's file contract needs: write one from the occupancy mask
    (background outside it), as the JAX pipeline does (pipeline.py:268-281)."""
    mat_fp = render_output / f"sample_{sample_id}" / "material_grid.npy"
    if mat_fp.exists() or not Path(mask_path).exists():
        return
    occ = np.load(mask_path) > 0
    placeholder = np.zeros((*occ.shape, 4), np.float32)
    placeholder[..., 0] = np.where(occ, 1000.0, 0.0)   # density
    placeholder[..., 1] = np.where(occ, 1e5, 0.0)      # E
    placeholder[..., 2] = np.where(occ, 0.3, 0.0)      # nu
    placeholder[..., 3] = np.where(occ, 0, background_id)
    mat_fp.parent.mkdir(parents=True, exist_ok=True)
    np.save(mat_fp, placeholder)
    logging.info("[neural] no GT material grid; wrote occupancy placeholder (metrics will "
                 "be meaningless)")


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
    """``pipeline.py``'s field and 3DGS training, voxelizer and neural slice
    with its ``key=value`` overrides."""
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
    train_nerf(paths["data_dir"], paths["nerf_output"], training_3d=cfg.training_3d,
               overwrite=bool(cfg.overwrite), device=device)
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
        features_dev=(vox or {}).get("features_dev"), feature_type=tr.feature_type,
        batch_size=tr.inference.batch_size)
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
