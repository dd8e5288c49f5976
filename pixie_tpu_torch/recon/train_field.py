"""Feature-field (f3rm) training: the ``ns-train f3rm`` stage (port of
pixie_tpu/recon/train_field.py).

Reference flow (pipeline.py:84-133 -> nerfstudio Trainer + f3rm plugin):
  * Blender/BlenderNeRF dataset: transforms(_train).json + PNGs, or a COLMAP
    model;
  * CLIP patch features per image, nearest patch per ray
    (feature_datamanager.py:106-124); optional: without a feature file the
    field trains RGB-only;
  * losses: RGB MSE + the interlevel loss + 1e-3 * feature MSE
    (f3rm/model.py:264-269);
  * 4096 rays a batch, one Adam over every field, the learning rate decayed
    exponentially from 1e-2 to 1e-4.

The JAX package jits a step and, for long runs, scans chunks of 50 steps
(``PIXIE_FIELD_SCAN``), a dispatch schedule with the per-step loop's
results; this port runs the per-step loop.  Its draws (pixels, then the
renders' uniforms) come from one ``torch.Generator`` on the device, its
initial parameters from flax's initializers (tables U(0, 2e-4), kernels
truncated-normal LeCun, biases 0) drawn from a CPU generator.

``load_blender_dataset`` and ``load_dataset`` are host numpy and PIL code
copied unchanged apart from their imports; the 3DGS trainer reads its
captures through them.  ``save_field_checkpoint`` / ``load_field_checkpoint``
write and read ``checkpoints/field.pth``, a torch state dict of each field
(``nerf``, ``feat``, ``prop``), beside the JAX package's ``field_meta.json``
keys.  The JAX package writes an orbax directory ``checkpoints/field/``
instead, which this port does not read (``recon.field.state_dict_from_jax``
converts its parameters).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from pixie_tpu_torch.recon.field import (
    FeatureField, NerfField, ProposalField, RenderConfig, draw_uniforms, render_rays,
    render_rays_prop,
)

FIELD_CKPT = Path("checkpoints") / "field.pth"


@dataclasses.dataclass
class FieldTrainConfig:
    max_iterations: int = 5000
    rays_per_batch: int = 4096
    lr: float = 1e-2
    lr_final: float = 1e-4
    feat_loss_weight: float = 1e-3
    feature_dim: int = 768
    seed: int = 42
    # "mxu" = the MXU table layout (the JAX package's default); "hashgrid" =
    # tcnn's layout
    encoding: str = "mxu"
    eval_views: int = 2  # held-out views for the final PSNR report
    # proposal sampling (nerfacto proposal networks): n_coarse samples
    # through a small density field pick n_fine full-field samples
    use_proposal: bool = True
    prop_loss_weight: float = 1.0  # nerfacto interlevel_loss_mult
    render: RenderConfig = dataclasses.field(
        default_factory=lambda: RenderConfig(n_coarse=64, n_fine=32)
    )


# Method-config registry — the nerfstudio `method_configs` analog (reference
# f3rm/f3rm_config.py registers "f3rm" as a nerfacto variant; `ns-train
# <method>` selects one).
METHOD_CONFIGS: dict[str, FieldTrainConfig] = {
    # f3rm: nerfacto + CLIP feature head, the pipeline default
    # (f3rm/f3rm_config.py:24-77)
    "f3rm": FieldTrainConfig(),
    # nerfacto: RGB-only (no distillation head)
    "nerfacto": FieldTrainConfig(feat_loss_weight=0.0),
    # quick preview profile
    "f3rm-lite": FieldTrainConfig(
        max_iterations=2000, rays_per_batch=2048,
        render=RenderConfig(n_coarse=48, n_fine=32),
    ),
}


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


def draw_pixels(generator: torch.Generator, n: int, n_img: int, h: int, w: int):
    """``n`` random (image, row, column) indices from ``generator``, on its
    device."""
    kw = dict(generator=generator, device=generator.device)
    return (torch.randint(0, n_img, (n,), **kw), torch.randint(0, h, (n,), **kw),
            torch.randint(0, w, (n,), **kw))


def draw_step(generator: torch.Generator, n: int, n_img: int, hw, rcfg: RenderConfig):
    """A training step's draws: pixel indices (img_idx, py, px), then the
    render's uniforms (jitter, inverse CDF)."""
    return (*draw_pixels(generator, n, n_img, *hw), draw_uniforms(n, rcfg, generator))


def make_ray_fn(dataset, feature_maps=None, device: str | torch.device = "cuda"):
    """The capture's images, cameras (and per-image CLIP patch features
    (N, Hf, Wf, C)) on ``device`` -> ``rays_from_pixels(img_idx, py, px)`` ->
    (origins, dirs, rgb, feature target or None).  A ray's feature target is
    its nearest patch (feature_datamanager.py:106-124)."""
    device = torch.device(device)
    images = torch.as_tensor(np.ascontiguousarray(dataset["images"], np.float32), device=device)
    c2w = torch.as_tensor(np.asarray(dataset["c2w"], np.float32), device=device)
    fx, fy, cx, cy = dataset["intrinsics"]
    h, w = images.shape[1], images.shape[2]
    if feature_maps is not None:
        feature_maps = torch.as_tensor(np.asarray(feature_maps), device=device)

    def rays_from_pixels(img_idx, py, px):
        n = img_idx.shape[0]
        # Blender convention: the camera looks down -z, y up
        dirs_cam = torch.stack([(px.to(torch.float32) + 0.5 - cx) / fx,
                                -(py.to(torch.float32) + 0.5 - cy) / fy,
                                -torch.ones((n,), device=device)], dim=-1)
        rot = c2w[img_idx, :3, :3]
        dirs = (rot[:, :, 0] * dirs_cam[:, None, 0] + rot[:, :, 1] * dirs_cam[:, None, 1]
                + rot[:, :, 2] * dirs_cam[:, None, 2])
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        feat_gt = None
        if feature_maps is not None:
            hf, wf = feature_maps.shape[1], feature_maps.shape[2]
            feat_gt = feature_maps[img_idx, torch.clamp((py * hf) // h, 0, hf - 1),
                                   torch.clamp((px * wf) // w, 0, wf - 1)]
        return c2w[img_idx, :3, 3], dirs, images[img_idx, py, px], feat_gt

    return rays_from_pixels


def make_view_rays(c2w: np.ndarray, intrinsics, hw):
    """All pixel rays of one camera (origins, dirs), Blender convention."""
    fx, fy, cx, cy = intrinsics
    h, w = hw
    px, py = np.meshgrid(np.arange(w), np.arange(h))
    dirs_cam = np.stack(
        [(px + 0.5 - cx) / fx, -(py + 0.5 - cy) / fy, -np.ones_like(px)],
        axis=-1,
    ).astype(np.float32)
    dirs = dirs_cam.reshape(-1, 3) @ np.asarray(c2w[:3, :3], np.float32).T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(
        np.asarray(c2w[:3, 3], np.float32), dirs.shape
    ).copy()
    return origins, dirs


@torch.no_grad()
def render_full_view(fields: dict, c2w, intrinsics, hw, rcfg: RenderConfig,
                     chunk: int = 4096, device: str | torch.device = "cuda") -> np.ndarray:
    """One full image (h, w, 3) rendered in ray chunks with ``fields``
    ({"nerf", and "prop" for proposal sampling}) in eval mode."""
    origins, dirs = (torch.as_tensor(a, device=device)
                     for a in make_view_rays(c2w, intrinsics, hw))
    rows = []
    for i in range(0, origins.shape[0], chunk):
        o, d = origins[i:i + chunk], dirs[i:i + chunk]
        if "prop" in fields:
            out = render_rays_prop(fields["prop"], fields["nerf"], None, o, d, rcfg, train=False,
                                   with_features=False)
        else:
            out = render_rays(fields["nerf"], None, o, d, rcfg, train=False, with_features=False)
        rows.append(out["rgb"])
    return torch.cat(rows).reshape(hw[0], hw[1], 3).cpu().numpy()


def evaluate_field(fields: dict, dataset, view_indices, rcfg: RenderConfig,
                   device: str | torch.device = "cuda") -> dict:
    """Test-view PSNR over held-out views (nerfstudio eval-loop analog;
    reference PSNR reporting: gaussian-splatting/train.py:100-112)."""
    from pixie_tpu_torch.utils.metrics import psnr  # noqa: PLC0415

    vals = [psnr(render_full_view(fields, dataset["c2w"][vi], dataset["intrinsics"],
                                  dataset["hw"], rcfg, device=device),
                 dataset["images"][vi])
            for vi in view_indices]
    return {"psnr_per_view": vals,
            "psnr_mean": float(np.mean(vals)) if vals else float("nan")}


def _flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's initializers in place: hash tables U(0, 2e-4), Dense kernels
    LeCun truncated normal (variance 1 / fan_in), biases 0."""
    with torch.no_grad():
        for name, prm in module.named_parameters():
            if name.endswith("table"):
                prm.copy_(torch.rand(prm.shape, generator=generator) * 2e-4)
            elif name.endswith("weight"):
                std = (1.0 / prm.shape[1]) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(prm, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            else:
                prm.zero_()


def init_fields(cfg: FieldTrainConfig, with_features: bool,
                device: str | torch.device = "cuda") -> dict:
    """The fields the trainer fits ({"nerf", "feat", "prop"} as configured),
    initialised from ``cfg.seed`` on the CPU, on ``device``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    fields = {"nerf": NerfField(encoding=cfg.encoding)}
    if with_features:
        fields["feat"] = FeatureField(feature_dim=cfg.feature_dim, encoding=cfg.encoding)
    if cfg.use_proposal:
        fields["prop"] = ProposalField()
    for module in fields.values():
        _flax_init_(module, gen)
        module.to(device)
    return fields


def learning_rate(cfg: FieldTrainConfig, step: int) -> float:
    """optax.exponential_decay(lr, max_iterations, lr_final / lr) at the
    count of updates made before this one."""
    return cfg.lr * (cfg.lr_final / cfg.lr) ** (step / cfg.max_iterations)


def train_feature_field(
    data_dir: str | Path,
    output_dir: str | Path,
    max_iterations: int = 5000,
    features_path: str | Path | None = None,
    cfg: FieldTrainConfig | None = None,
    log_every: int = 500,
    device: str | torch.device = "cuda",
    on_step=None,
) -> dict:
    """Train the nerf (+ feature, + proposal) fields on the capture in
    ``data_dir``; writes ``checkpoints/field.pth``, ``field_meta.json`` and
    ``metrics.json`` under ``output_dir`` and returns the fields
    ({name: module on ``device``}).  ``on_step(it, loss)``, when given, is
    called after each step with the step's loss as a device scalar."""
    cfg = cfg or FieldTrainConfig(max_iterations=max_iterations)
    device = torch.device(device)
    output_dir = Path(output_dir)
    dataset = load_dataset(data_dir)
    if "dataparser_transform" in dataset:
        # real-scene contract: the voxel/map stages undo this to get world
        # coordinates (map_pred_to_coords.transform_nerf_to_world)
        from pixie_tpu_torch.recon.colmap import write_dataparser_transforms  # noqa: PLC0415

        write_dataparser_transforms(output_dir / "dataparser_transforms.json",
                                    dataset["dataparser_transform"],
                                    dataset["dataparser_scale"])
    with_features = features_path is not None and Path(features_path).exists()
    feature_maps = np.load(features_path) if with_features else None
    if with_features:
        cfg = dataclasses.replace(cfg, feature_dim=int(feature_maps.shape[-1]))

    # hold out the last eval_views frames for the test-view PSNR report
    n_frames = len(dataset["images"])
    n_eval = min(cfg.eval_views, max(0, n_frames - 2))
    n_train = n_frames - n_eval
    eval_indices = list(range(n_train, n_frames))
    train_ds = dict(dataset, images=dataset["images"][:n_train], c2w=dataset["c2w"][:n_train])
    rays_from_pixels = make_ray_fn(
        train_ds, feature_maps[:n_train] if with_features else None, device)
    fields = init_fields(cfg, with_features, device)
    opt = torch.optim.Adam([p for m in fields.values() for p in m.parameters()], lr=cfg.lr,
                           betas=(0.9, 0.99), eps=1e-15)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    hw = train_ds["images"].shape[1:3]

    t0 = time.time()
    loss = torch.zeros((), device=device)
    for it in range(cfg.max_iterations):
        img_idx, py, px, draws = draw_step(gen, cfg.rays_per_batch, n_train, hw, cfg.render)
        origins, dirs, rgb_gt, feat_gt = rays_from_pixels(img_idx, py, px)
        if cfg.use_proposal:
            out = render_rays_prop(fields["prop"], fields["nerf"], fields.get("feat"), origins,
                                   dirs, cfg.render, train=True, with_features=with_features,
                                   draws=draws)
        else:
            out = render_rays(fields["nerf"], fields.get("feat"), origins, dirs, cfg.render,
                              train=True, with_features=with_features, draws=draws)
        loss = torch.mean((out["rgb"] - rgb_gt) ** 2)
        if cfg.use_proposal:
            # the interlevel loss trains the proposal field (mip-NeRF 360)
            loss = loss + cfg.prop_loss_weight * out["prop_loss"]
        if with_features:
            # feature MSE at 1e-3 weight (f3rm/model.py:264-269)
            loss = loss + cfg.feat_loss_weight * torch.mean((out["feature"] - feat_gt) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = learning_rate(cfg, it)
        opt.step()
        loss = loss.detach()
        if on_step is not None:
            on_step(it, loss)
        if it % log_every == 0:
            logging.info("field iter %d loss %.5f (%.1fs)", it, float(loss), time.time() - t0)

    save_field_checkpoint(output_dir, fields, feature_dim=cfg.feature_dim,
                          encoding=cfg.encoding)
    metrics = {"train_s": time.time() - t0, "final_loss": float(loss)}
    if eval_indices:
        metrics.update(evaluate_field(fields, dataset, eval_indices, cfg.render, device))
        logging.info("field eval PSNR %.2f dB over views %s", metrics["psnr_mean"],
                     eval_indices)
    (output_dir / "metrics.json").write_text(json.dumps(metrics, indent=1))
    return fields


def main(argv=None):
    """ns-train-equivalent CLI (reference: `ns-train f3rm --data <dir>`).
    Usage:
        python -m pixie_tpu_torch.recon.train_field --data <capture_dir> \
            --output <out_dir> [--features clip_features.npy] [--iters N] \
            [--device cpu]
    """
    import argparse  # noqa: PLC0415

    ap = argparse.ArgumentParser(description=main.__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--method", default="f3rm", choices=sorted(METHOD_CONFIGS),
                    help="method preset (ns-train <method> analog)")
    ap.add_argument("--features", default=None,
                    help="per-view CLIP patch features npy (enables the feature head, f3rm "
                    "distillation)")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = METHOD_CONFIGS[args.method]
    if args.iters is not None:
        cfg = dataclasses.replace(cfg, max_iterations=args.iters)
    train_feature_field(args.data, args.output, cfg=cfg, features_path=args.features,
                        log_every=args.log_every, device=args.device)


if __name__ == "__main__":
    main()
