"""3D Gaussian Splatting training (port of pixie_tpu/recon/train_gaussians.py).

Reference: gaussian-splatting/train.py:31-160: per-iteration random camera,
render, L1 + 0.2 * (1 - SSIM) loss, Adam with per-group learning rates,
densify-and-prune every 100 iters between 500 and 15000 (split high-grad
large gaussians / clone high-grad small ones, prune low-opacity), opacity
reset every 3000 iterations.

The port trains exactly N gaussians: JAX's padding to a power-of-two
capacity (``pad_params``) only avoids TPU recompiles and is not ported, nor
is its scan-chunked loop (``PIXIE_GS_SCAN``), a dispatch schedule with the
per-step loop's results.  The host rng draws in JAX's order (one view index
a step, then the split noise at each densify event), so the view sequence
and the densify children are JAX's.  The screen-space gradient comes from
the rasterizer's ``mean2d_offset`` hook, as in JAX.  Densify and prune run
on the host in numpy; the optimizer is re-created whole after each densify
event and each opacity reset, as JAX's ``fresh_opt`` does.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.recon import gaussians as G
from pixie_tpu_torch.recon.rasterizer import Camera, rasterize, rasterize_tiled
from pixie_tpu_torch.recon.train_field import load_dataset

PARAM_KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


@dataclasses.dataclass
class GSTrainConfig:
    iterations: int = 10000
    lr_xyz: float = 1.6e-4
    lr_feature: float = 2.5e-3
    lr_opacity: float = 0.05
    lr_scaling: float = 5e-3
    lr_rotation: float = 1e-3
    lambda_dssim: float = 0.2
    densify_from: int = 500
    densify_until: int = 15000
    densify_interval: int = 100
    densify_grad_threshold: float = 2e-4
    opacity_reset_interval: int = 3000
    prune_opacity: float = 0.005
    percent_dense: float = 0.01
    sh_degree: int = 3
    white_background: bool = False
    seed: int = 0
    # tile-culled rasterization: "auto" switches to the tiled path when the
    # dense O(N*H*W) blend would exceed ~2^31 gaussian-pixel pairs
    tiled: str = "auto"   # "auto" | "on" | "off"
    tile_cap: int = 1024
    max_tiles_side: int = 6


@functools.lru_cache(maxsize=8)
def _gauss_band(n: int, window: int, sigma: float) -> np.ndarray:
    """(n, n) banded Gaussian-blur matrix == 'SAME' zero-padded 1-D conv
    (the 2D window is an outer product, so the blur is A_h @ X @ A_w^T)."""
    half = window // 2
    x = np.arange(window, dtype=np.float64) - half
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    d = np.arange(n)[None, :] - np.arange(n)[:, None] + half
    a = np.where((d >= 0) & (d < window), g[np.clip(d, 0, window - 1)], 0.0)
    return a.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _band(n: int, window: int, sigma: float, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_gauss_band(n, window, sigma), device=device)


def ssim(img1, img2, window: int = 11, sigma: float = 1.5):
    """Gaussian-windowed SSIM (utils/loss_utils.py ssim) of two (H, W, C)
    images; the separable window is two banded float32 matmuls, as in JAX.
    On CUDA the trainer keeps them in full float32 (TF32 off)."""
    h, w = img1.shape[0], img1.shape[1]
    ah = _band(h, window, sigma, img1.device)
    aw = _band(w, window, sigma, img1.device)
    img1 = img1.permute(2, 0, 1)
    img2 = img2.permute(2, 0, 1)

    def filt(x):
        # (C, H, W): blur rows then columns; A is symmetric
        return torch.matmul(torch.matmul(ah, x), aw)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    c1, c2 = 0.01**2, 0.03**2
    return torch.mean(((2 * mu12 + c1) * (2 * s12 + c2))
                      / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))


def blender_viewmat(c2w: np.ndarray) -> np.ndarray:
    """Blender/NeRF c2w (look down -z, y up) -> COLMAP-style w2c with camera
    looking down +z (as the rasterizer expects)."""
    c2w = np.asarray(c2w, np.float32).copy()
    c2w[:3, 1] *= -1  # y down
    c2w[:3, 2] *= -1  # z forward
    return np.linalg.inv(c2w).astype(np.float32)


def make_optimizer(params: dict, cfg: GSTrainConfig, spatial_scale: float):
    """Adam with one param group per key (optax.adam per key in JAX: eps 1e-15
    added outside the square root, as torch.optim.Adam adds it)."""
    lrs = {
        "xyz": cfg.lr_xyz * spatial_scale,
        "f_dc": cfg.lr_feature,
        "f_rest": cfg.lr_feature / 20.0,
        "opacity": cfg.lr_opacity,
        "scaling": cfg.lr_scaling,
        "rotation": cfg.lr_rotation,
    }
    return torch.optim.Adam([{"params": [params[k]], "lr": lr, "name": k}
                             for k, lr in lrs.items()], eps=1e-15)


def densify_and_prune(params, grad_accum, denom, cfg: GSTrainConfig,
                      spatial_scale: float, rng):
    """Host-side split/clone/prune (gaussian_model.py densify_and_prune);
    returns the new parameters as numpy arrays."""
    p = {k: v.detach().cpu().numpy() for k, v in params.items()}
    grads = np.asarray(grad_accum) / np.maximum(np.asarray(denom), 1)
    scales = np.exp(p["scaling"]).max(axis=1)
    high_grad = grads >= cfg.densify_grad_threshold
    big = scales > cfg.percent_dense * spatial_scale

    clone_mask = high_grad & ~big
    split_mask = high_grad & big
    keep_opacity = 1.0 / (1.0 + np.exp(-p["opacity"][:, 0])) > cfg.prune_opacity

    new_parts = []
    # clones: copy as-is
    if clone_mask.any():
        new_parts.append({k: v[clone_mask] for k, v in p.items()})
    # splits: two children sampled inside the parent, scale / 1.6
    if split_mask.any():
        parent = {k: v[split_mask] for k, v in p.items()}
        for _ in range(2):
            noise = rng.normal(size=parent["xyz"].shape).astype(np.float32)
            child = {k: v.copy() for k, v in parent.items()}
            child["xyz"] = parent["xyz"] + noise * np.exp(parent["scaling"])
            child["scaling"] = parent["scaling"] - np.log(1.6)
            new_parts.append(child)
    keep = keep_opacity & ~split_mask  # split parents removed

    merged = {k: v[keep] for k, v in p.items()}
    for part in new_parts:
        merged = {k: np.concatenate([merged[k], part[k]]) for k in merged}
    return merged


def _leaves(arrays: dict, device) -> dict:
    """Fresh float32 leaf tensors on ``device`` from arrays or tensors."""
    return {k: torch.as_tensor(arrays[k], dtype=torch.float32, device=device)
            .clone().requires_grad_(True) for k in PARAM_KEYS}


def train_gaussian_splatting(
    data_dir: str | Path,
    output_dir: str | Path,
    iterations: int = 10000,
    cfg: GSTrainConfig | None = None,
    init_points: np.ndarray | None = None,
    log_every: int = 1000,
    image_downscale: int = 1,
    device: str | torch.device = "cuda",
    on_step=None,
):
    """Train a 3DGS model on the capture in ``data_dir``; writes
    ``point_cloud/iteration_K/point_cloud.ply`` and ``metrics.json`` under
    ``output_dir`` and returns the final parameters (tensors on ``device``).
    ``on_step(it, loss, l1, n_gaussians)``, when given, is called after each
    step with the step's loss and L1 as device scalars."""
    cfg = cfg or GSTrainConfig(iterations=iterations)
    device = torch.device(device)
    if device.type == "cuda":
        # JAX runs the SSIM at Precision.HIGHEST: keep its matmuls in float32
        torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(cfg.seed)
    output_dir = Path(output_dir)

    dataset = load_dataset(data_dir)
    if init_points is None and "points3d" in dataset:
        # COLMAP capture: seed from the sparse reconstruction (the
        # reference's fetchPly/BasicPointCloud path, scene/__init__.py)
        init_points = np.asarray(dataset["points3d"], np.float32)
    images = dataset["images"]
    if image_downscale > 1:
        images = images[:, ::image_downscale, ::image_downscale]
    h, w = images.shape[1:3]
    fx, fy, cx, cy = (v / image_downscale for v in dataset["intrinsics"])
    cam = Camera(h, w, fx, fy, cx, cy)
    viewmats = np.stack([blender_viewmat(c) for c in dataset["c2w"]])
    bg = 1.0 if cfg.white_background else 0.0

    if init_points is None:
        init_points = rng.uniform(-0.5, 0.5, (5000, 3)).astype(np.float32)
    params = _leaves(G.create_from_points(init_points, sh_degree=cfg.sh_degree,
                                          device=device), device)
    spatial_scale = float(np.linalg.norm(viewmats[:, :3, 3], axis=1).max()) or 1.0
    opt = make_optimizer(params, cfg, spatial_scale)

    if cfg.tiled == "on":
        use_tiled = True
    elif cfg.tiled == "off":
        use_tiled = False
    else:
        # JAX's rule, on JAX's power-of-two capacity, so both pick one path
        capacity = int(2 ** np.ceil(np.log2(init_points.shape[0] + 1)))
        use_tiled = (capacity * cam.height * cam.width > 2**31
                     and cam.height % 16 == 0 and cam.width % 16 == 0)

    def render(params, viewmat, offset=None):
        if use_tiled:
            return rasterize_tiled(params, viewmat, cam, bg_color=bg,
                                   tile_cap=cfg.tile_cap,
                                   max_tiles_side=cfg.max_tiles_side,
                                   mean2d_offset=offset)
        return rasterize(params, viewmat, cam, bg_color=bg, mean2d_offset=offset)

    viewmats_dev = torch.as_tensor(viewmats, device=device)
    images_dev = torch.as_tensor(np.ascontiguousarray(images, np.float32), device=device)
    n = len(init_points)
    grad_accum = torch.zeros(n, device=device)
    denom = torch.zeros(n, device=device)
    t0 = time.time()
    for it in range(1, cfg.iterations + 1):
        vi = int(rng.integers(len(viewmats)))
        offset = torch.zeros((n, 2), device=device, requires_grad=True)
        img, _ = render(params, viewmats_dev[vi], offset)
        gt = images_dev[vi]
        l1 = torch.abs(img - gt).mean()
        loss = (1.0 - cfg.lambda_dssim) * l1 + cfg.lambda_dssim * (1.0 - ssim(img, gt))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss, l1 = loss.detach(), l1.detach()
        opt.step()
        with torch.no_grad():
            sg = torch.linalg.norm(offset.grad, dim=-1)
            seen = sg > 0
            grad_accum += torch.where(seen, sg, 0.0)
            denom += seen.to(torch.float32)
        if on_step is not None:
            on_step(it, loss, l1, n)

        in_densify = cfg.densify_from <= it < cfg.densify_until
        if in_densify and it % cfg.densify_interval == 0:
            merged = densify_and_prune(params, grad_accum.cpu().numpy(), denom.cpu().numpy(),
                                       cfg, spatial_scale, rng)
            params = _leaves(merged, device)
            opt = make_optimizer(params, cfg, spatial_scale)
            n = len(merged["xyz"])
            grad_accum = torch.zeros(n, device=device)
            denom = torch.zeros(n, device=device)

        if it % cfg.opacity_reset_interval == 0:
            with torch.no_grad():
                params["opacity"].clamp_(max=float(G.inverse_sigmoid(0.01)))
            opt = make_optimizer(params, cfg, spatial_scale)

        if it % log_every == 0:
            logging.info("gs iter %d loss %.4f l1 %.4f gaussians %d (%.1fs)",
                         it, loss.item(), l1.item(), n, time.time() - t0)

    out = output_dir / "point_cloud" / f"iteration_{cfg.iterations}"
    out.mkdir(parents=True, exist_ok=True)
    final = {k: v.detach() for k, v in params.items()}
    G.save_gaussian_ply(out / "point_cloud.ply", final)
    logging.info("saved %d gaussians to %s", n, out)

    # train-view PSNR report (reference gaussian-splatting/train.py:100-112
    # logs train PSNR; every view is evaluated at the final iterate)
    from pixie_tpu_torch.utils.metrics import psnr  # noqa: PLC0415

    with torch.no_grad():
        psnrs = [psnr(torch.clamp(render(final, vm)[0], 0, 1).cpu().numpy(), img)
                 for vm, img in zip(viewmats_dev, images)]
    metrics = {
        "psnr_per_view": [float(p) for p in psnrs],
        "psnr_mean": float(np.mean(psnrs)),
        "n_gaussians": int(n),
        "train_s": time.time() - t0,
    }
    output_dir.mkdir(parents=True, exist_ok=True)
    (output_dir / "metrics.json").write_text(json.dumps(metrics, indent=1))
    logging.info("gs train PSNR %.2f dB over %d views", metrics["psnr_mean"], len(psnrs))
    return final


def search_for_max_iteration(point_cloud_dir: str | Path) -> int:
    """searchForMaxIteration (gs_simulation.py:215-227); -1 when none."""
    best = -1
    for p in Path(point_cloud_dir).glob("iteration_*"):
        try:
            best = max(best, int(p.name.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return best


def main(argv=None):
    """3DGS training CLI (reference: gaussian-splatting/train.py -s <data>).
    Usage:
        python -m pixie_tpu_torch.recon.train_gaussians --data <capture_dir> \
            --output <model_dir> [--iters N] [--downscale K] [--device cuda]
    """
    import argparse  # noqa: PLC0415

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--data", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--iters", type=int, default=10000)
    ap.add_argument("--downscale", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    train_gaussian_splatting(
        args.data, args.output, iterations=args.iters,
        image_downscale=args.downscale, device=args.device,
    )


if __name__ == "__main__":
    main()
