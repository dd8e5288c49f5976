"""Output-rendering orchestrator (port of the root render.py, reference
render.py:1-313 rebuilt).

Modes (render.modes):
  nerf     — render field test views (replaces `ns-render`)
  gs       — render 3DGS checkpoint test views (the dense rasterizer, no Blender)
  sim      — render simulated frame PLYs as point-cloud images
  feature_colors — paint material predictions onto the mesh (host)
  blender_glb / blender_gs — external Blender paths, gated on the binary.

The field and the gaussians render on the card unless ``main`` is asked for
the CPU; the point-cloud frames, the mesh paint and the PNGs are host code.

Usage: python -m pixie_tpu_torch.render obj_id=... +render_modes='[nerf,gs]'
"""

from __future__ import annotations

import logging
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.config import compose
from pixie_tpu_torch.utils.paths import get_output_paths, resolve_paths

# the bpy scripts Blender runs (data for the Blender binary, never imported)
BLENDER_SCRIPTS = Path(__file__).resolve().parent / "blender"


def _orbit_camera(vi: int, n_views: int, radius: float):
    """(position, right, up, forward) of orbit view ``vi``, looking at the origin."""
    theta = 2 * np.pi * vi / n_views
    cam_pos = radius * np.array([np.cos(theta), np.sin(theta), 0.4], np.float32)
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    return cam_pos, right, np.cross(right, fwd), fwd


@torch.no_grad()
def render_nerf_views(cfg, paths, n_views: int = 8, res: int = 256,
                      device: str | torch.device = "cuda"):
    """Orbit renders of the trained field (render.py:45-198 equivalent)."""
    from pixie_tpu_torch.recon.field import RenderConfig, render_rays  # noqa: PLC0415
    from pixie_tpu_torch.recon.field_adapter import load_field_adapter  # noqa: PLC0415

    adapter = load_field_adapter(paths["nerf_output"], device=device)
    out_dir = Path(paths["render_output"]) / "nerf_views"
    out_dir.mkdir(parents=True, exist_ok=True)

    rcfg = RenderConfig(n_coarse=48, n_fine=48)
    for vi in range(n_views):
        cam_pos, right, up, fwd = _orbit_camera(vi, n_views, 1.5)
        fx = 0.5 * res / np.tan(0.4)
        ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
        d = np.stack([(xs + 0.5 - res / 2) / fx, -(ys + 0.5 - res / 2) / fx,
                      -np.ones_like(xs, np.float32)], -1)
        dirs = d @ np.stack([right, up, -fwd], 0)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = np.broadcast_to(cam_pos, dirs.shape).reshape(-1, 3)
        out = render_rays(
            adapter.nerf, None,
            torch.as_tensor(np.ascontiguousarray(origins, np.float32), device=adapter.device),
            torch.as_tensor(dirs.reshape(-1, 3).astype(np.float32), device=adapter.device),
            rcfg, train=False, with_features=False,
        )
        img = out["rgb"].reshape(res, res, 3).cpu().numpy()
        _save_png(out_dir / f"view_{vi:03d}.png", img)
    logging.info("nerf views -> %s", out_dir)
    return out_dir


@torch.no_grad()
def render_gs_views(cfg, paths, n_views: int = 8, res: int = 256,
                    device: str | torch.device = "cuda"):
    """Rasterize the 3DGS checkpoint from orbit cameras (render.py:260-313)."""
    from pixie_tpu_torch.recon.gaussians import load_gaussian_ply  # noqa: PLC0415
    from pixie_tpu_torch.recon.rasterizer import Camera, rasterize  # noqa: PLC0415
    from pixie_tpu_torch.recon.train_gaussians import search_for_max_iteration  # noqa: PLC0415

    device = torch.device(device)
    pc_dir = Path(paths["gs_output"]) / "point_cloud"
    it = search_for_max_iteration(pc_dir)
    params = {k: v.to(device) for k, v in
              load_gaussian_ply(pc_dir / f"iteration_{it}" / "point_cloud.ply").items()}
    out_dir = Path(paths["render_output"]) / "gs_views"
    out_dir.mkdir(parents=True, exist_ok=True)
    cam = Camera(res, res, fx=res / 1.2, fy=res / 1.2, cx=res / 2, cy=res / 2)

    for vi in range(n_views):
        cam_pos, right, up, fwd = _orbit_camera(vi, n_views, 1.8)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, -up, fwd, cam_pos
        viewmat = np.linalg.inv(c2w).astype(np.float32)
        img, _ = rasterize(params, torch.as_tensor(viewmat, device=device), cam,
                           bg_color=1.0 if cfg.physics.white_bg else 0.0)
        _save_png(out_dir / f"view_{vi:03d}.png", img.cpu().numpy())
    logging.info("gs views -> %s", out_dir)
    return out_dir


def render_sim_frames(cfg, paths, res: int = 512):
    """Simulation video.  When the sim loop already rasterized GS frames
    (physics.render_img, the reference's flagship output), compile those;
    otherwise fall back to an orthographic point scatter of the material
    PLYs (pre-GS-render legacy path)."""
    from pixie_tpu_torch.utils.io import read_ply  # noqa: PLC0415
    from pixie_tpu_torch.utils.viz import compile_video, render_pointcloud_image  # noqa: PLC0415

    sim_dir = Path(paths["physgaussian_output"]) / f"sample_{cfg.physics.sample_id}"
    ply_dir = sim_dir / "ply_files"
    out_dir = sim_dir / "frames"
    out_dir.mkdir(parents=True, exist_ok=True)

    gs_frames = sorted(out_dir.glob("*.png"))
    if gs_frames:
        if cfg.physics.compile_video:
            compile_video(out_dir, sim_dir / "simulation.mp4",
                          fps=cfg.output_rendering.fps)
        logging.info("sim frames (GS-rasterized) -> %s", out_dir)
        return out_dir

    frames = sorted(ply_dir.glob("frame_*.ply"))
    for f in frames:
        v = read_ply(f)["vertex"]
        if "material_id" not in (v.dtype.names or ()):
            continue  # gaussian-format PLY; frames/ should exist instead
        img = render_pointcloud_image(
            np.column_stack([v["x"], v["y"], v["z"]]),
            labels=np.asarray(v["material_id"]), res=res,
        )
        _save_png(out_dir / (f.stem + ".png"), img)
    if cfg.physics.compile_video and frames:
        compile_video(out_dir, sim_dir / "simulation.mp4",
                      fps=cfg.output_rendering.fps)
    logging.info("sim frames -> %s", out_dir)
    return out_dir


def render_feature_colored_mesh(cfg, paths, turntable_frames: int = 24):
    """Paint material predictions onto the object mesh and render turntables
    (apply_feature_colors.py equivalent, Blender-free: utils/mesh_paint.py)."""
    from pixie_tpu_torch.utils.mesh_paint import paint_mesh_with_predictions  # noqa: PLC0415
    from pixie_tpu_torch.utils.paths import sample_dir  # noqa: PLC0415

    sdir = Path(sample_dir(paths["render_output"], cfg.physics.sample_id))
    preds = sdir / "mapped_preds.ply"
    if not preds.exists():
        preds = sdir / "segmented_semantics.ply"
    mesh = Path(cfg.paths.get("data_dir", ".")) / f"{cfg.obj_id}.glb"
    if not mesh.exists():
        # fall back to painting the prediction cloud itself
        mesh = preds
    out_dir = Path(paths["render_output"]) / "feature_colors"
    outs = paint_mesh_with_predictions(
        mesh, preds, out_dir, turntable_frames=turntable_frames,
        fps=cfg.output_rendering.fps,
    )
    logging.info("feature-colored mesh -> %s", out_dir)
    return outs


def render_blender(cfg, paths, mode: str):
    """Shell out to the bundled bpy scripts (reference render.py:93-259:
    render_blender_gs builds a `blender -b -P pixie/blender/render_gs.py`
    command over the sim's ply_files; render_blender_glb the GLB analog)."""
    from pixie_tpu_torch.utils.proc import run_cmd  # noqa: PLC0415

    blender = str(cfg.paths.get("blender_path", "blender"))
    out_dir = Path(paths["blender_output"]) / mode
    out_dir.mkdir(parents=True, exist_ok=True)

    if mode == "blender_gs":
        rc = cfg.output_rendering.get("blender_render_gs", {})
        ply_dir = (Path(paths["physgaussian_output"])
                   / f"sample_{cfg.physics.sample_id}" / "ply_files")
        cmd = [
            blender, "-b", "-P", str(BLENDER_SCRIPTS / "render_gs.py"), "--",
            "--obj_id", cfg.obj_id,
            "--ply_dir", str(ply_dir),
            "--output_dir", str(out_dir),
            "--data_dir", str(cfg.paths.get("data_dir", ".")),
            "--blender_gs_addon_path",
            str(cfg.paths.get("blender_gs_addon_path", "")),
        ]
        blend = cfg.paths.get("blend_file_path")
        if blend:
            cmd += ["--blend_file_path", str(blend)]
        for key in ("camera_id", "rotate_around", "focal_length_ratio",
                    "resolution_x", "resolution_y", "cycles_samples",
                    "num_renders", "start_frame"):
            if rc.get(key) is not None:
                cmd += [f"--{key}", str(rc[key])]
        for flag in ("place_on_ground", "is_dropping", "transparent",
                     "save_blend"):
            if rc.get(flag, False):
                cmd.append(f"--{flag}")
        if rc.get("bg_color") is not None:
            cmd += ["--bg_color"] + [str(c) for c in rc["bg_color"]]
        for key, default in (("init_xyz", (0.0, 0.0, 0.0)),
                             ("xyz_rotation", (0.0, 0.0, 0.0))):
            cmd += [f"--{key}"] + [str(v) for v in rc.get(key, default)]
        if cfg.get("overwrite", False):
            cmd.append("--overwrite")
    else:  # blender_glb
        rc = cfg.output_rendering.get("blender_render_glb", {})
        sdir = Path(paths["render_output"]) / "feature_colors"
        mesh = sdir / "painted_mesh.glb"
        if not mesh.exists():
            mesh = Path(cfg.paths.get("data_dir", ".")) / f"{cfg.obj_id}.glb"
        cmd = [
            blender, "-b", "-P", str(BLENDER_SCRIPTS / "render_glb.py"), "--",
            "--obj", str(mesh),
            "--obj_id", cfg.obj_id,
            "--output_folder", str(out_dir),
            "--data_dir", str(cfg.paths.get("data_dir", ".")),
        ]
        blend = cfg.paths.get("blend_file_path")
        if blend:
            cmd += ["--blend_file_path", str(blend)]
        for key in ("views", "resolution", "scene_scale", "camera_id",
                    "focal_length", "cycles_samples"):
            if rc.get(key) is not None:
                cmd += [f"--{key}", str(rc[key])]
        if rc.get("transparent", False):
            cmd.append("--transparent")
    # (the JAX package passes run_cmd a step_name it does not take)
    run_cmd(cmd)
    return out_dir


def _save_png(path, img):
    from PIL import Image  # noqa: PLC0415

    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def main(argv=None, device: str | torch.device = "cuda"):
    logging.basicConfig(level=logging.INFO)
    overrides = list(sys.argv[1:] if argv is None else argv)
    cfg = compose(overrides=overrides)
    if not cfg.obj_id:
        raise ValueError("obj_id is required")
    cfg = resolve_paths(cfg)
    paths = get_output_paths(cfg, cfg.obj_id)
    modes = cfg.get("render_modes", cfg.output_rendering.render_modes)

    for mode in modes:
        t0 = time.perf_counter()
        if mode == "nerf":
            render_nerf_views(cfg, paths, device=device)
        elif mode == "gs":
            render_gs_views(cfg, paths, device=device)
        elif mode == "sim":
            render_sim_frames(cfg, paths)
        elif mode == "feature_colors":
            render_feature_colored_mesh(cfg, paths)
        elif mode in ("blender_glb", "blender_gs"):
            if shutil.which(str(cfg.paths.get("blender_path", "blender"))) is None:
                logging.warning("blender not found; skipping %s", mode)
            else:
                render_blender(cfg, paths, mode)
        else:
            raise ValueError(f"unknown render mode {mode!r}")
        logging.info("render mode %s: %.3f s", mode, time.perf_counter() - t0)


if __name__ == "__main__":
    main()
