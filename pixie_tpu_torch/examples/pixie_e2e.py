"""Golden-path end-to-end demo, the nbs/pixie.ipynb equivalent (port of
examples/pixie_e2e.py).

Runs the whole neural pipeline in-process on a synthetic asset, with no
network and no Blender:

  synthetic multi-view renders -> feature-field training -> voxelization ->
  U-Net training (tiny) -> combined inference -> prediction -> material PLY
  -> MPM rollout -> frame renders.

Usage: python -m pixie_tpu_torch.examples.pixie_e2e [--out DIR] [--cpu]
"""

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np

from pixie_tpu_torch.examples import default_out


def make_synthetic_views(root: Path, n_views=8, res=32):
    """Analytic red-sphere renders + transforms.json."""
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    fov = 0.8
    frames = []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        cam_pos = 2.0 * np.array([np.cos(theta), np.sin(theta), 0.4])
        fwd = -cam_pos / np.linalg.norm(cam_pos)
        right = np.cross(fwd, [0, 0, 1.0]); right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, cam_pos
        fx = 0.5 * res / np.tan(0.5 * fov)
        img = np.ones((res, res, 3), np.float32)  # white background
        for py in range(res):
            for px in range(res):
                d = np.array([(px + 0.5 - res / 2) / fx,
                              -(py + 0.5 - res / 2) / fx, -1.0])
                d = c2w[:3, :3] @ d
                d /= np.linalg.norm(d)
                b = 2 * np.dot(cam_pos, d)
                c = np.dot(cam_pos, cam_pos) - 0.35**2
                if b * b - 4 * c > 0:
                    img[py, px] = [0.9, 0.2, 0.15]
        fname = f"r_{i}.png"
        Image.fromarray((img * 255).astype(np.uint8)).save(root / fname)
        frames.append({"file_path": fname, "transform_matrix": c2w.tolist()})
    (root / "transforms.json").write_text(
        json.dumps({"camera_angle_x": fov, "frames": frames})
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="pixie_e2e")
    ap.add_argument("--out", default=default_out("pixie_e2e"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--field-iters", type=int, default=400)
    ap.add_argument("--unet-steps", type=int, default=10)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    base = Path(args.out)
    grid = 16          # small voxel grid for the demo
    feat_ch = 16

    # ---- 1. synthetic multi-view data -------------------------------------
    t0 = time.time()
    data_dir = base / "data" / "demo_obj"
    if not (data_dir / "transforms.json").exists():
        make_synthetic_views(data_dir)
    logging.info("[1] views ready (%.1fs)", time.time() - t0)

    # ---- 2. feature-field training ----------------------------------------
    from pixie_tpu_torch.recon.field import RenderConfig
    from pixie_tpu_torch.recon.train_field import FieldTrainConfig, train_feature_field

    field_out = base / "models" / "demo_obj" / "f3rm"
    t0 = time.time()
    train_feature_field(
        data_dir, field_out,
        cfg=FieldTrainConfig(
            max_iterations=args.field_iters, rays_per_batch=512,
            render=RenderConfig(n_coarse=24, n_fine=16, bg_color=1.0),
        ),
        log_every=max(args.field_iters - 1, 1), device=device,
    )
    logging.info("[2] field trained (%.1fs)", time.time() - t0)

    # ---- 3. voxelize -------------------------------------------------------
    from pixie_tpu_torch.recon.field_adapter import load_field_adapter
    from pixie_tpu_torch.voxel.voxelize import extract_feature_voxel_grid

    class DemoField:
        """Wrap the trained density field; synthesize features from density +
        position (stands in for CLIP distillation at demo scale)."""

        def __init__(self, adapter):
            self.adapter = adapter

        def query(self, pts):
            out = self.adapter.query(pts)
            d = out["density"].cpu().numpy()
            pos = np.asarray(pts)
            feats = np.concatenate(
                [np.tanh(d), pos, np.tile(np.tanh(d), (1, feat_ch - 4))], axis=1
            )
            return {"density": d, "feature": feats[:, :feat_ch]}

        def get_rgb(self, pts):
            return self.adapter.get_rgb(pts).cpu().numpy()

    render_out = base / "render_outputs" / "demo_obj"
    t0 = time.time()
    adapter = load_field_adapter(field_out, device=device)
    paths = extract_feature_voxel_grid(
        DemoField(adapter), render_out / "clip_features.npz",
        voxel_size=1.0 / grid, expected_grid=grid, batch_size=2048,
        nb_neighbors=10, run_outlier_filter=True, device=device,
    )
    if "wait" in paths:  # stage 4 reads the features npy from disk
        paths["wait"]()
    mask = np.load(paths["mask"])
    logging.info("[3] voxelized: %d occupied voxels (%.1fs)", int(mask.sum()),
                 time.time() - t0)
    if mask.sum() == 0:
        raise SystemExit("voxelization produced an empty mask — field training failed")

    # ---- 4. tiny U-Net training on synthetic labels ------------------------
    from pixie_tpu_torch.train.data import MaterialVoxelDataset
    from pixie_tpu_torch.train.trainer import TrainConfig, Trainer
    from pixie_tpu_torch.utils.norm import REFERENCE_RANGES

    sample_dir = render_out / "sample_0"
    sample_dir.mkdir(exist_ok=True)
    mat = np.zeros((grid, grid, grid, 4), np.float32)
    mat[..., 3] = 7
    mat[mask > 0, 0] = 400.0
    mat[mask > 0, 1] = 2e5
    mat[mask > 0, 2] = 0.35
    mat[mask > 0, 3] = 0
    np.save(sample_dir / "material_grid.npy", mat)

    dataset = MaterialVoxelDataset(
        base / "render_outputs", REFERENCE_RANGES, grid_size=grid,
        feature_channels=feat_ch,
    )
    small = dict(feature_channels=feat_ch, cond_dim=8, model_channels=8,
                 num_res_blocks=1, channel_mult=(1, 2), grid_size=grid)
    t0 = time.time()
    ckpts = {}
    for mode, key in (("discrete", "seg"), ("continuous", "cont")):
        tr = Trainer(TrainConfig(mode=mode, batch_size=1, lr=1e-3, **small), device=device)
        tr.setup(steps_per_epoch=1)
        feat, cont, mat_id, m, info = dataset[0]
        batch = (
            (feat[None], mat_id[None], m[None]) if mode == "discrete"
            else (feat[None], cont[None], m[None])
        )
        for _ in range(args.unet_steps):
            loss, aux = tr.train_step(batch)
        ckpts[key] = tr.save_checkpoint(base / f"ckpt_{mode}", 0)
    logging.info("[4] U-Nets trained, final loss %.4f (%.1fs)", float(loss),
                 time.time() - t0)

    # ---- 5. combined inference + prediction mapping ------------------------
    from pixie_tpu_torch.train.inference import run_inference
    from pixie_tpu_torch.voxel.map_pred_to_coords import map_pred_to_ply

    neural_dir = base / "inference_results"
    report = run_inference(
        dataset, ckpts["seg"], ckpts["cont"], neural_dir, batch_size=1,
        model_kwargs=dict(cond_dim=8, model_channels=8, num_res_blocks=1,
                          channel_mult=(1, 2)), device=device,
    )
    logging.info("[5] inference: seg_acc %.3f over %d objects",
                 report["seg_acc"]["mean"], report["n_objects"])

    mapped = sample_dir / "mapped_preds.ply"
    map_pred_to_ply(
        neural_dir / "demo_obj" / "sample_0_pred.npy",
        paths["mask"], paths["npz"], mapped, "demo_obj", REFERENCE_RANGES,
    )

    # ---- 6. MPM rollout -----------------------------------------------------
    from pixie_tpu_torch.sim.driver import run_simulation

    sim_cfg = {
        "material": "jelly", "n_grid": 24, "grid_lim": 2.0,
        "substep_dt": 1e-4, "frame_dt": 2e-3, "frame_num": args.frames,
        "g": 9.8, "density": 300.0, "E": 2e5, "nu": 0.35,
    }
    cfg_path = base / "sim_config.json"
    cfg_path.write_text(json.dumps(sim_cfg))
    t0 = time.time()
    info = run_simulation(mapped, cfg_path, base / "sim_out", save_ply=True, device=device)
    logging.info(
        "[6] simulated %d frames x %d substeps (%s solver) in %.1fs",
        info["frames"], info["substeps_per_frame"], info["solver"], time.time() - t0,
    )

    # ---- 7. render frames ---------------------------------------------------
    from PIL import Image

    from pixie_tpu_torch.utils.io import read_ply
    from pixie_tpu_torch.utils.viz import render_pointcloud_image

    frames_dir = base / "sim_out" / "frames"
    frames_dir.mkdir(exist_ok=True)
    pngs = []
    for f in sorted((base / "sim_out" / "ply_files").glob("frame_*.ply")):
        v = read_ply(f)["vertex"]
        img = render_pointcloud_image(
            np.column_stack([v["x"], v["y"], v["z"]]),
            labels=np.asarray(v["material_id"]), res=256,
        )
        pngs.append(frames_dir / (f.stem + ".png"))
        Image.fromarray((img * 255).astype(np.uint8)).save(pngs[-1])
    logging.info("[7] done: artifacts under %s", base)
    return {"mapped_ply": mapped, "frames": pngs, "sim_info": base / "sim_out" / "sim_info.json",
            "ckpts": ckpts, "report": report}


if __name__ == "__main__":
    main()
