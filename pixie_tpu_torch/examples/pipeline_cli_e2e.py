"""Golden-path run of the pipeline CLI itself (port of
examples/pipeline_cli_e2e.py).

Unlike ``pixie_e2e`` (which drives the libraries in-process), this runs the
orchestrator entry point, ``python -m pixie_tpu_torch.pipeline obj_id=...
material_mode=neural`` (reference pipeline.py:438-517), in a subprocess
against a synthetic asset: only the U-Net checkpoints are "provided
externally" (trained tiny here).  Stages covered: data -> field training
-> 3DGS training -> voxelization -> neural segmentation (checkpoint
discovery, inference, PLY mapping) -> MPM rollout with frame PLY exports;
then the same with material_mode=vlm (MockVLM + the hash text encoder).

Usage: python -m pixie_tpu_torch.examples.pipeline_cli_e2e [--out DIR] [--cpu]
"""

import argparse
import json
import logging
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from pixie_tpu_torch.examples import default_out


def run_pipeline(overrides: list[str], cpu: bool) -> None:
    """``python -m pixie_tpu_torch.pipeline <overrides>`` in a subprocess."""
    cmd = [sys.executable, "-m", "pixie_tpu_torch.pipeline", *overrides]
    cmd += ["--cpu"] if cpu else []
    subprocess.run(cmd, check=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="pipeline_cli_e2e")
    ap.add_argument("--out", default=default_out("pixie_cli_e2e"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--field-iters", type=int, default=40)
    ap.add_argument("--gs-iters", type=int, default=5)
    ap.add_argument("--unet-steps", type=int, default=2)
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    base = Path(args.out)
    grid = 16
    obj = "demo_obj"

    # ---- synthetic capture + per-object sim config ------------------------
    from pixie_tpu_torch.examples.pixie_e2e import make_synthetic_views

    data_dir = base / "data" / obj
    if not (data_dir / "transforms.json").exists():
        make_synthetic_views(data_dir)

    # synthetic per-view "CLIP" patch features for field distillation (the
    # real pipeline extracts these; no CLIP weights offline)
    feat_npy = base / "synthetic_clip_patches.npy"
    if not feat_npy.exists():
        rng0 = np.random.default_rng(7)
        np.save(feat_npy, rng0.normal(
            size=(8, 4, 4, 768)).astype(np.float16))

    sim_cfg_dir = base / "config" / "real_scene"
    sim_cfg_dir.mkdir(parents=True, exist_ok=True)
    (sim_cfg_dir / f"custom_{obj}_config.json").write_text(json.dumps({
        "material": "jelly", "n_grid": 24, "grid_lim": 2.0,
        "substep_dt": 1e-4, "frame_dt": 2e-3, "frame_num": 2,
        "g": 9.8, "density": 300.0, "E": 2e5, "nu": 0.35,
    }))

    # ---- tiny externally-provided U-Net checkpoints (default arch) --------
    from pixie_tpu_torch.train.trainer import TrainConfig, Trainer

    rng = np.random.default_rng(0)
    feat = rng.normal(size=(1, grid, grid, grid, 768)).astype(np.float32)
    mat_id = rng.integers(0, 8, (1, grid, grid, grid))
    cont = rng.normal(size=(1, grid, grid, grid, 3)).astype(np.float32)
    mask = (mat_id != 7).astype(np.float32)
    t0 = time.time()
    for mode, ckpt_dir in (("discrete", "checkpoints_discrete"),
                           ("continuous", "checkpoints_continuous_mse")):
        tr = Trainer(TrainConfig(mode=mode, batch_size=1, lr=1e-3, grid_size=grid),
                     device=device)
        tr.setup(steps_per_epoch=1)
        batch = (feat, mat_id, mask) if mode == "discrete" else (feat, cont, mask)
        for _ in range(args.unet_steps):
            tr.train_step(batch)
        tr.save_checkpoint(base / ckpt_dir, 0)
    logging.info("[ckpts] tiny U-Nets saved (%.1fs)", time.time() - t0)

    # ---- the CLI ------------------------------------------------------------
    common = [
        f"obj_id={obj}",
        f"paths.base_path={base}",
        f"paths.physgaussian_config_dir={base}/config",
        "is_objaverse_object=false",
        f"training_3d.nerf_max_num_iterations={args.field_iters}",
        f"training_3d.clip_features_path={feat_npy}",
        f"training_3d.gs_iterations={args.gs_iters}",
        f"voxelization.grid_size={grid}",
        f"training.default_grid_size={grid}",
        "physics.n_frames=2",
        "physics.compile_video=false",
    ]
    t0 = time.time()
    run_pipeline(["material_mode=neural", *common, "training_3d.nerf_rays_per_batch=256",
                  "training_3d.nerf_n_coarse=24", "training_3d.nerf_n_fine=16"], args.cpu)
    logging.info("[cli] neural mode completed in %.1fs", time.time() - t0)

    # ---- second golden path: material_mode=vlm (MockVLM + hash encoder) ---
    t0 = time.time()
    run_pipeline(["material_mode=vlm", "obj_class=toy", "+vlm_model=mock",
                  "segmentation.allow_hash_text_encoder=true", *common], args.cpu)
    logging.info("[cli] vlm mode completed in %.1fs", time.time() - t0)
    vlm_sim = base / "mpm_sim_outputs" / "vlm" / obj / "sample_0"
    assert (vlm_sim / "sim_info.json").exists(), "vlm-mode sim missing"

    # ---- the golden-path artifacts ------------------------------------------
    render_out = base / "render_outputs" / obj
    assert (render_out / "clip_features_features.npy").exists()
    assert (render_out / "sample_0" / "mapped_preds.ply").exists()
    sim_out = base / "mpm_sim_outputs" / "neural" / obj / "sample_0"
    plys = sorted((sim_out / "ply_files").glob("frame_*.ply"))
    assert (sim_out / "sim_info.json").exists(), "sim_info.json missing"
    assert plys, "no frame PLYs exported"
    print(f"OK: pipeline CLI golden path produced {len(plys)} frame PLYs "
          f"under {sim_out} on {device}")
    return {"plys": plys, "sim_info": [sim_out / "sim_info.json", vlm_sim / "sim_info.json"]}


if __name__ == "__main__":
    main()
