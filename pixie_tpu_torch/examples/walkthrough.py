"""Narrative acceptance walkthrough, the nbs/pixie.ipynb analog (port of
examples/walkthrough.py).

Runs the CLI golden path on a synthetic asset (``pipeline_cli_e2e``) when
its artifacts are missing, then renders and inspects each artifact in
order, writing numbered PNG/mp4 files and a printed narrative to
--out/walkthrough.

Section <-> notebook-cell map (reference nbs/pixie.ipynb):
  1 field render      <- cell "Verify that the distilled NeRF field ..."
  2 voxel point cloud <- cell "Verify the voxel grid is correct"
  3 segmentation      <- get_vlm_results / material_segmentation cells
  4 material field    <- 5-panel viz(part_label, material_id, E, density, nu)
  5 simulation video  <- Video(.../frames/output.mp4) + gs_renders cells

Usage: python -m pixie_tpu_torch.examples.walkthrough [--out DIR] [--cpu]
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


def section(n, title):
    print(f"\n{'=' * 70}\n## {n}. {title}\n{'=' * 70}", flush=True)


def load_fields(field_dir: Path, device) -> dict:
    """The field checkpoint's nerf (and proposal) modules, for rendering."""
    from pixie_tpu_torch.recon.field import NerfField, ProposalField
    from pixie_tpu_torch.recon.train_field import load_field_checkpoint

    params = load_field_checkpoint(field_dir)
    meta_path = field_dir / "checkpoints" / "field_meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    fields = {"nerf": NerfField(encoding=meta.get("encoding", "mxu"))}
    if "prop" in params:
        fields["prop"] = ProposalField()
    for name, module in fields.items():
        module.load_state_dict(params[name])
        module.to(device).eval()
    return fields


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="walkthrough")
    ap.add_argument("--out", default=default_out("pixie_walkthrough"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    logging.basicConfig(level=logging.WARNING)
    base = Path(args.out)
    wt = base / "walkthrough"
    wt.mkdir(parents=True, exist_ok=True)
    obj = "demo_obj"

    # ---- 0. pipeline golden path (the CLI, idempotent) ---------------------
    section(0, "Run the pipeline (python -m pixie_tpu_torch.pipeline obj_id=... analog)")
    render_out = base / "render_outputs" / obj
    mapped_ply = next(render_out.rglob("mapped_preds*.ply"), None) if render_out.exists() else None
    if mapped_ply is None:
        cmd = [sys.executable, "-m", "pixie_tpu_torch.examples.pipeline_cli_e2e",
               "--out", str(base)] + (["--cpu"] if args.cpu else [])
        print("  artifacts missing -> running:", " ".join(cmd))
        t0 = time.time()
        subprocess.run(cmd, check=True)
        print(f"  pipeline done in {time.time() - t0:.0f}s")
    else:
        print("  artifacts found — reusing (delete --out to re-run)")

    from PIL import Image

    from pixie_tpu_torch.utils.io import read_ply
    from pixie_tpu_torch.utils.viz import compile_video, render_pointcloud_image

    # ---- 1. the distilled field ------------------------------------------
    section(1, "Verify the distilled field (held-out view render + PSNR)")
    from pixie_tpu_torch.recon.field import RenderConfig
    from pixie_tpu_torch.recon.train_field import load_blender_dataset, render_full_view
    from pixie_tpu_torch.utils.metrics import psnr

    fields = load_fields(base / "models" / obj / "f3rm", device)
    ds = load_blender_dataset(base / "data" / obj)
    vi = len(ds["images"]) - 1
    img = render_full_view(fields, ds["c2w"][vi], ds["intrinsics"], ds["hw"],
                           RenderConfig(n_coarse=24, n_fine=16, bg_color=1.0), device=device)
    p = psnr(np.clip(img, 0, 1), ds["images"][vi])
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).resize(
        (256, 256), Image.NEAREST).save(wt / "01_field_render.png")
    Image.fromarray((ds["images"][vi] * 255).astype(np.uint8)).resize(
        (256, 256), Image.NEAREST).save(wt / "01_field_gt.png")
    print(f"  held-out view {vi}: PSNR {p:.1f} dB -> 01_field_render.png "
          f"(gt: 01_field_gt.png)")

    # ---- 2. the voxel grid ------------------------------------------------
    section(2, "Verify the voxel grid (clip_features_pc.ply)")
    pc_path = render_out / "clip_features_pc.ply"
    v = read_ply(pc_path)["vertex"]
    pts = np.column_stack([v["x"], v["y"], v["z"]])
    rgb = np.column_stack([v["red"], v["green"], v["blue"]]) / 255.0
    img = render_pointcloud_image(pts, colors=rgb, res=384)
    Image.fromarray((img * 255).astype(np.uint8)).save(wt / "02_voxel_pc.png")
    print(f"  {len(pts)} occupied voxels, bounds "
          f"{pts.min(0).round(3)}..{pts.max(0).round(3)} -> 02_voxel_pc.png")

    # ---- 3. segmentation --------------------------------------------------
    section(3, "Inspect the material segmentation")
    vlm_json = render_out / "chosen_vlm_results.json"
    if vlm_json.exists():
        chosen = json.loads(vlm_json.read_text())
        print("  VLM results:", json.dumps(chosen, indent=2)[:400])
    pred_path = next(base.rglob("sample_*_pred.npy"), None)
    if pred_path is not None:
        cls = np.load(pred_path)[3:].argmax(0)
        uniq, counts = np.unique(cls, return_counts=True)
        print("  neural class histogram (class: voxels):",
              dict(zip(uniq.tolist(), counts.tolist())))

    # ---- 4. the material field -------------------------------------------
    section(4, "Inspect the material field (5-panel property viz)")
    mapped_ply = next(render_out.rglob("mapped_preds*.ply"))
    mv = read_ply(mapped_ply)["vertex"]
    mpts = np.column_stack([mv["x"], mv["y"], mv["z"]])
    panels = []
    for prop_name in ("part_label", "material_id", "E", "density", "nu"):
        vals = np.asarray(mv[prop_name], np.float32)
        discrete = prop_name in ("part_label", "material_id")
        if discrete:
            img = render_pointcloud_image(mpts, labels=vals.astype(np.int32), res=256)
        else:
            # continuous property: blue -> red colormap over the range
            t = (vals - vals.min()) / max(np.ptp(vals), 1e-9)
            cols = np.stack([t, 0.2 + 0.2 * t, 1.0 - t], axis=-1)
            img = render_pointcloud_image(mpts, colors=cols, res=256)
        panels.append((img * 255).astype(np.uint8))
        lo, hi = vals.min(), vals.max()
        print(f"  {prop_name:12s}: range [{lo:.3g}, {hi:.3g}]"
              + ("" if discrete else f" mean {vals.mean():.3g}"))
    Image.fromarray(np.concatenate(panels, axis=1)).save(wt / "04_material_field.png")
    print("  -> 04_material_field.png (part_label | material_id | E | density | nu)")

    # ---- 5. the simulation ------------------------------------------------
    section(5, "Watch the simulation (point frames + video)")
    ply_frames = sorted(base.rglob("ply_files/frame_*.ply"))
    sim_dir = ply_frames[0].parent.parent if ply_frames else base / "sim_out"
    frames_dir = sim_dir / "frames"
    gs_frames = sorted(sim_dir.rglob("gs_frames/*.png"))
    if not frames_dir.exists() or not any(frames_dir.iterdir()):
        frames_dir.mkdir(parents=True, exist_ok=True)
        for f in ply_frames:
            fv = read_ply(f)["vertex"]
            img = render_pointcloud_image(
                np.column_stack([fv["x"], fv["y"], fv["z"]]),
                labels=np.asarray(fv["material_id"]), res=256)
            Image.fromarray((img * 255).astype(np.uint8)).save(frames_dir / (f.stem + ".png"))
    video = wt / "05_simulation.mp4"
    ok = compile_video(frames_dir, video, fps=10)
    print(f"  {len(ply_frames)} frame PLYs; video "
          f"{'-> 05_simulation.mp4' if ok else 'skipped (no ffmpeg)'}")
    if gs_frames:
        compile_video(gs_frames[0].parent, wt / "05_simulation_gs.mp4", fps=10)
        print("  GS-rasterized frames found -> 05_simulation_gs.mp4")

    # ---- summary ----------------------------------------------------------
    section(6, "Artifact summary")
    for f in sorted(wt.iterdir()):
        print(f"  {f.name:28s} {f.stat().st_size / 1024:.0f} KB")
    print("\nWalkthrough complete — inspect the files under", wt)
    return {"pngs": sorted(wt.glob("*.png")), "psnr": p}


if __name__ == "__main__":
    main()
