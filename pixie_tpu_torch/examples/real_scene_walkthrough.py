"""Real-scene acceptance walkthrough, the nbs/real_scene.ipynb analog
(port of examples/real_scene_walkthrough.py).

The reference's second acceptance notebook drives a real capture (COLMAP
sparse model + photos) end to end: reconstruct with the COLMAP dataparser
(f3rm_config.py:40-52 ``USE_COLMAP_DATAPARSER``), voxelize, segment,
predict materials, and simulate at n_grid=120 (config/real_scene/*.json).
Real captures are not in the repo, so by default this fabricates a
synthetic COLMAP capture (orbit cameras, sparse points, images: the
fixture of tests/test_colmap.py) — pass --data <capture_dir> to run on a
real one (expects images/ + sparse/0/{cameras,images,points3D}.bin).

Section <-> notebook-cell map (reference nbs/real_scene.ipynb):
  1 COLMAP ingest    <- dataparser cells (camera poses, seed point cloud)
  2 field training   <- ns-train f3rm cells (here: short budget run)
  3 3DGS training    <- gaussian-splatting train cells (seeded from
                        points3D, as scene/__init__.py fetchPly does)
  4 dataparser export<- dataparser_transforms.json consumed by
                        voxel/map_pred_to_coords.transform_nerf_to_world
  5 sim config       <- config/real_scene/*.json decode (n_grid=120)

Usage: python -m pixie_tpu_torch.examples.real_scene_walkthrough [--data DIR]
       [--cpu] [--out DIR] [--iters 200]
"""

import argparse
import dataclasses
import json
import struct
import time
from pathlib import Path

import numpy as np

from pixie_tpu_torch.examples import default_out

REPO = Path(__file__).resolve().parents[2]


def section(n, title):
    print(f"\n{'=' * 70}\n## {n}. {title}\n{'=' * 70}", flush=True)


def _rotmat_to_qvec(m: np.ndarray) -> np.ndarray:
    """wxyz quaternion of a rotation, branching on the dominant diagonal."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = 2 * np.sqrt(tr + 1.0)
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    if m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = 2 * np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
        return np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                         (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    if m[1, 1] >= m[2, 2]:
        s = 2 * np.sqrt(1.0 - m[0, 0] + m[1, 1] - m[2, 2])
        return np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                         0.25 * s, (m[1, 2] + m[2, 1]) / s])
    s = 2 * np.sqrt(1.0 - m[0, 0] - m[1, 1] + m[2, 2])
    return np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                     (m[1, 2] + m[2, 1]) / s, 0.25 * s])


def write_synthetic_colmap(root: Path, n_views: int = 8, n_pts: int = 200) -> None:
    """A tiny binary COLMAP capture: orbit cameras looking at the origin, a
    PINHOLE camera, a sparse point cloud, and 16x16 images (the capture of
    tests/test_colmap.py's ``_write_synthetic_model``)."""
    from PIL import Image

    from pixie_tpu_torch.recon.colmap import qvec2rotmat

    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    img_dir = root / "images"
    img_dir.mkdir()
    w = h = 16
    fx = fy = 20.0
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.3, 0.3, (n_pts, 3))
    rgbs = rng.integers(0, 255, (n_pts, 3))
    views = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        cam_pos = np.array([2.0 * np.cos(ang), 2.0 * np.sin(ang), 1.0])
        fwd = -cam_pos / np.linalg.norm(cam_pos)     # OpenCV: +z forward
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        r_w2c = np.stack([right, np.cross(fwd, right), fwd])
        q = _rotmat_to_qvec(r_w2c)
        assert np.abs(qvec2rotmat(q) - r_w2c).max() < 1e-6
        name = f"frame_{i:03d}.png"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(img_dir / name)
        views.append((i + 1, q, -r_w2c @ cam_pos, name))
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))  # PINHOLE
        f.write(struct.pack("<4d", fx, fy, w / 2.0, h / 2.0))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for iid, q, t, name in views:
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<7d", *q, *t))
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 3))        # a few dummy 2D tracks
            for _ in range(3):
                f.write(struct.pack("<ddq", 1.0, 2.0, -1))
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n_pts))
        for i in range(n_pts):
            f.write(struct.pack("<Q", i + 1))
            f.write(struct.pack("<3d", *pts[i]))
            f.write(struct.pack("<3B", *rgbs[i]))
            f.write(struct.pack("<d", 0.5))
            tl = int(rng.integers(0, 4))
            f.write(struct.pack("<Q", tl))
            for _ in range(tl):
                f.write(struct.pack("<ii", 1, 2))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="real_scene_walkthrough")
    ap.add_argument("--data", default=None,
                    help="real COLMAP capture dir; default: synthetic fixture")
    ap.add_argument("--out", default=default_out("pixie_real_scene"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    if args.data is None:
        data = out / "capture"
        if not (data / "sparse").exists():
            data.mkdir(parents=True, exist_ok=True)
            write_synthetic_colmap(data, n_views=8, n_pts=200)
        print(f"synthetic COLMAP capture at {data}")
    else:
        data = Path(args.data)

    section(1, "COLMAP ingest: poses, intrinsics, seed points")
    from pixie_tpu_torch.recon.train_field import load_dataset

    ds = load_dataset(data)
    print(f"views: {ds['images'].shape[0]}  image {ds['hw']}  "
          f"intrinsics {tuple(round(v, 1) for v in ds['intrinsics'])}")
    print(f"dataparser scale: {ds['dataparser_scale']:.4f}  "
          f"seed points3d: {ds.get('points3d', np.zeros((0, 3))).shape[0]}")
    assert np.abs(ds["c2w"][:, :3, 3]).max() <= 1.0 + 1e-5, "auto-scale"

    section(2, "feature-field training (budget run)")
    from pixie_tpu_torch.recon.train_field import METHOD_CONFIGS, train_feature_field

    cfg = dataclasses.replace(METHOD_CONFIGS["nerfacto"], max_iterations=args.iters,
                              eval_views=1)
    t0 = time.time()
    train_feature_field(data, out / "field", cfg=cfg, log_every=args.iters, device=device)
    print(f"field trained {args.iters} iters in {time.time() - t0:.1f}s")
    dp = out / "field" / "dataparser_transforms.json"
    assert dp.exists(), "real-scene contract: dataparser_transforms.json"
    print(f"dataparser_transforms.json: {json.loads(dp.read_text())['scale']:.4f} scale")

    section(3, "3DGS training seeded from the sparse reconstruction")
    from pixie_tpu_torch.recon.train_gaussians import GSTrainConfig, train_gaussian_splatting

    gs_cfg = GSTrainConfig(iterations=max(args.iters // 2, 10), densify_until=0, sh_degree=1)
    t0 = time.time()
    train_gaussian_splatting(data, out / "gs", cfg=gs_cfg, log_every=max(args.iters // 2, 10),
                             device=device)
    print(f"3DGS trained in {time.time() - t0:.1f}s (COLMAP points3d seed)")

    section(4, "train-space <-> world roundtrip (map_pred contract)")
    from pixie_tpu_torch.recon.colmap import apply_dataparser_transform

    meta = json.loads(dp.read_text())
    pts_w = np.random.default_rng(0).uniform(-0.3, 0.3, (64, 3))
    p_train = apply_dataparser_transform(pts_w, meta["transform"], meta["scale"])
    t = np.eye(4)
    t[:3, :] = np.asarray(meta["transform"])
    back = (np.linalg.inv(t) @ np.concatenate(
        [p_train / meta["scale"], np.ones((64, 1))], 1).T).T[:, :3]
    err = np.abs(back - pts_w).max()
    print(f"world->train->world max err: {err:.2e}")
    assert err < 1e-4

    section(5, "real-scene sim config decode (n_grid=120 family)")
    from pixie_tpu_torch.sim.params import decode_param_json

    sim = decode_param_json(REPO / "config" / "real_scene" / "custom_bonsai_config.json")
    mat = sim[0] if isinstance(sim, tuple) else sim
    print(f"bonsai decoded: n_grid={mat['n_grid']} grid_lim={mat['grid_lim']}")
    assert mat["n_grid"] == 120

    print("\nreal-scene walkthrough complete —", out)
    return {"field": out / "field", "gs": out / "gs", "dataparser": dp}


if __name__ == "__main__":
    main()
