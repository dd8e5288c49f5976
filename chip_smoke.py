#!/usr/bin/env python3
"""Smoke run of pixie_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
checks each against its plain PyTorch version, and drives the main path once
at full width.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device   — a CUDA device is required; prints nvidia-smi's name/power limit
  2. build    — nvcc builds pixie_tpu_torch/csrc/{transfer,gs_stream}.cu for
                sm_90a, one nvcc per source, started together
  3. kernels  — P2G / G2P kernels vs their plain versions on the card at the
                slice's shapes (100k particles, n_grid 50); the tile blend
                (B3, tile_cap 512) and its backward (B4, tile_cap 1024, a
                seeded cotangent) vs their plain versions at the render's
                shapes (~100k seeded gaussians at 800x800, the tree config's
                camera), with timings and B4's peak device memory
  4. train    — 3DGS training through train_gaussian_splatting: 12 views of
                the seeded 100k-gaussian model rendered at 800x800 with the
                port's forward and written as PNGs + transforms.json; 100k
                init points (the model's centres plus seeded noise), SH 3,
                tile_cap 1024, the shipped learning rates, 300 iterations
                with densify at 100 and 200 and an opacity reset at 250;
                B3 and B4 launch counts must match the steps and renders run
  5. slice    — a seeded synthetic object (64^3 ball mask of ~100k voxels,
                768-channel float16 features, clip_features.npz) through
                pixie_tpu_torch.pipeline: both U-Nets at the shipped width ->
                mapped_preds.ply, then under
                config/objaverse/custom_tree_config.json
                (a) point-cloud mode: 1 frame x 400 substeps of MPM;
                (b) GS mode: the checkpoint phase 4 trained (its capture's
                    cameras as cameras.json) -> 3 frames x 400 substeps,
                    each frame rendered to PNG + gaussian PLY;
                each path's kernel launch counts must equal its substeps
                (and, in GS mode, its frames)
The line before the last is the kernel JSON; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX or pixie_tpu.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_PARTICLES, N_GRID, GRID_LIM, DT = 100_000, 50, 2.0, 1e-4
N_FRAMES = 3             # GS path; the point-cloud path runs 1
N_GAUSSIANS, RES = 100_000, 800
N_VIEWS, TRAIN_ITERS = 12, 300
# GSTrainConfig fields: densify at 100 and 200, an opacity reset at 250.  The
# JAX trainer (and so the port) takes the screen-space gradient in pixels,
# where the reference's backward.cu takes it in NDC units (x W/2): its 2e-4
# threshold, converted to pixels at 800 px, is 2e-4 / 400
TRAIN_CFG = dict(densify_from=100, densify_interval=100, densify_until=300,
                 opacity_reset_interval=250, densify_grad_threshold=2e-4 / (RES / 2))
KERNELS = ("p2g", "g2p", "gs_blend", "gs_blend_backward")
# stated tolerances of phase 3, relative to the largest |value| of the plain
# result: P2G sums ~170 float atomics per node in run-dependent order; G2P
# sums 27 terms in a fixed order but contracts multiply-adds (FMA) where the
# plain version rounds each op
P2G_RTOL, G2P_RTOL = 1e-5, 1e-5
# absolute, on colour and T in [0, 1]: the kernel's sequential product
# against the plain version's log-domain chunked product, over <= 512 terms
BLEND_ATOL = 1e-4
# per column of d feat, relative to that column's largest |plain value|:
# float atomics across tiles in run-dependent order, and the sequential
# transmittance product against the plain version's log-domain chunks
BWD_RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 30, warmup: int = 3, setup=None) -> float:
    """Median of per-call CUDA-event timings (ms) after warm-up."""
    import torch

    times = []
    for i in range(warmup + reps):
        args = setup() if setup else ()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def _reset_counts() -> None:
    from pixie_tpu_torch.ops import gs_stream, transfer

    transfer.P2G_LAUNCHES = transfer.G2P_LAUNCHES = 0
    gs_stream.BLEND_LAUNCHES = gs_stream.BLEND_BWD_LAUNCHES = 0


def _read_counts() -> dict:
    from pixie_tpu_torch.ops import gs_stream, transfer

    return {"p2g": transfer.P2G_LAUNCHES, "g2p": transfer.G2P_LAUNCHES,
            "gs_blend": gs_stream.BLEND_LAUNCHES,
            "gs_blend_backward": gs_stream.BLEND_BWD_LAUNCHES}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    for src in ("transfer.cu", "gs_stream.cu"):
        if not (HERE / "pixie_tpu_torch" / "csrc" / src).exists():
            fail(f"pixie_tpu_torch sources not found beside {Path(__file__).name}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)
    for mod in ("yaml", "sklearn", "scipy", "PIL", "imageio"):
        try:
            __import__(mod)
            print(f"module {mod}: present")
        except ImportError:
            print(f"module {mod}: absent")


def phase_build():
    from pixie_tpu_torch.ops import build, gs_stream, transfer

    t0 = time.time()
    build.load_libraries("transfer", "gs_stream")  # one nvcc per source, both at once
    transfer.build()
    gs_stream.build()
    print(f"build: transfer.cu, gs_stream.cu in {time.time() - t0:.2f} s", flush=True)
    for name in ("transfer", "gs_stream"):
        print(f"  {name}.cu -> {build.library_path(name).name}")
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")


def _slice_state(dev):
    """Seeded particle state at the slice's shapes, with stress and C."""
    import numpy as np
    import torch

    from pixie_tpu_torch.sim.types import MPMConfig, finalize_mu_lam, make_state

    rng = np.random.default_rng(0)
    x = rng.uniform(0.5, 1.5, (N_PARTICLES, 3)).astype(np.float32)
    st = finalize_mu_lam(make_state(x, np.full(N_PARTICLES, 1.0 / N_PARTICLES, np.float32),
                                    density=600.0, E=9e6, nu=0.33, device=dev))
    s = 1e3 * rng.normal(size=(N_PARTICLES, 3, 3))
    st = st.replace(
        v=torch.as_tensor(rng.normal(size=(N_PARTICLES, 3)).astype(np.float32), device=dev),
        C=torch.as_tensor((0.1 * rng.normal(size=(N_PARTICLES, 3, 3))).astype(np.float32),
                          device=dev),
        stress=torch.as_tensor((0.5 * (s + np.swapaxes(s, 1, 2))).astype(np.float32),
                               device=dev),
        F_trial=torch.as_tensor((np.eye(3) + 0.01 * rng.normal(size=(N_PARTICLES, 3, 3)))
                                .astype(np.float32), device=dev),
        cov=torch.as_tensor(rng.normal(size=(N_PARTICLES, 6)).astype(np.float32), device=dev),
    )
    st = st.replace(F=st.F_trial.clone())
    cfg = MPMConfig(n_grid=N_GRID, grid_lim=GRID_LIM, rpic_damping=0.1,
                    update_cov_with_F=True, gravity=(0.0, 0.0, -9.8))
    return st, cfg


def phase_kernels(dev):
    import torch

    from pixie_tpu_torch.ops import transfer
    from pixie_tpu_torch.sim.solver import grid_momentum_to_velocity

    st, cfg = _slice_state(dev)
    args = (st.x, st.v, st.C, st.stress, st.mass, st.vol, st.selection == 0, cfg, DT)
    grid_k = transfer.p2g(*args)
    grid_p = transfer.p2g_plain(*args)
    torch.cuda.synchronize()
    scale = float(grid_p.abs().max())
    p2g_err = float((grid_k - grid_p).abs().max())
    mass_k, mass_p = float(grid_k[..., 3].double().sum()), float(st.mass.double().sum())
    print(f"p2g: max_abs_err {p2g_err:.3e} (max |grid| {scale:.3e}, tol "
          f"{P2G_RTOL * scale:.3e}); grid mass {mass_k:.6f} vs particle mass {mass_p:.6f}")
    if not p2g_err <= P2G_RTOL * scale or abs(mass_k - mass_p) > 1e-4 * mass_p:
        fail("p2g kernel disagrees with its plain version")

    grid_v = grid_momentum_to_velocity(grid_p, cfg, DT).contiguous()
    fields = ("x", "v", "C", "F_trial", "cov")

    def fresh():
        return st.replace(**{k: getattr(st, k).clone() for k in fields})

    out_k = transfer.g2p(fresh(), grid_v, cfg, DT)
    out_p = transfer.g2p_plain(fresh(), grid_v, cfg, DT)
    torch.cuda.synchronize()
    g2p_err = 0.0
    for k in fields:
        ref = getattr(out_p, k)
        err = float((getattr(out_k, k) - ref).abs().max())
        tol = G2P_RTOL * max(float(ref.abs().max()), 1.0)
        print(f"g2p {k}: max_abs_err {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            fail(f"g2p kernel disagrees with its plain version on {k}")
        g2p_err = max(g2p_err, err)

    timings = {
        "p2g": (cuda_ms(lambda: transfer.p2g(*args)),
                cuda_ms(lambda: transfer.p2g_plain(*args))),
        "g2p": (cuda_ms(lambda s: transfer.g2p(s, grid_v, cfg, DT), setup=lambda: (fresh(),)),
                cuda_ms(lambda s: transfer.g2p_plain(s, grid_v, cfg, DT),
                        setup=lambda: (fresh(),))),
    }
    for name, (k_ms, p_ms) in timings.items():
        print(f"{name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"(median of 30 CUDA-event timings, {N_PARTICLES} particles, n_grid {N_GRID})")
    return {"p2g": (p2g_err, *timings["p2g"]), "g2p": (g2p_err, *timings["g2p"])}


def _gs_model(dev, n: int = N_GAUSSIANS, res: int = RES, n_cams: int = 5):
    """Seeded 3DGS model and cameras.  Gaussians fill a ball of radius 0.44
    (inside the object's voxel ball of radius 29/64, so every gaussian has a
    material vertex within the kNN's 0.1), with log-scales near the mean
    3-NN distance, random rotations, SH degree 3 and opacity logits mostly
    above the 0.02 threshold; n_cams cameras at res x res on a ring around
    it, at elevation 0.3 (even) and -0.2 (odd), as cameras.json entries."""
    import numpy as np
    import torch

    from pixie_tpu_torch.recon.gaussians import create_from_points
    from pixie_tpu_torch.sim.camera import look_at_viewmat

    rng = np.random.default_rng(0)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * 0.44 * rng.uniform(size=(n, 1)) ** (1.0 / 3.0)).astype(np.float32)
    params = create_from_points(pts, colors=rng.uniform(0.1, 0.9, (n, 3)), sh_degree=3,
                                device=dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    q = rng.normal(size=(n, 4))
    params.update(scaling=params["scaling"] + t(rng.normal(0.0, 0.2, (n, 3))),
                  rotation=t(q / np.linalg.norm(q, axis=1, keepdims=True)),
                  f_rest=t(rng.normal(0.0, 0.05, (n, 15, 3))),
                  opacity=t(rng.normal(2.0, 1.5, (n, 1))))
    cams = []
    for i in range(n_cams):
        az, el = 2.0 * np.pi * i / n_cams, (0.3 if i % 2 == 0 else -0.2)
        eye = 2.4 * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])
        c2w = np.linalg.inv(look_at_viewmat(eye, [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]))
        cams.append({"id": i, "img_name": f"view_{i:03d}", "width": res, "height": res,
                     "position": c2w[:3, 3].tolist(), "rotation": c2w[:3, :3].tolist(),
                     "fx": 1.375 * res, "fy": 1.375 * res})
    return params, cams


def phase_blend(dev, n_gaussians: int = N_GAUSSIANS, res: int = RES):
    """The tile blend at the render's shapes: the GS model seen from the
    tree config's camera 4, through the port's projection and binning."""
    import torch

    from pixie_tpu_torch.ops import gs_stream
    from pixie_tpu_torch.recon import rasterizer as R
    from pixie_tpu_torch.sim.camera import viewmat_from_camera_entry

    params, cams = _gs_model(dev, n_gaussians, res)
    cam = cams[4]
    vm = torch.as_tensor(viewmat_from_camera_entry(cam), device=dev)
    bins = R.bin_tiles(params, vm, R.Camera(res, res, cam["fx"], cam["fy"], res / 2, res / 2))
    args = (bins.feat, bins.idx, bins.starts, bins.counts, bins.tx_n, 0.0)
    img_k, t_k = gs_stream.blend(*args)
    img_p, t_p = gs_stream.blend_plain(*args)
    torch.cuda.synchronize()
    err = max(float((img_k - img_p).abs().max()), float((t_k - t_p).abs().max()))
    busy = int((bins.counts > 0).sum())
    print(f"blend: {n_gaussians} gaussians at {res}x{res}, {bins.starts.shape[0]} tiles "
          f"({busy} with splats), {bins.idx.shape[0]} tile entries; largest tile count "
          f"{int(bins.raw.max())}, tiles cut by tile_cap 512: {int((bins.raw > 512).sum())}; "
          f"JAX's stream would overflow: {R.jax_stream_overflows(bins)}")
    print(f"blend: max_abs_err {err:.3e} on colour and T (tol {BLEND_ATOL:.0e}); "
          f"min T {float(t_k.min()):.3e}")
    if not err <= BLEND_ATOL:
        fail("gs blend kernel disagrees with its plain version")
    if not float(t_k.min()) < 0.5:
        fail("the blend scene is nearly transparent: nothing was tested")
    k_ms, p_ms = cuda_ms(lambda: gs_stream.blend(*args)), cuda_ms(
        lambda: gs_stream.blend_plain(*args))
    print(f"gs_blend: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median of 30 CUDA-event "
          f"timings, {res}x{res}, tile_cap 512)", flush=True)
    return err, k_ms, p_ms


def phase_blend_backward(dev, n_gaussians: int = N_GAUSSIANS, res: int = RES,
                         tile_cap: int = 1024):
    """The blend backward (B4) at a training step's shapes: the GS model from
    the tree config's camera 4, tile_cap 1024, a seeded cotangent."""
    import torch

    from pixie_tpu_torch.ops import gs_stream
    from pixie_tpu_torch.recon import rasterizer as R
    from pixie_tpu_torch.sim.camera import viewmat_from_camera_entry

    params, cams = _gs_model(dev, n_gaussians, res)
    cam = cams[4]
    vm = torch.as_tensor(viewmat_from_camera_entry(cam), device=dev)
    bins = R.bin_tiles(params, vm, R.Camera(res, res, cam["fx"], cam["fy"], res / 2, res / 2),
                       tile_cap=tile_cap)
    g = torch.Generator(device=dev).manual_seed(0)
    d_img = torch.randn((res, res, 3), device=dev, generator=g)
    d_trans = torch.randn((res, res), device=dev, generator=g)
    args = (bins.feat, bins.idx, bins.starts, bins.counts, bins.tx_n, 0.3, d_img, d_trans)
    peaks = []
    for fn in (gs_stream.blend_backward, gs_stream.blend_backward_plain):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(*args)
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2**20)
        if fn is gs_stream.blend_backward:
            d_k = out
        else:
            d_p = out
    err = (d_k - d_p).abs().max(0).values
    scale = d_p.abs().max(0).values
    rel = (err / scale).tolist()
    print(f"blend backward: {n_gaussians} gaussians at {res}x{res}, tile_cap {tile_cap}: "
          f"{bins.idx.shape[0]} tile entries, largest tile {int(bins.raw.max())}, "
          f"{int((bins.raw > tile_cap).sum())} tiles cut")
    print("blend backward: per-column max_abs_err / max |plain| (mx my c0 c1 c2 r g b op): "
          + " ".join(f"{r:.2e}" for r in rel) + f" (tol {BWD_RTOL:.0e})")
    print("blend backward: max |plain| per column: " + " ".join(f"{v:.3e}" for v in scale.tolist()))
    if not all(r <= BWD_RTOL for r in rel) or not bool(torch.isfinite(d_k).all()):
        fail("gs blend backward kernel disagrees with its plain version")
    k_ms = cuda_ms(lambda: gs_stream.blend_backward(*args))
    p_ms = cuda_ms(lambda: gs_stream.blend_backward_plain(*args), reps=5, warmup=1)
    print(f"gs_blend_backward: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median of 30 / 5 "
          f"CUDA-event timings); peak device memory above the inputs: kernel "
          f"{peaks[0]:.1f} MiB, plain {peaks[1]:.1f} MiB", flush=True)
    return float(err.max()), k_ms, p_ms


def phase_train(dev, root: Path, n_gaussians: int = N_GAUSSIANS, res: int = RES,
                n_views: int = N_VIEWS, iters: int = TRAIN_ITERS,
                cfg_kw: dict | None = None) -> dict:
    """3DGS training of a rendered capture through the port's entry point;
    writes the checkpoint and the capture's cameras.json to root / "gs" and
    returns the path's launch counts."""
    import numpy as np
    import torch
    from PIL import Image

    from pixie_tpu_torch.recon import rasterizer as R
    from pixie_tpu_torch.recon.train_gaussians import GSTrainConfig, train_gaussian_splatting
    from pixie_tpu_torch.sim.camera import viewmat_from_camera_entry

    t0 = time.time()
    target, cams = _gs_model(dev, n_gaussians, res, n_cams=n_views)
    capture, gs = root / "capture", root / "gs"
    capture.mkdir(parents=True)
    gs.mkdir(parents=True)
    frames = []
    with torch.no_grad():
        for i, cam in enumerate(cams):
            vm = viewmat_from_camera_entry(cam)
            img, _ = R.rasterize_tiled(target, torch.as_tensor(vm, device=dev),
                                       R.Camera(res, res, cam["fx"], cam["fy"], res / 2, res / 2),
                                       bg_color=0.0, tile_cap=1024)
            png = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
            Image.fromarray(png).save(capture / f"{cam['img_name']}.png")
            c2w = np.linalg.inv(vm.astype(np.float64))
            c2w[:3, 1:3] *= -1.0                      # Blender axes: y up, looking down -z
            frames.append({"file_path": f"{cam['img_name']}.png",
                           "transform_matrix": c2w.tolist()})
    (capture / "transforms.json").write_text(json.dumps(
        {"fl_x": cams[0]["fx"], "fl_y": cams[0]["fy"], "cx": res / 2, "cy": res / 2,
         "frames": frames}))
    (gs / "cameras.json").write_text(json.dumps(cams))
    rng = np.random.default_rng(1)
    init = (target["xyz"].cpu().numpy() + rng.normal(0.0, 0.01, (n_gaussians, 3))).astype(
        np.float32)
    del target
    torch.cuda.empty_cache()
    print(f"setup: capture of {n_views} views at {res}x{res}, {n_gaussians} init points in "
          f"{time.time() - t0:.1f} s", flush=True)

    cfg = GSTrainConfig(iterations=iters, **(TRAIN_CFG if cfg_kw is None else cfg_kw))
    steps = []

    def on_step(it, loss, l1, n):
        torch.cuda.synchronize()
        steps.append((it, time.perf_counter(), float(loss), n))

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    final = train_gaussian_splatting(capture, gs, cfg=cfg, init_points=init, log_every=100,
                                     device=dev, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _read_counts()
    metrics = json.loads((gs / "metrics.json").read_text())
    ms = [1e3 * (b[1] - a[1]) for a, b in zip(steps, steps[1:]) if a[0] >= 10]
    events = [it for it in range(1, iters + 1)     # the trainer's densify rule
              if cfg.densify_from <= it < cfg.densify_until and it % cfg.densify_interval == 0]
    counts = {it: n for it, _, _, n in steps}
    after = {e: counts.get(e + 1, metrics["n_gaussians"]) for e in events}
    print(f"train: {iters} iterations in {wall:.1f} s (incl. the PSNR pass over {n_views} views); "
          f"median {statistics.median(ms):.2f} ms/iter over iterations 10..{iters} "
          f"(synchronized), p10 {np.percentile(ms, 10):.2f}, p90 {np.percentile(ms, 90):.2f}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"train: densify threshold {cfg.densify_grad_threshold:.3e}; loss {steps[0][2]:.5f} at iteration 1, "
          f"{steps[-1][2]:.5f} at {iters}; "
          f"gaussians {n_gaussians} -> " + ", ".join(
              f"{after[e]} after the densify at {e}" for e in events)
          + f"; final {metrics['n_gaussians']}; psnr_mean {metrics['psnr_mean']:.3f} dB; "
          f"launches {launches} for {iters} steps + {n_views} PSNR renders", flush=True)
    if not steps[-1][2] < steps[0][2]:
        fail("training loss did not fall")
    if launches != {"p2g": 0, "g2p": 0, "gs_blend": iters + n_views,
                    "gs_blend_backward": iters}:
        fail(f"training launches {launches} != {iters} steps + {n_views} renders")
    if not all(bool(torch.isfinite(v).all()) for v in final.values()) or not np.isfinite(
            metrics["psnr_mean"]):
        fail("non-finite parameters or PSNR after training")
    if not (gs / "point_cloud" / f"iteration_{iters}" / "point_cloud.ply").exists():
        fail("no checkpoint PLY")
    return launches


def _make_object(root: Path, d: int, fc: int, model_kwargs: dict):
    """Seeded synthetic object and U-Net checkpoints (ball of radius 29/64 d)."""
    import numpy as np
    import torch

    from pixie_tpu_torch.models.unet3d import RegressionUNet, SegmentationUNet, seeded_state_dict

    render = root / "render_outputs" / "smokeobj"
    render.mkdir(parents=True)
    c = np.arange(d) - (d - 1) / 2.0
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    mask = (r < 29.0 * d / 64).astype(np.float32)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((d, d, d, fc), dtype=np.float32).astype(np.float16)
    feats *= mask[..., None].astype(np.float16)
    np.save(render / "clip_features_features.npy", feats)
    np.save(render / "clip_features_mask.npy", mask)
    np.savez(render / "clip_features.npz", min_bounds=np.full(3, -0.5, np.float32),
             max_bounds=np.full(3, 0.5, np.float32), grid_shape=np.array([d, d, d]))
    kw = dict(feature_channels=fc, grid_size=d, **model_kwargs)
    for i, (name, model, scale) in enumerate((
            ("discrete", SegmentationUNet(num_classes=8, **kw), 1.0),
            # regression head x1e-3 keeps the denormalized E (~9e6 Pa) in the
            # range an explicit step at substep_dt 1e-4 holds
            ("continuous", RegressionUNet(out_channels=3, **kw), 1e-3))):
        ckpt = root / f"checkpoints_{name}"
        ckpt.mkdir()
        torch.save({"model_state_dict": seeded_state_dict(model, seed=5 + i, head_scale=scale)},
                   ckpt / "epoch_0.pth")
    print(f"object: {d}^3 grid, {int(mask.sum())} occupied voxels, {fc} float16 channels")
    return render, feats, mask


def phase_slice(dev, gs_dir: Path, d: int = 64, fc: int = 768, model_kwargs: dict | None = None,
                n_frames: int = N_FRAMES, res: int = RES) -> dict:
    """The main path at the shipped width (defaults: 64^3 x 768, U-Nets with
    model_channels 64, mult (1,1,2,4), 3 res blocks, projector 768->128->32),
    then the 3DGS checkpoint in ``gs_dir`` rendered at res x res.  Returns
    each path's launches."""
    import numpy as np
    import torch
    from PIL import Image

    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.recon.gaussians import load_gaussian_ply
    from pixie_tpu_torch.train.inference import CombinedInference, load_params
    from pixie_tpu_torch.utils.io import read_ply

    tree_cfg = HERE / "config" / "objaverse" / "custom_tree_config.json"
    with tempfile.TemporaryDirectory(prefix="pixie_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.time()
        model_kwargs = model_kwargs or {}
        render, feats, mask = _make_object(root, d, fc, model_kwargs)
        print(f"setup: synthetic object in {time.time() - t0:.1f} s", flush=True)

        t0 = time.time()
        ply = pipeline.generate_neural_segmentation(
            render, root / "neural", "smokeobj", root / "checkpoints_discrete",
            root / "checkpoints_continuous", grid_size=d, feature_channels=fc,
            model_kwargs=model_kwargs, device=dev)
        torch.cuda.synchronize()
        seg_s = time.time() - t0
        pred = np.load(root / "neural" / "smokeobj" / "sample_0_pred.npy")
        verts = read_ply(ply)["vertex"]
        if pred.shape != (11, d, d, d) or not np.isfinite(pred).all():
            fail(f"bad prediction grid {pred.shape}")
        if len(verts) != int(mask.sum()):
            fail(f"mapped_preds.ply has {len(verts)} vertices, mask {int(mask.sum())}")
        classes = np.unique(verts["material_id"], return_counts=True)
        print(f"neural stage: {seg_s:.2f} s; class mix {dict(zip(*(a.tolist() for a in classes)))}; "
              f"E {verts['E'].min():.3e}..{verts['E'].max():.3e}", flush=True)

        # U-Net throughput: both nets on one grid, device-resident input
        infer = CombinedInference(load_params(root / "checkpoints_discrete" / "epoch_0.pth"),
                                  load_params(root / "checkpoints_continuous" / "epoch_0.pth"),
                                  grid_size=d, feature_channels=fc, model_kwargs=model_kwargs,
                                  device=dev)
        feat_dev = torch.as_tensor(feats, device=dev)
        walls = []
        for i in range(4):
            torch.cuda.synchronize()
            t1 = time.time()
            infer.predict_device(feat_dev)
            torch.cuda.synchronize()
            if i:
                walls.append(time.time() - t1)
        unet_s = statistics.median(walls)
        print(f"unet: {1.0 / unet_s:.3f} grids/s (median of 3 timed passes of both nets, "
              f"{unet_s * 1e3:.1f} ms/grid, float32, TF32 off)", flush=True)
        del infer, feat_dev
        torch.cuda.empty_cache()

        # (a) point-cloud mode, one frame
        _reset_counts()
        sim_out = root / "sim"
        info = pipeline.run_physics_simulation(ply, tree_cfg, sim_out, n_frames=1, debug=True,
                                               device=dev)
        pc_launches = _read_counts()
        substeps = info["substeps_per_frame"]
        print(f"mpm (point cloud): {info['n_particles']} particles, 1 frame x {substeps} "
              f"substeps, materials {info['active_materials']}, "
              f"{info['substeps_per_sec']:.2f} substeps/s, median frame "
              f"{info['median_frame_s']:.3f} s; launches {pc_launches}", flush=True)
        if pc_launches != {"p2g": substeps, "g2p": substeps, "gs_blend": 0,
                           "gs_blend_backward": 0}:
            fail(f"point-cloud launches {pc_launches} != substeps run {substeps}")
        frames = sorted((sim_out / "ply_files").glob("frame_*.ply"))
        if len(frames) != 1:
            fail(f"{len(frames)} frame PLYs, expected 1")
        v = read_ply(frames[0])["vertex"]
        if len(v) != info["n_particles"] or not all(np.isfinite(v[k]).all() for k in "xyz"):
            fail(f"{frames[0].name}: non-finite or missing positions")
        if not info["final_state_finite"]:
            fail("non-finite positions after the last substep")
        for name in ("sim_info.json", "boundary_conditions.json"):
            if not (sim_out / name).exists():
                fail(f"missing artifact {name}")

        # (b) GS mode: the trained 3DGS checkpoint, rendered every frame
        _reset_counts()
        gs_out = root / "sim_gs"
        info = pipeline.run_physics_simulation(ply, tree_cfg, gs_out, n_frames=n_frames,
                                               debug=True, gaussian_checkpoint=gs_dir,
                                               render_img=True, device=dev)
        launches = _read_counts()
        substeps = n_frames * info["substeps_per_frame"]
        print(f"mpm (GS): {info['n_particles']} gaussians, {n_frames} frames x "
              f"{info['substeps_per_frame']} substeps, materials {info['active_materials']}, "
              f"{info['substeps_per_sec']:.2f} substeps/s, median frame "
              f"{info['median_frame_s']:.3f} s, median render {info['median_render_ms']:.1f} ms "
              f"(render + PNG + PLY); launches {launches}", flush=True)
        if launches != {"p2g": substeps, "g2p": substeps, "gs_blend": n_frames,
                        "gs_blend_backward": 0}:
            fail(f"GS launches {launches} != {substeps} substeps, {n_frames} frames")
        pngs = sorted((gs_out / "frames").glob("*.png"))
        if [p.name for p in pngs] != [f"{i:05d}.png" for i in range(n_frames)]:
            fail(f"frames {[p.name for p in pngs]}")
        for p in pngs:
            img = np.asarray(Image.open(p))
            lit = float((img.max(-1) > 16).mean())
            print(f"  {p.name}: {img.shape}, mean {img.mean():.2f}, lit share {lit:.3f}")
            if img.shape != (res, res, 3) or lit < 0.02 or img.std() < 5.0:
                fail(f"{p.name}: blank or wrong-sized frame")
        plys = sorted((gs_out / "ply_files").glob("frame_*.ply"))
        if [p.name for p in plys] != [f"frame_{i:05d}.ply" for i in range(n_frames)]:
            fail(f"gaussian PLYs {[p.name for p in plys]}")
        for p in plys:
            g = load_gaussian_ply(p)
            if len(g["xyz"]) != info["n_particles"] or not all(
                    bool(torch.isfinite(a).all()) for a in g.values()):
                fail(f"{p.name}: non-finite or missing gaussians")
        if not info["final_state_finite"]:
            fail("non-finite positions after the last GS substep")
        return {"point_cloud": pc_launches, "gs": launches}


def main() -> int:
    phase_device()
    import torch

    sys.path.insert(0, str(HERE))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kern = phase_kernels(dev)
    kern["gs_blend"] = phase_blend(dev)
    kern["gs_blend_backward"] = phase_blend_backward(dev)
    with tempfile.TemporaryDirectory(prefix="pixie_smoke_train_") as tmp:
        paths = {"train": phase_train(dev, Path(tmp))}
        paths.update(phase_slice(dev, gs_dir=Path(tmp) / "gs"))
    print(f"launches by path: {paths}")
    launches = {k: sum(p[k] for p in paths.values()) for k in KERNELS}
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "pixie_tpu"))
    if leaked:
        fail(f"JAX or the JAX package was imported: {leaked[:5]}")
    rows = []
    for name, src, replaces in (
            ("p2g", "transfer.cu", "pixie_tpu/ops/transfer.py:361"),
            ("g2p", "transfer.cu", "pixie_tpu/ops/transfer.py:439"),
            ("gs_blend", "gs_stream.cu", "pixie_tpu/ops/gs_stream.py:210"),
            ("gs_blend_backward", "gs_stream.cu", "pixie_tpu/ops/gs_stream.py:252")):
        err, k_ms, p_ms = kern[name]
        rows.append({"name": name, "route": "cuda", "source": f"pixie_tpu_torch/csrc/{src}",
                     "replaces": replaces, "launches": launches[name], "max_abs_err": err,
                     "ms": k_ms, "plain_ms": p_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
