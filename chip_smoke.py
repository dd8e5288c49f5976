#!/usr/bin/env python3
"""Smoke run of pixie_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
checks each against its plain PyTorch version, and drives the main path once
at full width.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device   — a CUDA device is required; prints nvidia-smi's name/power limit
  2. build    — nvcc builds pixie_tpu_torch/csrc/transfer.cu for sm_90a
  3. kernels  — P2G / G2P kernels vs their plain versions on the card at the
                slice's shapes (100k particles, n_grid 50), with timings
  4. slice    — a seeded synthetic object (64^3 ball mask of ~100k voxels,
                768-channel float16 features, clip_features.npz) through
                pixie_tpu_torch.pipeline: both U-Nets at the shipped width ->
                mapped_preds.ply -> 3 frames x 400 substeps of MPM under
                config/objaverse/custom_tree_config.json; kernel launch
                counts must equal the substeps run
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
N_FRAMES = 3
# stated tolerances of phase 3, relative to the largest |value| of the plain
# result: P2G sums ~170 float atomics per node in run-dependent order; G2P
# sums 27 terms in a fixed order but contracts multiply-adds (FMA) where the
# plain version rounds each op
P2G_RTOL, G2P_RTOL = 1e-5, 1e-5


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


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not (HERE / "pixie_tpu_torch" / "csrc" / "transfer.cu").exists():
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
    for mod in ("yaml", "sklearn", "scipy"):
        try:
            __import__(mod)
            print(f"module {mod}: present")
        except ImportError:
            print(f"module {mod}: absent")


def phase_build():
    from pixie_tpu_torch.ops import build, transfer

    t0 = time.time()
    transfer.build()
    print(f"build: transfer.cu -> {build.library_path('transfer').name} in "
          f"{time.time() - t0:.2f} s", flush=True)
    for line in build.BUILD_LOG.get("transfer", "").splitlines():
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


def phase_slice(dev, d: int = 64, fc: int = 768, model_kwargs: dict | None = None,
                n_frames: int = N_FRAMES):
    """The main path at the shipped width (defaults: 64^3 x 768, U-Nets with
    model_channels 64, mult (1,1,2,4), 3 res blocks, projector 768->128->32)."""
    import numpy as np
    import torch

    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.ops import transfer
    from pixie_tpu_torch.train.inference import CombinedInference, load_params
    from pixie_tpu_torch.utils.io import read_ply

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

        transfer.P2G_LAUNCHES = 0
        transfer.G2P_LAUNCHES = 0
        sim_out = root / "sim"
        info = pipeline.run_physics_simulation(
            ply, HERE / "config" / "objaverse" / "custom_tree_config.json", sim_out,
            n_frames=n_frames, debug=True, device=dev)
        launches = {"p2g": transfer.P2G_LAUNCHES, "g2p": transfer.G2P_LAUNCHES}
        substeps = n_frames * info["substeps_per_frame"]
        print(f"mpm: {info['n_particles']} particles, {n_frames} frames x "
              f"{info['substeps_per_frame']} substeps, materials {info['active_materials']}, "
              f"{info['substeps_per_sec']:.2f} substeps/s, median frame "
              f"{info['median_frame_s']:.3f} s; launches {launches}", flush=True)
        if launches != {"p2g": substeps, "g2p": substeps}:
            fail(f"kernel launches {launches} != substeps run {substeps}")
        frames = sorted((sim_out / "ply_files").glob("frame_*.ply"))
        if len(frames) != n_frames:
            fail(f"{len(frames)} frame PLYs, expected {n_frames}")
        for f in frames:
            v = read_ply(f)["vertex"]
            if len(v) != info["n_particles"] or not all(np.isfinite(v[k]).all() for k in "xyz"):
                fail(f"{f.name}: non-finite or missing positions")
        if not info["final_state_finite"]:
            fail("non-finite positions after the last substep")
        for name in ("sim_info.json", "boundary_conditions.json"):
            if not (sim_out / name).exists():
                fail(f"missing artifact {name}")
        return launches


def main() -> int:
    phase_device()
    import torch

    sys.path.insert(0, str(HERE))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kern = phase_kernels(dev)
    launches = phase_slice(dev)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "pixie_tpu"))
    if leaked:
        fail(f"JAX or the JAX package was imported: {leaked[:5]}")
    rows = []
    for name, line in (("p2g", 361), ("g2p", 439)):
        err, k_ms, p_ms = kern[name]
        rows.append({"name": name, "route": "cuda", "source": "pixie_tpu_torch/csrc/transfer.cu",
                     "replaces": f"pixie_tpu/ops/transfer.py:{line}",
                     "launches": launches[name], "max_abs_err": err, "ms": k_ms,
                     "plain_ms": p_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
