#!/usr/bin/env python3
"""Smoke run of pixie_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
checks each against its plain PyTorch version, and drives the main path once
at full width.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device   — a CUDA device is required; prints nvidia-smi's name/power limit
  2. build    — nvcc builds pixie_tpu_torch/csrc/{transfer,gs_stream,
                fused_substep,probe_ablation,gather}.cu for sm_90a, one nvcc
                per source, started together
  3. kernels  — P2G (B1: bin keys, torch.sort, binned splat) vs its plain
                version in three cases (the slice's state: 100k particles,
                n_grid 50; the same sorted by cell; P1's 100k particles at
                ~45 a cell), each with its device time and the share of
                the sort; G2P (B2) vs its plain
                version on the slice's state in three orders (as given,
                sorted by cell as the unfused frame keeps it, and a cell
                order left stale by 100 unfused substeps), each with its
                mean run length, the time around the call, its device and
                host time and its schedules; the fused substep
                (B6) vs its plain version on a mixed-material state at the
                same shapes (ids 0, 1, 2, 3, 5, 6, yielding, damaged,
                inactive and off-face particles) in three particle orders
                (as given, sorted by cell, sorted then drifted by 100 fused
                substeps), each with its mean run length and timed without
                its splat; the mean run length of a kept cell order at
                substeps 1, 100 and 399 of a fused frame; a torch.profiler
                count of launches, wall and device time a substep, unfused
                (the frame's state in a cell order and in the caller's, in
                turns) and fused; the tile blend (B3, tile_cap 512)
                and its backward (B4, tile_cap 1024, a seeded cotangent)
                vs their plain versions at the render's shapes (~100k
                seeded gaussians at 800x800, the tree config's camera),
                with timings and B4's peak device memory, and B4's
                ablation: without its per-entry reduction, and with a first
                walk in place of the forward's state; B3 at both tile_caps,
                with and without that state, bitwise against its ablation
                without per-warp lists, timed with its ablations (no lists;
                the gate alone), with the share of (warp, entry) pairs its
                lists keep and its power bit-equal to the plain order of
                operations
  4. probes   — the probe entry points pixie_tpu_torch.scripts.
                probe_kernel_ablation (P1: four P2G variants x two particle
                orders, 100k particles, n_grid 50) and probe_vmem_gather (P2:
                take_along_axis on both axes, 8192 x 128), their launch
                counts, then each P1 variant (each behind B1's keys and
                sort) against its plain version in both orders and each
                gather axis exactly against its plain version, with plain
                and torch.gather timings; P1 full's time beside B1's device
                time on the same particles from phase 3, and B1's time
                attributed to atomics, weight math, load/launch and the
                keys+sort
  5. train    — 3DGS training through train_gaussian_splatting: 12 views of
                the seeded 100k-gaussian model rendered at 800x800 with the
                port's forward and written as PNGs + transforms.json; 100k
                init points (the model's centres plus seeded noise), SH 3,
                tile_cap 1024, the shipped learning rates, 300 iterations
                with densify at 100 and 200 and an opacity reset at 250;
                B3 and B4 launch counts must match the steps and renders run
  6. slice    — a seeded synthetic object (64^3 ball mask of ~100k voxels,
                768-channel float16 features, clip_features.npz) through
                pixie_tpu_torch.pipeline: both U-Nets at the shipped width ->
                mapped_preds.ply, then under
                config/objaverse/custom_tree_config.json
                (a) point-cloud mode: 1 frame x 400 substeps of MPM;
                (b) GS mode: the checkpoint phase 5 trained (its capture's
                    cameras as cameras.json) -> 3 frames x 400 substeps,
                    each frame rendered to PNG + gaussian PLY;
                (c) the fused path (fused=True, PIXIE_FUSED=1's solver):
                    GS mode 3 frames and point-cloud mode 2 frames; frame 0
                    holds the impulse and runs unfused, every later frame
                    1 P2G + 399 fused substeps + 1 G2P; the GS run's frame
                    0 keeps the caller's order, and x after it agrees with
                    (b)'s frame 0 in a cell order; fused and unfused GS
                    frames agree in x after frame 1;
                (d) particle filling: the outer half of the capture's
                    seeded model under a copy of
                    config/objaverse/custom_sand_config.json cut to 1 frame x
                    20 substeps (n_grid 200, fill grid 100), rendered once;
                    the filled count must be positive;
                each path's kernel launch counts must equal its substeps
                (and, in GS mode, its frames)
  7. voxelize — a seeded MXU NerfField (its density fitted on the card in
                plain PyTorch, 120 Adam steps, to a ball of radius 29/64) and a
                768-wide FeatureField saved with save_field_checkpoint, then
                pipeline.generate_voxels at 64^3 with the config's batch
                size -> generate_neural_segmentation on the grid it left on
                the device -> 1 point-cloud frame x 400 substeps of the tree
                config; the voxelizer's timings, the occupied voxels and the
                U-Net stage's seconds; the device grid equals the npy
                bitwise, the mask equals create_occupancy_mask on the CPU
                bit for bit, and the features at 1,000 seeded voxels agree
                with the CPU field within a float16 ulp; then a seeded f3rm
                step-0.ckpt (F3RM feature field + nerfacto mlp_base at
                max_res 2048) through load_f3rm_checkpoint and
                TcnnFieldAdapter over the 64^3 grid in batches of 4096,
                1,000 points against the CPU within 1e-5 of the largest value
  8. field    — field training on phase 5's capture (12 views at 800x800,
                2 held out): seeded ViT-L/14-336 weights under HF's keys in a
                temporary hub-cache snapshot; extract_clip_features in
                bfloat16 (the default) against float32 on the card; then
                pipeline.train_nerf (the CLIP features extracted into
                clip_patch_features.npy, the shipped fields: MXU NerfField
                16 x 2, FeatureField 12 x 8 widened to the features' 1024,
                ProposalField 5 x 2; 4096 rays, 64 + 64 samples, the config
                tree's) for FIELD_ITERS of its 5,000 iterations; ms/step,
                launches, device time and idle share a step and the ten
                kernels with the most device time (torch.profiler over
                steps 20-24), peak memory, the loss (it must fall,
                finite), held-out PSNR; then generate_voxels on the new
                field.pth at 64^3 (grid shape, occupied voxels, seconds)
The line before the last is the kernel JSON (with each kernel's bound: the
larger of its bytes over 3.35 TB/s and its float32 operations over
67 TFLOP/s, the H100 SXM's published peaks, counted from this run's inputs,
and torch.gather's time as the gather rows' library_ms); the launches of a
probe row are those of the probe entry points' run, which launch no kernel
of the pipeline paths, as those launch no probe kernel.  The last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX or pixie_tpu.
"""

from __future__ import annotations

import collections
import contextlib
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
PROBE_P2G = ("probe_p2g_full", "probe_p2g_noweights", "probe_p2g_noatomics",
             "probe_p2g_minimal")
GATHERS = ("gather_axis0", "gather_axis1")
KERNELS = ("p2g", "g2p", "gs_blend", "gs_blend_backward", "fused_substep") + PROBE_P2G + GATHERS
# stated tolerances of phase 3, relative to the largest |value| of the plain
# result: P2G sums ~170 float atomics per node in run-dependent order; G2P
# sums 27 terms in a fixed order but contracts multiply-adds (FMA) where the
# plain version rounds each op
P2G_RTOL, G2P_RTOL = 1e-5, 1e-5
# the P1 variants against their plain versions, relative to the largest
# |value|: full and noweights splat by atomics (P2G_RTOL); noatomics sums a
# run's lanes and then its nodes, the plain version each particle's nodes and
# then the run's particles, and the kernel contracts multiply-adds; minimal
# adds 26 floats in the plain version's order
PROBE_RTOL = {"full": P2G_RTOL, "noweights": P2G_RTOL, "noatomics": 1e-5, "minimal": 1e-6}
# absolute, on colour and T in [0, 1]: the kernel's sequential product
# against the plain version's log-domain chunked product, over <= 512 terms
BLEND_ATOL = 1e-4
# per column of d feat, relative to that column's largest |plain value|:
# float atomics across tiles in run-dependent order, and the sequential
# transmittance product against the plain version's log-domain chunks
BWD_RTOL = 1e-5
# B6 against its plain version: x, v, C, F_trial, cov and the grid to 1e-5 of
# each field's largest |value| (as P2G / G2P).  F, stress, mu, lam and the
# yield stress to JAX's fused-vs-two-kernel criterion
# (tests/test_fast_solver.py:282-294): 90 % within the float32 ULP floor
# 6 * 1.2e-7 * scale (scale E for stress, the field's largest |value|
# otherwise), all within 100 times it: stress = 2 mu (F - R) F^T with F near
# I amplifies last-ulp differences of F, and the kernel contracts
# multiply-adds where the plain version rounds each op.
FUSED_RTOL, ULP_FLOOR, ULP_SHARE, ULP_MAX = 1e-5, 6 * 1.2e-7, 0.9, 100.0
# fused vs unfused GS rollout, max |dx| after frame 1 in cells: the two run
# the same substeps and differ by float32 rounding alone (atomic order, FMA
# contraction, 3x3 products summed in another order), which stays orders of
# magnitude below a cell; a tenth of a cell would mean particles took other
# branches or other forces, i.e. a fault.  The mean is held to 1e-3 cell.
FUSED_DX_MAX, FUSED_DX_MEAN = 0.1, 1e-3
# an unfused GS frame with its state in a cell order vs the same frame in the
# caller's order, |dx| in cells: the two differ by the order of P2G's float
# atomics alone, as two runs of one order do (max 1.85e-4, mean 7.5e-6 cell
# after the tree config's frame 0; PERF.md): the mean is held to 1e-4 cell,
# the max, which a few particles set, to 1e-2
ORDER_DX_MAX, ORDER_DX_MEAN = 1e-2, 1e-4
# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s, float32
# operations/s outside the tensor cores
HBM_BPS, F32_OPS = 3.35e12, 67e12
# float32 operations a particle, counted from the kernels' source (an FMA is
# 2): the B-spline stencil of one position 48; G2P 27 nodes x 56 + advect and
# F_trial 78; cov transport 63; P2G 27 nodes x 64 (4 atomics included) + RPIC
# damping and -vol dt stress 54; svd3 1292 (15 Jacobi rotations x 73 + F^T F,
# sorting, Gram-Schmidt, F V, det); a return map 120; the stresses with det
# and symmetrization
G2P_OPS, COV_OPS, P2G_OPS, SVD3_OPS, RETURN_MAP_OPS = 1638, 63, 1830, 1292, 120
STRESS_OPS = {0: 155, 1: 134, 2: 134, 3: 134, 5: 155, 6: 38}   # others: 18
# P1 variants a particle: noweights the base cell 9, damping and stress 54,
# one node's contribution 43 (every node's is the same) and its 108 values
# added into the grid; noatomics as P2G (a run's sums kept in registers in
# place of its atomics); minimal 25 adds
PROBE_OPS = {"full": P2G_OPS, "noweights": 214, "noatomics": P2G_OPS, "minimal": 25}
# phase 7: the field's density fit (steps of Adam over 65,536 of the 64^3
# grid's points; host-bound at ~0.1 s a step on the card, and 60 steps
# already put 101,093 voxels of the ball's 101,769 over the threshold on
# the CPU) and the voxels its mask must hold at 64^3 (a ball of radius
# 29/64 holds ~102k); the f3rm query's tolerance, relative to the largest
# |feature|: float32 sums of the card's and the CPU's matmuls in another
# order
VOX_FIT_STEPS, VOX_MASK_RANGE, F3RM_RTOL = 120, (50_000, 150_000), 1e-5
# phase 8: training iterations of the config's 5,000 (the learning rate
# decays over the run's own length, as FieldTrainConfig.max_iterations sets
# it); the profiled window of steps; the CLIP tower's bfloat16 features
# against its float32 ones, relative to the largest |value|: 24 pre-LN
# blocks with the residual stream and every product's output rounded to
# bfloat16 (2^-8 relative), seeded at HF's initial scales
FIELD_ITERS, FIELD_PROFILE, CLIP_BF16_RTOL = 250, (20, 25), 5e-2
# a (pixel, splat) pair of the blend: offsets, conic power, exp, alpha and its
# gate (16), as every pair evaluates them; the blend of a hit is not counted
BLEND_PAIR_OPS = 16


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


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the float32 operations over the peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / F32_OPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _reset_counts() -> None:
    from pixie_tpu_torch.ops import fused_substep, gather, gs_stream, probe_ablation, transfer

    transfer.P2G_LAUNCHES = transfer.G2P_LAUNCHES = 0
    gs_stream.BLEND_LAUNCHES = gs_stream.BLEND_BWD_LAUNCHES = 0
    fused_substep.FUSED_LAUNCHES = 0
    probe_ablation.LAUNCHES.update(dict.fromkeys(probe_ablation.MODES, 0))
    gather.LAUNCHES.update({0: 0, 1: 0})


def _read_counts() -> dict:
    from pixie_tpu_torch.ops import fused_substep, gather, gs_stream, probe_ablation, transfer

    return {"p2g": transfer.P2G_LAUNCHES, "g2p": transfer.G2P_LAUNCHES,
            "gs_blend": gs_stream.BLEND_LAUNCHES,
            "gs_blend_backward": gs_stream.BLEND_BWD_LAUNCHES,
            "fused_substep": fused_substep.FUSED_LAUNCHES,
            **{f"probe_p2g_{m}": probe_ablation.LAUNCHES[m] for m in probe_ablation.MODES},
            **{f"gather_axis{a}": gather.LAUNCHES[a] for a in (0, 1)}}


def _counts(**kw) -> dict:
    """A launch-count dict with every kernel, zero unless given."""
    return {k: kw.get(k, 0) for k in KERNELS}


def _smi() -> str:
    """nvidia-smi's name and power limit of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    for src in ("transfer.cu", "gs_stream.cu", "fused_substep.cu", "probe_ablation.cu",
                "gather.cu", "mpm.cuh"):
        if not (HERE / "pixie_tpu_torch" / "csrc" / src).exists():
            fail(f"pixie_tpu_torch sources not found beside {Path(__file__).name}")
    print(f"nvidia-smi: {_smi()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)
    for mod in ("yaml", "sklearn", "scipy", "PIL", "imageio"):
        try:
            __import__(mod)
            print(f"module {mod}: present")
        except ImportError:
            print(f"module {mod}: absent")


LIBRARIES = ("transfer", "gs_stream", "fused_substep", "probe_ablation", "gather")


def phase_build():
    from pixie_tpu_torch.ops import (build, fused_substep, gather, gs_stream, probe_ablation,
                                     transfer)

    t0 = time.time()
    build.load_libraries(*LIBRARIES)  # one nvcc per source, all at once
    for mod in (transfer, gs_stream, fused_substep, probe_ablation, gather):
        mod.build()
    print(f"build: {', '.join(n + '.cu' for n in LIBRARIES)} in {time.time() - t0:.2f} s",
          flush=True)
    for name in LIBRARIES:
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


def _p2g_case(dev, label: str, args: tuple, cfg, dt, reps: int = 30) -> dict:
    """B1 (key kernel, torch.sort, binned splat) against p2g_plain on one
    input: the error and grid-mass check, the wrapper's time (CUDA events
    around each call, as every phase-3 row), its device time and that of
    torch.sort of its keys (a sleep kernel queued ahead, scripts/timing.py),
    and its host time a call."""
    import torch

    from pixie_tpu_torch.ops import transfer
    from pixie_tpu_torch.scripts.timing import time_calls

    grid_k = transfer.p2g(*args, cfg, dt)
    grid_p = transfer.p2g_plain(*args, cfg, dt)
    torch.cuda.synchronize()
    scale = float(grid_p.abs().max())
    err = float((grid_k - grid_p).abs().max())
    mass_k, mass_p = float(grid_k[..., 3].double().sum()), float(args[4][args[6]].double().sum())
    keys = transfer.p2g_bin_keys(args[0], args[6], cfg.n_grid, cfg.inv_dx)
    nb, hbits = transfer.bin_layout(cfg.n_grid)
    ids, bins = torch.unique(keys >> hbits, return_counts=True)
    bins = bins[ids < nb ** 3].float()
    print(f"p2g ({label}): {args[0].shape[0]} particles, n_grid {cfg.n_grid}, {bins.numel()} "
          f"bins of {transfer.P2G_BIN}^3 cells ({float(bins.mean()):.1f} particles "
          f"a bin, largest {int(bins.max())}); max_abs_err {err:.3e} (max |grid| "
          f"{scale:.3e}, tol {P2G_RTOL * scale:.3e}); grid mass {mass_k:.6f} vs particle mass "
          f"{mass_p:.6f}")
    if not err <= P2G_RTOL * scale or abs(mass_k - mass_p) > 1e-4 * mass_p:
        fail(f"p2g kernel disagrees with its plain version ({label})")

    def device_ms(fn):
        return statistics.median(time_calls(fn, [()] * reps, dev))

    def host_ms(fn, calls=10):
        """Host time a call, enqueued behind a sleep kernel (a few launches
        each: the launch queue does not fill)."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e3 * (t1 - t0) / calls

    row = {"max_abs_err": err, "ms": cuda_ms(lambda: transfer.p2g(*args, cfg, dt), reps=reps),
           "device_ms": device_ms(lambda: transfer.p2g(*args, cfg, dt)),
           "sort_ms": device_ms(lambda: torch.sort(keys)),
           "host_ms": host_ms(lambda: transfer.p2g(*args, cfg, dt))}
    print(f"p2g ({label}): wrapper {row['ms']:.4f} ms (CUDA events around the call), device "
          f"{row['device_ms']:.4f} ms, of which torch.sort of the keys {row['sort_ms']:.4f} ms "
          f"(share {row['sort_ms'] / row['device_ms']:.3f}) (medians of {reps}); host time a "
          f"call {row['host_ms']:.4f} ms", flush=True)
    return row


def phase_kernels(dev, n_p1: int = 100_000):
    import numpy as np
    import torch

    from pixie_tpu_torch.ops import transfer
    from pixie_tpu_torch.scripts import probe_kernel_ablation as p1

    st, cfg = _slice_state(dev)
    args = (st.x, st.v, st.C, st.stress, st.mass, st.vol, st.selection == 0)
    # B1 in three cases: the phase-3 state (random order, ~6.4 particles a
    # cell), the same state sorted by base cell, and P1's particles (100k in
    # [0.75, 1.25]^3 at n_grid 50, ~45 a cell)
    order = torch.as_tensor(np.argsort(p1.base_cells(st.x.cpu().numpy(), cfg), kind="stable"),
                            device=dev)
    p1_cfg = p1.config()
    cases = {"phase-3 state": _p2g_case(dev, "phase-3 state", args, cfg, DT),
             "cell-sorted": _p2g_case(dev, "cell-sorted", tuple(a[order].contiguous()
                                                                for a in args), cfg, DT),
             "P1 state": _p2g_case(dev, "P1 state", p1.inputs(p1.make_particles(n_p1), "generated",
                                                              p1_cfg, dev), p1_cfg, p1.DT)}
    p2g_err = max(c["max_abs_err"] for c in cases.values())
    p_ms = cuda_ms(lambda: transfer.p2g_plain(*args, cfg, DT))
    n, act, g3 = N_PARTICLES, int((st.selection == 0).sum()), N_GRID ** 3
    # bytes: each input read once, each output written once (particles with
    # selection == 0 only; the flags of all)
    b = bound(act * (12 + 12 + 36 + 36 + 4 + 4) + n + g3 * 16, act * P2G_OPS)
    k_ms = cases["phase-3 state"]["ms"]
    print(f"p2g: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}) (median of 30 CUDA-event timings, {N_PARTICLES} particles, n_grid "
          f"{N_GRID})")
    return {"p2g": {"max_abs_err": p2g_err, "ms": k_ms, "plain_ms": p_ms, **b, "library_ms": None,
                    "cases": cases},
            "g2p": _g2p_orders(dev, st, cfg)}


G2P_STALE = 100   # substeps a kept cell order drifts before B2 reads it


def _g2p_orders(dev, st, cfg, reps: int = 30) -> dict:
    """B2 against g2p_plain on the phase-3 state in three orders: as given
    (random), sorted by cell (transfer.cell_order, as the unfused frame
    keeps its state), and sorted by cell, then run G2P_STALE unfused
    substeps without re-sorting; each with its mean run length of same-cell
    lanes, the time around the call (CUDA events), its device time (a sleep
    kernel queued ahead) and its host time a call.  The row of the kernels'
    JSON line is the cell-sorted state's, the order the unfused frame runs
    B2 in, with the device time as its ms: around the call, the wrapper's
    host time (~0.03 ms) is longer than the kernel."""
    import torch

    from pixie_tpu_torch.ops import fused_substep as fs
    from pixie_tpu_torch.ops import transfer
    from pixie_tpu_torch.scripts.timing import time_calls
    from pixie_tpu_torch.sim.solver import grid_momentum_to_velocity, p2g2p, permute_state

    active = st.selection == 0
    cell = transfer.cell_order(st.x, active, cfg)
    stale = permute_state(st, cell)
    for step in range(G2P_STALE):
        stale = p2g2p(stale, cfg, (), float(step) * DT, DT)
    states = {"given": st, "cell-sorted": permute_state(st, cell),
              f"stale {G2P_STALE} substeps": stale}
    fields = ("x", "v", "C", "F_trial", "cov")
    n, act, g3 = N_PARTICLES, int(active.sum()), N_GRID ** 3
    cov = 48 * cfg.update_cov_with_F
    # bytes: x, F, cov read and x, v, C, F_trial, cov written for active
    # particles, the flags of all, the velocity grid once
    b = bound(act * (12 + 36 + 12 + 12 + 36 + 36 + cov) + 4 * n + g3 * 12,
              act * (G2P_OPS + COV_OPS * cfg.update_cov_with_F))
    per_order, err_all = {}, 0.0
    for label, s0 in states.items():
        grid_v = grid_momentum_to_velocity(transfer.p2g_plain(
            s0.x, s0.v, s0.C, s0.stress, s0.mass, s0.vol, s0.selection == 0, cfg, DT),
            cfg, DT).contiguous()

        def fresh(s0=s0):
            return s0.replace(**{k: getattr(s0, k).clone() for k in fields})

        out_k = transfer.g2p(fresh(), grid_v, cfg, DT)
        out_p = transfer.g2p_plain(fresh(), grid_v, cfg, DT)
        torch.cuda.synchronize()
        errs = {}
        for k in fields:
            ref = getattr(out_p, k)
            errs[k] = float((getattr(out_k, k) - ref).abs().max())
            tol = G2P_RTOL * max(float(ref.abs().max()), 1.0)
            if not errs[k] <= tol:
                fail(f"g2p kernel disagrees with its plain version on {k} ({label}): "
                     f"{errs[k]:.3e} > {tol:.3e}")
        err_all = max(err_all, *errs.values())
        print(f"g2p ({label}): max_abs_err " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f" (tol {G2P_RTOL:.0e} of each field's largest |value|)", flush=True)

        def device_ms(fn):
            return statistics.median(time_calls(fn, [(fresh(),) for _ in range(reps)], dev))

        def host_ms(calls=10):
            states_ = [fresh() for _ in range(calls + 1)]
            transfer.g2p(states_[0], grid_v, cfg, DT)
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000_000)
            t0 = time.perf_counter()
            for s_ in states_[1:]:
                transfer.g2p(s_, grid_v, cfg, DT)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            return 1e3 * (t1 - t0) / calls

        row = {"run_length": fs.mean_run_length(s0.x, s0.selection == 0, cfg),
               "around_ms": cuda_ms(lambda s_: transfer.g2p(s_, grid_v, cfg, DT),
                                    setup=lambda: (fresh(),)),
               "device_ms": device_ms(lambda s_: transfer.g2p(s_, grid_v, cfg, DT)),
               "host_ms": host_ms(),
               "plain_ms": cuda_ms(lambda s_: transfer.g2p_plain(s_, grid_v, cfg, DT),
                                   setup=lambda: (fresh(),), reps=10)}
        per_order[label] = row
        print(f"g2p ({label}): mean run length {row['run_length']:.3f}; around the call "
              f"{row['around_ms']:.4f} ms (CUDA events), device {row['device_ms']:.4f} ms (median of "
              f"{reps}, a sleep kernel ahead), host time a call {row['host_ms']:.4f} ms; plain "
              f"{row['plain_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
              flush=True)
    for line in _ptxas("transfer"):
        print(f"transfer ptxas: {line}")
    c, g = per_order["cell-sorted"], per_order["given"]
    print(f"g2p: kernel {c['device_ms']:.4f} ms device, {c['around_ms']:.4f} ms around the call on "
          f"the cell-sorted state (given order {g['device_ms']:.4f}, {g['around_ms']:.4f}), plain "
          f"{c['plain_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) ({n} particles, "
          f"n_grid {N_GRID})", flush=True)
    return {"max_abs_err": err_all, "ms": c["device_ms"], "around_ms": c["around_ms"],
            "plain_ms": c["plain_ms"], **b, "library_ms": None, "orders": per_order}


def _ptxas(name: str) -> list[str]:
    """The register and spill lines of a library's ptxas report."""
    from pixie_tpu_torch.ops import build

    log = build.BUILD_LOG.get(name, "(cached build: no ptxas report)")
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "cached" in ln or "Compiling" in ln]


FUSED_MATS = (0, 1, 2, 3, 5, 6)


def _fused_state(dev, n: int = N_PARTICLES, n_grid: int = N_GRID):
    """Seeded mixed-material state for B6 at the slice's shapes, and the
    velocity grid its plain P2G gives: ids 0, 1, 2, 3, 5, 6 in turn; F = F_trial
    = I + 0.01 noise, so sand both expands and compacts; yield stresses of
    1e3..1e5 Pa at E 9e6, so von Mises and snow yield, every 8th near 0, so
    snow damages; every 13th particle inactive; the first and last 500 within
    a cell of the low and high grid faces, so their stencils hang off the grid;
    update_cov_with_F on, rpic_damping 0.1, hardening on."""
    import numpy as np
    import torch

    from pixie_tpu_torch.ops import transfer
    from pixie_tpu_torch.sim.constitutive import compute_stress_from_F_trial
    from pixie_tpu_torch.sim.solver import grid_momentum_to_velocity
    from pixie_tpu_torch.sim.types import MPMConfig, finalize_mu_lam, make_state

    rng = np.random.default_rng(4)
    dx = GRID_LIM / n_grid
    x = rng.uniform(0.25 * GRID_LIM, 0.75 * GRID_LIM, (n, 3))
    x[:500] = rng.uniform(0.0, dx, (500, 3))
    x[-500:] = GRID_LIM - rng.uniform(0.0, dx, (500, 3))
    ys = rng.uniform(1e3, 1e5, n)
    ys[::8] = 1e-3
    st = finalize_mu_lam(make_state(
        x.astype(np.float32), np.full(n, 1.0 / n, np.float32), density=600.0, E=9e6, nu=0.33,
        material=np.asarray(FUSED_MATS, np.int32)[np.arange(n) % len(FUSED_MATS)],
        yield_stress=ys.astype(np.float32), device=dev))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    f = t(np.eye(3) + 0.01 * rng.normal(size=(n, 3, 3)))
    st = st.replace(v=t(rng.normal(size=(n, 3))), C=t(0.1 * rng.normal(size=(n, 3, 3))),
                    F=f, F_trial=f.clone(), cov=t(1e-3 * rng.normal(size=(n, 6))),
                    selection=torch.as_tensor((np.arange(n) % 13 == 6).astype(np.int32),
                                              device=dev))
    cfg = MPMConfig(n_grid=n_grid, grid_lim=GRID_LIM, rpic_damping=0.1, update_cov_with_F=True,
                    gravity=(0.0, 0.0, -9.8), active_materials=FUSED_MATS, hardening=1.0,
                    xi=0.1, plastic_viscosity=0.1, softening=0.5, friction_angle=30.0)
    # the stress of the F given, for the velocity grid; F, mu and the yield
    # stress stay as given, so the substep itself returns them
    st = st.replace(stress=compute_stress_from_F_trial(st, cfg, DT).stress)
    grid = transfer.p2g_plain(st.x, st.v, st.C, st.stress, st.mass, st.vol, st.selection == 0,
                              cfg, DT)
    return st, cfg, grid_momentum_to_velocity(grid, cfg, DT).contiguous()


def _branches(st, mu_in):
    """Return-map branch per particle, read from a substep's outputs: 1 if F
    left F_trial (yield, or sand off its elastic branch), + 2 if the rotation
    of sand's expansion (det F = 1), + 4 if snow damaged (mu fell to 0)."""
    import torch

    from pixie_tpu_torch.sim.svd3 import det3

    moved = (st.F != st.F_trial).flatten(1).any(1)
    expand = moved & (st.material == 2) & ((det3(st.F) - 1.0).abs() < 1e-5)
    damaged = (st.mu == 0) & (mu_in != 0)
    return moved.to(torch.int32) + 2 * expand.to(torch.int32) + 4 * damaged.to(torch.int32)


def _check_fused(out_k, grid_k, out_p, grid_p, mu_in, label: str,
                 every_branch: bool = True) -> float:
    """B6's outputs against the plain version's by the criterion above (and
    with ``every_branch`` the plain version must take every return-map
    branch); returns the largest error of the fields held to FUSED_RTOL."""
    import torch

    from pixie_tpu_torch.ops import fused_substep as fs

    err = 0.0
    for k in ("x", "v", "C", "F_trial", "cov", "grid"):
        got, ref = (grid_k, grid_p) if k == "grid" else (getattr(out_k, k), getattr(out_p, k))
        e, tol = float((got - ref).abs().max()), FUSED_RTOL * float(ref.abs().max())
        print(f"fused_substep ({label}) {k}: max_abs_err {e:.3e} (tol {tol:.3e})")
        if not e <= tol:
            fail(f"fused_substep kernel disagrees with its plain version on {k} ({label})")
        err = max(err, e)
    for k in ("F", "stress", "mu", "lam", "yield_stress"):
        got, ref = getattr(out_k, k), getattr(out_p, k)
        scale = 9e6 if k == "stress" else float(ref.abs().max())
        floor = ULP_FLOOR * scale
        diff = (got - ref).abs()
        share, worst = float((diff <= floor).float().mean()), float(diff.max())
        print(f"fused_substep ({label}) {k}: {share:.5f} of entries within the ULP floor "
              f"{floor:.3e}, max_abs_err {worst:.3e} (tol: share >= {ULP_SHARE}, max <= "
              f"{ULP_MAX * floor:.3e})")
        if not (share >= ULP_SHARE and worst <= ULP_MAX * floor):
            fail(f"fused_substep kernel disagrees with its plain version on {k} ({label})")
    bk, bp = _branches(out_k, mu_in), _branches(out_p, mu_in)
    counts = {c: int((bp == c).sum()) for c in (1, 3, 5)}
    print(f"fused_substep ({label}): return-map branch differs for "
          f"{float((bk != bp).float().mean()):.3e} of particles ({int((bk != bp).sum())}); plain "
          f"version's branches: yielded {counts[1]}, sand expanded {counts[3]}, snow damaged "
          f"{counts[5]}")
    if every_branch and not all(counts.values()):
        fail("the fused state did not take every return-map branch")
    if not all(bool(torch.isfinite(getattr(out_k, k)).all()) for k in fs.UPDATED_FIELDS):
        fail(f"non-finite fused_substep output ({label})")
    return err


RUN_SUBSTEPS = (1, 100, 399)   # substeps of a fused frame at which runs are read


def _drift_frame(st, cfg, dev):
    """A fused frame of 400 substeps of _fused_state (no collider) on the
    state sorted into the prologue's cell order, never re-sorted: the mean
    run length of that order and of a fresh cell sort at RUN_SUBSTEPS, and
    the state at substep 100."""
    import torch

    from pixie_tpu_torch.ops import fused_substep as fs
    from pixie_tpu_torch.ops import transfer
    from pixie_tpu_torch.sim.constitutive import compute_stress_from_F_trial
    from pixie_tpu_torch.sim.solver import grid_update, permute_state

    s = compute_stress_from_F_trial(st, cfg, DT)
    active = s.selection == 0
    grid, order = transfer.p2g(s.x, s.v, s.C, s.stress, s.mass, s.vol, active, cfg, DT,
                               return_order=True)
    if order is None:   # the CPU's plain P2G (a rehearsal) returns no order
        order = transfer.cell_order(s.x, active, cfg)
    s, active = permute_state(s, order), active[order]
    runs, drifted = {}, None
    for step in range(1, 400):
        grid_v = grid_update(grid, cfg, DT, 0.0, ())
        if step in RUN_SUBSTEPS:
            fresh = transfer.cell_order(s.x, active, cfg)
            runs[step] = (fs.mean_run_length(s.x, active, cfg),
                          fs.mean_run_length(s.x[fresh], active[fresh], cfg))
        if step == 100:
            drifted = s.replace(**{k: getattr(s, k).clone() for k in fs.UPDATED_FIELDS})
        grid = fs.fused_substep(s, grid_v, cfg, DT, active)
    torch.cuda.synchronize()
    return runs, drifted


def phase_fused(dev, n: int = N_PARTICLES, n_grid: int = N_GRID) -> dict:
    """B6 against fused_substep_plain on one substep of _fused_state, its
    particles in three orders: as given, sorted by cell, and sorted by cell
    at substep 0 of a fused frame, then drifted by its first 100 substeps;
    each timed with and without the splat, in the same call; the mean run
    length over a fused frame."""
    import torch

    from pixie_tpu_torch.ops import fused_substep as fs
    from pixie_tpu_torch.ops import transfer
    from pixie_tpu_torch.sim.solver import permute_state

    st, cfg, grid_v = _fused_state(dev, n, n_grid)
    runs, drifted = _drift_frame(st, cfg, dev)
    print("fused_substep: mean run length (active lanes / runs) of a fused frame's lanes in the "
          "prologue's cell order, kept without re-sorting, against a fresh cell sort: " + "; ".join(
              f"substep {k} {v[0]:.3f} (fresh {v[1]:.3f})" for k, v in runs.items()), flush=True)
    orders = {"given": st,
              "cell-sorted": permute_state(st, transfer.cell_order(st.x, st.selection == 0, cfg)),
              "drifted 100 substeps": drifted}
    err, per_order = 0.0, {}
    for label, s0 in orders.items():
        active = s0.selection == 0

        def fresh(s0=s0):
            return s0.replace(**{k: getattr(s0, k).clone() for k in fs.UPDATED_FIELDS})

        out_k, out_p = fresh(), fresh()
        grid_k = fs.fused_substep(out_k, grid_v, cfg, DT, active)
        grid_p = fs.fused_substep_plain(out_p, grid_v, cfg, DT, active)
        torch.cuda.synchronize()
        # the drifted state's snow has already damaged: that branch is spent
        err = max(err, _check_fused(out_k, grid_k, out_p, grid_p, s0.mu, label,
                                    every_branch=s0 is st))
        row = {"run_length": fs.mean_run_length(s0.x, active, cfg)}
        for sched in ("run_sums", "nosplat", "run_sums (again)"):
            row[sched] = cuda_ms(lambda s, m=sched.split()[0], a=active: fs.fused_substep_variant(
                m, s, grid_v, cfg, DT, a), setup=lambda: (fresh(),))
        per_order[label] = row
        print(f"fused_substep ({label}): mean run length {row['run_length']:.3f}; ms (median of 30 "
              f"CUDA-event timings): " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                                                   if k != "run_length"), flush=True)
    shipped = per_order["cell-sorted"]["run_sums"]
    g, c = per_order["given"], per_order["cell-sorted"]
    print(f"B6 attribution: shipped in a cell order {shipped:.4f} ms; splat ~ run_sums - nosplat: "
          f"cell-sorted {c['run_sums'] - c['nosplat']:.4f}, given "
          f"{g['run_sums'] - g['nosplat']:.4f} ms; the gather and constitutive math (nosplat) "
          f"given {g['nosplat']:.4f} against cell-sorted {c['nosplat']:.4f} ms", flush=True)

    def fresh_given():
        return st.replace(**{k: getattr(st, k).clone() for k in fs.UPDATED_FIELDS})

    active = st.selection == 0
    p_ms = cuda_ms(lambda s: fs.fused_substep_plain(s, grid_v, cfg, DT, active),
                   setup=lambda: (fresh_given(),), reps=10)
    mat = st.material[active]
    n_act = int(active.sum())
    counts = {m: int((mat == m).sum()) for m in range(8)}
    n_bytes = (n_act * (12 + 36 + 12 + 12 + 48 * cfg.update_cov_with_F  # x, F, mu lam ys, mass vol mat
                        + 12 + 12 + 36 + 36 + 36 + 36 + 12)           # x v C F_trial F stress mu lam ys
               + 4 * counts[6] + n + n_grid ** 3 * (12 + 16))         # bulk (water), flags, grids
    n_ops = sum(c * (G2P_OPS + COV_OPS * cfg.update_cov_with_F + P2G_OPS + STRESS_OPS.get(m, 18)
                     + SVD3_OPS * (m in (0, 1, 2, 3, 5))
                     + (SVD3_OPS + RETURN_MAP_OPS) * (m in (1, 2, 3, 5)))
                for m, c in counts.items())
    b = bound(n_bytes, n_ops)
    print(f"fused_substep: kernel {shipped:.4f} ms (cell-sorted lanes), plain {p_ms:.4f} ms "
          f"(median of 30 / 10 CUDA-event timings, {n} "
          f"particles, {n_act} active, n_grid {n_grid}); bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}: {n_bytes / 1e6:.2f} MB, {n_ops / 1e6:.1f} Mflop)", flush=True)
    for line in _ptxas("fused_substep"):
        print(f"fused_substep ptxas: {line}")
    return {"max_abs_err": err, "ms": shipped, "plain_ms": p_ms, **b, "library_ms": None,
            "orders": per_order,
            "run_length": {str(k): v[0] for k, v in runs.items()}}


@contextlib.contextmanager
def _unfused_frame_order(how: str):
    """The unfused frame's particle order: "cell", as shipped (the state
    permuted into P2G's cell order); "given", the frame never re-sorts, so
    the state keeps the caller's order.  The fused frame is left as it is."""
    from pixie_tpu_torch.sim import solver as solver_mod

    shipped = solver_mod._substep
    if how == "given":
        solver_mod._substep = lambda *a: shipped(*a[:-1], False)
    try:
        yield
    finally:
        solver_mod._substep = shipped


def phase_profile(dev, n: int = N_PARTICLES, n_grid: int = N_GRID,
                  substeps: dict | None = None) -> None:
    """torch.profiler over frames of _fused_state with a sticky ground
    collider, unfused (simulate_substeps) and fused (simulate_substeps_fused):
    kernel launches, device kernels, device time and wall time a substep, as
    the difference between a frame of substeps[path] substeps (20 unfused,
    a whole frame of 400 fused) and a frame of 1, so the fused frame's
    prologue and epilogue (the plain constitutive pass, once a frame) are
    reported apart.  Wall times are the best of 3 synchronized runs, taken
    before the profiler sessions of their turn; a frame of 1 substep varies
    by several ms on the host's clock, which the long frames dilute.  The
    unfused substep runs four turns: with the frame's state in a cell order
    (as shipped), in the caller's (random) order (P2G hands the frame no
    order), again in the caller's, again in a cell order, each also with
    B2's and B1's device time a substep from the profiler's kernels; the
    fused substep twice, as shipped."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pixie_tpu_torch.ops import fused_substep as fs
    from pixie_tpu_torch.sim import bc as bc_mod
    from pixie_tpu_torch.sim.solver import simulate_substeps, simulate_substeps_fused

    st, cfg, _ = _fused_state(dev, n, n_grid)
    bcs = (bc_mod.make_surface_collider((1.0, 1.0, 0.3), (0.0, 0.0, 1.0), "sticky",
                                        device=dev),)
    runs = {"unfused": simulate_substeps, "fused": simulate_substeps_fused}
    substeps = substeps or {"unfused": 20, "fused": 400}

    def go(name, k):
        s = st.replace(**{f: getattr(st, f).clone() for f in fs.UPDATED_FIELDS})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name](s, cfg, bcs, 0.0, DT, k)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def measure(name, label):
        k = substeps[name]
        walls, res = {}, {}
        for case in (1, k):
            go(name, case)  # warm-up
            walls[case] = min(go(name, case) for _ in range(3))
        for case in (1, k):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                go(name, case)
            events = prof.events()
            kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
            launches = sum(1 for e in events if e.name in (
                "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"))
            res[case] = (walls[case], len(kernels), launches,
                         sum(e.time_range.elapsed_us() for e in kernels),
                         *(sum(e.time_range.elapsed_us() for e in kernels if name_ in e.name)
                           for name_ in ("g2p_kernel", "p2g_binned_kernel")))
        one, full = res[1], res[k]
        wall, n_kern, n_launch, dev_us, g2p_us, p2g_us = (
            (f - o) / (k - 1) for f, o in zip(full, one))
        print(f"profile {label}, {n} particles, a substep (frame of {k} less frame of 1): "
              f"{1.0 / wall:.2f} substeps/s, {wall * 1e3:.3f} ms wall, {n_kern:.1f} device "
              f"kernels, {n_launch:.1f} kernel launches, device time {dev_us / 1e3:.3f} ms, "
              f"device idle {1.0 - dev_us * 1e-6 / wall:.3f} of the wall; a frame of 1 substep: "
              f"{one[0] * 1e3:.3f} ms wall, {one[1]} device kernels, {one[2]} launches, device "
              f"time {one[3] / 1e3:.3f} ms; a substep's B2 {g2p_us / 1e3:.4f} ms, B1's splat "
              f"{p2g_us / 1e3:.4f} ms device", flush=True)

    names = {"cell": "state in a cell order", "given": "state in the caller's order"}
    for turn in ("cell", "given", "given", "cell"):
        with _unfused_frame_order(turn):
            measure("unfused", f"unfused ({names[turn]})")
    for _ in range(2):
        measure("fused", "fused (B6 as shipped)")


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
    b = _blend_bound(bins, pixel_bytes=16, out_bytes=0)   # writes img and T
    print(f"gs_blend: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median of 30 CUDA-event "
          f"timings, {res}x{res}, tile_cap 512); bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})", flush=True)
    ablation = _blend_ablation(bins, dev, 512)
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **b, "library_ms": None,
            "ablation_ms": ablation}


def _power_bits_equal(bins, dev, n_tiles: int = 64) -> int:
    """The packed staging's power, with the conic scaled by -1/2 and -1 at
    staging, against the plain version's order of operations, bit for bit,
    over every (pixel, entry) pair of the n_tiles heaviest tiles (plain
    PyTorch ops on the card, each rounded on its own as the kernel rounds
    them); fails on any differing bit.  Returns the number of pairs."""
    import torch

    from pixie_tpu_torch.ops import gs_stream

    px, py = gs_stream._pixel_centres(bins.starts.shape[0], bins.tx_n, dev)
    pairs = 0
    for t in torch.argsort(bins.counts, descending=True)[:n_tiles].tolist():
        s0, c = int(bins.starts[t]), int(bins.counts[t])
        f = bins.feat[bins.idx[s0:s0 + c].long()][:, None, :]
        dx, dy = px[t][None, :] - f[..., 0], py[t][None, :] - f[..., 1]
        plain = -0.5 * (f[..., 2] * dx * dx + f[..., 4] * dy * dy) - f[..., 3] * dx * dy
        scaled = ((-0.5 * f[..., 2]) * dx * dx + (-0.5 * f[..., 4]) * dy * dy) \
            + (-f[..., 3]) * dx * dy
        if not torch.equal(plain.view(torch.int32), scaled.view(torch.int32)):
            fail("the scaled conic's power differs from the plain version's in some bit")
        pairs += plain.numel()
    return pairs


def _blend_ablation(bins, dev, tile_cap: int, bg: float = 0.0) -> dict:
    """B3's schedules on one scene, with and without the state, in turns:
    the shipped kernel (packed staging, per-warp entry lists, exact early
    exit, half-tile blocks) and the ablations nolists and alpha; the shipped
    kernel's img, T and state bit for bit against nolists' (the lists drop
    no hit); the share of the (warp, entry) pairs the lists keep.  Returns
    {mode: ms} a state."""
    import torch

    from pixie_tpu_torch.ops import gs_stream

    args = (bins.feat, bins.idx, bins.starts, bins.counts, bins.tx_n, bg)
    out = {}
    for keep in (False, True):
        ship = gs_stream.blend_forward_variant("shipped", *args, keep)
        full = gs_stream.blend_forward_variant("nolists", *args, keep)
        torch.cuda.synchronize()
        if not all((g is None and w is None) or torch.equal(g, w) for g, w in zip(ship, full)):
            fail(f"B3 (state {keep}) is not bitwise equal to its nolists ablation")
        ms = {}
        for mode in ("shipped", "nolists", "alpha", "shipped (again)"):
            ms[mode] = cuda_ms(lambda m=mode.split()[0]: gs_stream.blend_forward_variant(
                m, *args, keep))
        out["state" if keep else "no_state"] = ms
        print(f"B3 at tile_cap {tile_cap}, {'keeping' if keep else 'without'} the state: img, T"
              f"{', state' if keep else ''} bitwise equal to nolists'; ms (median "
              f"of 30 CUDA-event timings, in turns): "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    box = gs_stream.blend_box_plain(bins.feat)
    met = pairs = 0
    w = torch.arange(8, device=dev)                     # a warp's 8 x 4 pixel block
    wx, wy = (w % 2) * 8.0 + 0.5, (w // 2) * 4.0 + 0.5
    for t, (s0, c) in enumerate(zip(bins.starts.tolist(), bins.counts.tolist())):
        if not c:
            continue
        b = box[bins.idx[s0:s0 + c].long()]
        x0 = wx + float((t % bins.tx_n) * 16)
        y0 = wy + float((t // bins.tx_n) * 16)
        hit = ((b[:, 0:1] <= x0 + 7.0) & (b[:, 1:2] >= x0)
               & (b[:, 2:3] <= y0 + 3.0) & (b[:, 3:4] >= y0))
        met += int(hit.sum())
        pairs += hit.numel()
    out["list_share"] = met / max(pairs, 1)
    out["power_pairs"] = _power_bits_equal(bins, dev)
    print(f"B3 at tile_cap {tile_cap}: the per-warp lists keep {out['list_share']:.4f} of the "
          f"{pairs} (warp, entry) pairs; power of the scaled conic bit-equal to the plain "
          f"version's on {out['power_pairs']} (pixel, entry) pairs of the 64 heaviest tiles",
          flush=True)
    return out


def _blend_bound(bins, pixel_bytes: int, out_bytes: int) -> dict:
    """Bound of one walk of a tile blend over these bins: feat, idx, starts,
    counts read once, `pixel_bytes` read or written a pixel (256 a tile),
    `out_bytes` more written; BLEND_PAIR_OPS for each (pixel, entry) pair."""
    n_pairs = 256 * int(bins.counts.sum())
    n_bytes = (4 * bins.feat.numel() + 4 * bins.idx.numel() + 8 * bins.starts.numel()
               + pixel_bytes * 256 * bins.starts.numel() + out_bytes)
    return bound(n_bytes, BLEND_PAIR_OPS * n_pairs)


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
    # the forward's state (colour before the background, final T), which the
    # backward kernel reads as training's autograd hands it over
    state = gs_stream.blend_forward(*args[:6], keep_state=True)[2]

    def kernel(*a):
        return gs_stream.blend_backward(*a, state)

    peaks = []
    for fn in (kernel, gs_stream.blend_backward_plain):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(*args)
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2**20)
        if fn is kernel:
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
    # the pass1 ablation must still agree: the ablation below is read against it
    prev = gs_stream.blend_backward_variant("pass1", *args, state)
    rel_prev = ((prev - d_p).abs().max(0).values / scale).tolist()
    print("blend backward (pass1): per-column max_abs_err / max |plain|: "
          + " ".join(f"{r:.2e}" for r in rel_prev))
    if not all(r <= BWD_RTOL for r in rel_prev):
        fail("the pass1 blend backward disagrees with its plain version")
    k_ms = cuda_ms(lambda: kernel(*args))
    p_ms = cuda_ms(lambda: gs_stream.blend_backward_plain(*args), reps=5, warmup=1)
    # one walk; reads d img, d trans (16 B a pixel) and the forward's state
    # (32 B a pixel), writes d feat
    b = _blend_bound(bins, pixel_bytes=16 + 32, out_bytes=4 * bins.feat.numel())
    # the walk stops early only behind pixels whose T reached exactly 0: the
    # bound counts every (pixel, entry) pair, which this share qualifies
    opaque = float((gs_stream.blend_forward(*args[:6])[1] == 0.0).double().mean())
    print(f"gs_blend_backward: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median of 30 / 5 "
          f"CUDA-event timings); bound {b['bound_ms']:.4f} ms ({b['bound_by']}; share of "
          f"pixels whose T reaches 0: {opaque:.4f}); peak device "
          f"memory above the inputs: kernel {peaks[0]:.1f} MiB, plain {peaks[1]:.1f} MiB",
          flush=True)
    # the ablation and the forward that feeds the state, against the shipped
    # kernel, in turns
    ablation = {"shipped": k_ms}
    for mode in gs_stream.BWD_MODES:
        ablation[mode] = cuda_ms(lambda m=mode: gs_stream.blend_backward_variant(m, *args,
                                                                                 state))
    ablation["shipped (again)"] = cuda_ms(lambda: kernel(*args))
    fwd = {"no_state": cuda_ms(lambda: gs_stream.blend_forward(*args[:6])),
           "keep_state": cuda_ms(lambda: gs_stream.blend_forward(*args[:6], keep_state=True))}
    fwd["no_state (again)"] = cuda_ms(lambda: gs_stream.blend_forward(*args[:6]))
    # B3 as a training step runs it: its bound (one walk; img, T and the
    # state written, 48 B a pixel) and its schedules at these shapes
    fwd["bound"] = _blend_bound(bins, pixel_bytes=48, out_bytes=0)
    fwd["ablation"] = _blend_ablation(bins, dev, tile_cap, bg=0.3)
    print(f"B3 keeping the state at tile_cap {tile_cap}: bound {fwd['bound']['bound_ms']:.4f} ms "
          f"({fwd['bound']['bound_by']})", flush=True)
    print("gs_blend_backward ablation, ms (median of 30 CUDA-event timings, same inputs): "
          + ", ".join(f"{m} {t:.4f}" for m, t in ablation.items()), flush=True)
    a = ablation
    print(f"B4 attribution: {k_ms:.4f} ms; per-entry reduction ~ shipped - noreduce = "
          f"{k_ms - a['noreduce']:.4f} ms; pass 1 replaced by the forward's state ~ pass1 - "
          f"shipped = {a['pass1'] - k_ms:.4f} ms", flush=True)
    print(f"B3 at B4's shapes (tile_cap {tile_cap}), ms: without the state {fwd['no_state']:.4f} "
          f"/ {fwd['no_state (again)']:.4f}, keeping it (as training runs it) "
          f"{fwd['keep_state']:.4f}; a training step's pair: forward with state + backward "
          f"{fwd['keep_state'] + k_ms:.4f} against forward without state + pass1 backward "
          f"{fwd['no_state'] + a['pass1']:.4f}", flush=True)
    return {"max_abs_err": float(err.max()), "ms": k_ms, "plain_ms": p_ms, **b,
            "library_ms": None, "ablation_ms": ablation, "forward_ms": fwd}


def phase_probes(dev, b1_ms: float | None = None, n: int = N_PARTICLES, t: int = 8192,
                 l: int = 128) -> tuple[dict, dict]:
    """The probe entry points P1 and P2 at full width, their launch counts,
    then each kernel against its plain version on the same inputs; P1 full's
    time beside ``b1_ms``, B1's device time on P1's particles from phase 3.
    Returns (kernel rows, the probe path's launches)."""
    import torch

    from pixie_tpu_torch.ops import gather, probe_ablation as pa
    from pixie_tpu_torch.scripts import probe_kernel_ablation as p1, probe_vmem_gather as p2
    from pixie_tpu_torch.scripts.timing import time_calls

    _reset_counts()
    p1_ms = p1.main(device=dev, n=n)
    p2_out = p2.main(device=dev, t=t, l=l)
    launches = _read_counts()
    want = _counts(**dict.fromkeys(PROBE_P2G, len(p1.ORDERS) * (p1.WARMUP + p1.REPS)),
                   **dict.fromkeys(GATHERS, 1 + p2.WARMUP + p2.REPS))
    print(f"probes: launches {launches}", flush=True)
    if launches != want:
        fail(f"probe launches {launches} != {want}")

    def median_ms(fn, reps=30):
        return statistics.median(time_calls(fn, [()] * reps, dev))

    rows, cfg, d = {}, p1.config(), p1.make_particles(n)
    for order in p1.ORDERS:
        args = p1.inputs(d, order, cfg, dev)
        for mode in pa.MODES:
            got = pa.p2g_variant(mode, *args, cfg, p1.DT)
            ref = pa.p2g_variant_plain(mode, *args, cfg, p1.DT)
            torch.cuda.synchronize()
            err, scale = float((got - ref).abs().max()), float(ref.abs().max())
            tol = PROBE_RTOL[mode] * scale
            print(f"probe_p2g_{mode} ({order}): max_abs_err {err:.3e} (max |plain| {scale:.3e}, "
                  f"tol {tol:.3e})")
            if not (err <= tol and scale > 0.0):
                fail(f"P1 {mode} kernel disagrees with its plain version ({order} order)")
            row = rows.setdefault(f"probe_p2g_{mode}", {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if order == "generated":
                act, g3 = int(args[6].sum()), cfg.n_grid ** 3
                out_bytes = {"full": g3 * 16, "noweights": g3 * 16, "noatomics": n * 16,
                             "minimal": n * 4}[mode]
                b = bound(act * (12 + 12 + 36 + 36 + 4 + 4) + n + out_bytes,
                          act * PROBE_OPS[mode])
                p_ms = median_ms(lambda m=mode: pa.p2g_variant_plain(m, *args, cfg, p1.DT),
                                 reps=10)
                row.update(ms=p1_ms[mode]["generated"], plain_ms=p_ms, **b, library_ms=None,
                           ms_cell_sorted=p1_ms[mode]["cell_sorted"])
                print(f"probe_p2g_{mode}: kernel {row['ms']:.4f} ms (cell-sorted "
                      f"{row['ms_cell_sorted']:.4f}), plain {p_ms:.4f} ms (median of 10), bound "
                      f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    for order in p1.ORDERS:
        ms = {m: p1_ms[m][order] for m in (*pa.MODES, "keys_sort")}
        print(f"P2G attribution ({order}, {n} particles): full {ms['full']:.4f} ms; atomics "
              f"~ full - noatomics = {ms['full'] - ms['noatomics']:.4f} ms; weight math ~ full - "
              f"noweights = {ms['full'] - ms['noweights']:.4f} ms; load/launch ~ minimal = "
              f"{ms['minimal']:.4f} ms; keys+sort {ms['keys_sort']:.4f} ms (share of full "
              f"{ms['keys_sort'] / ms['full']:.3f})", flush=True)
        rows["probe_p2g_full"][f"keys_sort_ms_{order}"] = ms["keys_sort"]
    if b1_ms is not None:
        full = rows["probe_p2g_full"]
        full["b1_device_ms"] = b1_ms
        print(f"P1 full {full['ms']:.4f} ms (generated order; cell-sorted "
              f"{full['ms_cell_sorted']:.4f}) against B1's device time on P1's particles in "
              f"phase 3, {b1_ms:.4f} ms: ratio {full['ms'] / b1_ms:.3f}", flush=True)

    for axis in (0, 1):
        table, idx, _ = p2.make_inputs(axis, t, l, device=dev)
        got = gather.take_along_axis(table, idx, axis)
        ref = gather.take_along_axis_plain(table, idx, axis)
        lib = torch.gather(table, axis, idx)
        torch.cuda.synchronize()
        if not (torch.equal(got, ref) and torch.equal(lib, ref)):
            fail(f"gather axis {axis} kernel disagrees with its plain version")
        k_ms = median_ms(lambda: gather.take_along_axis(table, idx, axis))
        lib_ms = median_ms(lambda: torch.gather(table, axis, idx))
        p_ms = median_ms(lambda: gather.take_along_axis_plain(table, idx, axis), reps=10)
        b = bound(3 * t * l * 4, 0)
        name = f"gather_axis{axis}"
        print(f"{name}: exact against its plain version and torch.gather; kernel {k_ms:.4f} ms "
              f"(probe: mean {p2_out[axis]['ms']:.4f} over {p2.REPS} fresh index arrays), "
              f"torch.gather {lib_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}) at {t} x {l}", flush=True)
        rows[name] = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, **b, "library_ms": lib_ms}
    return rows, launches


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
    if launches != _counts(gs_blend=iters + n_views, gs_blend_backward=iters):
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
    _unet_checkpoints(root, d, fc, model_kwargs)
    print(f"object: {d}^3 grid, {int(mask.sum())} occupied voxels, {fc} float16 channels")
    return render, feats, mask


def _unet_checkpoints(root: Path, d: int, fc: int, model_kwargs: dict) -> None:
    """Seeded U-Net checkpoints in root / checkpoints_{discrete,continuous}."""
    import torch

    from pixie_tpu_torch.models.unet3d import RegressionUNet, SegmentationUNet, seeded_state_dict

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


def phase_slice(dev, gs_dir: Path, d: int = 64, fc: int = 768, model_kwargs: dict | None = None,
                n_frames: int = N_FRAMES, res: int = RES) -> dict:
    """The main path at the shipped width (defaults: 64^3 x 768, U-Nets with
    model_channels 64, mult (1,1,2,4), 3 res blocks, projector 768->128->32),
    then the 3DGS checkpoint in ``gs_dir`` rendered at res x res.  Returns
    each path's launches."""
    import numpy as np
    import torch

    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.recon.gaussians import load_gaussian_ply
    from pixie_tpu_torch.sim.params import decode_param_json
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
        if pc_launches != _counts(p2g=substeps, g2p=substeps):
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
        if launches != _counts(p2g=substeps, g2p=substeps, gs_blend=n_frames):
            fail(f"GS launches {launches} != {substeps} substeps, {n_frames} frames")
        _check_gs_run(gs_out, info, n_frames, res)

        # (c) the fused path: fused frames wherever no particle BC is active;
        # its unfused frame 0 keeps the caller's order, (b)'s runs in a cell
        # order, and the two are compared below
        _reset_counts()
        gs_fused = root / "sim_gs_fused"
        with _unfused_frame_order("given"):
            info_f = pipeline.run_physics_simulation(ply, tree_cfg, gs_fused, n_frames=n_frames,
                                                     debug=True, gaussian_checkpoint=gs_dir,
                                                     render_img=True, device=dev, fused=True)
        launches_f = _read_counts()
        _check_fused_launches("GS", info_f, launches_f, n_frames, gs_blend=n_frames)
        _check_gs_run(gs_fused, info_f, n_frames, res)
        mp = decode_param_json(tree_cfg)[0]
        dx_world = mp["grid_lim"] / mp["n_grid"] / info_f["scale_origin"]
        for i in range(1, n_frames):
            name = f"frame_{i:05d}.ply"
            d = ((load_gaussian_ply(gs_out / "ply_files" / name)["xyz"]
                  - load_gaussian_ply(gs_fused / "ply_files" / name)["xyz"]).norm(dim=1)
                 / dx_world)
            if i - 1 in info_f["fused_frames"]:
                how, bounds = "fused against unfused", (FUSED_DX_MAX, FUSED_DX_MEAN)
            else:
                how, bounds = ("unfused in both runs, a cell order against the caller's",
                               (ORDER_DX_MAX, ORDER_DX_MEAN))
            print(f"fused vs unfused GS rollout, x after frame {i - 1} ({how}): max |dx| "
                  f"{float(d.max()):.3e} cells, mean {float(d.mean()):.3e} cells (bound "
                  f"{bounds[0]} / {bounds[1]})", flush=True)
            if not (float(d.max()) <= bounds[0] and float(d.mean()) <= bounds[1]):
                fail(f"the GS rollouts diverge after frame {i - 1} ({how})")

        _reset_counts()
        pc_fused = root / "sim_fused"
        info_pf = pipeline.run_physics_simulation(ply, tree_cfg, pc_fused, n_frames=2, debug=True,
                                                  device=dev, fused=True)
        launches_pf = _read_counts()
        _check_fused_launches("point cloud", info_pf, launches_pf, 2)
        for p in sorted((pc_fused / "ply_files").glob("frame_*.ply")):
            v = read_ply(p)["vertex"]
            if len(v) != info_pf["n_particles"] or not all(np.isfinite(v[k]).all() for k in "xyz"):
                fail(f"{p.name}: non-finite or missing positions (fused point cloud)")
        if not info_pf["final_state_finite"]:
            fail("non-finite positions after the last fused point-cloud substep")
        # (d) particle filling: a GS rollout of the sand config, which fills
        launches_fill = _filling_rollout(dev, root, ply, gs_dir, res)
        return {"point_cloud": pc_launches, "gs": launches, "gs_fused": launches_f,
                "point_cloud_fused": launches_pf, "gs_filling": launches_fill}


FILL_SUBSTEPS = 20


def _filling_rollout(dev, root: Path, ply: Path, gs_dir: Path, res: int) -> dict:
    """One GS rollout of a copy of config/objaverse/custom_sand_config.json
    (particle_filling: fill grid 100, sim n_grid 200), cut to one frame of
    FILL_SUBSTEPS substeps, rendered once with gs_dir's cameras.  The
    gaussians are the outer half (by distance from their mean) of the
    seeded model that phase 5's capture was rendered from, not phase 5's
    checkpoint: that model is a solid ball, which leaves no empty cell to
    fill, while a capture's trained model has its gaussians on the surface;
    and the checkpoint's opacities still carry the reset of iteration 250,
    so its density stays under the config's search threshold (printed).
    The filled count must be positive and the state finite.  Returns the
    path's launches."""
    import numpy as np
    import torch

    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.recon.gaussians import load_gaussian_ply, save_gaussian_ply
    from pixie_tpu_torch.recon.train_gaussians import search_for_max_iteration
    from pixie_tpu_torch.sim.params import decode_param_json

    it = search_for_max_iteration(gs_dir / "point_cloud")
    trained = torch.sigmoid(load_gaussian_ply(
        gs_dir / "point_cloud" / f"iteration_{it}" / "point_cloud.ply")["opacity"])
    params = {k: v.cpu() for k, v in _gs_model(dev, N_GAUSSIANS, res)[0].items()}
    r = (params["xyz"] - params["xyz"].mean(0)).norm(dim=1)
    outer = r > r.median()
    shell = root / "gs_shell"
    (shell / "point_cloud" / "iteration_1").mkdir(parents=True)
    save_gaussian_ply(shell / "point_cloud" / "iteration_1" / "point_cloud.ply",
                      {k: v[outer] for k, v in params.items()})
    (shell / "cameras.json").write_bytes((gs_dir / "cameras.json").read_bytes())
    print(f"filling rollout: phase 5's checkpoint (iteration {it}) has opacities of median "
          f"{float(trained.median()):.4f}, {float((trained > 0.1).float().mean()):.3f} of them "
          f"above 0.1; the rollout takes the {int(outer.sum())} of {len(outer)} gaussians of "
          f"the capture's seeded model farther than the median {float(r.median()):.3f} from "
          f"their mean", flush=True)
    cfg = json.loads((HERE / "config" / "objaverse" / "custom_sand_config.json").read_text())
    print(f"filling rollout: custom_sand_config.json cut from frame_dt {cfg['frame_dt']} "
          f"({round(cfg['frame_dt'] / cfg['substep_dt'])} substeps) x {cfg['frame_num']} frames "
          f"to {FILL_SUBSTEPS} substeps x 1 frame; particle_filling as shipped "
          f"({json.dumps(cfg['particle_filling'])})", flush=True)
    cfg["frame_dt"] = FILL_SUBSTEPS * cfg["substep_dt"]
    cfg_path = root / "custom_sand_config_cut.json"
    cfg_path.write_text(json.dumps(cfg))
    _reset_counts()
    out = root / "sim_gs_filling"
    t0 = time.time()
    info = pipeline.run_physics_simulation(ply, cfg_path, out, n_frames=1, debug=True,
                                           gaussian_checkpoint=shell, render_img=True,
                                           device=dev)
    launches = _read_counts()
    s = info["substeps_per_frame"]
    print(f"filling rollout: {info['n_particles']} particles = "
          f"{info['n_particles'] - info['n_filled']} gaussians + {info['n_filled']} filled; "
          f"n_grid {decode_param_json(cfg_path)[0]['n_grid']}, 1 frame x {s} substeps, "
          f"materials {info['active_materials']}, {time.time() - t0:.1f} s with setup; "
          f"launches {launches}", flush=True)
    if not info["n_filled"] > 0:
        fail("particle filling added no particle")
    if not info["final_state_finite"]:
        fail("non-finite positions after the filled rollout")
    if s != FILL_SUBSTEPS or launches != _counts(p2g=s, g2p=s, gs_blend=1):
        fail(f"filling rollout launches {launches} != {FILL_SUBSTEPS} substeps and 1 render")
    _check_gs_run(out, {**info, "n_particles": info["n_particles"] - info["n_filled"],
                        "final_state_finite": info["final_state_finite"]}, 1, res)
    if not np.isfinite(info["median_frame_s"]):
        fail("no frame time for the filled rollout")
    return launches


def _check_gs_run(gs_out: Path, info: dict, n_frames: int, res: int) -> None:
    """The GS run's frames are lit and of the render's size, its gaussian PLYs
    finite, and its final state finite."""
    import numpy as np
    import torch
    from PIL import Image

    from pixie_tpu_torch.recon.gaussians import load_gaussian_ply

    pngs = sorted((gs_out / "frames").glob("*.png"))
    if [p.name for p in pngs] != [f"{i:05d}.png" for i in range(n_frames)]:
        fail(f"frames {[p.name for p in pngs]}")
    for p in pngs:
        img = np.asarray(Image.open(p))
        lit = float((img.max(-1) > 16).mean())
        print(f"  {gs_out.name}/{p.name}: {img.shape}, mean {img.mean():.2f}, lit share {lit:.3f}")
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
        fail(f"non-finite positions after the last substep of {gs_out.name}")


def _check_fused_launches(mode: str, info: dict, launches: dict, n_frames: int,
                          gs_blend: int = 0) -> None:
    """Frame 0 holds the tree config's impulse and runs unfused (S P2G, S
    G2P); every later frame runs fused (1 P2G, S - 1 fused substeps, 1 G2P)."""
    s = info["substeps_per_frame"]
    fused = info["fused_frames"]
    frame_s = info["frame_s"]
    want = _counts(p2g=s + (n_frames - 1), g2p=s + (n_frames - 1), gs_blend=gs_blend,
                   fused_substep=(n_frames - 1) * (s - 1))
    print(f"mpm ({mode}, fused): {info['n_particles']} particles, {n_frames} frames x {s} "
          f"substeps, fused frames {fused}; frame 0 (unfused, impulse) {s / frame_s[0]:.2f} "
          f"substeps/s, fused frames {s / statistics.median(frame_s[1:]):.2f} substeps/s "
          f"(median); frame seconds {[round(t, 4) for t in frame_s]}; launches {launches}",
          flush=True)
    if fused != list(range(1, n_frames)):
        fail(f"{mode}: fused frames {fused}, expected every frame after the impulse's")
    if launches != want:
        fail(f"{mode} fused launches {launches} != {want}")


def _seed_field(module, gen, table_scale: float) -> None:
    """Parameters from ``gen``: hash tables U(0, table_scale), weights
    N(0, 1/fan_in), biases 0."""
    import torch

    with torch.no_grad():
        for name, prm in module.named_parameters():
            if name.endswith("table"):
                prm.copy_(torch.rand(prm.shape, generator=gen) * table_scale)
            elif name.endswith("weight"):
                prm.copy_(torch.randn(prm.shape, generator=gen) / prm.shape[1] ** 0.5)
            else:
                prm.zero_()


def _fit_density(nerf, pts01, inside, steps: int, batch: int = 65536) -> float:
    """Adam on the NerfField's log density (clip(h - 1, -15, 15)) toward 4
    inside the ball and -6 outside, ``batch`` seeded grid points a step, in
    plain PyTorch; returns the last loss."""
    import torch

    target = torch.where(inside, 4.0, -6.0)
    gen = torch.Generator(device=pts01.device).manual_seed(1)
    opt = torch.optim.Adam(nerf.parameters(), lr=1e-2)
    for _ in range(steps):
        sel = torch.randint(len(pts01), (min(batch, len(pts01)),), generator=gen,
                            device=pts01.device)
        opt.zero_grad(set_to_none=True)
        loss = ((torch.log(nerf(pts01[sel], None, True)[:, 0]) - target[sel]) ** 2).mean()
        loss.backward()
        opt.step()
    return float(loss.detach())


def _write_f3rm_ckpt(path: Path, seed: int) -> None:
    """A seeded nerfstudio/f3rm step-*.ckpt: the F3RM feature field and a
    nerfacto mlp_base at max_res 2048 as flat [network | encoding] buffers,
    the colour head and an appearance embedding, under the keys
    find_tcnn_buffers reads."""
    import numpy as np
    import torch

    from pixie_tpu_torch.recon import tcnn_compat as tc

    rng = np.random.default_rng(seed)

    def buffer(n_net, n_enc):
        return torch.as_tensor(np.concatenate([
            rng.normal(0.0, 0.3, n_net).astype(np.float32),
            rng.uniform(-0.5, 0.5, n_enc).astype(np.float32)]))

    base = tc.nerfacto_density_field(max_res=2048)
    torch.save({"pipeline": {
        "_model.feature_field.field.params": buffer(tc.F3RM_MLP.n_params, tc.F3RM_GRID.n_params),
        "_model.field.mlp_base.params": buffer(base.mlp.config.n_params,
                                               base.grid.config.n_params),
        "_model.field.mlp_head.params": torch.as_tensor(
            rng.normal(0.0, 0.3, tc.NERFACTO_HEAD_MLP.n_params).astype(np.float32)),
        "_model.field.embedding_appearance.embedding.weight": torch.as_tensor(
            rng.normal(0.0, 0.5, (12, 32)).astype(np.float32))}, "step": 0}, path)


def _fp16_within_ulp(got, want) -> int:
    """How many float16 values differ by more than one float16 ulp of the
    larger of the two (near zero: two float32 ulps of the largest |want|)."""
    import numpy as np

    g, w = got.astype(np.float32), want.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))).astype(np.float32)
    return int((np.abs(g - w) > ulp + 2.0 ** -22 * np.abs(w).max()).sum())


def phase_voxelize(dev, d: int = 64, fc: int = 768, model_kwargs: dict | None = None,
                   fit_steps: int = VOX_FIT_STEPS, n_check: int = 1000) -> dict:
    """The voxelizer stage from a field checkpoint through the U-Nets, the
    map and one point-cloud frame, then the f3rm checkpoint's grid query.
    Returns the path's launches."""
    import numpy as np
    import torch

    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.config import compose
    from pixie_tpu_torch.recon import tcnn_compat as tc
    from pixie_tpu_torch.recon.field import FeatureField, NerfField
    from pixie_tpu_torch.recon.field_adapter import load_field_adapter, use_fp32_matmuls
    from pixie_tpu_torch.recon.train_field import save_field_checkpoint
    from pixie_tpu_torch.utils.io import read_ply
    from pixie_tpu_torch.voxel.voxelize import (
        create_occupancy_mask, dense_voxel_grid, pack_rows,
    )

    model_kwargs = model_kwargs or {}
    vc = compose().voxelization
    lo_b, hi_b = vc.scene_bounds.x_bound
    h = (hi_b - lo_b) / d
    grid = dense_voxel_grid((lo_b,) * 3, (hi_b,) * 3, h)
    flat = grid.reshape(-1, 3)
    tree_cfg = HERE / "config" / "objaverse" / "custom_tree_config.json"
    mask_range = tuple(int(v * (d / 64) ** 3) for v in VOX_MASK_RANGE)
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="pixie_smoke_vox_") as tmp:
        root = Path(tmp)
        # 1. a seeded field, its density fitted to the ball on the card
        t0 = time.time()
        use_fp32_matmuls(dev)
        gen = torch.Generator().manual_seed(0)
        nerf, feat = NerfField(), FeatureField(feature_dim=fc)
        _seed_field(nerf, gen, 2e-4)
        _seed_field(feat, gen, 1.0)
        nerf.to(dev)
        pts01 = torch.as_tensor(flat * 0.5 + 0.5, device=dev)
        inside = torch.as_tensor(np.linalg.norm(flat, axis=1) < 29.0 / 64.0, device=dev)
        loss = _fit_density(nerf, pts01, inside, fit_steps)
        with torch.no_grad():
            alpha = 1.0 - torch.exp(-nerf(pts01, None, True)[:, 0] * np.float32(h))
        n_alpha = int((alpha > vc.alpha_threshold_for_mask).sum())
        torch.cuda.synchronize()
        print(f"voxelize: field fitted in {time.time() - t0:.2f} s ({fit_steps} Adam steps, "
              f"{min(65536, len(flat))} of {len(flat)} points a step, loss {loss:.4f}); {n_alpha} "
              f"voxels over the "
              f"alpha threshold (ball {int(inside.sum())})", flush=True)
        if not mask_range[0] <= n_alpha <= mask_range[1]:
            fail(f"the fitted density holds {n_alpha} voxels, outside {mask_range}")
        nerf_out = root / "f3rm"
        save_field_checkpoint(nerf_out, {"nerf": nerf, "feat": feat}, feature_dim=fc)
        del nerf, pts01, alpha
        _unet_checkpoints(root, d, fc, model_kwargs)

        # 2. the stages: voxelize -> U-Nets on the device grid -> map -> MPM
        _reset_counts()
        render = root / "render_outputs" / "smokeobj"
        t0 = time.time()
        vox = pipeline.generate_voxels(nerf_out, render, grid_size=d,
                                       batch_size=vc.batch_size, device=dev)
        vox_s = time.time() - t0
        t0 = time.time()
        ply = pipeline.generate_neural_segmentation(
            render, root / "neural", "smokeobj", root / "checkpoints_discrete",
            root / "checkpoints_continuous", grid_size=d, feature_channels=fc,
            model_kwargs=model_kwargs, device=dev, features_dev=vox["features_dev"])
        torch.cuda.synchronize()
        seg_s = time.time() - t0
        info = pipeline.run_physics_simulation(ply, tree_cfg, root / "sim", n_frames=1,
                                               debug=True, device=dev)
        launches = _read_counts()
        timings = vox.pop("wait")()
        mask = np.load(vox["mask"]) > 0.5
        s = info["substeps_per_frame"]
        print(f"voxelize: generate_voxels {vox_s:.2f} s, timings "
              f"{ {k: round(v, 4) for k, v in timings.items()} }; {int(mask.sum())} occupied "
              f"voxels of {d}^3; U-Net stage {seg_s:.2f} s; mpm (point cloud) "
              f"{info['n_particles']} particles, 1 frame x {s} substeps, "
              f"{info['substeps_per_sec']:.2f} substeps/s; launches {launches}", flush=True)
        print(f"voxelize: nvidia-smi {_smi()}", flush=True)
        if not mask_range[0] <= int(mask.sum()) <= mask_range[1]:
            fail(f"the voxelizer's mask holds {int(mask.sum())} voxels, outside {mask_range}")
        if launches != _counts(p2g=s, g2p=s):
            fail(f"voxelize path launches {launches} != substeps run {s}")
        verts = read_ply(ply)["vertex"]
        if len(verts) != int(mask.sum()) or not info["final_state_finite"]:
            fail(f"mapped_preds.ply has {len(verts)} vertices for a mask of {int(mask.sum())}, "
                 f"or the rollout went non-finite")

        # 3. the checks: device grid vs npy, mask vs the CPU, features vs the CPU
        feats = np.load(vox["features"])
        if not np.array_equal(vox["features_dev"].cpu().numpy().view(np.uint16),
                              feats.view(np.uint16)):
            fail("the device feature grid differs from clip_features_features.npy")
        alphas, rgb = np.load(vox["alphas"]), np.load(vox["rgb"])
        cpu_mask = create_occupancy_mask(grid, alphas, rgb, vc.alpha_threshold_for_mask,
                                         vc.gray_threshold, voxel_size=h, device="cpu")
        if not np.array_equal(cpu_mask, mask):
            fail(f"the mask differs from create_occupancy_mask on the CPU in "
                 f"{int((cpu_mask != mask).sum())} voxels")
        sel = np.random.default_rng(1).choice(len(flat), n_check, replace=False)
        cpu_field = load_field_adapter(nerf_out, device="cpu")
        q = cpu_field.query(flat[sel])
        f16, a16, _ = pack_rows(q["density"], q["feature"], torch.zeros((n_check, 3)),
                                np.float32(h), vc.alpha_weighted)
        keep = alphas.reshape(-1)[sel].astype(np.float32) > vc.alpha_threshold_for_mask
        want = np.where(keep[:, None], f16.numpy(), np.float16(0.0))
        bad = _fp16_within_ulp(feats.reshape(-1, fc)[sel], want)
        bad_alpha = _fp16_within_ulp(alphas.reshape(-1)[sel], a16.numpy()[:, 0])
        print(f"voxelize: device grid == npy bitwise; mask == CPU mask bit for bit; "
              f"{n_check} seeded voxels ({int(keep.sum())} over the threshold): "
              f"{bad} features and {bad_alpha} alphas beyond a float16 ulp of the CPU field",
              flush=True)
        if bad or bad_alpha:
            fail("the voxelizer's features or alphas disagree with the CPU field")
        del vox, feats

        # 4. an f3rm checkpoint through TcnnFieldAdapter
        ckpt = root / "step-0.ckpt"
        _write_f3rm_ckpt(ckpt, seed=3)
        t0 = time.time()
        fields = tc.load_f3rm_checkpoint(ckpt)
        load_s = time.time() - t0
        if set(fields) != {"feature_field", "mlp_base", "mlp_head", "appearance"}:
            fail(f"load_f3rm_checkpoint found {sorted(fields)}")
        adapter = tc.TcnnFieldAdapter(fields, device=dev)
        out = torch.empty((len(flat), tc.F3RM_MLP.out_dim), device=dev)
        torch.cuda.synchronize()
        t0 = time.time()
        for i in range(0, len(flat), vc.batch_size):
            out[i:i + vc.batch_size] = adapter.query(flat[i:i + vc.batch_size])["feature"]
        torch.cuda.synchronize()
        query_s = time.time() - t0
        want = tc.TcnnFieldAdapter(tc.load_f3rm_checkpoint(ckpt), device="cpu").query(
            flat[sel])["feature"].numpy()
        got = out[torch.as_tensor(sel, device=dev)].cpu().numpy()
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"f3rm: step-0.ckpt loaded in {load_s:.2f} s; {d}^3 grid queried in batches of "
              f"{vc.batch_size} in {query_s:.3f} s, features {tuple(out.shape)}; {n_check} "
              f"points: max_abs_err {err:.3e} against the CPU (max |value| {scale:.3e}, tol "
              f"{F3RM_RTOL * scale:.3e})", flush=True)
        if tuple(out.shape) != (d ** 3, 768) or not bool(torch.isfinite(out).all()):
            fail(f"f3rm grid features {tuple(out.shape)} not (d^3, 768) or not finite")
        if not err <= F3RM_RTOL * scale:
            fail("the f3rm field on the card disagrees with the CPU")
    print(f"voxelize: phase 7 in {time.time() - t_phase:.1f} s", flush=True)
    return launches


def _clip_snapshot(path: Path, dev, seed: int = 0) -> None:
    """A seeded ViT-L/14-336 CLIPVisionModel snapshot in ``path``:
    config.json and model.safetensors under HF's keys, at HF's initial
    scales (CLIPPreTrainedModel._init_weights), written from the card."""
    import numpy as np
    import torch

    from pixie_tpu_torch.recon.clip_tower import CLIPVisionConfig

    c = CLIPVisionConfig.vit_l_14_336()
    hid, n_layers, p = c.hidden_size, c.num_hidden_layers, c.patch_size
    in_std, out_std, fc_std = hid ** -0.5 * (2 * n_layers) ** -0.5, hid ** -0.5, (2 * hid) ** -0.5
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"vision_model.embeddings.class_embedding": ((hid,), hid ** -0.5),
              "vision_model.embeddings.patch_embedding.weight": ((hid, 3, p, p), 0.02),
              "vision_model.embeddings.position_embedding.weight":
                  ((1 + (c.image_size // p) ** 2, hid), 0.02)}
    for name in ("pre_layrnorm", "post_layernorm"):
        shapes[f"vision_model.{name}.weight"] = ((hid,), None)
        shapes[f"vision_model.{name}.bias"] = ((hid,), 0.0)
    for i in range(n_layers):
        lp = f"vision_model.encoder.layers.{i}."
        for n, std in (("q", in_std), ("k", in_std), ("v", in_std), ("out", out_std)):
            shapes[f"{lp}self_attn.{n}_proj.weight"] = ((hid, hid), std)
            shapes[f"{lp}self_attn.{n}_proj.bias"] = ((hid,), 0.0)
        for n in ("layer_norm1", "layer_norm2"):
            shapes[f"{lp}{n}.weight"] = ((hid,), None)
            shapes[f"{lp}{n}.bias"] = ((hid,), 0.0)
        shapes[f"{lp}mlp.fc1.weight"] = ((c.intermediate_size, hid), fc_std)
        shapes[f"{lp}mlp.fc1.bias"] = ((c.intermediate_size,), 0.0)
        shapes[f"{lp}mlp.fc2.weight"] = ((hid, c.intermediate_size), in_std)
        shapes[f"{lp}mlp.fc2.bias"] = ((hid,), 0.0)
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps({
        "architectures": ["CLIPVisionModel"], "model_type": "clip_vision_model",
        "hidden_size": hid, "intermediate_size": c.intermediate_size,
        "num_hidden_layers": n_layers, "num_attention_heads": c.num_attention_heads,
        "patch_size": p, "image_size": c.image_size, "layer_norm_eps": c.layer_norm_eps,
        "hidden_act": "quick_gelu", "num_channels": 3}))
    header, offset = {}, 0
    for name, (shape, _) in shapes.items():
        n = 4 * int(np.prod(shape))
        header[name] = {"dtype": "F32", "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    with open(path / "model.safetensors", "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob)
        for shape, std in shapes.values():
            if std is None:
                t = torch.ones(shape, device=dev)
            else:
                t = torch.randn(shape, generator=gen, device=dev) * std
            f.write(t.cpu().numpy().astype("<f4").tobytes())


def phase_field(dev, capture: Path, iters: int = FIELD_ITERS,
                window: tuple[int, int] = FIELD_PROFILE) -> dict:
    """CLIP extraction at full width, then field training through
    pipeline.train_nerf on ``capture`` and generate_voxels on its
    checkpoint; returns the path's kernel launches (it runs none of the
    port's kernels)."""
    import os

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.config import compose
    from pixie_tpu_torch.recon.clip_features import CLIPArgs, extract_clip_features

    t_phase = time.time()
    vc, t3 = compose().voxelization, compose().training_3d
    views = sorted(capture.glob("*.png"))
    with tempfile.TemporaryDirectory(prefix="pixie_smoke_field_") as tmp:
        root = Path(tmp)
        hub = root / "hub"
        t0 = time.time()
        _clip_snapshot(hub / ("models--" + CLIPArgs.model_name.replace("/", "--")) / "snapshots"
                       / "seeded", dev)
        os.environ["HF_HUB_CACHE"] = str(hub)
        print(f"field: seeded ViT-L/14-336 snapshot written in {time.time() - t0:.2f} s",
              flush=True)

        # 1. CLIP features, bfloat16 (the default) and float32
        secs = {}
        for name, dtype in (("bfloat16", torch.bfloat16), ("float32", None)):
            torch.cuda.synchronize()
            t0 = time.time()
            feats = extract_clip_features(views, device=dev, dtype=dtype)
            secs[name] = (time.time() - t0, feats)
        (bf_s, bf), (f32_s, f32) = secs["bfloat16"], secs["float32"]
        err = float(np.abs(bf.astype(np.float32) - f32.astype(np.float32)).max())
        scale = float(np.abs(f32.astype(np.float32)).max())
        print(f"field: CLIP features {bf.shape} {bf.dtype} from {len(views)} views: bfloat16 "
              f"{bf_s:.2f} s, float32 {f32_s:.2f} s (each with the weights' load); bfloat16 vs "
              f"float32 max_abs_err {err:.4e} of max |value| {scale:.4e} (tol "
              f"{CLIP_BF16_RTOL * scale:.4e}), mean |diff| "
              f"{float(np.abs(bf.astype(np.float32) - f32.astype(np.float32)).mean()):.4e}",
              flush=True)
        want = (len(views), 24, 24, 1024)
        if bf.shape != want or not np.isfinite(f32).all() or not np.isfinite(bf).all():
            fail(f"CLIP features {bf.shape} not {want} or not finite")
        if not err <= CLIP_BF16_RTOL * scale:
            fail("the bfloat16 CLIP tower disagrees with the float32 one")
        del bf, f32, secs

        # 2. field training through the pipeline's stage
        nerf_out = root / "f3rm"
        steps = []
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

        def on_step(it, loss):
            torch.cuda.synchronize()
            steps.append((it, time.perf_counter(), float(loss)))
            if it == window[0] - 1:
                prof.start()
            elif it == window[1] - 1:
                prof.stop()

        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        fields = pipeline.train_nerf(capture, nerf_out, training_3d={
            "nerf_max_num_iterations": iters}, device=dev, on_step=on_step)
        torch.cuda.synchronize()
        os.environ.pop("HF_HUB_CACHE")
        t_end = time.perf_counter()
        wall = time.time() - t0
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        metrics = json.loads((nerf_out / "metrics.json").read_text())
        meta = json.loads((nerf_out / "checkpoints" / "field_meta.json").read_text())
        ms = [1e3 * (b[1] - a[1]) for a, b in zip(steps, steps[1:]) if a[0] >= 10]
        events = prof.events()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        n_launch = sum(1 for e in events if e.name in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"))
        n_win = window[1] - window[0]
        dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_win
        by_name, n_by_name = collections.Counter(), collections.Counter()
        for e in kernels:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n_win
            n_by_name[e.name] += 1 / n_win
        med = statistics.median(ms)
        losses = [x[2] for x in steps]
        print(f"field: pipeline.train_nerf {wall:.1f} s for {iters} of "
              f"{t3.nerf_max_num_iterations} iterations ({t3.nerf_rays_per_batch} rays, "
              f"{t3.nerf_n_coarse} + {t3.nerf_n_fine} samples; the CLIP extraction into "
              f"clip_patch_features.npy, the training, the checkpoint and the held-out "
              f"views); median {med:.2f} ms/step over steps 10..{iters} (synchronized), p10 "
              f"{np.percentile(ms, 10):.2f}, p90 {np.percentile(ms, 90):.2f}; steps "
              f"{window[0]}..{window[1] - 1} profiled: {n_launch / n_win:.1f} kernel launches, "
              f"{len(kernels) / n_win:.1f} device kernels, device time {dev_ms:.3f} ms a step, "
              f"device idle {1.0 - dev_ms / med:.3f} of the median step; peak device memory "
              f"{peak:.2f} GiB", flush=True)
        for name, t in by_name.most_common(10):
            print(f"field:   {t:8.3f} ms a step, {n_by_name[name]:6.1f} launches: {name[:100]}")
        print(f"field: loss {losses[0]:.5f} at step 0, {losses[-1]:.5f} at step {iters - 1}; "
              f"train_s {metrics['train_s']:.2f}; held-out PSNR {metrics['psnr_per_view']} dB "
              f"(mean {metrics['psnr_mean']:.3f}); eval + save {t_end - steps[-1][1]:.2f} s; "
              f"meta {meta}; launches {launches}", flush=True)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail("field training loss did not fall or went non-finite")
        if set(fields) != {"nerf", "feat", "prop"} or meta["feature_dim"] != 1024 or not \
                meta["with_features"]:
            fail(f"train_nerf trained {sorted(fields)} with meta {meta}, not the distilled "
                 f"1024-wide feature field")
        if not np.isfinite(metrics["psnr_mean"]):
            fail("non-finite held-out PSNR")
        del fields

        # 3. the voxelizer on the new checkpoint
        torch.cuda.synchronize()
        t0 = time.time()
        vox = pipeline.generate_voxels(nerf_out, root / "render", grid_size=64,
                                       batch_size=vc.batch_size, device=dev)
        torch.cuda.synchronize()
        vox_s = time.time() - t0
        grid = vox["features_dev"]
        timings = vox.pop("wait")()
        mask = np.load(vox["mask"]) > 0.5
        print(f"field: generate_voxels on the trained field.pth {vox_s:.2f} s, grid "
              f"{tuple(grid.shape)} {grid.dtype}, {int(mask.sum())} occupied voxels of 64^3; "
              f"timings { {k: round(v, 4) for k, v in timings.items()} }", flush=True)
        if tuple(grid.shape) != (64, 64, 64, 1024) or not bool(torch.isfinite(grid).all()):
            fail(f"the voxel grid {tuple(grid.shape)} is not 64^3 x 1024 or not finite")
        del vox, grid
        print(f"field: nvidia-smi {_smi()}", flush=True)
    print(f"field: phase 8 in {time.time() - t_phase:.1f} s", flush=True)
    return launches


def main() -> int:
    phase_device()
    import torch

    sys.path.insert(0, str(HERE))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kern = phase_kernels(dev)
    kern["fused_substep"] = phase_fused(dev)
    phase_profile(dev)
    kern["gs_blend"] = phase_blend(dev)
    kern["gs_blend_backward"] = phase_blend_backward(dev)
    # what training's launches of B3 run: tile_cap 1024, keeping the state
    kern["gs_blend"]["training_ms"] = kern["gs_blend_backward"].pop("forward_ms")
    probe_rows, probe_launches = phase_probes(dev, kern["p2g"]["cases"]["P1 state"]["device_ms"])
    kern.update(probe_rows)
    with tempfile.TemporaryDirectory(prefix="pixie_smoke_train_") as tmp:
        paths = {"probes": probe_launches, "train": phase_train(dev, Path(tmp))}
        paths.update(phase_slice(dev, gs_dir=Path(tmp) / "gs"))
        paths["field"] = phase_field(dev, Path(tmp) / "capture")
    paths["voxelize"] = phase_voxelize(dev)
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
            ("gs_blend_backward", "gs_stream.cu", "pixie_tpu/ops/gs_stream.py:252"),
            ("fused_substep", "fused_substep.cu", "pixie_tpu/ops/fused_substep.py:266"),
            *((name, "probe_ablation.cu", "scripts/probe_kernel_ablation.py:112")
              for name in PROBE_P2G),
            *((name, "gather.cu", "scripts/probe_vmem_gather.py:48") for name in GATHERS)):
        rows.append({"name": name, "route": "cuda", "source": f"pixie_tpu_torch/csrc/{src}",
                     "replaces": replaces, "launches": launches[name], **kern[name]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
