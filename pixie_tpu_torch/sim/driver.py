"""Simulation driver: material point cloud -> MPM rollout -> frame exports
(port of pixie_tpu/sim/driver.py, point-cloud mode).

The material PLY's vertices are the particles (gs_simulation.py:108):
rotations and sim-area crop, transform into the MPM cube, material field and
automatic BCs, JSON BCs, then per frame: export the current state as
``ply_files/frame_%04d.ply`` in world coordinates and step.  Writes
``sim_info.json`` and, with ``debug``, ``boundary_conditions.json`` — the
same artifacts as the JAX driver.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.sim import material_field as mf
from pixie_tpu_torch.sim import transforms as tf
from pixie_tpu_torch.sim.bc import build_boundary_conditions
from pixie_tpu_torch.sim.params import decode_param_json
from pixie_tpu_torch.sim.solver import MPMSolver
from pixie_tpu_torch.utils.io import load_material_ply, make_material_vertex, write_ply

_NEXT_SLICE = ("ROADMAP.md 'Next slices' (a): GS-checkpoint particles and the "
               "per-frame splat render")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_simulation(
    point_cloud_path: str | Path,
    config_path: str | Path,
    output_dir: str | Path,
    n_frames: int | None = None,
    save_ply: bool = True,
    particle_volume: float | None = None,
    debug: bool = False,
    use_fast_solver: bool = True,
    gaussian_checkpoint: str | Path | None = None,
    render_img: bool = False,
    compile_video: bool = False,
    white_bg: bool = False,
    checkpoint_every: int = 0,
    resume: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """End-to-end rollout in point-cloud mode; returns timing/diagnostic info.

    ``use_fast_solver`` is accepted for signature parity: both values run
    the one solver of this package, whose transfers are the CUDA kernels on
    a CUDA device.  ``gaussian_checkpoint``/``render_img``/``compile_video``
    and rollout checkpointing (``checkpoint_every``/``resume``) are not in
    this port yet and raise ``NotImplementedError``.
    """
    if gaussian_checkpoint is not None or render_img or compile_video:
        raise NotImplementedError(f"not ported yet: {_NEXT_SLICE}")
    if checkpoint_every or resume:
        raise NotImplementedError("rollout checkpoint/resume is not ported yet")
    device = torch.device(device)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    (material_params, bc_params, time_params, preprocessing_params,
     _camera_params) = decode_param_json(config_path)

    params = load_material_ply(point_cloud_path)
    z_shift = preprocessing_params.get("z_shift_value", 0.0)
    rotation_matrices = tf.generate_rotation_matrices(
        preprocessing_params.get("rotation_degree", []) or [],
        preprocessing_params.get("rotation_axis", []) or [],
    )
    pos = params["pos"].astype(np.float32)
    n0 = len(pos)
    pos = tf.apply_rotations(pos, rotation_matrices)
    keep = np.ones(len(pos), bool)
    sim_area = preprocessing_params.get("sim_area")
    if sim_area is not None:
        bounds = np.asarray(sim_area, np.float32).reshape(3, 2)
        keep = np.all((pos >= bounds[:, 0]) & (pos <= bounds[:, 1]), axis=1)
        pos = pos[keep]
        logging.info("sim_area crop: %d -> %d particles", n0, len(pos))
    pos_norm, scale_origin, original_mean_pos = tf.transform2origin(pos)
    pos_mpm = tf.shift2center111(pos_norm, z_shift)
    n = len(pos_mpm)
    logging.info("Loaded %d particles from %s", n, point_cloud_path)

    if particle_volume is None:
        particle_volume = 1.0 / max(n, 1)  # uniform estimate, unit cube
    vols = np.full(n, particle_volume, np.float32)

    solver = MPMSolver(device=device)
    solver.load_initial_data(pos_mpm, vols, n_grid=material_params["n_grid"],
                             grid_lim=material_params["grid_lim"])
    g = material_params["g"]
    if np.isscalar(g):
        g = [0.0, 0.0, -abs(float(g))]
    setup = {k: v for k, v in material_params.items() if k not in ("n_grid", "grid_lim")}
    setup["g"] = g
    solver.set_parameters_dict(setup)

    sub_params = {k: (np.asarray(v)[keep] if np.asarray(v).shape[:1] == (n0,) else v)
                  for k, v in params.items()}
    sub_params["pos"] = pos
    mpm_world = tf.apply_inverse_rotations(
        tf.undotransform2origin(tf.undoshift2center111(pos_mpm, z_shift),
                                scale_origin, original_mean_pos),
        rotation_matrices)
    conf, auto_bcs = mf.apply_material_field_to_simulation(
        solver, sub_params, mpm_positions_world=mpm_world,
        only_handle_largest_cluster=preprocessing_params["only_handle_largest_cluster"],
        fix_ground=preprocessing_params["fix_ground"],
        k_smoothing_neighbors=preprocessing_params["k_smoothing_neighbors"],
        nn_distance_threshold=preprocessing_params["nn_distance_threshold"],
    )
    solver.bcs.extend(build_boundary_conditions(bc_params, time_params, pos_mpm,
                                                device=device))
    if debug:
        (output_dir / "boundary_conditions.json").write_text(json.dumps(auto_bcs, indent=2))

    substep_dt = time_params["substep_dt"]
    frame_dt = time_params["frame_dt"]
    frame_num = int(n_frames if n_frames is not None else time_params["frame_num"])
    steps_per_frame = max(int(round(frame_dt / substep_dt)), 1)

    ply_dir = output_dir / "ply_files"
    if save_ply:
        ply_dir.mkdir(exist_ok=True)

    frame_times = []
    for frame in range(frame_num):
        # export the CURRENT state, then step (gs_simulation.py:573-637)
        if save_ply:
            st = solver.state
            x_world = tf.apply_inverse_rotations(
                tf.undotransform2origin(
                    tf.undoshift2center111(st.x.cpu().numpy(), z_shift),
                    scale_origin, original_mean_pos),
                rotation_matrices)
            write_ply(ply_dir / f"frame_{frame:04d}.ply", make_material_vertex(
                coords=x_world, density=st.density.cpu().numpy(),
                E=st.E.cpu().numpy(), nu=st.nu.cpu().numpy(),
                material_id=st.material.cpu().numpy(), conf=conf))
        _sync(device)
        t0 = time.time()
        solver.step_frame(steps_per_frame, substep_dt)
        _sync(device)
        frame_times.append(time.time() - t0)
        if frame % 10 == 0:
            logging.info("frame %d/%d: %.1fms (%d substeps)", frame, frame_num,
                         frame_times[-1] * 1e3, steps_per_frame)

    info = {
        "n_particles": n,
        "frames": frame_num,
        "substeps_per_frame": steps_per_frame,
        "median_frame_s": float(np.median(frame_times)) if frame_times else None,
        "substeps_per_sec": (steps_per_frame / float(np.median(frame_times))
                             if frame_times else None),
        "median_render_ms": None,
        "active_materials": list(solver.cfg.active_materials),
        "solver": "torch-cuda-kernels" if device.type == "cuda" else "torch-plain",
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "final_state_finite": bool(torch.isfinite(solver.state.x).all()),
        "auto_bcs": auto_bcs,
    }
    (output_dir / "sim_info.json").write_text(json.dumps(info, indent=2))
    return info
