"""Simulation driver: material point cloud or 3DGS checkpoint -> MPM rollout
-> frame exports (port of pixie_tpu/sim/driver.py).

Point-cloud mode: the material PLY's vertices are the particles
(gs_simulation.py:108).  GS mode (``gaussian_checkpoint``): the particles
are the checkpoint's opacity-filtered gaussians, their covariances ride
along, and the whole material PLY maps onto them by kNN smoothing; with
``render_img`` every frame is rasterized through the tile splat rasterizer.

Setup (rotations, sim-area crop, transform into the MPM cube, material
field and automatic BCs, JSON BCs), then per frame: export or render the
current state, then step.  Writes ``sim_info.json`` and, with ``debug``,
``boundary_conditions.json`` — the same artifacts as the JAX driver.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.recon.gaussians import (
    covariance_upper, get_opacity, get_shs, load_gaussian_ply,
)
from pixie_tpu_torch.recon.train_gaussians import search_for_max_iteration
from pixie_tpu_torch.sim import material_field as mf
from pixie_tpu_torch.sim import transforms as tf
from pixie_tpu_torch.sim.bc import build_boundary_conditions
from pixie_tpu_torch.sim.engine_utils import load_rollout_checkpoint, save_rollout_checkpoint
from pixie_tpu_torch.sim.filling import fill_particles, get_particle_volume
from pixie_tpu_torch.sim.params import decode_param_json
from pixie_tpu_torch.sim.render_sim import SimRenderer, save_frame_png
from pixie_tpu_torch.sim.solver import MPMSolver, compute_cov_from_F
from pixie_tpu_torch.utils import observability as obs
from pixie_tpu_torch.utils import viz
from pixie_tpu_torch.utils.io import load_material_ply, make_material_vertex, write_ply


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
    fused: bool | None = None,
) -> dict:
    """End-to-end rollout; returns timing/diagnostic info.

    ``gaussian_checkpoint`` (a 3DGS model dir or point_cloud.ply) selects
    GS mode; ``render_img`` (which needs it) writes ``frames/%05d.png`` and
    gaussian-format ``ply_files/frame_%05d.ply`` per frame, and
    ``compile_video`` turns the frames into ``frames/output.mp4``.

    ``median_frame_s`` times the substeps of a frame alone, synchronized
    (so it compares across modes); ``median_render_ms`` times the
    render, PNG and PLY of a frame, synchronized.  The JAX driver's frame
    times also include the render fetch it overlaps with the substeps.

    ``use_fast_solver`` is accepted for signature parity: both values run
    the one solver of this package, whose transfers are the CUDA kernels on
    a CUDA device.  ``fused`` (None reads ``PIXIE_FUSED``, default off)
    runs each frame that no particle BC touches as a fused-substep frame
    (``MPMSolver``); ``fused_frames`` in the info lists those frames,
    ``frame_s`` every frame's substep time, and ``scale_origin`` the factor
    from world lengths to MPM lengths.

    ``checkpoint_every`` > 0 snapshots the solver state to
    ``rollout_ckpt.npz`` every that-many frames (atomic write, the JAX
    package's npz schema); with ``resume=True`` an existing snapshot
    restores the rollout and the frames already exported are skipped.  A
    config's ``particle_filling`` (GS mode) adds filled particles after the
    gaussians, with zero covariance; they are simulated, not rendered.
    """
    if render_img and gaussian_checkpoint is None:
        raise ValueError("render_img requires gaussian_checkpoint")
    device = torch.device(device)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    decoded = decode_param_json(config_path)
    time_params, camera_params = decoded[2], decoded[4]
    gaussians = None if gaussian_checkpoint is None else load_gaussians(gaussian_checkpoint)
    sim = setup_simulation(load_material_ply(point_cloud_path), decoded, gaussians,
                           particle_volume=particle_volume, device=device, fused=fused)
    logging.info("Loaded %d particles from %s", sim.n_particles,
                 gaussian_checkpoint or point_cloud_path)
    solver, conf, auto_bcs, gs_payload = sim.solver, sim.conf, sim.auto_bcs, sim.gs_payload
    n, z_shift, rotation_matrices = sim.n_particles, sim.z_shift, sim.rotation_matrices
    scale_origin, original_mean_pos = sim.scale_origin, sim.original_mean_pos
    if debug:
        (output_dir / "boundary_conditions.json").write_text(json.dumps(auto_bcs, indent=2))

    substep_dt, steps_per_frame = sim.substep_dt, sim.steps_per_frame
    frame_dt = time_params["frame_dt"]
    frame_num = int(n_frames if n_frames is not None else time_params["frame_num"])

    ply_dir = output_dir / "ply_files"
    if save_ply:
        ply_dir.mkdir(exist_ok=True)
    renderer = None
    frames_dir = output_dir / "frames"
    if render_img:
        renderer = SimRenderer.from_camera_params(
            camera_params, gaussian_checkpoint, frame_num,
            shs=gs_payload["shs"], opacity_act=gs_payload["opacity"],
            scale_origin=scale_origin, original_mean_pos=original_mean_pos,
            rotation_matrices=rotation_matrices, z_shift=z_shift,
            unselected=gs_payload["unselected"], white_bg=white_bg, device=device)
        frames_dir.mkdir(exist_ok=True)
        gs_num = gs_payload["gs_num"]

    ckpt_path = output_dir / "rollout_ckpt.npz"
    start_frame = 0
    if resume and ckpt_path.exists():
        ck_state, ck_time, start_frame = load_rollout_checkpoint(ckpt_path, device=device)
        if ck_state.n_particles != solver.state.n_particles:
            raise ValueError(f"rollout checkpoint particle count {ck_state.n_particles} "
                             f"!= scene particle count {solver.state.n_particles}")
        solver.state, solver.time = ck_state, ck_time
        logging.info("resuming rollout from frame %d (t=%.4f)", start_frame, ck_time)

    frame_times, render_times, fused_frames = [], [], []
    for frame in range(start_frame, frame_num):
        # render/export the CURRENT state, then step (gs_simulation.py:573-637)
        if renderer is not None:
            _sync(device)
            r0 = time.time()
            cov6 = _export_cov(solver)
            img8, (pos_w, cov_w) = renderer.render_frame(
                frame, solver.state.x[:gs_num], cov6[:gs_num])
            save_frame_png(frames_dir / f"{frame:05d}.png", img8)
            if save_ply:
                renderer.export_gaussian_ply(ply_dir / f"frame_{frame:05d}.ply",
                                             pos_w.cpu().numpy(), cov_w)
            render_times.append(time.time() - r0)
        elif save_ply:
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
        if solver.step_frame(steps_per_frame, substep_dt):
            fused_frames.append(frame)
        _sync(device)
        frame_times.append(time.time() - t0)
        if checkpoint_every and (frame + 1) % checkpoint_every == 0:
            save_rollout_checkpoint(ckpt_path, solver.state, solver.time, frame + 1)
        if frame % 10 == 0:
            logging.info("frame %d/%d: %.1fms (%d substeps)", frame, frame_num,
                         frame_times[-1] * 1e3, steps_per_frame)

    if renderer is not None and compile_video and frame_num:
        viz.compile_video(frames_dir, frames_dir / "output.mp4", fps=max(int(round(1.0 / frame_dt)), 1))

    info = {
        "n_particles": n,
        "n_filled": n - gs_payload["gs_num"] if gs_payload else 0,
        "frames": frame_num,
        "substeps_per_frame": steps_per_frame,
        "median_frame_s": float(np.median(frame_times)) if frame_times else None,
        "median_render_ms": float(np.median(render_times)) * 1e3 if render_times else None,
        "frame_s": frame_times,
        "fused_frames": fused_frames,
        "scale_origin": float(scale_origin),
        "active_materials": list(solver.cfg.active_materials),
        "solver": "torch-cuda-kernels" if device.type == "cuda" else "torch-plain",
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "final_state_finite": bool(torch.isfinite(solver.state.x).all()),
        "auto_bcs": auto_bcs,
    }
    (output_dir / "sim_info.json").write_text(json.dumps(info, indent=2))
    return info



@dataclasses.dataclass
class SimSetup:
    """What ``setup_simulation`` hands the frame loop: the solver ready to
    step, the frame's substeps and their dt, and what the exports need."""

    solver: MPMSolver
    steps_per_frame: int
    substep_dt: float
    n_particles: int
    conf: np.ndarray                 # the material field's per-particle confidence
    auto_bcs: list                   # the material field's BC dicts (ground, stationary)
    scale_origin: float
    original_mean_pos: np.ndarray
    rotation_matrices: list
    z_shift: float
    gs_payload: dict | None          # GS mode: shs, opacity, unselected, gs_num


def setup_simulation(params: dict, decoded: tuple, gaussians: dict | None = None,
                     particle_volume: float | None = None,
                     device: str | torch.device = "cuda",
                     fused: bool | None = None) -> SimSetup:
    """``run_simulation``'s set-up from inputs already in memory.

    ``params``: the material source in ``load_material_ply``'s schema;
    ``decoded``: ``decode_params``' five groups of the class config;
    ``gaussians``: a 3DGS model in ``load_gaussian_ply``'s schema (GS mode),
    or None (point-cloud mode: the material source's vertices are the
    particles).  Rotations, crop, the transform into the MPM cube, particle
    volumes and the solver's parameters (the span ``sim.setup.particles``),
    then the material field: kNN smoothing, the ground and stationary
    cuboids (``sim.setup.material_field``), then the config's BCs.  A
    config's ``particle_filling`` runs inside ``sim.setup.particles`` as the
    span ``sim.setup.filling`` (GS mode).  While a
    tracer is on, the counters ``sim.materials.<id>`` hold the particles of
    each material id."""
    device = torch.device(device)
    material_params, bc_params, time_params, preprocessing_params, _ = decoded
    z_shift = preprocessing_params.get("z_shift_value", 0.0)
    rotation_matrices = tf.generate_rotation_matrices(
        preprocessing_params.get("rotation_degree", []) or [],
        preprocessing_params.get("rotation_axis", []) or [],
    )
    with obs.span("sim.setup.particles"):
        gs_payload = init_cov_mpm = None
        if gaussians is not None:
            (init_cov_mpm, gs_payload, scale_origin, original_mean_pos,
             pos_mpm) = _prepare_gaussian_particles(gaussians, preprocessing_params,
                                                    material_params, rotation_matrices, device)
            sub_params = dict(params)  # the whole PLY is the material source
        else:
            pos = tf.apply_rotations(params["pos"].astype(np.float32), rotation_matrices)
            n0 = len(pos)
            keep = np.ones(n0, bool)
            sim_area = preprocessing_params.get("sim_area")
            if sim_area is not None:
                bounds = np.asarray(sim_area, np.float32).reshape(3, 2)
                keep = np.all((pos >= bounds[:, 0]) & (pos <= bounds[:, 1]), axis=1)
                pos = pos[keep]
                logging.info("sim_area crop: %d -> %d particles", n0, len(pos))
            pos_norm, scale_origin, original_mean_pos = tf.transform2origin(pos)
            pos_mpm = tf.shift2center111(pos_norm, z_shift)
            sub_params = {k: (np.asarray(v)[keep] if np.asarray(v).shape[:1] == (n0,) else v)
                          for k, v in params.items()}
            sub_params["pos"] = pos  # original-frame positions (identity kNN)
        n = len(pos_mpm)

        if gaussians is not None and particle_volume is None:
            # per-cell volume split; uniform for sand (gs_simulation.py:466-470)
            vols = get_particle_volume(
                pos_mpm, material_params["n_grid"],
                material_params["grid_lim"] / material_params["n_grid"],
                uniform=material_params.get("material") == "sand")
        else:
            if particle_volume is None:
                particle_volume = 1.0 / max(n, 1)  # uniform estimate, unit cube
            vols = np.full(n, particle_volume, np.float32)

        solver = MPMSolver(device=device, fused=fused)
        solver.load_initial_data(pos_mpm, vols, cov=init_cov_mpm,
                                 n_grid=material_params["n_grid"],
                                 grid_lim=material_params["grid_lim"])
        g = material_params["g"]
        if np.isscalar(g):
            g = [0.0, 0.0, -abs(float(g))]
        setup = {k: v for k, v in material_params.items() if k not in ("n_grid", "grid_lim")}
        setup["g"] = g
        solver.set_parameters_dict(setup)

    with obs.span("sim.setup.material_field"):
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
    if obs.enabled():
        ids, counts = torch.unique(solver.state.material, return_counts=True)
        for i, c in zip(ids.tolist(), counts.tolist()):
            obs.count(f"sim.materials.{i}", c)
    solver.bcs.extend(build_boundary_conditions(bc_params, time_params, pos_mpm,
                                                device=device))
    substep_dt = time_params["substep_dt"]
    steps_per_frame = max(int(round(time_params["frame_dt"] / substep_dt)), 1)
    return SimSetup(solver, steps_per_frame, substep_dt, n, conf, auto_bcs, scale_origin,
                    original_mean_pos, rotation_matrices, z_shift, gs_payload)


def _export_cov(solver: MPMSolver) -> torch.Tensor:
    """Current per-particle covariances on the device
    (export_particle_cov_to_torch, mpm_solver_warp.py:715-741): transported
    from F unless the per-substep cov update is on."""
    if solver.cfg.update_cov_with_F:
        return solver.state.cov
    return compute_cov_from_F(solver.state)


def load_gaussians(gaussian_checkpoint) -> dict:
    """A 3DGS model dir (its latest ``point_cloud/iteration_*``) or a
    point_cloud.ply -> the gaussians in ``load_gaussian_ply``'s schema."""
    path = Path(gaussian_checkpoint)
    if path.is_dir():
        pc_dir = path / "point_cloud"
        path = pc_dir / f"iteration_{search_for_max_iteration(pc_dir)}" / "point_cloud.ply"
    return load_gaussian_ply(path)


def _prepare_gaussian_particles(gs, preprocessing_params, material_params, rotation_matrices,
                                device):
    """3DGS model (``load_gaussian_ply``'s schema) -> simulation particles,
    reference order (gs_simulation.py:402-482): opacity filter -> rotations
    -> sim_area crop (crop-excluded gaussians kept for static rendering) ->
    transform2origin + shift2center111 -> MPM-frame covariances
    (apply_cov_rotations * scale_origin**2) -> optional internal particle
    filling, its scans on ``device``, the span ``sim.setup.filling`` (filled
    particles follow the ``gs_num`` gaussians with zero covariance and are
    not rendered).

    Returns (init_cov_mpm, gs_payload, scale_origin, original_mean_pos, pos_mpm).
    """
    opacity = get_opacity(gs).numpy()                # activated (N,1)
    keep = opacity[:, 0] > preprocessing_params["opacity_threshold"]
    init_pos = gs["xyz"].numpy()[keep]
    cov_w = covariance_upper(gs).numpy()[keep]
    init_opacity = opacity[keep]
    init_shs = get_shs(gs).numpy()[keep]
    logging.info("opacity filter: %d -> %d gaussians", len(opacity), len(init_pos))

    rotated_pos = tf.apply_rotations(init_pos, rotation_matrices)
    unselected = None
    sim_area = preprocessing_params.get("sim_area")
    if sim_area is not None:
        bounds = np.asarray(sim_area, np.float32).reshape(3, 2)
        m = np.all((rotated_pos >= bounds[:, 0]) & (rotated_pos <= bounds[:, 1]), axis=1)
        unselected = {"pos": init_pos[~m], "cov6": cov_w[~m],
                      "opacity": init_opacity[~m], "shs": init_shs[~m]}
        rotated_pos = rotated_pos[m]
        cov_w, init_opacity, init_shs = cov_w[m], init_opacity[m], init_shs[m]
        logging.info("sim_area crop: %d sim + %d static gaussians",
                     len(rotated_pos), len(unselected["pos"]))

    pos_norm, scale_origin, original_mean_pos = tf.transform2origin(rotated_pos)
    pos_mpm = tf.shift2center111(pos_norm, preprocessing_params.get("z_shift_value", 0.0))
    init_cov_mpm = (tf.apply_cov_rotations(cov_w, rotation_matrices)
                    * scale_origin ** 2).astype(np.float32)
    gs_num = len(pos_mpm)
    filling = preprocessing_params.get("particle_filling")
    if filling:
        # the JAX driver's keys (pixie_tpu/sim/driver.py:403-421), the
        # reference's spelling of max_partciels_per_cell included
        with obs.span("sim.setup.filling"):
            new_mpm = fill_particles(
                pos_mpm, init_opacity[:, 0], init_cov_mpm,
                grid_n=filling["n_grid"], max_samples=filling["max_particles_num"],
                grid_dx=material_params["grid_lim"] / filling["n_grid"],
                density_thres=filling["density_threshold"],
                search_thres=filling["search_threshold"],
                max_particles_per_cell=filling["max_partciels_per_cell"],
                search_exclude_dir=filling["search_exclude_direction"],
                ray_cast_dir=filling["ray_cast_direction"],
                boundary=filling["boundary"], device=device)
        if len(new_mpm):
            pos_mpm = np.concatenate([pos_mpm, new_mpm])
            logging.info("particle filling added %d particles", len(new_mpm))
    init_cov_full = np.zeros((len(pos_mpm), 6), np.float32)
    init_cov_full[:gs_num] = init_cov_mpm
    gs_payload = {"shs": init_shs, "opacity": init_opacity, "unselected": unselected,
                  "gs_num": gs_num}
    return init_cov_full, gs_payload, scale_origin, original_mean_pos, pos_mpm
