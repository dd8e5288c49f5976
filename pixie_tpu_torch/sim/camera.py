"""Orbit-camera controls for simulation rendering.

Port of PhysGaussian utils/camera_view_utils.py (268 lines): spherical-orbit
camera around the MPM-space viewpoint center with per-frame azimuth /
elevation / radius / roll deltas (decode_param camera_params contract,
decode_param.py:213-273), producing world-space view matrices compatible
with the gaussian rasterizer.

Carried over unchanged from pixie_tpu/sim/camera.py (host numpy).
"""

from __future__ import annotations

import numpy as np


def generate_local_coord(vertical_axis: np.ndarray):
    """Orthonormal (vertical, h1, h2) frame from a world vertical axis
    (camera_view_utils.py:44-57 generate_local_coord, matched exactly so
    azimuth angles in the reference's sim configs keep their meaning:
    the [1,1,1] fallback fires when the dot is SMALL and h2 = h1 x v)."""
    v = np.asarray(vertical_axis, np.float64)
    v = v / np.linalg.norm(v)
    h1 = np.array([1.0, 1.0, 1.0])
    if abs(np.dot(h1, v)) < 0.01:
        h1 = np.array([0.72, 0.37, -0.67])
    h1 = h1 - np.dot(h1, v) * v
    h1 /= np.linalg.norm(h1)
    h2 = np.cross(h1, v)
    return v, h1, h2


def get_center_view_worldspace_and_observant_coordinate(
    mpm_space_viewpoint_center,
    mpm_space_vertical_upward_axis,
    rotation_matrices,
    scale_origin,
    original_mean_pos,
):
    """MPM-space viewpoint center + vertical -> world center and the
    (h1, h2, vertical) orbit basis (transformation_utils.py:143-166)."""
    from pixie_tpu_torch.sim import transforms as tf  # noqa: PLC0415

    center = np.asarray(mpm_space_viewpoint_center, np.float64).reshape(1, 3)
    vert = np.asarray(mpm_space_vertical_upward_axis, np.float64).reshape(1, 3)
    center_w = tf.undo_all_transforms(
        center, rotation_matrices, scale_origin, original_mean_pos)
    up_w = tf.undo_all_transforms(
        vert + center, rotation_matrices, scale_origin, original_mean_pos)
    vertical_w = (up_w - center_w).reshape(3)
    v, h1, h2 = generate_local_coord(vertical_w)
    observant_coordinates = np.column_stack((h1, h2, v))
    return center_w.reshape(3), observant_coordinates


def orbit_camera_position(center, observant_coordinates, azimuth_deg, elevation_deg,
                          radius):
    """Camera position on the orbit sphere in world space."""
    a = np.radians(azimuth_deg)
    e = np.radians(elevation_deg)
    h1, h2, vertical = (
        observant_coordinates[:, 0], observant_coordinates[:, 1],
        observant_coordinates[:, 2],
    )
    offset = radius * (
        np.cos(e) * (np.cos(a) * h1 + np.sin(a) * h2) + np.sin(e) * vertical
    )
    return np.asarray(center) + offset


def look_at_viewmat(cam_pos, target, up, roll_deg: float = 0.0) -> np.ndarray:
    """World->camera matrix, camera looking down +z (rasterizer convention)."""
    cam_pos = np.asarray(cam_pos, np.float64)
    fwd = np.asarray(target, np.float64) - cam_pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    dn = np.cross(fwd, right)
    if roll_deg:
        r = np.radians(roll_deg)
        right, dn = (
            np.cos(r) * right + np.sin(r) * dn,
            -np.sin(r) * right + np.cos(r) * dn,
        )
    rot = np.stack([right, dn, fwd], axis=0)
    t = -rot @ cam_pos
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = rot.astype(np.float32)
    view[:3, 3] = t.astype(np.float32)
    return view


def focal2fov(focal: float, pixels: float) -> float:
    """gaussian-splatting utils/graphics_utils.py focal2fov."""
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def load_cameras_json(model_path):
    """cameras.json next to a 3DGS checkpoint (get_camera_view,
    camera_view_utils.py:180-186); None when absent."""
    import json
    from pathlib import Path

    p = Path(model_path)
    cam_path = (p if p.is_dir() else p.parent) / "cameras.json"
    if not cam_path.exists():
        # checkpoints live in model_dir/point_cloud/iteration_N/; walk up
        for parent in (p if p.is_dir() else p.parent).parents:
            if (parent / "cameras.json").exists():
                cam_path = parent / "cameras.json"
                break
        else:
            return None
    return json.loads(cam_path.read_text())


def viewmat_from_camera_entry(entry: dict) -> np.ndarray:
    """cameras.json entry (camera-to-world rotation+position) -> 4x4
    world->camera matrix (camera_view_utils.py:244-250)."""
    c2w = np.eye(4)
    c2w[:3, :3] = np.asarray(entry["rotation"], np.float64)
    c2w[:3, 3] = np.asarray(entry["position"], np.float64)
    return np.linalg.inv(c2w).astype(np.float32)


def get_sim_camera_sequence(camera_params: dict, model_path,
                            viewpoint_center_worldspace,
                            observant_coordinates, n_frames: int,
                            default_res: int = 800, default_fov: float = 0.8):
    """Per-frame (world->camera) view matrices + intrinsics for the sim
    frame loop (get_camera_view, camera_view_utils.py:163-268).

    ``default_camera_index > -1`` uses that cameras.json camera verbatim for
    every frame; otherwise the spherical-orbit parameters drive the camera
    (optionally moving per frame).  Intrinsics come from cameras.json when
    available, else the synthetic (default_res, default_fov) fallback.

    Returns (viewmats: list[(4,4)], height, width, fovx, fovy).
    """
    cams = load_cameras_json(model_path) if model_path is not None else None
    if cams:
        raw = cams[max(int(camera_params.get("default_camera_index") or 0), 0)]
        width, height = int(raw["width"]), int(raw["height"])
        fovx = focal2fov(float(raw["fx"]), width)
        fovy = focal2fov(float(raw["fy"]), height)
    else:
        raw = None
        width = height = int(default_res)
        fovx = fovy = float(default_fov)

    idx = camera_params.get("default_camera_index", 0)
    if raw is not None and (idx is None or int(idx) > -1):
        static = viewmat_from_camera_entry(raw)
        return [static] * n_frames, height, width, fovx, fovy

    views = get_camera_view_sequence(
        camera_params, viewpoint_center_worldspace, observant_coordinates,
        n_frames,
    )
    return views, height, width, fovx, fovy


def get_camera_view_sequence(camera_params: dict, viewpoint_center_worldspace,
                             observant_coordinates, n_frames: int):
    """Per-frame view matrices from the sim JSON camera params
    (get_camera_view, camera_view_utils; decode_param.py:213-273 defaults)."""
    az = camera_params.get("init_azimuthm") or 0.0
    el = camera_params.get("init_elevation") or 30.0
    ra = camera_params.get("init_radius") or 2.0
    roll = camera_params.get("init_roll") or 0.0
    da = camera_params.get("delta_a") or 0.0
    de = camera_params.get("delta_e") or 0.0
    dr = camera_params.get("delta_r") or 0.0
    droll = camera_params.get("delta_roll") or 0.0
    move = bool(camera_params.get("move_camera", False))

    vertical = observant_coordinates[:, 2]
    views = []
    for f in range(n_frames):
        if move:
            a, e, r, ro = az + da * f, el + de * f, ra + dr * f, roll + droll * f
        else:
            a, e, r, ro = az, el, ra, roll
        pos = orbit_camera_position(
            viewpoint_center_worldspace, observant_coordinates, a, e, r
        )
        views.append(
            look_at_viewmat(pos, viewpoint_center_worldspace, vertical, ro)
        )
    return views
