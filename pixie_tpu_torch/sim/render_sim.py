"""GS-rendered simulation frames (port of pixie_tpu/sim/render_sim.py).

The render half of the PhysGaussian frame loop (gs_simulation.py:573-631)
and its gaussian-format per-frame PLY export (gs_simulation.py:290-330):

  * simulated positions go back to world coordinates and the transported
    covariances are unscaled (cov / scale_origin**2) and un-rotated, as one
    affine map and one 6x6 congruence on the device;
  * crop-excluded gaussians (``sim_area``) are appended as static splats;
  * view-dependent colors come from SH evaluated at the *deformed* world
    positions, and the frame goes through ``rasterize_tiled`` with the
    precomputed covariance/color/opacity inputs;
  * per-frame PLYs carry eigendecomposed covariances as log-scales + wxyz
    quaternions.  As the reference does, the *activated* opacity goes into
    the PLY's raw ``opacity`` field.

"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.recon import gaussians as G
from pixie_tpu_torch.recon.rasterizer import Camera, congruence6, rasterize_tiled
from pixie_tpu_torch.sim import camera as cam_utils
from pixie_tpu_torch.sim import transforms as tf


def cov6_to_log_scales_quats(cov6: np.ndarray):
    """Upper-packed world covariances -> (log_scales (N,3), quats wxyz (N,4)).

    Eigendecomposition with descending eigenvalues and right-handedness
    enforcement (cov3D_to_log_scales_and_quats, gs_simulation.py:230-268).
    Carried over unchanged from pixie_tpu/sim/render_sim.py (host numpy)."""
    cov6 = np.asarray(cov6, np.float64)
    m = np.zeros((len(cov6), 3, 3))
    m[:, 0, 0] = cov6[:, 0]
    m[:, 0, 1] = m[:, 1, 0] = cov6[:, 1]
    m[:, 0, 2] = m[:, 2, 0] = cov6[:, 2]
    m[:, 1, 1] = cov6[:, 3]
    m[:, 1, 2] = m[:, 2, 1] = cov6[:, 4]
    m[:, 2, 2] = cov6[:, 5]
    evals, evecs = np.linalg.eigh(m)            # ascending
    evals, evecs = evals[:, ::-1], evecs[:, :, ::-1]  # descending
    scales = np.sqrt(np.clip(evals, 1e-12, None))
    neg = np.linalg.det(evecs) < 0
    evecs[neg, :, 2] *= -1.0

    # rotation matrix -> wxyz quaternion (branchless Shepperd)
    r = evecs
    t = np.trace(r, axis1=1, axis2=2)
    s0 = np.sqrt(np.clip(t + 1.0, 1e-12, None)) * 2
    q0 = np.stack([0.25 * s0,
                   (r[:, 2, 1] - r[:, 1, 2]) / s0,
                   (r[:, 0, 2] - r[:, 2, 0]) / s0,
                   (r[:, 1, 0] - r[:, 0, 1]) / s0], -1)
    sx = np.sqrt(np.clip(1.0 + r[:, 0, 0] - r[:, 1, 1] - r[:, 2, 2], 1e-12, None)) * 2
    qx = np.stack([(r[:, 2, 1] - r[:, 1, 2]) / sx, 0.25 * sx,
                   (r[:, 0, 1] + r[:, 1, 0]) / sx,
                   (r[:, 0, 2] + r[:, 2, 0]) / sx], -1)
    sy = np.sqrt(np.clip(1.0 - r[:, 0, 0] + r[:, 1, 1] - r[:, 2, 2], 1e-12, None)) * 2
    qy = np.stack([(r[:, 0, 2] - r[:, 2, 0]) / sy,
                   (r[:, 0, 1] + r[:, 1, 0]) / sy, 0.25 * sy,
                   (r[:, 1, 2] + r[:, 2, 1]) / sy], -1)
    sz = np.sqrt(np.clip(1.0 - r[:, 0, 0] - r[:, 1, 1] + r[:, 2, 2], 1e-12, None)) * 2
    qz = np.stack([(r[:, 1, 0] - r[:, 0, 1]) / sz,
                   (r[:, 0, 2] + r[:, 2, 0]) / sz,
                   (r[:, 1, 2] + r[:, 2, 1]) / sz, 0.25 * sz], -1)
    use_x = (r[:, 0, 0] >= r[:, 1, 1]) & (r[:, 0, 0] >= r[:, 2, 2])
    use_y = (~use_x) & (r[:, 1, 1] >= r[:, 2, 2])
    q = np.where(use_x[:, None], qx, np.where(use_y[:, None], qy, qz))
    q = np.where((t > 0)[:, None], q0, q)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.log(scales).astype(np.float32), q.astype(np.float32)


@dataclass
class SimRenderer:
    """Per-frame splat rendering of a running simulation.

    Built once per rollout from the gaussian payload collected during
    particle setup; ``render_frame`` takes the current MPM-frame positions
    and covariances of the first ``gs_num`` particles and returns an
    (H, W, 3) uint8 frame.  The payload (``shs`` / ``opacity_act`` /
    ``unselected``) is sent to ``device`` once, at the first frame, and is
    treated as constant for the renderer's lifetime.
    """

    shs: np.ndarray                 # (G, K, 3) SH coefficients
    opacity_act: np.ndarray         # (G, 1) activated (sigmoid) opacity
    scale_origin: float
    original_mean_pos: np.ndarray
    rotation_matrices: list
    z_shift: float
    viewmats: list                  # per-frame (4,4) world->camera
    width: int
    height: int
    fovx: float
    fovy: float
    white_bg: bool = False
    unselected: dict | None = None  # pos/cov6/opacity/shs in world frame
    device: torch.device = torch.device("cuda")
    _dev: dict = field(default_factory=dict, repr=False)

    @classmethod
    def from_camera_params(cls, camera_params: dict, model_path, n_frames: int, shs,
                           opacity_act, scale_origin, original_mean_pos,
                           rotation_matrices, z_shift, unselected=None, white_bg=False,
                           device: str | torch.device = "cuda"):
        """Reference camera setup (gs_simulation.py:536-590): MPM-space
        viewpoint center/up -> world orbit basis -> per-frame views."""
        center_w, obs = cam_utils.get_center_view_worldspace_and_observant_coordinate(
            camera_params.get("mpm_space_viewpoint_center", [1.0, 1.0, 1.0]),
            camera_params.get("mpm_space_vertical_upward_axis", [0.0, 0.0, 1.0]),
            rotation_matrices, scale_origin, np.asarray(original_mean_pos),
        )
        viewmats, h, w, fovx, fovy = cam_utils.get_sim_camera_sequence(
            camera_params, model_path, center_w, obs, n_frames)
        return cls(
            shs=np.asarray(shs, np.float32),
            opacity_act=np.asarray(opacity_act, np.float32).reshape(-1, 1),
            scale_origin=float(scale_origin),
            original_mean_pos=np.asarray(original_mean_pos, np.float32),
            rotation_matrices=list(rotation_matrices),
            z_shift=float(z_shift),
            viewmats=viewmats, width=w, height=h, fovx=fovx, fovy=fovy,
            unselected=unselected, white_bg=white_bg, device=torch.device(device),
        )

    # --- geometry helpers -------------------------------------------------

    def to_world(self, x_mpm: np.ndarray) -> np.ndarray:
        """MPM cube -> original world coordinates (gs_simulation.py:595-599)."""
        return tf.apply_inverse_rotations(
            tf.undotransform2origin(
                tf.undoshift2center111(np.asarray(x_mpm), self.z_shift),
                self.scale_origin, self.original_mean_pos),
            self.rotation_matrices)

    def cov_to_world(self, cov6_mpm: np.ndarray) -> np.ndarray:
        """MPM-frame covariances -> world (gs_simulation.py:600)."""
        return tf.apply_inverse_cov_rotations(
            np.asarray(cov6_mpm) / (self.scale_origin ** 2), self.rotation_matrices)

    def _camera(self):
        # the tiled rasterizer needs H, W multiples of 16: render padded and
        # crop, with the principal point on the REQUESTED frame
        hp = (self.height + 15) // 16 * 16
        wp = (self.width + 15) // 16 * 16
        fx = self.width / (2.0 * np.tan(self.fovx * 0.5))
        fy = self.height / (2.0 * np.tan(self.fovy * 0.5))
        return Camera(width=wp, height=hp, fx=fx, fy=fy,
                      cx=self.width / 2.0, cy=self.height / 2.0)

    def _world_maps(self):
        """undoshift2center111 -> undotransform2origin -> inverse rotations
        as one affine map pos_w = x @ A + b, and the covariance unscale +
        un-rotation as one packed congruence cov6_w = cov6 @ T6.T."""
        q = np.eye(3, dtype=np.float64)
        for r in reversed(self.rotation_matrices):
            q = q @ np.asarray(r, np.float64)
        c = np.array([1.0, 1.0, 1.0 + self.z_shift])
        a_mat = q / self.scale_origin
        b_vec = (np.asarray(self.original_mean_pos, np.float64) - c / self.scale_origin) @ q
        t6 = congruence6(q.T) / (self.scale_origin ** 2)
        return a_mat.astype(np.float32), b_vec.astype(np.float32), t6.astype(np.float32)

    def _device_payload(self) -> dict:
        """Constant per-rollout tensors, sent to the device once."""
        if not self._dev:
            shs, opacity = self.shs, self.opacity_act
            if self.unselected is not None:
                shs = np.concatenate([shs, self.unselected["shs"]], 0)
                opacity = np.concatenate(
                    [opacity, np.asarray(self.unselected["opacity"]).reshape(-1, 1)], 0)
                u_pos = np.asarray(self.unselected["pos"], np.float32)
                u_cov = np.asarray(self.unselected["cov6"], np.float32)
            else:
                u_pos = np.zeros((0, 3), np.float32)
                u_cov = np.zeros((0, 6), np.float32)
            a_mat, b_vec, t6 = self._world_maps()

            def put(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

            self._dev.update(shs=put(shs), opacity=put(opacity)[:, 0], u_pos=put(u_pos),
                             u_cov=put(u_cov), a=put(a_mat), b=put(b_vec), t6=put(t6))
        return self._dev

    def render_frame(self, frame_idx: int, x_mpm_gs, cov6_mpm_gs):
        """Rasterize one simulation frame from the MPM-frame positions (G,3)
        and packed covariances (G,6) of the simulated gaussians (tensors on
        the renderer's device, or host arrays).  Returns ((H, W, 3) uint8
        numpy frame, (pos_w, cov_w)): the world-frame positions and
        covariances stay on the device."""
        d = self._device_payload()
        x = torch.as_tensor(x_mpm_gs, dtype=torch.float32, device=self.device)
        cov6 = torch.as_tensor(cov6_mpm_gs, dtype=torch.float32, device=self.device)
        vm = torch.as_tensor(np.asarray(self.viewmats[frame_idx], np.float32),
                             device=self.device)
        pos_w = x @ d["a"] + d["b"]
        cov_w = cov6 @ d["t6"].T
        pos_r = torch.cat([pos_w, d["u_pos"]], 0)
        cov_r = torch.cat([cov_w, d["u_cov"]], 0)
        # camera center in world space (convert_SH, render_utils.py:131)
        cam_pos = -vm[:3, :3].T @ vm[:3, 3]
        dirs = pos_r - cam_pos[None]
        dirs = dirs / torch.clamp(torch.sqrt(torch.sum(dirs * dirs, 1, keepdim=True)),
                                  min=1e-8)
        colors = torch.clamp(G.eval_sh(d["shs"], dirs, G.sh_degree_of(d["shs"])), min=0.0)
        params = {"xyz": pos_r, "cov6_precomp": cov_r, "colors_precomp": colors,
                  "opacity_precomp": d["opacity"]}
        img, _alpha = rasterize_tiled(params, vm, self._camera(),
                                      bg_color=1.0 if self.white_bg else 0.0)
        img = torch.clamp(img[: self.height, : self.width], 0.0, 1.0)
        img8 = (img * 255.0 + 0.5).to(torch.uint8)
        return img8.cpu().numpy(), (pos_w, cov_w)

    def export_gaussian_ply(self, path, pos_world, cov6_world):
        """Per-frame gaussian-format PLY (export_gaussians_to_ply,
        gs_simulation.py:290-330) for the Blender GS render mode."""
        cov6 = cov6_world.cpu().numpy() if isinstance(cov6_world, torch.Tensor) else cov6_world
        log_s, quat = cov6_to_log_scales_quats(cov6)
        G.save_gaussian_ply(path, {
            "xyz": pos_world,
            "f_dc": self.shs[:, :1, :],
            "f_rest": self.shs[:, 1:, :],
            "opacity": self.opacity_act,   # activated, as the reference writes it
            "scaling": log_s,
            "rotation": quat,
        })


def save_frame_png(path: str | Path, img: np.ndarray):
    """Write a frame as PNG (cv2.imwrite equivalent, gs_simulation.py:629-631).
    Accepts uint8 (render_frame output) or [0,1] float."""
    from PIL import Image  # noqa: PLC0415

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(img).save(path)
    logging.debug("wrote %s", path)
