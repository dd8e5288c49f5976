"""3D Gaussian Splatting model: parameters, PLY I/O, covariance, SH
(port of pixie_tpu/recon/gaussians.py).

Parameters are a plain dict of tensors: xyz (N,3), f_dc (N,1,3), f_rest
(N,K-1,3), scaling (N,3) log-scales, rotation (N,4) wxyz quaternions,
opacity (N,1) logits.  The PLY is the Inria layout, with f_rest flattened
channel-major.
"""

from __future__ import annotations

import numpy as np
import torch

from pixie_tpu_torch.sim.material_field import knn
from pixie_tpu_torch.utils.io import read_ply, write_ply

SH_C0 = 0.28209479177387814


def rgb_to_sh(rgb):
    return (np.asarray(rgb) - 0.5) / SH_C0


def inverse_sigmoid(x):
    x = np.clip(x, 1e-6, 1 - 1e-6)
    return np.log(x / (1 - x))


def create_from_points(points: np.ndarray, colors: np.ndarray | None = None,
                       sh_degree: int = 3, initial_opacity: float = 0.1,
                       device: str | torch.device = "cpu") -> dict:
    """Initialize gaussians from a point cloud (GaussianModel.create_from_pcd):
    scale = log(sqrt(mean 3-NN squared distance)), identity rotation,
    opacity logit(initial_opacity), DC SH from colors.  The kNN runs on
    ``device``; the parameters come back on it too."""
    n = len(points)
    if colors is None:
        colors = np.full((n, 3), 0.5, np.float32)
    k = min(4, n)
    if k >= 2:
        dists, _ = knn(points, points, k=k, device=device)  # self + up to 3
        mean_sq = np.maximum((dists[:, 1:] ** 2).mean(axis=1), 1e-7)
    else:
        mean_sq = np.full(n, 1e-7, np.float32)
    scales = np.log(np.sqrt(mean_sq))[:, None].repeat(3, axis=1)
    n_rest = (sh_degree + 1) ** 2 - 1

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {
        "xyz": t(points),
        "f_dc": t(rgb_to_sh(colors)[:, None, :]),
        "f_rest": torch.zeros((n, n_rest, 3), dtype=torch.float32, device=device),
        "scaling": t(scales),
        "rotation": t(np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))),
        "opacity": torch.full((n, 1), float(inverse_sigmoid(initial_opacity)),
                              dtype=torch.float32, device=device),
    }


# -- activations (gaussian_model.py setup_functions) -------------------------

def get_scaling(params):
    return torch.exp(params["scaling"])


def get_opacity(params):
    return torch.sigmoid(params["opacity"])


def get_rotation(params):
    q = params["rotation"]
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-8)


def quat_to_rotmat(q):
    """(N,4) wxyz -> (N,3,3)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def covariance_upper(params, scaling_modifier: float = 1.0):
    """Packed upper-triangular (N,6) Sigma = R S S^T R^T, like the
    reference's strip_symmetric, as the JAX package sums it."""
    s = get_scaling(params) * scaling_modifier
    m = quat_to_rotmat(get_rotation(params)) * s[:, None, :]

    def dot(a, b):
        return m[:, a, 0] * m[:, b, 0] + m[:, a, 1] * m[:, b, 1] + m[:, a, 2] * m[:, b, 2]

    return torch.stack([dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)], -1)


# -- SH color evaluation (utils/sh_utils.py eval_sh, degree <= 3) -------------

_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)


def eval_sh(sh_coeffs, dirs, degree: int = 3):
    """sh_coeffs (N, K, 3), dirs (N, 3) unit -> rgb (N,3) pre-clamp."""
    if sh_coeffs.ndim != 3 or sh_coeffs.shape[-1] != 3:
        raise ValueError(f"sh_coeffs must be (N, K, 3), got {tuple(sh_coeffs.shape)}")
    result = SH_C0 * sh_coeffs[:, 0]
    if degree >= 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        result = (result - _SH_C1 * y * sh_coeffs[:, 1] + _SH_C1 * z * sh_coeffs[:, 2]
                  - _SH_C1 * x * sh_coeffs[:, 3])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (result
                  + _SH_C2[0] * xy * sh_coeffs[:, 4]
                  + _SH_C2[1] * yz * sh_coeffs[:, 5]
                  + _SH_C2[2] * (2.0 * zz - xx - yy) * sh_coeffs[:, 6]
                  + _SH_C2[3] * xz * sh_coeffs[:, 7]
                  + _SH_C2[4] * (xx - yy) * sh_coeffs[:, 8])
    if degree >= 3:
        result = (result
                  + _SH_C3[0] * y * (3 * xx - yy) * sh_coeffs[:, 9]
                  + _SH_C3[1] * xy * z * sh_coeffs[:, 10]
                  + _SH_C3[2] * y * (4 * zz - xx - yy) * sh_coeffs[:, 11]
                  + _SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh_coeffs[:, 12]
                  + _SH_C3[4] * x * (4 * zz - xx - yy) * sh_coeffs[:, 13]
                  + _SH_C3[5] * z * (xx - yy) * sh_coeffs[:, 14]
                  + _SH_C3[6] * x * (xx - 3 * yy) * sh_coeffs[:, 15])
    return result + 0.5


def sh_degree_of(shs) -> int:
    """SH degree of an (N, K, 3) stack (K = 1, 4, 9, 16; else 3)."""
    return {1: 0, 4: 1, 9: 2, 16: 3}.get(shs.shape[1], 3)


def get_shs(params):
    """(N, K, 3) full SH stack [dc, rest]."""
    return torch.cat([params["f_dc"], params["f_rest"]], dim=1)


# -- Inria PLY format (gaussian_model.py load_ply / save_ply) -----------------

def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_gaussian_ply(path, params):
    """Write a parameter dict (tensors or arrays) as an Inria-layout PLY."""
    p = {k: _np(v) for k, v in params.items()}
    n = len(p["xyz"])
    n_rest = p["f_rest"].shape[1]
    fields = [("x", "f4"), ("y", "f4"), ("z", "f4"),
              ("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    fields += [(f"f_dc_{i}", "f4") for i in range(3)]
    fields += [(f"f_rest_{i}", "f4") for i in range(n_rest * 3)]
    fields += [("opacity", "f4")]
    fields += [(f"scale_{i}", "f4") for i in range(3)]
    fields += [(f"rot_{i}", "f4") for i in range(4)]
    v = np.zeros(n, dtype=fields)
    v["x"], v["y"], v["z"] = p["xyz"].T
    for i in range(3):
        v[f"f_dc_{i}"] = p["f_dc"][:, 0, i]
    # Inria layout: f_rest flattened channel-major (3, n_rest) per point
    rest = np.transpose(p["f_rest"], (0, 2, 1)).reshape(n, -1)
    for i in range(rest.shape[1]):
        v[f"f_rest_{i}"] = rest[:, i]
    v["opacity"] = p["opacity"][:, 0]
    for i in range(3):
        v[f"scale_{i}"] = p["scaling"][:, i]
    for i in range(4):
        v[f"rot_{i}"] = p["rotation"][:, i]
    write_ply(path, v)


def load_gaussian_ply(path) -> dict:
    """Inria-layout PLY -> parameter dict of float32 CPU tensors."""
    v = read_ply(path)["vertex"]
    n = len(v)
    n_rest_flat = sum(1 for nm in v.dtype.names if nm.startswith("f_rest_"))
    n_rest = n_rest_flat // 3
    xyz = np.column_stack([v["x"], v["y"], v["z"]])
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :]
    if n_rest:
        rest = np.stack([v[f"f_rest_{i}"] for i in range(n_rest_flat)], -1)
        f_rest = np.transpose(rest.reshape(n, 3, n_rest), (0, 2, 1))
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    arrays = {
        "xyz": xyz, "f_dc": f_dc, "f_rest": f_rest,
        "scaling": np.stack([v[f"scale_{i}"] for i in range(3)], -1),
        "rotation": np.stack([v[f"rot_{i}"] for i in range(4)], -1),
        "opacity": np.asarray(v["opacity"])[:, None],
    }
    return {k: torch.as_tensor(np.ascontiguousarray(a, np.float32)) for k, a in arrays.items()}
