"""World <-> MPM-cube coordinate transforms.

Port of PhysGaussian utils/transformation_utils.py (torch/cuda) to plain
numpy/jax: center + unit-scale into [-0.5,0.5]^3, rotations, shift to the MPM
cube centered at (1,1,1), and their inverses, plus packed-covariance rotation.

Carried over unchanged from pixie_tpu/sim/transforms.py (host numpy).
"""

from __future__ import annotations

import numpy as np

_PI = 3.1415926  # the reference's value (transformation_utils.py:24)


def transform2origin(positions: np.ndarray):
    """Center at bbox mean, scale by 1/max_extent (transformation_utils.py:6-16)."""
    min_pos = positions.min(axis=0)
    max_pos = positions.max(axis=0)
    max_diff = (max_pos - min_pos).max()
    original_mean_pos = (min_pos + max_pos) / 2.0
    scale = 1.0 / max_diff
    return (positions - original_mean_pos) * scale, scale, original_mean_pos


def undotransform2origin(positions, scale, original_mean_pos):
    return original_mean_pos + positions / scale


def generate_rotation_matrix(degree: float, axis: int) -> np.ndarray:
    c = np.cos(degree / 180.0 * _PI)
    s = np.sin(degree / 180.0 * _PI)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    if axis == 2:
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    raise ValueError("Invalid axis selection")


def generate_rotation_matrices(degrees, axes):
    assert len(degrees) == len(axes)
    return [generate_rotation_matrix(d, a) for d, a in zip(degrees, axes)]


def apply_rotations(positions, rotation_matrices):
    for r in rotation_matrices:
        positions = positions @ r.T
    return positions


def apply_inverse_rotations(positions, rotation_matrices):
    for r in reversed(rotation_matrices):
        positions = positions @ r
    return positions


def shift2center111(positions, z_shift_value: float = 0.0):
    return positions + np.array([1.0, 1.0, 1.0 + z_shift_value], positions.dtype)


def undoshift2center111(positions, z_shift_value: float = 0.0):
    return positions - np.array([1.0, 1.0, 1.0 + z_shift_value], positions.dtype)


def undo_all_transforms(positions, rotation_matrices, scale, original_mean_pos):
    """MPM cube -> world (transformation_utils.py:136-140)."""
    return apply_inverse_rotations(
        undotransform2origin(undoshift2center111(positions), scale, original_mean_pos),
        rotation_matrices,
    )


# -- packed upper-triangular covariance helpers ------------------------------

def get_mat_from_upper(upper: np.ndarray) -> np.ndarray:
    u = upper.reshape(-1, 6)
    m = np.empty((u.shape[0], 3, 3), u.dtype)
    m[:, 0, 0], m[:, 0, 1], m[:, 0, 2] = u[:, 0], u[:, 1], u[:, 2]
    m[:, 1, 0], m[:, 1, 1], m[:, 1, 2] = u[:, 1], u[:, 3], u[:, 4]
    m[:, 2, 0], m[:, 2, 1], m[:, 2, 2] = u[:, 2], u[:, 4], u[:, 5]
    return m


def get_upper_from_mat(mat: np.ndarray) -> np.ndarray:
    m = mat.reshape(-1, 3, 3)
    return np.stack(
        [m[:, 0, 0], m[:, 0, 1], m[:, 0, 2], m[:, 1, 1], m[:, 1, 2], m[:, 2, 2]], -1
    )


def apply_cov_rotations(upper_cov: np.ndarray, rotation_matrices) -> np.ndarray:
    cov = get_mat_from_upper(upper_cov)
    for r in rotation_matrices:
        cov = r @ cov @ r.T
    return get_upper_from_mat(cov)


def apply_inverse_cov_rotations(upper_cov: np.ndarray, rotation_matrices) -> np.ndarray:
    """Undo apply_cov_rotations (transformation_utils.py:125-130)."""
    cov = get_mat_from_upper(upper_cov)
    for r in reversed(rotation_matrices):
        cov = r.T @ cov @ r
    return get_upper_from_mat(cov)
