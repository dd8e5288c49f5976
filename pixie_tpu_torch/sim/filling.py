"""Internal particle filling and particle volumes (port of
pixie_tpu/sim/filling.py).

One-time simulation preprocessing of a GS checkpoint's particles:

  * ``densify_grids``, ``emit_particles_in_cells`` and
    ``get_particle_volume`` are host numpy, carried over unchanged;
  * ``internal_cells_mask`` replaces the reference's per-cell ray casts by
    dense directional suffix scans (``torch.flip`` / ``torch.cumsum``) on
    the device the caller names;
  * ``init_filled_particles`` gives each new particle the attributes of its
    nearest original gaussian through ``material_field.knn``.

``fill_particles`` draws its jitter from ``np.random.default_rng(seed)`` in
the JAX package's order, so the same seed gives the same particles.
"""

from __future__ import annotations

import numpy as np
import torch

from pixie_tpu_torch.sim.material_field import knn
from pixie_tpu_torch.sim.transforms import get_mat_from_upper


def densify_grids(pos, opacity, cov_upper, grid_n: int, grid_dx: float):
    """Particle-count grid + gaussian-weighted density grid
    (densify_grids, filling.py:26-87).  Host-side numpy, vectorized per
    stencil offset with a per-particle radius cap."""
    pos = np.asarray(pos, np.float32)
    opacity = np.asarray(opacity, np.float32).reshape(-1)
    cell = np.clip((pos / grid_dx).astype(np.int64), 0, grid_n - 1)

    count = np.zeros((grid_n, grid_n, grid_n), np.int32)
    np.add.at(count, (cell[:, 0], cell[:, 1], cell[:, 2]), 1)

    # inverse covariance and radius from eigenvalues (filling.py:44-68)
    cov = get_mat_from_upper(np.asarray(cov_upper, np.float32))
    sig, q = np.linalg.eigh(cov)
    sig = np.maximum(sig, 1e-8)
    inv_cov = np.einsum("nij,nj,nkj->nik", q, 1.0 / sig, q)
    r = np.ceil(np.sqrt(sig.max(axis=1)) / grid_dx).astype(np.int64)
    r_max = int(min(max(r.max(initial=1), 1), 3))  # cap stencil for vectorization

    density = np.zeros((grid_n, grid_n, grid_n), np.float32)
    offs = np.arange(-r_max, r_max + 1)
    for dx in offs:
        for dy in offs:
            for dz in offs:
                within = (np.abs(dx) <= r) & (np.abs(dy) <= r) & (np.abs(dz) <= r)
                tgt = cell + np.array([dx, dy, dz])
                ok = within & np.all((tgt >= 0) & (tgt < grid_n), axis=1)
                if not ok.any():
                    continue
                t = tgt[ok]
                p = pos[ok]
                ic = inv_cov[ok]
                op = opacity[ok]
                # 8-corner gaussian weight (compute_density, filling.py:13-23)
                w = np.zeros(len(t), np.float32)
                for ci in range(2):
                    for cj in range(2):
                        for ck in range(2):
                            node = (t + np.array([ci, cj, ck])) * grid_dx
                            d = p - node
                            w += np.exp(-0.5 * np.einsum("ni,nij,nj->n", d, ic, d))
                np.add.at(density, (t[:, 0], t[:, 1], t[:, 2]), op * w / 8.0)
    return count, density


def _beyond(flags: torch.Tensor, axis: int, positive: bool) -> torch.Tensor:
    """Number of set flags strictly beyond each cell along the direction."""
    f = flags if positive else torch.flip(flags, (axis,))
    f = f.to(torch.int32)
    sfx = torch.flip(torch.cumsum(torch.flip(f, (axis,)), dim=axis), (axis,))
    out = sfx - f  # count at >= self minus self
    return out if positive else torch.flip(out, (axis,))


def internal_cells_mask(count, density, search_threshold: float, exclude_dir: int = 5,
                        ray_cast_dir: int = 4, device: str | torch.device = "cuda"):
    """Dense reformulation of internal_filling's per-cell ray casts
    (filling.py:117-240): a cell is internal iff it is empty, occluded along
    all five non-excluded axis directions, and its ray parity along
    ray_cast_dir is odd.  Direction d is axis d // 2, positive for even d.
    Runs on ``device``; returns a bool tensor there."""
    count = torch.as_tensor(np.asarray(count), device=device)
    occ = torch.as_tensor(np.asarray(density), device=device) > search_threshold
    enclosed = torch.ones_like(occ)
    for d in range(6):
        if d != exclude_dir:
            enclosed = enclosed & (_beyond(occ, d // 2, d % 2 == 0) > 0)
    if ray_cast_dir in (0, 1, 2, 3, 4, 5):
        axis, positive = ray_cast_dir // 2, ray_cast_dir % 2 == 0
        o = occ if positive else torch.flip(occ, (axis,))
        prev = torch.zeros_like(o)
        prev.narrow(axis, 1, o.shape[axis] - 1).copy_(o.narrow(axis, 0, o.shape[axis] - 1))
        rising = o & ~prev
        par = (_beyond(rising, axis, True) % 2) == 1
        parity = par if positive else torch.flip(par, (axis,))
    else:
        parity = torch.ones_like(occ)  # dir_type out of range -> times=1 (odd)
    return (count == 0) & enclosed & parity


def emit_particles_in_cells(mask, count, grid_dx: float, max_particles_per_cell: int, rng):
    """Random in-cell jitter particle emission (fill_dense_grids /
    internal_filling emission, filling.py:90-113,222-233)."""
    mask = np.asarray(mask)
    count = np.asarray(count)
    cells = np.argwhere(mask & (count < max_particles_per_cell))
    if len(cells) == 0:
        return np.zeros((0, 3), np.float32)
    diffs = max_particles_per_cell - count[mask & (count < max_particles_per_cell)]
    reps = np.repeat(np.arange(len(cells)), diffs)
    jitter = rng.random((len(reps), 3)).astype(np.float32)
    return (cells[reps] + jitter) * grid_dx


def fill_particles(
    pos,
    opacity,
    cov_upper,
    grid_n: int,
    max_samples: int,
    grid_dx: float,
    density_thres: float = 2.0,
    search_thres: float = 1.0,
    max_particles_per_cell: int = 1,
    search_exclude_dir: int = 5,
    ray_cast_dir: int = 4,
    boundary=None,
    smooth: bool = False,
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """Full filling pipeline (fill_particles, filling.py:291-380); the
    internal-cell scans run on ``device``.  Returns new particle positions
    (M,3), M <= max_samples - len(pos)."""
    rng = np.random.default_rng(seed)
    count, density = densify_grids(pos, opacity, cov_upper, grid_n, grid_dx)

    # surface fill: dense cells below particle cap (fill_dense_grids)
    dense_mask = density > density_thres
    new_surface = emit_particles_in_cells(dense_mask, count, grid_dx, max_particles_per_cell,
                                          rng)
    count2 = count.copy()
    count2[dense_mask] = np.maximum(count2[dense_mask], max_particles_per_cell)

    # internal fill: enclosed odd-parity empty cells
    internal = internal_cells_mask(count2, density, search_thres, search_exclude_dir,
                                   ray_cast_dir, device=device).cpu().numpy()
    if boundary is not None:
        b = np.asarray(boundary, np.float32).reshape(3, 2)
        idx = np.arange(grid_n) * grid_dx
        inb = (((idx >= b[0, 0]) & (idx <= b[0, 1]))[:, None, None]
               & ((idx >= b[1, 0]) & (idx <= b[1, 1]))[None, :, None]
               & ((idx >= b[2, 0]) & (idx <= b[2, 1]))[None, None, :])
        internal = internal & inb
    new_internal = emit_particles_in_cells(internal, count2, grid_dx, max_particles_per_cell,
                                           rng)

    new = np.concatenate([new_surface, new_internal], axis=0)
    budget = max(max_samples - len(pos), 0)
    if len(new) > budget:
        new = new[rng.permutation(len(new))[:budget]]
    return new.astype(np.float32)


def get_particle_volume(pos, grid_n: int, grid_dx: float, uniform: bool = False):
    """Per-particle volume = cell volume / particles-in-cell
    (get_particle_volume, filling.py:273-289)."""
    pos = np.asarray(pos, np.float32)
    cell = np.clip((pos / grid_dx).astype(np.int64), 0, grid_n - 1)
    count = np.zeros((grid_n, grid_n, grid_n), np.int32)
    np.add.at(count, (cell[:, 0], cell[:, 1], cell[:, 2]), 1)
    vol = (grid_dx**3) / count[cell[:, 0], cell[:, 1], cell[:, 2]]
    if uniform:
        vol = np.full(len(pos), vol.mean(), np.float32)
    return vol.astype(np.float32)


def init_filled_particles(new_pos, orig_pos, attrs: dict, device: str | torch.device = "cuda"):
    """Inherit attributes from the nearest original gaussian
    (init_filled_particles, filling.py:408-446), the kNN on ``device``."""
    if len(new_pos) == 0:
        return {k: np.zeros((0, *np.asarray(v).shape[1:]), np.asarray(v).dtype)
                for k, v in attrs.items()}
    _, idx = knn(np.asarray(new_pos, np.float32), np.asarray(orig_pos, np.float32), k=1,
                 device=device)
    nearest = idx[:, 0]
    return {k: np.asarray(v)[nearest] for k, v in attrs.items()}
