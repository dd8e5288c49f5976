"""Particle volumes for GS-checkpoint particles (port of the part of
pixie_tpu/sim/filling.py the simulation path runs).

``get_particle_volume`` is carried over unchanged (host numpy).  Internal
particle filling is not ported: ``fill_particles`` raises.
"""

from __future__ import annotations

import numpy as np


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


def fill_particles(*args, **kwargs):
    """Internal particle filling (pixie_tpu/sim/filling.py:fill_particles)."""
    raise NotImplementedError(
        "particle_filling is not ported yet: ROADMAP.md 'Next slices' "
        "(fill_particles)")
