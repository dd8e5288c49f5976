"""Particle state export/import (port of pixie_tpu/sim/engine_utils.py).

h5 snapshots (x + particle_volume in the reference's transposed layout),
position PLYs, and the rollout checkpoint: one npz of every ``MPMState``
field by name plus ``_sim_time`` and ``_next_frame``, the JAX package's
schema, so a rollout saved by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.sim.types import MPMState
from pixie_tpu_torch.utils.io import write_ply


def save_particles_h5(path: str | Path, x: np.ndarray, particle_volume: np.ndarray):
    """Reference layout: x stored transposed (3, N), volume (1, N)."""
    import h5py  # noqa: PLC0415

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.asarray(x, np.float64).T)
        f.create_dataset("particle_volume", data=np.asarray(particle_volume, np.float64)[None])


def load_particles_h5(path: str | Path):
    import h5py  # noqa: PLC0415

    with h5py.File(path, "r") as f:
        x = np.asarray(f["x"]).T.astype(np.float32)
        vol = np.squeeze(np.asarray(f["particle_volume"]), 0).astype(np.float32)
    return x, vol


def save_positions_ply(path: str | Path, x: np.ndarray, colors: np.ndarray | None = None):
    x = np.asarray(x, np.float32)
    if colors is None:
        v = np.zeros(len(x), dtype=[("x", "f4"), ("y", "f4"), ("z", "f4")])
    else:
        v = np.zeros(len(x), dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"),
                                    ("red", "u1"), ("green", "u1"), ("blue", "u1")])
        v["red"], v["green"], v["blue"] = np.asarray(colors, np.uint8).T
    v["x"], v["y"], v["z"] = x.T
    write_ply(path, v)


def save_rollout_checkpoint(path: str | Path, state: MPMState, sim_time: float,
                            next_frame: int):
    """Snapshot every MPMState field + the sim clock as one npz.  The write
    is atomic (tmp + rename), so a kill mid-save leaves the previous
    checkpoint intact."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrs = {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)}
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(tmp, _sim_time=np.float64(sim_time), _next_frame=np.int64(next_frame),
                        **arrs)
    tmp.replace(path)


def load_rollout_checkpoint(path: str | Path, device: str | torch.device = "cuda"):
    """Inverse of save_rollout_checkpoint -> (MPMState on ``device``,
    sim_time, next_frame).  Raises if a field of MPMState is missing."""
    with np.load(Path(path)) as z:
        missing = [f.name for f in dataclasses.fields(MPMState) if f.name not in z]
        if missing:
            raise KeyError(f"{path}: rollout checkpoint lacks {missing}")
        fields = {f.name: torch.as_tensor(z[f.name], device=device).contiguous()
                  for f in dataclasses.fields(MPMState)}
        sim_time = float(z["_sim_time"])
        next_frame = int(z["_next_frame"])
    return MPMState(**fields), sim_time, next_frame
