"""Ablate the P2G kernel to attribute its time.

    python -m pixie_tpu_torch.scripts.probe_kernel_ablation [--device cuda|cpu]

Times four variants of the shipped P2G splat (``csrc/transfer.cu``
``p2g_kernel``) on the particle set of ``scripts/probe_kernel_ablation.py``:
seed 0, 100,000 particles uniform in [0.75, 1.25]^3, n_grid 50, inv_dx 25;
v, C and stress normal x 0.1, mass and vol |normal| x 0.1.

Variants (``ops/probe_ablation.py``, ``csrc/probe_ablation.cu``):
  full       — shipped kernel
  noweights  — per-node weight, weight gradient and APIC offset replaced by
               constants (the 108 atomics a particle kept)
  noatomics  — weights kept, the atomics replaced by a sum in registers and
               one 16-byte store a particle
  minimal    — the particle's loads, one sum and one store: load and launch

Each runs in two particle orders: as generated (the order the rollout
feeds the kernel) and sorted by base cell (the counterpart of the JAX
layout's tile sort, on which the JAX probe measures).  Each line is the
median of 30 per-call timings (CUDA events on the card, see
``pixie_tpu_torch.scripts.timing``; the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from pixie_tpu_torch.ops.probe_ablation import MODES, p2g_variant
from pixie_tpu_torch.scripts.timing import time_calls
from pixie_tpu_torch.sim.types import MPMConfig

N = 100_000
N_GRID, GRID_LIM = 50, 2.0   # inv_dx 25
DT = 1e-4
WARMUP, REPS = 3, 30
ORDERS = ("generated", "cell_sorted")


def config() -> MPMConfig:
    return MPMConfig(n_grid=N_GRID, grid_lim=GRID_LIM)


def make_particles(n: int = N, seed: int = 0) -> dict:
    """The probe's particles as numpy arrays: x drawn first, as there."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.75, 1.25, (n, 3)).astype(np.float32)

    def noise(*shape):
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    return {"x": x, "v": noise(n, 3), "C": noise(n, 3, 3), "stress": noise(n, 3, 3),
            "mass": np.abs(noise(n)), "vol": np.abs(noise(n))}


def base_cells(x: np.ndarray, cfg: MPMConfig) -> np.ndarray:
    """Flat index of each particle's stencil base cell, as the kernel finds it."""
    base = np.floor(x * np.float32(cfg.inv_dx) - np.float32(0.5)).astype(np.int64)
    return (base[:, 0] * cfg.n_grid + base[:, 1]) * cfg.n_grid + base[:, 2]


def inputs(d: dict, order: str, cfg: MPMConfig, device) -> tuple:
    """(x, v, C, stress, mass, vol, active) on ``device`` in ``order``."""
    perm = (np.arange(len(d["x"])) if order == "generated"
            else np.argsort(base_cells(d["x"], cfg), kind="stable"))
    ts = [torch.as_tensor(np.ascontiguousarray(d[k][perm]), device=device)
          for k in ("x", "v", "C", "stress", "mass", "vol")]
    return (*ts, torch.ones(len(perm), dtype=torch.bool, device=device))


def main(device: str | torch.device = "cuda", n: int = N) -> dict:
    """Times every variant in both orders; returns {mode: {order: ms}}."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_kernel_ablation: no CUDA device (pass device='cpu')")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    cfg = config()
    d = make_particles(n)
    cells = np.unique(base_cells(d["x"], cfg))
    print(f"n_particles={n} n_grid={cfg.n_grid} inv_dx={cfg.inv_dx:g} "
          f"occupied_cells={len(cells)} ({n / len(cells):.1f} particles a cell)", flush=True)
    out = {mode: {} for mode in MODES}
    for order in ORDERS:
        args = inputs(d, order, cfg, dev)
        print(f"order: {order}", flush=True)
        for mode in MODES:
            times = time_calls(lambda m=mode: p2g_variant(m, *args, cfg, DT), [()] * REPS, dev,
                               warmup=WARMUP)
            out[mode][order] = statistics.median(times)
            print(f"p2g[{mode}]: {out[mode][order]:.4f} ms/call", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    a = ap.parse_args()
    main(a.device, a.n)
