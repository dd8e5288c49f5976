"""Probe: throughput of take_along_axis on a (T, L) float32 table.

    python -m pixie_tpu_torch.scripts.probe_vmem_gather [--device cuda|cpu]

The counterpart of ``scripts/probe_vmem_gather.py``, which measured the
TPU's in-VMEM dynamic gather for a hash-table lookup: store the table as
(T, 128), pack many points' corner indices into one (T, 128) index array,
and gather T x 128 values in one call.  Here the two gathers are the
hand-written kernels of ``csrc/gather.cu`` (``ops/gather.py``):
  axis 0: out[i, j] = table[idx[i, j], j]   (row index, columns batched)
  axis 1: out[i, j] = table[i, idx[i, j]]   (column index, rows batched)
at T = 8192, L = 128.  For each axis it prints the time of the first call
(build included), the max error against ``np.take_along_axis``, and the
mean time a call over 50 fresh index arrays (CUDA events on the card, see
``pixie_tpu_torch.scripts.timing``; the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from pixie_tpu_torch.ops.gather import take_along_axis
from pixie_tpu_torch.scripts.timing import time_calls

T = 8192      # table rows / gather rows a call
L = 128       # columns
REPS, WARMUP = 50, 3
NAMES = {0: "gather axis0 (row idx, column batch)", 1: "gather axis1 (column idx, row batch)"}


def make_inputs(axis: int, t: int = T, l: int = L, seed: int = 0, device="cpu"):
    """Seeded (table (t, l) float32, idx (t, l) int32 in range for axis) and
    the generator, for more index arrays."""
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.normal(size=(t, l)).astype(np.float32), device=device)
    return table, random_indices(rng, axis, t, l, device), rng


def random_indices(rng, axis: int, t: int, l: int, device) -> torch.Tensor:
    hi = t if axis == 0 else l
    return torch.as_tensor(rng.integers(0, hi, size=(t, l)).astype(np.int32), device=device)


def run(axis: int, dev: torch.device, t: int = T, l: int = L, reps: int = REPS) -> dict:
    name = NAMES[axis]
    table, idx, rng = make_inputs(axis, t, l, device=dev)
    t0 = time.perf_counter()
    out = take_along_axis(table, idx, axis)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    print(f"{name}: compiled+ran in {first_s:.1f}s", flush=True)
    ref = np.take_along_axis(table.cpu().numpy(), idx.cpu().numpy(), axis=axis)
    err = float(np.abs(out.cpu().numpy() - ref).max())
    print(f"{name}: max err {err:.2e}", flush=True)
    idxs = [(random_indices(rng, axis, t, l, dev),) for _ in range(reps)]
    ms = statistics.mean(time_calls(lambda i: take_along_axis(table, i, axis), idxs, dev,
                                    warmup=WARMUP))
    n = t * l
    print(f"{name}: {ms * 1e3:.1f} us per {n} gathered values ({ms * 1e6 / n:.3f} ns/value)",
          flush=True)
    return {"first_s": first_s, "max_err": err, "ms": ms}


def main(device: str | torch.device = "cuda", t: int = T, l: int = L, reps: int = REPS) -> dict:
    """Runs both axes; returns {axis: {"first_s", "max_err", "ms"}}."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_vmem_gather: no CUDA device (pass device='cpu')")
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          flush=True)
    return {axis: run(axis, dev, t, l, reps) for axis in (0, 1)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.device)
