"""Observability: phase timing, rollout debugging, experiment logging (port of
pixie_tpu/utils/observability.py).

Reference equivalents:
  * wp.ScopedTimer per MPM phase (mpm_solver_warp.py:550-635, time_profile
    dict + print_time_profile:743) -> ``PhaseTimer``, whose phases can also
    be ``torch.profiler.record_function`` ranges (JAX's trace annotations);
  * debug_particle_positions out-of-grid check (mpm_solver_warp.py:473-502);
  * wandb rank-0 logging (training_utils.py:90-125) -> ``ExperimentLogger``
    that uses wandb when importable and otherwise appends JSONL locally
    (same .log(dict) call surface).
"""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch


class PhaseTimer:
    """Accumulating phase timer (ScopedTimer-with-dict equivalent).

    ``use_profiler``: each phase is also a ``torch.profiler.record_function``
    range, so a profiler trace shows it.  ``block_on``: a tensor whose
    device's queue is synchronized before the phase's clock stops (CUDA
    returns before the work is done)."""

    def __init__(self, use_profiler: bool = False):
        self.time_profile: dict[str, list[float]] = defaultdict(list)
        self.use_profiler = use_profiler

    @contextmanager
    def phase(self, name: str, block_on=None):
        ctx = torch.profiler.record_function(name) if self.use_profiler else None
        if ctx is not None:
            ctx.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if isinstance(block_on, torch.Tensor) and block_on.is_cuda:
                torch.cuda.synchronize(block_on.device)
            self.time_profile[name].append(time.perf_counter() - t0)
            if ctx is not None:
                ctx.__exit__(None, None, None)

    def print_time_profile(self):
        logging.info("MPM Time profile:")
        for key, values in self.time_profile.items():
            logging.info("  %s: %.4fs (%d calls)", key, sum(values), len(values))

    def summary(self) -> dict:
        return {k: {"total_s": sum(v), "calls": len(v)} for k, v in
                self.time_profile.items()}


def debug_particle_positions(x, grid_lim: float, step_name: str = "") -> bool:
    """Out-of-grid particle check (debug_particle_positions,
    mpm_solver_warp.py:473-502). Returns True when violations exist."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    outside_min = int((x < 0).any(axis=1).sum())
    outside_max = int((x > grid_lim).any(axis=1).sum())
    if outside_min or outside_max:
        logging.warning(
            "[DEBUG %s] %d particles < 0, %d particles > %s; range "
            "x[%.4f, %.4f] y[%.4f, %.4f] z[%.4f, %.4f]",
            step_name, outside_min, outside_max, grid_lim,
            x[:, 0].min(), x[:, 0].max(), x[:, 1].min(), x[:, 1].max(),
            x[:, 2].min(), x[:, 2].max(),
        )
        return True
    return False


class ExperimentLogger:
    """wandb-compatible logger with a local JSONL fallback."""

    def __init__(self, out_dir: str | Path, project: str = "pixie-tpu",
                 run_name: str | None = None, config: dict | None = None,
                 use_wandb: bool = True, rank: int = 0):
        self.rank = rank
        self._wandb = None
        self._fh = None
        if rank != 0:
            return
        if use_wandb:
            try:
                import wandb  # noqa: PLC0415

                self._wandb = wandb.init(
                    project=project, name=run_name, config=config or {},
                    resume="allow",
                )
            except Exception as e:  # noqa: BLE001
                logging.info("wandb unavailable (%s); logging to JSONL", e)
        if self._wandb is None:
            path = Path(out_dir)
            path.mkdir(parents=True, exist_ok=True)
            self._fh = open(path / "metrics.jsonl", "a")
            if config:
                (path / "run_config.json").write_text(json.dumps(config, indent=2))

    def log(self, metrics: dict, step: int | None = None):
        if self.rank != 0:
            return
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        elif self._fh is not None:
            rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        if self._fh is not None:
            self._fh.close()
