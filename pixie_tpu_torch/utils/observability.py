"""Observability: the program's tracer, rollout debugging, experiment
logging (port of pixie_tpu/utils/observability.py).

Reference equivalents:
  * wp.ScopedTimer per MPM phase (mpm_solver_warp.py:550-635, time_profile
    dict + print_time_profile:743) -> ``PhaseTimer``, whose phases can also
    be ``torch.profiler.record_function`` ranges (JAX's trace annotations).
    A ``PhaseTimer`` is also the program's tracer: ``span(name)`` at the
    layer boundaries of the solver and the material stage records into the
    timer that ``tracing()`` opens, and costs one module-global check
    otherwise;
  * debug_particle_positions out-of-grid check (mpm_solver_warp.py:473-502);
  * wandb rank-0 logging (training_utils.py:90-125) -> ``ExperimentLogger``
    that uses wandb when importable and otherwise appends JSONL locally
    (same .log(dict) call surface).

A span's stamps are ``time.time_ns()``: Unix-epoch nanoseconds, the clock
of the host events in a ``torch.profiler`` trace, so a trace's device
activity can be charged to the spans that launched it without conversion.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

# what ``span`` returns while no ``tracing()`` is open: one shared no-op
_OFF = contextlib.nullcontext()
_TRACER: "PhaseTimer | None" = None     # the timer of the open ``tracing()``


class _Span:
    """A range of a ``PhaseTimer``, entered any number of times (its state
    is on the timer's stacks): a record, and a profiler range named
    ``label`` while a profiler records (without one, a range shows nowhere
    and only costs)."""

    __slots__ = ("timer", "name", "label", "block_on")

    def __init__(self, timer: "PhaseTimer", name: str, label: str | None, block_on=None):
        self.timer, self.name, self.label, self.block_on = timer, name, label, block_on

    def __enter__(self):
        t = self.timer
        ctx = None
        if self.label is not None and torch.autograd._profiler_enabled():
            ctx = torch.profiler.record_function(self.label)
            ctx.__enter__()
        t._ranges.append(ctx)
        # no container is made from here on, so no collection can run
        # between the index and the record it names
        stack = t._stack
        t._parents.append(stack[-1] if stack else -1)
        stack.append(len(t._names))
        t._names.append(self.name)
        t._ends.append(0)
        t._starts.append(time.time_ns())
        return self

    def __exit__(self, *exc):
        if isinstance(self.block_on, torch.Tensor) and self.block_on.is_cuda:
            torch.cuda.synchronize(self.block_on.device)
        t = self.timer
        t._ends[t._stack.pop()] = time.time_ns()
        ctx = t._ranges.pop()
        if ctx is not None:
            ctx.__exit__(None, None, None)
        return False


class PhaseTimer:
    """Accumulating phase timer (ScopedTimer-with-dict equivalent), and the
    program's tracer.

    ``records`` holds every range in the order it opened: ``(name, parent
    index (-1 at the top), start_ns, end_ns)`` on ``time.time_ns()``'s clock.
    ``use_profiler``: each phase is also a ``torch.profiler.record_function``
    range, so a profiler trace shows it.  ``block_on``: a tensor whose
    device's queue is synchronized before the phase's clock stops (CUDA
    returns before the work is done).  ``counters`` sums ``count``'s values;
    tensors are kept on their device and summed there by ``read_counters``
    (``tracing()`` calls it once, as it closes)."""

    def __init__(self, use_profiler: bool = False):
        self.use_profiler = use_profiler
        self.counters: dict[str, float] = {}
        self._on_device: dict[str, list] = defaultdict(list)
        # the records, one field a list (no object a record), and the open ranges
        self._names: list[str] = []
        self._parents: list[int] = []
        self._starts: list[int] = []
        self._ends: list[int] = []
        self._stack: list[int] = []
        self._ranges: list = []
        self._spans: dict[str, _Span] = {}
        self._gc_start = 0

    @property
    def records(self) -> list[tuple]:
        return list(zip(self._names, self._parents, self._starts, self._ends))

    def _on_gc(self, phase: str, info: dict):
        """``gc.callbacks`` hook: each collection becomes a ``python.gc`` range."""
        if phase == "start":
            self._gc_start = time.time_ns()
        else:
            self._parents.append(self._stack[-1] if self._stack else -1)
            self._names.append("python.gc")
            self._starts.append(self._gc_start)
            self._ends.append(time.time_ns())

    def span(self, name: str) -> _Span:
        """The range ``name``, shown as ``pixie.<name>`` (one object a name)."""
        s = self._spans.get(name)
        if s is None:
            s = self._spans[name] = _Span(self, name, f"pixie.{name}")
        return s

    def phase(self, name: str, block_on=None):
        return _Span(self, name, name if self.use_profiler else None, block_on)

    def count(self, name: str, value):
        if isinstance(value, torch.Tensor):
            self._on_device[name].append(value.detach().reshape(()))
        else:
            self.counters[name] = self.counters.get(name, 0) + value

    def read_counters(self):
        """Adds the tensors ``count`` kept to ``counters``: one read each."""
        for name, values in self._on_device.items():
            self.counters[name] = self.counters.get(name, 0) + torch.stack(values).sum().item()
        self._on_device.clear()

    @property
    def time_profile(self) -> dict[str, list[float]]:
        """Seconds of each range, by name (the reference's ``time_profile``)."""
        out: dict[str, list[float]] = defaultdict(list)
        for name, t0, t1 in zip(self._names, self._starts, self._ends):
            out[name].append((t1 - t0) * 1e-9)
        return out

    def print_time_profile(self):
        logging.info("MPM Time profile:")
        for key, v in self.summary().items():
            logging.info("  %s: %.4fs (%d calls)", key, v["total_s"], v["calls"])

    def summary(self) -> dict:
        """By name: calls, the ranges' host seconds, and their self seconds
        (less the ranges opened inside them)."""
        dur = [(t1 - t0) * 1e-9 for t0, t1 in zip(self._starts, self._ends)]
        own = list(dur)
        for parent, d in zip(self._parents, dur):
            if parent >= 0:
                own[parent] -= d
        out: dict = {}
        for name, d, self_s in zip(self._names, dur, own):
            s = out.setdefault(name, {"calls": 0, "total_s": 0.0, "self_s": 0.0})
            s["calls"] += 1
            s["total_s"] += d
            s["self_s"] += self_s
        return out


def span(name: str):
    """A range of the program, recorded by the open ``tracing()`` (and shown
    in a profiler trace as ``pixie.<name>``); without one, a shared no-op."""
    t = _TRACER
    return _OFF if t is None else t.span(name)


def count(name: str, value):
    """Adds ``value`` (a number, or a one-element tensor summed on its device)
    to the open ``tracing()``'s counter ``name``; nothing without one."""
    t = _TRACER
    if t is not None:
        t.count(name, value)


def enabled() -> bool:
    """Whether a ``tracing()`` is open (for work done only to be counted)."""
    return _TRACER is not None


@contextlib.contextmanager
def tracing():
    """Turns the program's spans and counters on, with Python's garbage
    collections as ``python.gc`` ranges; yields the ``PhaseTimer`` that
    records them and reads its device counters once, as it closes."""
    global _TRACER
    if _TRACER is not None:
        raise RuntimeError("tracing() is already open")
    timer = PhaseTimer(use_profiler=True)
    _TRACER = timer
    gc.callbacks.append(timer._on_gc)
    try:
        yield timer
    finally:
        gc.callbacks.remove(timer._on_gc)
        _TRACER = None
        timer.read_counters()


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
