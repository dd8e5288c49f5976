"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to a cell is found by name:

  * ``configs/<config>.json``     the configuration (the ``file`` of its entry);
  * ``traffic/<traffic>.json``    the traffic mix; its ``driver`` names the
                                  module ``drivers/<driver>.py`` that runs it;
  * ``limits/<workload>.json``    the limit of each number ``check`` compares;
  * ``metrics/<metric>.py``       one reader per metric, ``read(run)``, which
                                  returns the value or None.

A run: set-up (the traffic driver's ``Cell``), then the window: units of traffic
(``Cell.step``) until ``--seconds`` have passed and the cell's ``min_units``
are done; then the comparison with the plain reference (``Cell.check``), and
one JSON line.  With ``--trace 1`` the window has three parts instead
(``_traced_window``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# whole top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "pixie_tpu")


class BenchError(Exception):
    """A run that cannot print a result; the message says why."""


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cfg: dict
    setup_s: float
    window_s: float         # from the window's start to the end of its last unit; with
                            # --trace 1, of its untraced part
    work: int               # work done in that time (substeps, grids)
    trace: object = None    # trace.TraceSummary of a --trace 1 run


def cache_env() -> dict:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run there builds and compiles (the port's nvcc libraries already
    live in build/pixie_tpu_torch/, ops/build.py)."""
    return {"TRITON_CACHE_DIR": str(ROOT / "build" / "triton"),
            "TORCH_EXTENSIONS_DIR": str(ROOT / "build" / "torch_extensions"),
            "CUDA_CACHE_PATH": str(ROOT / "build" / "cuda_cache"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def resolve(spec: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]

    def applies(m):
        return workload in m.get("workloads", [workload])

    return dict(cell=cell,
                cfg=json.loads((ROOT / conf["file"]).read_text()),
                traffic=json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
                limits=json.loads((BENCH / "limits" / f"{workload}.json").read_text()),
                end_to_end=[m for m in spec["end_to_end"] if applies(m)],
                per_layer=[m for m in spec["per_layer"] if applies(m)])


def reader(name: str):
    """``read`` of ``metrics/<name>.py`` (loaded by path: names hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             spec: dict | None = None, overrides: dict | None = None,
             control: str | None = None, fault: str | None = None) -> dict:
    """One run of a cell on ``device``; returns the result object.
    ``overrides`` ({"config": {...}, "traffic": {...}, "limits": {...}})
    resize a cell for the CPU tests; ``control`` puts the reference at a lower precision in
    the program's place for the comparison, and ``fault`` plants the driver's fault of that
    name in the window's timed path (``control.py``)."""
    import torch

    r = resolve(spec or load_spec(), workload)
    cfg, traffic = r["cfg"], r["traffic"]
    for key, part in (overrides or {}).items():
        {"config": cfg, "traffic": traffic, "limits": r["limits"]}[key].update(part)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    drv = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    if "host_threads" in traffic:
        torch.set_num_threads(int(traffic["host_threads"]))
    cell = drv.Cell(cfg, traffic, seed, device)
    min_units = getattr(cell, "min_units", 1)
    unit_s: list = []

    def units_of(n: int) -> int:
        work = 0
        for _ in range(n):
            u0 = time.perf_counter()
            work += cell.step()
            unit_s.append(time.perf_counter() - u0)
        return work

    summary = None
    with contextlib.ExitStack() as planted:
        if fault is not None:
            planted.enter_context(drv.FAULTS[fault](cell))
        if trace:
            work, (t0, t1), summary = _traced_window(cell, traffic, units_of, min_units,
                                                     on_card)
        else:
            t0 = time.perf_counter()
            work = 0
            while True:            # at least min_units units, then until --seconds
                work += units_of(1)
                if len(unit_s) >= min_units and time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
    units = len(unit_s)
    run = Run(cfg, t0 - t_start, t1 - t0, work, summary)
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if on_card else 0}
    if on_card:
        dev["power_limit_w"] = _power_limit()
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)

    checks = cell.check(control)
    del cell
    missing = sorted(set(checks) - set(r["limits"]))
    if missing:
        raise BenchError(f"limits/{workload}.json has no limit for {missing}")
    over = [k for k, v in checks.items() if not (math.isfinite(v) and v <= r["limits"][k])]
    bad = forbidden_modules()
    if bad:
        raise BenchError(f"modules loaded in the benchmark's process: {bad}")

    metrics = {}
    for m in (r["per_layer"] if trace else r["end_to_end"]):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": not over, "attempted": units, "failed": len(over),
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["unit_s"] = unit_s
    result["checks"] = {k: {"value": v, "limit": r["limits"][k]} for k, v in checks.items()}
    return result


def _traced_window(cell, traffic: dict, units_of, min_units: int, on_card: bool):
    """The window of a --trace 1 run, in three parts: (1) the traffic's
    ``trace_units`` (at least ``min_units``) untraced, timed on the host
    clock; (2) as many units under torch.profiler with the device's activity
    alone: busy time, kernels, launches (even this slows a launch-bound
    host, so the readers divide by part 1's time); (3) ``name_units``
    calls of the cell's ``name_step`` (a shorter unit, where it has one)
    under the profiler with the host's activity too, only to name the
    device's idle gaps by what the host was doing (the host's recorded
    operations slow it there).
    Returns part 1's work and (start, end), and the summary of part 2 with
    the idle gaps of part 3."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace as trace_mod

    n = int(traffic["trace_units"])
    t0 = time.perf_counter()
    work = units_of(max(n, min_units))
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
        s0 = time.perf_counter()
        traced_work = units_of(n)
        s1 = time.perf_counter()
    summary = trace_mod.summarize(prof, s1 - s0, traced_work)
    del prof
    name_step = getattr(cell, "name_step", cell.step)
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
        for _ in range(int(traffic["name_units"])):
            with record_function(f"{trace_mod.SPAN_PREFIX}{cell.work_name}"):
                name_step()
    summary.idle_gaps = trace_mod.idle_gaps(prof)
    return work, (t0, t1), summary


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(cache_env())
    try:
        spec = load_spec()
        chips = resolve(spec, args.workload)["cell"]["chips"]
        import pixie_tpu_torch
        import torch

        if not Path(pixie_tpu_torch.__file__).resolve().is_relative_to(ROOT):
            raise BenchError(f"pixie_tpu_torch comes from {pixie_tpu_torch.__file__}, "
                             f"not from this checkout ({ROOT})")
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise BenchError(f"the cell needs {chips} CUDA device(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                          t_start, spec)
    except BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
