"""The program's spans (``pixie_tpu_torch.utils.observability``) against a
profiler trace of the host and the device: each device activity is charged
to the innermost span that holds its launch, each idle gap of the device to
the innermost span at its middle.

A kernel (or copy) is tied to its launch by correlation id: the runtime
event (``cudaLaunchKernel``, ``cudaMemcpyAsync``, a driver call) that shares
the activity's ``correlation_id()``; failing that, the host operation whose
id is the activity's ``linked_correlation_id()``.  The launch's host time
and the spans' stamps share one clock (Unix-epoch nanoseconds), so the
span is found by time.

    python3 benchmark/spans.py --workload <cell> --seed <n> --block <units> --pairs <k>

sets a cell up as ``run.py`` does, then (1) ``k`` pairs of blocks of
``units`` untraced units, one with the tracer off and one with it on, in
turns (which goes first alternates): the tracer's cost, and Python's
collections in each unit; (2) the traffic's ``name_units`` calls of the
driver's ``name_step`` (the host-traced part of a ``--trace 1`` run) with
the tracer on, under ``torch.profiler`` with the host's and the device's
activity.  It prints one JSON line.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.trace import _busy_and_gaps  # noqa: E402

# device activity of this name is a range's shadow on the device, not work
_SHADOWS = ("bench.", "pixie.")
# the host's CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...), which share their device activity's correlation id
_LAUNCH = "cu"


def scan(prof):
    """The device's activities of a profiler that traced host and device,
    sorted by start: ``(start_ns, end_ns, launch_ns or None)``."""
    launches, ops, dev = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            if not e.name().startswith(_SHADOWS):
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
                            e.linked_correlation_id()))
        elif e.name().startswith(_LAUNCH):
            launches[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = e.start_ns()
    dev.sort()
    return [(s, e, launches.get(c, ops.get(linked))) for s, e, c, linked in dev]


def innermost(records, starts, t) -> int:
    """Index of the innermost record (``[name, parent, start, end]``, nested,
    in the order they opened; ``starts`` their starts) that holds ``t``; -1
    where none does.  The ranges nest, so it is the last one opened by
    ``t`` or one of its parents."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and records[i][3] < t:
        i = records[i][1]
    return i


def charge(records, dev, gaps) -> dict:
    """By span name: the device seconds of the activities whose launch it
    holds innermost, and the idle seconds of the gaps whose middle it holds
    innermost; the rest under ``None``."""
    starts = [r[2] for r in records]
    out: dict = defaultdict(lambda: {"device_s": 0.0, "idle_s": 0.0})
    for s, e, at in dev:
        i = -1 if at is None else innermost(records, starts, at)
        out[records[i][0] if i >= 0 else None]["device_s"] += (e - s) * 1e-9
    for s, e in gaps:
        i = innermost(records, starts, (s + e) // 2)
        out[records[i][0] if i >= 0 else None]["idle_s"] += (e - s) * 1e-9
    return dict(out)


def span_table(timer, dev) -> dict:
    """By span name: calls, host_s, self_s (the tracer's) and device_s,
    idle_s (``charge`` of the activities ``dev``, as ``scan`` gives them);
    ``None`` holds what no span holds."""
    _, gaps = _busy_and_gaps(dev)
    table = {name: {"calls": v["calls"], "host_s": v["total_s"], "self_s": v["self_s"],
                    "device_s": 0.0, "idle_s": 0.0} for name, v in timer.summary().items()}
    for name, v in charge(timer.records, dev, gaps).items():
        table.setdefault(name, {"calls": 0, "host_s": 0.0, "self_s": 0.0,
                                "device_s": 0.0, "idle_s": 0.0}).update(v)
    return table


def readings(table: dict, counters: dict, work: int) -> dict:
    """The per-layer numbers these spans give: device ms a substep of the
    constitutive pass and of the grid stage, B6's mean run length, and the
    idle ms a grid under the host's post-processing (None where absent)."""
    def per_unit(names, key):
        s = sum(table[n][key] for n in names if n in table)
        return 1e3 * s / work if work and any(n in table for n in names) else None

    runs = counters.get("fused.runs")
    return {"constitutive_ms_per_substep": per_unit(["sim.constitutive"], "device_s"),
            "grid_ms_per_substep": per_unit(["sim.grid"], "device_s"),
            "fused_run_length": counters["fused.live_lanes"] / runs if runs else None,
            "post_idle_ms_per_grid": per_unit(["material.post", "material.unscale"], "idle_s")}


def name_trace(cell, traffic: dict, on_card: bool) -> dict:
    """The traffic's ``name_units`` calls of ``name_step`` with the tracer
    on, under the profiler (host and device): the span table, counters,
    work, the device's busy and total activity seconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from pixie_tpu_torch.utils import observability as obs

    step = getattr(cell, "name_step", cell.step)
    work = 0
    with obs.tracing() as timer:
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
            for _ in range(int(traffic["name_units"])):
                with record_function(f"bench.{cell.work_name}"):
                    work += step()
    dev = scan(prof)
    del prof
    table = span_table(timer, dev)
    busy, _ = _busy_and_gaps(dev)
    return {"spans": table, "counters": dict(timer.counters), "spans_work": work,
            "busy_s": busy * 1e-9, "device_s": sum(e - s for s, e, _ in dev) * 1e-9,
            "readings": readings(table, timer.counters, work)}


def tracer_pairs(cell, block: int, pairs: int) -> dict:
    """``pairs`` pairs of ``block`` untraced units with the tracer off and
    on, in turns (which goes first alternates): each block's work a second,
    the tracer's cost (1 - the median of each pair's on/off ratio) with the
    quartile spread of those ratios, and each on unit's seconds beside its
    Python collections' seconds."""
    from pixie_tpu_torch.utils import observability as obs

    rates: dict = {"off": [], "on": []}
    units = []                          # (seconds, gc seconds) of each unit with the tracer on
    for k in range(pairs):
        for side in (("off", "on") if k % 2 == 0 else ("on", "off")):
            stamps = []
            t0 = time.perf_counter()
            work = 0
            with obs.tracing() if side == "on" else contextlib.nullcontext() as timer:
                for _ in range(block):
                    u0 = time.time_ns()
                    work += cell.step()
                    stamps.append((u0, time.time_ns()))
            rates[side].append(work / (time.perf_counter() - t0))
            if timer is not None:
                gcs = [(s, e) for name, _, s, e in timer.records if name == "python.gc"]
                units += [((u1 - u0) * 1e-9, sum(e - s for s, e in gcs if u0 <= s < u1) * 1e-9)
                          for u0, u1 in stamps]
    ratios = [on / off for on, off in zip(rates["on"], rates["off"])]
    out = {"block": block, "rates": rates, "on_cost": 1.0 - statistics.median(ratios),
           "ratio_spread": _spread(ratios), "unit_s_and_gc_s": units}
    for side, v in rates.items():
        out[f"{side}_median"], out[f"{side}_spread"] = statistics.median(v), _spread(v)
    return out


def _spread(v) -> float:
    """Quartile distance over the median."""
    if len(v) < 2:
        return 0.0
    q = statistics.quantiles(v, n=4)
    return (q[2] - q[0]) / q[1]


def main(argv=None) -> int:
    import argparse

    import torch

    from benchmark import harness

    ap = argparse.ArgumentParser(description="A cell's device time by the program's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--block", type=int, default=1)
    ap.add_argument("--pairs", type=int, default=0)
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_env())
    if not torch.cuda.is_available():
        print("spans: needs a CUDA card", file=sys.stderr)
        return 2
    r = harness.resolve(harness.load_spec(), args.workload)
    traffic = r["traffic"]
    if "host_threads" in traffic:
        torch.set_num_threads(int(traffic["host_threads"]))
    drv = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    torch.cuda.set_device(0)
    cell = drv.Cell(r["cfg"], traffic, args.seed, "cuda:0")
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), "power_limit_w": harness._power_limit()}
    if args.pairs:
        out["pairs"] = tracer_pairs(cell, args.block, args.pairs)
    out.update(name_trace(cell, traffic, on_card=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
