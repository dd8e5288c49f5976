"""CPU tests of ``benchmark/spans.py``: device activities charged to the
program's spans through their launches' correlation ids, idle gaps to the
span at their middle, the readings, and a tiny traced run of each cell.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import harness, spans

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 977
TINY = {"scene_500k.rollout": {"config": {"n_particles": 3000, "n_grid": 24,
                                          "substeps_per_frame": 40},
                               "traffic": {"name_substeps": 20}},
        "scene_500k.fused": {"config": {"n_particles": 3000, "n_grid": 24,
                                        "substeps_per_frame": 40},
                             "traffic": {"name_substeps": 25}},
        "tree_neural.material": {"config": {"grid_size": 16, "feature_channels": 48,
                                            "model_channels": 8, "num_res_blocks": 1,
                                            "channel_mult": [1, 2]},
                                 "traffic": {"pool": 2, "name_units": 2}}}


class Ev:
    """A kineto event as ``spans.scan`` reads it."""

    def __init__(self, device, name, start, dur, corr=0, linked=0):
        self.device, self._name = device, name
        self.start, self.dur, self.corr, self.linked = start, dur, corr, linked

    def device_type(self):
        return f"DeviceType.{self.device}"

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


def _prof(events):
    return type("P", (), {"profiler": type("K", (), {
        "kineto_results": type("R", (), {"events": lambda self: events})()})()})()


# the tracer's records: a frame [0, 1000] holding grid [100, 200] and fused [300, 400]
RECORDS = [["sim.frame", -1, 0, 1000], ["sim.grid", 0, 100, 200], ["sim.fused", 0, 300, 400]]
EVENTS = [
    # launched inside the grid stage (runtime event 7), run after it closed
    Ev("CPU", "cudaLaunchKernel", 150, 10, corr=7, linked=2),
    Ev("CUDA", "grid_kernel", 500, 100, corr=7, linked=2),
    # no runtime event: tied through its linked host operation (id 3, at 350)
    Ev("CPU", "aten::add", 350, 20, corr=3),
    Ev("CUDA", "fused_kernel", 650, 50, corr=8, linked=3),
    # launched after the frame closed
    Ev("CPU", "cudaLaunchKernel", 1500, 10, corr=9),
    Ev("CUDA", "late_kernel", 1600, 30, corr=9),
    # a range's shadow on the device is no work
    Ev("CUDA", "pixie.sim.grid", 500, 100),
]


def test_scan_ties_each_activity_to_its_launch():
    assert spans.scan(_prof(EVENTS)) == [(500, 600, 150), (650, 700, 350), (1600, 1630, 1500)]


@pytest.mark.parametrize("t, want", [(150, "sim.grid"), (350, "sim.fused"), (250, "sim.frame"),
                                     (1000, "sim.frame"), (1500, None), (-5, None)])
def test_innermost_span_at_a_time(t, want):
    i = spans.innermost(RECORDS, [r[2] for r in RECORDS], t)
    assert (RECORDS[i][0] if i >= 0 else None) == want


def test_activities_and_gaps_are_charged_to_spans():
    dev = spans.scan(_prof(EVENTS))
    got = spans.charge(RECORDS, dev, [(600, 650), (700, 1600)])
    assert got["sim.grid"]["device_s"] == pytest.approx(100e-9)
    assert got["sim.fused"]["device_s"] == pytest.approx(50e-9)
    assert got[None]["device_s"] == pytest.approx(30e-9)          # outside every span
    # a gap goes to the span at its middle: 625 in the frame alone, 1150 in none
    assert got["sim.frame"]["idle_s"] == pytest.approx(50e-9)
    assert got[None]["idle_s"] == pytest.approx(900e-9)
    assert got["sim.grid"]["idle_s"] == got["sim.fused"]["idle_s"] == 0.0


def test_readings_of_a_span_table():
    table = {"sim.constitutive": {"device_s": 0.2, "idle_s": 0.0},
             "sim.grid": {"device_s": 0.01, "idle_s": 0.0},
             "material.post": {"device_s": 0.0, "idle_s": 0.03},
             "material.unscale": {"device_s": 0.0, "idle_s": 0.01}}
    got = spans.readings(table, {"fused.live_lanes": 900, "fused.runs": 300}, 10)
    assert got == pytest.approx({"constitutive_ms_per_substep": 20.0, "grid_ms_per_substep": 1.0,
                                 "fused_run_length": 3.0, "post_idle_ms_per_grid": 4.0})
    assert set(spans.readings({}, {}, 10).values()) == {None}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_tiny_traced_run_holds_the_programs_spans(cell):
    import importlib

    import torch

    r = harness.resolve(SPEC, cell)
    cfg, traffic = r["cfg"], r["traffic"]
    cfg.update(TINY[cell]["config"])
    traffic.update(TINY[cell]["traffic"])
    drv = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    got = spans.name_trace(drv.Cell(cfg, traffic, SEED, torch.device("cpu")), traffic,
                           on_card=False)
    calls = {k: v["calls"] for k, v in got["spans"].items() if k not in ("python.gc", None)}
    units = int(traffic["name_units"])
    if cell == "tree_neural.material":
        assert got["spans_work"] == units
        assert calls == {"unet.forward": units, "material.post": units,
                         "material.unscale": units}
    elif cell == "scene_500k.fused":
        s = int(traffic["name_substeps"])
        assert got["spans_work"] == units * s
        assert calls == {"sim.frame": units, "sim.constitutive": units, "sim.p2g": units,
                         "sim.grid": units * s, "sim.fused": units * (s - 1),
                         "sim.run_length": units * 3, "sim.g2p": units}
        assert 1.0 <= got["readings"]["fused_run_length"] <= 32.0
    else:
        s = int(traffic["name_substeps"])
        assert got["spans_work"] == units * s
        assert calls == {"sim.frame": units, **{k: units * s for k in (
            "sim.particle_bc", "sim.constitutive", "sim.p2g", "sim.grid", "sim.g2p")}}
    # the CPU has no device activity to charge
    assert got["busy_s"] == got["device_s"] == 0.0
    assert all(v["device_s"] == 0.0 for v in got["spans"].values())
