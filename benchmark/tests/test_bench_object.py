"""CPU tests of the object cell (``tree_object.rollout``,
``drivers/object_rollout.py``): through ``harness.run_cell`` at a tiny size
the cell is correct, and the bfloat16 control, each planted fault and a
wrong set-up are not; the cell sets up through ``run_simulation``'s own set-up; the reference
imports nothing of the program; the grid stage's reader.

    python -m pytest benchmark/tests -q

The tiny size: 3000 particles, n_grid 16, frames (the set-up's too) of 20
substeps, the impulse 100 times the class config's, so that motion and not
float32's rounding of x fills the frames.  Its limits lie between its own
readings (seed below): the program's / the smallest of the bfloat16
control's and the faults' that cross it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness, trace
from benchmark.drivers import object_rollout

ROOT = Path(__file__).resolve().parents[2]
CELL = "tree_object.rollout"
SEED = 2**31 + 977
_CFG = json.loads((ROOT / "benchmark" / "configs" / "tree_object.json").read_text())
TINY = {"config": {"n_particles": 3000, "n_grid": 16, "substeps_per_frame": 20,
                   "boundary_conditions": [dict(_CFG["boundary_conditions"][0],
                                                force=[-48.0, 0.0, 0.0])]},
        "traffic": {"setup_frame_substeps": 20},
        # x 9.3e-6 / 0.037 cells; v 1.8e-5 / 0.065; C 1.1e-4 / 0.20; F 2.3e-6 / 1.0e-4;
        # dx 1.5e-3 / 0.075; the set-up frame: x 5.5e-6 / 0.038, v 1.7e-5 / 0.043, F 1.9e-6 /
        # 1.7e-3; the set-up: x 7.2e-7 / 0.060 cells, volumes 0 / 0.98, material ids 0 /
        # 1.3e-3 (k = 1, below), density, E, nu 3.3e-4 (one particle's kNN near a tie) / 1,
        # cuboids 6.3e-7 / 0.057 cells
        "limits": {"x_gap.impulse": 2e-4, "v_gap.impulse": 1e-3, "F_gap.impulse": 3e-5,
                   "x_gap": 2e-4, "v_gap": 1e-3, "C_gap": 3e-3, "F_gap.jelly": 3e-5,
                   "F_gap.metal": 3e-5, "F_gap.stationary": 3e-5, "dx_gap": 0.02,
                   "setup.x_gap": 1e-4, "setup.vol_share": 0.01, "setup.material_share": 5e-4,
                   "setup.param_share": 0.01, "setup.cuboid_gap": 1e-3}}


def run_tiny(control=None, fault=None) -> dict:
    overrides = {k: json.loads(json.dumps(v)) for k, v in TINY.items()}
    return harness.run_cell(CELL, SEED, 0.0, False, "cpu", time.perf_counter(),
                            overrides=overrides, control=control, fault=fault)


def test_cell_is_correct_at_a_tiny_size():
    res = run_tiny()
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(TINY["limits"])
    assert res["attempted"] == 2 and res["unit_s"] and "setup_s" in res["metrics"]


@pytest.mark.parametrize("what", ["bfloat16", *object_rollout.FAULTS])
def test_control_and_each_fault_are_not_correct(what):
    res = run_tiny(**({"control": what} if what == "bfloat16" else {"fault": what}))
    assert not res["correct"], res["checks"]


def _knn_of_one(monkeypatch):
    from pixie_tpu_torch.sim import material_field

    real = material_field.knn
    monkeypatch.setattr(material_field, "knn",
                        lambda query, ref, k=10, device="cpu": real(query, ref, 1, device))


def _no_stationary_cuboid(monkeypatch):
    from pixie_tpu_torch.sim import material_field

    monkeypatch.setattr(material_field, "handle_stationary_clusters", lambda *a, **k: [])


def _uniform_volumes(monkeypatch):
    from pixie_tpu_torch.sim import driver

    monkeypatch.setattr(driver, "get_particle_volume",
                        lambda pos, n, dx, uniform=False: np.full(len(pos), 1.0 / len(pos),
                                                                  np.float32))


@pytest.mark.parametrize("fault", [_knn_of_one, _no_stationary_cuboid, _uniform_volumes],
                         ids=["knn_of_one", "no_stationary_cuboid", "uniform_volumes"])
def test_set_up_faults_are_not_correct(monkeypatch, fault):
    """A wrong material field or particle volume in the set-up, which the
    window's frames take as given, reads as not correct."""
    fault(monkeypatch)
    res = run_tiny()
    assert not res["correct"], res["checks"]
    assert any(v["value"] > v["limit"] for k, v in res["checks"].items()
               if k.startswith("setup.")), res["checks"]


def test_cell_sets_up_through_run_simulations_set_up(monkeypatch):
    from pixie_tpu_torch.sim import driver

    calls = []
    real = driver.setup_simulation
    monkeypatch.setattr(driver, "setup_simulation",
                        lambda *a, **k: calls.append(k.get("device")) or real(*a, **k))
    r = harness.resolve(harness.load_spec(), CELL)
    cfg, traffic = r["cfg"], r["traffic"]
    cfg.update(TINY["config"], n_particles=500)
    traffic.update(TINY["traffic"], warm_frames=0)
    cell = object_rollout.Cell(cfg, traffic, SEED, "cpu")
    assert len(calls) == 1 and cell.solver.state.n_particles == 500
    assert {b["type"] for b in cell.cuboids} >= {"ground"}


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.mpm_object\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'pixie_tpu_torch', 'pixie_tpu', 'jax', 'jaxlib', 'flax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_grid_stage_reader_leaves_out_the_particle_kernels():
    read = harness.reader("grid_ms_per_substep.tree")
    kernels = {"p2g_keys_kernel(x)": [4, 1e-3], "DeviceRadixSortOnesweepKernel": [8, 2e-3],
               "p2g_binned_kernel(x)": [4, 3e-3], "g2p_kernel(x)": [4, 1e-3],
               "constitutive_kernel<1>": [4, 2e-3], "elementwise_kernel(where)": [40, 4e-3],
               "CatArrayBatchedCopy": [4, 1e-3], "Memcpy DtoH": [1, 5e-3]}
    summary = trace.TraceSummary(window_s=0.1, work=4, busy_s=0.02, launches=68,
                                 kernels=kernels)
    run = harness.Run(cfg={}, setup_s=1.0, window_s=0.1, work=4, trace=summary)
    assert read(run) == pytest.approx(1e3 * 5e-3 / 4)
    assert read(harness.Run(cfg={}, setup_s=1.0, window_s=0.1, work=4)) is None
