"""CPU tests of the filled sand cell (``sand_castle.rollout``,
``drivers/filled_rollout.py``): through ``harness.run_cell`` at a tiny size
the cell is correct, and the bfloat16 control, each planted fault and each
wrong set-up are not; the driver writes the set-up's particle count into
the configuration; the reference imports nothing of the program; the two
grid readers.

    python -m pytest benchmark/tests/test_bench_sand.py -q

The tiny size: a ball of sand in place of the castle (eight fill cells
across), 3000 gaussians in a shell 0.15 deep with log-scales about log
0.05, fill grid and n_grid 16, frames (the set-up's too) of 20 substeps,
gravity 100 times the class config's, so that motion and not float32's
rounding of x and F fills the frames.  Its limits lie between its own
readings (seed below): the program's / the smallest of the bfloat16
control's and the faults' that cross it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import grid_counts, harness, trace
from benchmark.drivers import filled_rollout

ROOT = Path(__file__).resolve().parents[2]
CELL = "sand_castle.rollout"
SEED = 2**31 + 977
_CFG = json.loads((ROOT / "benchmark" / "configs" / "sand_castle.json").read_text())
BALL = {"name": "ball", "material": "sand", "id": 2, "density": [1800, 2200], "E": [4e7, 6e7],
        "nu": [0.28, 0.32], "shape": "ellipsoid", "center": [0.0, 0.0, 0.5],
        "radii": [0.5, 0.5, 0.5]}
TINY = {"config": {"n_gaussians": 3000, "n_grid": 16, "substeps_per_frame": 20, "shell": 0.15,
                   "scale": 0.05, "g": [0.0, 0.0, -980.0], "parts": [BALL], "voxel_grid": 24,
                   "particle_filling": dict(_CFG["particle_filling"], n_grid=16)},
        "traffic": {"setup_frame_substeps": 20},
        # frame 0: x 1.5e-6 / 0.032 cells, v 1.4e-4 / 0.018, F 4.0e-6 / 3.1e-4; the checked
        # frame: x 6.6e-6 / 3.2e-3 (state unchanged), v 6.1e-5 / 0.046 (sand as jelly), C
        # 2.0e-4 / 0.15, F 9.6e-6 / 2.2e-4 (sand as jelly), dx 1.5e-3 / 0.028 (sand as
        # jelly); the set-up: filled cells 0 / one cell of 39 is 0.026, x 8.3e-7 / 0.064
        # cells, volumes 0 / 1.0, material ids 0 / 0 (none but sand), density, E, nu 0 / 1.0,
        # cuboids 8.1e-7 / 0.020 cells
        "limits": {"x_gap.frame0": 2e-4, "v_gap.frame0": 1e-3, "F_gap.frame0": 2e-5,
                   "x_gap": 2e-4, "v_gap": 1e-3, "C_gap": 3e-3, "F_gap.sand": 3e-5,
                   "dx_gap": 0.01, "setup.fill_share": 0.01, "setup.x_gap": 1e-4,
                   "setup.vol_share": 0.01, "setup.material_share": 5e-4,
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


@pytest.mark.parametrize("what", ["bfloat16", *filled_rollout.FAULTS])
def test_control_and_each_fault_are_not_correct(what):
    res = run_tiny(**({"control": what} if what == "bfloat16" else {"fault": what}))
    assert not res["correct"], res["checks"]


def _no_internal_fill(monkeypatch):
    import torch

    from pixie_tpu_torch.sim import filling

    monkeypatch.setattr(filling, "internal_cells_mask",
                        lambda count, *a, **k: torch.zeros(tuple(count.shape), dtype=torch.bool))


def _parity_ignored(monkeypatch):
    from pixie_tpu_torch.sim import filling

    real = filling.internal_cells_mask
    monkeypatch.setattr(filling, "internal_cells_mask",
                        lambda count, density, thr, exclude, ray, device: real(
                            count, density, thr, exclude, -1, device=device))


def _per_cell_volumes(monkeypatch):
    from pixie_tpu_torch.sim import driver

    real = driver.get_particle_volume
    monkeypatch.setattr(driver, "get_particle_volume",
                        lambda pos, n, dx, uniform=False: real(pos, n, dx, uniform=False))


@pytest.mark.parametrize("fault", [_no_internal_fill, _parity_ignored, _per_cell_volumes],
                         ids=["no_internal_fill", "parity_ignored", "per_cell_volumes"])
def test_set_up_faults_are_not_correct(monkeypatch, fault):
    """A wrong filling or particle volume in the set-up, which the window's
    frames take as given, reads as not correct."""
    fault(monkeypatch)
    res = run_tiny()
    assert not res["correct"], res["checks"]
    assert any(v["value"] > v["limit"] for k, v in res["checks"].items()
               if k.startswith("setup.")), res["checks"]


def test_driver_writes_the_particle_count_into_the_configuration():
    r = harness.resolve(harness.load_spec(), CELL)
    cfg, traffic = r["cfg"], r["traffic"]
    assert "n_particles" not in cfg
    cfg.update(json.loads(json.dumps(TINY["config"])))
    traffic.update(TINY["traffic"], setup_frame_substeps=2, warm_frames=0)
    cell = filled_rollout.Cell(cfg, traffic, SEED, "cpu")
    assert cfg["n_particles"] == cell.solver.state.n_particles > cell.gs_num == 3000


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.mpm_filled, benchmark.drivers.filled_rollout\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'pixie_tpu_torch', 'pixie_tpu', 'jax', 'jaxlib', 'flax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(kernels, n_grid=200):
    summary = trace.TraceSummary(window_s=0.1, work=4, busy_s=0.02, launches=68,
                                 kernels=kernels)
    return harness.Run(cfg={"n_grid": n_grid}, setup_s=1.0, window_s=0.1, work=4,
                       trace=summary)


def test_grid_readers():
    kernels = {"p2g_keys_kernel(x)": [4, 1e-3], "DeviceRadixSortOnesweepKernel": [8, 2e-3],
               "p2g_binned_kernel(x)": [4, 3e-3], "g2p_kernel(x)": [4, 1e-3],
               "constitutive_kernel<1>": [4, 2e-3], "grid_stage_kernel(float)": [4, 8e-4],
               "vectorized_elementwise_kernel(FillFunctor)": [4, 4e-4],
               "Memset (Device)": [8, 2e-4], "Memcpy DtoD (Device -> Device)": [1, 5e-3]}
    ms = harness.reader("grid_ms_per_substep.sand")
    assert ms(_run(kernels)) == pytest.approx(1e3 * (8e-4 + 4e-4 + 2e-4) / 4)
    roof = harness.reader("grid_roofline.sand")
    assert roof(_run(kernels)) == pytest.approx(
        100.0 * 28 * 200 ** 3 / 3.35e12 / (8e-4 / 4))
    assert grid_counts.grid_least_time(200) == pytest.approx(28 * 8e6 / 3.35e12)
    del kernels["grid_stage_kernel(float)"]
    assert roof(_run(kernels)) is None
    for read in (ms, roof):
        assert read(harness.Run(cfg={"n_grid": 200}, setup_s=1.0, window_s=0.1, work=4)) is None
