"""The filled sand object on the normal neural GS path, on the CPU:
``setup_simulation`` with the sand class's ``particle_filling`` and a
rollout of a small castle against the plain reference
``benchmark/reference/mpm_filled.py``; the set-up, filled cells included,
against the reference's recomputation from the same seeded inputs, and
three wrong set-ups failing it; ``internal_cells_mask`` against the
reference's per-cell ray walk; the filling's span and counters.

The small object: ``benchmark/configs/sand_castle.json`` (the class
config's values) with a ball of sand in place of the castle (eight fill
cells across, where the castle's keep would be under two), 3000 gaussians
in a shell 0.15 deep (log-scales about log 0.05, so that their density
reaches the search threshold on a fill grid of 16), n_grid 16, frames of
20 substeps, and gravity 100 times the class config's, so that motion and
not float32's rounding of x and F fills the 20 substeps.

Tolerances of the rollout (float32 program, float64 reference; 20
substeps from rest), with what the program reads and what a bfloat16
reference reads (seed below):
  * x: 1e-4 cells.  Each substep rounds x (~1) to float32, 6e-8 of 0.125
    a cell; 20 of them are 1e-5 at worst (read 2.2e-6; bfloat16 0.032);
  * v: 1e-3 of the largest speed (read 1.4e-4; bfloat16 0.016);
  * C: 1e-2 of the largest entry: the affine field is a difference of
    nearby node velocities, so it keeps fewer of float32's digits (read
    3.9e-4; bfloat16 0.041);
  * F_trial of the sand: 2e-5, absolute about the identity, against
    changes of up to 3.1e-4: the return map projects the strain of a
    yielding particle, so float32's rounding of a strain this small moves
    F by ~1 % of it (read 4.0e-6; bfloat16 3.1e-4).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.drivers import filled_rollout as drv
from benchmark.reference import mpm_filled as ref
from benchmark.reference import mpm_object
from pixie_tpu_torch.sim import driver as tdriver
from pixie_tpu_torch.sim import filling as tfilling
from pixie_tpu_torch.sim.driver import setup_simulation
from pixie_tpu_torch.sim.params import decode_params
from pixie_tpu_torch.utils import observability as obs

REPO = Path(__file__).resolve().parent.parent
N, G, SUBSTEPS, SEED = 3000, 16, 20, 2**31 + 24
TOL = {"x": 1e-4, "v": 1e-3, "C": 1e-2, "F": 2e-5}
_REST = ("x", "material", "density", "E", "nu", "vol")


BALL = {"name": "ball", "material": "sand", "id": 2, "density": [1800, 2200], "E": [4e7, 6e7],
        "nu": [0.28, 0.32], "shape": "ellipsoid", "center": [0.0, 0.0, 0.5],
        "radii": [0.5, 0.5, 0.5]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the cell runs: on tensors of a few thousand
    rows more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**kw) -> dict:
    """The benchmark's sand object at a small size (see the module's docstring)."""
    cfg = json.loads((REPO / "benchmark" / "configs" / "sand_castle.json").read_text())
    cfg.update({"n_gaussians": N, "n_grid": G, "substeps_per_frame": SUBSTEPS, "shell": 0.15,
                "scale": 0.05, "g": [0.0, 0.0, -980.0], "parts": [BALL], "voxel_grid": 24,
                **kw})
    cfg["particle_filling"] = dict(cfg["particle_filling"], n_grid=G)
    return cfg


def _setup(cfg: dict):
    obj = drv.draw_filled(cfg, SEED)
    cls = dict(cfg, frame_dt=SUBSTEPS * cfg["substep_dt"])
    return obj, setup_simulation(obj["source"], decode_params(cls), obj["gaussians"],
                                 device="cpu")


@pytest.fixture(scope="module")
def rollout():
    """The port's set-up and its frame of 20 substeps from rest, and the
    reference's frame in float64 and bfloat16 from the same rest state and
    cuboids."""
    cfg = _config()
    _, sim = _setup(cfg)
    rest = {k: getattr(sim.solver.state, k).clone() for k in _REST}
    sim.solver.step_frame(SUBSTEPS, sim.substep_dt)
    prm = ref.params(cfg, sim.auto_bcs, "cpu")
    refs = {dt: ref.frame(mpm_object.initial_state(*(rest[k] for k in _REST), dtype=dt), prm,
                          0.0, SUBSTEPS)
            for dt in (torch.float64, torch.bfloat16)}
    return sim, rest, refs


def _gaps(got: dict, want: dict) -> dict:
    def gap(a, b):
        return float((a.double() - b.double()).abs().max())

    return {"x": gap(got["x"], want["x"]) * G / 2.0,
            "v": gap(got["v"], want["v"]) / float(want["v"].abs().max()),
            "C": gap(got["C"], want["C"]) / float(want["C"].abs().max()),
            "F": gap(got["F_trial"], want["F_trial"])}


def test_setup_fills_the_ball_and_holds_the_class_bcs(rollout):
    sim, rest, _ = rollout
    from pixie_tpu_torch.sim import bc as tbc

    gs_num = sim.gs_payload["gs_num"]
    assert gs_num == N and sim.n_particles > N                # filled particles follow
    assert sim.steps_per_frame == SUBSTEPS
    assert [type(b) for b in sim.solver.bcs] == [tbc.CuboidVelocity, tbc.BoundingBox,
                                                 tbc.SurfaceCollider]
    assert sim.solver.cfg.active_materials == (2,)
    assert torch.unique(rest["vol"]).numel() == 1              # sand: one volume
    # every filled particle lies inside the ball (world units)
    world = (rest["x"][gs_num:].double().numpy() - 1.0) / sim.scale_origin + sim.original_mean_pos
    assert (drv.object_rollout.part_of(_config()["parts"], world) >= 0).all()


@pytest.mark.parametrize("field", ["x", "v", "C", "F"])
def test_rollout_matches_the_reference(rollout, field):
    sim, _, refs = rollout
    got = {k: getattr(sim.solver.state, k) for k in ("x", "v", "C", "F_trial")}
    gaps = _gaps(got, refs[torch.float64])
    assert gaps[field] <= TOL[field], gaps


def test_bfloat16_reference_fails_the_tolerances(rollout):
    _, _, refs = rollout
    gaps = _gaps(refs[torch.bfloat16], refs[torch.float64])
    assert all(v > TOL[k] for k, v in gaps.items()), gaps


# -- the set-up against the reference's ---------------------------------------------------

# the set-up's tolerances: the filled cells none apart (read 0 of 39; a
# cell flips only where a density lies within float32's rounding of the
# search threshold); x and the cuboids 1e-5 cells (float32's rounding of x
# ~1 is 5e-7 of a 0.125 cell; read <= 8.7e-7; bfloat16 >= 0.048); the
# shares of particles whose volume, material id or density, E, nu differ
# by 1e-4 of the value: none (read 0; bfloat16 1.0 for volume and means)
SETUP_TOL = {"setup.fill_share": 0.0, "setup.x_gap": 1e-5, "setup.vol_share": 0.0,
             "setup.material_share": 0.0, "setup.param_share": 0.0, "setup.cuboid_gap": 1e-5}


def _cell():
    cfg = _config()
    traffic = {"setup_frame_substeps": 4, "warm_frames": 0, "check_unit": 0,
               "name_substeps": 4}
    return drv.Cell(cfg, traffic, SEED, "cpu")


@pytest.fixture(scope="module")
def cell():
    return _cell()


def test_setup_matches_the_reference(cell):
    gaps = cell.setup_gaps()
    assert set(gaps) == set(SETUP_TOL)
    assert all(gaps[k] <= SETUP_TOL[k] for k in gaps), gaps
    assert cell.cfg["n_particles"] == cell.solver.state.n_particles > N


def test_bfloat16_setup_fails_the_tolerances(cell):
    gaps = cell.setup_gaps("bfloat16")
    over = [k for k, v in gaps.items() if v > SETUP_TOL[k]]
    assert len(over) >= 3, gaps


def _no_internal_fill(monkeypatch):
    monkeypatch.setattr(tfilling, "internal_cells_mask",
                        lambda count, *a, **k: torch.zeros(np.shape(count), dtype=torch.bool))


def _parity_ignored(monkeypatch):
    real = tfilling.internal_cells_mask
    monkeypatch.setattr(tfilling, "internal_cells_mask",
                        lambda count, density, thr, exclude, ray, device: real(
                            count, density, thr, exclude, -1, device=device))


def _per_cell_volumes(monkeypatch):
    real = tdriver.get_particle_volume
    monkeypatch.setattr(tdriver, "get_particle_volume",
                        lambda pos, n, dx, uniform=False: real(pos, n, dx, uniform=False))


@pytest.mark.parametrize("fault", [_no_internal_fill, _parity_ignored, _per_cell_volumes],
                         ids=["no_internal_fill", "parity_ignored", "per_cell_volumes"])
def test_wrong_setups_fail_the_set_up_check(monkeypatch, fault):
    fault(monkeypatch)
    gaps = _cell().setup_gaps()
    assert any(v > SETUP_TOL[k] for k, v in gaps.items()), gaps


# -- the internal cells: the port's scans against the reference's ray walk -----------------

def _sphere_shell(n=20, r0=5.5, r1=7.5, hole=False):
    idx = np.arange(n) - (n - 1) / 2.0
    i, j, k = np.meshgrid(idx, idx, idx, indexing="ij")
    r = np.sqrt(i * i + j * j + k * k)
    occ = (r >= r0) & (r <= r1)
    if hole:                                     # a chimney through the top
        occ &= ~((np.abs(i) < 1.5) & (np.abs(j) < 1.5) & (k > 0))
    return occ


def _box_open(n=16, face=2):
    """A box's six faces, the face of direction ``face`` left out."""
    occ = np.zeros((n, n, n), bool)
    lo, hi = 3, n - 4
    for d in range(6):
        if d == face:
            continue
        sl = [slice(lo, hi + 1)] * 3
        sl[d // 2] = hi if d % 2 == 0 else lo
        occ[tuple(sl)] = True
    return occ


@pytest.mark.parametrize("exclude, ray", [(2, 4), (5, 4), (0, 3), (3, 6)])
@pytest.mark.parametrize("shape", ["closed_shell", "box_open_along_excluded", "shell_with_hole",
                                   "random"])
def test_internal_cells_match_the_reference_walk(shape, exclude, ray):
    if shape == "closed_shell":
        occ = _sphere_shell()
    elif shape == "box_open_along_excluded":
        occ = _box_open(face=exclude)
    elif shape == "shell_with_hole":
        occ = _sphere_shell(hole=True)
    else:
        occ = np.random.default_rng(exclude * 7 + ray).random((14, 14, 14)) < 0.3
    density = np.where(occ, 2.5, 0.5).astype(np.float32)
    count = occ.astype(np.int32)
    got = tfilling.internal_cells_mask(count, density, 1.0, exclude, ray, device="cpu")
    want = ref.internal_cells(torch.as_tensor(count), torch.as_tensor(density), 1.0, exclude, ray)
    assert torch.equal(got, want)
    if shape != "random" and ray in (3, 4):
        assert int(want.sum()) > 0                 # the enclosed cells are filled


def test_open_box_and_chimney_leave_cells_unfilled():
    box = _box_open(face=2)
    density = np.where(box, 2.5, 0.0).astype(np.float32)
    count = box.astype(np.int32)
    # open along +y: enclosed only where +y is not searched
    assert ref.internal_cells(torch.as_tensor(count), torch.as_tensor(density), 1.0, 2, 4).any()
    assert not ref.internal_cells(torch.as_tensor(count), torch.as_tensor(density), 1.0, 5,
                                  4).any()
    shell = _sphere_shell(hole=True)
    density = np.where(shell, 2.5, 0.0).astype(np.float32)
    mask = ref.internal_cells(torch.as_tensor(shell.astype(np.int32)), torch.as_tensor(density),
                              1.0, 5, 4)
    closed = ref.internal_cells(torch.as_tensor(_sphere_shell().astype(np.int32)),
                                torch.as_tensor(np.where(_sphere_shell(), 2.5, 0.0)), 1.0, 5, 4)
    assert 0 < int(mask.sum()) < int(closed.sum())


# -- the filling's span and counters --------------------------------------------------------

def test_filling_span_and_counters():
    cfg = _config()
    with obs.tracing() as t:
        _, sim = _setup(cfg)
    summary = t.summary()
    assert {k: v["calls"] for k, v in summary.items() if k != "python.gc"} == {
        "sim.setup.particles": 1, "sim.setup.filling": 1, "sim.setup.material_field": 1}
    names = [r[0] for r in t.records]
    parent = t.records[names.index("sim.setup.filling")][1]
    assert names[parent] == "sim.setup.particles"
    filled = sim.n_particles - sim.gs_payload["gs_num"]
    c = t.counters
    assert c["sim.filling.surface"] + c["sim.filling.internal"] == filled > 0
    assert c["sim.filling.cells"] == c["sim.filling.internal"]       # one particle a cell
    assert c["sim.materials.2"] == sim.n_particles


def test_tracer_off_records_nothing_in_the_filling(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the tracer is off")

    monkeypatch.setattr(obs.PhaseTimer, "count", boom)
    monkeypatch.setattr(obs.PhaseTimer, "span", boom)
    _, sim = _setup(_config())
    assert not obs.enabled() and sim.n_particles > N
