"""The object on the normal neural GS path, on the CPU: ``setup_simulation``
(``run_simulation``'s set-up from inputs in memory) and the rollout of a
potted tree of jelly, metal and stationary parts against the plain reference
``benchmark/reference/mpm_object.py``; ``run_simulation`` against the JAX
package's driver, which it matched before its set-up was split out; the
set-up against the reference's recomputation from the same seeded inputs;
the set-up's and the grid BCs' spans and counters; the host DBSCAN against
its loop; a still cuboid's held node set.

Tolerances of the rollout (float32 program, float64 reference; 3000
particles, n_grid 16, 20 substeps from rest, the impulse in the first), with
what the program reads and what a bfloat16 reference reads:
  * x: 1e-4 cells.  Each substep rounds x (~1) to float32, 6e-8 of 0.125 a
    cell; 20 of them are 1e-5 at worst (read 5.3e-6; bfloat16 0.038);
  * v: 2e-4 of the largest speed (read 1.6e-5; the float32 reference itself
    2.4e-5; bfloat16 0.030);
  * C: 1e-3 of the largest entry: the affine field is a difference of
    nearby node velocities, so it keeps fewer of float32's digits (read
    1.2e-4; bfloat16 0.10);
  * F_trial by material: 2e-5, absolute about the identity (read <= 2.2e-6
    against changes of 1.2e-3 to 2.8e-3; bfloat16 >= 1.6e-4).
"""

import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.drivers import object_rollout as drv
from benchmark.reference import mpm_object as ref
from pixie_tpu_torch.sim import bc as tbc
from pixie_tpu_torch.sim import material_field as tmf
from pixie_tpu_torch.sim import solver as tsolver
from pixie_tpu_torch.sim.driver import setup_simulation
from pixie_tpu_torch.sim.params import decode_params
from pixie_tpu_torch.utils import observability as obs

REPO = Path(__file__).resolve().parent.parent
N, G, SUBSTEPS, SEED = 3000, 16, 20, 11
TOL = {"x": 1e-4, "v": 2e-4, "C": 1e-3, "F": 2e-5}
MATERIALS = {0: "jelly", 1: "metal", 6: "stationary"}
_REST = ("x", "material", "density", "E", "nu", "vol")


def _config(**kw) -> dict:
    """The benchmark's tree at a small size: a 100x impulse, so that motion,
    not float32's rounding of x, fills the 20 substeps."""
    cfg = json.loads((REPO / "benchmark" / "configs" / "tree_object.json").read_text())
    cfg.update({"n_particles": N, "n_grid": G, "substeps_per_frame": SUBSTEPS, **kw})
    cfg["boundary_conditions"] = [dict(cfg["boundary_conditions"][0], force=[-48.0, 0.0, 0.0])]
    return cfg


def _setup(cfg: dict, fused: bool = False):
    obj = drv.draw_object(cfg, SEED)
    return setup_simulation(obj["source"], decode_params(drv.class_config(cfg)),
                            obj["gaussians"], device="cpu", fused=fused)


@pytest.fixture(scope="module")
def rollout():
    """The port's frame of 20 substeps from rest and the reference's, in
    float64 and bfloat16, from the same rest state and cuboids."""
    torch.manual_seed(0)
    cfg = _config()
    sim = _setup(cfg)
    rest = {k: getattr(sim.solver.state, k).clone() for k in _REST}
    sim.solver.step_frame(SUBSTEPS, sim.substep_dt)
    prm = ref.params(cfg, sim.auto_bcs, "cpu")
    impulse = dict(mask=torch.ones(N, dtype=torch.bool),
                   force=torch.tensor([-48.0, 0.0, 0.0], dtype=torch.float64), start=0.0,
                   end=float(np.float32(sim.substep_dt)))
    refs = {}
    for dt in (torch.float64, torch.bfloat16):
        st = ref.initial_state(*(rest[k] for k in _REST), dtype=dt)
        refs[dt] = ref.frame(st, prm, 0.0, SUBSTEPS, dict(impulse, force=impulse["force"].to(dt)))
    return sim, rest, refs


def _copy(state):
    return dataclasses.replace(state, **{f.name: getattr(state, f.name).clone()
                                         for f in dataclasses.fields(state)})


def _gaps(got: dict, want: dict, material) -> dict:
    def gap(a, b):
        return float((a.double() - b.double()).abs().max())

    out = {"x": gap(got["x"], want["x"]) * G / 2.0,
           "v": gap(got["v"], want["v"]) / float(want["v"].abs().max()),
           "C": gap(got["C"], want["C"]) / float(want["C"].abs().max())}
    for m, name in MATERIALS.items():
        sel = material == m
        out[f"F.{name}"] = gap(got["F_trial"][sel], want["F_trial"][sel])
    return out


def test_setup_holds_the_three_parts_and_both_bc_kinds(rollout):
    sim, rest, _ = rollout
    assert sim.steps_per_frame == SUBSTEPS and sim.n_particles == N
    assert sorted(b["type"] for b in sim.auto_bcs) == ["ground", "stationary_cluster"]
    assert [type(b) for b in sim.solver.bcs] == [tbc.CuboidVelocity, tbc.CuboidVelocity,
                                                 tbc.ParticleImpulse]
    assert sim.solver.cfg.active_materials == (0, 1, 6)
    counts = torch.bincount(rest["material"])
    assert all(int(counts[m]) >= 40 for m in MATERIALS)
    # each part's values lie in its range (kNN means of the voxels' draws)
    for p in _config()["parts"]:
        sel = rest["material"] == p["id"]
        for key in ("density", "E", "nu"):
            v = rest[key][sel]
            lo, hi = p[key]
            # boundary particles average two parts' voxels; most lie in their own range
            assert float(((v >= lo) & (v <= hi)).float().mean()) > 0.8, (p["name"], key)


@pytest.mark.parametrize("field", ["x", "v", "C", "F.jelly", "F.metal", "F.stationary"])
def test_rollout_matches_the_reference(rollout, field):
    sim, rest, refs = rollout
    got = {k: getattr(sim.solver.state, k) for k in ("x", "v", "C", "F_trial")}
    gaps = _gaps(got, refs[torch.float64], rest["material"])
    assert gaps[field] <= TOL[field.split(".")[0]], gaps


def test_bfloat16_reference_fails_the_tolerances(rollout):
    _, rest, refs = rollout
    gaps = _gaps(refs[torch.bfloat16], refs[torch.float64], rest["material"])
    over = [k for k, v in gaps.items() if v > TOL[k.split(".")[0]]]
    assert len(over) >= 3, gaps


# -- the set-up against the reference's ---------------------------------------------------

# the set-up's tolerances: x and the cuboids 1e-5 cells (float32's rounding of
# x ~1 is 5e-7 of a 0.125 cell; read <= 7e-7; bfloat16 >= 0.03); the shares of
# particles whose volume, material id or density, E, nu differ by 1e-4 of the
# value: volumes and ids none (read 0), the means 1e-3 (read 3.3e-4: one
# particle whose 10th and 11th voxels lie at nearly one distance, so that
# float32 picks the other; bfloat16 1.0)
SETUP_TOL = {"x": 1e-5, "cuboids": 1e-5, "vol": 0.0, "material": 0.0, "params": 1e-3}


def _setup_gaps(got: dict, want: dict) -> dict:
    dx = 2.0 / G

    def share(mask):
        return float(mask.double().mean())

    def differs(key):
        a, b = got[key].double(), want[key].double()
        return (a - b).abs() > 1e-4 * b.abs()

    assert [c["type"] for c in got["cuboids"]] == [c["type"] for c in want["cuboids"]]
    return {"x": float((got["x"].double() - want["x"].double()).abs().max()) / dx,
            "cuboids": max(float((torch.as_tensor(a[k], dtype=torch.float64)
                                  - b[k].double()).abs().max())
                           for a, b in zip(got["cuboids"], want["cuboids"])
                           for k in ("point", "size")) / dx,
            "vol": share(differs("vol")),
            "material": share(got["material"].long() != want["material"].long()),
            "params": share(differs("density") | differs("E") | differs("nu"))}


@pytest.fixture(scope="module")
def setups(rollout):
    """The program's set-up and the reference's, in float64 and bfloat16,
    from the same seeded inputs."""
    sim, rest, _ = rollout
    obj = drv.draw_object(_config(), SEED)
    src = {k: torch.as_tensor(np.asarray(v)) for k, v in obj["source"].items()}
    xyz, logit = obj["gaussians"]["xyz"], obj["gaussians"]["opacity"][:, 0]
    refs = {dt: ref.setup(xyz, logit, src, _config(), dt)
            for dt in (torch.float64, torch.bfloat16)}
    return dict(rest, cuboids=sim.auto_bcs), refs


@pytest.mark.parametrize("field", list(SETUP_TOL))
def test_setup_matches_the_reference(setups, field):
    got, refs = setups
    gaps = _setup_gaps(got, refs[torch.float64])
    assert gaps[field] <= SETUP_TOL[field], gaps


def test_bfloat16_setup_fails_the_tolerances(setups):
    _, refs = setups
    gaps = _setup_gaps(refs[torch.bfloat16], refs[torch.float64])
    over = [k for k, v in gaps.items() if v > SETUP_TOL[k]]
    assert len(over) >= 3, gaps


# -- run_simulation, its set-up split out ------------------------------------------------

def _write_object(root: Path, mode: str):
    """A small tree as the pipeline leaves it: a 3DGS checkpoint, the material
    PLY, the class config (2 frames of 20 substeps)."""
    from pixie_tpu_torch.recon.gaussians import save_gaussian_ply
    from pixie_tpu_torch.utils.io import make_material_vertex, write_ply

    cfg = _config(n_particles=1200, voxel_grid=24, frame_num=2)
    cfg["frame_dt"] = SUBSTEPS * cfg["substep_dt"]
    obj = drv.draw_object(cfg, SEED)
    src = obj["source"]
    ckpt = root / "gs" / "point_cloud" / "iteration_30"
    ckpt.mkdir(parents=True)
    save_gaussian_ply(ckpt / "point_cloud.ply", obj["gaussians"])
    write_ply(root / "mapped_preds.ply", make_material_vertex(
        coords=src["pos"], density=src["density"], E=src["E"], nu=src["nu"],
        material_id=src["material_id"], part_label=src["part_labels"]))
    (root / "sim.json").write_text(json.dumps(cfg))
    return dict(gaussian_checkpoint=root / "gs") if mode == "gs" else {}


@pytest.mark.parametrize("mode", ["gs", "point_cloud"])
def test_run_simulation_writes_what_it_wrote_before_the_split(tmp_path, mode, monkeypatch):
    """``run_simulation`` sets up through ``setup_simulation`` and writes the
    sim_info.json fields and frame PLYs of the JAX package's driver, which
    it matched before: counts, materials and BCs exactly, the last frame's
    positions to 2e-5 (40 substeps of float32 in two libraries)."""
    from pixie_tpu.sim.driver import run_simulation as j_run
    from pixie_tpu_torch.sim import driver as tdriver
    from pixie_tpu_torch.utils.io import read_ply

    kw = _write_object(tmp_path, mode)
    calls = []
    real = tdriver.setup_simulation
    monkeypatch.setattr(tdriver, "setup_simulation",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    args = (tmp_path / "mapped_preds.ply", tmp_path / "sim.json")
    tinfo = tdriver.run_simulation(*args, tmp_path / "torch", device="cpu", debug=True, **kw)
    jinfo = j_run(*args, tmp_path / "jax", use_fast_solver=False, debug=True, **kw)
    assert calls == [1]
    written = json.loads((tmp_path / "torch" / "sim_info.json").read_text())
    assert written == json.loads(json.dumps(tinfo))
    for k in ("n_particles", "frames", "substeps_per_frame", "active_materials", "auto_bcs"):
        assert written[k] == jinfo[k], k
    assert written["n_filled"] == 0 and written["final_state_finite"]
    # the port's own fields: the scale into the MPM cube is 1 / the particles' largest extent
    from pixie_tpu_torch.recon.gaussians import get_opacity, load_gaussian_ply

    if mode == "gs":
        gs = load_gaussian_ply(tmp_path / "gs" / "point_cloud" / "iteration_30" / "point_cloud.ply")
        pos = gs["xyz"].numpy()[get_opacity(gs).numpy()[:, 0] > 0.02]
    else:
        pos = np.column_stack([read_ply(tmp_path / "mapped_preds.ply")["vertex"][k] for k in "xyz"])
    assert written["scale_origin"] == pytest.approx(1.0 / np.ptp(pos, axis=0).max(), rel=1e-6)
    assert written["n_particles"] == (1200 if mode == "gs" else len(read_ply(
        tmp_path / "mapped_preds.ply")["vertex"]))
    assert {b["type"] for b in written["auto_bcs"]} >= {"ground"}
    names = sorted(p.name for p in (tmp_path / "jax" / "ply_files").glob("*.ply"))
    assert names == ["frame_0000.ply", "frame_0001.ply"]
    assert sorted(p.name for p in (tmp_path / "torch" / "ply_files").glob("*.ply")) == names
    got = read_ply(tmp_path / "torch" / "ply_files" / names[-1])["vertex"]
    want = read_ply(tmp_path / "jax" / "ply_files" / names[-1])["vertex"]
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=k)
    for k in ("material_id", "density", "E", "nu"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (json.loads((tmp_path / "torch" / "boundary_conditions.json").read_text())
            == json.loads((tmp_path / "jax" / "boundary_conditions.json").read_text()))


# -- spans and counters ----------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_setup_and_grid_bc_spans_and_counters(fused):
    cfg = _config(n_particles=1500)
    with obs.tracing() as t:
        sim = _setup(cfg, fused=fused)
    calls = {k: v["calls"] for k, v in t.summary().items() if k != "python.gc"}
    assert calls == {"sim.setup.particles": 1, "sim.setup.material_field": 1}
    ids, counts = torch.unique(sim.solver.state.material, return_counts=True)
    assert t.counters == {f"sim.materials.{i}": c for i, c in zip(ids.tolist(), counts.tolist())}
    assert sum(t.counters.values()) == 1500

    solver = sim.solver
    solver.step_frame(SUBSTEPS, sim.substep_dt)               # the impulse: an unfused frame
    start, t0 = _copy(solver.state), solver.time
    states = []
    for on in (False, True):
        solver.state, solver.time = _copy(start), t0
        with obs.tracing() if on else contextlib.nullcontext() as t:
            assert solver.step_frame(SUBSTEPS, sim.substep_dt) is fused
        states.append(solver.state)
    for k in ("x", "v", "C", "F_trial"):
        assert torch.equal(getattr(states[0], k), getattr(states[1], k)), k
    s = t.summary()
    assert s["sim.grid_bc"]["calls"] == s["sim.grid"]["calls"] == SUBSTEPS
    assert t.counters.pop("sim.bc.grid_cuboids") == 2 * SUBSTEPS    # ground and pot
    assert set(t.counters) == ({"fused.live_lanes", "fused.runs"} if fused else set())
    grid = [i for i, r in enumerate(t.records) if r[0] == "sim.grid"]
    assert all(t.records[i][0] == "sim.grid_bc" and t.records[i][1] in grid
               for i, r in enumerate(t.records) if r[0] == "sim.grid_bc")


def test_tracer_off_records_nothing_in_a_cuboid_frame(monkeypatch):
    sim = _setup(_config(n_particles=1500))

    def boom(*a, **k):
        raise AssertionError("the tracer is off")

    monkeypatch.setattr(obs.time, "time_ns", boom)
    monkeypatch.setattr(obs.PhaseTimer, "count", boom)
    sim.solver.step_frame(4, sim.substep_dt)
    assert not obs.enabled()


def test_collider_frame_opens_no_grid_bc_span():
    """A frame without a cuboid keeps its spans (the scene cells')."""
    st = drv.draw_object(_config(n_particles=500), SEED)["gaussians"]["xyz"].numpy() + 1.0
    from pixie_tpu_torch.sim.types import finalize_mu_lam, make_state

    s = tsolver.MPMSolver(n_grid=G, grid_lim=2.0, device="cpu")
    s.state = finalize_mu_lam(make_state(st, np.full(len(st), 1e-6, np.float32)))
    s.bcs = [tbc.make_surface_collider((1.0, 1.0, 0.95), (0.0, 0.0, 1.0), "sticky")]
    with obs.tracing() as t:
        s.step_frame(3, 1e-4)
    assert "sim.grid_bc" not in t.summary() and t.counters == {}


# -- the set-up's host parts ---------------------------------------------------------------

def _dbscan_loop(points, eps, min_samples):
    """sklearn's ``dbscan_inner``: depth-first growth from each unlabelled
    core point in index order (the port's loop before it was vectorised)."""
    from scipy.spatial import cKDTree

    n = len(points)
    labels = np.full(n, -1, np.int64)
    neighborhoods = cKDTree(points).query_ball_point(points, r=eps)
    is_core = np.array([len(nb) >= min_samples for nb in neighborhoods])
    label = 0
    for i in range(n):
        if labels[i] != -1 or not is_core[i]:
            continue
        stack = [i]
        while stack:
            j = stack.pop()
            if labels[j] != -1:
                continue
            labels[j] = label
            if is_core[j]:
                stack.extend(v for v in neighborhoods[j] if labels[v] == -1)
        label += 1
    return labels


@pytest.mark.parametrize("case", ["pot", "touching_clusters", "sparse", "empty"])
def test_dbscan_equals_its_loop(case):
    rng = np.random.default_rng(5)
    if case == "pot":         # the tree's stationary particles, in MPM units
        xyz = drv.draw_object(_config(n_particles=20000), SEED)["gaussians"]["xyz"].numpy()
        pts = xyz[drv.part_of(_config()["parts"], xyz.astype(np.float64)) == 0] + 1.0
    elif case == "touching_clusters":
        # two blobs joined by border points that each reach a core of both
        pts = np.concatenate([rng.normal([0.5, 0.5, 0.5], 0.012, (300, 3)),
                              rng.normal([0.56, 0.5, 0.5], 0.012, (300, 3)),
                              rng.uniform(0.4, 0.7, (200, 3))])
        pts = pts[rng.permutation(len(pts))]
    elif case == "sparse":
        pts = rng.uniform(0.0, 1.0, (400, 3))
    else:
        pts = np.zeros((0, 3))
    pts = pts.astype(np.float32)
    for eps, k in ((0.03, 8), (0.02, 4)):
        want = _dbscan_loop(pts, eps, k) if len(pts) else np.zeros(0, np.int64)
        np.testing.assert_array_equal(tmf.dbscan(pts, eps, k), want)


def test_still_cuboid_holds_its_node_set_a_frame():
    cfg = tsolver.MPMConfig(n_grid=G, grid_lim=2.0)
    node_x = tsolver.node_positions(cfg, "cpu")
    grid_v = torch.randn((G, G, G, 3), generator=torch.Generator().manual_seed(1))
    still = tbc.make_cuboid_velocity([1.0, 1.0, 0.6], [0.3, 0.3, 0.1], [0, 0, 0])
    moving = tbc.make_cuboid_velocity([1.0, 1.0, 0.6], [0.3, 0.3, 0.1], [0, 0, 2.0])
    assert still.still and not moving.still
    for b in (still, moving):
        fresh = [tbc.make_cuboid_velocity(b.point, b.size, b.velocity).apply(
            t, 1e-4, grid_v, node_x, cfg) for t in (0.0, 0.05)]
        held = [b.apply(t, 1e-4, grid_v, node_x, cfg) for t in (0.0, 0.05)]
        for f, h in zip(fresh, held):
            assert torch.equal(f, h)
    assert still._held[0] is node_x and moving._held is None
    # the moving one's node set moved with it; the still one's did not
    assert not torch.equal(*[moving.apply(t, 1e-4, grid_v, node_x, cfg) for t in (0.0, 0.05)])
    other = tsolver.node_positions(cfg, "cpu")
    still.apply(0.0, 1e-4, grid_v, other, cfg)
    assert still._held[0] is other
