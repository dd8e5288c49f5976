"""The fused-substep rollout (PIXIE_FUSED=1) of pixie_tpu_torch against its own
unfused rollout and against the JAX package's FastMPMSolver fused path.

On the CPU, ``ops.fused_substep`` runs its plain version: the port's own
G2P, constitutive pass and P2G in the rotated order.  So a fused frame runs
the same operations as an unfused frame and must equal it bit for bit.
Against JAX (the Pallas fused kernel in interpret mode, on the TPU's tiled
layout), the tolerances are those of tests/test_fast_solver.py:282-294:
trajectories atol x 1e-5, v 1e-4, F 1e-5, F_trial 1e-5, C 5e-3, cov 1e-5;
the stored stress to the float32 ULP floor 6 E 1.2e-7 (90 % of entries
within it, all within 100 times it), because stress = 2 mu (F - R) F^T with F
near I amplifies last-ulp differences of F.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import to_np

from pixie_tpu_torch.ops import fused_substep as fs
from pixie_tpu_torch.sim import bc as tbc
from pixie_tpu_torch.sim import solver as tsolver
from pixie_tpu_torch.sim.types import MPMConfig, finalize_mu_lam, make_state

REPO = Path(__file__).resolve().parent.parent
MATS = (0, 1, 2, 3, 5, 6)
E = 2e5
DT = 1e-4
FIELDS = ("x", "v", "C", "F", "F_trial", "stress", "mu", "lam", "yield_stress", "cov")
TRAJ_TOL = {"x": 1e-5, "v": 1e-4, "F": 1e-5, "F_trial": 1e-5, "C": 5e-3, "cov": 1e-5}


def _mixed_inputs(n=1000, seed=11):
    """numpy arrays of a mixed-material block: ids 0, 1, 2, 3, 5, 6 in turn,
    yield stresses low enough that von Mises and snow yield, F_trial spread
    so sand both expands and compacts, every 17th particle inactive."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(n, 6)).astype(np.float32) * 1e-4
    c[:, [0, 3, 5]] += 1e-3
    return {
        "x": rng.uniform(0.7, 1.3, (n, 3)).astype(np.float32),
        "vol": np.full(n, 1e-6, np.float32),
        "v": (0.5 * rng.normal(size=(n, 3))).astype(np.float32),
        "F": (np.eye(3) + 0.04 * rng.normal(size=(n, 3, 3))).astype(np.float32),
        "material": np.asarray(MATS, np.int32)[np.arange(n) % len(MATS)],
        "yield_stress": rng.uniform(50.0, 400.0, n).astype(np.float32),
        "selection": (np.arange(n) % 17 == 4).astype(np.int32),
        "cov": c,
    }


def _cfg_kw(update_cov):
    return dict(n_grid=16, grid_lim=2.0, gravity=(0.0, 0.0, -9.8), rpic_damping=0.1,
                update_cov_with_F=update_cov, active_materials=MATS, hardening=1.0,
                xi=0.1, plastic_viscosity=0.05, softening=0.5, friction_angle=30.0)


def _torch_state(d):
    st = finalize_mu_lam(make_state(d["x"], d["vol"], density=300.0, E=E, nu=0.3,
                                    material=d["material"], yield_stress=d["yield_stress"]))
    # copies: the substeps write the state in place
    return st.replace(v=torch.tensor(d["v"]), F=torch.tensor(d["F"]),
                      F_trial=torch.tensor(d["F"]), cov=torch.tensor(d["cov"]),
                      selection=torch.tensor(d["selection"]))


def _collider():
    return tbc.make_surface_collider((1.0, 1.0, 0.75), (0.0, 0.0, 1.0), "sticky")


@pytest.mark.parametrize("update_cov", [False, True])
def test_fused_frames_equal_unfused_frames_bitwise(update_cov):
    d = _mixed_inputs()
    cfg = MPMConfig(**_cfg_kw(update_cov))
    bcs = (_collider(),)
    ref, got = _torch_state(d), _torch_state(d)
    for f in range(2):
        ref = tsolver.simulate_substeps(ref, cfg, bcs, f * 10 * DT, DT, 10)
        got = tsolver.simulate_substeps_fused(got, cfg, bcs, f * 10 * DT, DT, 10)
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    # every branch was taken: von Mises / snow yield, sand expands and compacts
    mat = d["material"]
    yielded = ~np.isclose(to_np(ref.yield_stress), d["yield_stress"])
    assert yielded[mat == 1].any() and yielded[mat == 5].any()
    det = np.linalg.det(to_np(ref.F)[mat == 2].astype(np.float64))
    assert (det > 1.0).any() and (det < 1.0).any()
    assert np.isfinite(to_np(ref.x)).all()


def test_fused_frames_of_no_substep_and_of_one():
    """A fused frame of no substeps returns its state unchanged, as the
    unfused frame does; one of a single substep equals the unfused one bit
    for bit."""
    d = _mixed_inputs(n=300, seed=5)
    cfg = MPMConfig(**_cfg_kw(True))
    bcs = (_collider(),)
    start = _torch_state(d)
    got = tsolver.simulate_substeps_fused(_torch_state(d), cfg, bcs, 0.0, DT, 0)
    ref = tsolver.simulate_substeps(_torch_state(d), cfg, bcs, 0.0, DT, 0)
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(start, k)), k
        assert torch.equal(getattr(ref, k), getattr(start, k)), k
    got = tsolver.simulate_substeps_fused(_torch_state(d), cfg, bcs, 0.0, DT, 1)
    ref = tsolver.simulate_substeps(_torch_state(d), cfg, bcs, 0.0, DT, 1)
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    assert not torch.equal(got.x, start.x)


def test_fused_substep_plain_is_the_rotated_composition():
    """One call against its three pieces, in place, inactive rows untouched."""
    from pixie_tpu_torch.ops import transfer
    from pixie_tpu_torch.sim.constitutive import compute_stress_from_F_trial

    d = _mixed_inputs(n=300, seed=3)
    cfg = MPMConfig(**_cfg_kw(True))
    grid_v = torch.as_tensor(np.random.default_rng(5).normal(
        size=(16, 16, 16, 3)).astype(np.float32))
    st = _torch_state(d)
    before = {k: getattr(st, k).clone() for k in FIELDS}
    active = st.selection == 0
    launches = fs.FUSED_LAUNCHES
    grid = fs.fused_substep(st, grid_v, cfg, DT, active)
    assert fs.FUSED_LAUNCHES == launches  # the plain version is not a launch
    ref = _torch_state(d)
    transfer.g2p_plain(ref, grid_v, cfg, DT)
    ref = compute_stress_from_F_trial(ref, cfg, DT)
    want = transfer.p2g_plain(ref.x, ref.v, ref.C, ref.stress, ref.mass, ref.vol, active,
                              cfg, DT)
    assert torch.equal(grid, want)
    inactive = ~active
    for k in FIELDS:
        assert torch.equal(getattr(st, k), getattr(ref, k)), k
        assert torch.equal(getattr(st, k)[inactive], before[k][inactive]), k


def _jax_fused_run(d, cfg_kw, bcs_spec, n_substeps):
    import os

    import jax.numpy as jnp

    from pixie_tpu.sim import bc as jbc
    from pixie_tpu.sim.solver_fast import FastMPMSolver
    from pixie_tpu.sim.types import MPMConfig as JCfg
    from pixie_tpu.sim.types import finalize_mu_lam as jfin
    from pixie_tpu.sim.types import make_state as jmake

    st = jfin(jmake(d["x"], d["vol"], density=300.0, E=E, nu=0.3, material=d["material"],
                    yield_stress=d["yield_stress"]))
    st = st.replace(v=jnp.asarray(d["v"]), F=jnp.asarray(d["F"]), F_trial=jnp.asarray(d["F"]),
                    cov=jnp.asarray(d["cov"]), selection=jnp.asarray(d["selection"]))
    bcs = tuple(jbc.make_surface_collider(*b) for b in bcs_spec)
    old = os.environ.get("PIXIE_FUSED")
    os.environ["PIXIE_FUSED"] = "1"
    try:
        solver = FastMPMSolver(st, JCfg(**cfg_kw), bcs=bcs, interpret=True)
        solver.step_frame(n_substeps, DT)
        return solver.state
    finally:
        if old is None:
            os.environ.pop("PIXIE_FUSED", None)
        else:
            os.environ["PIXIE_FUSED"] = old


@pytest.mark.parametrize("update_cov", [False, True])
def test_fused_frame_matches_jax_fused_path(update_cov):
    d = _mixed_inputs()
    kw = _cfg_kw(update_cov)
    spec = (((1.0, 1.0, 0.75), (0.0, 0.0, 1.0), "sticky"),)
    want = _jax_fused_run(d, kw, spec, 5)
    solver = tsolver.MPMSolver(device="cpu", fused=True)
    solver.cfg = MPMConfig(**kw)
    solver.state = _torch_state(d)
    solver.bcs = [tbc.make_surface_collider(*spec[0])]
    assert solver.step_frame(5, DT)
    got = solver.state
    for k, tol in TRAJ_TOL.items():
        np.testing.assert_allclose(to_np(getattr(got, k)), np.asarray(getattr(want, k)),
                                   atol=tol, err_msg=k)
    for k in ("mu", "lam", "yield_stress"):
        np.testing.assert_allclose(to_np(getattr(got, k)), np.asarray(getattr(want, k)),
                                   rtol=1e-5, err_msg=k)
    diff = np.abs(to_np(got.stress) - np.asarray(want.stress))
    floor = 6 * E * 1.2e-7
    assert (diff <= floor).mean() > 0.9
    assert diff.max() < 100 * floor


def test_fused_dispatch_is_frame_granular(monkeypatch):
    """As tests/test_fast_solver.py:335-378: a frame with an active impulse
    runs the unfused frame, the next one the fused frame, and the two-frame
    rollout matches the JAX reference solver."""
    import jax.numpy as jnp

    from pixie_tpu.sim import bc as jbc
    from pixie_tpu.sim import solver as jsolver
    from pixie_tpu.sim.types import MPMConfig as JCfg
    from pixie_tpu.sim.types import finalize_mu_lam as jfin
    from pixie_tpu.sim.types import make_state as jmake

    rng = np.random.default_rng(0)
    n = 400
    kw = dict(n_grid=24, grid_lim=2.0, gravity=(0.0, 0.0, -9.8), update_cov_with_F=False)
    x = rng.uniform(0.6, 1.4, (n, 3)).astype(np.float32)
    mask = (x[:, 2] > 1.0).astype(np.float32)
    jst = jfin(jmake(jnp.asarray(x), jnp.full((n,), 1e-6), density=300.0, E=1e5, nu=0.3))
    jb = jbc.ParticleImpulse(force=jnp.array([0.0, 0.0, 20.0]), mask=jnp.asarray(mask),
                             start_time=0.0, end_time=5e-4)  # frame 0 only
    ref = jst
    for f in range(2):
        ref = jsolver.simulate_substeps(ref, JCfg(**kw), (jb,), jnp.float32(f * 1e-3),
                                        jnp.float32(DT), 10)

    calls = []
    real = tsolver.simulate_substeps_fused

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tsolver, "simulate_substeps_fused", spy)
    solver = tsolver.MPMSolver(device="cpu", fused=True)
    solver.cfg = MPMConfig(**kw)
    solver.state = finalize_mu_lam(make_state(x, np.full(n, 1e-6, np.float32), density=300.0,
                                              E=1e5, nu=0.3))
    solver.bcs = [tbc.ParticleImpulse(force=torch.tensor([0.0, 0.0, 20.0]),
                                      mask=torch.as_tensor(mask > 0), start_time=0.0,
                                      end_time=5e-4)]
    assert not solver.step_frame(10, DT)
    assert not calls, "the frame with an active impulse must run unfused"
    assert solver.step_frame(10, DT)
    assert calls, "the frame after the impulse must run fused"
    vr, vf = np.asarray(ref.v), to_np(solver.state.v)
    assert np.abs(vr - vf).max() / np.abs(vr).max() < 2e-5
    assert np.abs(np.asarray(ref.x) - to_np(solver.state.x)).max() < 1e-5


@pytest.mark.parametrize("env,want", [(None, False), ("0", False), ("1", True)])
def test_fused_follows_pixie_fused(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("PIXIE_FUSED", raising=False)
    else:
        monkeypatch.setenv("PIXIE_FUSED", env)
    assert tsolver.MPMSolver(device="cpu").fused is want
    assert tsolver.MPMSolver(device="cpu", fused=not want).fused is (not want)


def test_fused_frame_refuses_particle_bcs():
    d = _mixed_inputs(n=50)
    st = _torch_state(d)
    imp = tbc.make_particle_impulse(d["x"], [1.0, 0.0, 0.0], DT, num_dt=1)
    with pytest.raises(AssertionError, match="particle BCs"):
        tsolver.simulate_substeps_fused(st, MPMConfig(**_cfg_kw(False)), (imp,), 0.0, DT, 2)


@pytest.fixture(scope="module")
def tree_object(tmp_path_factory):
    """The slice's synthetic object (tests/test_torch_slice.py) as a
    material PLY, under the tree config at 10 substeps a frame, 3 frames."""
    from test_torch_slice import D, FC, MODEL_KW, OBJ, _make_object

    from pixie_tpu_torch import pipeline

    root = tmp_path_factory.mktemp("fused_slice")
    render, _, _, _, sim_cfg = _make_object(root)
    cfg = json.loads(sim_cfg.read_text())
    cfg.update(frame_dt=1e-3, frame_num=3)
    sim_cfg.write_text(json.dumps(cfg))
    ply = pipeline.generate_neural_segmentation(
        render, root / "neural", OBJ, root / "checkpoints_discrete",
        root / "checkpoints_continuous_mse", grid_size=D, feature_channels=FC,
        model_kwargs=MODEL_KW, device="cpu")
    return root, ply, sim_cfg


def test_pipeline_fused_rollout_matches_jax(tree_object, monkeypatch):
    """The slice under PIXIE_FUSED=1: pipeline.run_physics_simulation(fused=True)
    against the JAX driver's fast solver with PIXIE_FUSED=1.  Frame 0 has the
    impulse and runs unfused in both; frames 1 and 2 run fused, and
    frame_0002.ply shows the state after fused frame 1.  The port's fused
    rollout also equals its unfused rollout bit for bit."""
    from pixie_tpu.sim.driver import run_simulation as jax_run
    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.utils.io import read_ply

    root, ply, sim_cfg = tree_object
    info = pipeline.run_physics_simulation(ply, sim_cfg, root / "fused", debug=True,
                                           device="cpu", fused=True)
    plain = pipeline.run_physics_simulation(ply, sim_cfg, root / "unfused", device="cpu",
                                            fused=False)
    monkeypatch.setenv("PIXIE_FUSED", "1")
    jax_run(ply, sim_cfg, root / "jax", use_fast_solver=True)
    assert info["fused_frames"] == [1, 2] and plain["fused_frames"] == []
    assert len(info["frame_s"]) == info["frames"] == 3
    sim_info = json.loads((root / "fused" / "sim_info.json").read_text())
    assert sim_info["fused_frames"] == [1, 2]
    for name in ("frame_0000.ply", "frame_0001.ply", "frame_0002.ply"):
        got = read_ply(root / "fused" / "ply_files" / name)["vertex"]
        same = read_ply(root / "unfused" / "ply_files" / name)["vertex"]
        want = read_ply(root / "jax" / "ply_files" / name)["vertex"]
        for k in "xyz":
            np.testing.assert_array_equal(got[k], same[k])
            np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=name)


# -- the CUDA kernel's splat through a kept cell order, emulated on the CPU ------

def _run_sum_splat(x, v, C, stress, mass, vol, active, perm, cfg, dt):
    """csrc/fused_substep.cu's splat in plain PyTorch: lane q of each warp of
    32 takes particle perm[q]; a lane is live if its particle is active, its
    position finite and its stencil reaches the grid; each run of adjacent
    live lanes with one base cell sums its 27 nodes' values, added into the
    grid at the nodes of the run's last lane where they are in the grid.
    Returns the grid and the number of (warp, cell) pairs split over more
    than one run."""
    from pixie_tpu_torch.ops import transfer

    g, n = cfg.n_grid, x.shape[0]
    vals, _ = transfer.p2g_contributions(x, v, C, stress, mass, vol, active, cfg, dt)
    base, *_ = transfer._spline_weights(x, cfg.inv_dx)
    node = base[None] + torch.as_tensor(transfer._OFFSETS)[:, None, :]       # (27, N, 3)
    in_grid = ((node >= 0) & (node < g)).all(-1)
    live = active & torch.isfinite(x).all(1) & ((base >= -2) & (base <= g - 1)).all(1)
    label = ((base[:, 0] + 2) * (g + 2) + base[:, 1] + 2) * (g + 2) + base[:, 2] + 2
    grid, split = torch.zeros((g ** 3, 4)), 0
    for w0 in range(0, n, 32):
        lanes = perm[w0:w0 + 32]
        lab = torch.where(live[lanes], label[lanes], -1 - torch.arange(len(lanes)))
        run = torch.cumsum(torch.cat([torch.ones(1, dtype=torch.bool), lab[1:] != lab[:-1]]), 0)
        cells = lab[live[lanes]]
        split += len(torch.unique_consecutive(cells)) - len(torch.unique(cells))
        for r in torch.unique(run[live[lanes]]).tolist():
            members = lanes[run == r]
            last = members[-1]
            nd, ok = node[:, last], in_grid[:, last]
            flat = (nd[:, 0] * g + nd[:, 1]) * g + nd[:, 2]
            grid.index_add_(0, flat[ok], vals[:, members].sum(1)[ok])
    return grid.reshape(g, g, g, 4), split


@pytest.mark.parametrize("order", ["given", "cell_sorted", "stale"])
def test_run_sum_splat_through_a_kept_order_matches_plain(order):
    """The fused kernel's run-summed splat, emulated on the CPU, gives
    p2g_plain's grid to 1e-5 of its largest value in any lane order: the
    particles' own order, sorted by cell (transfer.cell_order), and the
    order of a sort made before the particles drifted (up to 0.8 of a cell
    on each axis, as over many substeps), which splits cells over several
    runs of a warp.  Particles on the grid's faces, off the grid and
    inactive are in the scene.  The mean run length reads as the kernel
    would form them: longest sorted, shortened by the drift."""
    from pixie_tpu_torch.ops import transfer

    d = _mixed_inputs(n=3000, seed=7)
    cfg = MPMConfig(**{**_cfg_kw(True), "n_grid": 40})
    rng = np.random.default_rng(8)
    x = d["x"].copy()
    x[:50] = rng.uniform(0.0, cfg.dx, (50, 3))          # stencils over the low faces
    x[50:55] = [-0.5, 1.0, 1.0]                          # no node in the grid
    st = _torch_state({**d, "x": x})
    active = st.selection == 0
    st = st.replace(stress=torch.as_tensor((1e3 * rng.normal(size=(3000, 3, 3))).astype(
        np.float32)), C=torch.as_tensor((0.1 * rng.normal(size=(3000, 3, 3))).astype(np.float32)))
    perm = {"given": torch.arange(3000), "cell_sorted": transfer.cell_order(st.x, active, cfg),
            "stale": transfer.cell_order(st.x, active, cfg)}[order]
    if order == "stale":
        drift = rng.uniform(-0.8, 0.8, (3000, 3)) * cfg.dx
        st = st.replace(x=st.x + torch.as_tensor(drift.astype(np.float32)))
    args = (st.x, st.v, st.C, st.stress, st.mass, st.vol, active)
    want = transfer.p2g_plain(*args, cfg, DT)
    got, split = _run_sum_splat(*args, perm, cfg, DT)
    scale = float(want.abs().max())
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=1e-5 * scale)
    runs = {o: fs.mean_run_length(st.x[p], active[p], cfg)
            for o, p in (("given", torch.arange(3000)),
                         ("sorted", transfer.cell_order(st.x, active, cfg)), ("this", perm))}
    assert runs["given"] < 1.5 < runs["sorted"]
    if order == "stale":
        assert split > 0 and runs["given"] < runs["this"] < runs["sorted"]
    elif order == "cell_sorted":
        assert split == 0 and runs["this"] == runs["sorted"]


def test_fused_frame_runs_on_the_state_in_cell_order(monkeypatch):
    """Where P2G returns its cell order (on the card), the fused frame runs
    its substeps on the state permuted into that order, permutes it again
    every RESORT_EVERY substeps by a fresh cell order and hands the state
    back in the caller's order: every field where the frame in the
    caller's order puts it (the sums of P2G run in another order: atol
    1e-6 of the field's largest value, the stress to the module's ULP
    floor), the untouched ones exactly.  On the CPU P2G returns no order and
    the frame runs in place, in the caller's order."""
    from pixie_tpu_torch.ops import transfer

    d = _mixed_inputs(n=200, seed=2)
    cfg = MPMConfig(**_cfg_kw(False))
    rng = np.random.default_rng(0)
    first, again = (torch.as_tensor(rng.permutation(200)) for _ in range(2))
    seen, sorts = [], []
    real_p2g, real_fused = transfer.p2g, fs.fused_substep

    def p2g(*a, return_order=False, **k):
        grid = real_p2g(*a, **k)
        return (grid, first) if return_order else grid

    def cell_order(x, active, c):
        sorts.append(x.clone())
        return again

    def fused(state, grid_v, c, dt, active):
        seen.append(state.x.clone())
        return real_fused(state, grid_v, c, dt, active)

    monkeypatch.setattr(fs, "fused_substep", fused)
    want = tsolver.simulate_substeps_fused(_torch_state(d), cfg, (), 0.0, DT, 8)
    assert len(seen) == 7 and not sorts
    monkeypatch.setattr(transfer, "p2g", p2g)
    monkeypatch.setattr(transfer, "cell_order", cell_order)
    monkeypatch.setattr(tsolver, "RESORT_EVERY", 3)
    seen.clear()
    got = tsolver.simulate_substeps_fused(_torch_state(d), cfg, (), 0.0, DT, 8)
    assert len(seen) == 7 and len(sorts) == 2                 # renewed at steps 3 and 6
    assert torch.equal(seen[0], torch.as_tensor(d["x"])[first])
    assert torch.equal(seen[3], sorts[0][again])
    for k in FIELDS:
        if k != "stress":
            np.testing.assert_allclose(to_np(getattr(got, k)), to_np(getattr(want, k)), rtol=0,
                                       atol=1e-6 * max(float(getattr(want, k).abs().max()), 1.0),
                                       err_msg=k)
    diff = np.abs(to_np(got.stress) - to_np(want.stress))
    floor = 6 * E * 1.2e-7
    assert (diff <= floor).mean() > 0.9 and diff.max() < 100 * floor
    for k in ("material", "selection", "mass", "vol", "init_cov"):
        assert torch.equal(getattr(got, k), getattr(_torch_state(d), k)), k
