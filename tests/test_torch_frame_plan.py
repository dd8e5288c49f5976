"""The host side of the card's graphed unfused frame, on the CPU.

On the card ``sim/solver.py:simulate_substeps`` replays its substep as a
CUDA graph captured in the frame, on the substeps that ``frame_plan``
allows; the graph bakes in what each BC's ``apply`` decides on the host, so
a substep replays only while its BCs' ``host_key`` is that of the capture.
Here: each BC's key over a window of substeps against what its ``apply``
does there, the plan of frames whose BCs open, close, move or touch the
particles, ``constitutive_pass(out=...)`` (the graphs' constitutive pass),
and that a CPU frame never reaches the graphs.  The graphs themselves run
only on the card (``tests/test_torch_cuda.py -k graph``).  This file
imports no JAX package module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pixie_tpu_torch.ops import constitutive as ops_const
from pixie_tpu_torch.sim import bc
from pixie_tpu_torch.sim import solver as S
from pixie_tpu_torch.sim.constitutive import compute_stress_from_F_trial
from pixie_tpu_torch.sim.types import MPMConfig, finalize_mu_lam, make_state

DT = 1e-4
# a window over substeps 5..9 of a frame from t = 0, its ends between substeps
START, END = 4.5 * DT, 9.5 * DT
STEPS = 30
N_GRID = 16


def _times():
    dt = np.float32(DT)
    return [np.float32(np.float32(0.0) + np.float32(s) * dt) for s in range(STEPS)]


def _nodes():
    cfg = MPMConfig(n_grid=N_GRID, grid_lim=1.0)
    return cfg, S.node_positions(cfg, "cpu")


def _grid_changed(b, t):
    """Whether ``b.apply`` changes a grid of outward unit velocities."""
    cfg, node_x = _nodes()
    v = torch.where(node_x < 0.5, -1.0, 1.0)
    return not torch.equal(b.apply(t, DT, v, node_x, cfg), v)


def _particles_changed(b, t):
    st = make_state(np.full((4, 3), 0.5, np.float32), np.full(4, 1e-3, np.float32))
    return not torch.equal(b.apply(t, DT, st).v, st.v)


def _cuboid(velocity, reset=0):
    return bc.make_cuboid_velocity((0.5, 0.5, 0.5), (0.2, 0.2, 0.2), velocity, START, END, reset)


def _inside(t):
    return 5 <= t < 10


# case -> (BC, what apply changes, its key at substep s)
HOST_KEYS = {
    "still_cuboid": (lambda: _cuboid((0.0, 0.0, 0.0)), _grid_changed,
                     lambda s: (_inside(s), False)),
    "moving_cuboid": (lambda: _cuboid((0.0, 0.0, 1.0)), _grid_changed,
                      lambda s: None if _inside(s) else (False, False)),
    # reset=1 zeroes the whole grid wherever the cuboid is inactive before
    # 15 dt past its window (mpm_solver_warp.py:895-897), so before it too
    "cuboid_with_reset": (lambda: _cuboid((0.0, 0.0, 0.0), reset=1), _grid_changed,
                          lambda s: (_inside(s), not _inside(s) and s < 25)),
    "collider": (lambda: bc.make_surface_collider((0.5, 0.5, 0.5), (0.0, 0.0, 1.0), "sticky",
                                                  start_time=START, end_time=END),
                 _grid_changed, _inside),
    "bounding_box": (lambda: bc.BoundingBox(start_time=START, end_time=END), _grid_changed,
                     _inside),
    "particle_impulse": (lambda: bc.make_particle_impulse(
        np.full((4, 3), 0.5, np.float32), (1.0, 0.0, 0.0), DT, num_dt=5, start_time=START),
        _particles_changed, _inside),
}


@pytest.mark.parametrize("case", sorted(HOST_KEYS))
def test_host_key_is_what_apply_decides(case):
    """Each BC's ``host_key`` over substeps 0..29 of a window over 5..9:
    the expected key, and ``apply`` changes the grid or the particles
    exactly where the key says it acts (active, or a reset's window)."""
    make, changed, want = HOST_KEYS[case]
    b = make()
    for s, t in enumerate(_times()):
        key = b.host_key(t, DT)
        assert key == want(s), (s, key)
        acts = key is None or (any(key) if isinstance(key, tuple) else key)
        assert changed(b, t) == acts, (s, key)


def _plan(eager=(), capture=(), n=STEPS):
    """The plan with these substeps eager and these capturing; replays elsewhere."""
    return tuple("eager" if s in eager else "capture" if s in capture else "replay"
                 for s in range(n))


def _collider(start=0.0, end=999.0):
    return bc.make_surface_collider((0.5, 0.5, 0.1), (0.0, 0.0, 1.0), "sticky",
                                    start_time=start, end_time=end)


def _impulse(num_dt=1, start=0.0):
    return bc.make_particle_impulse(np.full((4, 3), 0.5, np.float32), (1.0, 0.0, 0.0), DT,
                                    num_dt=num_dt, start_time=start)


def _translation(start=0.0, end=999.0):
    return bc.make_particle_translation(np.full((4, 3), 0.5, np.float32), (0.5, 0.5, 0.5),
                                        (0.1, 0.1, 0.1), (0.0, 0.0, 1.0), start, end)


# case -> (BCs, time0, substeps, RESORT_EVERY, the plan)
PLANS = {
    # a re-sort every 100: substeps 0, 100, 200, 300 eager, the two graphs
    # captured at 1 and 2, replayed on the other 394
    "resorts_eager": (lambda: (_collider(),), 0.0, 400, 100,
                      _plan(eager=(0, 100, 200, 300), capture=(1, 2), n=400)),
    "resorts_every_3": (lambda: (), 0.0, 11, 3, _plan(eager=(0, 3, 6, 9), capture=(1, 2), n=11)),
    # the cells' one-substep impulse, active at substep 0 of frame 0 only
    "impulse_frame_0": (lambda: (_collider(), _impulse()), 0.0, 400, 100,
                        _plan(eager=(0, 100, 200, 300), capture=(1, 2), n=400)),
    "impulse_frame_1": (lambda: (_collider(), _impulse()), 400 * DT, 400, 100,
                        _plan(eager=(0, 100, 200, 300), capture=(1, 2), n=400)),
    # an impulse over substeps 5..9 keeps them eager; the keys after it are the capture's
    "impulse_mid_frame": (lambda: (_collider(), _impulse(num_dt=5, start=START)), 0.0, STEPS,
                          100, _plan(eager=(0, 5, 6, 7, 8, 9), capture=(1, 2))),
    # a collider that opens at substep 5 splits the plan: the keys after it
    # are not the capture's, so those substeps run eager
    "window_opens_mid_frame": (lambda: (_collider(start=START),), 0.0, 12, 100,
                               _plan(eager=(0,) + tuple(range(5, 12)), capture=(1, 2), n=12)),
    "moving_cuboid_active": (lambda: (_collider(), bc.make_cuboid_velocity(
        (0.5, 0.5, 0.5), (0.1, 0.1, 0.1), (0.0, 0.0, 1.0))), 0.0, 12, 100,
        ("eager",) * 12),
    # while it moves, eager; once it has stopped (substep 10 on), replayed
    "moving_cuboid_stops": (lambda: (bc.make_cuboid_velocity(
        (0.5, 0.5, 0.5), (0.1, 0.1, 0.1), (0.0, 0.0, 1.0), end_time=END),), 0.0, STEPS, 100,
        _plan(eager=tuple(range(10)), capture=(10, 11))),
    "particle_bc_throughout": (lambda: (_collider(), _translation()), 0.0, 12, 3,
                               ("eager",) * 12),
    "one_substep": (lambda: (_collider(),), 0.0, 1, 100, ("eager",)),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_frame_plan(case, monkeypatch):
    """``frame_plan``: re-sorts, active particle BCs, active moving cuboids
    and substeps whose keys differ from the first capture's run eager; the
    first two others capture, the rest replay."""
    make, time0, n, every, want = PLANS[case]
    monkeypatch.setattr(S, "RESORT_EVERY", every)
    got = S.frame_plan(make(), time0, DT, n)
    assert got == want, [(s, g, w) for s, (g, w) in enumerate(zip(got, want)) if g != w]


def _mixed_state(n=300, seed=2):
    rng = np.random.default_rng(seed)
    st = finalize_mu_lam(make_state(
        rng.uniform(0.3, 0.7, (n, 3)).astype(np.float32), np.full(n, 1e-6, np.float32),
        E=2e5, nu=0.3, material=np.array([0, 1, 2, 6], np.int32)[np.arange(n) % 4],
        yield_stress=rng.uniform(50.0, 400.0, n).astype(np.float32)))
    return st.replace(
        F_trial=torch.as_tensor((np.eye(3) + 0.03 * rng.normal(size=(n, 3, 3))).astype(np.float32)),
        selection=torch.as_tensor((np.arange(n) % 7 == 3).astype(np.int32)))


def test_constitutive_pass_writes_out():
    """``constitutive_pass(out=...)`` on CPU tensors: the plain pass's five
    fields, written into the given tensors and returned in them; the input
    state's tensors keep their values."""
    st = _mixed_state()
    cfg = MPMConfig(n_grid=N_GRID, grid_lim=1.0, active_materials=(0, 1, 2, 6), hardening=1.0,
                    xi=0.1, friction_angle=30.0)
    before = {f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)}
    out = {k: torch.full_like(getattr(st, k), float("nan")) for k in ops_const.OUTPUTS}
    got = ops_const.constitutive_pass(st, cfg, DT, out=out)
    want = compute_stress_from_F_trial(_mixed_state(), cfg, DT)
    for k in ops_const.OUTPUTS:
        assert getattr(got, k) is out[k], k
        assert torch.equal(out[k], getattr(want, k)), k
    for k, t in before.items():
        assert torch.equal(getattr(st, k), t), k
    assert not torch.equal(got.F, st.F)       # the active rows did change


def test_cpu_frame_never_reaches_the_graphs(monkeypatch):
    """A CPU frame runs every substep eagerly: no capture or replay
    counted, no plan made, and the state bitwise that of ``run_frame`` over
    ``_substep``."""
    st = _mixed_state()
    cfg = MPMConfig(n_grid=N_GRID, grid_lim=1.0, gravity=(0.0, 0.0, -9.8),
                    active_materials=(0, 1, 2, 6))
    bcs = (_collider(),)
    counts = (S.GRAPH_CAPTURES, S.GRAPH_REPLAYS)

    def no_plan(*a):
        raise AssertionError("a CPU frame made a plan")

    def fresh():
        return st.replace(**{f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)})

    dt, node_x = np.float32(DT), S.node_positions(cfg, "cpu")
    want = S.run_frame(fresh(), bcs, np.float32(0.0), dt, 6,
                       lambda s, b, t, r: S._substep(s, cfg, b, t, dt, node_x, r))
    monkeypatch.setattr(S, "frame_plan", no_plan)
    got = S.simulate_substeps(fresh(), cfg, bcs, 0.0, DT, 6)
    assert (S.GRAPH_CAPTURES, S.GRAPH_REPLAYS) == counts
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
