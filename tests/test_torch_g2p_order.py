"""The unfused frame in a cell order (``sim/solver.py:simulate_substeps``),
emulated on the CPU.

On the card P2G returns the cell order it splatted in, and the unfused
frame permutes its state into that order between P2G and G2P of substep 0
and every RESORT_EVERY substeps, so that G2P's lanes of one cell gather the
same nodes; the particle BCs' masks travel with the state, and the frame
hands its state back in the caller's order.  On the CPU P2G returns no order
and the state keeps its order.  Here a fake P2G returns a random
permutation where the card's would return the cell order, so the frame's
bookkeeping runs on the CPU: against the frame in the caller's order (P2G
sums its particles in another order: every field within 1e-5 of its largest
value; inactive particles and the particles each BC selects identical), and
against JAX's ``simulate_substeps`` at the tolerances of
tests/test_torch_solver.py's rollouts (x atol 1e-5, v atol and rtol 1e-3,
F atol 1e-4), which a mask left in the caller's order fails.
"""

import numpy as np
import pytest
import torch

from torch_parity import to_np

from pixie_tpu_torch.ops import transfer
from pixie_tpu_torch.sim import bc as tbc
from pixie_tpu_torch.sim import solver as tsolver
from pixie_tpu_torch.sim.types import MPMConfig, finalize_mu_lam, make_state

MATS = (0, 1, 2, 3, 5, 6)
E, DT, N, SUBSTEPS = 2e5, 1e-4, 1000, 5
FIELDS = ("x", "v", "C", "F", "F_trial", "stress", "mu", "lam", "yield_stress", "cov")
CFG_KW = dict(n_grid=16, grid_lim=2.0, gravity=(0.0, 0.0, -9.8), rpic_damping=0.1,
              update_cov_with_F=True, active_materials=MATS, hardening=1.0, xi=0.1,
              plastic_viscosity=0.05, softening=0.5, friction_angle=30.0)
# the impulse fires on substeps 0..3 and the translation over the frame, so
# both apply after the frame's first re-sorts (RESORT_EVERY 2: substeps 0, 2, 4)
BC_SPECS = [
    {"type": "particle_impulse", "force": [0.0, 0.02, 0.01], "point": [1.0, 1.0, 1.0],
     "size": [0.2, 0.2, 0.2], "num_dt": 4},
    {"type": "enforce_particle_translation", "point": [0.85, 0.9, 1.0], "size": [0.1, 0.1, 0.3],
     "velocity": [0.0, 0.0, 2.0], "start_time": 0.0, "end_time": 1.0},
    {"type": "surface_collider", "point": [1.0, 1.0, 0.75], "normal": [0.0, 0.0, 1.0],
     "surface": "sticky", "friction": 0.0, "start_time": 0.0, "end_time": 1e3},
]


def _inputs(seed=11):
    """numpy arrays of a mixed block: ids 0, 1, 2, 3, 5, 6 in turn, yield
    stresses low enough that von Mises and snow yield, every 17th particle
    inactive."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(N, 6)).astype(np.float32) * 1e-4
    c[:, [0, 3, 5]] += 1e-3
    return {"x": rng.uniform(0.7, 1.3, (N, 3)).astype(np.float32),
            "vol": np.full(N, 1e-6, np.float32),
            "v": (0.5 * rng.normal(size=(N, 3))).astype(np.float32),
            "F": (np.eye(3) + 0.04 * rng.normal(size=(N, 3, 3))).astype(np.float32),
            "material": np.asarray(MATS, np.int32)[np.arange(N) % len(MATS)],
            "yield_stress": rng.uniform(50.0, 400.0, N).astype(np.float32),
            "selection": (np.arange(N) % 17 == 4).astype(np.int32),
            "cov": c}


def _torch_state(d):
    """The state, its reserved Jp holding each particle's index (a tag that
    travels with the particle: nothing reads or writes Jp)."""
    st = finalize_mu_lam(make_state(d["x"], d["vol"], density=300.0, E=E, nu=0.3,
                                    material=d["material"], yield_stress=d["yield_stress"]))
    return st.replace(v=torch.tensor(d["v"]), F=torch.tensor(d["F"]),
                      F_trial=torch.tensor(d["F"]), cov=torch.tensor(d["cov"]),
                      selection=torch.tensor(d["selection"]),
                      Jp=torch.arange(N, dtype=torch.float32))


def _frame(d, monkeypatch, ordered: bool):
    """One unfused frame of SUBSTEPS on the CPU.  With ``ordered``, P2G
    returns a random permutation as its order (the card returns its cell
    order) and the frame re-sorts every 2 substeps.  Returns the state and,
    for each particle-BC application, the tags of the particles it chose."""
    bcs = tbc.build_boundary_conditions(BC_SPECS, {"substep_dt": DT}, d["x"])
    chosen = []
    for cls in (tbc.ParticleImpulse, tbc.ParticleVelocityTranslation):
        def spy(self, time, dt, state, real=cls.apply):
            if tbc._active(time, self.start_time, self.end_time):
                chosen.append((type(self).__name__, sorted(state.Jp[self.mask].tolist())))
            return real(self, time, dt, state)

        monkeypatch.setattr(cls, "apply", spy)
    orders = []
    if ordered:
        real_p2g, rng = transfer.p2g, np.random.default_rng(5)

        def p2g(*a, return_order=False, **k):
            grid = real_p2g(*a, **k)
            if not return_order:
                return grid
            orders.append(torch.as_tensor(rng.permutation(N)))
            return grid, orders[-1]

        monkeypatch.setattr(transfer, "p2g", p2g)
        monkeypatch.setattr(tsolver, "RESORT_EVERY", 2)
    st = tsolver.simulate_substeps(_torch_state(d), MPMConfig(**CFG_KW), bcs, 0.0, DT, SUBSTEPS)
    monkeypatch.undo()
    assert len(orders) == (SUBSTEPS if ordered else 0)
    return st, chosen


def test_unfused_frame_in_a_cell_order_matches_the_callers_order(monkeypatch):
    d = _inputs()
    want, chose_want = _frame(d, monkeypatch, ordered=False)
    got, chose_got = _frame(d, monkeypatch, ordered=True)
    assert torch.equal(got.Jp, torch.arange(N, dtype=torch.float32))   # the caller's order back
    for k in FIELDS:
        w = to_np(getattr(want, k))
        np.testing.assert_allclose(to_np(getattr(got, k)), w, rtol=0,
                                   atol=1e-5 * max(float(np.abs(w).max()), 1e-30), err_msg=k)
    inactive = d["selection"] != 0
    assert inactive.any()
    for k in FIELDS + ("material", "selection", "mass", "vol", "init_cov"):
        np.testing.assert_array_equal(to_np(getattr(got, k))[inactive],
                                      to_np(getattr(want, k))[inactive], err_msg=k)
    # each BC chose the same particles at every substep it applied
    assert chose_got == chose_want
    assert {name for name, _ in chose_want} == {"ParticleImpulse", "ParticleVelocityTranslation"}
    assert len(chose_want) == 4 + SUBSTEPS and all(tags for _, tags in chose_want)


@pytest.fixture(scope="module")
def jax_frame():
    """JAX's simulate_substeps on the same inputs and BCs (numpy out)."""
    import jax.numpy as jnp

    from pixie_tpu.sim import bc as jbc
    from pixie_tpu.sim import solver as jsolver
    from pixie_tpu.sim.types import MPMConfig as JCfg
    from pixie_tpu.sim.types import finalize_mu_lam as jfin
    from pixie_tpu.sim.types import make_state as jmake

    d = _inputs()
    st = jfin(jmake(d["x"], d["vol"], density=300.0, E=E, nu=0.3, material=d["material"],
                    yield_stress=d["yield_stress"]))
    st = st.replace(v=jnp.asarray(d["v"]), F=jnp.asarray(d["F"]), F_trial=jnp.asarray(d["F"]),
                    cov=jnp.asarray(d["cov"]), selection=jnp.asarray(d["selection"]))
    bcs = jbc.build_boundary_conditions(BC_SPECS, {"substep_dt": DT}, d["x"])
    out = jsolver.simulate_substeps(st, JCfg(**CFG_KW), bcs, jnp.float32(0.0), jnp.float32(DT),
                                    SUBSTEPS)
    return {k: np.asarray(getattr(out, k)) for k in ("x", "v", "F")}


@pytest.mark.parametrize("masks", ["travel", "stay"])
def test_unfused_frame_in_a_cell_order_matches_jax(jax_frame, monkeypatch, masks):
    """The frame in a (fake) cell order against JAX's; with the BCs' masks
    left in the caller's order ("stay") the comparison must fail."""
    if masks == "stay":
        monkeypatch.setattr(tsolver, "_permute_bcs", lambda bcs, idx: bcs)
    got, _ = _frame(_inputs(), monkeypatch, ordered=True)

    def compare():
        np.testing.assert_allclose(to_np(got.x), jax_frame["x"], atol=1e-5)
        np.testing.assert_allclose(to_np(got.v), jax_frame["v"], atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(to_np(got.F), jax_frame["F"], atol=1e-4)

    if masks == "travel":
        compare()
    else:
        with pytest.raises(AssertionError):
            compare()
