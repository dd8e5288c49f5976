"""Golden rollouts of the port: ``pixie_tpu_torch.sim.solver.simulate_substeps``
(CPU, plain P2G/G2P) against the scalar float64 NumPy oracle
(tests/oracle_mpm.py), on the seven scenes of tests/test_oracle_rollout.py
(:56-121) at that file's tolerances: jelly, sand, metal, snow, mixed
materials, RPIC + grid damping, and covariance transport.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets the torch thread count)
from oracle_mpm import OracleParams, make_oracle_state, substep
from torch_parity import to_np

from pixie_tpu_torch.sim.solver import simulate_substeps
from pixie_tpu_torch.sim.types import MPMConfig, finalize_mu_lam, make_state

_ORACLE_KEYS = ("rpic_damping", "grid_v_damping_scale", "hardening", "xi",
                "friction_angle", "plastic_viscosity", "softening")


def _run_pair(x, vol, n_substeps, dt=1e-4, material=0, E=1e5, nu=0.3, density=200.0,
              yield_stress=0.0, gravity=(0.0, 0.0, -9.8), update_cov=False, cov=None,
              **cfg_kw):
    """tests/test_oracle_rollout.py:_run_pair with the port's solver."""
    mats = np.unique(np.atleast_1d(material)).tolist()
    cfg = MPMConfig(n_grid=16, grid_lim=2.0, gravity=gravity, update_cov_with_F=update_cov,
                    active_materials=tuple(int(m) for m in mats), **cfg_kw)
    vol = np.full(len(x), vol, np.float32) if np.ndim(vol) == 0 else vol
    st = finalize_mu_lam(make_state(x, vol, density=density, E=E, nu=nu, material=material,
                                    yield_stress=yield_stress, init_cov=cov))
    out = simulate_substeps(st, cfg, (), 0.0, dt, n_substeps)

    prm = OracleParams(n_grid=16, grid_lim=2.0, gravity=gravity, update_cov_with_F=update_cov,
                       **{k: v for k, v in cfg_kw.items() if k in _ORACLE_KEYS})
    ost = make_oracle_state(x, vol, density=density, E=E, nu=nu, material=material,
                            yield_stress=yield_stress, cov=cov)
    for _ in range(n_substeps):
        substep(ost, prm, dt)
    return out, ost


def _block(rng, n=64, center=(1.0, 1.0, 1.2), half=0.15):
    return (np.asarray(center) + rng.uniform(-half, half, (n, 3))).astype(np.float32)


_MIXED = np.array([0] * 16 + [1] * 16 + [2] * 16 + [5] * 16 + [6] * 16, np.int32)
_COV = np.tile(np.array([1e-4, 0, 0, 1e-4, 0, 1e-4]), (64, 1))

# name: (seed, block kwargs, _run_pair kwargs, {field: (atol, rtol)})
SCENES = {
    "jelly": (0, {}, dict(n_substeps=50, E=2e5, nu=0.4),
              {"x": (2e-5, 0), "v": (2e-3, 0), "F": (2e-4, 0), "C": (2e-2, 0)}),
    "sand": (1, {}, dict(n_substeps=40, material=2, E=5e5, nu=0.3, density=1000.0),
             {"x": (2e-5, 0), "v": (2e-3, 0), "F": (5e-4, 0)}),
    "metal": (2, dict(half=0.1), dict(n_substeps=40, material=1, E=1e6, nu=0.3,
                                      density=2000.0, yield_stress=1e3),
              {"x": (2e-5, 0), "F": (5e-4, 0), "yield_stress": (0, 1e-4)}),
    "snow": (3, {}, dict(n_substeps=40, material=5, E=2e5, nu=0.3, density=400.0,
                         yield_stress=5e2, softening=0.1),
             {"x": (2e-5, 0), "F": (5e-4, 0)}),
    "mixed": (4, dict(n=80, half=0.2), dict(n_substeps=30, material=_MIXED, E=3e5, nu=0.3,
                                            density=500.0, yield_stress=1e3),
              {"x": (2e-5, 0), "v": (2e-3, 0), "F": (5e-4, 0)}),
    "damping": (5, {}, dict(n_substeps=30, E=2e5, nu=0.35, rpic_damping=0.5,
                            grid_v_damping_scale=0.9999),
                {"x": (2e-5, 0), "v": (2e-3, 0)}),
    "cov_transport": (6, {}, dict(n_substeps=30, E=2e5, nu=0.4, update_cov=True, cov=_COV),
                      {"cov": (1e-9, 1e-3)}),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_port_rollout_matches_oracle(scene):
    seed, block_kw, run_kw, tol = SCENES[scene]
    x = _block(np.random.default_rng(seed), **block_kw)
    out, ost = _run_pair(x, 1e-6, **run_kw)
    for field, (atol, rtol) in tol.items():
        got = to_np(getattr(out, field))
        assert np.isfinite(got).all(), field
        np.testing.assert_allclose(got, ost[field], atol=atol, rtol=rtol, err_msg=field)
    assert isinstance(out.x, torch.Tensor) and out.x.device.type == "cpu"


def test_rollout_leaves_the_input_positions_alone():
    """make_state copies x: the in-place G2P advection must not write the
    rollout back into the caller's array (it once did, and every oracle
    scene above then started the oracle from the moved positions)."""
    x = _block(np.random.default_rng(0))
    before = x.copy()
    st = finalize_mu_lam(make_state(x, np.full(len(x), 1e-6, np.float32)))
    simulate_substeps(st, MPMConfig(n_grid=16, grid_lim=2.0, gravity=(0.0, 0.0, -9.8)),
                      (), 0.0, 1e-4, 3)
    np.testing.assert_array_equal(x, before)
