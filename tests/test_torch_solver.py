"""pixie_tpu_torch MPM core vs pixie_tpu: svd3, constitutive models, boundary
conditions, DBSCAN and short rollouts, on the same numpy inputs.

Tolerances, with their reasons:
  * svd3 / stress: the port sums 3x3 products with torch.matmul where the
    JAX code unrolls them, a float32 rounding difference (svd atol 2e-5;
    stresses rtol 1e-4 of stresses up to ~1e4).
  * rollouts (2 frames x 20 substeps): atol 1e-5 on positions in a domain
    of size 2 and 1e-3 on velocities — rounding differences of the scatter
    order grow only slightly over 40 explicit substeps.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import make_pair, to_np

from pixie_tpu.sim import bc as jbc
from pixie_tpu.sim import constitutive as jconst
from pixie_tpu.sim import solver as jsolver
from pixie_tpu.sim import svd3 as jsvd
from pixie_tpu.sim.types import MPMConfig as JCfg
from pixie_tpu_torch.sim import bc as tbc
from pixie_tpu_torch.sim import constitutive as tconst
from pixie_tpu_torch.sim import material_field as tmf
from pixie_tpu_torch.sim import solver as tsolver
from pixie_tpu_torch.sim import svd3 as tsvd
from pixie_tpu_torch.sim.types import MPMConfig as TCfg


# -- svd3 --------------------------------------------------------------------

def _check_convention(f, u, s, v, recon_atol=2e-5):
    np.testing.assert_allclose(np.linalg.det(u), 1.0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(v), 1.0, atol=1e-4)
    assert (s[:, 0] >= s[:, 1] - 1e-6).all() and (s[:, 1] >= np.abs(s[:, 2]) - 1e-6).all()
    det_f = np.linalg.det(f.astype(np.float64))
    neg = det_f < -1e-6
    assert (s[neg, 2] <= 0).all() and (s[det_f > 1e-6, 2] >= 0).all()
    np.testing.assert_allclose(np.einsum("nij,nj,nkj->nik", u, s, v), f, atol=recon_atol)


def test_svd3_matches_jax_well_conditioned():
    rng = np.random.default_rng(0)
    f = (np.eye(3) + 0.3 * rng.normal(size=(400, 3, 3))).astype(np.float32)
    f[::5] *= -1.0  # reflections: sigma[2] must carry sign(det F)
    ju, js, jv = (np.asarray(a) for a in jsvd.svd3(jnp.asarray(f)))
    tu, ts, tv = (to_np(a) for a in tsvd.svd3(torch.as_tensor(f)))
    _check_convention(f, tu, ts, tv)
    gap = np.minimum(js[:, 0] - js[:, 1], js[:, 1] - np.abs(js[:, 2]))
    ok = gap > 1e-2  # vectors are defined up to sign only with distinct sigmas
    np.testing.assert_allclose(ts, js, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tu[ok], ju[ok], atol=2e-4)
    np.testing.assert_allclose(tv[ok], jv[ok], atol=2e-4)


def test_svd3_near_degenerate():
    rng = np.random.default_rng(1)
    r = np.linalg.qr(rng.normal(size=(6, 3, 3)))[0]
    r *= np.sign(np.linalg.det(r))[:, None, None]
    f = np.stack([
        np.eye(3),
        np.eye(3) + 1e-7 * rng.normal(size=(3, 3)),
        np.diag([1.0, 1.0, 0.5]),            # repeated sigma
        np.diag([2.0, 1e-9, 1e-9]),          # rank 1
        np.diag([1.0, 1.0, -1.0]),           # pure reflection
        np.zeros((3, 3)),                    # zero matrix
        r[0] @ np.diag([1.5, 1.5, 1.5]),     # scaled rotation
        r[1] @ np.diag([1.2, 0.7, 0.0]) @ r[2].T,  # singular
    ]).astype(np.float32)
    ju, js, jv = (np.asarray(a) for a in jsvd.svd3(jnp.asarray(f)))
    tu, ts, tv = (to_np(a) for a in tsvd.svd3(torch.as_tensor(f)))
    assert np.isfinite(tu).all() and np.isfinite(tv).all()
    np.testing.assert_allclose(ts, js, atol=2e-5)
    # the F^T F eigen-route loses ~sqrt(eps) on a singular F: 6.1e-5 in both
    # implementations on the last case
    _check_convention(f, tu, ts, tv, recon_atol=1e-4)
    np.testing.assert_allclose(np.einsum("nij,nj,nkj->nik", tu, ts, tv),
                               np.einsum("nij,nj,nkj->nik", ju, js, jv), atol=2e-6)


# -- constitutive --------------------------------------------------------------

def _stress_inputs(n_per=24, mats=range(8), seed=0):
    rng = np.random.default_rng(seed)
    mats = list(mats)
    n = n_per * len(mats)
    d = {"x": rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32),
         "vol": np.full(n, 1e-5, np.float32)}
    F_trial = (np.eye(3) + 0.15 * rng.normal(size=(n, 3, 3))).astype(np.float32)
    material = np.repeat(np.asarray(mats, np.int32), n_per)
    ys = rng.uniform(1e2, 3e3, n).astype(np.float32)
    ys[::7] = 0.0  # fully damaged snow stays elastic
    sel = (np.arange(n) % 11 == 5).astype(np.int32)
    js, ts = make_pair(d, E=1e5, nu=0.3, material=material, F_trial=F_trial,
                       yield_stress=ys, bulk=np.full(n, 5e4, np.float32), selection=sel)
    cfg = dict(n_grid=24, grid_lim=2.0, active_materials=tuple(sorted(set(mats))),
               hardening=1.0, xi=0.1, plastic_viscosity=0.2)
    return js, ts, JCfg(**cfg), TCfg(**cfg)


@pytest.mark.parametrize("mat", range(8))
def test_stress_each_material(mat):
    js, ts, jc, tc = _stress_inputs(mats=[mat])
    want = jconst.compute_stress_from_F_trial(js, jc, jnp.float32(1e-4))
    got = tconst.compute_stress_from_F_trial(ts, tc, np.float32(1e-4))
    scale = max(float(np.abs(np.asarray(want.stress)).max()), 1.0)
    np.testing.assert_allclose(to_np(got.F), np.asarray(want.F), atol=2e-5)
    np.testing.assert_allclose(to_np(got.stress), np.asarray(want.stress),
                               atol=1e-4 * scale)
    for k in ("yield_stress", "mu", "lam"):
        np.testing.assert_allclose(to_np(getattr(got, k)), np.asarray(getattr(want, k)),
                                   rtol=1e-4, atol=1e-3, err_msg=k)
    if mat in (4, 7):  # fluid / background: no branch, zero stress
        assert not np.asarray(want.stress).any() and not to_np(got.stress).any()


def test_stress_mixed_materials():
    js, ts, jc, tc = _stress_inputs(mats=range(8), seed=3)
    want = jconst.compute_stress_from_F_trial(js, jc, jnp.float32(1e-4))
    got = tconst.compute_stress_from_F_trial(ts, tc, np.float32(1e-4))
    scale = float(np.abs(np.asarray(want.stress)).max())
    np.testing.assert_allclose(to_np(got.stress), np.asarray(want.stress), atol=1e-4 * scale)
    np.testing.assert_allclose(to_np(got.F), np.asarray(want.F), atol=2e-5)


# -- boundary conditions ------------------------------------------------------

BC_CASES = {
    "surface_sticky": {"type": "surface_collider", "point": [0, 0, 1.0], "normal": [0, 0.3, 1],
                       "surface": "sticky", "friction": 0.0, "start_time": 0, "end_time": 1},
    "surface_slip": {"type": "surface_collider", "point": [0, 0, 1.0], "normal": [0, 0, 1],
                     "surface": "slip", "friction": 0.0, "start_time": 0, "end_time": 1},
    "cuboid_moving": {"type": "cuboid", "point": [1, 1, 1], "size": [0.3, 0.2, 0.4],
                      "velocity": [0.5, 0, -0.2], "start_time": 0.0, "end_time": 0.5},
    "cuboid_reset": {"type": "cuboid", "point": [1, 1, 1], "size": [0.3, 0.3, 0.3],
                     "velocity": [0, 0, 0], "start_time": 0.0, "end_time": 0.01, "reset": 1},
    "bounding_box": {"type": "bounding_box"},
    "particle_impulse": {"type": "particle_impulse", "force": [-0.5, 0.1, 0.0],
                         "num_dt": 2, "start_time": 0.0, "point": [1, 1, 1], "size": [0.3, 1, 1]},
    "enforce_particle_translation": {"type": "enforce_particle_translation",
                                     "point": [1, 1, 1], "size": [0.3, 0.3, 0.3],
                                     "velocity": [0, 0.4, 0], "start_time": 0, "end_time": 1},
    "release_particles_sequentially": {"type": "release_particles_sequentially",
                                       "normal": [0, 0, 1], "start_position": 0.6,
                                       "end_position": 1.4, "num_layers": 5,
                                       "start_time": 0, "end_time": 0.1},
    "enforce_particle_velocity_rotation": {
        "type": "enforce_particle_velocity_rotation", "point": [1, 1, 1],
        "normal": [0, 0, 1], "half_height_and_radius": [0.3, 0.4],
        "rotation_scale": 2.0, "translation_scale": 0.1, "start_time": 0, "end_time": 1},
}


@pytest.mark.parametrize("name", sorted(BC_CASES))
@pytest.mark.parametrize("time", [0.0, 0.0105, 0.7])
def test_boundary_condition_matches_jax(name, time):
    rng = np.random.default_rng(0)
    n, g = 256, 16
    d = {"x": rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32),
         "vol": np.full(n, 1e-4, np.float32),
         "v": rng.normal(size=(n, 3)).astype(np.float32)}
    js, ts = make_pair(d)
    dt = 1e-3
    tp = {"substep_dt": dt}
    jb = jbc.build_boundary_conditions([BC_CASES[name]], tp, d["x"])
    tb = tbc.build_boundary_conditions([BC_CASES[name]], tp, d["x"])
    assert [type(b).__name__ for b in jb] == [type(b).__name__ for b in tb]
    jc, tc = JCfg(n_grid=g, grid_lim=2.0), TCfg(n_grid=g, grid_lim=2.0)
    t32 = np.float32(time)
    if isinstance(jb[0], jbc.GRID_BC_TYPES):
        grid_v = rng.normal(size=(g, g, g, 3)).astype(np.float32)
        want = jsolver.apply_grid_bcs(jnp.asarray(grid_v), _node_x_jax(jc), jc,
                                      jnp.float32(dt), jnp.float32(time), jb)
        got = tsolver.apply_grid_bcs(torch.as_tensor(grid_v), tsolver.node_positions(tc, "cpu"),
                                     tc, np.float32(dt), t32, tb)
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)
    else:
        for b_j, b_t in zip(jb, tb):
            js = b_j.apply(jnp.float32(time), jnp.float32(dt), js)
            ts = b_t.apply(t32, np.float32(dt), ts)
        np.testing.assert_allclose(to_np(ts.v), np.asarray(js.v), atol=1e-6, rtol=1e-6)


def _node_x_jax(cfg):
    idx = jnp.arange(cfg.n_grid, dtype=jnp.float32) * cfg.dx
    return jnp.stack(jnp.meshgrid(idx, idx, idx, indexing="ij"), axis=-1)


def test_one_substep_impulse_fires_on_the_same_substep():
    """custom_tree_config.json's impulse (num_dt 1): float32 time gating must
    fire it on substep 0 only, as in the JAX scan."""
    d = {"x": np.full((4, 3), 1.0, np.float32), "vol": np.full(4, 1e-4, np.float32)}
    dt = 1e-4
    bcj = jbc.make_particle_impulse(d["x"], [-0.48, 0, 0], dt, num_dt=1)
    bct = tbc.make_particle_impulse(d["x"], [-0.48, 0, 0], dt, num_dt=1)
    for step in range(4):
        t_j = jnp.float32(0.0) + jnp.float32(step) * jnp.float32(dt)
        t_t = np.float32(np.float32(0.0) + np.float32(step) * np.float32(dt))
        js, ts = make_pair(d)
        fired_j = bool(np.asarray(bcj.apply(t_j, jnp.float32(dt), js).v).any())
        fired_t = bool(to_np(bct.apply(t_t, np.float32(dt), ts).v).any())
        assert fired_j == fired_t == (step == 0)


# -- DBSCAN --------------------------------------------------------------------

def test_dbscan_matches_sklearn():
    cluster = pytest.importorskip("sklearn.cluster")
    rng = np.random.default_rng(0)
    pts = np.concatenate([
        rng.normal([0.5, 0.5, 0.5], 0.02, (150, 3)),
        rng.normal([1.2, 0.9, 1.0], 0.015, (90, 3)),
        rng.normal([0.2, 1.5, 0.8], 0.01, (40, 3)),
        rng.uniform(0, 2, (60, 3)),           # noise
    ]).astype(np.float32)
    pts = pts[rng.permutation(len(pts))]
    want = cluster.DBSCAN(eps=0.03, min_samples=8).fit_predict(pts)
    got = tmf.dbscan(pts, eps=0.03, min_samples=8)
    np.testing.assert_array_equal(got, want)


def test_stationary_clusters_and_ground_match_jax():
    pytest.importorskip("sklearn.cluster")
    from pixie_tpu.sim import material_field as jmf

    rng = np.random.default_rng(1)
    pos = rng.uniform(0.6, 1.4, (3000, 3)).astype(np.float32)
    mats = np.where(pos[:, 2] < 0.75, 6, 0).astype(np.int32)
    for only_largest in (True, False):
        assert (tmf.handle_stationary_clusters(pos, mats, only_handle_largest_cluster=only_largest)
                == jmf.handle_stationary_clusters(pos, mats,
                                                  only_handle_largest_cluster=only_largest))
    assert tmf.fix_to_ground(pos, 0.05, 0.5) == jmf.fix_to_ground(pos, 0.05, 0.5)


def test_knn_smoothing_matches_jax():
    from pixie_tpu.sim import material_field as jmf

    rng = np.random.default_rng(2)
    src = rng.uniform(-0.3, 0.3, (500, 3)).astype(np.float32)
    params = {"pos": src, "part_labels": rng.integers(0, 8, 500),
              "density": rng.uniform(100, 900, 500).astype(np.float32),
              "E": rng.uniform(1e4, 1e6, 500).astype(np.float32),
              "nu": rng.uniform(0.2, 0.45, 500).astype(np.float32),
              "material_id": rng.integers(0, 8, 500), "conf": np.ones(500, np.float32)}
    query = (src[:300] + 0.01 * rng.normal(size=(300, 3))).astype(np.float32)
    want = jmf.perform_knn_smoothing(300, query, params, 10, 0.1)
    got = tmf.perform_knn_smoothing(300, query, params, 10, 0.1)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


# -- rollouts ------------------------------------------------------------------

ROLLOUTS = {
    "jelly": dict(material="jelly", E=2e5, nu=0.3),
    "metal": dict(material="metal", E=2e5, nu=0.3, yield_stress=2e3, hardening=1, xi=0.05),
    "sand": dict(material="sand", E=2e5, nu=0.3, friction_angle=35),
    "snow": dict(material="snow", E=2e5, nu=0.3, yield_stress=1e3, softening=0.3),
    "mixed": dict(material="jelly", E=2e5, nu=0.3, yield_stress=1e3, mixed=True),
}


@pytest.mark.parametrize("name", sorted(ROLLOUTS))
def test_rollout_matches_jax(name):
    setup = dict(ROLLOUTS[name])
    mixed = setup.pop("mixed", False)
    rng = np.random.default_rng(7)
    n = 256
    x = rng.uniform(0.8, 1.2, (n, 3)).astype(np.float32)
    vol = np.full(n, 0.4 ** 3 / n, np.float32)
    setup.update(density=300.0, g=[0.0, 0.0, -9.8], rpic_damping=0.1,
                 grid_v_damping_scale=0.999)

    def build(solver):
        solver.load_initial_data(x, vol, n_grid=24, grid_lim=2.0)
        solver.set_parameters_dict(setup)
        if mixed:
            mats = np.array([0, 1, 2, 5, 6, 4, 7], np.int32)[np.arange(n) % 7]
            solver.set_per_particle_materials(300.0, 2e5, 0.3, mats)
        solver.finalize_mu_lam()
        solver.add_surface_collider([0, 0, 0.85], [0, 0, 1], "sticky")
        solver.set_velocity_on_cuboid([1, 1, 1.15], [0.5, 0.5, 0.05], [0, 0, -0.5],
                                      0.0, 1e-3, reset=1)
        solver.add_bounding_box()
        solver.add_impulse_on_particles([0.0, 0.05, 0.0], 1e-4, num_dt=1)
        return solver

    js = build(jsolver.MPMSolver())
    ts = build(tsolver.MPMSolver(device="cpu"))
    assert dataclasses.asdict(js.cfg) == dataclasses.asdict(ts.cfg)  # same static config
    for _ in range(2):
        js.step_frame(20, 1e-4)
        ts.step_frame(20, 1e-4)
    np.testing.assert_allclose(ts.export_particle_x(), js.export_particle_x(), atol=1e-5)
    np.testing.assert_allclose(ts.export_particle_v(), js.export_particle_v(), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(to_np(ts.state.F), np.asarray(js.state.F), atol=1e-4)
    assert np.isfinite(ts.export_particle_x()).all()
