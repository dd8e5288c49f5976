"""The port's sharded MPM frames (``pixie_tpu_torch/sim/solver_dist.py``)
on 2 and 4 gloo processes, against the JAX package's
(pixie_tpu/sim/solver_dist.py on the virtual 8-device mesh of
tests/conftest.py) and against one process.

Bounds are JAX's own (tests/test_solver_dist.py:45-49): x 1e-6, v 1e-4,
F 1e-6; the ranks' splats and the all-reduce sum float32 in another order
than one process.  The processes of one world size start once a module
(``run_ranks``, file:// rendezvous under a temporary directory) and run
every case of that size; the port's P2G returns a random per-rank order in
some cases (``fake_order``), where the card would return its cell order,
so the frame's order bookkeeping on each rank runs here too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from torch_dist_workers import clamp_v0, mpm_inputs, run_ranks, torch_bcs, torch_state

from pixie_tpu.parallel.mesh import get_mesh
from pixie_tpu.sim import bc as jbc
from pixie_tpu.sim import solver as jsolver
from pixie_tpu.sim import solver_dist as jdist
from pixie_tpu.sim.types import MPMConfig as JCfg, finalize_mu_lam, make_state

from pixie_tpu_torch.sim import solver as tsolver
from pixie_tpu_torch.sim import solver_dist as tdist
from pixie_tpu_torch.sim.types import MPMConfig

DT = 1e-4
GRAV = (0.0, 0.0, -9.8)
COLLIDER = ("collider", dict(point=(1.0, 1.0, 0.75), normal=(0.0, 0.0, 1.0)))
IMPULSE = ("impulse", dict(force=(0.0, 0.0, 20.0), z=1.0))
RS_IMPULSE = ("impulse", dict(force=(0.0, 0.0, 5e-4), z=1.5))


def _cfg(n_grid, grid_lim=2.0, mats=(0,), **kw):
    return dict(n_grid=n_grid, grid_lim=grid_lim, gravity=GRAV, active_materials=mats, **kw)


# name -> (world, case); every case of one world size runs in one start of the ranks
CASES = {
    "sharded_2": (2, dict(inputs=dict(n=4000), cfg=_cfg(32), substeps=30, path="sharded")),
    "sharded_4": (4, dict(inputs=dict(n=4000), cfg=_cfg(32), substeps=30, path="sharded",
                          fake_order=True)),
    "padding_4": (4, dict(inputs=dict(n=1003, seed=1), cfg=_cfg(24), substeps=10,
                          path="sharded")),
    "sand_4": (4, dict(inputs=dict(n=4096, seed=2, material=2), cfg=_cfg(24, mats=(2,)),
                       substeps=25, path="sharded", bcs=[COLLIDER])),
    "impulse_4": (4, dict(inputs=dict(n=502), cfg=_cfg(24, mats=()), substeps=5,
                          path="sharded", bcs=[IMPULSE])),
    "rollout_2": (2, dict(inputs=dict(n=3001, seed=4), cfg=_cfg(32), substeps=12,
                          path="rollout", bcs=[IMPULSE, COLLIDER], fake_order=True)),
    "halo48_2": (2, dict(inputs=dict(n=6000, seed=7), cfg=_cfg(48), substeps=10,
                         path="halo", bcs=[COLLIDER])),
    "halo48_4": (4, dict(inputs=dict(n=6000, seed=7), cfg=_cfg(48), substeps=10,
                         path="halo", bcs=[COLLIDER], fake_order=True)),
    "halo96_4": (4, dict(inputs=dict(n=12000, seed=9), cfg=_cfg(96), substeps=8,
                         path="halo", bcs=[IMPULSE])),
    "realscene_2": (2, dict(inputs=dict(n=8000, scene="realscene"),
                            cfg=_cfg(120, 3.0, (2, 3, 5), grid_v_damping_scale=0.9999),
                            substeps=3, path="halo", bcs=[RS_IMPULSE])),
    "clamp_2": (2, dict(inputs=dict(n=2000, scene="clamp"),
                        cfg=dict(n_grid=48, grid_lim=2.0, active_materials=(0,)),
                        substeps=5, path="halo", v0=clamp_v0(2000))),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each case's per-rank results, from one start of 2 and one of 4 ranks."""
    out = {}
    for world in (2, 4):
        names = [k for k, (w, _) in CASES.items() if w == world]
        res = run_ranks(tmp_path_factory.mktemp(f"w{world}"), world, "mpm",
                        {"cases": [CASES[k][1] for k in names]})
        for i, k in enumerate(names):
            out[k] = [r[i] for r in res]
    return out


def _jax_state(case):
    d = mpm_inputs(**case["inputs"])
    kw = {k: v for k, v in d.items() if k not in ("x", "vol")}
    st = finalize_mu_lam(make_state(d["x"], d["vol"], **kw))
    if "v0" in case:
        st = st.replace(v=jnp.asarray(case["v0"]))
    return st, d


def _jax_bcs(case, x):
    out = []
    for kind, kw in case.get("bcs", ()):
        if kind == "collider":
            out.append(jbc.make_surface_collider(kw["point"], kw["normal"], surface="sticky"))
        else:
            out.append(jbc.ParticleImpulse(force=jnp.array(kw["force"]),
                                           mask=jnp.asarray((x[:, 2] > kw["z"]).astype(np.float32)),
                                           start_time=0.0, end_time=1.0))
    return tuple(out)


def _jax_single(case):
    st, d = _jax_state(case)
    out = jsolver.simulate_substeps(st, JCfg(**case["cfg"]), _jax_bcs(case, d["x"]),
                                    jnp.float32(0.0), jnp.float32(DT), case["substeps"])
    return {k: np.asarray(getattr(out, k)) for k in ("x", "v", "F")}


def _port_single(case):
    d = mpm_inputs(**case["inputs"])
    st = torch_state(d)
    if "v0" in case:
        st = st.replace(v=torch.as_tensor(case["v0"]))
    out = tsolver.simulate_substeps(st, MPMConfig(**case["cfg"]), torch_bcs(case.get("bcs", ()),
                                                                             d["x"]),
                                    0.0, DT, case["substeps"])
    return {k: getattr(out, k).numpy() for k in ("x", "v", "F")}


def _rows(per_rank, n):
    """The ranks' blocks of the sharded path, in rank order, without padding."""
    return {k: np.concatenate([r[k] for r in per_rank])[:n] for k in ("x", "v", "F")}


def _close(got, want, v_rel=False):
    """JAX's bounds.  With ``v_rel`` (cases whose particles reach tens to
    hundreds of m/s, where 1e-4 is a few float32 ulps of v): v as JAX holds
    its impulse cases (tests/test_solver_dist.py:320: max |dv| over max |v|
    < 1e-5), and F, whose gradient term scales with v, to 1e-5."""
    np.testing.assert_allclose(got["x"], want["x"], atol=1e-6)
    if v_rel:
        assert np.abs(got["v"] - want["v"]).max() / np.abs(want["v"]).max() < 1e-5
    else:
        np.testing.assert_allclose(got["v"], want["v"], atol=1e-4)
    np.testing.assert_allclose(got["F"], want["F"], atol=1e-5 if v_rel else 1e-6)


# -- the all-reduce path -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["sharded_2", "sharded_4"])
def test_sharded_matches_jax(ranks, name):
    """10k-particle JAX case cut to 4000: the port's ranks against JAX's
    simulate_substeps_sharded on a mesh of the same size, JAX's
    single-device frame and the port's one process."""
    world, case = CASES[name]
    n = case["inputs"]["n"]
    got = _rows(ranks[name], n)
    st, d = _jax_state(case)
    mesh = get_mesh(dp=world // 2, sp=2, devices=jax.devices()[:world])
    out = jdist.simulate_substeps_sharded(jdist.shard_particles(mesh, st), JCfg(**case["cfg"]),
                                          (), jnp.float32(0.0), jnp.float32(DT),
                                          case["substeps"], mesh)
    _close(got, {k: np.asarray(getattr(out, k))[:n] for k in ("x", "v", "F")})
    _close(got, _jax_single(case))
    _close(got, _port_single(case))
    assert np.abs(got["x"] - d["x"]).max() > 4e-5      # gravity moved them (4.6e-5 in 30)


def test_padding_rows_inert(ranks):
    """N = 1003 on 4 ranks: the last rank's block ends in one padded row
    (selection 1, x 1.0) that never moves, and the real rows match."""
    world, case = CASES["padding_4"]
    per = ranks["padding_4"]
    assert all(len(r["x"]) == 251 for r in per)
    last = per[-1]
    assert last["selection_in"][-1] == 1 and (last["selection_in"][:-1] == 0).all()
    np.testing.assert_array_equal(last["x"][-1], last["x_in"][-1])
    np.testing.assert_array_equal(last["x_in"][-1], np.ones(3, np.float32))
    _close(_rows(per, 1003), _jax_single(case))


def test_sand_with_grid_bcs(ranks):
    """Sand and a sticky collider: x at 1e-6; F as JAX holds it (the
    return mapping's branch can flip on borderline particles)."""
    world, case = CASES["sand_4"]
    got, want = _rows(ranks["sand_4"], 4096), _jax_single(case)
    np.testing.assert_allclose(got["x"], want["x"], atol=1e-6)
    diff = np.abs(got["F"] - want["F"])
    assert (diff <= 1e-6).mean() > 0.99 and diff.max() < 5e-2


def test_impulse_mask_sharded_with_rows(ranks):
    """An impulse's mask is padded and cut with the rows (502 on 4 ranks:
    two padded rows): v against JAX's frame to 1e-5 of its scale, and the
    chosen particles pushed up."""
    world, case = CASES["impulse_4"]
    got, want = _rows(ranks["impulse_4"], 502), _jax_single(case)
    assert np.abs(got["v"] - want["v"]).max() / np.abs(want["v"]).max() < 1e-5
    m = mpm_inputs(**case["inputs"])["x"][:, 2] > 1.0
    assert got["v"][m, 2].mean() > 10.0 * max(abs(got["v"][~m, 2].mean()), 1e-3)


def test_rollout_fast_sharded_in_callers_order(ranks):
    """rollout_fast_sharded: every rank returns the whole state in the
    caller's order without padding (3001 on 2 ranks), a random per-rank
    cell order, an impulse and a collider."""
    world, case = CASES["rollout_2"]
    per = ranks["rollout_2"]
    for r in per:
        assert r["x"].shape == (3001, 3)
        np.testing.assert_array_equal(r["x"], per[0]["x"])
    _close(per[0], _jax_single(case))
    _close(per[0], _port_single(case))


# -- the halo path ---------------------------------------------------------------------

def _jax_halo(case, world):
    st, d = _jax_state(case)
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    out = jdist.rollout_halo_sharded(st, JCfg(**case["cfg"]), mesh, bcs=_jax_bcs(case, d["x"]),
                                     n_substeps=case["substeps"], dt=DT, interpret=True)
    return {k: np.asarray(getattr(out, k)) for k in ("x", "v", "F")}


@pytest.mark.parametrize("name", ["halo48_2", "halo48_4"])
def test_halo_matches_jax_halo(ranks, name):
    """n_grid 48 (4 x-tiles) with a sticky collider on 2 and 4 slabs:
    against JAX's rollout_halo_sharded (interpret mode, ~7 s here), JAX's
    single-device frame and the port's one process."""
    world, case = CASES[name]
    got = ranks[name][0]
    for r in ranks[name][1:]:
        np.testing.assert_array_equal(r["x"], got["x"])
    _close(got, _jax_halo(case, world))
    _close(got, _jax_single(case))
    _close(got, _port_single(case))


def test_halo_96_with_impulse(ranks):
    """n_grid 96 (8 x-tiles) on 4 slabs with an impulse, against the
    single-device frames.  JAX's own halo test holds its halo path to its
    single-device one at this size (tests/test_solver_dist.py:152-174)."""
    world, case = CASES["halo96_4"]
    got = ranks["halo96_4"][0]
    _close(got, _jax_single(case), v_rel=True)
    _close(got, _port_single(case), v_rel=True)
    # to its left: 1 plane of 4 channels, 3 of 3; to its right: 3 of 4, 1 of 3
    left, right = 1 * 4 + 3 * 3, 3 * 4 + 1 * 3
    plane = 96 * 96 * 4
    assert [r["bytes"] for r in ranks["halo96_4"]] == [
        right * plane, (left + right) * plane, (left + right) * plane, left * plane]


def test_halo_realscene_shape(ranks):
    """__graft_entry__.py's real-scene-shaped halo case: n_grid 120 (10
    x-tiles, 5 a slab), sand, snow and plasticine, an impulse, 8000
    particles on 2 slabs."""
    world, case = CASES["realscene_2"]
    got = ranks["realscene_2"][0]
    assert np.isfinite(got["x"]).all()
    _close(got, _jax_single(case))
    _close(got, _port_single(case))


def test_halo_band_clamps_as_jax_window(ranks):
    """Particles of slab 0's last x-tile sent over the slab's face at 300
    m/s drift 3.6 cells in 5 substeps, past the band JAX's window reaches
    (one cell).  Their splat and gather are clamped to the band with their
    own weights, as JAX clips them to the tile's window: the port's halo
    frame matches JAX's rollout_halo_sharded (its window clamp; y and z stay
    inside the tile) and not the unclamped one-process frame, whose fast
    particles push the resting ones elsewhere."""
    world, case = CASES["clamp_2"]
    got = ranks["clamp_2"][0]
    _close(got, _jax_halo(case, world), v_rel=True)
    one = _port_single(case)
    assert np.abs(got["v"] - one["v"]).max() > 1e-2
    n = case["inputs"]["n"]
    inv_dx = 48 / 2.0
    base = np.floor(got["x"][: n // 2, 0] * np.float32(inv_dx) - np.float32(0.5))
    assert base.max() > 24 + 1      # beyond the band's last base cell


def test_halo_layout_invariants():
    """tests/test_solver_dist.py:201-232 on the port's layout: a common
    padded count, every slot's particle in its rank's x-slab, every
    particle once."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0.2, 1.8, (30_000, 3)).astype(np.float32)
    n_grid, n_dev = 96, 8
    inv_dx = n_grid / 2.0
    lay = tdist.build_halo_layout(x, n_grid, inv_dx, n_dev)
    t = tdist.n_tiles(n_grid)
    nx = lay["nx"]
    assert nx * n_dev == t and lay["perm"].shape == (n_dev, lay["n_local"])
    base = np.floor(x * inv_dx - 0.5).astype(np.int32)
    tcx = np.clip(base[:, 0] // tdist.TILE, 0, t - 1)
    for d in range(n_dev):
        got = lay["perm"][d][lay["occupied"][d]]
        assert (tcx[got] // nx == d).all()
        assert (np.diff(got) > 0).all()          # the caller's order within a rank
    allp = np.sort(np.concatenate([lay["perm"][d][lay["occupied"][d]] for d in range(n_dev)]))
    np.testing.assert_array_equal(allp, np.arange(len(x)))
    # JAX's layout puts each particle on the same device
    jlay = jdist.build_halo_layout(x, n_grid, inv_dx, n_dev)
    jperm = np.asarray(jlay["perm"]).reshape(n_dev, -1)
    jocc = np.asarray(jlay["occupied"]).reshape(n_dev, -1) > 0
    for d in range(n_dev):
        np.testing.assert_array_equal(np.sort(jperm[d][jocc[d]]),
                                      lay["perm"][d][lay["occupied"][d]])


@pytest.mark.parametrize("n_grid,world", [(120, 3), (120, 4), (96, 3), (48, 3)])
def test_halo_precondition_raises(n_grid, world):
    """n_tiles(n_grid) must be a multiple of the world, as JAX asserts
    (solver_dist.py:350-351): at 120 (10 tiles) 2, 5 or 10 ranks."""
    x = np.full((10, 3), 1.0, np.float32)
    with pytest.raises(ValueError, match="divisible"):
        tdist.build_halo_layout(x, n_grid, n_grid / 2.0, world)
    with pytest.raises(AssertionError):
        jdist.build_halo_layout(x, n_grid, n_grid / 2.0, world)
    for ok in (2, 5, 10) if n_grid == 120 else ():
        tdist.build_halo_layout(x, n_grid, n_grid / 2.0, ok)
