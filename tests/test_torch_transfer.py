"""P2G / G2P of pixie_tpu_torch.ops.transfer vs the JAX package.

On the CPU the wrappers run their plain PyTorch versions; those are held
against ``pixie_tpu/sim/solver.py`` p2g/g2p and against the Pallas TPU
kernels (``p2g_tiled_t``, ``p2g2p_fast``) run in interpret mode, on the
random state of tests/test_fast_solver.py:23-38 (n=300, n_grid=24).

Tolerances: vs solver.py the arithmetic is the same term for term and
only the scatter order of index_add_ differs, so the grids agree to float32
rounding (atol 1e-6 on momenta of ~4e-3).  Vs the Pallas kernels the bounds
are those of tests/test_fast_solver.py:60-110, which hold the kernels to
solver.py (their MXU contractions sum in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_state_close, configs, make_pair, random_particles, to_np

from pixie_tpu.sim import solver as jsolver
from pixie_tpu_torch.ops import transfer
from pixie_tpu_torch.sim import solver as tsolver

DT = 1e-4
SOLVER_TOL = {"v": (1e-6, 1e-5), "x": (1e-7, 1e-6), "C": (5e-4, 1e-4),
              "F_trial": (1e-7, 1e-6)}
PALLAS_TOL = {"v": (2e-5, 1e-4), "x": (2e-6, 1e-5), "C": (2e-3, 1e-3),
              "F_trial": (1e-5, 1e-4)}


def _setup(n=300, n_grid=24, seed=0, **cfg_kw):
    d = random_particles(n, seed)
    js, ts = make_pair(d)
    jc, tc = configs(n_grid=n_grid, grid_lim=2.0, gravity=(0.0, 0.0, -9.8), **cfg_kw)
    return js, ts, jc, tc


@pytest.mark.parametrize("rpic", [0.0, 0.3, -1.0])
def test_p2g_matches_solver(rpic):
    js, ts, jc, tc = _setup(rpic_damping=rpic)
    want = np.asarray(jsolver.p2g(js, jc, DT))
    got = to_np(tsolver.p2g(ts, tc, DT))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_p2g_drops_out_of_grid_and_inactive():
    d = random_particles(200, seed=3)
    d["x"][:20] = np.float32(0.01)       # stencil hangs off the low faces
    d["x"][20:40] = np.float32(1.99)     # ... and the high faces
    sel = np.zeros(200, np.int32)
    sel[40:60] = 1
    js, ts = make_pair(d, selection=sel)
    jc, tc = configs(n_grid=24, grid_lim=2.0)
    want = np.asarray(jsolver.p2g(js, jc, DT))
    got = to_np(tsolver.p2g(ts, tc, DT))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    inside = (d["x"] > 0.05).all(1) & (d["x"] < 1.95).all(1) & (sel == 0)
    mass = to_np(ts.mass)
    assert got[..., 3].sum() < mass[sel == 0].sum()
    assert got[..., 3].sum() >= mass[inside].sum() * (1 - 1e-5)


def test_p2g_conserves_mass_and_momentum():
    d = random_particles(500, seed=1)
    d["stress"][:] = 0.0          # stress forces sum to zero only on a full stencil
    d["C"][:] = 0.0               # APIC affine terms carry no net momentum
    _, ts = make_pair(d)
    _, tc = configs(n_grid=24, grid_lim=2.0)
    grid = to_np(tsolver.p2g(ts, tc, DT)).astype(np.float64)
    mass = to_np(ts.mass).astype(np.float64)
    np.testing.assert_allclose(grid[..., 3].sum(), mass.sum(), rtol=1e-5)
    np.testing.assert_allclose(grid[..., :3].reshape(-1, 3).sum(0),
                               (mass[:, None] * d["v"]).sum(0), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("update_cov", [False, True])
def test_g2p_matches_solver(update_cov):
    js, ts, jc, tc = _setup(update_cov_with_F=update_cov)
    cov = np.random.default_rng(5).normal(size=(300, 6)).astype(np.float32)
    sel = (np.arange(300) % 7 == 0).astype(np.int32)
    js = js.replace(cov=jnp.asarray(cov), selection=jnp.asarray(sel))
    ts = ts.replace(cov=torch.as_tensor(cov), selection=torch.as_tensor(sel))
    grid_v = np.random.default_rng(2).normal(size=(24, 24, 24, 3)).astype(np.float32)
    want = jsolver.g2p(js, jnp.asarray(grid_v), jc, jnp.float32(DT))
    got = tsolver.g2p(ts, torch.as_tensor(grid_v), tc, np.float32(DT))
    assert_state_close(want, got, {**SOLVER_TOL, "cov": (1e-6, 1e-5)})
    # selection != 0 particles are untouched
    np.testing.assert_array_equal(to_np(got.x)[sel == 1], random_particles()["x"][sel == 1])


def test_substep_matches_solver():
    js, ts, jc, tc = _setup()
    want = jsolver.p2g2p(js, jc, (), jnp.float32(0.0), jnp.float32(DT))
    got = tsolver.p2g2p(ts, tc, (), np.float32(0.0), np.float32(DT))
    assert_state_close(want, got, SOLVER_TOL)


def test_p2g_matches_pallas_interpret():
    from pixie_tpu.ops import tiling
    from pixie_tpu.ops import transfer as jtransfer
    from pixie_tpu.sim import soa
    from pixie_tpu.sim.solver_fast import (
        pad_state_to_layout, state_to_soa, windows_to_combine_layout,
    )

    js, ts, jc, tc = _setup()
    layout = tiling.build_padded_layout(np.asarray(js.x), jc.n_grid, jc.inv_dx)
    sd = state_to_soa(pad_state_to_layout(js, layout))
    tile_rows = [jnp.repeat(layout["tile_coords"][:, a], tiling.PBLK) for a in range(3)]
    act = (sd["selection"] == 0).astype(jnp.float32)
    pdata_t = jtransfer.build_pdata_rows(
        soa.unpack(sd["x"]), soa.unpack(sd["v"]), soa.unpack(sd["C"]),
        soa.unpack(sd["stress"]), sd["mass"] * act, sd["vol"] * act, tile_rows,
        DT, jc.dx, jc.inv_dx)
    t = tiling.n_tiles(jc.n_grid)
    wins = jtransfer.p2g_tiled_t(pdata_t, layout["block_tile"], t ** 3 * tiling.NSLAB,
                                 interpret=True)
    want = np.asarray(tiling.combine_windows(windows_to_combine_layout(wins, t),
                                             jc.n_grid, 4))
    got = to_np(tsolver.p2g(ts, tc, DT))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_substep_matches_pallas_interpret():
    from pixie_tpu.ops import tiling
    from pixie_tpu.sim.solver_fast import p2g2p_fast, pad_state_to_layout, unpad_state

    js, ts, jc, tc = _setup()
    layout = tiling.build_padded_layout(np.asarray(js.x), jc.n_grid, jc.inv_dx)
    out = p2g2p_fast(pad_state_to_layout(js, layout), layout, jc, (),
                     jnp.float32(0.0), jnp.float32(DT), interpret=True)
    want = unpad_state(out, layout, js.n_particles)
    got = tsolver.p2g2p(ts, tc, (), np.float32(0.0), np.float32(DT))
    assert_state_close(want, got, PALLAS_TOL)


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """Only CPU tensors take the plain versions: any other device goes to
    the kernel path, which raises for a device it does not handle."""
    js, ts, jc, tc = _setup(n=8)

    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(transfer, "p2g_plain", boom)
    monkeypatch.setattr(transfer, "g2p_plain", boom)
    fake = torch.empty(0, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        transfer.p2g(fake, fake, fake, fake, fake, fake, fake, tc, DT)
