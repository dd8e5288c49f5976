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


# -- the binned decomposition of the CUDA P2G, emulated in plain PyTorch ---------

BLOCK = 256                        # csrc/transfer.cu kThreads


def _binned_emulation(x, v, C, stress, mass, vol, active, cfg, dt):
    """The index math of csrc/transfer.cu's binned P2G on the CPU: bin keys,
    sorted; per warp of 32 sorted positions, each run of lanes with one base
    cell sums its 27 nodes' values, added into the grid by index where the
    node is in the grid."""
    g = cfg.n_grid
    nb, hbits = transfer.bin_layout(g)
    keys, perm = torch.sort(transfer.p2g_bin_keys_plain(x, active, g, cfg.inv_dx))
    bins = (keys >> hbits).to(torch.int64)
    vals, _ = transfer.p2g_contributions(x, v, C, stress, mass, vol, active, cfg, dt)
    base, *_ = transfer._spline_weights(x, cfg.inv_dx)
    node = base[None] + torch.as_tensor(transfer._OFFSETS)[:, None, :]       # (27, N, 3)
    in_grid = ((node >= 0) & (node < g)).all(-1)
    grid = torch.zeros((g ** 3, 4))
    side = g + 2
    cell = ((base[:, 0] + 2) * side + base[:, 1] + 2) * side + base[:, 2] + 2
    for w0 in range(0, x.shape[0], 32):
        lanes = perm[w0:w0 + 32][bins[w0:w0 + 32] < nb ** 3]
        c = cell[lanes]
        run = torch.cumsum(torch.cat([torch.ones(1, dtype=torch.bool), c[1:] != c[:-1]]), 0)
        assert int(run[-1]) == len(torch.unique(c)) if len(c) else True   # cells adjacent
        for r in range(1, int(run[-1]) + 1 if len(c) else 1):
            members = lanes[run == r]
            total = vals[:, members].sum(1)                             # (27, 4)
            nd, ok = node[:, members[0]], in_grid[:, members[0]]
            flat = (nd[:, 0] * g + nd[:, 1]) * g + nd[:, 2]
            grid.index_add_(0, flat[ok], total[ok])
    return grid.reshape(g, g, g, 4)


def _binned_scene(case, n_grid=24, seed=0):
    """random: 3000 particles in [0.4, 1.6]^3 (~3 a cell); faces: 400 within
    a cell of the low grid faces, 400 of the high ones, 10 with no in-grid
    node, every 13th inactive; one_cell: all 3000 in one cell; sparse: 60
    over the whole grid (bins of one or two particles: the direct splat);
    one_particle: n = 1."""
    n = {"sparse": 60, "one_particle": 1}.get(case, 3000)
    d = random_particles(n, seed)
    x, dx = d["x"], 2.0 / n_grid
    rng = np.random.default_rng(seed + 1)
    active = np.ones(n, bool)
    if case == "faces":
        x[:400] = rng.uniform(0.0, dx, (400, 3))
        x[400:800] = 2.0 - rng.uniform(0.0, dx, (400, 3))
        x[800:810] = [-0.5, 1.0, 1.0]
        active[::13] = False
    elif case == "one_cell":
        x[:] = 1.0 + dx * rng.uniform(0.55, 1.45, (n, 3))
    elif case == "sparse":
        x[:] = rng.uniform(0.0, 2.0, (n, 3))
    cfg = configs(n_grid=n_grid, grid_lim=2.0, rpic_damping=0.1)[1]
    args = [torch.as_tensor(a) for a in (x, d["v"], d["C"], d["stress"])]
    args += [torch.full((n,), 1.0 / n), torch.as_tensor(d["vol"]), torch.as_tensor(active)]
    return args, cfg


@pytest.mark.parametrize("order", ["given", "cell_sorted"])
@pytest.mark.parametrize("case", ["random", "faces", "one_cell", "sparse", "one_particle"])
def test_binned_p2g_decomposition_matches_plain(case, order):
    """The CUDA P2G's bins and runs, emulated on the CPU, give p2g_plain's
    grid to 1e-6 of its largest value (the sums run in another order), for
    the particles in their given order and sorted by base cell (the keys'
    hash of the index then orders a cell's particles otherwise); every
    particle of one cell is one bin larger than a block."""
    args, cfg = _binned_scene(case)
    off = torch.zeros(args[0].shape[0], dtype=torch.bool)   # faces: no in-grid node
    off[800:810] = case == "faces"
    if order == "cell_sorted":
        base = torch.floor(args[0] * cfg.inv_dx - 0.5).long()
        g = cfg.n_grid + 4
        perm = torch.argsort(((base[:, 0] * g + base[:, 1]) * g + base[:, 2]), stable=True)
        args, off = [a[perm] for a in args], off[perm]
    want = transfer.p2g_plain(*args, cfg, DT)
    got = _binned_emulation(*args, cfg, DT)
    scale = float(want.abs().max())
    assert scale > 0.0
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=1e-6 * scale)
    keys = transfer.p2g_bin_keys_plain(args[0], args[6], cfg.n_grid, cfg.inv_dx)
    nb, hbits = transfer.bin_layout(cfg.n_grid)
    counts = torch.bincount((keys >> hbits).long(), minlength=nb ** 3 + 1)
    if case == "one_cell":
        assert int(counts[:-1].max()) == 3000 > BLOCK            # one bin over 12 blocks
    if case == "faces":   # no bin: the inactive ones and the active ones off the grid
        assert int(counts[-1]) == int((~args[6]).sum()) + int((args[6] & off).sum())


def test_bin_keys_order_cells_within_a_bin():
    """A bin's particles sort by their cell within the bin, so the lanes of
    one cell are adjacent; below the cell bits a hash of the index, so a
    cell's particles come in a pseudo-random order."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor((1.065 + 0.15 * rng.random((4096, 3))).astype(np.float32))  # bin 7
    active = torch.ones(4096, dtype=torch.bool)
    nb, hbits = transfer.bin_layout(50)
    keys, perm = torch.sort(transfer.p2g_bin_keys_plain(x, active, 50, 25.0))
    base = torch.floor(x * 25.0 - 0.5).long()[perm] + 2
    flat = (base[:, 0] * 52 + base[:, 1]) * 52 + base[:, 2]
    assert int((keys >> hbits).unique().numel()) == 1                    # one bin
    assert int((flat[1:] != flat[:-1]).sum()) == len(flat.unique()) - 1  # each cell one run
    gaps = (perm[1:33] - perm[:32]).abs()
    assert int(gaps.min()) > 1 and len(set(perm[:32].tolist())) == 32
