"""The probes of pixie_tpu_torch (P1, the P2G ablation; P2, take_along_axis)
vs the JAX package's probes and kernels.

On the CPU the wrappers run their plain PyTorch versions.  P2 is held
exactly against the JAX probe's own Pallas kernels
(``scripts/probe_vmem_gather.py`` ``kernel_axis0`` / ``kernel_axis1``) run
in interpret mode: a gather copies values, so nothing may differ.  P1's
``full`` is held against JAX's ``p2g_tiled_t`` in interpret mode on the
probe's particle distribution, at the bounds of
``tests/test_torch_transfer.py::test_p2g_matches_pallas_interpret`` (atol
2e-5, rtol 1e-4: the MXU contractions sum in another order).  The three
ablated variants, which have no JAX counterpart, are held against numpy
statements of what each computes, in float64 (rtol 1e-5; for
``noatomics`` an emulation of the runs of same-cell lanes of each warp of
B1's sorted schedule) or, for the fold of ``minimal``, bit for bit.
"""

import importlib.util
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from torch_parity import configs, make_pair, to_np

from pixie_tpu_torch.ops import gather, probe_ablation as pa, transfer
from pixie_tpu_torch.scripts import probe_kernel_ablation as p1, probe_vmem_gather as p2
from pixie_tpu_torch.sim.types import MPMConfig

REPO = Path(__file__).resolve().parent.parent
DT = p1.DT
OFFSETS = np.array([(i, j, k) for i in range(3) for j in range(3) for k in range(3)])


# -- P2: take_along_axis -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_gather_probe():
    """``scripts/probe_vmem_gather.py`` imported from its path; it sets
    JAX_COMPILATION_CACHE_DIR at import, which is undone here."""
    saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    spec = importlib.util.spec_from_file_location("jax_probe_vmem_gather",
                                                  REPO / "scripts" / "probe_vmem_gather.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = saved
    return mod


def _jax_take(kernel, table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The probe's pallas_call (probe_vmem_gather.py:48-56) in interpret mode."""
    fn = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(table.shape, jnp.float32),
                        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
                        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    return np.asarray(fn(jnp.asarray(table), jnp.asarray(idx)))


@pytest.mark.parametrize("t", [64, 256])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_axis_matches_jax_probe_kernel(jax_gather_probe, axis, t):
    table, idx, _ = p2.make_inputs(axis, t, 128, seed=t)
    kernel = jax_gather_probe.kernel_axis0 if axis == 0 else jax_gather_probe.kernel_axis1
    want = _jax_take(kernel, to_np(table), to_np(idx))
    np.testing.assert_array_equal(want, np.take_along_axis(to_np(table), to_np(idx), axis))
    np.testing.assert_array_equal(to_np(gather.take_along_axis_plain(table, idx, axis)), want)
    before = dict(gather.LAUNCHES)
    np.testing.assert_array_equal(to_np(gather.take_along_axis(table, idx, axis)), want)
    assert gather.LAUNCHES == before  # CPU tensors launch nothing


@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_axis_plain_raises_out_of_range(axis):
    table, idx, _ = p2.make_inputs(axis, 16, 8)
    hi = table.shape[axis]
    for bad in (-1, hi):
        wrong = idx.clone()
        wrong[3, 5] = bad
        with pytest.raises(IndexError, match="out of range"):
            gather.take_along_axis(table, wrong, axis)


def test_take_along_axis_rejects_bad_axis_and_shapes():
    table, idx, _ = p2.make_inputs(0, 16, 8)
    with pytest.raises(ValueError, match="axis"):
        gather.take_along_axis(table, idx, 2)
    with pytest.raises(ValueError, match="shape"):
        gather.take_along_axis(table, idx[:8], 0)
    with pytest.raises(ValueError, match="shape"):
        gather.take_along_axis(table[None], idx[None], 0)


# -- P1: the P2G variants ------------------------------------------------------

def _probe_state(n, seed=0, inactive_every=0):
    """The probe's particles (numpy) and CPU tensors (x, v, C, stress, mass,
    vol, active) in generated order; every ``inactive_every``-th particle
    inactive."""
    d = p1.make_particles(n, seed)
    args = p1.inputs(d, "generated", p1.config(), "cpu")
    if inactive_every:
        active = args[6].clone()
        active[::inactive_every] = False
        args = (*args[:6], active)
    return d, args


def test_full_matches_pallas_p2g_interpret():
    """P1 ``full`` on the probe's distribution against JAX's p2g_tiled_t, built
    as in tests/test_torch_transfer.py::test_p2g_matches_pallas_interpret."""
    from pixie_tpu.ops import tiling
    from pixie_tpu.ops import transfer as jtransfer
    from pixie_tpu.sim import soa
    from pixie_tpu.sim.solver_fast import (
        pad_state_to_layout, state_to_soa, windows_to_combine_layout,
    )

    d = p1.make_particles(2000, seed=1)
    js, ts = make_pair(d, mass=d["mass"])
    jc, tc = configs(n_grid=p1.N_GRID, grid_lim=p1.GRID_LIM)
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
    want = np.asarray(tiling.combine_windows(windows_to_combine_layout(wins, t), jc.n_grid, 4))
    got = to_np(pa.p2g_variant("full", ts.x, ts.v, ts.C, ts.stress, ts.mass, ts.vol,
                               ts.selection == 0, tc, DT))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[..., 3].sum(), d["mass"].astype(np.float64).sum(), rtol=1e-5)


def test_full_is_transfer_p2g():
    _, args = _probe_state(500, inactive_every=7)
    np.testing.assert_array_equal(to_np(pa.p2g_variant("full", *args, p1.config(), DT)),
                                  to_np(transfer.p2g(*args, p1.config(), DT)))


def test_noweights_splats_constants_onto_each_stencil():
    """Every in-grid node of an active particle's stencil gets
    [ABLATE m (v + C ABLATE dx 1) - vol dt (stress 1) ABLATE inv_dx, ABLATE m]."""
    cfg = p1.config()
    d, args = _probe_state(600, inactive_every=5)
    d["x"][:10] = np.float32(0.01)          # stencils hanging off the low faces
    args = (torch.as_tensor(d["x"]), *args[1:])
    got = to_np(pa.p2g_variant("noweights", *args, cfg, DT)).astype(np.float64)
    act = to_np(args[6])
    a, dx, inv_dx = pa.ABLATE, cfg.dx, cfg.inv_dx
    v, C, s, m, vol = (d[k].astype(np.float64) for k in ("v", "C", "stress", "mass", "vol"))
    mom = a * m[:, None] * (v + C.sum(-1) * a * dx) - (vol * DT)[:, None] * s.sum(-1) * a * inv_dx
    node_val = np.concatenate([mom, (a * m)[:, None]], axis=1) * act[:, None]
    base = np.floor(d["x"] * np.float32(inv_dx) - np.float32(0.5)).astype(np.int64)
    want = np.zeros((cfg.n_grid,) * 3 + (4,))
    for o in OFFSETS:
        node = base + o
        ok = ((node >= 0) & (node < cfg.n_grid)).all(1)
        np.add.at(want, tuple(node[ok].T), node_val[ok])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    # the mass channel: ABLATE x 27 x the mass of the active particles whose
    # stencils lie wholly in the grid, plus the in-grid part of the others
    inside = ((base >= 0) & (base + 2 < cfg.n_grid)).all(1) & act
    assert inside.sum() == len(inside) - 10 - (~act[10:]).sum()
    hanging = got[..., 3].sum() - a * 27 * m[inside].sum()
    assert 0.0 < hanging < a * 27 * m[:10][act[:10]].sum()


def test_noatomics_sums_full_over_nodes():
    """noatomics is B1's schedule without the atomics: row q (a position of
    the stably sorted bin keys) holds the sum, over the run of same-cell
    lanes of its warp of 32 that ends at q, of the particles' in-grid node
    values (full's contributions summed over the 27 nodes); every other row
    is 0.  Emulated here with numpy's stable argsort and a loop over the
    warps, in float64 (rtol 1e-5 of the largest |row|); its rows sum to
    full's grid.  Particles hanging off the low faces and inactive ones are
    in the scene."""
    cfg = p1.config()
    d, args = _probe_state(800, inactive_every=6)
    d["x"][:40] = np.float32(0.01)
    args = (torch.as_tensor(d["x"]), *args[1:])
    got = to_np(pa.p2g_variant("noatomics", *args, cfg, DT)).astype(np.float64)
    grid = to_np(pa.p2g_variant("full", *args, cfg, DT)).astype(np.float64)
    assert got.shape == (800, 4)
    rows = to_np(transfer.p2g_contributions(*args, cfg, DT)[0].sum(0)).astype(np.float64)
    keys = to_np(transfer.p2g_bin_keys_plain(args[0], args[6], cfg.n_grid, cfg.inv_dx))
    nb, hbits = transfer.bin_layout(cfg.n_grid)
    perm = np.argsort(keys, kind="stable")
    live = (keys[perm] >> hbits) < nb ** 3
    base = np.floor(d["x"][perm] * np.float32(cfg.inv_dx) - np.float32(0.5)).astype(np.int64)
    want, n_runs = np.zeros((800, 4)), 0
    for w0 in range(0, 800, 32):
        q = w0
        while q < min(w0 + 32, 800):
            end = q + 1
            while (live[q] and end < min(w0 + 32, 800) and live[end]
                   and (base[end] == base[q]).all()):
                end += 1
            if live[q]:
                want[end - 1] = rows[perm[q:end]].sum(0)
                n_runs += 1
            q = end
    assert 0 < n_runs < int(live.sum())                  # some runs hold several lanes
    assert int((np.abs(got).sum(1) > 0).sum()) == n_runs
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got.sum(0), grid.reshape(-1, 4).sum(0), rtol=1e-5)


def test_minimal_is_the_fold_of_the_inputs():
    d, args = _probe_state(300, inactive_every=4)
    got = to_np(pa.p2g_variant("minimal", *args, p1.config(), DT))
    cols = np.concatenate([d["x"], d["v"], d["C"].reshape(-1, 9), d["stress"].reshape(-1, 9),
                           d["mass"][:, None], d["vol"][:, None]], axis=1)
    want = cols[:, 0].copy()
    for k in range(1, 26):
        want = want + cols[:, k]          # float32, in the kernel's order
    want[~to_np(args[6])] = 0.0
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_cell_sorted_order_permutes_the_particles():
    cfg = p1.config()
    d = p1.make_particles(1000)
    gen, srt = (p1.inputs(d, order, cfg, "cpu") for order in p1.ORDERS)
    cells = p1.base_cells(to_np(srt[0]), cfg)
    assert (np.diff(cells) >= 0).all() and not (np.diff(p1.base_cells(d["x"], cfg)) >= 0).all()
    perm = np.lexsort(to_np(gen[0]).T)
    np.testing.assert_array_equal(to_np(gen[0])[perm], to_np(srt[0])[np.lexsort(to_np(srt[0]).T)])
    for mode in ("full", "noweights"):
        np.testing.assert_allclose(to_np(pa.p2g_variant(mode, *gen, cfg, DT)),
                                   to_np(pa.p2g_variant(mode, *srt, cfg, DT)), atol=1e-6)


def test_unknown_mode_and_non_cpu_tensors_never_take_the_plain_version(monkeypatch):
    """Only CPU tensors take the plain versions: any other device goes to the
    kernel path, which raises for a device it does not handle."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(pa, "p2g_variant_plain", boom)
    monkeypatch.setattr(gather, "take_along_axis_plain", boom)
    fake = torch.empty(0, device="meta")
    cfg = MPMConfig()
    for mode in pa.MODES:
        with pytest.raises(ValueError, match="unsupported device"):
            pa.p2g_variant(mode, fake, fake, fake, fake, fake, fake, fake, cfg, DT)
    with pytest.raises(ValueError, match="unknown mode"):
        pa.p2g_variant("nopairs", fake, fake, fake, fake, fake, fake, fake, cfg, DT)
    table = torch.empty((4, 8), device="meta")
    idx = torch.empty((4, 8), dtype=torch.int32, device="meta")
    for axis in (0, 1):
        with pytest.raises(ValueError, match="unsupported device"):
            gather.take_along_axis(table, idx, axis)


# -- the entry points ------------------------------------------------------------

def test_probe_kernel_ablation_main_prints_the_jax_probe_lines(capsys):
    out = p1.main(device="cpu", n=400)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    timed = [ln for ln in lines if ln.startswith("p2g[")]
    assert len(timed) == 2 * len(pa.MODES)
    assert all(re.fullmatch(r"p2g\[(full|noweights|noatomics|minimal)\]: \d+\.\d+ ms/call", ln)
               for ln in timed)
    assert [ln for ln in lines if ln.startswith("order: ")] == ["order: generated",
                                                                 "order: cell_sorted"]
    assert [ln for ln in lines if ln.startswith("keys+sort: ")] == [
        ln for ln in lines if re.fullmatch(r"keys\+sort: \d+\.\d+ ms/call", ln)]
    assert len([ln for ln in lines if ln.startswith("keys+sort: ")]) == 2
    assert set(out) == {*pa.MODES, "keys_sort"}
    assert all(set(v) == set(p1.ORDERS) and min(v.values()) > 0 for v in out.values())


def test_probe_vmem_gather_main_prints_the_jax_probe_lines(capsys):
    out = p2.main(device="cpu", t=64, l=128, reps=3)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    for axis in (0, 1):
        name = re.escape(p2.NAMES[axis])
        mine = [ln for ln in lines if ln.startswith(p2.NAMES[axis])]
        assert len(mine) == 3
        assert re.fullmatch(name + r": compiled\+ran in \d+\.\ds", mine[0])
        assert mine[1] == f"{p2.NAMES[axis]}: max err 0.00e+00"
        assert re.fullmatch(name + r": \d+\.\d us per 8192 gathered values \(\d+\.\d{3} ns/value\)",
                            mine[2])
        assert out[axis]["max_err"] == 0.0 and out[axis]["ms"] > 0
