"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (skipped without a GPU: a CUDA kernel has no CPU mode).

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: P2G sums float atomics in run-dependent order, so grids agree
to atol 1e-5 / rtol 1e-4 (momenta up to ~1e-1), and the binned P2G's cases
to 1e-5 of the largest |grid| with the grid mass to rtol 1e-5; G2P sums the 27 nodes in a
fixed order but contracts multiply-adds, atol 1e-5 / rtol 1e-4.  The tile
blend's sequential transmittance product against the plain version's
log-domain chunked product agrees to atol 1e-4 on colour and T (values in
[0, 1], up to 512 terms).  The blend backward sums float atomics across
tiles in run-dependent order: each column of d feat agrees with the plain
version to 1e-5 of that column's largest |value| (measured 3.5e-7 of it at
800x800).  The fused substep (B6) is held as chip_smoke.py holds it: x, v,
C, F_trial, cov and the grid to 1e-5 of each field's largest |value|; F,
stress, mu, lam and the yield stress to the float32 ULP floor 6 * 1.2e-7 *
scale (scale E for stress, the field's largest |value| otherwise), 90 % of
entries within it and all within 100 times it (JAX's fused-vs-two-kernel
criterion, tests/test_fast_solver.py:282-294).  The P2G ablation probe's
variants (P1), each behind B1's keys and sort, are held as chip_smoke.py
holds them: full and noweights splat by run atomics (1e-5 of the largest
|grid|), noatomics sums a run's nodes in another order than the plain
version (1e-5 of the largest |value|), minimal adds 26 floats in the plain
version's order (1e-6).  The take_along_axis kernels (P2) copy values and
agree exactly.  The voxelizer stage (plain PyTorch) is held against the
CPU: the occupancy mask bit for bit, float16 artifacts within one ulp,
float32 field outputs within 1e-5 of the largest value.  The field
renders, their gradients and the CLIP tower (plain PyTorch) are held
against the CPU by the bounds their CPU tests hold them to JAX by.  A U-Net
training step (plain PyTorch, TF32 off) is held against the CPU's, and DDP
over NCCL (two or more cards) against one process on the whole batch,
each gradient within 1e-3 of its scale.  The sharded MPM frames and the
U-Net over an sp group run on 2 and 4 NCCL ranks, one card a rank
(skipped with fewer cards), against one process on the first card: x
within PERF.md's unfused criterion (mean 1e-4, max 1e-2 cell), each
rank's B1 and B2 launches equal to its substeps; the loss to rel 1e-5,
each gradient within 1e-3 of its scale.  This file imports no JAX package
module.
"""

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401  (fixture)
    cuda_device, random_particles, to_np, underflow_scene,
)

from pixie_tpu_torch.ops import fused_substep as fs
from pixie_tpu_torch.ops import gather, gs_stream, probe_ablation, transfer
from pixie_tpu_torch.recon import rasterizer as R
from pixie_tpu_torch.scripts import probe_kernel_ablation as p1, probe_vmem_gather as p2
from pixie_tpu_torch.sim.types import MPMConfig, finalize_mu_lam, make_state

pytestmark = pytest.mark.cuda
DT = 1e-4
G2P_FIELDS = ("x", "v", "C", "F_trial", "cov")


def _state(n=4096, seed=0):
    d = random_particles(n, seed)
    d["x"][:64] = np.float32(0.02)     # stencils hanging off the low faces
    d["x"][64:128] = np.float32(1.98)  # ... and the high faces
    st = finalize_mu_lam(make_state(d["x"], d["vol"], density=300.0, E=1e5, nu=0.35))
    rng = np.random.default_rng(seed + 1)
    return st.replace(
        v=torch.as_tensor(d["v"]), C=torch.as_tensor(d["C"]),
        stress=torch.as_tensor(d["stress"]),
        F=torch.as_tensor((np.eye(3) + 0.05 * rng.normal(size=(n, 3, 3))).astype(np.float32)),
        cov=torch.as_tensor(rng.normal(size=(n, 6)).astype(np.float32)),
        selection=torch.as_tensor((np.arange(n) % 13 == 0).astype(np.int32)))


def _to(st, dev, fields):
    return st.replace(**{k: getattr(st, k).to(dev).clone() for k in fields})


@pytest.mark.parametrize("rpic", [0.0, 0.2, -1.0])
def test_p2g_kernel_matches_plain(cuda_device, rpic):
    st = _state()
    cfg = MPMConfig(n_grid=24, grid_lim=2.0, rpic_damping=rpic)
    cpu = (st.x, st.v, st.C, st.stress, st.mass, st.vol, st.selection == 0)
    want = transfer.p2g_plain(*cpu, cfg, DT)
    before = transfer.P2G_LAUNCHES
    got = transfer.p2g(*(t.to(cuda_device) for t in cpu), cfg, DT)
    assert transfer.P2G_LAUNCHES == before + 1
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("update_cov", [False, True])
def test_g2p_kernel_matches_plain(cuda_device, update_cov):
    st = _state(seed=3)
    cfg = MPMConfig(n_grid=24, grid_lim=2.0, update_cov_with_F=update_cov)
    grid_v = torch.as_tensor(np.random.default_rng(2).normal(
        size=(24, 24, 24, 3)).astype(np.float32))
    want = transfer.g2p_plain(_to(st, "cpu", G2P_FIELDS), grid_v, cfg, DT)
    before = transfer.G2P_LAUNCHES
    got = transfer.g2p(_to(st, cuda_device, G2P_FIELDS + ("F", "selection")),
                       grid_v.to(cuda_device), cfg, DT)
    assert transfer.G2P_LAUNCHES == before + 1
    for k in G2P_FIELDS:
        np.testing.assert_allclose(to_np(getattr(got, k)), to_np(getattr(want, k)),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def _g2p_order(st, cfg, order):
    """B2's three orders: the state as given (random), sorted by cell, and
    sorted by cell before a drift of up to 0.8 cell on each axis."""
    from pixie_tpu_torch.sim.solver import permute_state

    if order == "given":
        return st
    st = permute_state(st, transfer.cell_order(st.x, st.selection == 0, cfg))
    if order == "stale":
        rng = np.random.default_rng(3)
        st = st.replace(x=st.x + torch.as_tensor(
            (rng.uniform(-0.8, 0.8, (st.n_particles, 3)) * cfg.dx).astype(np.float32)))
    return st


@pytest.mark.parametrize("order", ["given", "cell_sorted", "stale"])
@pytest.mark.parametrize("update_cov", [False, True])
def test_g2p_kernel_in_three_orders(cuda_device, update_cov, order):
    """B2 on particles in the given order, sorted by cell and in a cell order
    gone stale (every 13th inactive, stencils hanging off both faces): each
    field to 1e-5 of its largest |value| (G2P_RTOL) against the plain
    version, inactive particles untouched."""
    st = _g2p_order(_state(seed=3), MPMConfig(n_grid=24, grid_lim=2.0), order)
    cfg = MPMConfig(n_grid=24, grid_lim=2.0, update_cov_with_F=update_cov)
    grid_v = torch.as_tensor(np.random.default_rng(2).normal(
        size=(24, 24, 24, 3)).astype(np.float32))
    want = transfer.g2p_plain(_to(st, "cpu", G2P_FIELDS), grid_v, cfg, DT)
    got = _to(st, cuda_device, G2P_FIELDS + ("F", "selection"))
    before = transfer.G2P_LAUNCHES
    transfer.g2p(got, grid_v.to(cuda_device), cfg, DT)
    assert transfer.G2P_LAUNCHES == before + 1
    inactive = to_np(st.selection) != 0
    for k in G2P_FIELDS:
        w = to_np(getattr(want, k))
        g = to_np(getattr(got, k))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
        np.testing.assert_array_equal(g[inactive], to_np(getattr(st, k))[inactive], err_msg=k)


def test_unfused_frame_with_an_impulse_on_cuda_matches_cpu(cuda_device, monkeypatch):
    """The unfused frame on CUDA (its state in P2G's cell order, re-sorted
    every 3 substeps, the impulse's and the translation's masks travelling
    with it) against the same frame on the CPU (the caller's order): x
    within 1e-5, v within 1e-4 of its largest |value|; one P2G and one G2P
    launch a substep; inactive particles keep x, C and F_trial (the
    particle BCs set v whatever the selection)."""
    from pixie_tpu_torch.sim import bc as bc_mod
    from pixie_tpu_torch.sim import solver as S

    st = _state(n=4096, seed=5)
    st = st.replace(F_trial=st.F.clone())
    x0 = to_np(st.x)
    cfg = MPMConfig(n_grid=24, grid_lim=2.0, gravity=(0.0, 0.0, -9.8), rpic_damping=0.1)
    specs = [{"type": "particle_impulse", "force": [0.0, 0.0, 0.05], "point": [1.0, 1.0, 1.0],
              "size": [0.3, 0.3, 0.3], "num_dt": 5},
             {"type": "enforce_particle_translation", "point": [0.7, 0.7, 1.0],
              "size": [0.2, 0.2, 0.5], "velocity": [0.0, 0.0, 1.0], "start_time": 0.0,
              "end_time": 1.0},
             {"type": "surface_collider", "point": [1.0, 1.0, 0.5], "normal": [0.0, 0.0, 1.0],
              "surface": "sticky", "friction": 0.0, "start_time": 0.0, "end_time": 1e3}]
    monkeypatch.setattr(S, "RESORT_EVERY", 3)
    out = {}
    for dev in ("cpu", cuda_device):
        bcs = bc_mod.build_boundary_conditions(specs, {"substep_dt": DT}, x0, device=dev)
        before = (transfer.P2G_LAUNCHES, transfer.G2P_LAUNCHES)
        fields = G2P_FIELDS + ("F", "stress", "mass", "vol", "selection", "mu", "lam",
                               "material", "bulk", "yield_stress", "init_cov", "density", "Jp",
                               "E", "nu")
        out[str(dev)] = S.simulate_substeps(_to(st, dev, fields), cfg, bcs, 0.0, DT, 8)
        launched = (transfer.P2G_LAUNCHES - before[0], transfer.G2P_LAUNCHES - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (8, 8))
    got, want = out[str(cuda_device)], out["cpu"]
    np.testing.assert_allclose(to_np(got.x), to_np(want.x), rtol=0, atol=1e-5)
    w = to_np(want.v)
    np.testing.assert_allclose(to_np(got.v), w, rtol=0, atol=1e-4 * np.abs(w).max())
    inactive = to_np(st.selection) != 0
    for k in ("x", "C", "F_trial"):
        np.testing.assert_array_equal(to_np(getattr(got, k))[inactive],
                                      to_np(getattr(st, k))[inactive], err_msg=k)


def _graph_case(case, dev, n=4096):
    """A state and its BCs for the graphed unfused frame: config-style
    jelly under gravity above a sticky collider, or jelly, metal and
    stationary particles in turn under two still cuboids (a floor slab and
    a block in the middle) with the covariance carried."""
    from pixie_tpu_torch.sim import bc as bc_mod

    st = _state(n=n, seed=21)
    st = st.replace(F_trial=st.F.clone())
    if case == "collider_gravity":
        cfg = MPMConfig(n_grid=24, grid_lim=2.0, gravity=(0.0, 0.0, -9.8), rpic_damping=0.1)
        bcs = (bc_mod.make_surface_collider((1.0, 1.0, 0.5), (0.0, 0.0, 1.0), "sticky",
                                            device=dev),)
    else:
        mats = np.array([0, 1, 6], np.int32)[np.arange(n) % 3]
        st = st.replace(material=torch.as_tensor(mats), yield_stress=torch.full((n,), 50.0))
        cfg = MPMConfig(n_grid=24, grid_lim=2.0, active_materials=(0, 1, 6),
                        update_cov_with_F=True)
        bcs = tuple(bc_mod.make_cuboid_velocity(p, size, (0.0, 0.0, 0.0), device=dev)
                    for p, size in (((1.0, 1.0, 0.3), (1.0, 1.0, 0.15)),
                                    ((1.0, 1.0, 1.0), (0.2, 0.2, 0.2))))
    return st, cfg, bcs


def _all_to(st, dev):
    import dataclasses

    return st.replace(**{f.name: getattr(st, f.name).to(dev).clone()
                         for f in dataclasses.fields(st)})


def _graph_counts():
    from pixie_tpu_torch.ops import constitutive as ops_const
    from pixie_tpu_torch.sim import solver as S

    return np.array([S.GRAPH_CAPTURES, S.GRAPH_REPLAYS, transfer.P2G_LAUNCHES,
                     transfer.G2P_LAUNCHES, ops_const.CONSTITUTIVE_LAUNCHES])


def _eager_frame(st, cfg, bcs, n):
    """The unfused frame with every substep ``_substep`` itself."""
    from pixie_tpu_torch.sim import solver as S

    dt = np.float32(DT)
    node_x = S.node_positions(cfg, st.device)
    return S.run_frame(st, bcs, np.float32(0.0), dt, n,
                       lambda s, b, t, resort: S._substep(s, cfg, b, t, dt, node_x, resort))


def _assert_frame_close(got, want):
    np.testing.assert_allclose(to_np(got.x), to_np(want.x), rtol=0, atol=1e-5)
    w = to_np(want.v)
    np.testing.assert_allclose(to_np(got.v), w, rtol=0, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("case", ["collider_gravity", "still_cuboids_mixed"])
def test_graphed_frame_matches_the_eager_frame(cuda_device, monkeypatch, case):
    """``simulate_substeps`` on the card (a re-sort every 3 substeps, 11
    substeps: 4 eager, 2 captures, 5 replays) against the same frame with
    every substep run eagerly from the same state: x within 1e-5, v within
    1e-4 of its largest |value| (P2G's float atomics sum in a run-dependent
    order); two captures, a replay for every substep the plan gives a graph,
    and one wrapper call of B1, B2 and B7 for every eager substep and
    capture."""
    from pixie_tpu_torch.sim import solver as S

    monkeypatch.setattr(S, "RESORT_EVERY", 3)
    st, cfg, bcs = _graph_case(case, cuda_device)
    n = 11
    plan = S.frame_plan(bcs, 0.0, DT, n)
    assert plan.count("eager") == 4 and plan.count("capture") == 2
    want = _eager_frame(_all_to(st, cuda_device), cfg, bcs, n)
    before = _graph_counts()
    got = S.simulate_substeps(_all_to(st, cuda_device), cfg, bcs, 0.0, DT, n)
    torch.cuda.synchronize()
    captures, replays, *calls = _graph_counts() - before
    assert (captures, replays) == (2, n - 4)
    assert calls == [4 + 2] * 3
    _assert_frame_close(got, want)
    assert not np.array_equal(to_np(got.x), to_np(st.x))


def test_graphed_frame_with_the_tracer_on(cuda_device, monkeypatch):
    """The tracer on: the same captures, replays and wrapper calls as off,
    each replay the span ``sim.graph`` inside ``sim.frame``, the stage spans
    recorded at the captures and the eager substeps (no ``sim.grid_bc``: B8
    applies the cuboids inside ``sim.grid``, which still counts them), the
    tracer's graph counters equal to the module's, and the state within the eager
    comparison's bounds of the frame with the tracer off (P2G's atomics
    keep the two runs from agreeing bit for bit)."""
    from pixie_tpu_torch.sim import solver as S
    from pixie_tpu_torch.utils import observability as obs

    monkeypatch.setattr(S, "RESORT_EVERY", 3)
    st, cfg, bcs = _graph_case("still_cuboids_mixed", cuda_device)
    n = 11
    before = _graph_counts()
    off = S.simulate_substeps(_all_to(st, cuda_device), cfg, bcs, 0.0, DT, n)
    mid = _graph_counts()
    with obs.tracing() as tr:
        on = S.simulate_substeps(_all_to(st, cuda_device), cfg, bcs, 0.0, DT, n)
    torch.cuda.synchronize()
    assert list(_graph_counts() - mid) == list(mid - before)
    captures, replays = (mid - before)[:2]
    assert tr.counters["sim.graph.captures"] == captures == 2
    assert tr.counters["sim.graph.replays"] == replays == n - 4
    spans = tr.summary()
    assert spans["sim.graph"]["calls"] == replays
    for stage in ("sim.constitutive", "sim.p2g", "sim.grid", "sim.g2p"):
        assert spans[stage]["calls"] == 4 + 2, stage
    assert "sim.grid_bc" not in spans
    assert tr.counters["sim.bc.grid_cuboids"] == 2 * (4 + 2)
    frame = [i for i, r in enumerate(tr.records) if r[0] == "sim.frame"]
    assert all(r[1] in frame for r in tr.records if r[0] == "sim.graph")
    _assert_frame_close(on, off)


def test_graphed_frame_honours_a_patched_g2p(cuda_device, monkeypatch):
    """A G2P patched on ``solver.g2p`` after a frame reaches the next
    frame's captures: with a G2P that leaves the particles as they are, the
    frame's x is its start x bit for bit, where the frame before moved
    them."""
    from pixie_tpu_torch.sim import solver as S

    st, cfg, bcs = _graph_case("collider_gravity", cuda_device)
    moved = S.simulate_substeps(_all_to(st, cuda_device), cfg, bcs, 0.0, DT, 12)
    assert not np.array_equal(to_np(moved.x), to_np(st.x))
    monkeypatch.setattr(S, "g2p", lambda state, grid_v, cfg, dt: state)
    before = _graph_counts()
    kept = S.simulate_substeps(_all_to(st, cuda_device), cfg, bcs, 0.0, DT, 12)
    assert (_graph_counts() - before)[0] == 2
    np.testing.assert_array_equal(to_np(kept.x), to_np(st.x))


def _p2g_binned_case(case, n_grid=24):
    """B1's cases: the random state of _state (every 13th inactive, 64
    particles hanging off the low faces and 64 off the high ones), the same
    sorted by base cell, every particle within a cell of a grid face, all
    in one cell (one bin over 12 blocks of 256), n = 1, and 3000 particles
    in one bin of 4^3 cells (a bin larger than a block)."""
    st = _state(n=1 if case == "one_particle" else 3000)
    dx = 2.0 / n_grid
    rng = np.random.default_rng(9)
    x = to_np(st.x).copy()
    if case == "faces":
        lo = rng.uniform(0.0, dx, (3000, 3))
        x[:] = np.where(rng.random((3000, 1)) < 0.5, lo, 2.0 - lo)
    elif case == "one_cell":
        x[:] = 1.0 + dx * rng.uniform(0.55, 1.45, (3000, 3))
    elif case == "one_bin":   # base cells 14..17: shifted 16..19, bin 4 on each axis
        x[:] = dx * rng.uniform(15.05, 17.95, (3000, 3))
    cfg = MPMConfig(n_grid=n_grid, grid_lim=2.0, rpic_damping=0.1)
    args = [torch.as_tensor(x.astype(np.float32)), st.v, st.C, st.stress, st.mass, st.vol,
            st.selection == 0]
    if case == "cell_sorted":
        order = torch.as_tensor(np.argsort(p1.base_cells(x, cfg), kind="stable"))
        args = [a[order].contiguous() for a in args]
    return args, cfg


@pytest.mark.parametrize("case", ["random", "cell_sorted", "faces", "one_cell", "one_bin",
                                  "one_particle"])
def test_binned_p2g_kernel_matches_plain(cuda_device, case):
    """B1 to 1e-5 of the largest |grid| (P2G_RTOL: float atomics in
    run-dependent order), the grid's mass to the active particles' in-grid
    mass, one count a call, and the key kernel equal to its plain version."""
    args, cfg = _p2g_binned_case(case)
    want = transfer.p2g_plain(*args, cfg, DT)
    dev_args = [a.to(cuda_device) for a in args]
    before = transfer.P2G_LAUNCHES
    got = transfer.p2g(*dev_args, cfg, DT)
    assert transfer.P2G_LAUNCHES == before + 1
    want = to_np(want)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(to_np(got)[..., 3].astype(np.float64).sum()),
                               float(want[..., 3].astype(np.float64).sum()), rtol=1e-5)
    keys = transfer.p2g_bin_keys(dev_args[0], dev_args[6], cfg.n_grid, cfg.inv_dx)
    np.testing.assert_array_equal(to_np(keys), to_np(transfer.p2g_bin_keys_plain(
        args[0], args[6], cfg.n_grid, cfg.inv_dx)))
    if case == "one_bin":
        nb, hbits = transfer.bin_layout(cfg.n_grid)
        assert int((to_np(keys) >> hbits < nb ** 3).sum()) > 256
        assert len(np.unique(to_np(keys)[to_np(args[6])] >> hbits)) == 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    st = _to(_state(n=256), cuda_device, G2P_FIELDS + ("F", "stress", "mass", "vol", "selection"))
    cfg = MPMConfig(n_grid=24, grid_lim=2.0)
    active = st.selection == 0
    with pytest.raises(TypeError):
        transfer.p2g(st.x.double(), st.v, st.C, st.stress, st.mass, st.vol, active, cfg, DT)
    with pytest.raises(ValueError, match="contiguous"):
        transfer.p2g(st.x, st.v, st.C.transpose(1, 2), st.stress, st.mass, st.vol, active,
                     cfg, DT)
    with pytest.raises(ValueError, match="expected cuda"):
        transfer.p2g(st.x, st.v.cpu(), st.C, st.stress, st.mass, st.vol, active, cfg, DT)
    with pytest.raises(ValueError, match="shape"):
        transfer.g2p(st, torch.zeros((8, 8, 8, 3), device=cuda_device), cfg, DT)


def _splat_bins(n=3000, seed=0, tile_cap=512, res=128):
    """A seeded splat scene binned on the CPU: random gaussians in a ball,
    seen from z = -2.2 (tile_cap 128 binds on the centre tiles)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    params = {
        "xyz": rng.normal(0.0, 0.25, (n, 3)),
        "f_dc": rng.normal(0.0, 1.0, (n, 1, 3)),
        "f_rest": rng.normal(0.0, 0.1, (n, 15, 3)),
        "scaling": rng.uniform(np.log(0.01), np.log(0.05), (n, 3)),
        "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
        "opacity": rng.normal(1.0, 1.5, (n, 1)),
    }
    params = {k: torch.as_tensor(v.astype(np.float32)) for k, v in params.items()}
    vm = torch.eye(4)
    vm[2, 3] = 2.2
    cam = R.Camera(res, res, 1.2 * res, 1.2 * res, res / 2, res / 2)
    return R.bin_tiles(params, vm, cam, tile_cap=tile_cap)


def _blend_both(bins, dev, bg=0.3):
    args = (bins.feat, bins.idx, bins.starts, bins.counts)
    want = gs_stream.blend_plain(*args, bins.tx_n, bg)
    before = gs_stream.BLEND_LAUNCHES
    got = gs_stream.blend(*(t.to(dev) for t in args), bins.tx_n, bg)
    assert gs_stream.BLEND_LAUNCHES == before + 1
    return got, want


@pytest.mark.parametrize("tile_cap", [512, 128])
def test_blend_kernel_matches_plain(cuda_device, tile_cap):
    bins = _splat_bins(tile_cap=tile_cap)
    if tile_cap == 128:
        assert int((bins.raw > tile_cap).sum()) > 0  # the cap binds
    (img, trans), (want_img, want_trans) = _blend_both(bins, cuda_device)
    np.testing.assert_allclose(to_np(img), to_np(want_img), atol=1e-4)
    np.testing.assert_allclose(to_np(trans), to_np(want_trans), atol=1e-4)
    assert float(want_trans.min()) < 0.1  # opaque somewhere: the blend did work


def test_blend_kernel_empty_and_transparent_tiles(cuda_device):
    feat = torch.tensor([[8.5, 8.5, 1.0, 0.0, 1.0, 0.2, 0.4, 0.6, 1.0],     # opaque
                         [40.5, 8.5, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.003]])  # < 1/255
    idx = torch.tensor([0, 1], dtype=torch.int32)
    starts = torch.tensor([0, 1, 2], dtype=torch.int32)
    counts = torch.tensor([1, 1, 0], dtype=torch.int32)
    bins = R.TileBins(feat=feat, idx=idx, starts=starts, counts=counts, raw=counts, tx_n=3)
    (img, trans), (want_img, want_trans) = _blend_both(bins, cuda_device, bg=0.5)
    np.testing.assert_allclose(to_np(img), to_np(want_img), atol=1e-6)
    np.testing.assert_allclose(to_np(trans), to_np(want_trans), atol=1e-6)
    assert float(trans[:, 16:].min()) == 1.0
    np.testing.assert_array_equal(to_np(img[:, 16:]), 0.5)


def test_rasterize_tiled_on_cuda_launches_the_kernel(cuda_device):
    rng = np.random.default_rng(3)
    n = 500
    params = {"xyz": rng.uniform(-0.5, 0.5, (n, 3)), "cov6_precomp": np.tile(
        [4e-4, 1e-4, 0.0, 3e-4, 0.0, 2e-4], (n, 1)), "colors_precomp": rng.uniform(0, 1, (n, 3)),
        "opacity_precomp": rng.uniform(0.1, 1.0, (n,))}
    params = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in params.items()}
    vm = torch.eye(4)
    vm[2, 3] = 2.0
    cam = R.Camera(96, 80, 90.0, 90.0, 40.0, 48.0)
    want = R.rasterize_tiled(params, vm, cam, bg_color=1.0)
    before = gs_stream.BLEND_LAUNCHES
    got = R.rasterize_tiled({k: v.to(cuda_device) for k, v in params.items()},
                            vm.to(cuda_device), cam, bg_color=1.0)
    assert gs_stream.BLEND_LAUNCHES == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), atol=1e-4)


def test_blend_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    bins = _splat_bins(n=200)
    args = [t.to(cuda_device) for t in (bins.feat, bins.idx, bins.starts, bins.counts)]
    with pytest.raises(TypeError):
        gs_stream.blend(args[0].double(), *args[1:], bins.tx_n)
    with pytest.raises(TypeError):
        gs_stream.blend(args[0], args[1].long(), *args[2:], bins.tx_n)
    with pytest.raises(ValueError, match="contiguous"):
        gs_stream.blend(args[0].t().contiguous().t(), *args[1:], bins.tx_n)
    with pytest.raises(ValueError, match="expected cuda"):
        gs_stream.blend(args[0], args[1].cpu(), *args[2:], bins.tx_n)
    with pytest.raises(ValueError, match="shape"):
        gs_stream.blend(args[0], args[1], args[2], args[3][:-1], bins.tx_n)
    with pytest.raises(ValueError, match="tx_n"):
        gs_stream.blend(*args, 7)


def _blend_modes(bins, dev, bg=0.3, keep_state=True):
    """The shipped forward kernel and its nolists mode (no per-warp entry
    lists) on the same inputs: {mode: (img, trans, state)}."""
    args = [t.to(dev) for t in (bins.feat, bins.idx, bins.starts, bins.counts)]
    return {m: gs_stream.blend_forward_variant(m, *args, bins.tx_n, bg, keep_state)
            for m in ("shipped", "nolists")}


def test_blend_kernel_all_opaque_tile_and_a_full_tile(cuda_device):
    """One tile under 300 opaque splats (T reaches exactly 0 at every pixel
    after ~25: the block stops early) and one at tile_cap 1024 of faint
    ones: both against the plain version (atol 1e-4), and the per-warp
    lists drop no hit (bitwise against the nolists mode)."""
    rng = np.random.default_rng(4)
    n_opaque, n_faint = 300, 1024
    feat = np.zeros((n_opaque + n_faint, 9), np.float32)
    feat[:n_opaque, 0:2] = rng.uniform(6.0, 10.0, (n_opaque, 2))          # tile 0, centred
    feat[:n_opaque, 2:5] = [1e-3, 0.0, 1e-3]                               # wide: covers it
    feat[:n_opaque, 8] = 0.999
    feat[n_opaque:, 0] = rng.uniform(16.0, 32.0, n_faint)                  # tile 1
    feat[n_opaque:, 1] = rng.uniform(0.0, 16.0, n_faint)
    feat[n_opaque:, 2:5] = [0.05, 0.01, 0.08]
    feat[n_opaque:, 8] = rng.uniform(0.004, 0.05, n_faint)
    feat[:, 5:8] = rng.uniform(0.0, 1.0, (n_opaque + n_faint, 3))
    idx = torch.arange(n_opaque + n_faint, dtype=torch.int32)
    starts = torch.tensor([0, n_opaque], dtype=torch.int32)
    counts = torch.tensor([n_opaque, n_faint], dtype=torch.int32)
    bins = R.TileBins(feat=torch.as_tensor(feat), idx=idx, starts=starts, counts=counts,
                      raw=counts, tx_n=2)
    (img, trans), (want_img, want_trans) = _blend_both(bins, cuda_device)
    np.testing.assert_allclose(to_np(img), to_np(want_img), atol=1e-4)
    np.testing.assert_allclose(to_np(trans), to_np(want_trans), atol=1e-4)
    assert float(trans[:, :16].max()) == 0.0 and float(trans[:, 16:].min()) < 0.5
    out = _blend_modes(bins, cuda_device)
    for k in range(3):
        assert torch.equal(out["shipped"][k], out["nolists"][k]), k


def test_blend_kernel_nan_opacity_and_conic(cuda_device):
    """A NaN opacity or a NaN conic fails the gate, as in the plain version:
    the image matches it (atol 1e-4) and the nolists mode bit for bit."""
    bins = _splat_bins(n=600, tile_cap=512)
    feat = bins.feat.clone()
    busy = torch.argsort(bins.counts, descending=True)[:2]
    feat[int(bins.idx[bins.starts[int(busy[0])]]), 8] = float("nan")
    feat[int(bins.idx[bins.starts[int(busy[1])] + 1]), 3] = float("nan")
    nan_bins = R.TileBins(feat=feat, idx=bins.idx, starts=bins.starts, counts=bins.counts,
                          raw=bins.raw, tx_n=bins.tx_n)
    (img, trans), (want_img, want_trans) = _blend_both(nan_bins, cuda_device)
    assert bool(torch.isfinite(img).all())
    np.testing.assert_allclose(to_np(img), to_np(want_img), atol=1e-4)
    np.testing.assert_allclose(to_np(trans), to_np(want_trans), atol=1e-4)
    out = _blend_modes(nan_bins, cuda_device)
    for k in range(3):
        assert torch.equal(out["shipped"][k], out["nolists"][k]), k


def _cotangents(bins, seed=0):
    h, w = bins.starts.shape[0] // bins.tx_n * 16, bins.tx_n * 16
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(h, w, 3)).astype(np.float32)),
            torch.as_tensor(rng.normal(size=(h, w)).astype(np.float32)))


def _assert_columns_close(got, want):
    got, want = to_np(got), to_np(want)
    for c in range(9):
        scale = float(np.abs(want[:, c]).max())
        assert scale > 0.0, c
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=0, atol=1e-5 * scale, err_msg=c)


def _underflow_bins():
    p, vm = underflow_scene()
    return R.bin_tiles({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(vm),
                       R.Camera(64, 64, 64.0, 64.0, 32.0, 32.0), tile_cap=256)


def _backward_on(dev, args, tx_n, bg, di, dt):
    """The CUDA backward as training runs it: the forward keeps its state,
    the backward reads it."""
    args = [t.to(dev) for t in args]
    state = gs_stream.blend_forward(*args, tx_n, bg, keep_state=True)[2]
    return gs_stream.blend_backward(*args, tx_n, bg, di.to(dev), dt.to(dev), state)


@pytest.mark.parametrize("case", ["random", "underflow", "tile_cap_truncated"])
def test_blend_backward_kernel_matches_plain(cuda_device, case):
    bins = {"random": lambda: _splat_bins(tile_cap=512),
            "underflow": _underflow_bins,
            "tile_cap_truncated": lambda: _splat_bins(tile_cap=128)}[case]()
    args = (bins.feat, bins.idx, bins.starts, bins.counts)
    if case == "underflow":
        assert float(gs_stream.blend_plain(*args, bins.tx_n)[1].min()) == 0.0  # T underflowed
    if case == "tile_cap_truncated":
        assert int((bins.raw > 128).sum()) > 0
    di, dt = _cotangents(bins)
    want = gs_stream.blend_backward_plain(*args, bins.tx_n, 0.3, di, dt)
    before = gs_stream.BLEND_BWD_LAUNCHES
    got = _backward_on(cuda_device, args, bins.tx_n, 0.3, di, dt)
    assert gs_stream.BLEND_BWD_LAUNCHES == before + 1
    _assert_columns_close(got, want)


def test_blend_backward_kernel_nan_opacity_and_empty_tiles(cuda_device):
    """A NaN opacity fails the alpha gate as in the plain version (its row
    gets no term; the plain version's conic and mean columns of that row are
    NaN from 0 * NaN, its colour and opacity columns 0); empty tiles add
    nothing; every other row to BWD_RTOL of its column."""
    bins = _splat_bins(n=600, tile_cap=512)
    feat = bins.feat.clone()
    hit = int(bins.idx[bins.starts[int(torch.argmax(bins.counts))]])
    feat[hit, 8] = float("nan")
    counts = bins.counts.clone()
    counts[::5] = 0                                   # every 5th tile empty
    args = (feat, bins.idx, bins.starts, counts)
    di, dt = _cotangents(bins)
    want = to_np(gs_stream.blend_backward_plain(*args, bins.tx_n, 0.3, di, dt))
    got = to_np(_backward_on(cuda_device, args, bins.tx_n, 0.3, di, dt))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[hit], 0.0)
    np.testing.assert_array_equal(want[hit, 5:], 0.0)
    keep = np.ones(len(want), bool)
    keep[hit] = False
    _assert_columns_close(torch.as_tensor(got[keep]), torch.as_tensor(want[keep]))
    empty = R.TileBins(feat=feat, idx=bins.idx, starts=bins.starts,
                       counts=torch.zeros_like(counts), raw=counts, tx_n=bins.tx_n)
    zero = _backward_on(cuda_device, (empty.feat, empty.idx, empty.starts, empty.counts),
                        bins.tx_n, 0.3, di, dt)
    assert float(zero.abs().max()) == 0.0


def test_blend_backward_kernel_alpha_clamp(cuda_device):
    """The underflow scene, whose stacked splats sit at the 0.99 clamp at
    their centres (d alpha dropped there): the kernel holds BWD_RTOL per
    column."""
    bins = _underflow_bins()
    args = (bins.feat, bins.idx, bins.starts, bins.counts)
    assert float(bins.feat[:, 8].max()) > 0.99   # opacity sigmoid(6) = 0.9975
    di, dt = _cotangents(bins)
    want = gs_stream.blend_backward_plain(*args, bins.tx_n, 0.3, di, dt)
    _assert_columns_close(_backward_on(cuda_device, args, bins.tx_n, 0.3, di, dt), want)


def test_blend_backward_needs_the_forward_state(cuda_device):
    """The CUDA backward reads the forward's colour sums and final T: a call
    without them raises (training's autograd always hands them over)."""
    bins = _splat_bins(n=200)
    args = [t.to(cuda_device) for t in (bins.feat, bins.idx, bins.starts, bins.counts)]
    di, dt = (t.to(cuda_device) for t in _cotangents(bins))
    with pytest.raises(ValueError, match="keep_state"):
        gs_stream.blend_backward(*args, bins.tx_n, 0.3, di, dt)
    state = gs_stream.blend_forward(*args, bins.tx_n, 0.3, keep_state=True)[2]
    assert state.dtype == torch.float64 and state.shape == (di.shape[0] * di.shape[1], 4)
    with pytest.raises(TypeError):
        gs_stream.blend_backward(*args, bins.tx_n, 0.3, di, dt, state.float())


def test_rasterize_tiled_backward_launches_each_kernel_once(cuda_device):
    """Autograd through rasterize_tiled on CUDA tensors runs B3 once and B4
    once, and its gradients match the CPU (plain) ones to 1e-4 of each
    key's largest |grad|."""
    p, vm = underflow_scene()
    cam = R.Camera(64, 64, 64.0, 64.0, 32.0, 32.0)
    grads = {}
    for dev in ("cpu", cuda_device):
        tp = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in p.items()}
        before = (gs_stream.BLEND_LAUNCHES, gs_stream.BLEND_BWD_LAUNCHES)
        img, alpha = R.rasterize_tiled(tp, torch.as_tensor(vm, device=dev), cam, bg_color=0.25)
        (img.square().sum() + alpha.sum()).backward()
        launched = (gs_stream.BLEND_LAUNCHES - before[0], gs_stream.BLEND_BWD_LAUNCHES - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        grads[str(dev)] = {k: to_np(v.grad) for k, v in tp.items()}
    for k, want in grads["cpu"].items():
        np.testing.assert_allclose(grads[str(cuda_device)][k], want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=k)


def test_blend_backward_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    bins = _splat_bins(n=200)
    args = [t.to(cuda_device) for t in (bins.feat, bins.idx, bins.starts, bins.counts)]
    di, dt = (t.to(cuda_device) for t in _cotangents(bins))
    with pytest.raises(ValueError, match="shape"):
        gs_stream.blend_backward(*args, bins.tx_n, 0.0, di[:-16], dt)
    with pytest.raises(ValueError, match="expected cuda"):
        gs_stream.blend_backward(*args, bins.tx_n, 0.0, di, dt.cpu())
    with pytest.raises(TypeError):
        gs_stream.blend_backward(*args, bins.tx_n, 0.0, di.double(), dt)


def _fused_case(mats, update_cov, n=4096, seed=7):
    """The 4096-particle state of _state with F = F_trial near I, the given
    material ids in turn, low yield stresses (every 8th near 0: snow damages)
    and a random velocity grid."""
    st = _state(n=n, seed=seed)
    rng = np.random.default_rng(seed + 2)
    ys = rng.uniform(10.0, 500.0, n).astype(np.float32)
    ys[::8] = 1e-3
    st = st.replace(material=torch.as_tensor(np.asarray(mats, np.int32)[np.arange(n) % len(mats)]),
                    yield_stress=torch.as_tensor(ys), F_trial=st.F.clone())
    cfg = MPMConfig(n_grid=24, grid_lim=2.0, update_cov_with_F=update_cov, rpic_damping=0.1,
                    active_materials=tuple(sorted(set(mats))), hardening=1.0, xi=0.1,
                    plastic_viscosity=0.1, softening=0.5)
    grid_v = torch.as_tensor(rng.normal(size=(24, 24, 24, 3)).astype(np.float32))
    return st, cfg, grid_v


def _fused_both(st, cfg, grid_v, dev):
    want = _to(st, "cpu", fs.UPDATED_FIELDS)
    grid_want = fs.fused_substep_plain(want, grid_v, cfg, DT, want.selection == 0)
    got = _to(st, dev, fs.UPDATED_FIELDS + ("mass", "vol", "material", "bulk", "selection"))
    before = fs.FUSED_LAUNCHES
    grid_got = fs.fused_substep(got, grid_v.to(dev), cfg, DT, got.selection == 0)
    assert fs.FUSED_LAUNCHES == before + 1
    return got, grid_got, want, grid_want


def _assert_fused_close(got, grid_got, want, grid_want, E=1e5):
    for k in ("x", "v", "C", "F_trial", "cov", "grid"):
        g, w = (grid_got, grid_want) if k == "grid" else (getattr(got, k), getattr(want, k))
        w = to_np(w)
        np.testing.assert_allclose(to_np(g), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
    for k in ("F", "stress", "mu", "lam", "yield_stress"):
        g, w = to_np(getattr(got, k)), to_np(getattr(want, k))
        floor = 6 * 1.2e-7 * (E if k == "stress" else max(float(np.abs(w).max()), 1e-30))
        diff = np.abs(g - w)
        assert (diff <= floor).mean() >= 0.9, k
        assert diff.max() <= 100 * floor, k


@pytest.mark.parametrize("update_cov", [False, True])
@pytest.mark.parametrize("mats", [(0,), (1,), (2,), (3,), (4,), (5,), (6,), (7,),
                                  (0, 1, 2, 3, 5, 6)])
def test_fused_substep_kernel_matches_plain(cuda_device, mats, update_cov):
    st, cfg, grid_v = _fused_case(mats, update_cov)
    got, grid_got, want, grid_want = _fused_both(st, cfg, grid_v, cuda_device)
    _assert_fused_close(got, grid_got, want, grid_want)
    inactive = to_np(st.selection) != 0
    for k in fs.UPDATED_FIELDS:  # inactive particles keep every field
        np.testing.assert_array_equal(to_np(getattr(got, k))[inactive],
                                      to_np(getattr(st, k))[inactive], err_msg=k)


def test_fused_frame_on_cuda_launches_once_a_substep(cuda_device):
    """simulate_substeps_fused on CUDA: 1 P2G, S - 1 fused substeps, 1 G2P,
    and x within 1e-5 of the unfused frame on the card."""
    from pixie_tpu_torch.sim import bc as bc_mod
    from pixie_tpu_torch.sim.solver import simulate_substeps, simulate_substeps_fused

    st, cfg, _ = _fused_case((0, 1, 2, 3, 5, 6), True)
    fields = fs.UPDATED_FIELDS + ("mass", "vol", "material", "bulk", "selection")
    bcs = (bc_mod.make_surface_collider((1.0, 1.0, 0.5), (0.0, 0.0, 1.0), "sticky",
                                        device=cuda_device),)
    ref = simulate_substeps(_to(st, cuda_device, fields), cfg, bcs, 0.0, DT, 8)
    before = (transfer.P2G_LAUNCHES, transfer.G2P_LAUNCHES, fs.FUSED_LAUNCHES)
    got = simulate_substeps_fused(_to(st, cuda_device, fields), cfg, bcs, 0.0, DT, 8)
    after = (transfer.P2G_LAUNCHES, transfer.G2P_LAUNCHES, fs.FUSED_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 7)
    np.testing.assert_allclose(to_np(got.x), to_np(ref.x), rtol=0, atol=1e-5)


def _fused_order(st, cfg, order):
    """The state in B6's three orders: as given, sorted by cell, and sorted
    by cell before a drift of up to 0.8 cell on each axis."""
    from pixie_tpu_torch.sim.solver import permute_state

    if order == "given":
        return st
    st = permute_state(st, transfer.cell_order(st.x, st.selection == 0, cfg))
    if order == "drifted":
        rng = np.random.default_rng(3)
        st = st.replace(x=st.x + torch.as_tensor(
            (rng.uniform(-0.8, 0.8, (st.n_particles, 3)) * cfg.dx).astype(np.float32)))
    return st


@pytest.mark.parametrize("order", ["given", "cell_sorted", "drifted"])
def test_fused_substep_kernel_in_three_orders(cuda_device, order):
    """B6 on particles in the given order, sorted by cell and in a cell order
    gone stale: grid and particle fields by B6's criterion against the
    plain version."""
    st, cfg, grid_v = _fused_case((0, 1, 2, 3, 5, 6), True)
    st = _fused_order(st, cfg, order)
    want = _to(st, "cpu", fs.UPDATED_FIELDS)
    grid_want = fs.fused_substep_plain(want, grid_v, cfg, DT, want.selection == 0)
    fields = fs.UPDATED_FIELDS + ("mass", "vol", "material", "bulk", "selection")
    got = _to(st, cuda_device, fields)
    before = fs.FUSED_LAUNCHES
    grid_got = fs.fused_substep(got, grid_v.to(cuda_device), cfg, DT, got.selection == 0)
    assert fs.FUSED_LAUNCHES == before + 1
    _assert_fused_close(got, grid_got, want, grid_want)


def test_fused_frame_on_cuda_resorts_its_order(cuda_device, monkeypatch):
    """A fused frame on CUDA runs on its state sorted by cell, renews the
    order every RESORT_EVERY substeps, and returns the state in the
    caller's order within 1e-5 of the unfused frame."""
    from pixie_tpu_torch.sim import solver as S

    st, cfg, _ = _fused_case((0, 1, 2, 3, 5, 6), True)
    fields = fs.UPDATED_FIELDS + ("mass", "vol", "material", "bulk", "selection")
    sorts, real = [], transfer.cell_order
    monkeypatch.setattr(transfer, "cell_order", lambda *a: sorts.append(1) or real(*a))
    monkeypatch.setattr(S, "RESORT_EVERY", 3)
    ref = S.simulate_substeps(_to(st, cuda_device, fields), cfg, (), 0.0, DT, 8)
    got = S.simulate_substeps_fused(_to(st, cuda_device, fields), cfg, (), 0.0, DT, 8)
    assert len(sorts) == 2
    np.testing.assert_allclose(to_np(got.x), to_np(ref.x), rtol=0, atol=1e-5)
    assert torch.equal(got.material, ref.material) and torch.equal(got.selection, ref.selection)


def test_fused_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    st, cfg, grid_v = _fused_case((0,), False, n=256)
    st = _to(st, cuda_device, fs.UPDATED_FIELDS + ("mass", "vol", "material", "bulk",
                                                   "selection"))
    grid_v = grid_v.to(cuda_device)
    active = st.selection == 0
    with pytest.raises(TypeError):
        fs.fused_substep(st.replace(mu=st.mu.double()), grid_v, cfg, DT, active)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_substep(st.replace(F=st.F.transpose(1, 2)), grid_v, cfg, DT, active)
    with pytest.raises(ValueError, match="expected cuda"):
        fs.fused_substep(st, grid_v, cfg, DT, active.cpu())
    with pytest.raises(ValueError, match="shape"):
        fs.fused_substep(st, grid_v[:8], cfg, DT, active)


PROBE_RTOL = {"full": 1e-5, "noweights": 1e-5, "noatomics": 1e-5, "minimal": 1e-6}


@pytest.mark.parametrize("order", p1.ORDERS)
@pytest.mark.parametrize("mode", probe_ablation.MODES)
def test_probe_p2g_variant_matches_plain(cuda_device, mode, order):
    """The probe's particles (20k), every 11th inactive and 64 hanging off
    the low grid faces, in both orders."""
    d = p1.make_particles(20_000, seed=2)
    d["x"][:64] = np.float32(0.02)
    cfg = p1.config()
    cpu = p1.inputs(d, order, cfg, "cpu")
    active = cpu[6].clone()
    active[::11] = False
    cpu = (*cpu[:6], active)
    want = probe_ablation.p2g_variant_plain(mode, *cpu, cfg, p1.DT)
    before = probe_ablation.LAUNCHES[mode]
    got = probe_ablation.p2g_variant(mode, *(t.to(cuda_device) for t in cpu), cfg, p1.DT)
    assert probe_ablation.LAUNCHES[mode] == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    want = to_np(want)
    np.testing.assert_allclose(to_np(got), want, rtol=0,
                               atol=PROBE_RTOL[mode] * np.abs(want).max())


def test_probe_wrapper_rejects_what_the_kernels_do_not_take(cuda_device):
    cfg = p1.config()
    args = list(p1.inputs(p1.make_particles(256), "generated", cfg, cuda_device))
    for i, bad, err in ((0, args[0].double(), TypeError), (6, args[6].int(), TypeError),
                        (2, args[2].transpose(1, 2), ValueError), (4, args[4].cpu(), ValueError),
                        (5, args[5][:-1], ValueError)):
        with pytest.raises(err):
            probe_ablation.p2g_variant("full", *args[:i], bad, *args[i + 1:], cfg, p1.DT)


@pytest.mark.parametrize("case", ["probe", "ragged", "equal_row"])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_axis_kernel_matches_plain(cuda_device, axis, case):
    """The probe's 8192 x 128; T = 1003 at L = 100 (no multiple of the 256
    threads of axis 0 or of axis 1's 20 rows a block); a row of one index
    repeated (every thread of a warp on one bank / one table row)."""
    t, l = (1003, 100) if case == "ragged" else (p2.T, p2.L)
    table, idx, _ = p2.make_inputs(axis, t, l, seed=3)
    if case == "equal_row":
        idx[5] = 7
        idx[:, 9] = 7
    want = gather.take_along_axis_plain(table, idx, axis)
    before = gather.LAUNCHES[axis]
    got = gather.take_along_axis(table.to(cuda_device), idx.to(cuda_device), axis)
    assert gather.LAUNCHES[axis] == before + 1
    np.testing.assert_array_equal(to_np(got), to_np(want))
    np.testing.assert_array_equal(to_np(got), np.take_along_axis(to_np(table), to_np(idx), axis))


@pytest.mark.parametrize("t", [1, 7, 8192])
@pytest.mark.parametrize("l", [1, 3, 127, 128, 129, 4096])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_axis_kernel_at_every_width(cuda_device, axis, l, t):
    """Exact against the plain version on the card at row lengths that take
    the vector path (L % 4 == 0) and the scalar one, and at 1, 7 and 8192
    rows; at L = 128 also from a table 4 bytes off 16-byte alignment (the
    scalar path)."""
    table, idx, _ = p2.make_inputs(axis, t, l, seed=l + t, device=cuda_device)
    cases = [table]
    if l == 128:
        flat = torch.empty(t * l + 1, device=cuda_device)
        cases.append(flat[1:].view(t, l).copy_(table))
    for tab in cases:
        before = gather.LAUNCHES[axis]
        got = gather.take_along_axis(tab, idx, axis)
        assert gather.LAUNCHES[axis] == before + 1
        assert torch.equal(got, gather.take_along_axis_plain(tab, idx, axis))


def test_take_along_axis_wrapper_rejects_what_the_kernels_do_not_take(cuda_device):
    table, idx, _ = p2.make_inputs(1, 64, 32, device=cuda_device)
    with pytest.raises(TypeError):
        gather.take_along_axis(table, idx.long(), 0)
    with pytest.raises(TypeError):
        gather.take_along_axis(table.double(), idx, 0)
    with pytest.raises(ValueError, match="contiguous"):
        gather.take_along_axis(table.t().contiguous().t(), idx, 1)
    with pytest.raises(ValueError, match="expected cuda"):
        gather.take_along_axis(table, idx.cpu(), 1)
    with pytest.raises(ValueError, match="at most"):
        wide = torch.zeros((2, gather.MAX_AXIS1_ROW + 1), device=cuda_device)
        gather.take_along_axis(wide, torch.zeros_like(wide, dtype=torch.int32), 1)


def test_probe_full_is_b1(cuda_device):
    """P1's full runs B1's keys, sort and splat: its grid agrees with
    transfer.p2g on the same particles to 1e-5 of the largest |grid| (the
    run atomics land in run-dependent order)."""
    cfg = p1.config()
    args = p1.inputs(p1.make_particles(20_000, seed=3), "generated", cfg, cuda_device)
    got = to_np(probe_ablation.p2g_variant("full", *args, cfg, p1.DT))
    want = to_np(transfer.p2g(*args, cfg, p1.DT))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# -- the voxelizer stage on the card: plain PyTorch, held against the CPU ----------

def _seeded_field_sds(fc=32, density_bias=-1.0, seed=20):
    """NerfField and FeatureField state dicts from numpy seeds: tables
    U(0, 1), weights N(0, 0.3), biases N(0, 0.1); the density bias leaves
    about a fifth of a 16^3 grid under the alpha threshold."""
    from pixie_tpu_torch.recon.field import FeatureField, NerfField

    rng = np.random.default_rng(seed)
    sds = []
    for module in (NerfField(), FeatureField(feature_dim=fc)):
        sd = {}
        for k, v in module.state_dict().items():
            a = (rng.uniform(0.0, 1.0, v.shape) if k.endswith("table") else
                 rng.normal(size=v.shape) * (0.3 if k.endswith("weight") else 0.1))
            sd[k] = torch.as_tensor(a.astype(np.float32))
        sds.append(sd)
    sds[0]["density_mlp.out.bias"][0] = density_bias
    return sds


def test_field_adapter_on_cuda_matches_cpu(cuda_device):
    """Density, features and rgb on the card against the CPU (TF32 off):
    1e-5 of each one's largest |value| (float32 sums in another order)."""
    from pixie_tpu_torch.recon.field_adapter import FieldAdapter

    nsd, fsd = _seeded_field_sds()
    pts = np.random.default_rng(1).uniform(-0.5, 0.5, (5000, 3)).astype(np.float32)
    cpu = FieldAdapter(nsd, fsd, feature_dim=32, device="cpu")
    gpu = FieldAdapter(nsd, fsd, feature_dim=32, device=cuda_device)
    assert gpu.nerf.grid.table.is_cuda
    want, got = cpu.query(pts), gpu.query(pts)
    for key in ("density", "feature"):
        w = to_np(want[key])
        np.testing.assert_allclose(to_np(got[key]), w, rtol=0, atol=1e-5 * np.abs(w).max())
    w = to_np(cpu.get_rgb(pts))
    np.testing.assert_allclose(to_np(gpu.get_rgb(pts)), w, rtol=0, atol=1e-5)


def test_extract_feature_voxel_grid_on_cuda_matches_cpu(cuda_device, tmp_path):
    """The whole stage at 16^3 on the card and on the CPU: the mask
    identical, features and alphas within one float16 ulp (near zero two
    float32 ulps of the largest |feature|), and the device grid equal to the
    npy bit for bit."""
    from pixie_tpu_torch.recon.field_adapter import FieldAdapter
    from pixie_tpu_torch.voxel.voxelize import extract_feature_voxel_grid

    nsd, fsd = _seeded_field_sds()
    out = {}
    for name, dev in (("cpu", "cpu"), ("cuda", cuda_device)):
        out[name] = extract_feature_voxel_grid(
            FieldAdapter(nsd, fsd, feature_dim=32, device=dev), tmp_path / name / "v.npz",
            voxel_size=1 / 16, batch_size=1000, expected_grid=16, nb_neighbors=10, device=dev)
        out[name]["wait"]()
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu["features_dev"].is_cuda
    feats = np.load(gpu["features"])
    np.testing.assert_array_equal(to_np(gpu["features_dev"]).view(np.uint16),
                                  feats.view(np.uint16))
    np.testing.assert_array_equal(np.load(gpu["mask"]), np.load(cpu["mask"]))
    for key in ("features", "alphas", "rgb"):
        g, w = np.load(gpu[key]), np.load(cpu[key])
        ulp = np.spacing(np.maximum(np.abs(g), np.abs(w))).astype(np.float32)
        slack = ulp + 2.0 ** -22 * np.abs(w.astype(np.float32)).max()
        assert (np.abs(g.astype(np.float32) - w.astype(np.float32)) <= slack).all(), key


def test_occupancy_mask_on_cuda_matches_cpu(cuda_device):
    """The lattice kNN and DBSCAN convolutions through cuDNN, bit for bit
    against the CPU on a seeded 48^3 scene (a ball with holes, a floating
    cluster, isolated voxels), with and without TF32."""
    from pixie_tpu_torch.voxel.voxelize import create_occupancy_mask, dense_voxel_grid

    d = 48
    rng = np.random.default_rng(4)
    grid = dense_voxel_grid((-0.5,) * 3, (0.5,) * 3, 1.0 / d)
    r = np.linalg.norm(grid, axis=-1)
    alpha = np.where(r < 0.3, rng.uniform(0.2, 1.0, r.shape), 0.0)
    alpha[rng.random(r.shape) < 0.15] = 0.0
    alpha[(r > 0.42) & (rng.random(r.shape) < 0.002)] = 0.6
    alpha[4:7, 4:7, 40:43] = 0.7
    alphas = alpha[..., None].astype(np.float16)
    rgb = rng.uniform(0.0, 1.0, grid.shape).astype(np.float16)
    want = create_occupancy_mask(grid, alphas, rgb, voxel_size=1.0 / d, device="cpu")
    assert 0 < want.sum() < (alpha > 0.01).sum()
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        for allow in (False, True):
            torch.backends.cudnn.allow_tf32 = allow
            got = create_occupancy_mask(grid, alphas, rgb, voxel_size=1.0 / d,
                                        device=cuda_device)
            np.testing.assert_array_equal(got, want)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def test_tcnn_network_on_cuda_matches_cpu(cuda_device):
    """tcnn's hash grid + frequency encoding + padded MLP from one seeded flat
    buffer, on the card against the CPU: 1e-5 of the largest |value|."""
    from pixie_tpu_torch.recon import tcnn_compat as tc

    grid = tc.TcnnGridConfig.from_min_max(6, 2, 12, 8, 256)
    mlp = tc.TcnnMLPConfig(in_dim=12 + 3 * 2 * 3, out_dim=20, hidden=32, n_hidden_layers=2)
    rng = np.random.default_rng(5)
    flat = np.concatenate([rng.normal(0, 0.3, mlp.n_params),
                           rng.uniform(-0.1, 0.1, grid.n_params)]).astype(np.float32)
    net = tc.TcnnNetworkWithInputEncoding(grid, mlp, pe_n_freq=3)
    net.load_state_dict(tc.split_tcnn_params(flat, grid, mlp))
    x = torch.as_tensor(rng.uniform(0, 1, (4000, 3)).astype(np.float32))
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        want = to_np(net(x))
        got = to_np(net.to(cuda_device)(x.to(cuda_device)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _seeded_module(module, seed):
    """Hash tables U(0, 1), weights N(0, 0.3), biases N(0, 0.1) from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, prm in module.named_parameters():
            if name.endswith("table"):
                prm.copy_(torch.rand(prm.shape, generator=gen))
            else:
                prm.copy_(torch.randn(prm.shape, generator=gen)
                          * (0.3 if name.endswith("weight") else 0.1))
    return module


def test_field_render_and_gradients_on_cuda_match_cpu(cuda_device):
    """render_rays_prop through the shipped fields (mxu; a 24-wide feature
    field) in train mode on the same draws, the card against the CPU:
    outputs within 1e-3 of the largest value, every parameter's gradient
    within 2e-2 of its largest, the bounds tests/test_torch_field_render.py
    holds the port to JAX by (sample positions a few ulps apart: the CPU's
    cumsum accumulates in double; bfloat16 MXU weights and gradients;
    index_add_'s float atomics in run-dependent order on the card)."""
    from pixie_tpu_torch.recon import field as F

    rng = np.random.default_rng(0)
    target = rng.uniform(-0.3, 0.3, (64, 3))
    origins = rng.normal(size=(64, 3))
    origins *= 2.0 / np.linalg.norm(origins, axis=1, keepdims=True)
    dirs = target - origins
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rcfg = F.RenderConfig(n_coarse=32, n_fine=16)
    draws = F.draw_uniforms(64, rcfg, torch.Generator().manual_seed(1))
    cot = {k: torch.as_tensor(rng.normal(size=s).astype(np.float32))
           for k, s in (("rgb", (64, 3)), ("depth", (64,)), ("feature", (64, 24)))}
    results = {}
    for dev in ("cpu", cuda_device):
        fields = {"prop": _seeded_module(F.ProposalField(), 2),
                  "nerf": _seeded_module(F.NerfField(), 3),
                  "feat": _seeded_module(F.FeatureField(feature_dim=24), 4)}
        for m in fields.values():
            m.to(dev)
        out = F.render_rays_prop(
            fields["prop"], fields["nerf"], fields["feat"],
            *(torch.as_tensor(a.astype(np.float32), device=dev) for a in (origins, dirs)),
            rcfg, train=True, draws=tuple(d.to(dev) for d in draws))
        (sum((out[k] * cot[k].to(dev)).sum() for k in cot) + out["prop_loss"]).backward()
        results[str(dev)] = ({k: to_np(v) for k, v in out.items()},
                             {f"{n}.{k}": to_np(p.grad) for n, m in fields.items()
                              for k, p in m.named_parameters()})
    (want_out, want_grad), (got_out, got_grad) = results["cpu"], results[str(cuda_device)]
    for k, w in want_out.items():
        np.testing.assert_allclose(got_out[k], w, rtol=0, atol=1e-3 * np.abs(w).max(), err_msg=k)
    for k, w in want_grad.items():
        np.testing.assert_allclose(got_grad[k], w, rtol=0, atol=2e-2 * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["float32", "bfloat16"])
def test_clip_tower_on_cuda_matches_cpu(cuda_device, dtype):
    """The CLIP tower (a small config, seeded HF weights) on a rectangular
    patch grid: float32 within 1e-5 of the largest value, bfloat16 within
    2e-2 (tests/test_torch_clip.py's bounds against JAX)."""
    from torch_parity import TINY_CLIP, hf_clip_state_dict

    from pixie_tpu_torch.recon import clip_tower as C

    cfg = C.CLIPVisionConfig(**{k: TINY_CLIP[k] for k in (
        "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
        "patch_size", "image_size")})
    params = C.convert_clip_vision_state_dict(hf_clip_state_dict(TINY_CLIP, seed=0), cfg)
    images = np.random.default_rng(1).uniform(0, 1, (3, 40, 56, 3)).astype(np.float32)
    want = C.extract_clip_features_torch(images, params, cfg, dtype=dtype, device="cpu")
    got = C.extract_clip_features_torch(images, params, cfg, dtype=dtype, device=cuda_device)
    rtol = 1e-5 if dtype is None else 2e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _grad_err(got: dict, want: dict, floor: float = 1e-3) -> float:
    """Worst gradient difference over each tensor's largest |value| (at
    least ``floor`` of the net's largest: a bias ahead of a norm has
    gradient 0 in exact arithmetic, rounding noise in both runs)."""
    top = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k].cpu() - w.cpu()).abs().max())
               / max(float(w.abs().max()), floor * top) for k, w in want.items())


def test_unet_train_step_on_cuda_matches_cpu(cuda_device, tmp_path):
    """One Trainer step of each U-Net (SMALL widths) on the card and on the
    CPU from the same weights and batch, TF32 off: the loss within 1e-5,
    every gradient within 1e-3 of its scale (cuDNN's and oneDNN's float32
    sums in other orders), and the accuracy equal."""
    from unet_train_parity import SMALL, ddp_batches, seeded_params

    from pixie_tpu_torch.train.trainer import TrainConfig, Trainer

    _, batches = ddp_batches(tmp_path, np.random.default_rng(3))
    feat, mat_id, mask = batches[0]
    cont = np.random.default_rng(4).uniform(-1, 1, mat_id.shape + (3,)).astype(np.float32)
    for mode, target in (("discrete", mat_id), ("continuous", cont)):
        cfg = TrainConfig(mode=mode, batch_size=4, **SMALL)
        params = seeded_params(cfg, seed=5)
        runs = []
        for dev in (cuda_device, torch.device("cpu")):
            trainer = Trainer(cfg, device=dev)
            trainer.setup(1, params=params)
            runs.append((trainer.train_step((feat, target, mask)),
                         {n: p.grad for n, p in trainer.model.named_parameters()}))
        ((loss, aux), grads), ((want_loss, want_aux), want) = runs
        assert loss == pytest.approx(want_loss, rel=1e-5)
        assert aux.keys() == want_aux.keys()
        for k in aux:
            assert aux[k] == pytest.approx(want_aux[k], rel=1e-5), k
        assert _grad_err(grads, want) <= 1e-3


def test_ddp_nccl_gradient_equals_one_process(cuda_device, tmp_path):
    """DDP over NCCL, one card a rank (up to 4 cards; skipped on one): the
    ranks' averaged gradient against one process's on the whole batch on
    the first card, for a batch whose rows hold different foreground
    counts and for an odd batch (a zero-weight pad row), within 1e-3 of
    each gradient's scale (cuDNN's sums differ between batch sizes)."""
    from unet_train_parity import SMALL, ddp_batches, run_ddp, seeded_params

    from pixie_tpu_torch.train.trainer import TrainConfig, Trainer

    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        pytest.skip("needs 2 or more cards (NCCL DDP)")
    cfg_kw = dict(mode="discrete", batch_size=4, **SMALL)
    params = seeded_params(TrainConfig(**cfg_kw), seed=8)
    batch_paths, batches = ddp_batches(tmp_path, np.random.default_rng(9))
    ranks = run_ddp(tmp_path, world, cfg_kw, params, batch_paths, device="cuda")
    assert [r[0]["device"] for r in ranks] == [f"cuda:{i}" for i in range(world)]
    for i, batch in enumerate(batches):
        one = Trainer(TrainConfig(**cfg_kw), device=cuda_device)
        one.setup(1, params=params)
        loss, _ = one.train_step(batch)
        want = {n: p.grad for n, p in one.model.named_parameters()}
        for r in ranks:
            assert r[i]["world"] == world
            assert r[i]["loss"] == pytest.approx(loss, rel=1e-5)
            assert _grad_err(r[i]["grads"], want) <= 1e-3


# -- the sharded paths over NCCL, one card a rank -------------------------------------

def _cards(world):
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards (NCCL, one card a rank)")


def _x_close_in_cells(got, want, inv_dx):
    """PERF.md's criterion for unfused frames in two particle orders: mean
    |dx| <= 1e-4 cell, max <= 1e-2 cell (B1 adds float atomics in run
    order, and the ranks' grids are summed in another)."""
    d = np.abs(got - want) * inv_dx
    assert d.mean() <= 1e-4 and d.max() <= 1e-2, (d.mean(), d.max())


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_mpm_nccl(cuda_device, tmp_path, world):
    """The all-reduce path (n_grid 32) and the halo path (n_grid 48 on 2
    cards, 96 on 4) on NCCL ranks against one process on the first card;
    each rank's B1 and B2 launches equal its substeps."""
    from torch_dist_workers import mpm_inputs, run_ranks, torch_bcs, torch_state

    from pixie_tpu_torch.sim.solver import simulate_substeps

    _cards(world)
    grav = (0.0, 0.0, -9.8)
    halo_grid = 48 if world == 2 else 96
    cases = [dict(inputs=dict(n=20_000, seed=6), cfg=dict(n_grid=32, grid_lim=2.0, gravity=grav,
                                                          active_materials=(0,)),
                  substeps=20, path="rollout",
                  bcs=[("collider", dict(point=(1.0, 1.0, 0.75), normal=(0.0, 0.0, 1.0)))]),
             dict(inputs=dict(n=20_000, seed=7), cfg=dict(n_grid=halo_grid, grid_lim=2.0,
                                                          gravity=grav, active_materials=(0,)),
                  substeps=20, path="halo",
                  bcs=[("impulse", dict(force=(0.0, 0.0, 20.0), z=1.0))])]
    res = run_ranks(tmp_path, world, "mpm", {"cases": cases, "gloo": False}, device="cuda")
    for i, case in enumerate(cases):
        d = mpm_inputs(**case["inputs"])
        cfg = MPMConfig(**case["cfg"])
        one = simulate_substeps(torch_state(d, cuda_device),
                                cfg, torch_bcs(case["bcs"], d["x"], cuda_device), 0.0, DT,
                                case["substeps"])
        for r in res:
            assert np.isfinite(r[i]["x"]).all()
            assert r[i]["launches"] == (case["substeps"], case["substeps"])
            _x_close_in_cells(r[i]["x"], to_np(one.x), cfg.inv_dx)


@pytest.mark.parametrize("world", [2, 4])
def test_unet_sp_nccl(cuda_device, tmp_path, world):
    """The U-Net trainer on (1, 2) or (2, 2) NCCL ranks against one process
    on the first card: the loss to rel 1e-5, each gradient within 1e-3 of
    its scale (phase 9's card bound), or as close to the float64 gradient
    as one process's own where a LeakyReLU input within rounding of 0
    takes the other slope (tests/torch_dist_workers.check_sp_grads)."""
    from torch_dist_workers import (
        check_sp_grads, load_batches, run_ranks, unet_grads64, unet_steps,
    )
    from unet_train_parity import seeded_params

    from pixie_tpu_torch.train.trainer import TrainConfig, Trainer

    _cards(world)
    dp = world // 2
    cfg_kw = dict(mode="discrete", batch_size=2 * dp, lr=1e-3, feature_channels=16, cond_dim=8,
                  model_channels=8, num_res_blocks=1, channel_mult=(1, 2), grid_size=8)
    params = seeded_params(TrainConfig(**cfg_kw), seed=12)
    torch.save(params, tmp_path / "p.pt")
    rng = np.random.default_rng(13)
    paths = []
    for i in range(2):
        b = 2 * dp
        mask = (rng.uniform(size=(b, 8, 8, 8)) < 0.5).astype(np.float32)
        np.savez(tmp_path / f"b{i}.npz", feat=rng.normal(size=(b, 8, 8, 8, 16)).astype(np.float32),
                 target=np.where(mask > 0, rng.integers(0, 7, mask.shape), 7), mask=mask)
        paths.append(str(tmp_path / f"b{i}.npz"))
    run = dict(dp=dp, sp=2, cfg=cfg_kw, params=str(tmp_path / "p.pt"), batches=paths)
    res = run_ranks(tmp_path, world, "unet", {"runs": [run], "gloo": False}, device="cuda")

    def one():
        t = Trainer(TrainConfig(**cfg_kw), device=cuda_device)
        t.setup(1, params=params)
        return t

    batches = load_batches(paths)
    want = unet_steps(one, batches)
    want64 = [unet_grads64(cfg_kw, params, b, cuda_device) for b in batches]
    for r in res:
        for got, w, w64 in zip(r[0], want, want64):
            assert got["loss"] == pytest.approx(w["loss"], rel=1e-5)
            check_sp_grads(got["grads"], w["grads"], w64, 1e-3)
