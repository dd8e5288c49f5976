"""The grid stage's dispatch (``sim.solver.grid_update``), the host table of
grid BCs it hands the card (``ops.grid.bc_table``) and, on the card, its
kernel (B8, ``csrc/grid.cu``) against the plain version on the card.

On the CPU ``grid_update`` is the plain version (``grid_momentum_to_velocity``
then ``apply_grid_bcs``), and the table is built from the BCs' host copies
and host decisions alone: in insertion order, without the BCs inactive at
t, a reset in its place, a moving cuboid's point rounded as ``_inside``
rounds it, cut into ordered parts of ``TABLE_CAPACITY``.  The table's
meaning is held to the plain BCs through a plain PyTorch rendering of the
kernel's per-node loop (``_emulate``).

On the card (tests marked ``cuda``, skipped without a GPU: a CUDA kernel
has no CPU mode; ``python -m pytest tests/test_torch_grid_kernel.py -m
cuda``) the kernel equals the plain version on the card bit for bit: no
BC, the scene's gravity, damping and sticky collider, a tilted sticky
collider (its signed distance summed as PyTorch's CUDA reduction sums three
terms), the tree's still cuboids, a reset, an inactive BC, more BCs than a
table holds.  Slip and frictional colliders, a cut, the bounding box and a
moving cuboid are held within 1e-6 of the largest |velocity|: their plain
versions run more kernels, among them ``linalg.vector_norm``'s reduction,
whose multiply-adds nvcc may contract, and a cut or a box edge that a node
sits on decides a whole velocity.  This file imports no JAX package module.
"""

import numpy as np
import pytest
import torch

from torch_parity import cuda_device, random_particles, to_np  # noqa: F401  (fixture)

from pixie_tpu_torch.ops import grid as grid_op
from pixie_tpu_torch.sim import bc as tbc
from pixie_tpu_torch.sim import solver as S
from pixie_tpu_torch.sim.types import MPMConfig, finalize_mu_lam, make_state
from pixie_tpu_torch.utils import observability as obs

DT = 1e-4
SCENE = dict(grid_lim=3.0, gravity=(0.0, 0.0, -9.8), grid_v_damping_scale=0.9999)
TREE = dict(grid_lim=2.0, gravity=(0.0, 0.0, 0.0), grid_v_damping_scale=0.9999)


def _cfg(n_grid, **kw):
    return MPMConfig(n_grid=n_grid, **kw)


def _grid(cfg, seed=0, device="cpu"):
    """A seeded (G, G, G, 4) P2G grid: momenta ~ N(0, 1e-3), masses in
    [1e-6, 1e-3], a third of the nodes empty (mass 0, momentum 0) and some
    with a mass at or below 1e-15 but a momentum."""
    g = cfg.n_grid
    rng = np.random.default_rng(seed)
    grid = np.empty((g, g, g, 4), np.float32)
    grid[..., :3] = rng.normal(0.0, 1e-3, (g, g, g, 3))
    grid[..., 3] = rng.uniform(1e-6, 1e-3, (g, g, g))
    empty = rng.random((g, g, g)) < 1 / 3
    grid[empty] = 0.0
    tiny = rng.random((g, g, g)) < 0.01
    grid[..., 3][tiny] = np.float32(1e-15) * rng.uniform(0.0, 1.0, int(tiny.sum()))
    return torch.as_tensor(grid, device=device)


def _plain(grid, cfg, t, bcs):
    """The plain grid stage on the grid's own device."""
    v = S.grid_momentum_to_velocity(grid, cfg, np.float32(DT))
    if any(isinstance(b, tbc.GRID_BC_TYPES) for b in bcs):
        v = S.apply_grid_bcs(v, S.node_positions(cfg, grid.device), cfg, np.float32(DT), t, bcs)
    return v.contiguous()


def _collider(surface, normal=(0.0, 0.0, 1.0), point=(1.0, 1.0, 0.5), friction=0.0,
              legacy=True, start=0.0, end=999.0, device="cpu"):
    b = tbc.make_surface_collider(point, normal, "sticky" if surface == "sticky" else surface,
                                  friction, start, end, device=device)
    b.legacy_zero_velocity = legacy
    return b


def _cuboid(point, size, velocity=(0.0, 0.0, 0.0), start=0.0, end=999.0, reset=0,
            device="cpu"):
    return tbc.make_cuboid_velocity(point, size, velocity, start, end, reset, device=device)


def _impulse(device="cpu"):
    x = np.random.default_rng(1).uniform(0.5, 1.5, (50, 3)).astype(np.float32)
    return tbc.make_particle_impulse(x, (0.0, 0.0, 1.0), DT, device=device)


def _case_bcs(case, device="cpu"):
    """(config keywords, BCs, time) of a card case."""
    if case == "none":
        return SCENE, (), np.float32(0.0)
    if case == "scene":
        return SCENE, (_collider("sticky", point=(1.5, 1.5, 0.2), device=device),), \
            np.float32(0.0)
    if case == "tilted_sticky":
        return SCENE, (_collider("sticky", normal=(0.3, -0.2, 1.0), point=(1.5, 1.4, 0.7),
                                 device=device),), np.float32(0.0)
    if case == "tree":
        return TREE, (_cuboid((1.0, 1.0, 0.3), (1.0, 1.0, 0.15), device=device),
                      _cuboid((1.0, 1.0, 0.62), (0.2, 0.2, 0.21), device=device)), \
            np.float32(0.02)
    if case == "reset":
        # ended at 0.01, so it zeroes the grid for 15 dt after; the cuboid
        # after it sets its own nodes again
        return TREE, (_cuboid((1.0, 1.0, 1.0), (0.3, 0.3, 0.3), (0.0, 0.5, 0.0), 0.0, 0.01,
                              reset=1, device=device),
                      _cuboid((1.0, 1.0, 0.3), (0.4, 0.4, 0.2), (0.0, 0.0, 0.25),
                              device=device)), np.float32(0.0105)
    if case == "inactive":
        return SCENE, (_collider("sticky", point=(1.5, 1.5, 0.9), start=0.5, device=device),
                       _cuboid((1.5, 1.5, 1.5), (0.3, 0.3, 0.3), (1.0, 0.0, 0.0), 0.0, 0.01,
                               device=device),
                       _collider("sticky", point=(1.5, 1.5, 0.2), device=device)), \
            np.float32(0.02)
    if case == "overflow":
        bcs = []
        for i in range(grid_op.TABLE_CAPACITY + 5):
            c = 0.2 + 0.12 * i
            bcs.append(_cuboid((c, 3.0 - c, 1.5), (0.2, 0.2, 0.2), (0.0, 0.01 * i, 0.0),
                               device=device))
            if i % 4 == 0:
                bcs.append(_collider("sticky", normal=(1.0, 1.0, 0.2), point=(c, c, 0.2),
                                     device=device))
        return SCENE, tuple(bcs), np.float32(0.0)
    if case in ("slip", "frictional"):
        return SCENE, (_collider(case, normal=(0.2, 0.1, 1.0), point=(1.5, 1.5, 1.2),
                                 friction=0.3, legacy=False, device=device),), np.float32(0.0)
    if case == "cut":
        return TREE, (_collider("cut", normal=(0.0, 1.0, 0.0), point=(1.0, 1.0, 1.0),
                                device=device),), np.float32(0.0)
    if case == "bounding_box":
        return SCENE, (tbc.BoundingBox(),), np.float32(0.0)
    if case == "moving":
        return TREE, (_cuboid((0.7, 1.0, 1.0), (0.25, 0.2, 0.3), (1.3, -0.7, 0.4), 0.0, 0.5,
                              device=device),), np.float32(0.0123)
    raise ValueError(case)


# -- CPU: the table ------------------------------------------------------------------------------

def _mixed_bcs():
    return (_collider("sticky", point=(1.5, 1.5, 0.2)),
            _impulse(),
            _cuboid((1.0, 1.0, 0.3), (1.0, 1.0, 0.15)),
            tbc.BoundingBox(),
            _collider("slip", normal=(0.0, 1.0, 1.0), friction=0.2, legacy=False),
            _collider("frictional", normal=(1.0, 0.0, 1.0), friction=0.4, legacy=False),
            _collider("slip", legacy=True),
            _collider("cut", normal=(0.0, 1.0, 0.0)),
            _cuboid((0.5, 0.5, 0.5), (0.1, 0.2, 0.3), (0.0, 0.0, 2.0)))


def test_table_keeps_insertion_order_and_kinds():
    """Every active grid BC, in the order given, the particle BCs left out;
    a slip collider with the legacy zeroing zeroes; the vectors are the
    BCs' own, bit for bit."""
    bcs = _mixed_bcs()
    [(kinds, vals)] = grid_op.bc_table(bcs, np.float32(0.1), np.float32(DT))
    assert kinds.tolist() == [grid_op.HALFSPACE_ZERO, grid_op.BOX_SET, grid_op.BOUNDING_BOX,
                              grid_op.HALFSPACE_SLIP, grid_op.HALFSPACE_FRICTION,
                              grid_op.HALFSPACE_ZERO, grid_op.HALFSPACE_CUT, grid_op.BOX_SET]
    assert vals.dtype == np.float32 and vals.shape == (8, grid_op.ENTRY_FLOATS)
    grid_bcs = [b for b in bcs if isinstance(b, tbc.GRID_BC_TYPES)]
    for row, b in zip(vals, grid_bcs):
        if isinstance(b, tbc.SurfaceCollider):
            np.testing.assert_array_equal(row[0:3], to_np(b.point))
            np.testing.assert_array_equal(row[3:6], to_np(b.normal))
            assert row[9] == np.float32(b.friction)
        elif isinstance(b, tbc.CuboidVelocity):
            np.testing.assert_array_equal(row[3:6], to_np(b.size))
            np.testing.assert_array_equal(row[6:9], to_np(b.velocity))
        else:
            assert not row.any()


@pytest.mark.parametrize("t", [0.0, 0.0099, 0.01, 0.0100999, 0.0102, 0.0114, 0.3, 0.5, 0.6])
def test_table_drops_inactive_bcs_per_host_key(t):
    """At each time, a collider or a bounding box has an entry exactly
    where its ``host_key`` says it is active, a cuboid where it is active
    (its point) or resets (a zeroing entry), in the BCs' order."""
    t, dt = np.float32(t), np.float32(DT)
    bcs = (_collider("sticky", start=0.01, end=0.5), tbc.BoundingBox(0.0, 0.0102),
           _cuboid((1.0, 1.0, 1.0), (0.2, 0.2, 0.2), (0.0, 0.0, 1.0), 0.0, 0.01, reset=1),
           _cuboid((1.0, 1.0, 1.0), (0.2, 0.2, 0.2), start=0.3, end=0.6),
           _collider("cut", start=0.0, end=0.0114))
    want = []
    for b in bcs:
        key = b.host_key(t, dt)
        if isinstance(b, tbc.CuboidVelocity):
            active, resets = (True, False) if key is None else key
            if active or resets:
                want.append(grid_op.BOX_SET if active else grid_op.ZERO_ALL)
        elif key:
            want.append(grid_op.HALFSPACE_CUT if b is bcs[-1] else
                        grid_op.BOUNDING_BOX if isinstance(b, tbc.BoundingBox)
                        else grid_op.HALFSPACE_ZERO)
    tables = grid_op.bc_table(bcs, t, dt)
    got = [k for kinds, _ in tables for k in kinds.tolist()]
    assert got == want
    assert (tables == []) == (want == [])


def test_table_puts_a_reset_in_its_place():
    """A reset cuboid between two others: its zeroing entry sits between
    their entries during the 15 dt after its end, and drops out after."""
    dt = np.float32(DT)
    bcs = (_cuboid((0.5, 0.5, 0.5), (0.1, 0.1, 0.1)),
           _cuboid((1.0, 1.0, 1.0), (0.2, 0.2, 0.2), (0.0, 0.0, 1.0), 0.0, 0.01, reset=1),
           _collider("sticky"))
    kinds = {t: [k for ks, _ in grid_op.bc_table(bcs, np.float32(t), dt) for k in ks.tolist()]
             for t in (0.005, 0.0105, 0.0116)}
    assert kinds[0.005] == [grid_op.BOX_SET, grid_op.BOX_SET, grid_op.HALFSPACE_ZERO]
    assert kinds[0.0105] == [grid_op.BOX_SET, grid_op.ZERO_ALL, grid_op.HALFSPACE_ZERO]
    assert kinds[0.0116] == [grid_op.BOX_SET, grid_op.HALFSPACE_ZERO]


@pytest.mark.parametrize("t", [0.0, 1e-4, 0.0123, 0.1337, 0.25, 0.5, 0.75])
def test_moving_cuboid_point_is_the_one_inside_uses(t):
    """The table's point of a moving cuboid equals, bit for bit, the point
    ``CuboidVelocity._inside`` computes on the device (clamped travel, a
    float32 product, then a sum), and the nodes inside a box at the
    table's point are ``_inside``'s nodes."""
    t = np.float32(t)
    b = _cuboid((0.7, 1.0, 1.0), (0.25, 0.2, 0.3), (1.3, -0.7, 0.4), 0.1, 0.5)
    tables = grid_op.bc_table((b,), t, np.float32(DT))
    if not tbc._active(t, b.start_time, b.end_time):
        assert tables == []
        return
    [(kinds, vals)] = tables
    assert kinds.tolist() == [grid_op.BOX_SET]
    point = b.point + b.velocity * float(b._travel(t))
    np.testing.assert_array_equal(vals[0, 0:3].view(np.int32), to_np(point).view(np.int32))
    cfg = _cfg(40, **TREE)
    node_x = S.node_positions(cfg, "cpu")
    inside = np.all(np.abs(to_np(node_x) - vals[0, 0:3]) < vals[0, 3:6], axis=-1)
    np.testing.assert_array_equal(inside, to_np(b._inside(t, node_x)))
    assert inside.any()


def test_table_splits_more_bcs_than_it_holds_into_ordered_parts():
    """37 active grid BCs: tables of 16, 16 and 5 entries whose
    concatenation is the one list in the BCs' order."""
    bcs = [(_cuboid((0.1 * i, 1.0, 1.0), (0.1, 0.1, 0.1)) if i % 3 else
            _collider("sticky", point=(1.0, 1.0, 0.01 * i))) for i in range(37)]
    tables = grid_op.bc_table(bcs, np.float32(0.0), np.float32(DT))
    assert [len(k) for k, _ in tables] == [16, 16, 5]
    assert grid_op.TABLE_CAPACITY == 16
    vals = np.concatenate([v for _, v in tables])
    kinds = np.concatenate([k for k, _ in tables])
    for i, b in enumerate(bcs):
        if isinstance(b, tbc.CuboidVelocity):
            assert kinds[i] == grid_op.BOX_SET and vals[i, 0] == np.float32(0.1 * i)
        else:
            assert kinds[i] == grid_op.HALFSPACE_ZERO and vals[i, 2] == np.float32(0.01 * i)


def test_table_reads_no_tensor():
    """Built from the host copies the BCs made at construction: with every
    tensor of every BC replaced by one on the meta device (whose values
    cannot be read), each substep's table is the one built before."""
    bcs = _mixed_bcs()
    times = [np.float32(t) for t in (0.0, 0.05, 0.5)]
    want = [grid_op.bc_table(bcs, t, np.float32(DT)) for t in times]
    for b in bcs:
        for k in ("point", "normal", "size", "velocity", "force", "mask"):
            if hasattr(b, k):
                setattr(b, k, torch.empty_like(getattr(b, k), device="meta"))
    for t, w in zip(times, want):
        got = grid_op.bc_table(bcs, t, np.float32(DT))
        assert len(got) == len(w)
        for (gk, gv), (wk, wv) in zip(got, w):
            np.testing.assert_array_equal(gk, wk)
            np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("kind", tbc.GRID_BC_TYPES, ids=lambda k: k.__name__)
def test_every_grid_bc_type_has_a_table_entry(kind):
    """Each grid BC decides its own entry, next to its ``apply``."""
    assert callable(getattr(kind, "table_entry", None))


def test_table_refuses_a_grid_bc_without_an_entry(monkeypatch):
    """A grid BC type the table cannot hold raises, where the card would
    otherwise drop it; an object of no BC type is left out, as the plain
    ``apply_grid_bcs`` leaves it."""
    class Unknown:
        def apply(self, time, dt, grid_v, node_x, cfg):
            return grid_v

    monkeypatch.setattr(tbc, "GRID_BC_TYPES", tbc.GRID_BC_TYPES + (Unknown,))
    with pytest.raises(TypeError, match="Unknown"):
        grid_op.bc_table((_cuboid((1.0, 1.0, 1.0), (0.1, 0.1, 0.1)), Unknown()),
                         np.float32(0.0), np.float32(DT))
    monkeypatch.undo()
    [(kinds, _)] = grid_op.bc_table((Unknown(), tbc.BoundingBox()), np.float32(0.0),
                                    np.float32(DT))
    assert kinds.tolist() == [grid_op.BOUNDING_BOX]


def _emulate(v, cfg, tables):
    """csrc/grid.cu's BC loop in plain PyTorch, one entry at a time over the
    whole grid, each product and sum rounded to float32 as the kernel
    rounds it; its sums of three terms are the device's own reduction
    (``.sum(-1)``), whose order the kernel takes from the card's."""
    g = cfg.n_grid
    idx = torch.arange(g, dtype=torch.float32) * np.float32(cfg.dx)
    p = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1)
    v = v.clone()
    zero = torch.zeros(())

    def dot(a, n):
        return (a * n).sum(-1)

    for kinds, vals in tables:
        for kind, e in zip(kinds.tolist(), torch.as_tensor(vals)):
            a, b, c, fric = e[0:3], e[3:6], e[6:9], e[9]
            if kind == grid_op.BOX_SET:
                v = torch.where(((p - a).abs() < b).all(-1)[..., None], c, v)
            elif kind == grid_op.ZERO_ALL:
                v = torch.zeros_like(v)
            elif kind == grid_op.BOUNDING_BOX:
                i = torch.round(p * np.float32(cfg.inv_dx)).to(torch.int32)
                v = torch.where((i < 3) & (v < 0), zero, v)
                v = torch.where((i >= g - 3) & (v > 0), zero, v)
            else:
                below = (dot(p - a, b) < 0)[..., None]
                if kind == grid_op.HALFSPACE_ZERO:
                    new = torch.zeros_like(v)
                elif kind == grid_op.HALFSPACE_CUT:
                    z = p[..., 2:3]
                    new = torch.where((z < 0.4) | (z > 0.53), zero,
                                      torch.stack([v[..., 0] * np.float32(0.3), zero.expand(
                                          v.shape[:3]), v[..., 2] * np.float32(0.3)], -1))
                else:
                    nc = dot(v, b)
                    s = nc if kind == grid_op.HALFSPACE_SLIP else torch.clamp(nc, max=0.0)
                    q = v - s[..., None] * b
                    ln = torch.sqrt((q * q).sum(-1))
                    scale = torch.clamp(ln + nc * fric, min=0.0)
                    new = torch.where(((nc < 0) & (ln > 1e-20))[..., None],
                                      scale[..., None] * q / torch.clamp(ln, min=1e-20)[..., None],
                                      q)
                v = torch.where(below, new, v)
    return v


@pytest.mark.parametrize("case", ["scene", "tilted_sticky", "tree", "reset", "inactive",
                                  "overflow", "slip", "frictional", "cut", "bounding_box",
                                  "moving"])
def test_table_means_what_the_plain_bcs_do(case):
    """The kernel's loop over the table, rendered in plain PyTorch on the
    CPU, gives the plain ``apply_grid_bcs``'s velocities: bit for bit where
    no norm is taken, within 1e-6 of the largest |v| for slip and
    frictional colliders (``linalg.vector_norm`` sums in its own order)."""
    kw, bcs, t = _case_bcs(case)
    cfg = _cfg(20, **kw)
    grid = _grid(cfg, seed=4)
    v = S.grid_momentum_to_velocity(grid, cfg, np.float32(DT))
    want = _plain(grid, cfg, t, bcs)
    got = _emulate(v, cfg, grid_op.bc_table(bcs, t, np.float32(DT)))
    assert not torch.equal(want, v.contiguous())
    if case in ("slip", "frictional"):
        w = to_np(want)
        np.testing.assert_allclose(to_np(got), w, rtol=0, atol=1e-6 * np.abs(w).max())
    else:
        np.testing.assert_array_equal(to_np(got).view(np.int32), to_np(want).view(np.int32))


# -- CPU: dispatch ------------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["none", "scene", "tree", "overflow"])
def test_cpu_grid_update_is_the_plain_version(monkeypatch, case):
    """On CPU tensors ``grid_update`` never reaches the kernel's wrapper and
    returns the plain pieces' velocities bit for bit; no launch counted."""
    def boom(*a, **k):
        raise AssertionError("the CPU took the kernel's path")

    monkeypatch.setattr(grid_op, "grid_stage", boom)
    kw, bcs, t = _case_bcs(case)
    cfg = _cfg(16, **kw)
    grid = _grid(cfg, seed=2)
    launches = grid_op.GRID_LAUNCHES
    got = S.grid_update(grid, cfg, np.float32(DT), t, bcs)
    assert grid_op.GRID_LAUNCHES == launches
    assert got.is_contiguous() and got.shape == (16, 16, 16, 3)
    np.testing.assert_array_equal(to_np(got).view(np.int32),
                                  to_np(_plain(grid, cfg, t, bcs)).view(np.int32))


def test_cpu_frames_keep_the_plain_grid_stage(monkeypatch):
    """An unfused and a fused CPU frame with grid BCs run without the
    kernel's wrapper; their frames still read node positions."""
    def boom(*a, **k):
        raise AssertionError("the CPU took the kernel's path")

    monkeypatch.setattr(grid_op, "grid_stage", boom)
    d = random_particles(300, seed=3)
    st = finalize_mu_lam(make_state(d["x"], d["vol"]))
    cfg = _cfg(16, grid_lim=2.0, gravity=(0.0, 0.0, -9.8), grid_v_damping_scale=0.999)
    bcs = (_collider("sticky", point=(1.0, 1.0, 0.6)), _cuboid((1.0, 1.0, 1.0), (0.2,) * 3))
    for frame in (S.simulate_substeps, S.simulate_substeps_fused):
        out = frame(st, cfg, bcs, 0.0, DT, 3)
        assert bool(torch.isfinite(out.x).all())
    assert S.frame_nodes(cfg, bcs, "cpu") is not None
    assert S.frame_nodes(cfg, (), "cpu") is None
    assert S.frame_nodes(cfg, bcs, "meta") is None


def test_grid_stage_refuses_other_devices():
    cfg = _cfg(8, **SCENE)
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="unsupported device"):
            grid_op.grid_stage(torch.zeros((8, 8, 8, 4), device=dev), cfg, DT, 0.0, ())


# -- the card: B8 against the plain version on the card -----------------------------------------

BITWISE = ["none", "scene", "tilted_sticky", "tree", "reset", "inactive", "overflow"]
CLOSE = ["slip", "frictional", "cut", "bounding_box", "moving"]


def _card_case(case, n_grid, dev):
    kw, bcs, t = _case_bcs(case, device=dev)
    cfg = _cfg(n_grid, **kw)
    return cfg, bcs, t, _grid(cfg, seed=n_grid, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n_grid", [16, 50, 120])
@pytest.mark.parametrize("case", BITWISE)
def test_grid_kernel_matches_plain_bit_for_bit(cuda_device, case, n_grid):
    """B8 through ``grid_update`` against the plain pieces on the card, on
    a grid with empty nodes and nodes of mass at or below 1e-15: every bit
    of every velocity; the input grid untouched; one launch a table."""
    cfg, bcs, t, grid = _card_case(case, n_grid, cuda_device)
    before = grid.clone()
    launches = grid_op.GRID_LAUNCHES
    got = S.grid_update(grid, cfg, np.float32(DT), t, bcs)
    tables = max(len(grid_op.bc_table(bcs, t, np.float32(DT))), 1)
    assert grid_op.GRID_LAUNCHES == launches + tables
    assert tables == (2 if case == "overflow" else 1)
    want = _plain(grid, cfg, t, bcs)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        f"{int((got.view(torch.int32) != want.view(torch.int32)).sum())} words differ"
    assert torch.equal(grid, before)


@pytest.mark.cuda
@pytest.mark.parametrize("n_grid", [16, 50, 120])
@pytest.mark.parametrize("case", CLOSE)
def test_grid_kernel_matches_plain_within_tolerance(cuda_device, case, n_grid):
    """Slip and frictional colliders (a norm PyTorch reduces in its own
    order), a cut, the bounding box and a moving cuboid: every velocity
    within 1e-6 of the largest |velocity| of the plain version."""
    cfg, bcs, t, grid = _card_case(case, n_grid, cuda_device)
    got = to_np(S.grid_update(grid, cfg, np.float32(DT), t, bcs))
    want = to_np(_plain(grid, cfg, t, bcs))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.cuda
def test_grid_launches_are_counted_with_the_tracer(cuda_device):
    """``GRID_LAUNCHES`` and, with the tracer on, ``sim.grid.launches``
    count each launch; ``sim.bc.grid_cuboids`` counts the cuboids as the
    plain path does, and no ``sim.grid_bc`` span opens on the card."""
    cfg, bcs, t, grid = _card_case("tree", 16, cuda_device)
    launches = grid_op.GRID_LAUNCHES
    with obs.tracing() as tr:
        with obs.span("sim.grid"):
            S.grid_update(grid, cfg, np.float32(DT), t, bcs)
        cfg2, over, t2, grid2 = _card_case("overflow", 16, cuda_device)
        S.grid_update(grid2, cfg2, np.float32(DT), t2, over)
    torch.cuda.synchronize()
    assert grid_op.GRID_LAUNCHES == launches + 3
    assert tr.counters["sim.grid.launches"] == 3
    assert tr.counters["sim.bc.grid_cuboids"] == 2 + grid_op.TABLE_CAPACITY + 5
    assert "sim.grid_bc" not in tr.summary()


def _frame_state(n, dev):
    d = random_particles(n, seed=8)
    st = finalize_mu_lam(make_state(d["x"], d["vol"], density=300.0, E=1e5, nu=0.35))
    st = st.replace(v=torch.as_tensor(d["v"]), C=torch.as_tensor(d["C"]))
    return st.replace(**{k: getattr(st, k).to(dev).clone() for k in vars(st)})


@pytest.mark.cuda
def test_graphed_frame_with_cuboids_matches_the_eager_frame(cuda_device, monkeypatch):
    """A card frame under a collider, a bounding box and two still cuboids
    with gravity and damping, captured and replayed (11 substeps, a re-sort
    every 3: 4 eager, 2 captures, 5 replays), against the same frame with
    every substep run eagerly: x within 1e-5, v within 1e-4 of its largest
    |value| (P2G's atomics sum in a run-dependent order); B8 ran once a
    substep."""
    monkeypatch.setattr(S, "RESORT_EVERY", 3)
    cfg = _cfg(24, grid_lim=2.0, gravity=(0.0, 0.0, -9.8), grid_v_damping_scale=0.999)
    bcs = (_collider("sticky", point=(1.0, 1.0, 0.4), device=cuda_device), tbc.BoundingBox(),
           _cuboid((1.0, 1.0, 0.3), (1.0, 1.0, 0.15), device=cuda_device),
           _cuboid((1.0, 1.0, 1.0), (0.2, 0.2, 0.2), device=cuda_device))
    n, dt = 11, np.float32(DT)
    want = S.run_frame(_frame_state(4096, cuda_device), bcs, np.float32(0.0), dt, n,
                       lambda s, b, t, r: S._substep(s, cfg, b, t, dt, None, r))
    before = (grid_op.GRID_LAUNCHES, S.GRAPH_CAPTURES, S.GRAPH_REPLAYS)
    got = S.simulate_substeps(_frame_state(4096, cuda_device), cfg, bcs, 0.0, DT, n)
    torch.cuda.synchronize()
    launches, captures, replays = (a - b for a, b in zip(
        (grid_op.GRID_LAUNCHES, S.GRAPH_CAPTURES, S.GRAPH_REPLAYS), before))
    assert (captures, replays) == (2, n - 4)
    assert launches - captures + replays == n
    np.testing.assert_allclose(to_np(got.x), to_np(want.x), rtol=0, atol=1e-5)
    w = to_np(want.v)
    np.testing.assert_allclose(to_np(got.v), w, rtol=0, atol=1e-4 * np.abs(w).max())


@pytest.mark.cuda
def test_grid_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    cfg = _cfg(16, **SCENE)
    grid = _grid(cfg, device=cuda_device)
    with pytest.raises(TypeError):
        grid_op.grid_stage(grid.double(), cfg, DT, 0.0, ())
    with pytest.raises(ValueError, match="shape"):
        grid_op.grid_stage(grid[:-1], cfg, DT, 0.0, ())
    with pytest.raises(ValueError, match="contiguous"):
        grid_op.grid_stage(grid.transpose(0, 1), cfg, DT, 0.0, ())
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(16 ** 3 * 4 + 1, device=cuda_device)
        grid_op.grid_stage(flat[1:].view(16, 16, 16, 4), cfg, DT, 0.0, ())
