"""Multi-card MPM: particle-sharded and x-slab halo-sharded frames
(port of pixie_tpu/sim/solver_dist.py).

One process a card (or several processes sharing one card over gloo), in
a ``torch.distributed`` group.  Two decompositions, as in the JAX package:

  * **all-reduce** (``shard_particles``, ``simulate_substeps_sharded``,
    ``rollout_fast_sharded``): the particles are split into contiguous
    blocks, one a rank; each rank splats its block into a dense (G,G,G,4)
    grid (B1), the grids are summed with one ``all_reduce`` a substep, and
    every rank runs the grid update and gathers its particles' velocities
    from the whole grid (B2).  JAX's ``simulate_substeps_fast_sharded`` runs
    the same substep over its tile layout; here both are one frame;
  * **x-slab halo** (``build_halo_layout``, ``simulate_substeps_halo_sharded``,
    ``rollout_halo_sharded``): rank d owns the x-tiles [d nx, (d+1) nx) of
    TILE = 12 cells (JAX's tile, pixie_tpu/ops/tiling.py:38) and the
    particles whose base cell lies in them at the frame's start.  It splats
    into a full-size dense grid, sends the neighbours the planes they own
    (``HALO_LEFT`` plane left, ``HALO_RIGHT`` planes right), updates its own
    planes only, and sends back the velocity planes its neighbours' G2P
    reads: four band messages a substep whatever the world size, never the
    whole grid (at G = 120: ~1.6 MB a middle rank, against 27.6 MB
    all-reduced).

Each rank keeps the unfused frame's cell order (``solver.run_frame``): its
state is permuted into B1's order at substep 0 and every RESORT_EVERY, the
particle BCs' masks with it, and returns in the caller's order.

The JAX package's tile-layout helpers (``pad_layout_for_mesh``,
``pad_particle_bcs_for_layout``, ``_bc_specs``, ``_shard_padded_bcs``,
``_soa_spec``) have no counterpart: the port has no tile layout.

Numerics: the ranks' splats and the all-reduce sum float32 in another order
than one process; frames agree to ~1e-6 in x (tests/test_torch_solver_dist.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from pixie_tpu_torch.ops import constitutive, transfer
from pixie_tpu_torch.parallel.mesh import exchange
from pixie_tpu_torch.sim import bc as bc_mod
from pixie_tpu_torch.sim.solver import (
    _substep, g2p, grid_momentum_to_velocity, apply_grid_bcs, grid_update, frame_nodes,
    node_positions, permute_state, run_frame,
)
from pixie_tpu_torch.sim.types import MPMConfig, MPMState

TILE = 12          # cells a tile edge (pixie_tpu/ops/tiling.py:38)
# The halo band.  JAX's tile window spans WIN = TILE + 4 nodes
# (pixie_tpu/ops/tiling.py:39): one node before the tile and three after it,
# which the quadratic stencil of a base cell that drifted one cell either
# way reaches.  A particle that drifts further within a frame has its
# window-relative base clipped to the window (ops/transfer.py:81-82,
# solver_fast.py:116): it splats and gathers at the edge with its own
# weights.  The slab's band is that window at the slab's faces: a rank
# sends HALO_LEFT plane to its left neighbour and HALO_RIGHT planes to its
# right one, and clamps its particles' base cells to [lo - 1, hi] at a face
# with a neighbour, as JAX clips at the slab's edge tiles.
HALO_LEFT = 1
HALO_RIGHT = 3


def _group_info(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def _fields(state: MPMState) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def _masked_bcs(bcs, take) -> tuple:
    """The particle BCs with ``take(mask)`` as their masks."""
    return tuple(dataclasses.replace(b, mask=take(b.mask))
                 if isinstance(b, bc_mod.PARTICLE_BC_TYPES) else b for b in bcs)


# -- the all-reduce path ---------------------------------------------------------------

def shard_particles(state: MPMState, bcs=None, group=None):
    """This rank's block of the particles (solver_dist.py:46-95): N is
    padded to a multiple of the world size with rows of ``selection = 1``
    and ``x = 1.0`` (inert and inside the grid), and rank r takes rows
    [r N/W, (r+1) N/W).  With ``bcs`` the particle BCs' masks are
    zero-padded and cut the same way, and ``(state, bcs)`` is returned."""
    world, r = _group_info(group)
    n = state.n_particles
    pad = (-n) % world
    per = (n + pad) // world
    rows = slice(r * per, (r + 1) * per)

    def cut(t):
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        return t[rows].clone()

    local = {k: cut(t) for k, t in _fields(state).items()}
    first_pad = max(n - r * per, 0)     # this block's first padded row
    local["selection"][first_pad:] = 1
    local["x"][first_pad:] = 1.0
    local = state.replace(**local)
    return local if bcs is None else (local, _masked_bcs(bcs, cut))


def simulate_substeps_sharded(state: MPMState, cfg: MPMConfig, bcs, time0, dt,
                              n_substeps: int, group=None) -> MPMState:
    """A frame on this rank's particles (``shard_particles``) with one
    ``all_reduce`` of the (G,G,G,4) grid a substep (solver_dist.py:97-137):
    the particle BCs, the stress, P2G (B1), the all-reduce, the grid update
    on every rank, G2P (B2).  Returns this rank's rows in their order."""
    time0, dt = np.float32(time0), np.float32(dt)
    node_x = frame_nodes(cfg, bcs, state.device)

    def stage(grid, t):
        dist.all_reduce(grid, group=group)
        return grid_update(grid, cfg, dt, t, bcs, node_x)

    return run_frame(state, bcs, time0, dt, n_substeps,
                     lambda st, b, t, resort: _substep(st, cfg, b, t, dt, node_x, resort,
                                                       grid_stage=stage))


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal blocks of rows, concatenated in rank order on every
    rank (an all_reduce of a zero buffer: the one collective every backend
    has for CUDA tensors)."""
    world, r = _group_info(group)
    per = t.shape[0]
    buf = t.new_zeros((world * per,) + tuple(t.shape[1:]))
    buf[r * per:(r + 1) * per] = t
    dist.all_reduce(buf, group=group)
    return buf


def rollout_fast_sharded(state: MPMState, cfg: MPMConfig, bcs=(), n_substeps: int = 8,
                         dt: float = 1e-4, time0: float = 0.0, group=None) -> MPMState:
    """One frame of the caller's whole state (the same on every rank) on
    the all-reduce path: shard, run, gather the rows back on every rank in
    the caller's order without the padding (JAX's ``unpad_state``).  The
    port's counterpart of JAX's Pallas variant (solver_dist.py:290-338),
    which runs the same kernels here."""
    n = state.n_particles
    local, lbcs = shard_particles(state, tuple(bcs), group)
    out = simulate_substeps_sharded(local, cfg, lbcs, time0, dt, n_substeps, group)
    return state.replace(**{k: _gather_rows(t, group)[:n] for k, t in _fields(out).items()})


# -- the x-slab halo path --------------------------------------------------------------

def n_tiles(n_grid: int) -> int:
    return -(-n_grid // TILE)


def build_halo_layout(x: np.ndarray, n_grid: int, inv_dx: float, n_dev: int) -> dict:
    """Which rows each rank owns (solver_dist.py:341-418): rank d takes the
    particles whose base cell's x-tile is in [d nx, (d+1) nx), in the
    caller's order, padded to a common count ``n_local``.

    ``perm`` (n_dev, n_local) holds the caller's row of each slot (0 in a
    padded slot), ``occupied`` (n_dev, n_local) which slots are real.
    Raises unless ``n_tiles(n_grid)`` is a multiple of ``n_dev``."""
    t = n_tiles(n_grid)
    if t % n_dev:
        raise ValueError(f"halo sharding needs n_tiles={t} divisible by n_dev={n_dev}")
    nx = t // n_dev
    x = np.asarray(x, np.float32)
    base = np.floor(x[:, 0] * np.float32(inv_dx) - np.float32(0.5)).astype(np.int64)
    dev = np.clip(base // TILE, 0, t - 1) // nx
    rows = [np.nonzero(dev == d)[0] for d in range(n_dev)]
    n_local = max(max(len(r) for r in rows), 1)
    perm = np.zeros((n_dev, n_local), np.int64)
    occupied = np.zeros((n_dev, n_local), bool)
    for d, r in enumerate(rows):
        perm[d, :len(r)] = r
        occupied[d, :len(r)] = True
    return {"perm": perm, "occupied": occupied, "nx": nx, "n_local": n_local}


@dataclasses.dataclass(frozen=True)
class _Slab:
    """Rank d's x planes [lo, hi) of the grid and its neighbours' global
    ranks (None at the grid's faces)."""

    lo: int
    hi: int
    left: int | None
    right: int | None
    n_grid: int

    @classmethod
    def of(cls, n_grid: int, nx: int, group) -> "_Slab":
        world, d = _group_info(group)
        peer = (lambda i: dist.get_global_rank(group, i)) if group is not None else (lambda i: i)
        return cls(d * nx * TILE, min((d + 1) * nx * TILE, n_grid),
                   peer(d - 1) if d > 0 else None, peer(d + 1) if d < world - 1 else None,
                   n_grid)

    def right_band(self, hi: int) -> slice:
        """The planes after ``hi`` that a rank whose slab ends there splats
        into and reads (cut at the grid's face)."""
        return slice(hi, min(hi + HALO_RIGHT, self.n_grid))

    def bytes_a_substep(self) -> int:
        """The bytes this rank sends a substep, float32: its P2G bands (4
        channels) and the velocity bands its neighbours read (3 channels)."""
        planes = 0
        if self.left is not None:
            band = self.right_band(self.lo)
            planes += HALO_LEFT * 4 + (band.stop - band.start) * 3
        if self.right is not None:
            band = self.right_band(self.hi)
            planes += (band.stop - band.start) * 4 + HALO_LEFT * 3
        return planes * self.n_grid * self.n_grid * 4


def halo_bytes_a_substep(n_grid: int, nx: int, group=None) -> int:
    """The bytes this rank sends a substep on the halo path."""
    return _Slab.of(n_grid, nx, group).bytes_a_substep()


def _stencil_x(x: torch.Tensor, slab: _Slab, cfg: MPMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions whose base cell is clamped into the band at the slab's
    faces with a neighbour (``HALO_LEFT``), shifted by whole cells so that
    the spline weights stay the particle's own, and which rows moved.
    Rounding can leave a shifted base one cell off near a cell boundary;
    a few one-ulp steps put it back."""
    lo_b = slab.lo - HALO_LEFT if slab.left is not None else None
    hi_b = slab.hi if slab.right is not None else None
    if lo_b is None and hi_b is None:
        return x, torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    inv_dx = cfg.inv_dx

    def base(px):     # as B1/B2 compute it: x * inv_dx rounded, then - 0.5
        return torch.floor(px * inv_dx - 0.5)

    px = x[:, 0]
    b = base(px)
    target = torch.clamp(b, min=lo_b, max=hi_b)
    moved = target != b
    px = torch.where(moved, px + (target - b) * cfg.dx, px)
    for _ in range(4):
        bs = base(px)
        px = torch.where(moved & (bs < target), torch.nextafter(px, px + 1.0), px)
        px = torch.where(moved & (bs > target), torch.nextafter(px, px - 1.0), px)
    return torch.cat([px[:, None], x[:, 1:]], 1), moved


def _halo_grid_stage(grid: torch.Tensor, slab: _Slab, cfg: MPMConfig, dt, time, bcs,
                     node_x_own, group) -> torch.Tensor:
    """The rank's dense P2G grid -> the dense velocity grid G2P reads: add
    the neighbours' bands to the own planes, update the own planes, then
    fill the band planes with the neighbours' velocities."""
    lo, hi = slab.lo, slab.hi
    sends, recvs = [], []
    from_left = from_right = None
    if slab.left is not None:
        sends.append((grid[lo - HALO_LEFT:lo], slab.left))
        from_left = torch.empty_like(grid[slab.right_band(lo)])
        recvs.append((from_left, slab.left))
    if slab.right is not None:
        sends.append((grid[slab.right_band(hi)], slab.right))
        from_right = torch.empty_like(grid[hi - HALO_LEFT:hi])
        recvs.append((from_right, slab.right))
    exchange(sends, recvs, group)
    own = grid[lo:hi]
    if from_left is not None:
        own[:from_left.shape[0]] += from_left
    if from_right is not None:
        own[own.shape[0] - HALO_LEFT:] += from_right
    v_own = grid_momentum_to_velocity(own, cfg, dt)
    if node_x_own is not None:
        v_own = apply_grid_bcs(v_own, node_x_own, cfg, dt, time, bcs)
    grid_v = grid.new_zeros(grid.shape[:3] + (3,))
    grid_v[lo:hi] = v_own
    sends, recvs = [], []
    if slab.left is not None:
        sends.append((grid_v[slab.right_band(lo)], slab.left))
        recvs.append((grid_v[lo - HALO_LEFT:lo], slab.left))
    if slab.right is not None:
        sends.append((grid_v[hi - HALO_LEFT:hi], slab.right))
        recvs.append((grid_v[slab.right_band(hi)], slab.right))
    exchange(sends, recvs, group)
    return grid_v


def _halo_substep(state: MPMState, cfg: MPMConfig, bcs, time, dt, slab: _Slab, node_x_own,
                  resort: bool, group):
    """One substep on the rank's particles (the halo path's p2g2p): as
    ``solver._substep``, with the stencil's base clamped into the band
    (``_stencil_x``) for P2G and G2P, and the halo grid stage."""
    for b in bcs:
        if isinstance(b, bc_mod.PARTICLE_BC_TYPES):
            state = b.apply(time, dt, state)
    state = constitutive.constitutive_pass(state, cfg, dt)
    active = state.selection == 0
    xs, moved = _stencil_x(state.x, slab, cfg)
    grid, order = transfer.p2g(xs, state.v, state.C, state.stress, state.mass, state.vol,
                               active, cfg, dt, return_order=True)
    grid_v = _halo_grid_stage(grid, slab, cfg, dt, time, bcs, node_x_own, group)
    order = order if resort else None
    if order is not None:
        state, xs, moved, active = (permute_state(state, order), xs[order], moved[order],
                                    active[order])
    x0 = state.x
    state = g2p(state.replace(x=xs.contiguous()), grid_v, cfg, dt)
    # a shifted particle advects from its own position
    x_new = torch.where(moved[:, None], x0 + float(dt) * state.v * active[:, None], state.x)
    return state.replace(x=x_new), order


def simulate_substeps_halo_sharded(state: MPMState, cfg: MPMConfig, bcs, time0, dt,
                                   n_substeps: int, nx: int, group=None) -> MPMState:
    """A frame on this rank's particles of the x-slab layout
    (``build_halo_layout``; solver_dist.py:421-468): the rank owns the
    x-tiles [r nx, (r+1) nx) of the grid, and four band messages a substep
    replace the all-reduce.  Returns this rank's rows in their order."""
    time0, dt = np.float32(time0), np.float32(dt)
    slab = _Slab.of(cfg.n_grid, nx, group)
    node_x_own = (node_positions(cfg, state.device)[slab.lo:slab.hi] if any(
        isinstance(b, bc_mod.GRID_BC_TYPES) for b in bcs) else None)
    return run_frame(state, bcs, time0, dt, n_substeps,
                     lambda st, b, t, resort: _halo_substep(st, cfg, b, t, dt, slab, node_x_own,
                                                            resort, group))


def rollout_halo_sharded(state: MPMState, cfg: MPMConfig, bcs=(), n_substeps: int = 8,
                         dt: float = 1e-4, time0: float = 0.0, group=None) -> MPMState:
    """One frame of the caller's whole state (the same on every rank) on
    the x-slab halo path: the layout from the frame's start, this rank's
    rows (padding inert, BC masks taken with the rows), the frame, and the
    rows gathered back on every rank in the caller's order
    (solver_dist.py:471-504)."""
    world, d = _group_info(group)
    lay = build_halo_layout(state.x.cpu().numpy(), cfg.n_grid, cfg.inv_dx, world)
    dev = state.device
    rows = torch.as_tensor(lay["perm"][d], device=dev)
    occ = torch.as_tensor(lay["occupied"][d], device=dev)
    local = permute_state(state, rows)
    local = local.replace(selection=torch.where(occ, local.selection, 1).to(torch.int32))
    lbcs = _masked_bcs(tuple(bcs), lambda m: m[rows.to(m.device)] & occ.to(m.device))
    out = simulate_substeps_halo_sharded(local, cfg, lbcs, time0, dt, n_substeps, lay["nx"],
                                         group)
    perm = torch.as_tensor(lay["perm"].reshape(-1), device=dev)
    keep = torch.as_tensor(lay["occupied"].reshape(-1), device=dev)
    back = {}
    for k, t in _fields(out).items():
        full = _gather_rows(t, group)
        res = getattr(state, k).clone()
        res[perm[keep]] = full[keep]
        back[k] = res
    return state.replace(**back)
