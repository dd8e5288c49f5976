"""MLS-MPM solver: explicit APIC/RPIC substep with quadratic B-splines
(port of pixie_tpu/sim/solver.py; reference mpm_solver_warp.py:514-637).

One solver for every device.  Its transfers go through
``pixie_tpu_torch.ops.transfer`` and its constitutive pass through
``pixie_tpu_torch.ops.constitutive``, which launch the CUDA kernels on CUDA
tensors and run their plain versions on CPU tensors.  With ``fused``
(``PIXIE_FUSED=1``, default off as in JAX) a frame that no particle BC
touches runs ``simulate_substeps_fused``: one ``ops.fused_substep`` launch
per substep, G2P through the next P2G.  An unfused frame on the card
captures its substep as a CUDA graph and replays it between re-sorts
(``simulate_substeps``, ``frame_plan``).  The JAX
package's tile-sorted fast path (solver_fast.py, ops/tiling.py, sim/soa.py,
constitutive_soa.py) is the TPU's layout of the same math and has no
counterpart here: ``run_simulation(use_fast_solver=...)`` routes both values
to this solver.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from pixie_tpu_torch.ops import constitutive
from pixie_tpu_torch.ops import fused_substep as fs
from pixie_tpu_torch.ops import grid as grid_op
from pixie_tpu_torch.ops import transfer
from pixie_tpu_torch.sim import bc as bc_mod
from pixie_tpu_torch.sim.svd3 import matmul_nt, svd3
from pixie_tpu_torch.sim.types import (
    MPMConfig, MPMState, finalize_mu_lam, get_material_id, make_state,
)
from pixie_tpu_torch.utils import observability as obs


def grid_momentum_to_velocity(grid, cfg: MPMConfig, dt) -> torch.Tensor:
    """Momentum -> velocity + gravity + damping (mpm_utils.py:398-409, 583-588)."""
    m = grid[..., 3]
    v = grid[..., :3] / torch.clamp(m, min=1e-15)[..., None]
    # + dt * gravity, as float32 host scalars (no host-to-device copy per
    # substep); a zero component adds nothing, so it is skipped
    dtg = np.float32(dt) * np.asarray(cfg.gravity, np.float32)
    if dtg.any():
        v = torch.stack([v[..., a] + float(dtg[a]) for a in range(3)], -1)
    v_out = torch.where((m > 1e-15)[..., None], v, 0.0)
    if cfg.grid_v_damping_scale < 1.0:
        v_out = v_out * cfg.grid_v_damping_scale
    return v_out


def node_positions(cfg: MPMConfig, device) -> torch.Tensor:
    """(G,G,G,3) node coordinates i * dx."""
    idx = torch.arange(cfg.n_grid, dtype=torch.float32, device=device) * cfg.dx
    return torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), dim=-1)


def frame_nodes(cfg: MPMConfig, bcs, device) -> torch.Tensor | None:
    """The node positions a frame's plain grid stage reads: on the CPU
    where a grid BC is given, else None (the card's kernel computes them)."""
    if torch.device(device).type != "cpu" or not any(
            isinstance(b, bc_mod.GRID_BC_TYPES) for b in bcs):
        return None
    return node_positions(cfg, device)


def apply_grid_bcs(v_out, node_x, cfg: MPMConfig, dt, time, bcs: Sequence):
    """Grid BCs in insertion order (mpm_solver_warp.py:604-621), the plain
    version.  While a tracer is on, a call that applies a cuboid BC (the
    material field's ground and stationary cuboids) is the span
    ``sim.grid_bc`` and adds its cuboids to the counter
    ``sim.bc.grid_cuboids``."""
    cuboids = obs.enabled() and sum(isinstance(b, bc_mod.CuboidVelocity) for b in bcs)
    if not cuboids:
        return _apply_grid_bcs(v_out, node_x, cfg, dt, time, bcs)
    obs.count("sim.bc.grid_cuboids", cuboids)
    with obs.span("sim.grid_bc"):
        return _apply_grid_bcs(v_out, node_x, cfg, dt, time, bcs)


def _apply_grid_bcs(v_out, node_x, cfg: MPMConfig, dt, time, bcs: Sequence):
    for b in bcs:
        if isinstance(b, bc_mod.GRID_BC_TYPES):
            v_out = b.apply(time, dt, v_out, node_x, cfg)
    return v_out


def grid_update(grid, cfg: MPMConfig, dt, time, bcs: Sequence,
                node_x: torch.Tensor | None = None) -> torch.Tensor:
    """Momentum -> velocity, gravity, damping, grid BCs.  On the card one
    launch of ``ops.grid``'s kernel (B8), which reads no ``node_x``; on the
    CPU the plain pieces, where the BCs are the span ``sim.grid_bc``.  While
    a tracer is on, both count the cuboid BCs in ``sim.bc.grid_cuboids``."""
    if grid.device.type != "cpu":
        cuboids = obs.enabled() and sum(isinstance(b, bc_mod.CuboidVelocity) for b in bcs)
        if cuboids:
            obs.count("sim.bc.grid_cuboids", cuboids)
        return grid_op.grid_stage(grid, cfg, dt, time, bcs)
    v_out = grid_momentum_to_velocity(grid, cfg, dt)
    if any(isinstance(b, bc_mod.GRID_BC_TYPES) for b in bcs):
        if node_x is None:
            node_x = node_positions(cfg, grid.device)
        v_out = apply_grid_bcs(v_out, node_x, cfg, dt, time, bcs)
    return v_out.contiguous()


def p2g(state: MPMState, cfg: MPMConfig, dt) -> torch.Tensor:
    return transfer.p2g(state.x, state.v, state.C, state.stress, state.mass,
                        state.vol, state.selection == 0, cfg, dt)


def g2p(state: MPMState, grid_v, cfg: MPMConfig, dt) -> MPMState:
    return transfer.g2p(state, grid_v, cfg, dt)


def p2g2p(state: MPMState, cfg: MPMConfig, bcs, time, dt,
          node_x: torch.Tensor | None = None) -> MPMState:
    """One explicit MPM substep (p2g2p, mpm_solver_warp.py:514-637).

    ``time`` and ``dt`` are float32 scalars (host side)."""
    return _substep(state, cfg, bcs, time, dt, node_x, False)[0]


def _substep(state: MPMState, cfg: MPMConfig, bcs, time, dt, node_x, resort: bool,
             grid_stage=None, out=None):
    """p2g2p; with ``resort``, the state is permuted into P2G's cell order
    between P2G and G2P where P2G returns one (on the card).  Returns the
    state and that order (None if the state kept its order).
    ``grid_stage(grid, time) -> grid_v`` replaces ``grid_update`` (the
    sharded frames of solver_dist.py sum the ranks' grids first); ``out``
    is the constitutive pass's (the tensors it writes F, stress, mu, lam
    and yield_stress into).  Each stage is a span of
    ``utils.observability``."""
    with obs.span("sim.particle_bc"):
        for b in bcs:
            if isinstance(b, bc_mod.PARTICLE_BC_TYPES):
                state = b.apply(time, dt, state)
    with obs.span("sim.constitutive"):
        state = (constitutive.constitutive_pass(state, cfg, dt) if out is None
                 else constitutive.constitutive_pass(state, cfg, dt, out=out))
    with obs.span("sim.p2g"):
        grid, order = transfer.p2g(state.x, state.v, state.C, state.stress, state.mass,
                                   state.vol, state.selection == 0, cfg, dt, return_order=True)
    with obs.span("sim.grid"):
        grid_v = (grid_update(grid, cfg, dt, time, bcs, node_x) if grid_stage is None
                  else grid_stage(grid, time))
    order = order if resort else None
    if order is not None:
        with obs.span("sim.resort"):
            state = permute_state(state, order)
    with obs.span("sim.g2p"):
        state = g2p(state, grid_v, cfg, dt)
    return state, order


# substeps between two cell sorts of a frame's particles: their runs of
# same-cell lanes shorten as they drift from the order of the last sort (on
# chip_smoke.py's 100k-particle state, NVIDIA H100 80GB HBM3, the mean run
# length of a kept order fell from 5.13 at substep 1 to 4.40 at 100 and
# 2.24 at 399; PERF.md)
RESORT_EVERY = 100
# fused substeps between two samples of the splat's run length while a
# tracer is on; RESORT_EVERY is a multiple of it, so the first substep after
# each re-sort is sampled
RUN_LENGTH_EVERY = 10
# CUDA graphs of the unfused substep captured, and replays of them (a
# capture is replayed at once, so the replays count every substep a graph
# ran); the wrappers' launch counters count the captures' calls only
GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0


def permute_state(state: MPMState, idx: torch.Tensor) -> MPMState:
    """Every per-particle array of ``state`` taken at ``idx`` (on the
    array's own device)."""
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    return state.replace(**{k: t[idx.to(t.device)] for k, t in fields.items()})


def _permute_bcs(bcs, idx: torch.Tensor) -> tuple:
    """The particle BCs with their (N,) masks taken at ``idx``, so that
    each still selects its particles in a state permuted by ``idx``."""
    return tuple(dataclasses.replace(b, mask=b.mask[idx.to(b.mask.device)])
                 if isinstance(b, bc_mod.PARTICLE_BC_TYPES) else b for b in bcs)


def _caller_order(state: MPMState, order: torch.Tensor) -> MPMState:
    """``state``, whose particle i is the caller's particle order[i], back
    in the caller's order."""
    back = torch.empty_like(order)
    back[order] = torch.arange(order.shape[0], device=order.device)
    return permute_state(state, back)


def simulate_substeps(state: MPMState, cfg: MPMConfig, bcs, time0, dt,
                      n_substeps: int) -> MPMState:
    """n_substeps substeps; the substep time is f32(time0) + f32(step) * f32(dt)
    as in the JAX scan (pixie_tpu/sim/solver.py:291).

    On the card the frame runs on its state sorted by cell, so the lanes of
    one cell sit side by side in G2P's warps and gather the same nodes: the
    state is permuted into P2G's order between P2G and G2P of substep 0 and
    again every RESORT_EVERY substeps, the particle BCs' masks with it, and
    the returned state is back in the caller's order.  Between re-sorts the
    card replays the substep as a CUDA graph captured in the frame, where
    ``frame_plan`` allows (``_GraphedSubsteps``): the same kernels on the
    same inputs, launched by one call.  On the CPU P2G returns no order and
    the state keeps its order, and every substep runs eagerly."""
    time0, dt = np.float32(time0), np.float32(dt)
    node_x = frame_nodes(cfg, bcs, state.device)
    if state.device.type == "cuda":
        substep = _GraphedSubsteps(cfg, dt, node_x, frame_plan(bcs, time0, dt, n_substeps))
    else:
        def substep(st, b, t, resort):
            return _substep(st, cfg, b, t, dt, node_x, resort)
    return run_frame(state, bcs, time0, dt, n_substeps, substep)


def _resorts(step: int) -> bool:
    """Whether a frame re-sorts its particles at substep ``step``."""
    return step % RESORT_EVERY == 0


def run_frame(state: MPMState, bcs, time0, dt, n_substeps: int, substep) -> MPMState:
    """The frame loop of ``simulate_substeps`` and ``simulate_substeps_fused``:
    ``substep(state, bcs, t, resort) -> (state, order)`` at t = f32(time0) +
    f32(step) * f32(dt), with ``resort`` at substep 0 and every
    RESORT_EVERY; the particle BCs' masks follow each order, and the state
    returns in the caller's order.  The frame is the span ``sim.frame``."""
    frame = None     # the state's particle i is the caller's particle frame[i]
    with obs.span("sim.frame"):
        for step in range(n_substeps):
            t = np.float32(time0 + np.float32(step) * dt)
            state, order = substep(state, bcs, t, _resorts(step))
            if order is not None:
                bcs = _permute_bcs(bcs, order)
                frame = order if frame is None else frame[order]
        return state if frame is None else _caller_order(state, frame)


def frame_plan(bcs, time0, dt, n_substeps: int) -> tuple[str, ...]:
    """How a card frame runs each substep: "eager" (``_substep`` itself),
    "capture" (a CUDA graph of ``_substep`` captured, then replayed) or
    "replay" (a graph replayed).  A substep runs eagerly where it re-sorts
    (every RESORT_EVERY), where a particle BC is active, where a BC's
    ``host_key`` is None, or where its BCs' keys differ from those of the
    frame's first capture, which a graph has baked in; of the others, the
    first two capture the frame's two graphs and the rest replay them."""
    time0, dt = np.float32(time0), np.float32(dt)
    plan, captured, captures = [], None, 0
    for step in range(n_substeps):
        t = np.float32(time0 + np.float32(step) * dt)
        keys = tuple(b.host_key(t, dt) for b in bcs)
        if (_resorts(step) or None in keys
                or any(k for b, k in zip(bcs, keys) if isinstance(b, bc_mod.PARTICLE_BC_TYPES))
                or (captured is not None and keys != captured)):
            plan.append("eager")
        elif captures < 2:
            captured, captures = keys, captures + 1
            plan.append("capture")
        else:
            plan.append("replay")
    return tuple(plan)


class _GraphedSubsteps:
    """``run_frame``'s substep in a card frame, run as ``frame_plan`` says.

    The first capture takes the frame's state as the graphs' static
    buffers.  The constitutive pass writes its outputs into the other of
    two sets of them, so graph 0 reads set 0 and writes set 1, graph 1
    reads set 1 and writes set 0, and no replay copies; B2 writes x, v, C,
    F_trial and cov in place.  The graphs' own tensors (the grid, the
    sort's buffers) live in one pool for every frame (``_CAPTURE``).  An
    eager substep after the first capture copies what it returns in new
    tensors (a re-sort's permuted state, the constitutive outputs) back
    into the buffers.  Each capture goes through the module's ``_substep``
    as it is then, and the graphs live as long as the frame.  While a
    tracer is on, the stage spans are recorded at a capture and on eager
    substeps, each replay is the span ``sim.graph``, and
    ``sim.graph.captures`` / ``sim.graph.replays`` count as
    ``GRAPH_CAPTURES`` / ``GRAPH_REPLAYS`` do."""

    def __init__(self, cfg: MPMConfig, dt, node_x, plan):
        self.cfg, self.dt, self.node_x, self.plan = cfg, dt, node_x, iter(plan)
        self.graphs: list = []
        self.states: list = []     # the static state with output set 0, set 1
        self.p = 0                 # the set the state is in

    def __call__(self, state: MPMState, bcs, t, resort: bool):
        global GRAPH_REPLAYS
        how = next(self.plan)
        if how == "eager":
            out, order = _substep(state, self.cfg, bcs, t, self.dt, self.node_x, resort)
            return (_copy_into(state, out) if self.states else out), order
        if how == "capture":
            self._capture(state, bcs, t)
        with obs.span("sim.graph"):
            self.graphs[self.p].replay()
        GRAPH_REPLAYS += 1
        obs.count("sim.graph.replays", 1)
        self.p ^= 1
        return self.states[self.p], None

    def _capture(self, state: MPMState, bcs, t) -> None:
        global GRAPH_CAPTURES
        if not self.states:
            spare = {k: torch.empty_like(getattr(state, k)) for k in constitutive.OUTPUTS}
            self.states = [state, state.replace(**spare)]
        src, dst = self.states[self.p], self.states[self.p ^ 1]
        dev = state.device
        side, keeper = _CAPTURE.get(dev) or (torch.cuda.Stream(dev), None)
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            graph.capture_begin(pool=None if keeper is None else keeper.pool(),
                                capture_error_mode="thread_local")
            try:
                out, _ = _substep(src, self.cfg, bcs, t, self.dt, self.node_x, False,
                                  out={k: getattr(dst, k) for k in constitutive.OUTPUTS})
                # nothing as shipped; a field that a patched _substep hands
                # back in another tensor is copied into the buffers
                _copy_into(dst, out)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graphs.append(graph)
        _CAPTURE[dev] = side, graph
        GRAPH_CAPTURES += 1
        obs.count("sim.graph.captures", 1)


def _copy_into(state: MPMState, new: MPMState) -> MPMState:
    """``state`` with every field that ``new`` holds in another tensor
    copied in; returns ``state``."""
    for f in dataclasses.fields(state):
        t = getattr(new, f.name)
        if t is not getattr(state, f.name):
            getattr(state, f.name).copy_(t)
    return state


# by device: the stream the unfused frames capture on, and the newest of
# their graphs, which keeps the graphs' memory pool alive from one frame to
# the next.  The caching allocator hands a pool's freed blocks only to the
# stream that freed them, and PyTorch drops a pool that no graph holds (its
# id cannot be captured into again), so with both kept each frame's
# captures reuse the blocks of the last frame's
_CAPTURE: dict = {}


def simulate_substeps_fused(state: MPMState, cfg: MPMConfig, bcs, time0, dt,
                            n_substeps: int) -> MPMState:
    """A frame of n_substeps with the substep boundary rotated
    (pixie_tpu/sim/solver_fast.py:501-590): stress(0) + P2G(0), then per
    substep s < S-1 the grid stage at t_s and one fused G2P(s) -> stress(s+1)
    -> P2G(s+1), then the grid stage at t_{S-1} and G2P.  The same operations
    as ``simulate_substeps`` for a frame without particle BCs, which the
    caller must drop (they would apply between advect and stress).

    On the card the frame runs on the state sorted by cell (the prologue
    P2G's order, renewed every RESORT_EVERY substeps), so the fused kernel's
    splat sums long runs of same-cell lanes; the returned state is back in
    the caller's order.  On the CPU the state keeps its order and is written
    in place.

    The frame is the span ``sim.frame``, its stages spans inside it.  While
    a tracer is on, the splat's run length (``fs.run_counts``) is counted
    before every RUN_LENGTH_EVERY-th B6 launch, in a span of its own."""
    assert not any(isinstance(b, bc_mod.PARTICLE_BC_TYPES) for b in bcs), \
        "the fused frame takes no particle BCs (use simulate_substeps)"
    time0, dt = np.float32(time0), np.float32(dt)
    node_x = frame_nodes(cfg, bcs, state.device)
    return run_frame(state, bcs, time0, dt, n_substeps,
                     _FusedSubsteps(cfg, dt, node_x, n_substeps))


class _FusedSubsteps:
    """``run_frame``'s substep in a fused frame.  Call k runs, at t_k: on
    call 0 the prologue (stress(0) + P2G(0), the state and its active mask
    permuted into P2G's cell order where it returns one); the grid stage;
    where ``resort`` is set and 0 < k < S-1, a fresh cell sort; then one
    fused substep, or on call S-1 G2P.  Returns the state and the order it
    was permuted by (None if it kept its order).  The stages go through
    their modules at call time."""

    def __init__(self, cfg: MPMConfig, dt, node_x, n_substeps: int):
        self.cfg, self.dt, self.node_x, self.last = cfg, dt, node_x, n_substeps - 1
        self.k = 0
        self.grid = self.active = None
        self.sorted = False    # the prologue's P2G returned a cell order (on the card)

    def __call__(self, state: MPMState, bcs, t, resort: bool):
        cfg, dt, k = self.cfg, self.dt, self.k
        self.k += 1
        order = None
        if k == 0:
            state, order = self._prologue(state)
        with obs.span("sim.grid"):
            grid_v = grid_update(self.grid, cfg, dt, t, bcs, self.node_x)
        if k == self.last:
            with obs.span("sim.g2p"):
                return g2p(state, grid_v, cfg, dt), order
        if resort and k and self.sorted:
            with obs.span("sim.resort"):
                order = transfer.cell_order(state.x, self.active, cfg)
                state, self.active = permute_state(state, order), self.active[order]
        if k % RUN_LENGTH_EVERY == 0 and obs.enabled():
            with obs.span("sim.run_length"):
                live, runs = fs.run_counts(state.x, self.active, cfg)
                obs.count("fused.live_lanes", live)
                obs.count("fused.runs", runs)
        with obs.span("sim.fused"):
            self.grid = fs.fused_substep(state, grid_v, cfg, dt, self.active)
        return state, order

    def _prologue(self, state: MPMState):
        cfg, dt = self.cfg, self.dt
        with obs.span("sim.constitutive"):
            state = constitutive.constitutive_pass(state, cfg, dt)
        self.active = state.selection == 0
        with obs.span("sim.p2g"):
            self.grid, order = transfer.p2g(state.x, state.v, state.C, state.stress, state.mass,
                                            state.vol, self.active, cfg, dt, return_order=True)
        if order is not None:
            self.sorted = True
            with obs.span("sim.resort"):
                state, self.active = permute_state(state, order), self.active[order]
        return state, order


def _unpack_cov(c):
    return torch.stack([torch.stack([c[:, 0], c[:, 1], c[:, 2]], -1),
                        torch.stack([c[:, 1], c[:, 3], c[:, 4]], -1),
                        torch.stack([c[:, 2], c[:, 4], c[:, 5]], -1)], -2)


def _pack_cov(m):
    return torch.stack([m[:, 0, 0], m[:, 0, 1], m[:, 0, 2],
                        m[:, 1, 1], m[:, 1, 2], m[:, 2, 2]], -1)


def compute_cov_from_F(state: MPMState) -> torch.Tensor:
    """cov = F_trial init_cov F_trial^T (mpm_utils.py:529-553)."""
    f = state.F_trial
    return _pack_cov(matmul_nt(f @ _unpack_cov(state.init_cov), f))


def compute_R_from_F(state: MPMState) -> torch.Tensor:
    """Polar rotation, transposed as the reference stores particle_R
    (mpm_utils.py:556-580)."""
    u, _, v = svd3(state.F_trial)
    return matmul_nt(u, v).transpose(-1, -2)


def apply_additional_params(state: MPMState, params: dict) -> MPMState:
    """Box-region material override (mpm_utils.py:591-610)."""
    dev = state.device
    point = torch.as_tensor(np.asarray(params["point"], np.float32), device=dev)
    size = torch.as_tensor(np.asarray(params["size"], np.float32), device=dev)
    inside = torch.all((state.x > point - size) & (state.x < point + size), dim=-1)
    mat = params["material"]
    mat = get_material_id(mat) if isinstance(mat, str) else int(mat)
    return state.replace(
        E=torch.where(inside, float(params["E"]), state.E),
        nu=torch.where(inside, float(params["nu"]), state.nu),
        density=torch.where(inside, float(params["density"]), state.density),
        material=torch.where(inside, torch.tensor(mat, dtype=torch.int32, device=dev),
                             state.material),
    )


class MPMSolver:
    """Object facade with MPM_Simulator_WARP's API (pixie_tpu.sim.solver.MPMSolver).

    ``fused`` selects the fused-substep frame where no particle BC is active
    (``FastMPMSolver``'s ``PIXIE_FUSED``); None reads ``PIXIE_FUSED``,
    default "0"."""

    def __init__(self, n_particles=0, n_grid=100, grid_lim=1.0, device="cuda",
                 fused: bool | None = None):
        self.device = torch.device(device)
        self.fused = (os.environ.get("PIXIE_FUSED", "0") == "1" if fused is None
                      else bool(fused))
        self.cfg = MPMConfig(n_grid=n_grid, grid_lim=grid_lim)
        self.state: MPMState | None = None
        self.bcs: list = []
        self.time = 0.0

    def load_initial_data(self, x, vol, cov=None, n_grid=100, grid_lim=1.0):
        self.cfg = MPMConfig(n_grid=int(n_grid), grid_lim=float(grid_lim))
        self.state = make_state(x, vol, init_cov=cov, device=self.device)
        self.time = 0.0
        self.bcs = []
        self.n_particles = int(np.asarray(x).shape[0])

    def set_parameters_dict(self, kwargs: dict):
        """Mirror set_parameters_dict (mpm_solver_warp.py:287-463)."""
        st = self.state
        n = st.n_particles
        cfg_updates: dict = {}

        def full(val, dtype=torch.float32):
            return torch.full((n,), val, dtype=dtype, device=self.device)

        if "material" in kwargs:
            mat_id = get_material_id(kwargs["material"])
            if mat_id == -1:
                raise TypeError("Undefined material type")
            st = st.replace(material=full(mat_id, torch.int32))
        if "grid_lim" in kwargs:
            cfg_updates["grid_lim"] = float(kwargs["grid_lim"])
        if "n_grid" in kwargs:
            cfg_updates["n_grid"] = int(kwargs["n_grid"])
        for key in ("E", "nu"):
            if key in kwargs:
                st = st.replace(**{key: full(float(kwargs[key]))})
        if "bulk_modulus" in kwargs:
            st = st.replace(bulk=full(float(kwargs["bulk_modulus"])))
        if "yield_stress" in kwargs:
            st = st.replace(yield_stress=full(float(kwargs["yield_stress"])))
        for key in ("hardening", "xi", "friction_angle", "rpic_damping",
                    "plastic_viscosity", "softening", "grid_v_damping_scale"):
            if key in kwargs:
                cfg_updates[key] = float(kwargs[key])
        if "g" in kwargs:
            cfg_updates["gravity"] = tuple(float(v) for v in kwargs["g"])
        if "density" in kwargs:
            dens = full(float(kwargs["density"]))
            st = st.replace(density=dens, mass=dens * st.vol)
        if "additional_material_params" in kwargs:
            for params in kwargs["additional_material_params"]:
                st = apply_additional_params(st, params)
            st = st.replace(mass=st.density * st.vol)
        if cfg_updates:
            self.cfg = dataclasses.replace(self.cfg, **cfg_updates)
        self.state = st
        self._refresh_active_materials()

    def set_per_particle_materials(self, density, E, nu, material_id):
        """Per-particle material assignment (material_field.py:343-363)."""
        st = self.state
        n = st.n_particles

        def as_t(a, dtype):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype).expand(n).clone()

        dens = as_t(density, torch.float32)
        self.state = st.replace(density=dens, mass=dens * st.vol,
                                E=as_t(E, torch.float32), nu=as_t(nu, torch.float32),
                                material=as_t(material_id, torch.int32))
        self._refresh_active_materials()

    def _refresh_active_materials(self):
        mats = tuple(sorted(int(m) for m in torch.unique(self.state.material).cpu()))
        self.cfg = dataclasses.replace(self.cfg, active_materials=mats)

    def finalize_mu_lam(self):
        self.state = finalize_mu_lam(self.state)

    # -- BCs -------------------------------------------------------------------
    def add_surface_collider(self, point, normal, surface="sticky", friction=0.0,
                             start_time=0.0, end_time=999.0):
        self.bcs.append(bc_mod.make_surface_collider(
            point, normal, surface, friction, start_time, end_time, device=self.device))

    def set_velocity_on_cuboid(self, point, size, velocity, start_time=0.0,
                               end_time=999.0, reset=0):
        self.bcs.append(bc_mod.make_cuboid_velocity(
            point, size, velocity, start_time, end_time, reset, device=self.device))

    def add_bounding_box(self, start_time=0.0, end_time=999.0):
        self.bcs.append(bc_mod.BoundingBox(start_time=start_time, end_time=end_time))

    def add_impulse_on_particles(self, force, dt, point=(1, 1, 1), size=(1, 1, 1),
                                 num_dt=1, start_time=0.0):
        self.bcs.append(bc_mod.make_particle_impulse(
            self.export_particle_x(), force, dt, point, size, num_dt, start_time,
            device=self.device))

    def enforce_particle_velocity_translation(self, point, size, velocity,
                                              start_time, end_time):
        self.bcs.append(bc_mod.make_particle_translation(
            self.export_particle_x(), point, size, velocity, start_time, end_time,
            device=self.device))

    def enforce_particle_velocity_rotation(self, point, normal,
                                           half_height_and_radius, rotation_scale,
                                           translation_scale, start_time, end_time):
        self.bcs.append(bc_mod.make_particle_rotation(
            self.export_particle_x(), point, normal, half_height_and_radius,
            rotation_scale, translation_scale, start_time, end_time,
            device=self.device))

    def release_particles_sequentially(self, normal, start_position, end_position,
                                       num_layers, start_time, end_time):
        self.bcs.extend(bc_mod.make_release_sequential(
            self.export_particle_x(), normal, start_position, end_position,
            num_layers, start_time, end_time, device=self.device))

    # -- stepping --------------------------------------------------------------
    def p2g2p(self, step, dt):
        self.state = p2g2p(self.state, self.cfg, tuple(self.bcs),
                           np.float32(self.time), np.float32(dt))
        self.time += dt

    def step_frame(self, n_substeps: int, dt: float) -> bool:
        """Advance one frame of n_substeps; returns whether it ran fused.

        With ``fused``, the choice is made per frame, as
        solver_fast.py:787-833 makes it: a frame whose [t0, t1) window a
        particle BC intersects runs ``simulate_substeps``; any other frame
        drops its (inactive) particle BCs and runs the fused frame."""
        t0, t1 = self.time, self.time + n_substeps * dt
        bc_active = any(isinstance(b, bc_mod.PARTICLE_BC_TYPES)
                        and b.start_time < t1 and b.end_time > t0 for b in self.bcs)
        use_fused = self.fused and not bc_active
        if use_fused:
            bcs = tuple(b for b in self.bcs if not isinstance(b, bc_mod.PARTICLE_BC_TYPES))
            self.state = simulate_substeps_fused(self.state, self.cfg, bcs, self.time, dt,
                                                 n_substeps)
        else:
            self.state = simulate_substeps(self.state, self.cfg, tuple(self.bcs),
                                           self.time, dt, n_substeps)
        self.time += n_substeps * dt
        return use_fused

    # -- exports ---------------------------------------------------------------
    def export_particle_x(self):
        return self.state.x.cpu().numpy()

    def export_particle_v(self):
        return self.state.v.cpu().numpy()

    def export_particle_F(self):
        return self.state.F.cpu().numpy().reshape(-1, 9)

    def export_particle_R(self):
        return compute_R_from_F(self.state).cpu().numpy().reshape(-1, 9)

    def export_particle_cov(self):
        if not self.cfg.update_cov_with_F:
            self.state = self.state.replace(cov=compute_cov_from_F(self.state))
        return self.state.cov.cpu().numpy()
