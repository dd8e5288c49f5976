"""MLS-MPM solver: explicit APIC/RPIC substep with quadratic B-splines
(port of pixie_tpu/sim/solver.py; reference mpm_solver_warp.py:514-637).

One solver for every device.  Its transfers go through
``pixie_tpu_torch.ops.transfer``, which launches the CUDA P2G/G2P kernels on
CUDA tensors and runs their plain versions on CPU tensors.  The JAX
package's tile-sorted fast path (solver_fast.py, ops/tiling.py, sim/soa.py,
constitutive_soa.py) is the TPU's layout of the same math and has no
counterpart here: ``run_simulation(use_fast_solver=...)`` routes both values
to this solver.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from pixie_tpu_torch.ops import transfer
from pixie_tpu_torch.sim import bc as bc_mod
from pixie_tpu_torch.sim.constitutive import compute_stress_from_F_trial
from pixie_tpu_torch.sim.svd3 import matmul_nt, svd3
from pixie_tpu_torch.sim.types import (
    MPMConfig, MPMState, finalize_mu_lam, get_material_id, make_state,
)


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


def apply_grid_bcs(v_out, node_x, cfg: MPMConfig, dt, time, bcs: Sequence):
    """Grid BCs in insertion order (mpm_solver_warp.py:604-621)."""
    for b in bcs:
        if isinstance(b, bc_mod.GRID_BC_TYPES):
            v_out = b.apply(time, dt, v_out, node_x, cfg)
    return v_out


def grid_update(grid, cfg: MPMConfig, dt, time, bcs: Sequence,
                node_x: torch.Tensor | None = None) -> torch.Tensor:
    """Momentum -> velocity, gravity, damping, grid BCs."""
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
    for b in bcs:
        if isinstance(b, bc_mod.PARTICLE_BC_TYPES):
            state = b.apply(time, dt, state)
    state = compute_stress_from_F_trial(state, cfg, dt)
    grid = p2g(state, cfg, dt)
    grid_v = grid_update(grid, cfg, dt, time, bcs, node_x)
    return g2p(state, grid_v, cfg, dt)


def simulate_substeps(state: MPMState, cfg: MPMConfig, bcs, time0, dt,
                      n_substeps: int) -> MPMState:
    """n_substeps substeps; the substep time is f32(time0) + f32(step) * f32(dt)
    as in the JAX scan (pixie_tpu/sim/solver.py:291)."""
    time0, dt = np.float32(time0), np.float32(dt)
    node_x = node_positions(cfg, state.device) if any(
        isinstance(b, bc_mod.GRID_BC_TYPES) for b in bcs) else None
    for step in range(n_substeps):
        t = np.float32(time0 + np.float32(step) * dt)
        state = p2g2p(state, cfg, bcs, t, dt, node_x)
    return state


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
    """Object facade with MPM_Simulator_WARP's API (pixie_tpu.sim.solver.MPMSolver)."""

    def __init__(self, n_particles=0, n_grid=100, grid_lim=1.0, device="cuda"):
        self.device = torch.device(device)
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

    def step_frame(self, n_substeps: int, dt: float):
        """Advance one frame of n_substeps."""
        self.state = simulate_substeps(self.state, self.cfg, tuple(self.bcs),
                                       self.time, dt, n_substeps)
        self.time += n_substeps * dt

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
