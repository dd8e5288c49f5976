"""Boundary conditions (port of pixie_tpu/sim/bc.py; reference
mpm_solver_warp.py:749-1211, decode_param.py:277-396).

Each BC is a small dataclass holding tensors on the solver's device, an
``apply`` method and a ``host_key`` method, which returns what ``apply``
decides on the host at a time (the solver replays a captured substep only
while its BCs' keys stay those of the capture).  A grid BC also keeps float32
host copies of its vectors (``host``) and a ``table_entry`` method, which
returns what ``apply`` does at a time as an entry of the table the card's
grid stage reads (``ops.grid``, ``csrc/grid.cu``).  Time gating is decided
on the host from float32 scalars: the solver passes
``time = f32(time0) + f32(step) * f32(dt)``, exactly the JAX scan's
expression (pixie_tpu/sim/solver.py:291), and every comparison below rounds
its operands to float32 first.  A one-substep impulse
(``num_dt: 1``) therefore fires on the same substep as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

_f32 = np.float32


def _active(time, start, end) -> bool:
    return bool((_f32(time) >= _f32(start)) & (_f32(time) < _f32(end)))


def _vec(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    """A float32 host copy of one of a BC's vectors, made at construction:
    the card's grid stage (``ops.grid``) builds its table from these, so a
    substep reads nothing back from the device."""
    return t.detach().cpu().numpy().astype(np.float32)


# an entry of the card's grid-stage table: its kind, as csrc/grid.cu reads
# it, and ENTRY_FLOATS float32s, a[3], b[3], c[3], friction
HALFSPACE_ZERO, HALFSPACE_SLIP, HALFSPACE_FRICTION, HALFSPACE_CUT = 0, 1, 2, 3
BOX_SET, ZERO_ALL, BOUNDING_BOX = 4, 5, 6
ENTRY_FLOATS = 10


def _entry_floats(a=None, b=None, c=None, friction=0.0) -> np.ndarray:
    vals = np.zeros(ENTRY_FLOATS, np.float32)
    for i, x in enumerate((a, b, c)):
        if x is not None:
            vals[3 * i:3 * i + 3] = x
    vals[9] = friction
    return vals


class _Windowed:
    """A BC whose ``apply`` decides on the host only whether it is active."""

    def host_key(self, time, dt):
        return _active(time, self.start_time, self.end_time)


# -- grid BCs ----------------------------------------------------------------

@dataclasses.dataclass
class SurfaceCollider(_Windowed):
    """Half-space collider; surface types 0=sticky, 1=slip, 2=frictional,
    11=cut.  ``legacy_zero_velocity`` reproduces the PhysGaussian fork, which
    zeroes slip/frictional velocities too (mpm_solver_warp.py:838-840)."""

    point: torch.Tensor
    normal: torch.Tensor
    surface_type: int = 0
    friction: float = 0.0
    start_time: float = 0.0
    end_time: float = 999.0
    legacy_zero_velocity: bool = True
    host: dict = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.host = {"point": _host(self.point), "normal": _host(self.normal)}

    def apply(self, time, dt, grid_v, node_x, cfg):
        if not _active(time, self.start_time, self.end_time):
            return grid_v
        inside = ((node_x - self.point) * self.normal).sum(-1) < 0.0
        if self.surface_type == 0 or (
                self.surface_type != 11 and self.legacy_zero_velocity):
            v_new = torch.zeros_like(grid_v)
        elif self.surface_type == 11:  # cut
            z = node_x[..., 2]
            outside_slab = (z < 0.4) | (z > 0.53)
            damped = grid_v.clone()
            damped[..., 1] = 0.0
            damped = damped * 0.3
            v_new = torch.where(outside_slab[..., None], 0.0, damped)
        else:
            n = self.normal
            normal_component = (grid_v * n).sum(-1)
            if self.surface_type == 1:  # slip: project out all normal
                v_proj = grid_v - normal_component[..., None] * n
            else:  # frictional: project out the inward normal only
                v_proj = grid_v - torch.clamp(normal_component, max=0.0)[..., None] * n
            v_len = torch.linalg.vector_norm(v_proj, dim=-1)
            fric_scale = torch.clamp(v_len + normal_component * self.friction, min=0.0)
            v_new = torch.where(
                ((normal_component < 0.0) & (v_len > 1e-20))[..., None],
                fric_scale[..., None] * v_proj / torch.clamp(v_len, min=1e-20)[..., None],
                v_proj,
            )
        return torch.where(inside[..., None], v_new, grid_v)

    def table_entry(self, time, dt):
        """What ``apply`` does at ``time`` as (kind, the entry's floats:
        point, normal, friction), or None while inactive."""
        if not self.host_key(time, dt):
            return None
        if self.surface_type == 11:
            kind = HALFSPACE_CUT
        elif self.surface_type == 0 or self.legacy_zero_velocity:
            kind = HALFSPACE_ZERO
        else:
            kind = HALFSPACE_SLIP if self.surface_type == 1 else HALFSPACE_FRICTION
        return kind, _entry_floats(self.host["point"], self.host["normal"],
                                   friction=self.friction)


@dataclasses.dataclass
class CuboidVelocity:
    """Velocity Dirichlet cuboid, optionally moving
    (set_velocity_on_cuboid, mpm_solver_warp.py:853-908).  reset=1 zeroes the
    WHOLE grid for 15 dt after end_time (mpm_solver_warp.py:895-897).

    A cuboid that does not move (its velocity is zero) keeps its node set
    with the node positions it was computed on, so a frame, which passes the
    same positions to each substep, computes it once."""

    point: torch.Tensor
    size: torch.Tensor
    velocity: torch.Tensor
    start_time: float = 0.0
    end_time: float = 999.0
    reset: int = 0
    still: bool = dataclasses.field(init=False, repr=False, compare=False)
    host: dict = dataclasses.field(init=False, repr=False, compare=False)
    _held: tuple | None = dataclasses.field(default=None, init=False, repr=False,
                                            compare=False)

    def __post_init__(self):
        self.host = {k: _host(getattr(self, k)) for k in ("point", "size", "velocity")}
        self.still = not self.host["velocity"].any()

    def apply(self, time, dt, grid_v, node_x, cfg):
        t = _f32(time)
        active = _active(t, self.start_time, self.end_time)
        out = grid_v
        if active:
            out = torch.where(self._inside(t, node_x)[..., None], self.velocity, grid_v)
        if self._resets(t, dt, active):
            out = torch.zeros_like(out)
        return out

    def host_key(self, time, dt):
        """(active, whether the reset zeroes the grid); None while a moving
        cuboid is active, since its position changes every substep."""
        t = _f32(time)
        active = _active(t, self.start_time, self.end_time)
        if active and not self.still:
            return None
        return active, self._resets(t, dt, active)

    def table_entry(self, time, dt):
        """What ``apply`` does at ``time`` as (kind, the entry's floats):
        while active, the velocity set inside the cuboid (its point at t,
        size, velocity); in a reset's window, the whole grid zeroed; else
        None."""
        t = _f32(time)
        active = _active(t, self.start_time, self.end_time)
        if active:
            return BOX_SET, _entry_floats(self.point_at(t), self.host["size"],
                                          self.host["velocity"])
        return (ZERO_ALL, _entry_floats()) if self._resets(t, dt, active) else None

    def _resets(self, t, dt, active) -> bool:
        return self.reset == 1 and not active and bool(
            t < _f32(self.end_time) + _f32(15.0) * _f32(dt))

    def _travel(self, t) -> np.float32:
        return _f32(np.clip(t, _f32(self.start_time), _f32(self.end_time))
                    - _f32(self.start_time))

    def point_at(self, t) -> np.ndarray:
        """The cuboid's point at t from the host copies, rounded in float32
        as ``_inside`` rounds it on the device (a product, then a sum)."""
        return self.host["point"] + self.host["velocity"] * self._travel(_f32(t))

    def _inside(self, t, node_x) -> torch.Tensor:
        if self._held is not None and self._held[0] is node_x:
            return self._held[1]
        point = self.point + self.velocity * float(self._travel(t))
        inside = torch.all((node_x - point).abs() < self.size, dim=-1)
        if self.still:
            self._held = (node_x, inside)
        return inside


@dataclasses.dataclass
class BoundingBox(_Windowed):
    """Outward-velocity clamp at the domain faces, padding 3 cells
    (add_bounding_box, mpm_solver_warp.py:910-977)."""

    start_time: float = 0.0
    end_time: float = 999.0

    def apply(self, time, dt, grid_v, node_x, cfg):
        if not _active(time, self.start_time, self.end_time):
            return grid_v
        padding = 3
        idx = torch.round(node_x * cfg.inv_dx).to(torch.int32)
        low = idx < padding
        high = idx >= cfg.n_grid - padding
        out = grid_v.clone()
        for a in range(3):
            va = grid_v[..., a]
            va = torch.where(low[..., a] & (va < 0), 0.0, va)
            out[..., a] = torch.where(high[..., a] & (va > 0), 0.0, va)
        return out

    def table_entry(self, time, dt):
        """What ``apply`` does at ``time`` as (kind, the entry's floats, all
        zero), or None while inactive."""
        return (BOUNDING_BOX, _entry_floats()) if self.host_key(time, dt) else None


# -- particle BCs (before P2G) -------------------------------------------------

@dataclasses.dataclass
class ParticleImpulse(_Windowed):
    """v += force / mass * dt while active (mpm_solver_warp.py:982-1029)."""

    force: torch.Tensor
    mask: torch.Tensor  # (N,) bool, selected from the initial positions
    start_time: float = 0.0
    end_time: float = 0.0

    def apply(self, time, dt, state):
        if not _active(time, self.start_time, self.end_time):
            return state
        impulse = self.force[None, :] / state.mass[:, None] * float(_f32(dt))
        return state.replace(v=torch.where(self.mask[:, None], state.v + impulse, state.v))


@dataclasses.dataclass
class ParticleVelocityTranslation(_Windowed):
    """Dirichlet particle velocity in a box (mpm_solver_warp.py:1031-1075)."""

    velocity: torch.Tensor
    mask: torch.Tensor
    start_time: float = 0.0
    end_time: float = 999.0

    def apply(self, time, dt, state):
        if not _active(time, self.start_time, self.end_time):
            return state
        return state.replace(v=torch.where(self.mask[:, None], self.velocity, state.v))


@dataclasses.dataclass
class ParticleVelocityRotation(_Windowed):
    """Rotate particles in a cylinder about ``normal`` (mpm_solver_warp.py:1080-1181)."""

    point: torch.Tensor
    normal: torch.Tensor
    horizontal_axis_1: torch.Tensor
    horizontal_axis_2: torch.Tensor
    mask: torch.Tensor
    rotation_scale: float = 1.0
    translation_scale: float = 0.0
    start_time: float = 0.0
    end_time: float = 999.0

    def apply(self, time, dt, state):
        if not _active(time, self.start_time, self.end_time):
            return state
        offset = state.x - self.point
        along = offset @ self.normal
        radial = offset - along[:, None] * self.normal
        horiz_dist = torch.linalg.vector_norm(radial, dim=-1)
        cosine = (offset @ self.horizontal_axis_1) / torch.clamp(horiz_dist, min=1e-12)
        theta = torch.arccos(torch.clamp(cosine, -1.0, 1.0))
        theta = torch.where(offset @ self.horizontal_axis_2 > 0, theta, -theta)
        a1 = -horiz_dist * torch.sin(theta) * self.rotation_scale
        a2 = horiz_dist * torch.cos(theta) * self.rotation_scale
        v_new = (a1[:, None] * self.horizontal_axis_1
                 + a2[:, None] * self.horizontal_axis_2
                 + self.translation_scale * self.normal[None, :])
        return state.replace(v=torch.where(self.mask[:, None], v_new, state.v))


GRID_BC_TYPES = (SurfaceCollider, CuboidVelocity, BoundingBox)
PARTICLE_BC_TYPES = (ParticleImpulse, ParticleVelocityTranslation, ParticleVelocityRotation)


# -- setup helpers (host side) -------------------------------------------------

def _normalize_np(v):
    v = np.asarray(v, np.float32)
    return v / np.sqrt((v ** 2).sum())


def _box_mask(positions, point, size, device) -> torch.Tensor:
    offset = np.abs(np.asarray(positions) - np.asarray(point))
    return torch.as_tensor(np.all(offset < np.asarray(size), axis=-1), device=device)


def make_surface_collider(point, normal, surface="sticky", friction=0.0,
                          start_time=0.0, end_time=999.0, device="cpu"):
    if surface == "sticky" and friction != 0:
        raise ValueError("friction must be 0 on sticky surfaces.")
    return SurfaceCollider(
        point=_vec(point, device),
        normal=_vec(_normalize_np(normal), device),
        surface_type={"sticky": 0, "slip": 1, "cut": 11}.get(surface, 2),
        friction=float(friction),
        start_time=float(start_time),
        end_time=float(end_time),
    )


def make_cuboid_velocity(point, size, velocity, start_time=0.0, end_time=999.0,
                         reset=0, device="cpu"):
    return CuboidVelocity(
        point=_vec(point, device), size=_vec(size, device),
        velocity=_vec(velocity, device), start_time=float(start_time),
        end_time=float(end_time), reset=int(reset),
    )


def make_particle_impulse(positions, force, dt, point=(1, 1, 1), size=(1, 1, 1),
                          num_dt=1, start_time=0.0, device="cpu"):
    return ParticleImpulse(
        force=_vec(force, device),
        mask=_box_mask(positions, point, size, device),
        start_time=float(start_time),
        end_time=float(start_time + dt * num_dt),
    )


def make_particle_translation(positions, point, size, velocity, start_time,
                              end_time, device="cpu"):
    return ParticleVelocityTranslation(
        velocity=_vec(velocity, device),
        mask=_box_mask(positions, point, size, device),
        start_time=float(start_time),
        end_time=float(end_time),
    )


def make_particle_rotation(positions, point, normal, half_height_and_radius,
                           rotation_scale, translation_scale, start_time,
                           end_time, device="cpu"):
    normal = _normalize_np(normal)
    h1 = np.array([1.0, 1.0, 1.0], np.float32)
    if abs(float(np.dot(normal, h1))) < 0.01:
        h1 = np.array([0.72, 0.37, -0.67], np.float32)
    h1 = h1 - np.dot(h1, normal) * normal
    h1 = h1 / np.linalg.norm(h1)
    h2 = np.cross(h1, normal)

    offset = np.asarray(positions) - np.asarray(point)
    vert = np.abs(offset @ normal)
    horiz = np.linalg.norm(offset - np.outer(offset @ normal, normal), axis=-1)
    mask = (vert < half_height_and_radius[0]) & (horiz < half_height_and_radius[1])
    return ParticleVelocityRotation(
        point=_vec(point, device), normal=_vec(normal, device),
        horizontal_axis_1=_vec(h1, device), horizontal_axis_2=_vec(h2, device),
        mask=torch.as_tensor(mask, device=device),
        rotation_scale=float(rotation_scale),
        translation_scale=float(translation_scale),
        start_time=float(start_time), end_time=float(end_time),
    )


def make_release_sequential(positions, normal, start_position, end_position,
                            num_layers, start_time, end_time, device="cpu"):
    """release_particles_sequentially (mpm_solver_warp.py:1185-1210); the
    reference hard-codes num_layers = 50 whatever the argument."""
    num_layers = 50
    point = [0.0, 0.0, 0.0]
    size = [0.0, 0.0, 0.0]
    axis = -1
    for i in range(3):
        if normal[i] == 0:
            point[i] = 1.0
            size[i] = 1.0
        else:
            axis = i
            point[i] = float(end_position)
    half = abs(start_position - end_position) / num_layers
    end_portion = end_time / num_layers
    bcs = []
    for i in range(num_layers):
        size[axis] = half * (num_layers - i)
        bcs.append(make_particle_translation(
            positions, point, list(size), [0.0, 0.0, 0.0],
            start_time, end_portion * (i + 1), device=device))
    return bcs


def build_boundary_conditions(bc_params: Sequence[dict], time_params: dict,
                              positions: np.ndarray, device="cpu") -> tuple:
    """JSON BC list -> BC objects (set_boundary_conditions, decode_param.py:277-396)."""
    bcs: list = []
    for bc in bc_params:
        t = bc["type"]
        if t == "cuboid":
            bcs.append(make_cuboid_velocity(
                bc["point"], bc["size"], bc["velocity"],
                bc.get("start_time", 0.0), bc.get("end_time", 1e3),
                bc.get("reset", 0), device=device))
        elif t == "particle_impulse":
            bcs.append(make_particle_impulse(
                positions, bc["force"], time_params["substep_dt"],
                bc.get("point", [1, 1, 1]), bc.get("size", [1, 1, 1]),
                bc.get("num_dt", 1), bc.get("start_time", 0.0), device=device))
        elif t == "bounding_box":
            bcs.append(BoundingBox())
        elif t == "enforce_particle_translation":
            bcs.append(make_particle_translation(
                positions, bc["point"], bc["size"], bc["velocity"],
                bc["start_time"], bc["end_time"], device=device))
        elif t == "surface_collider":
            bcs.append(make_surface_collider(
                bc["point"], bc["normal"], bc["surface"], bc["friction"],
                bc["start_time"], bc["end_time"], device=device))
        elif t == "release_particles_sequentially":
            bcs.extend(make_release_sequential(
                positions, bc["normal"], bc["start_position"],
                bc["end_position"], bc["num_layers"],
                bc["start_time"], bc["end_time"], device=device))
        elif t == "enforce_particle_velocity_rotation":
            bcs.append(make_particle_rotation(
                positions, bc["point"], bc["normal"],
                bc["half_height_and_radius"], bc["rotation_scale"],
                bc["translation_scale"], bc["start_time"], bc["end_time"],
                device=device))
        else:
            raise TypeError(f"Undefined BC type {t!r}")
    return tuple(bcs)
