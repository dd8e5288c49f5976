"""MPM state/config containers (port of pixie_tpu/sim/types.py).

``MPMState`` is a plain dataclass of tensors (the JAX package uses a
flax.struct pytree); every field lives on one device.  ``MPMConfig`` is the
same frozen dataclass of static scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# Material taxonomy (mpm_solver_warp.py:10-26)
MATERIAL_ID_TO_NAME = {
    0: "jelly",
    1: "metal",
    2: "sand",
    3: "visplas",
    4: "fluid",
    5: "snow",
    6: "stationary",
}
EXCLUDED_MATERIAL_NAMES = ("visplas", "fluid")
NAME_TO_MATERIAL_ID = {
    name: i
    for i, name in MATERIAL_ID_TO_NAME.items()
    if name not in EXCLUDED_MATERIAL_NAMES
}
NAME_TO_MATERIAL_ID.update({"elastic": 0, "rigid": 6})


def get_material_id(name_or_id) -> int:
    """Material name -> id (mpm_solver_warp.py:29-45). Ints pass through."""
    if isinstance(name_or_id, (int, np.integer)):
        return int(name_or_id)
    return NAME_TO_MATERIAL_ID.get(name_or_id, -1)


@dataclasses.dataclass
class MPMState:
    """Per-particle simulation state (float32 except the int32 tags)."""

    x: torch.Tensor          # (N,3) position in grid space [0, grid_lim]^3
    v: torch.Tensor          # (N,3) velocity
    F: torch.Tensor          # (N,3,3) elastic deformation gradient
    F_trial: torch.Tensor    # (N,3,3) trial deformation gradient
    C: torch.Tensor          # (N,3,3) affine velocity field (APIC)
    stress: torch.Tensor     # (N,3,3) Kirchhoff stress
    init_cov: torch.Tensor   # (N,6) initial covariance (upper-triangular packed)
    cov: torch.Tensor        # (N,6) current covariance
    vol: torch.Tensor        # (N,)
    mass: torch.Tensor       # (N,)
    density: torch.Tensor    # (N,)
    material: torch.Tensor   # (N,) int32 material id
    selection: torch.Tensor  # (N,) int32; only selection==0 is simulated
    Jp: torch.Tensor         # (N,) reserved
    E: torch.Tensor          # (N,) Young's modulus
    nu: torch.Tensor         # (N,) Poisson ratio
    mu: torch.Tensor         # (N,)
    lam: torch.Tensor        # (N,)
    bulk: torch.Tensor       # (N,)
    yield_stress: torch.Tensor  # (N,)

    @property
    def n_particles(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def replace(self, **kw) -> "MPMState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MPMConfig:
    """Static solver configuration; defaults as pixie_tpu.sim.types.MPMConfig."""

    n_grid: int = 50
    grid_lim: float = 2.0
    gravity: tuple[float, float, float] = (0.0, 0.0, 0.0)
    rpic_damping: float = 0.0          # 0 = APIC, >0 = RPIC blend, <0 = PIC
    grid_v_damping_scale: float = 1.1  # applied only when < 1.0
    update_cov_with_F: bool = False

    hardening: float = 0.0
    xi: float = 0.0
    friction_angle: float = 25.0
    plastic_viscosity: float = 0.0
    softening: float = 0.1

    active_materials: tuple[int, ...] = (0,)

    @property
    def dx(self) -> float:
        return self.grid_lim / self.n_grid

    @property
    def inv_dx(self) -> float:
        return self.n_grid / self.grid_lim

    @property
    def alpha(self) -> float:
        """Drucker-Prager alpha from the friction angle (mpm_solver_warp.py:84-86)."""
        sin_phi = np.sin(self.friction_angle / 180.0 * 3.14159265)
        return float(np.sqrt(2.0 / 3.0) * 2.0 * sin_phi / (3.0 - sin_phi))

    def needs_return_mapping(self) -> bool:
        return any(m in self.active_materials for m in (1, 2, 3, 5))


def _per_particle(val, n: int, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(val), dtype=dtype, device=device)
    return t.expand(n).clone() if t.ndim == 0 else t.reshape(n).clone()


def make_state(
    x: Any,
    vol: Any,
    init_cov: Any | None = None,
    density: float | Any = 200.0,
    E: float | Any = 1e5,
    nu: float | Any = 0.4,
    material: int | Any = 0,
    yield_stress: float | Any = 0.0,
    bulk: float | Any = 0.0,
    device: str | torch.device = "cpu",
) -> MPMState:
    """Initial state (load_initial_data_from_torch semantics,
    mpm_solver_warp.py:234-281): v=0, F=F_trial=I, mass = density * vol."""
    x = torch.as_tensor(np.asarray(x, np.float32), device=device).reshape(-1, 3)
    n = x.shape[0]
    f32, i32 = torch.float32, torch.int32
    eye = torch.eye(3, dtype=f32, device=device).expand(n, 3, 3)
    zeros33 = torch.zeros((n, 3, 3), dtype=f32, device=device)
    vol_t = _per_particle(np.asarray(vol, np.float32), n, f32, device)
    density_t = _per_particle(density, n, f32, device)
    if init_cov is None:
        cov = torch.zeros((n, 6), dtype=f32, device=device)
    else:
        cov = torch.as_tensor(np.asarray(init_cov, np.float32), device=device).reshape(n, 6)
    zeros = torch.zeros((n,), dtype=f32, device=device)
    return MPMState(
        x=x.contiguous(),
        v=torch.zeros((n, 3), dtype=f32, device=device),
        F=eye.clone(),
        F_trial=eye.clone(),
        C=zeros33,
        stress=zeros33.clone(),
        init_cov=cov.clone(),
        cov=cov.clone(),
        vol=vol_t,
        mass=density_t * vol_t,
        density=density_t,
        material=_per_particle(material, n, i32, device),
        selection=torch.zeros((n,), dtype=i32, device=device),
        Jp=zeros.clone(),
        E=_per_particle(E, n, f32, device),
        nu=_per_particle(nu, n, f32, device),
        mu=zeros.clone(),
        lam=zeros.clone(),
        bulk=_per_particle(bulk, n, f32, device),
        yield_stress=_per_particle(yield_stress, n, f32, device),
    )


def finalize_mu_lam(state: MPMState) -> MPMState:
    """E, nu -> mu, lam (mpm_utils.py:282-288); bulk = lam + 2/3 mu."""
    mu = state.E / (2.0 * (1.0 + state.nu))
    lam = state.E * state.nu / ((1.0 + state.nu) * (1.0 - 2.0 * state.nu))
    return state.replace(mu=mu, lam=lam, bulk=lam + 2.0 / 3.0 * mu)
