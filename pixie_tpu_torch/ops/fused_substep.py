"""The fused MPM substep: G2P(s) -> advect -> constitutive pass -> P2G(s+1)
in one kernel launch; the CUDA kernel and its plain PyTorch version.

Counterpart of ``pixie_tpu/ops/fused_substep.py``.  The substep boundary is
rotated as there: a frame runs stress(0) + P2G(0), then per substep the grid
stage and one ``fused_substep``, then the grid stage and G2P
(``pixie_tpu_torch.sim.solver.simulate_substeps_fused``).

Dispatch is by the device of the tensors, with no fallback:

  * CPU tensors take ``fused_substep_plain``, the port's own plain pieces in
    the rotated order (``g2p_plain``, ``compute_stress_from_F_trial``,
    ``p2g_plain``), so a fused frame on the CPU equals an unfused one bit
    for bit;
  * CUDA tensors launch the hand-written kernel of ``csrc/fused_substep.cu``
    on the current stream, or raise.

The kernel's splat sums runs of adjacent lanes of one cell before its
atomics: any particle order gives the same sums, a cell order
(``transfer.cell_order``, as the fused frame of ``sim/solver.py`` keeps
its state) long runs.

``FUSED_LAUNCHES`` counts kernel launches (plain-version calls are not
counted).
"""

from __future__ import annotations

import ctypes

import torch

from pixie_tpu_torch.ops import transfer
from pixie_tpu_torch.ops.build import check_tensor, load_library, raise_on_error
from pixie_tpu_torch.sim.constitutive import compute_stress_from_F_trial
from pixie_tpu_torch.sim.types import MPMConfig, MPMState

FUSED_LAUNCHES = 0

# fields the substep rewrites in place (besides the grid it returns)
UPDATED_FIELDS = ("x", "v", "C", "F", "F_trial", "stress", "mu", "lam", "yield_stress",
                  "cov")
_STRESS_FIELDS = ("F", "stress", "mu", "lam", "yield_stress")

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = load_library("fused_substep")
    if not getattr(lib, "_pixie_typed", False):
        lib.pixie_fused_substep.argtypes = ([_c_void_p] * 17 + [_c_int, _c_int]
                                            + [_c_float] * 9 + [_c_int, _c_int, _c_void_p])
        lib.pixie_fused_substep.restype = _c_int
        lib.pixie_error_string.argtypes = [_c_int]
        lib.pixie_error_string.restype = ctypes.c_char_p
        lib._pixie_typed = True
    return lib


def build() -> None:
    """Compile (or load from the build cache) the fused substep kernel."""
    _lib()


def material_mask(cfg: MPMConfig) -> int:
    """cfg.active_materials as a bitmask: bit m set for material id m."""
    return sum(1 << m for m in set(cfg.active_materials) if 0 <= m < 31)


def fused_substep_plain(state: MPMState, grid_v, cfg: MPMConfig, dt, active) -> torch.Tensor:
    """Plain PyTorch version: G2P + advect, the constitutive pass, then the
    next P2G; writes the state in place, as ``fused_substep``."""
    transfer.g2p_plain(state, grid_v, cfg, dt)
    out = compute_stress_from_F_trial(state, cfg, dt)
    for k in _STRESS_FIELDS:
        getattr(state, k).copy_(getattr(out, k))
    return transfer.p2g_plain(state.x, state.v, state.C, state.stress, state.mass,
                              state.vol, active, cfg, dt)


def fused_substep(state: MPMState, grid_v: torch.Tensor, cfg: MPMConfig, dt,
                  active: torch.Tensor) -> torch.Tensor:
    """One rotated substep for the particles with ``active`` (selection == 0):
    gather v, APIC C and grad v from ``grid_v`` (G,G,G,3) at x(s); advect x,
    F_trial = (I + dt grad v) F and, with ``cfg.update_cov_with_F``, cov; the
    return map and Kirchhoff stress of ``compute_stress_from_F_trial``; then
    splat P2G(s+1) at x(s+1).  Returns the new grid (G,G,G,4) =
    [momentum x, y, z, mass].

    The splat's runs are long where the particles come sorted by cell.

    Updates ``state.x, v, C, F, F_trial, stress, mu, lam, yield_stress, cov``
    IN PLACE (the JAX version is functional), as ``transfer.g2p`` does;
    inactive particles keep every field.
    """
    if state.x.device.type == "cpu":
        return fused_substep_plain(state, grid_v, cfg, dt, active)
    if state.x.device.type != "cuda":
        raise ValueError(f"fused_substep: unsupported device {state.x.device}")
    global FUSED_LAUNCHES
    grid = _launch(state, grid_v, cfg, dt, active)
    FUSED_LAUNCHES += 1
    return grid


def _launch(state: MPMState, grid_v, cfg: MPMConfig, dt, active):
    n, g, dev, f32 = state.n_particles, cfg.n_grid, state.x.device, torch.float32
    for name, shape in (("x", (n, 3)), ("v", (n, 3)), ("C", (n, 3, 3)), ("F", (n, 3, 3)),
                        ("F_trial", (n, 3, 3)), ("stress", (n, 3, 3)), ("mu", (n,)),
                        ("lam", (n,)), ("yield_stress", (n,)), ("cov", (n, 6)),
                        ("mass", (n,)), ("vol", (n,)), ("bulk", (n,))):
        check_tensor(name, getattr(state, name), shape, f32, dev)
    check_tensor("material", state.material, (n,), torch.int32, dev)
    check_tensor("active", active, (n,), torch.bool, dev)
    check_tensor("grid_v", grid_v, (g, g, g, 3), f32, dev)
    if (g + 2) ** 3 >= 2**31:
        raise ValueError(f"n_grid {g}: the splat's int32 cell labels overflow")
    lib = _lib()
    grid = torch.zeros((g, g, g, 4), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.pixie_fused_substep(
        *(getattr(state, k).data_ptr() for k in UPDATED_FIELDS),
        state.mass.data_ptr(), state.vol.data_ptr(), state.material.data_ptr(),
        state.bulk.data_ptr(), active.data_ptr(), grid_v.data_ptr(), grid.data_ptr(),
        n, g, cfg.dx, cfg.inv_dx, float(dt), float(cfg.hardening), float(cfg.xi),
        float(cfg.alpha), float(cfg.plastic_viscosity), float(cfg.softening),
        float(cfg.rpic_damping), int(cfg.update_cov_with_F), material_mask(cfg), stream)
    raise_on_error(lib, code, "fused_substep")
    return grid


def mean_run_length(x: torch.Tensor, active: torch.Tensor, cfg: MPMConfig,
                    warp: int = 32) -> float:
    """Mean length of the kernel's splat runs for particles at ``x`` in
    their array order: live lanes (active, finite, a stencil node in the
    grid) over runs, a run being adjacent live lanes of one warp with one
    base cell.  Plain PyTorch, on any device."""
    live, runs = run_counts(x, active, cfg, warp)
    return float(live) / max(int(runs), 1)


def run_counts(x: torch.Tensor, active: torch.Tensor, cfg: MPMConfig,
               warp: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """``mean_run_length``'s live lanes and runs, as 0-d int64 tensors on
    ``x``'s device (no host sync): each live lane heads a run but where the
    lane before it, in its warp, has the same base cell.  The base cells
    are read from P2G's bin keys (``transfer.p2g_bin_keys``: B1's key kernel
    on the card), whose live lanes are these."""
    nb, hbits = transfer.bin_layout(cfg.n_grid)
    cell = transfer.p2g_bin_keys(x, active, cfg.n_grid, cfg.inv_dx) >> (
        hbits - transfer._CELL_BITS)
    live = cell != nb ** 3 << transfer._CELL_BITS
    joined = live[1:] & (cell[1:] == cell[:-1])
    joined[warp - 1::warp] = False          # lane 0 of a warp heads a run
    n_live = live.sum()
    return n_live, n_live - joined.sum()
