"""P2G / G2P transfers: the CUDA kernels and their plain PyTorch versions.

Dispatch is by the device of the tensors, with no fallback:

  * CPU tensors take the plain PyTorch version (``p2g_plain`` / ``g2p_plain``);
  * CUDA tensors launch the hand-written kernel of ``csrc/transfer.cu`` on
    the current stream, or raise.

The kernels replace the TPU's ``pixie_tpu/ops/transfer.py:p2g_tiled_t`` and
``g2p_tiled_t`` (and compute what the AoS ``p2g_tiled``/``g2p_tiled``
compute); the source notes in ``csrc/transfer.cu`` say what bounds each and
why it is shaped as it is.  The CUDA P2G is binned: a key kernel gives each
particle its bin of ``P2G_BIN``^3 base cells and its cell within the bin
(``p2g_bin_keys_plain`` is its plain version), ``torch.sort`` orders the
keys, and the splat kernel sums each run of same-cell lanes of a warp
before adding the sums into the grid.  Semantics are those of
``pixie_tpu/sim/solver.py`` p2g (:60-128) and g2p (:171-220), including the
RPIC/PIC damping of C and the drop of out-of-grid nodes.

``P2G_LAUNCHES`` / ``G2P_LAUNCHES`` count kernel launches (plain-version
calls are not counted).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pixie_tpu_torch.ops.build import check_tensor, load_library, raise_on_error
from pixie_tpu_torch.sim.types import MPMConfig, MPMState

P2G_LAUNCHES = 0
G2P_LAUNCHES = 0
P2G_BIN = 4                # base cells a bin side (csrc/transfer.cu kBin)
_HASH_MUL = 2654435761     # csrc/transfer.cu kHashMul
_CELL_BITS = 6             # csrc/transfer.cu kCellBits: P2G_BIN^3 cells a bin

_OFFSETS = np.array([(i, j, k) for i in range(3) for j in range(3) for k in range(3)],
                    np.int64)

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = load_library("transfer")
    if not getattr(lib, "_pixie_typed", False):
        lib.pixie_p2g_keys.argtypes = [_c_void_p] * 3 + [_c_int, _c_int, _c_float] + [
            _c_int] * 2 + [_c_void_p]
        lib.pixie_p2g_keys.restype = _c_int
        lib.pixie_p2g.argtypes = [_c_void_p] * 9 + [_c_int] * 4 + [_c_float] * 4 + [_c_void_p]
        lib.pixie_p2g.restype = _c_int
        lib.pixie_g2p.argtypes = [_c_void_p] * 8 + [_c_int, _c_int, _c_float, _c_float,
                                                     _c_int, _c_void_p]
        lib.pixie_g2p.restype = _c_int
        lib.pixie_error_string.argtypes = [_c_int]
        lib.pixie_error_string.restype = ctypes.c_char_p
        lib._pixie_typed = True
    return lib


def build() -> None:
    """Compile (or load from the build cache) the transfer kernels."""
    _lib()


def _spline_weights(x: torch.Tensor, inv_dx: float):
    """Quadratic B-spline base cell, fx, w (N,3off,3ax), dw (solver.py:42-57)."""
    grid_pos = x * inv_dx
    base = torch.floor(grid_pos - 0.5).to(torch.int64)
    fx = grid_pos - base.to(torch.float32)
    wa, wb, wc = 1.5 - fx, fx - 1.0, fx - 0.5
    w = torch.stack([0.5 * wa * wa, 0.75 - wb * wb, 0.5 * wc * wc], dim=1)
    dw = torch.stack([fx - 1.5, -2.0 * (fx - 1.0), fx - 0.5], dim=1)
    return base, fx, w, dw


def _stencil(x: torch.Tensor, n_grid: int, inv_dx: float):
    """Per (offset, particle): weight (27,N), dweight (27,N,3), unitless dpos
    (27,N,3), flat node index (27,N) clamped, in-bounds mask (27,N)."""
    base, fx, w, dw = _spline_weights(x, inv_dx)
    offs = torch.as_tensor(_OFFSETS, device=x.device)
    wx, wy, wz = (w[:, offs[:, a], a].T for a in range(3))
    dwx, dwy, dwz = (dw[:, offs[:, a], a].T for a in range(3))
    weight = wx * wy * wz
    dweight = torch.stack([dwx * wy * wz, wx * dwy * wz, wx * wy * dwz], dim=-1) * inv_dx
    dpos = offs[:, None, :].to(torch.float32) - fx[None, :, :]
    cell = base[None, :, :] + offs[:, None, :]
    in_bounds = torch.all((cell >= 0) & (cell < n_grid), dim=-1)
    cellc = torch.clamp(cell, 0, n_grid - 1)
    flat = (cellc[..., 0] * n_grid + cellc[..., 1]) * n_grid + cellc[..., 2]
    return weight, dweight, dpos, flat, in_bounds


def _damped_C(C: torch.Tensor, rpic_damping: float) -> torch.Tensor:
    if rpic_damping < -0.001:
        return torch.zeros_like(C)
    if rpic_damping != 0.0:
        return (1.0 - rpic_damping) * C + rpic_damping / 2.0 * (C - C.transpose(-1, -2))
    return C


# -- P2G -----------------------------------------------------------------------

def p2g_contributions(x, v, C, stress, mass, vol, active, cfg: MPMConfig, dt, stencil=None):
    """Per (node offset, particle) P2G contributions (27,N,4) = [momentum
    xyz, mass], zero for out-of-grid nodes and inactive particles, and the
    flat node index (27,N).  ``stencil`` replaces ``_stencil``'s output
    (the P2G ablation probe makes the weights constant)."""
    g, dx, inv_dx = cfg.n_grid, cfg.dx, cfg.inv_dx
    weight, dweight, dpos, flat, in_bounds = stencil or _stencil(x, g, inv_dx)
    C = _damped_C(C, cfg.rpic_damping)
    act = active.to(torch.float32)
    m = mass * act
    stress_scaled = -vol[:, None, None] * stress * float(dt)
    dpos = dpos * dx
    v_aff = v[None] + (C[None] * dpos[..., None, :]).sum(-1)
    mom = weight[..., None] * (m[None, :, None] * v_aff) + (
        stress_scaled[None] * dweight[..., None, :]).sum(-1) * act[None, :, None]
    vals = torch.cat([mom, (weight * m[None])[..., None]], dim=-1)
    return torch.where(in_bounds[..., None], vals, 0.0), flat


def p2g_plain(x, v, C, stress, mass, vol, active, cfg: MPMConfig, dt) -> torch.Tensor:
    """Plain PyTorch P2G: grid (G,G,G,4) = [momentum xyz, mass], by index_add_."""
    return scatter_to_grid(*p2g_contributions(x, v, C, stress, mass, vol, active, cfg, dt),
                           cfg.n_grid)


def scatter_to_grid(vals: torch.Tensor, flat: torch.Tensor, g: int) -> torch.Tensor:
    """Sum (27,N,4) node contributions into the (G,G,G,4) grid by index_add_."""
    grid = torch.zeros((g * g * g, 4), dtype=torch.float32, device=vals.device)
    grid.index_add_(0, flat.reshape(-1), vals.reshape(-1, 4))
    return grid.reshape(g, g, g, 4)


def bin_layout(n_grid: int) -> tuple[int, int]:
    """(bins a side, low bits) of the P2G bin keys: shifted base cells
    0..n_grid+1 in bins of P2G_BIN; the key (bin << low bits | low) of the
    last bin, nb^3 (no bin), must fit an int32, with room for the cell
    within the bin in the low bits."""
    nb = -(-(n_grid + 2) // P2G_BIN)
    hbits = 31 - (nb ** 3).bit_length()
    if hbits < _CELL_BITS:
        raise ValueError(f"n_grid {n_grid}: {nb ** 3} bins do not fit the int32 bin keys")
    return nb, hbits


def p2g_bin_keys_plain(x, active, n_grid: int, inv_dx: float) -> torch.Tensor:
    """(N,) int32 bin keys, as ``csrc/transfer.cu:p2g_keys_kernel`` makes
    them: (bin of the base cell + 2 in P2G_BIN^3 cells) << low bits | low,
    low the cell within the bin above the top bits of (index * 2654435761
    mod 2^32); nb^3 << low bits for inactive particles, non-finite positions
    and stencils with no in-grid node."""
    nb, hbits = bin_layout(n_grid)
    base = torch.floor(x * inv_dx - 0.5)
    ok = active & torch.isfinite(x).all(1) & ((base >= -2) & (base <= n_grid - 1)).all(1)
    b = torch.where(ok[:, None], base, 0.0).to(torch.int64) + 2
    bins = ((b[:, 0] // P2G_BIN) * nb + b[:, 1] // P2G_BIN) * nb + b[:, 2] // P2G_BIN
    cell = ((b[:, 0] % P2G_BIN) * P2G_BIN + b[:, 1] % P2G_BIN) * P2G_BIN + b[:, 2] % P2G_BIN
    hash_bits = hbits - _CELL_BITS
    low = (torch.arange(x.shape[0], device=x.device) * _HASH_MUL) % 2**32 >> (32 - hash_bits) \
        if hash_bits > 0 else torch.zeros_like(bins)
    keys = torch.where(ok, (bins << hbits) | (cell << hash_bits) | low, nb ** 3 << hbits)
    return keys.to(torch.int32)


def p2g_bin_keys(x, active, n_grid: int, inv_dx: float) -> torch.Tensor:
    """(N,) int32 bin keys of P2G: ``p2g_bin_keys_plain`` on CPU tensors,
    ``csrc/transfer.cu:p2g_keys_kernel`` on CUDA tensors (part of P2G, not
    counted apart)."""
    if x.device.type == "cpu":
        return p2g_bin_keys_plain(x, active, n_grid, inv_dx)
    if x.device.type != "cuda":
        raise ValueError(f"p2g bin keys: unsupported device {x.device}")
    n = x.shape[0]
    check_tensor("x", x, (n, 3), torch.float32, x.device)
    check_tensor("active", active, (n,), torch.bool, x.device)
    nb, hbits = bin_layout(n_grid)
    lib = _lib()
    keys = torch.empty((n,), dtype=torch.int32, device=x.device)
    code = lib.pixie_p2g_keys(x.data_ptr(), active.data_ptr(), keys.data_ptr(), n, n_grid,
                              inv_dx, nb, hbits, torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(lib, code, "p2g bin keys")
    return keys


def cell_order(x, active, cfg: MPMConfig) -> torch.Tensor:
    """(N,) int64 permutation of the particles by P2G bin key, so by cell
    (``torch.sort`` of ``p2g_bin_keys``): the order B1 splats in, into which
    the fused frame sorts its state."""
    return torch.sort(p2g_bin_keys(x, active, cfg.n_grid, cfg.inv_dx)).indices


def p2g(x, v, C, stress, mass, vol, active, cfg: MPMConfig, dt, return_order: bool = False):
    """Particle-to-grid scatter of momentum, mass and stress force.

    x, v (N,3); C, stress (N,3,3); mass, vol (N,); active (N,) bool
    (selection == 0).  Returns grid (G,G,G,4): [momentum x, y, z, mass],
    and with ``return_order`` also the cell order it splatted in (None on
    CPU tensors).  On CUDA: the key kernel, ``torch.sort`` of the keys, the
    binned splat.
    """
    if x.device.type == "cpu":
        grid = p2g_plain(x, v, C, stress, mass, vol, active, cfg, dt)
        return (grid, None) if return_order else grid
    if x.device.type != "cuda":
        raise ValueError(f"p2g: unsupported device {x.device}")
    global P2G_LAUNCHES
    n, g, dev, f32 = x.shape[0], cfg.n_grid, x.device, torch.float32
    for name, t, shape in (("x", x, (n, 3)), ("v", v, (n, 3)), ("C", C, (n, 3, 3)),
                           ("stress", stress, (n, 3, 3)), ("mass", mass, (n,)),
                           ("vol", vol, (n,))):
        check_tensor(name, t, shape, f32, dev)
    check_tensor("active", active, (n,), torch.bool, dev)
    nb, hbits = bin_layout(g)
    keys, perm = torch.sort(p2g_bin_keys(x, active, g, cfg.inv_dx))
    lib = _lib()
    grid = torch.zeros((g, g, g, 4), dtype=f32, device=dev)
    code = lib.pixie_p2g(keys.data_ptr(), perm.data_ptr(), x.data_ptr(), v.data_ptr(),
                         C.data_ptr(), stress.data_ptr(), mass.data_ptr(), vol.data_ptr(),
                         grid.data_ptr(), n, g, nb, hbits, cfg.dx, cfg.inv_dx, float(dt),
                         cfg.rpic_damping, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, code, "p2g")
    P2G_LAUNCHES += 1
    return (grid, perm) if return_order else grid


# -- G2P -----------------------------------------------------------------------

def _update_cov(cov6, grad_v, dt):
    """cov += dt (grad_v cov + cov grad_v^T) (mpm_utils.py:316-335)."""
    c = cov6
    cov = torch.stack([torch.stack([c[:, 0], c[:, 1], c[:, 2]], -1),
                       torch.stack([c[:, 1], c[:, 3], c[:, 4]], -1),
                       torch.stack([c[:, 2], c[:, 4], c[:, 5]], -1)], -2)
    gc = grad_v @ cov
    m = cov + dt * (gc + gc.transpose(-1, -2))
    return torch.stack([m[:, 0, 0], m[:, 0, 1], m[:, 0, 2],
                        m[:, 1, 1], m[:, 1, 2], m[:, 2, 2]], -1)


def g2p_plain(state: MPMState, grid_v, cfg: MPMConfig, dt) -> MPMState:
    """Plain PyTorch G2P; writes x, v, C, F_trial (and cov) in place."""
    g, inv_dx = cfg.n_grid, cfg.inv_dx
    weight, dweight, dpos, flat, in_bounds = _stencil(state.x, g, inv_dx)
    gv = grid_v.reshape(-1, 3)[flat]
    gv = torch.where(in_bounds[..., None], gv, 0.0)
    new_v = torch.sum(weight[..., None] * gv, dim=0)
    wgv = weight[..., None] * gv
    new_C = torch.sum(wgv[..., :, None] * dpos[..., None, :], dim=0) * (inv_dx * 4.0)
    grad_v = torch.sum(gv[..., :, None] * dweight[..., None, :], dim=0)
    x_new = state.x + float(dt) * new_v
    eye = torch.eye(3, dtype=torch.float32, device=state.x.device)
    F_trial_new = (eye[None] + grad_v * float(dt)) @ state.F

    am = (state.selection == 0)[:, None]
    amm = am[..., None]
    if cfg.update_cov_with_F:
        state.cov.copy_(torch.where(am, _update_cov(state.cov, grad_v, float(dt)), state.cov))
    state.v.copy_(torch.where(am, new_v, state.v))
    state.x.copy_(torch.where(am, x_new, state.x))
    state.C.copy_(torch.where(amm, new_C, state.C))
    state.F_trial.copy_(torch.where(amm, F_trial_new, state.F_trial))
    return state


def g2p(state: MPMState, grid_v: torch.Tensor, cfg: MPMConfig, dt) -> MPMState:
    """Grid-to-particle gather: v, APIC C (x 4 inv_dx), grad v, advection,
    F_trial = (I + dt grad v) F and, with ``cfg.update_cov_with_F``, the
    covariance transport, for particles with selection == 0.

    Updates ``state.x, v, C, F_trial, cov`` IN PLACE (the JAX version is
    functional; in place saves a copy of the particle arrays per substep)
    and returns ``state``.  Any particle order gives the same result; on
    CUDA a cell order (``cell_order``) is the fast one.
    """
    if state.x.device.type == "cpu":
        return g2p_plain(state, grid_v, cfg, dt)
    if state.x.device.type != "cuda":
        raise ValueError(f"g2p: unsupported device {state.x.device}")
    global G2P_LAUNCHES
    n, g, dev, f32 = state.n_particles, cfg.n_grid, state.x.device, torch.float32
    for name, shape in (("x", (n, 3)), ("v", (n, 3)), ("C", (n, 3, 3)), ("F", (n, 3, 3)),
                        ("F_trial", (n, 3, 3)), ("cov", (n, 6))):
        check_tensor(name, getattr(state, name), shape, f32, dev)
    check_tensor("selection", state.selection, (n,), torch.int32, dev)
    check_tensor("grid_v", grid_v, (g, g, g, 3), f32, dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.pixie_g2p(state.x.data_ptr(), state.v.data_ptr(), state.C.data_ptr(),
                         state.F.data_ptr(), state.F_trial.data_ptr(),
                         state.cov.data_ptr(), state.selection.data_ptr(),
                         grid_v.data_ptr(), n, g, cfg.inv_dx, float(dt),
                         int(cfg.update_cov_with_F), stream)
    raise_on_error(lib, code, "g2p")
    G2P_LAUNCHES += 1
    return state
