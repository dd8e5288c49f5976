"""Constitutive models: Kirchhoff stresses and plastic return mappings
(port of pixie_tpu/sim/constitutive.py; reference mpm_utils.py:10-279).

Batched (N, ...) tensor functions.  Conventions as the reference:
singular values clamped at 0.01 before log (StVK / von Mises), von Mises
yield on the deviatoric Kirchhoff norm, Drucker-Prager sand, weakly
compressible water (gamma 1.1), final stress symmetrized.
"""

from __future__ import annotations

import torch

from pixie_tpu_torch.sim.svd3 import det3, diag_mm_nt, matmul_nt, svd3
from pixie_tpu_torch.sim.types import MPMConfig, MPMState


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


# -- Kirchhoff stresses (tau = P F^T) -----------------------------------------

def kirchhoff_stress_fcr(F, u, v, J, mu, lam):
    """Fixed corotated (mpm_utils.py:10-17)."""
    R = matmul_nt(u, v)
    FmR_Ft = matmul_nt(F - R, F)
    return (2.0 * mu[:, None, None] * FmR_Ft
            + _eye(F) * (lam * J * (J - 1.0))[:, None, None])


def kirchhoff_stress_stvk(F, u, v, sig, mu, lam):
    """StVK with Hencky strain (mpm_utils.py:52-68)."""
    sig = torch.clamp(sig, min=0.01)
    eps = torch.log(sig)
    log_sum = eps.sum(-1, keepdim=True)
    tau = 2.0 * mu[:, None] * eps + lam[:, None] * log_sum
    return matmul_nt(diag_mm_nt(u, tau, v), F)


def kirchhoff_stress_drucker_prager(F, u, v, sig, mu, lam):
    """Drucker-Prager sand stress (mpm_utils.py:71-86)."""
    log_sig = torch.log(sig)
    log_sum = log_sig.sum(-1, keepdim=True)
    center = (2.0 * mu[:, None] * log_sig + lam[:, None] * log_sum) / sig
    return matmul_nt(diag_mm_nt(u, center, v), F)


def kirchhoff_stress_water(J, bulk):
    """Weakly compressible fluid, gamma=1.1 (mpm_utils.py:20-28)."""
    gamma = 1.1
    pressure = -bulk * (torch.pow(torch.clamp(J, min=1e-6), -gamma) - 1.0)
    return torch.eye(3, dtype=J.dtype, device=J.device) * (J * pressure)[:, None, None]


# -- return mappings ---------------------------------------------------------

def von_mises_return_mapping(F_trial, u, sig_old, v, mu, lam, yield_stress,
                             hardening, xi):
    """Metal plasticity (mpm_utils.py:89-135)."""
    sig = torch.clamp(sig_old, min=0.01)
    eps = torch.log(sig)
    temp = eps.mean(-1, keepdim=True)
    tau = 2.0 * mu[:, None] * eps + lam[:, None] * eps.sum(-1, keepdim=True)
    cond = tau - tau.mean(-1, keepdim=True)
    yielding = torch.linalg.vector_norm(cond, dim=-1) > yield_stress

    eps_hat = eps - temp
    eps_hat_norm = torch.linalg.vector_norm(eps_hat, dim=-1) + 1e-6
    delta_gamma = eps_hat_norm - yield_stress / (2.0 * mu)
    eps_proj = eps - (delta_gamma / eps_hat_norm)[:, None] * eps_hat
    F_elastic = diag_mm_nt(u, torch.exp(eps_proj), v)

    F_new = torch.where(yielding[:, None, None], F_elastic, F_trial)
    if hardening == 1:
        ys_new = torch.where(yielding, yield_stress + 2.0 * mu * xi * delta_gamma,
                             yield_stress)
    else:
        ys_new = yield_stress
    return F_new, ys_new


def von_mises_return_mapping_with_damage(F_trial, u, sig_old, v, mu, lam,
                                         yield_stress, hardening, xi, softening):
    """Snow: von Mises + softening damage (mpm_utils.py:138-191)."""
    sig = torch.clamp(sig_old, min=0.01)
    eps = torch.log(sig)
    temp = eps.mean(-1, keepdim=True)
    tau = 2.0 * mu[:, None] * eps + lam[:, None] * eps.sum(-1, keepdim=True)
    cond = tau - tau.mean(-1, keepdim=True)
    over_yield = torch.linalg.vector_norm(cond, dim=-1) > yield_stress
    yielding = over_yield & (yield_stress > 0)  # fully damaged -> elastic

    eps_hat = eps - temp
    eps_hat_norm = torch.linalg.vector_norm(eps_hat, dim=-1) + 1e-6
    delta_gamma = eps_hat_norm - yield_stress / (2.0 * mu)
    corr = (delta_gamma / eps_hat_norm)[:, None] * eps_hat
    eps_proj = eps - corr
    F_elastic = diag_mm_nt(u, torch.exp(eps_proj), v)

    ys_soft = yield_stress - softening * torch.linalg.vector_norm(corr, dim=-1)
    damaged = ys_soft <= 0
    mu_new = torch.where(yielding & damaged, 0.0, mu)
    lam_new = torch.where(yielding & damaged, 0.0, lam)
    ys_new = torch.where(yielding, ys_soft, yield_stress)
    if hardening == 1:
        ys_new = torch.where(yielding, ys_new + 2.0 * mu_new * xi * delta_gamma, ys_new)
    F_new = torch.where(yielding[:, None, None], F_elastic, F_trial)
    return F_new, ys_new, mu_new, lam_new


def viscoplasticity_return_mapping_stvk(F_trial, u, sig_old, v, mu, lam,
                                        yield_stress, plastic_viscosity, dt):
    """Viscoplastic StVK (mpm_utils.py:195-239)."""
    sig = torch.clamp(sig_old, min=0.01)
    b_trial = sig * sig
    eps = torch.log(sig)
    trace_eps = eps.sum(-1, keepdim=True)
    eps_hat = eps - trace_eps / 3.0
    s_trial = 2.0 * mu[:, None] * eps_hat
    s_trial_norm = torch.linalg.vector_norm(s_trial, dim=-1)
    y = s_trial_norm - (2.0 / 3.0) ** 0.5 * yield_stress
    yielding = y > 0

    mu_hat = mu * b_trial.mean(-1)
    s_new_norm = s_trial_norm - y / (
        1.0 + plastic_viscosity / (2.0 * torch.clamp(mu_hat, min=1e-12) * dt))
    s_new = (s_new_norm / torch.clamp(s_trial_norm, min=1e-12))[:, None] * s_trial
    eps_new = s_new / (2.0 * mu[:, None]) + trace_eps / 3.0
    F_elastic = diag_mm_nt(u, torch.exp(eps_new), v)
    return torch.where(yielding[:, None, None], F_elastic, F_trial)


def sand_return_mapping(F_trial, u, sig, v, mu, lam, alpha):
    """Drucker-Prager sand (mpm_utils.py:242-279)."""
    eps = torch.log(torch.clamp(sig.abs(), min=1e-14))
    tr = eps.sum(-1)
    eps_hat = eps - (tr / 3.0)[:, None]
    eps_hat_norm = torch.linalg.vector_norm(eps_hat, dim=-1)
    delta_gamma = eps_hat_norm + (3.0 * lam + 2.0 * mu) / (2.0 * mu) * tr * alpha

    F_case2 = matmul_nt(u, v)  # expansion -> project to rotation
    h = eps - eps_hat * (delta_gamma / torch.clamp(eps_hat_norm, min=1e-12))[:, None]
    F_case3 = diag_mm_nt(u, torch.exp(h), v)  # compaction -> yield surface
    return torch.where(
        (delta_gamma <= 0)[:, None, None],
        F_trial,
        torch.where((tr > 0)[:, None, None], F_case2, F_case3),
    )


# -- combined: return map + stress (mpm_utils.py:466-526) ---------------------

def compute_stress_from_F_trial(state: MPMState, cfg: MPMConfig, dt) -> MPMState:
    """Material-dependent return mapping of F_trial, then the Kirchhoff stress
    of the result.  Branches for materials absent from ``cfg.active_materials``
    are skipped.  Ids 4 (fluid) and 7 (background) match no branch and get
    zero stress, exactly as in the JAX code; id 6 takes the water stress (a
    reference quirk kept for parity, constitutive.py:256-262)."""
    mat = state.material
    F_trial = state.F_trial
    mu, lam, ys = state.mu, state.lam, state.yield_stress
    active_set = cfg.active_materials

    F = F_trial
    mu_new, lam_new, ys_new = mu, lam, ys
    if cfg.needs_return_mapping():
        u_t, sig_t, v_t = svd3(F_trial)
        if 1 in active_set:
            F_vm, ys_vm = von_mises_return_mapping(
                F_trial, u_t, sig_t, v_t, mu, lam, ys, cfg.hardening, cfg.xi)
            sel = mat == 1
            F = torch.where(sel[:, None, None], F_vm, F)
            ys_new = torch.where(sel, ys_vm, ys_new)
        if 2 in active_set:
            F_sand = sand_return_mapping(F_trial, u_t, sig_t, v_t, mu, lam, cfg.alpha)
            F = torch.where((mat == 2)[:, None, None], F_sand, F)
        if 3 in active_set:
            F_vp = viscoplasticity_return_mapping_stvk(
                F_trial, u_t, sig_t, v_t, mu, lam, ys, cfg.plastic_viscosity, dt)
            F = torch.where((mat == 3)[:, None, None], F_vp, F)
        if 5 in active_set:
            F_sn, ys_sn, mu_sn, lam_sn = von_mises_return_mapping_with_damage(
                F_trial, u_t, sig_t, v_t, mu, lam, ys,
                cfg.hardening, cfg.xi, cfg.softening)
            sel = mat == 5
            F = torch.where(sel[:, None, None], F_sn, F)
            ys_new = torch.where(sel, ys_sn, ys_new)
            mu_new = torch.where(sel, mu_sn, mu_new)
            lam_new = torch.where(sel, lam_sn, lam_new)

    J = det3(F)
    u, sig, v = svd3(F)

    stress = torch.zeros_like(F)
    if 0 in active_set or 5 in active_set or 6 in active_set:
        s_fcr = kirchhoff_stress_fcr(F, u, v, J, mu_new, lam_new)
        stress = torch.where(((mat == 0) | (mat == 5))[:, None, None], s_fcr, stress)
    if 1 in active_set or 3 in active_set:
        s_stvk = kirchhoff_stress_stvk(F, u, v, sig, mu_new, lam_new)
        stress = torch.where(((mat == 1) | (mat == 3))[:, None, None], s_stvk, stress)
    if 2 in active_set:
        s_dp = kirchhoff_stress_drucker_prager(F, u, v, sig, mu_new, lam_new)
        stress = torch.where((mat == 2)[:, None, None], s_dp, stress)
    if 6 in active_set:
        s_w = kirchhoff_stress_water(J, state.bulk)
        stress = torch.where((mat == 6)[:, None, None], s_w, stress)

    stress = 0.5 * (stress + stress.transpose(-1, -2))

    active = state.selection == 0
    a1, a3 = active, active[:, None, None]
    return state.replace(
        F=torch.where(a3, F, state.F),
        stress=torch.where(a3, stress, state.stress),
        yield_stress=torch.where(a1, ys_new, state.yield_stress),
        mu=torch.where(a1, mu_new, state.mu),
        lam=torch.where(a1, lam_new, state.lam),
    )
