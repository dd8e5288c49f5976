"""Plain reference of the MLS-MPM substep that the scene cells time.

Written from the published equations (PhysGaussian's MLS-MPM as PIXIE runs
it: quadratic B-splines, APIC transfer, the stress force through the
weights' gradients, a sticky half-space collider on the grid), in plain
PyTorch at any dtype: float64 is the reference, bfloat16 the control.  It
imports nothing of the program.

The constitutive pass works on one SVD a substep, F_trial = U diag(s) V^T
with U and V proper rotations and the smallest singular value carrying
sign(det F): each return mapping maps the singular values, and the
Kirchhoff stresses of the three materials are diagonal in U (tau =
U diag(t) U^T), so the mapped F needs no second SVD.  The SVD is a cyclic
Jacobi eigen-decomposition of F^T F, enough sweeps to converge in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAND, VISPLAS, SNOW = 2, 3, 5

_PAIRS = ((0, 1), (0, 2), (1, 2))


def _sym_eig(a: torch.Tensor, sweeps: int):
    """Eigenvalues (N,3) and eigenvectors (columns, N,3,3) of symmetric (N,3,3)."""
    a = a.clone()
    v = torch.eye(3, dtype=a.dtype, device=a.device).repeat(a.shape[0], 1, 1)
    tiny = torch.finfo(a.dtype).tiny
    for _ in range(sweeps):
        for p, q in _PAIRS:
            apq, app, aqq = a[:, p, q], a[:, p, p], a[:, q, q]
            off = apq.abs() > tiny
            theta = (aqq - app) / (2.0 * torch.where(off, apq, torch.ones_like(apq)))
            t = torch.sign(theta) / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(theta == 0, torch.ones_like(t), t)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            c = torch.where(off, c, torch.ones_like(c))
            s = torch.where(off, s, torch.zeros_like(s))
            # a <- J^T a J, v <- v J with J the rotation in the (p, q) plane
            ap, aq = a[:, :, p].clone(), a[:, :, q].clone()
            a[:, :, p] = c[:, None] * ap - s[:, None] * aq
            a[:, :, q] = s[:, None] * ap + c[:, None] * aq
            ap, aq = a[:, p, :].clone(), a[:, q, :].clone()
            a[:, p, :] = c[:, None] * ap - s[:, None] * aq
            a[:, q, :] = s[:, None] * ap + c[:, None] * aq
            vp, vq = v[:, :, p].clone(), v[:, :, q].clone()
            v[:, :, p] = c[:, None] * vp - s[:, None] * vq
            v[:, :, q] = s[:, None] * vp + c[:, None] * vq
    return torch.diagonal(a, dim1=1, dim2=2), v


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
            - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
            + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]))


def svd3(f: torch.Tensor, sweeps: int = 6):
    """F = U diag(s) V^T, s sorted by decreasing magnitude, U and V proper
    rotations, s[:, 2] carrying the sign of det F."""
    w, v = _sym_eig(f.transpose(1, 2) @ f, sweeps)
    order = torch.argsort(w, dim=1, descending=True)
    w = torch.gather(w, 1, order)
    v = torch.gather(v, 2, order[:, None, :].expand(-1, 3, -1))
    v = torch.where((_det3(v) < 0)[:, None, None],
                    v * torch.tensor([1.0, 1.0, -1.0], dtype=v.dtype, device=v.device), v)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    fv = f @ v
    u0 = fv[:, :, 0] / torch.clamp(torch.linalg.vector_norm(fv[:, :, 0], dim=1), min=1e-30)[:, None]
    u1 = fv[:, :, 1] - (u0 * fv[:, :, 1]).sum(1, keepdim=True) * u0
    u1 = u1 / torch.clamp(torch.linalg.vector_norm(u1, dim=1), min=1e-30)[:, None]
    u2 = torch.linalg.cross(u0, u1, dim=1)
    u = torch.stack([u0, u1, u2], dim=2)
    s2 = (fv[:, :, 2] * u2).sum(1)     # signed: negative where det F < 0
    return u, torch.stack([s[:, 0], s[:, 1], s2], dim=1), v


def sand_alpha(friction_angle: float) -> float:
    """Drucker-Prager alpha of the friction angle in degrees (the published
    code converts with 3.14159265)."""
    sin_phi = math.sin(friction_angle / 180.0 * 3.14159265)
    return math.sqrt(2.0 / 3.0) * 2.0 * sin_phi / (3.0 - sin_phi)


def constitutive(st: dict, prm: dict):
    """Return mapping of F_trial and the Kirchhoff stress of the mapped F,
    for sand (Drucker-Prager), plasticine (viscoplastic StVK) and snow (von
    Mises with softening).  Updates st["F"], st["mu"], st["lam"], st["ys"];
    returns the stress (N,3,3)."""
    ft, mat = st["F_trial"], st["material"]
    mu, lam, ys = st["mu"], st["lam"], st["ys"]
    u, s, v = svd3(ft)
    one = torch.ones_like(s)
    keep = torch.zeros_like(mu, dtype=torch.bool)   # F = F_trial exactly
    s_new = s.clone()

    # sand: project log-strain onto the Drucker-Prager cone
    eps = torch.log(torch.clamp(s.abs(), min=1e-14))
    tr = eps.sum(1)
    eh = eps - (tr / 3.0)[:, None]
    ehn = torch.linalg.vector_norm(eh, dim=1)
    dg = ehn + (3.0 * lam + 2.0 * mu) / (2.0 * mu) * tr * prm["alpha"]
    h = eps - eh * (dg / torch.clamp(ehn, min=1e-12))[:, None]
    sand_s = torch.where((tr > 0)[:, None], one, torch.exp(h))
    is_sand = mat == SAND
    s_new = torch.where((is_sand & (dg > 0))[:, None], sand_s, s_new)
    keep = keep | (is_sand & (dg <= 0))

    # plasticine: viscoplastic StVK (radial return of the deviatoric Hencky strain)
    sc = torch.clamp(s, min=0.01)
    eps = torch.log(sc)
    tr = eps.sum(1)
    eh = eps - (tr / 3.0)[:, None]
    st_n = torch.linalg.vector_norm(2.0 * mu[:, None] * eh, dim=1)
    y = st_n - math.sqrt(2.0 / 3.0) * ys
    mu_hat = mu * (sc * sc).mean(1)
    s_norm = st_n - y / (1.0 + prm["plastic_viscosity"] / (2.0 * torch.clamp(mu_hat, min=1e-12)
                                                            * prm["dt"]))
    eps_new = (s_norm / torch.clamp(st_n, min=1e-12))[:, None] * eh + (tr / 3.0)[:, None]
    is_vp = mat == VISPLAS
    s_new = torch.where((is_vp & (y > 0))[:, None], torch.exp(eps_new), s_new)
    keep = keep | (is_vp & (y <= 0))

    # snow: von Mises with softening; a yield stress of 0 is fully damaged (elastic)
    tau = 2.0 * mu[:, None] * eps + lam[:, None] * tr[:, None]
    over = torch.linalg.vector_norm(tau - tau.mean(1, keepdim=True), dim=1) > ys
    is_snow = mat == SNOW
    yielding = is_snow & over & (ys > 0)
    ehn = torch.linalg.vector_norm(eh, dim=1) + 1e-6
    dgs = ehn - ys / (2.0 * mu)
    corr = (dgs / ehn)[:, None] * eh
    ys_soft = ys - prm["softening"] * torch.linalg.vector_norm(corr, dim=1)
    damaged = yielding & (ys_soft <= 0)
    mu = torch.where(damaged, torch.zeros_like(mu), mu)
    lam = torch.where(damaged, torch.zeros_like(lam), lam)
    ys_new = torch.where(yielding, ys_soft, ys)
    if prm["hardening"] == 1:
        ys_new = torch.where(yielding, ys_new + 2.0 * mu * prm["xi"] * dgs, ys_new)
    s_new = torch.where(yielding[:, None], torch.exp(eps - corr), s_new)
    keep = keep | (is_snow & ~yielding)

    f_new = (u * s_new[:, None, :]) @ v.transpose(1, 2)
    st["F"] = torch.where(keep[:, None, None], ft, f_new)
    st["mu"], st["lam"], st["ys"] = mu, lam, ys_new

    # Kirchhoff stresses, diagonal in U: tau = U diag(t) U^T
    j = s_new.prod(1)
    t_fcr = 2.0 * mu[:, None] * (s_new - 1.0) * s_new + (lam * j * (j - 1.0))[:, None]
    e_vp = torch.log(torch.clamp(s_new, min=0.01))
    t_vp = (2.0 * mu[:, None] * e_vp + lam[:, None] * e_vp.sum(1, keepdim=True)) * s_new
    e_dp = torch.log(s_new)
    t_dp = 2.0 * mu[:, None] * e_dp + lam[:, None] * e_dp.sum(1, keepdim=True)
    # the scene's three materials only: any other id gets no stress
    t = torch.where(is_sand[:, None], t_dp, torch.where(is_vp[:, None], t_vp, t_fcr))
    t = torch.where((is_sand | is_vp | is_snow)[:, None], t, torch.zeros_like(t))
    return (u * t[:, None, :]) @ u.transpose(1, 2)


def _stencil(x: torch.Tensor, n_grid: int, inv_dx: float):
    """Quadratic B-spline stencil of each particle: weights (N,27), their
    gradients (N,27,3), x_i - x_p in cells (N,27,3), flat node (N,27),
    in-grid mask (N,27)."""
    gp = x * inv_dx
    base = torch.floor(gp - 0.5)
    fx = gp - base
    w = torch.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2], 1)
    dw = torch.stack([fx - 1.5, -2.0 * (fx - 1.0), fx - 0.5], 1)
    r = torch.arange(3, device=x.device)
    oi, oj, ok = torch.meshgrid(r, r, r, indexing="ij")
    off = torch.stack([oi.reshape(-1), oj.reshape(-1), ok.reshape(-1)], 1)      # (27, 3)
    wa = [w[:, off[:, a], a] for a in range(3)]                                  # (N, 27) each
    dwa = [dw[:, off[:, a], a] for a in range(3)]
    weight = wa[0] * wa[1] * wa[2]
    grad = torch.stack([dwa[0] * wa[1] * wa[2], wa[0] * dwa[1] * wa[2],
                        wa[0] * wa[1] * dwa[2]], -1) * inv_dx
    dpos = off[None].to(x.dtype) - fx[:, None, :]
    node = base.long()[:, None, :] + off[None]
    inside = ((node >= 0) & (node < n_grid)).all(-1)
    node = node.clamp(0, n_grid - 1)
    flat = (node[..., 0] * n_grid + node[..., 1]) * n_grid + node[..., 2]
    return weight, grad, dpos, flat, inside


def substep(st: dict, prm: dict, time: float, impulse: dict | None = None) -> None:
    """One MPM substep on the state dict ``st`` (x, v, C, F, F_trial, mu,
    lam, ys, mass, vol, material), in place: particle impulse, return
    mapping and stress, P2G, grid update with gravity, damping and the
    sticky collider, G2P."""
    dt, g, dx, inv_dx = prm["dt"], prm["n_grid"], prm["dx"], prm["inv_dx"]
    dtype = st["x"].dtype
    if impulse is not None and impulse["start"] <= time < impulse["end"]:
        st["v"] = st["v"] + torch.where(impulse["mask"][:, None],
                                        impulse["force"] / st["mass"][:, None] * dt, 0.0)
    stress = constitutive(st, prm)
    weight, grad, dpos, flat, inside = _stencil(st["x"], g, inv_dx)
    w = torch.where(inside, weight, torch.zeros_like(weight))
    m, v, c = st["mass"], st["v"], st["C"]
    v_aff = v[:, None, :] + torch.einsum("nab,nkb->nka", c, dpos * dx)          # (N,27,3)
    force = torch.einsum("nab,nkb->nka", -(st["vol"] * dt)[:, None, None] * stress, grad)
    mom = (w * m[:, None])[..., None] * v_aff + torch.where(inside[..., None], force, 0.0)
    vals = torch.cat([mom, (w * m[:, None])[..., None]], -1)
    grid = torch.zeros((g * g * g, 4), dtype=dtype, device=st["x"].device)
    grid.index_add_(0, flat.reshape(-1), vals.reshape(-1, 4))

    gm = grid[:, 3:]
    has = gm > 1e-15
    gv = grid[:, :3] / torch.where(has, gm, torch.ones_like(gm))
    gv = gv + dt * prm["gravity"].to(dtype)
    gv = torch.where(has, gv, torch.zeros_like(gv))
    if prm["damping"] < 1.0:
        gv = gv * prm["damping"]
    node_x = prm["node_x"].to(dtype)
    below = ((node_x - prm["collider_point"].to(dtype)) * prm["collider_normal"].to(dtype)).sum(1) < 0
    gv = torch.where(below[:, None], torch.zeros_like(gv), gv)

    nv = torch.where(inside[..., None], gv[flat], torch.zeros((), dtype=dtype, device=gv.device))
    wv = weight[..., None] * nv                                                  # (N,27,3)
    st["v"] = wv.sum(1)
    st["C"] = torch.einsum("nka,nkb->nab", wv, dpos) * (4.0 * inv_dx)
    grad_v = torch.einsum("nka,nkb->nab", nv, grad)
    st["x"] = st["x"] + dt * st["v"]
    eye = torch.eye(3, dtype=dtype, device=gv.device)
    st["F_trial"] = (eye + dt * grad_v) @ st["F"]


def params(cfg: dict, device) -> dict:
    """Solver constants of a scene configuration (``configs/*.json``)."""
    g, lim = int(cfg["n_grid"]), float(cfg["grid_lim"])
    idx = torch.arange(g, dtype=torch.float64, device=device) * (lim / g)
    node_x = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)
    col = cfg["collider"]
    normal = torch.tensor(col["normal"], dtype=torch.float64, device=device)
    return dict(dt=float(cfg["substep_dt"]), n_grid=g, dx=lim / g, inv_dx=g / lim,
                gravity=torch.tensor(cfg["gravity"], dtype=torch.float64, device=device),
                damping=float(cfg["grid_v_damping_scale"]), alpha=sand_alpha(cfg["friction_angle"]),
                softening=float(cfg["softening"]), hardening=float(cfg["hardening"]),
                xi=float(cfg["xi"]), plastic_viscosity=float(cfg["plastic_viscosity"]),
                node_x=node_x, collider_point=torch.tensor(col["point"], dtype=torch.float64,
                                                           device=device),
                collider_normal=normal / torch.linalg.vector_norm(normal))


def initial_state(x, material, density, E, nu, ys, vol, dtype) -> dict:
    """Rest state of particles at x: v = 0, C = 0, F = F_trial = I, Lame
    parameters from E and nu."""
    n = x.shape[0]
    E, nu = E.double(), nu.double()
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    eye = torch.eye(3, dtype=dtype, device=x.device).repeat(n, 1, 1)
    return dict(x=x.to(dtype), v=torch.zeros((n, 3), dtype=dtype, device=x.device),
                C=torch.zeros((n, 3, 3), dtype=dtype, device=x.device), F=eye.clone(),
                F_trial=eye, mu=mu.to(dtype), lam=lam.to(dtype), ys=ys.to(dtype),
                mass=(density * vol).to(dtype), vol=vol.to(dtype), material=material)


def frame(st: dict, prm: dict, t0: float, n_substeps: int, impulse: dict | None = None) -> dict:
    """n_substeps substeps from time t0 (substep k at t0 + k dt, rounded to
    float32 as the published solver's clock)."""
    dt = np.float32(prm["dt"])
    for k in range(n_substeps):
        substep(st, prm, float(np.float32(np.float32(t0) + np.float32(k) * dt)), impulse)
    return st
