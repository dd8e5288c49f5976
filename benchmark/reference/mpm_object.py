"""Plain reference of the MLS-MPM substep that the object cell times: an
object of jelly, metal and stationary parts, pinned by velocity cuboids on
the grid, after a one-substep impulse.

Written from the published equations as PIXIE runs them (PhysGaussian's
MLS-MPM: quadratic B-splines, APIC transfer, the stress force through the
weights' gradients) in plain PyTorch at any dtype: float64 is the
reference, bfloat16 the control.  The B-spline stencil and the 3x3 SVD are
``reference/mpm.py``'s; this file adds what the scene cells leave out:

  * per-particle mu and lambda from E and nu;
  * jelly (id 0): fixed-corotated stress, no return mapping;
  * metal (id 1): the von Mises return mapping of the Hencky strain's
    singular values, then the StVK (Hencky) stress;
  * stationary (id 6): the stress of a weakly compressible fluid
    (gamma 1.1) on J = det F with the bulk modulus lambda + 2 mu / 3;
  * the particle impulse and the velocity cuboids on grid nodes, with
    their ``reset``.

Departures from the published description, each the published code's own
(mpm_utils.py, mpm_solver_warp.py):

  * "stationary" particles are not held still by their material: they take
    the fluid's stress (the solver's ``kirchhoff_stress_water`` branch for
    id 6), and the cuboid BCs on the grid pin them;
  * singular values are clamped at 0.01 before the logarithm (metal), and
    ``1e-6`` is added to the deviatoric strain's norm in the return mapping;
  * a cuboid with ``reset`` 1 zeroes the whole grid for 15 substeps after
    its end time;
  * the substep's clock is rounded to float32, as the published solver's.

The set-up (``setup``) is recomputed from the seeded inputs as PIXIE's
GS mode and material field define it (gs_simulation.py, material_field.py),
from the published settings the configuration leaves at their defaults:

  * the gaussians whose activated opacity passes the threshold, moved into
    the MPM cube: centred at their bounding box's midpoint, scaled by one
    over its largest extent, shifted by (1, 1, 1);
  * each particle's volume: its grid cell's volume over the particles in
    that cell;
  * the material field: the k nearest voxels of the source (by world
    distance); the material id is their most frequent (the lowest id on a
    tie), density, E and nu their plain means; a particle whose nearest
    voxel lies farther than ``nn_distance_threshold`` takes the stationary
    id and the source's means;
  * the ground cuboid: the particles' xy extent with 0.5 of margin, a slab
    0.05 thick at their lowest z;
  * the stationary cuboid: DBSCAN (eps 0.03, 8 points with the point
    itself) of the stationary particles; the largest cluster's bounding box
    with 0.1 of margin.  Clusters are the connected parts of the core
    points' neighbour graph, found by propagating each part's least index;
    a border point joins its core neighbours' least cluster.

The cuboid's node set is a predicate on float32 node positions (i dx) and
the float32 point and size the configuration gives, as the solver forms
it: computed in float64, a node on a face within a float32 rounding would
flip, and a BC's extent is a definition, not arithmetic under test.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.mpm import _det3, _stencil, svd3

JELLY, METAL, STATIONARY = 0, 1, 6


def lame(E: torch.Tensor, nu: torch.Tensor):
    """(mu, lambda) of Young's modulus and Poisson's ratio."""
    return E / (2.0 * (1.0 + nu)), E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))


def constitutive(st: dict, prm: dict) -> torch.Tensor:
    """Return mapping of F_trial (metal) and the Kirchhoff stress of the
    mapped F, by material; sets st["F"] and returns the stress (N,3,3).
    Any other id gets no stress."""
    ft, mat, mu, lam, ys = st["F_trial"], st["material"], st["mu"], st["lam"], st["ys"]
    u, s, v = svd3(ft)

    # metal: von Mises on the Hencky strain; F = U diag(s_new) V^T stays diagonal in U
    eps = torch.log(torch.clamp(s, min=0.01))
    tau = 2.0 * mu[:, None] * eps + lam[:, None] * eps.sum(1, keepdim=True)
    is_metal = mat == METAL
    yielding = is_metal & (torch.linalg.vector_norm(tau - tau.mean(1, keepdim=True), dim=1) > ys)
    eh = eps - eps.mean(1, keepdim=True)
    ehn = torch.linalg.vector_norm(eh, dim=1) + 1e-6
    dg = ehn - ys / (2.0 * mu)
    s_new = torch.where(yielding[:, None], torch.exp(eps - (dg / ehn)[:, None] * eh), s)
    f_new = (u * s_new[:, None, :]) @ v.transpose(1, 2)
    st["F"] = torch.where(yielding[:, None, None], f_new, ft)
    if prm["hardening"] == 1:
        st["ys"] = torch.where(yielding, ys + 2.0 * mu * prm["xi"] * dg, ys)

    # Kirchhoff stresses, diagonal in U: tau = U diag(t) U^T
    j = s_new.prod(1)
    t_fcr = 2.0 * mu[:, None] * (s_new - 1.0) * s_new + (lam * j * (j - 1.0))[:, None]
    e = torch.log(torch.clamp(s_new, min=0.01))
    t_stvk = (2.0 * mu[:, None] * e + lam[:, None] * e.sum(1, keepdim=True)) * s_new
    t = torch.where(is_metal[:, None], t_stvk, t_fcr)
    t = torch.where(((mat == JELLY) | is_metal)[:, None], t, torch.zeros_like(t))
    stress = (u * t[:, None, :]) @ u.transpose(1, 2)
    # stationary: p = -K (J^-1.1 - 1), tau = J p I with J of the unmapped F
    jf = _det3(ft)
    bulk = lam + 2.0 / 3.0 * mu
    p = -bulk * (torch.pow(torch.clamp(jf, min=1e-6), -1.1) - 1.0)
    eye = torch.eye(3, dtype=ft.dtype, device=ft.device)
    return torch.where((mat == STATIONARY)[:, None, None], (jf * p)[:, None, None] * eye, stress)


def cuboid_masks(cuboids, n_grid: int, grid_lim: float, device) -> list:
    """Each cuboid's node set (G^3,) bool, on float32 node positions (see the
    module's docstring); the cuboids do not move (velocity 0)."""
    idx = torch.arange(n_grid, dtype=torch.float32, device=device) * np.float32(grid_lim / n_grid)
    node = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)
    out = []
    for c in cuboids:
        assert not any(c["velocity"]), "a moving cuboid"
        point, size = (torch.tensor(c[k], dtype=torch.float32, device=device)
                       for k in ("point", "size"))
        out.append(((node - point).abs() < size).all(1))
    return out


def substep(st: dict, prm: dict, time: float, impulse: dict | None = None) -> None:
    """One MPM substep on ``st`` (x, v, C, F, F_trial, mu, lam, ys, mass,
    vol, material), in place: particle impulse, return mapping and stress,
    P2G, grid update with damping and the cuboids, G2P."""
    dt, g, dx, inv_dx = prm["dt"], prm["n_grid"], prm["dx"], prm["inv_dx"]
    dtype = st["x"].dtype
    f32 = np.float32
    if impulse is not None and impulse["start"] <= time < impulse["end"]:
        st["v"] = st["v"] + torch.where(impulse["mask"][:, None],
                                        impulse["force"] / st["mass"][:, None] * dt, 0.0)
    stress = constitutive(st, prm)
    weight, grad, dpos, flat, inside = _stencil(st["x"], g, inv_dx)
    w = torch.where(inside, weight, torch.zeros_like(weight))
    m, v, c = st["mass"], st["v"], st["C"]
    v_aff = v[:, None, :] + torch.einsum("nab,nkb->nka", c, dpos * dx)
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
    for c_bc, mask in zip(prm["cuboids"], prm["cuboid_masks"]):
        if f32(c_bc["start_time"]) <= f32(time) < f32(c_bc["end_time"]):
            gv = torch.where(mask[:, None], torch.zeros_like(gv), gv)
        elif c_bc["reset"] == 1 and f32(time) < f32(c_bc["end_time"]) + f32(15.0) * f32(dt):
            gv = torch.zeros_like(gv)

    nv = torch.where(inside[..., None], gv[flat], torch.zeros((), dtype=dtype, device=gv.device))
    wv = weight[..., None] * nv
    st["v"] = wv.sum(1)
    st["C"] = torch.einsum("nka,nkb->nab", wv, dpos) * (4.0 * inv_dx)
    grad_v = torch.einsum("nka,nkb->nab", nv, grad)
    st["x"] = st["x"] + dt * st["v"]
    eye = torch.eye(3, dtype=dtype, device=gv.device)
    st["F_trial"] = (eye + dt * grad_v) @ st["F"]


def params(cfg: dict, cuboids: list, device) -> dict:
    """Solver constants of an object configuration (``configs/*.json``, the
    class config's keys) and its cuboid BC dicts."""
    g, lim = int(cfg["n_grid"]), float(cfg["grid_lim"])
    return dict(dt=float(cfg["substep_dt"]), n_grid=g, dx=lim / g, inv_dx=g / lim,
                gravity=torch.tensor(cfg["g"], dtype=torch.float64, device=device),
                damping=float(cfg["grid_v_damping_scale"]),
                hardening=float(cfg.get("hardening", 0.0)), xi=float(cfg.get("xi", 0.0)),
                cuboids=cuboids, cuboid_masks=cuboid_masks(cuboids, g, lim, device))


def initial_state(x, material, density, E, nu, vol, dtype) -> dict:
    """Rest state of particles at x: v = 0, C = 0, F = F_trial = I, yield
    stress 0 (the class config sets none), Lame parameters from E and nu."""
    n = x.shape[0]
    mu, lam = lame(E.double(), nu.double())
    eye = torch.eye(3, dtype=dtype, device=x.device).repeat(n, 1, 1)
    return dict(x=x.to(dtype), v=torch.zeros((n, 3), dtype=dtype, device=x.device),
                C=torch.zeros((n, 3, 3), dtype=dtype, device=x.device), F=eye.clone(),
                F_trial=eye, mu=mu.to(dtype), lam=lam.to(dtype),
                ys=torch.zeros(n, dtype=dtype, device=x.device),
                mass=(density.double() * vol.double()).to(dtype), vol=vol.to(dtype),
                material=material)


def frame(st: dict, prm: dict, t0: float, n_substeps: int, impulse: dict | None = None) -> dict:
    """n_substeps substeps from time t0 (substep k at t0 + k dt, rounded to
    float32 as the published solver's clock)."""
    dt = np.float32(prm["dt"])
    for k in range(n_substeps):
        substep(st, prm, float(np.float32(np.float32(t0) + np.float32(k) * dt)), impulse)
    return st


# -- the set-up: the GS particles and the material field -----------------------------------

STATIONARY_EPS, STATIONARY_MIN_SAMPLES, STATIONARY_BUFFER = 0.03, 8, 0.1
GROUND_DELTA_Z, GROUND_BUFFER_XY = 0.05, 0.5


def _block(n_ref: int) -> int:
    """Query rows a block, so that a block's differences stay near 2**25 values."""
    return max(1, (1 << 25) // max(3 * n_ref, 1))


def knn_field(query, src_pos, src: dict, k: int, too_far: float, dtype) -> dict:
    """The material field on the particles at ``query`` (world units): the
    mode of the k nearest voxels' ``material_id``, the mean of their
    density, E and nu (see the module's docstring)."""
    ref_pos = src_pos.to(dtype)
    ids = src["material_id"].long()
    vals = {key: src[key].to(dtype) for key in ("density", "E", "nu")}
    mode, means, near = [], {key: [] for key in vals}, []
    n_cls = int(ids.max()) + 1
    step = _block(len(ref_pos))
    for a in range(0, len(query), step):
        q = query[a:a + step].to(dtype)
        d2 = ((q[:, None, :] - ref_pos[None, :, :]) ** 2).sum(-1)
        d2, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        votes = torch.zeros((len(q), n_cls), dtype=torch.int64, device=q.device)
        votes.scatter_add_(1, ids[idx], torch.ones_like(idx))
        mode.append(torch.argmax(votes, dim=1))
        for key, v in vals.items():
            means[key].append(v[idx].mean(1))
        near.append(d2[:, 0])
    far = torch.cat(near) > too_far ** 2
    out = {"material": torch.where(far, STATIONARY, torch.cat(mode))}
    for key, v in vals.items():
        out[key] = torch.where(far, v.mean(), torch.cat(means[key]))
    return out


def dbscan_largest(pts, eps: float, min_samples: int):
    """Mask of the largest DBSCAN cluster of ``pts`` (the least-numbered
    among equals); None if every point is noise."""
    n = len(pts)
    if n == 0:
        return None
    rows, cols = [], []
    step = _block(n)
    for a in range(0, n, step):
        d2 = ((pts[a:a + step, None, :] - pts[None, :, :]) ** 2).sum(-1)
        i, j = torch.nonzero(d2 <= eps * eps, as_tuple=True)
        keep = i + a != j
        rows.append(i[keep] + a)
        cols.append(j[keep])
    i, j = torch.cat(rows), torch.cat(cols)          # every neighbour pair, both ways
    core = torch.bincount(i, minlength=n) + 1 >= min_samples
    both = core[i] & core[j]
    ci, cj = i[both], j[both]
    label = torch.arange(n, device=pts.device)
    while True:                                      # each part's least index
        new = label.clone().scatter_reduce_(0, ci, label[cj], "amin")
        if torch.equal(new, label):
            break
        label = new
    border = ~core[i] & core[j]
    none = torch.full((n,), n, dtype=label.dtype, device=pts.device)
    reach = none.scatter_reduce(0, i[border], label[j[border]], "amin")
    label = torch.where(core, label, torch.where(reach < n, reach, -1))
    if not bool((label >= 0).any()):
        return None
    ids, sizes = torch.unique(label[label >= 0], return_counts=True)
    return label == ids[torch.argmax(sizes)]


def setup(xyz, opacity_logit, src: dict, cfg: dict, dtype) -> dict:
    """The particles and the material field of an object configuration from
    its seeded inputs: ``xyz`` (M,3) and ``opacity_logit`` (M,) of the
    gaussians, ``src`` the material source (``mapped_preds.ply``'s schema),
    all tensors on one device.
    Returns x (in the MPM cube), vol, material, density, E, nu, and
    ``cuboids``: the ground's and the stationary cluster's point and size,
    in that order."""
    assert not any(cfg.get("rotation_degree", [])), "a rotated object"
    assert cfg.get("fix_ground", True), "an object without its ground cuboid"
    keep = torch.sigmoid(opacity_logit.double()) > float(cfg["opacity_threshold"])
    world = xyz[keep].to(dtype)
    lo, hi = world.min(0).values, world.max(0).values
    x = (world - (lo + hi) / 2.0) / (hi - lo).max() + 1.0

    g, lim = int(cfg["n_grid"]), float(cfg["grid_lim"])
    dx = lim / g
    cell = torch.clamp(torch.floor(x / dx).long(), 0, g - 1)
    flat = (cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]
    per_cell = torch.bincount(flat, minlength=g ** 3)
    vol = dx ** 3 / per_cell[flat].to(dtype)

    field = knn_field(world, src["pos"], src, int(cfg["k_smoothing_neighbors"]),
                      float(cfg.get("nn_distance_threshold", 0.1)), dtype)

    lo, hi = x.min(0).values, x.max(0).values
    cuboids = [{"type": "ground",
                "point": torch.stack([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2,
                                      lo[2] + GROUND_DELTA_Z / 2]),
                "size": torch.stack([(hi[0] - lo[0]) / 2 + GROUND_BUFFER_XY,
                                     (hi[1] - lo[1]) / 2 + GROUND_BUFFER_XY,
                                     torch.tensor(GROUND_DELTA_Z / 2, dtype=dtype,
                                                  device=x.device)])}]
    still = x[field["material"] == STATIONARY]
    largest = dbscan_largest(still, STATIONARY_EPS, STATIONARY_MIN_SAMPLES)
    if largest is not None:
        pts = still[largest]
        lo, hi = pts.min(0).values, pts.max(0).values
        cuboids.append({"type": "stationary_cluster", "point": (lo + hi) / 2,
                        "size": (hi - lo) / 2 + STATIONARY_BUFFER})
    return dict(x=x, vol=vol, cuboids=cuboids, **field)
