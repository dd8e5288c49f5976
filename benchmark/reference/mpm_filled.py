"""Plain reference of the filled sand object that ``sand_castle.rollout``
times: a 3DGS of an object's surface, filled inside with particles, then
sand (Drucker-Prager) on a grid with a bounding box, a sticky collider and
the ground cuboid.

Written from the published code (PhysGaussian's particle_filling/filling.py
and MLS-MPM as PIXIE runs it) in plain PyTorch at any dtype: float64 is the
reference, bfloat16 the control.  It imports nothing of the program.  The
B-spline stencil is ``reference/mpm.py``'s, and its SVD and Drucker-Prager
return map are restated here (``svd3``, ``sand_constitutive``) with each
matrix entry a contiguous vector and no batched matmul: the same
arithmetic, a few times faster on a card for the 2,000 substeps of a
frame.  The kNN material field, the ground cuboid, DBSCAN and the cuboids'
node sets are ``reference/mpm_object.py``'s.  This file adds:

  * the filling (``fill``): the count grid and the gaussian density grid
    of densify_grids, each gaussian splatting onto the cells within its
    own radius (ceil of its largest standard deviation over dx) with the
    mean of its weight at the cell's 8 corners; the dense cells below the
    per-cell cap (fill_dense_grids); the internal cells of internal_filling:
    an empty cell whose ray walk along each of the five directions other
    than ``search_exclude_direction`` meets an occupied cell (density above
    ``search_threshold``), and whose walk along ``ray_cast_direction``
    counts an odd number of entries into occupied cells; then the emission
    and the budget;
  * the uniform volume of sand (get_particle_volume with ``uniform``): the
    mean of the per-cell volumes (a cell's volume over its particles);
  * Drucker-Prager on per-particle mu and lambda (``reference/mpm.py``'s
    return map; an id other than sand, plasticine or snow takes
    ``reference/mpm_object.py``'s constitutive model);
  * the grid BCs in the solver's order: the ground cuboid, the bounding
    box (outward velocity zeroed within 3 nodes of each face) and the
    sticky half-space collider.

Departures from the published filling, each as both packages run it:

  * the grid and ``boundary``: the published fill_particles crops the
    gaussians to ``boundary`` and lays its grid over that box (dx its
    largest side over n_grid, the origin at its low corner); the packages
    lay the grid over [0, grid_lim)^3 with dx = grid_lim / n_grid and use
    ``boundary`` only to keep the internal cells whose low corner lies in
    the box.  The reference follows the packages;
  * ``smooth`` is ignored (the published code smooths the density grid
    with mcubes before the internal fill);
  * order: the published kernels emit in the order their threads' atomics
    land; the reference emits the surface cells, then the internal cells,
    each in C order, and draws the jitter from ``np.random.default_rng(0)``
    in that order, as the program does, so that positions compare one to
    one (``fill_jitter``);
  * the budget: the published buffer holds ``max_particles_num`` new
    particles; the packages keep ``max_particles_num`` less the gaussians,
    a random subset (``permutation`` of the same generator) where more
    were emitted;
  * a position outside the grid is clamped into it (the published code
    indexes past it).

One departure from the published dynamics: the stress of sand is taken
from the return map's own U, V and singular values, where the published
code (and the program) take a fresh svd3 of the returned F.  The two agree
in exact arithmetic and in float64; in float32 the fresh SVD of an
expanding particle's rotation U V^T gives singular values off 1 by
float32's rounding, which mu and lambda (~2e7 Pa) turn into a stress, so
a float32 run of the published code strays from this reference by several
times the reference's own float32 rounding over a 2,000-substep frame.

The set-up (``setup``) is recomputed from the seeded inputs as PIXIE's GS
mode defines it (gs_simulation.py): the gaussians past the opacity
threshold moved into the MPM cube (``reference/mpm_object.py``'s
transform), their covariances R S S^T R^T scaled into it, the filling, the
uniform volumes, the kNN material field of every particle, the ground
cuboid.  The half-space collider's node set is a predicate on float32 node
positions, as the cuboids' are (``reference/mpm_object.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import mpm, mpm_object
from benchmark.reference.mpm import _stencil

SAND = 2
_OWN_MODEL = (mpm.SAND, mpm.VISPLAS, mpm.SNOW)     # reference/mpm.py's materials
_CORNERS = torch.tensor([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)])
_DIRS = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]])
# (gaussians, stencil cells, corners) values a block of the density splat
_SPLAT_BLOCK = 1 << 23


# -- the filling ----------------------------------------------------------------------------

def covariance(scaling, rotation, dtype) -> torch.Tensor:
    """Covariances (N,3,3) R S S^T R^T of log-scales (N,3) and wxyz
    quaternions (N,4), the quaternion normalised."""
    s = torch.exp(scaling.to(dtype))
    q = rotation.to(dtype)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    w, x, y, z = q.unbind(1)
    r = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    1).reshape(-1, 3, 3)
    m = r * s[:, None, :]
    return m @ m.transpose(1, 2)


def _cells(x, n: int, dx: float) -> torch.Tensor:
    return torch.clamp(torch.floor(x / dx).long(), 0, n - 1)


def density_grid(pos, opacity, cov, n: int, dx: float):
    """(count, density), (n,n,n) each: the particles in each cell, and the
    opacity-weighted gaussian density each gaussian splats onto the cells
    within its own radius, from its inverse covariance (eigenvalues
    clamped at 1e-8) at each cell's 8 corners (densify_grids)."""
    dtype = pos.dtype
    cell = _cells(pos, n, dx)
    flat = (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]
    count = torch.bincount(flat, minlength=n ** 3)
    sig, q = mpm._sym_eig(cov.double(), sweeps=10)
    sig = torch.clamp(sig, min=1e-8)
    inv = ((q / sig[:, None, :]) @ q.transpose(1, 2)).to(dtype)
    radius = torch.ceil(torch.sqrt(sig.max(1).values) / dx).long()
    density = torch.zeros(n ** 3, dtype=dtype, device=pos.device)
    corners = _CORNERS.to(pos.device)
    for r in torch.unique(radius).tolist():
        side = torch.arange(-r, r + 1, device=pos.device)
        offs = torch.stack(torch.meshgrid(side, side, side, indexing="ij"), -1).reshape(-1, 3)
        ids = torch.nonzero(radius == r).flatten()
        step = max(1, _SPLAT_BLOCK // (len(offs) * 8))
        for a in range(0, len(ids), step):
            g = ids[a:a + step]
            tgt = cell[g][:, None, :] + offs[None]                          # (M,K,3)
            ok = ((tgt >= 0) & (tgt < n)).all(-1)
            nodes = (tgt[:, :, None, :] + corners).to(dtype) * dx           # (M,K,8,3)
            d = pos[g][:, None, None, :] - nodes
            quad = (torch.einsum("mkci,mij->mkcj", d, inv[g]) * d).sum(-1)
            val = opacity[g].to(dtype)[:, None] * torch.exp(-0.5 * quad).sum(-1) / 8.0
            tflat = (tgt[..., 0] * n + tgt[..., 1]) * n + tgt[..., 2]
            density.index_add_(0, tflat[ok], val[ok])
    return count.reshape(n, n, n), density.reshape(n, n, n)


def _walk(occ, cells, d: int, parity: bool) -> torch.Tensor:
    """Per cell (M,3), the walk from the cell along direction ``d`` (axis
    d // 2, positive for even d) to the grid's end: whether it meets an
    occupied cell, or (``parity``) the entries into occupied cells it
    counts, starting from the cell's own state (collision_search,
    collision_times)."""
    n = occ.shape[0]
    step = _DIRS[d].to(cells.device)
    at = cells.clone()
    alive = torch.ones(len(cells), dtype=torch.bool, device=cells.device)
    state = occ[cells[:, 0], cells[:, 1], cells[:, 2]]
    hits = torch.zeros(len(cells), dtype=torch.int64, device=cells.device)
    for _ in range(n):
        at = at + step
        alive = alive & ((at >= 0) & (at < n)).all(1)
        if not parity:
            alive = alive & (hits == 0)
        if not bool(alive.any()):
            break
        c = torch.clamp(at, 0, n - 1)
        new = occ[c[:, 0], c[:, 1], c[:, 2]]
        hits = hits + (alive & (new if not parity else new & ~state)).long()
        state = torch.where(alive, new, state)
    return hits


def internal_cells(count, density, search_threshold: float, exclude_dir: int = 5,
                   ray_cast_dir: int = 4) -> torch.Tensor:
    """(n,n,n) bool: the empty cells that internal_filling fills, found by
    a ray walk from each empty cell (see the module's docstring)."""
    occ = density > search_threshold
    cells = torch.nonzero(count == 0)
    keep = torch.ones(len(cells), dtype=torch.bool, device=cells.device)
    for d in range(6):
        if d != exclude_dir:
            keep = keep & (_walk(occ, cells, d, parity=False) > 0)
    cells = cells[keep]
    if 0 <= ray_cast_dir <= 5:
        cells = cells[_walk(occ, cells, ray_cast_dir, parity=True) % 2 == 1]
    out = torch.zeros_like(occ)
    out[cells[:, 0], cells[:, 1], cells[:, 2]] = True
    return out


def fill_jitter(n_new: int, seed: int = 0) -> np.ndarray:
    """The jitter (n_new,3) of the emitted particles, in the order of their
    cells: the packages' generator, drawn once a particle."""
    return np.random.default_rng(seed).random((n_new, 3)).astype(np.float32)


def fill(pos, opacity, cov, filling: dict, grid_lim: float, n_gaussians: int) -> dict:
    """The filling of ``particle_filling`` (decode_params' keys) over the
    gaussians at ``pos`` (N,3, MPM units) with activated ``opacity`` (N,)
    and covariances ``cov`` (N,3,3): ``new`` (M,3), the emitted particles
    after the budget; ``surface`` and ``internal``, the cells each step
    fills (n,n,n bool); ``dx``, the fill grid's spacing."""
    n = int(filling["n_grid"])
    dx = grid_lim / n
    cap = int(filling["max_partciels_per_cell"])
    count, density = density_grid(pos, opacity, cov, n, dx)
    dense = density > float(filling["density_threshold"])
    surface = dense & (count < cap)
    count2 = torch.where(dense, torch.clamp(count, min=cap), count)
    internal = internal_cells(count2, density, float(filling["search_threshold"]),
                              int(filling["search_exclude_direction"]),
                              int(filling["ray_cast_direction"]))
    if filling.get("boundary") is not None:
        b = torch.tensor(filling["boundary"], dtype=torch.float32).reshape(3, 2)
        low = torch.arange(n, dtype=torch.float32) * np.float32(dx)
        inb = [(low >= b[a, 0]) & (low <= b[a, 1]) for a in range(3)]
        internal = internal & (inb[0][:, None, None] & inb[1][None, :, None]
                               & inb[2][None, None, :]).to(internal.device)
    cells, reps = [], []
    for mask, held in ((surface, count), (internal, count2)):
        c = torch.nonzero(mask)
        cells.append(c)
        reps.append(cap - held[mask])
    cells = torch.repeat_interleave(torch.cat(cells), torch.cat(reps), dim=0)
    rng = np.random.default_rng(0)
    jitter = torch.as_tensor(rng.random((len(cells), 3)).astype(np.float32), device=pos.device)
    new = (cells.to(pos.dtype) + jitter.to(pos.dtype)) * dx
    budget = max(int(filling["max_particles_num"]) - n_gaussians, 0)
    if len(new) > budget:
        new = new[torch.as_tensor(rng.permutation(len(new))[:budget], device=pos.device)]
    return dict(new=new, surface=surface, internal=internal, dx=dx)


def uniform_volume(x, n_grid: int, grid_lim: float) -> torch.Tensor:
    """Each particle's volume, the mean over particles of their cell's
    volume over the particles in it (get_particle_volume, uniform)."""
    dx = grid_lim / n_grid
    cell = _cells(x, n_grid, dx)
    flat = (cell[:, 0] * n_grid + cell[:, 1]) * n_grid + cell[:, 2]
    per_cell = torch.bincount(flat, minlength=n_grid ** 3)
    vol = dx ** 3 / per_cell[flat].to(x.dtype)
    return vol.mean().expand(len(x)).clone()


def setup(gaussians: dict, src: dict, cfg: dict, dtype, filled=None) -> dict:
    """The particles and the material field of a filled object from its
    seeded inputs: ``gaussians`` (xyz, opacity_logit, scaling, rotation of
    every gaussian) and ``src``, the material source in
    ``mapped_preds.ply``'s schema, all tensors on one device.  ``filled``
    (M,3), where given, stands in for the filling's own particles in what
    follows the filling (volumes, the material field, the cuboids), so that
    a program's set-up can be held particle by particle.
    Returns x (gaussians, then the filled particles), vol, material,
    density, E, nu, ``cuboids`` (the ground's), ``fill`` (``fill``'s
    output) and ``gs_num``."""
    assert not any(cfg.get("rotation_degree", [])), "a rotated object"
    assert cfg.get("fix_ground", True), "an object without its ground cuboid"
    keep = torch.sigmoid(gaussians["opacity_logit"].double()) > float(cfg["opacity_threshold"])
    world = gaussians["xyz"][keep].to(dtype)
    lo, hi = world.min(0).values, world.max(0).values
    mid, extent = (lo + hi) / 2.0, (hi - lo).max()
    x_g = (world - mid) / extent + 1.0
    cov = covariance(gaussians["scaling"][keep], gaussians["rotation"][keep], dtype) / extent ** 2
    opacity = torch.sigmoid(gaussians["opacity_logit"][keep].double()).to(dtype)
    lim = float(cfg["grid_lim"])
    filling = fill(x_g, opacity, cov, cfg["particle_filling"], lim, len(x_g))
    new = filling["new"] if filled is None else filled.to(dtype)
    x = torch.cat([x_g, new])
    vol = uniform_volume(x, int(cfg["n_grid"]), lim)
    field = mpm_object.knn_field((x - 1.0) * extent + mid, src["pos"], src,
                                 int(cfg["k_smoothing_neighbors"]),
                                 float(cfg.get("nn_distance_threshold", 0.1)), dtype)
    lo, hi = x.min(0).values, x.max(0).values
    dz = torch.tensor(mpm_object.GROUND_DELTA_Z / 2, dtype=dtype, device=x.device)
    cuboids = [{"type": "ground",
                "point": torch.stack([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, lo[2] + dz]),
                "size": torch.stack([(hi[0] - lo[0]) / 2 + mpm_object.GROUND_BUFFER_XY,
                                     (hi[1] - lo[1]) / 2 + mpm_object.GROUND_BUFFER_XY, dz])}]
    still = x[field["material"] == mpm_object.STATIONARY]
    largest = mpm_object.dbscan_largest(still, mpm_object.STATIONARY_EPS,
                                        mpm_object.STATIONARY_MIN_SAMPLES)
    if largest is not None:
        pts = still[largest]
        lo, hi = pts.min(0).values, pts.max(0).values
        cuboids.append({"type": "stationary_cluster", "point": (lo + hi) / 2,
                        "size": (hi - lo) / 2 + mpm_object.STATIONARY_BUFFER})
    return dict(x=x, vol=vol, cuboids=cuboids, fill=filling, gs_num=len(x_g), **field)


# -- the dynamics ---------------------------------------------------------------------------

_PAIRS = ((0, 1), (0, 2), (1, 2))


def _sym_eig(a: torch.Tensor, sweeps: int = 6):
    """Eigenvalues (N,3) and eigenvectors (columns, N,3,3) of symmetric
    (N,3,3) a: ``reference/mpm.py``'s cyclic Jacobi rotations, each entry
    of a and of V kept as a contiguous vector (strided columns of (N,3,3)
    tensors cost a card ten times as much)."""
    e = {(i, j): a[:, i, j].contiguous() for i in range(3) for j in range(i, 3)}
    one, zero = torch.ones_like(e[0, 0]), torch.zeros_like(e[0, 0])
    v = [[one if i == j else zero for j in range(3)] for i in range(3)]
    tiny = torch.finfo(a.dtype).tiny
    for _ in range(sweeps):
        for p, q in _PAIRS:
            r = 3 - p - q
            apq, app, aqq = e[p, q], e[p, p], e[q, q]
            off = apq.abs() > tiny
            theta = (aqq - app) / (2.0 * torch.where(off, apq, one))
            t = torch.sign(theta) / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(off, torch.where(theta == 0, one, t), zero)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            # a <- J^T a J, J the rotation by (c, s) in the (p, q) plane; v <- v J
            e[p, p], e[q, q] = app - t * apq, aqq + t * apq
            e[p, q] = torch.where(off, zero, apq)
            arp, arq = e[min(r, p), max(r, p)], e[min(r, q), max(r, q)]
            e[min(r, p), max(r, p)], e[min(r, q), max(r, q)] = c * arp - s * arq, s * arp + c * arq
            for k in range(3):
                v[k][p], v[k][q] = c * v[k][p] - s * v[k][q], s * v[k][p] + c * v[k][q]
    return (torch.stack([e[0, 0], e[1, 1], e[2, 2]], 1),
            torch.stack([torch.stack(row, 1) for row in v], 1))


def svd3(f: torch.Tensor):
    """F = U diag(s) V^T as ``reference/mpm.py``'s ``svd3`` (s by
    decreasing magnitude, U and V proper rotations, s[:, 2] carrying the
    sign of det F), its eigen-decomposition of F^T F by ``_sym_eig`` and
    the products as elementwise sums."""
    w, v = _sym_eig((f[:, :, :, None] * f[:, :, None, :]).sum(1))
    order = torch.argsort(w, dim=1, descending=True)
    w = torch.gather(w, 1, order)
    v = torch.gather(v, 2, order[:, None, :].expand(-1, 3, -1))
    v = torch.where((mpm._det3(v) < 0)[:, None, None], torch.cat([v[:, :, :2], -v[:, :, 2:]], 2),
                    v)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    fv = (f[:, :, :, None] * v[:, None, :, :]).sum(2)
    u0 = fv[:, :, 0] / torch.clamp(torch.linalg.vector_norm(fv[:, :, 0], dim=1), min=1e-30)[:, None]
    u1 = fv[:, :, 1] - (u0 * fv[:, :, 1]).sum(1, keepdim=True) * u0
    u1 = u1 / torch.clamp(torch.linalg.vector_norm(u1, dim=1), min=1e-30)[:, None]
    u2 = torch.linalg.cross(u0, u1, dim=1)
    u = torch.stack([u0, u1, u2], dim=2)
    return u, torch.stack([s[:, 0], s[:, 1], (fv[:, :, 2] * u2).sum(1)], dim=1), v


def _scaled(u, d, w):
    """U diag(d) W^T of (N,3,3) U, W and (N,3) d."""
    return ((u * d[:, None, :])[:, :, None, :] * w[:, None, :, :]).sum(-1)


def sand_constitutive(st: dict, prm: dict) -> torch.Tensor:
    """Drucker-Prager of ``reference/mpm.py``'s ``constitutive`` for a state
    of sand alone: the log-strain of the singular values projected onto
    the cone (to the tip where it expands), F = F_trial where it does not
    yield; the Kirchhoff stress 2 mu log s + lam tr(log s), diagonal in U.
    Sets st["F"] and returns the stress."""
    ft, mu, lam = st["F_trial"], st["mu"], st["lam"]
    u, s, v = svd3(ft)
    eps = torch.log(torch.clamp(s.abs(), min=1e-14))
    tr = eps.sum(1)
    eh = eps - (tr / 3.0)[:, None]
    ehn = torch.linalg.vector_norm(eh, dim=1)
    dg = ehn + (3.0 * lam + 2.0 * mu) / (2.0 * mu) * tr * prm["alpha"]
    h = eps - eh * (dg / torch.clamp(ehn, min=1e-12))[:, None]
    yields = dg > 0
    s_new = torch.where(yields[:, None],
                        torch.where((tr > 0)[:, None], torch.ones_like(s), torch.exp(h)), s)
    st["F"] = torch.where(yields[:, None, None], _scaled(u, s_new, v), ft)
    e = torch.log(s_new)
    return _scaled(u, 2.0 * mu[:, None] * e + lam[:, None] * e.sum(1, keepdim=True), u)


def _replayed_sand(st: dict, prm: dict) -> torch.Tensor:
    """``sand_constitutive`` on a card, captured once as a CUDA graph (its
    ~900 kernels of one element a particle each cost more to launch than
    to run) and replayed on copies of F_trial, mu and lam: the same
    kernels on the same values."""
    keep = prm["_sand_graph"]
    key = (st["F_trial"].shape, st["F_trial"].dtype, st["F_trial"].device)
    if keep.get("key") != key:
        static = {k: st[k].clone() for k in ("F_trial", "mu", "lam")}
        side = torch.cuda.Stream(device=key[2])
        side.wait_stream(torch.cuda.current_stream(key[2]))
        with torch.cuda.stream(side):
            sand_constitutive(dict(static), prm)
        torch.cuda.current_stream(key[2]).wait_stream(side)
        graph, out = torch.cuda.CUDAGraph(), dict(static)
        with torch.cuda.graph(graph):
            stress = sand_constitutive(out, prm)
        keep.clear()
        keep.update(key=key, graph=graph, static=static, out=out, stress=stress)
    for k, t in keep["static"].items():
        t.copy_(st[k])
    keep["graph"].replay()
    st["F"] = keep["out"]["F"].clone()
    return keep["stress"].clone()


def constitutive(st: dict, prm: dict) -> torch.Tensor:
    """Return mapping and Kirchhoff stress by material: a state of sand
    alone through ``sand_constitutive`` (replayed as a CUDA graph on a
    card); else sand, plasticine and snow as ``reference/mpm.py``, jelly,
    metal and stationary as ``reference/mpm_object.py``."""
    mat = st["material"]
    if bool((mat == SAND).all()):
        if st["F_trial"].is_cuda:
            return _replayed_sand(st, prm)
        return sand_constitutive(st, prm)
    other = ~torch.isin(mat, torch.tensor(_OWN_MODEL, device=mat.device))
    if not bool(other.any()):
        return mpm.constitutive(st, prm)
    st_o = dict(st)
    stress_o = mpm_object.constitutive(st_o, prm)
    stress = mpm.constitutive(st, prm)
    st["F"] = torch.where(other[:, None, None], st_o["F"], st["F"])
    st["ys"] = torch.where(other, st_o["ys"], st["ys"])
    return torch.where(other[:, None, None], stress_o, stress)


def grid_bcs(cfg: dict, cuboids: list, device) -> list:
    """The grid BCs in the solver's order: the material field's cuboids,
    then the configuration's bounding box and surface colliders, each with
    its node set ((G,G,G) or, for the box, (G,G,G,3), on float32 node
    positions) and time window."""
    g, lim = int(cfg["n_grid"]), float(cfg["grid_lim"])
    shape = (g, g, g)
    out = [dict(kind="cuboid", mask=m.reshape(shape), start=0.0,
                end=float(c.get("end_time", 1e6)), reset=int(c.get("reset", 1)))
           for c, m in zip(cuboids, mpm_object.cuboid_masks(
               [dict(c, velocity=[0.0, 0.0, 0.0]) for c in cuboids], g, lim, device))]
    idx = torch.arange(g, device=device)
    node_i = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1)
    node = node_i.to(torch.float32) * np.float32(lim / g)
    for b in cfg["boundary_conditions"]:
        if b["type"] == "bounding_box":
            out.append(dict(kind="box", low=node_i < 3, high=node_i >= g - 3,
                            start=float(b.get("start_time", 0.0)),
                            end=float(b.get("end_time", 999.0))))
        elif b["type"] == "surface_collider":
            assert b["surface"] == "sticky", "a collider other than sticky"
            point = torch.tensor(b["point"], dtype=torch.float32, device=device)
            normal = np.asarray(b["normal"], np.float32)
            normal = torch.as_tensor(normal / np.sqrt((normal ** 2).sum()), device=device)
            out.append(dict(kind="halfspace", mask=((node - point) * normal).sum(-1) < 0,
                            start=float(b["start_time"]), end=float(b["end_time"])))
        else:
            raise ValueError(f"no grid BC {b['type']!r} in this reference")
    return out


def params(cfg: dict, cuboids: list, device) -> dict:
    """Solver constants of a filled object configuration (the class
    config's keys and their defaults) and its cuboid BC dicts."""
    g, lim = int(cfg["n_grid"]), float(cfg["grid_lim"])
    return dict(dt=float(cfg["substep_dt"]), n_grid=g, dx=lim / g, inv_dx=g / lim,
                gravity=torch.tensor(cfg["g"], dtype=torch.float64, device=device),
                damping=float(cfg.get("grid_v_damping_scale", 1.1)),
                alpha=mpm.sand_alpha(float(cfg["friction_angle"])),
                softening=float(cfg.get("softening", 0.1)),
                hardening=float(cfg.get("hardening", 0.0)), xi=float(cfg.get("xi", 0.0)),
                plastic_viscosity=float(cfg.get("plastic_viscosity", 0.0)),
                bcs=grid_bcs(cfg, cuboids, device), _sand_graph={})


def _active(bc: dict, t) -> bool:
    f32 = np.float32
    return bool(f32(bc["start"]) <= f32(t) < f32(bc["end"]))


def _box(x, g: int, inv_dx: float):
    """The nodes any particle's stencil reaches, as slices of the grid: a
    node outside them gets no mass, so its velocity is 0 after any BC and
    no particle reads it."""
    base = torch.floor(x * inv_dx - 0.5).long()
    lo = torch.clamp(base.min(0).values, min=0).tolist()
    hi = torch.clamp(base.max(0).values + 3, max=g).tolist()
    return tuple(slice(a, b) for a, b in zip(lo, hi))


def _contract(m, u):
    """(N,3,3) m and (N,K,3) u -> (N,K,3) m u, as elementwise sums (a
    batched float64 matmul of these shapes is ten times slower on a card)."""
    return (m[:, None, :, :] * u[:, :, None, :]).sum(-1)


def _outer_sum(a, b):
    """(N,K,3) a and b -> (N,3,3) sum over K of a b^T."""
    return (a[:, :, :, None] * b[:, :, None, :]).sum(1)


def substep(st: dict, prm: dict, time: float) -> None:
    """One MPM substep on ``st`` (x, v, C, F, F_trial, mu, lam, ys, mass,
    vol, material), in place: return mapping and stress, P2G, grid update
    with gravity, damping and the grid BCs, G2P.  The grid is the box of
    nodes the particles reach (``_box``)."""
    dt, g, dx, inv_dx = prm["dt"], prm["n_grid"], prm["dx"], prm["inv_dx"]
    dtype = st["x"].dtype
    f32 = np.float32
    stress = constitutive(st, prm)
    weight, grad, dpos, flat, inside = _stencil(st["x"], g, inv_dx)
    box = _box(st["x"], g, inv_dx)
    e = [b.stop - b.start for b in box]
    flat = (((flat // (g * g) - box[0].start) * e[1] + (flat // g % g - box[1].start)) * e[2]
            + (flat % g - box[2].start))
    w = torch.where(inside, weight, torch.zeros_like(weight))
    m, v, c = st["mass"], st["v"], st["C"]
    v_aff = v[:, None, :] + _contract(c, dpos * dx)
    force = _contract(-(st["vol"] * dt)[:, None, None] * stress, grad)
    mom = (w * m[:, None])[..., None] * v_aff + torch.where(inside[..., None], force, 0.0)
    vals = torch.cat([mom, (w * m[:, None])[..., None]], -1)
    grid = torch.zeros((e[0] * e[1] * e[2], 4), dtype=dtype, device=st["x"].device)
    grid.index_add_(0, flat.reshape(-1), vals.reshape(-1, 4))

    gm = grid[:, 3:]
    has = gm > 1e-15
    gv = grid[:, :3] / torch.where(has, gm, torch.ones_like(gm))
    gv = gv + dt * prm["gravity"].to(dtype)
    gv = torch.where(has, gv, torch.zeros_like(gv))
    if prm["damping"] < 1.0:
        gv = gv * prm["damping"]
    for bc in prm["bcs"]:
        if bc["kind"] == "cuboid":
            if _active(bc, time):
                gv = torch.where(bc["mask"][box].reshape(-1, 1), torch.zeros_like(gv), gv)
            elif bc["reset"] == 1 and f32(time) < f32(bc["end"]) + f32(15.0) * f32(dt):
                gv = torch.zeros_like(gv)
        elif not _active(bc, time):
            continue
        elif bc["kind"] == "box":
            low, high = (bc[k][box].reshape(-1, 3) for k in ("low", "high"))
            gv = torch.where(low & (gv < 0), torch.zeros_like(gv), gv)
            gv = torch.where(high & (gv > 0), torch.zeros_like(gv), gv)
        else:
            gv = torch.where(bc["mask"][box].reshape(-1, 1), torch.zeros_like(gv), gv)

    nv = torch.where(inside[..., None], gv[flat], torch.zeros((), dtype=dtype, device=gv.device))
    wv = weight[..., None] * nv
    st["v"] = wv.sum(1)
    st["C"] = _outer_sum(wv, dpos) * (4.0 * inv_dx)
    grad_v = _outer_sum(nv, grad)
    st["x"] = st["x"] + dt * st["v"]
    eye = torch.eye(3, dtype=dtype, device=gv.device)
    a = eye + dt * grad_v
    st["F_trial"] = (a[:, :, :, None] * st["F"][:, None, :, :]).sum(2)


def frame(st: dict, prm: dict, t0: float, n_substeps: int) -> dict:
    """n_substeps substeps from time t0 (substep k at t0 + k dt, rounded to
    float32 as the published solver's clock)."""
    dt = np.float32(prm["dt"])
    for k in range(n_substeps):
        substep(st, prm, float(np.float32(np.float32(t0) + np.float32(k) * dt)))
    return st
