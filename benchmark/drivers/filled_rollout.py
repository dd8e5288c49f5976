"""Traffic driver: MPM frames of a filled object on the pipeline's normal GS
path: ``run_simulation``'s set-up (``pixie_tpu_torch.sim.driver.
setup_simulation``, the config's ``particle_filling`` included) from a
seeded 3DGS of the object's surface and a seeded material field, then
``MPMSolver.step_frame``, as ``run_simulation``'s frame loop calls it.

The inputs are drawn from the seed on the host (``draw_filled``): the
gaussians of a trained 3DGS of an opaque object, which lie on and just
inside its surface (a solid ball of gaussians leaves no cell to fill), and
the material source in ``mapped_preds.ply``'s schema, the voxel centres
inside the object (``object_rollout.draw_object``'s).  Set-up runs the GS
set-up with the filling, the material field and the ground cuboid, then
frame 0 from rest and the warm frames.  The configuration gives no particle
count: after the set-up the driver writes the set-up's count (gaussians
plus filled particles) into the configuration dict it was handed, as
``n_particles``, so that the readers of the simulated work
(``substep_roofline``, ``p2g_roofline``, ...) read it there.  Each unit of
the window is one frame; the window's frame ``check_unit`` has its start
and end states copied aside.

``check`` compares the set-up and two stretches with
``reference/mpm_filled.py`` in float64.  The set-up is recomputed from the
seeded inputs (``setup_gaps``): the filled cells as a set, the particles'
positions (a filled particle against its cell and the jitter drawn for it,
``mpm_filled.fill_jitter``), volumes, material ids, density, E and nu, the
ground cuboid.  The stretches start from states the program produced:
frame 0 from the rest state the set-up left, and the window's frame
``check_unit`` from its own start state.  Their gaps are the scene cells'
(``mpm_rollout.compare``), frame 0's named ``.frame0``, and ``dx_gap``,
x's gap over the largest displacement of the checked frame.

``FAULTS`` plant faults in the window's frames: the scene driver's three,
and the sand particles' material ids set to jelly in place.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.drivers import object_rollout
from benchmark.drivers.mpm_rollout import FAULTS as SCENE_FAULTS
from benchmark.drivers.mpm_rollout import compare
from benchmark.reference import mpm_filled as ref
from benchmark.reference import mpm_object

_CARRIED = object_rollout._CARRIED
_COMPARED = object_rollout._COMPARED
_REST = object_rollout._REST
_REF_NAMES = object_rollout._REF_NAMES
_DIFFERS = object_rollout._DIFFERS
JELLY, SAND = 0, 2


# -- the seeded inputs ------------------------------------------------------------------------

def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _surface_points(parts: list, n: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """n points (n,3) drawn uniformly by area on the outer surface of the
    union of ``parts``, with each point's inward unit normal (n,3).  The
    outer surface: each frustum's side, the lowest part's bottom disk, each
    frustum's top where no later part sits on it (an annulus out to the
    radius of the part above), an ellipsoid's upper half where it is
    centred on a frustum's top, else all of it."""
    pieces = []                                   # (area, draw(m) -> points, normals)
    for i, part in enumerate(parts):
        if part["shape"] == "frustum":
            (z0, z1), (r0, r1) = part["z"], part["radius"]
            cx, cy = part["center"]
            slant = np.hypot(r1 - r0, z1 - z0)

            def side(m, z0=z0, z1=z1, r0=r0, r1=r1, cx=cx, cy=cy):
                t = rng.random(4 * m + 64)
                t = t[rng.random(len(t)) * max(r0, r1) < r0 + (r1 - r0) * t][:m]
                phi = rng.uniform(0.0, 2.0 * np.pi, len(t))
                r = r0 + (r1 - r0) * t
                p = np.stack([cx + r * np.cos(phi), cy + r * np.sin(phi),
                              z0 + (z1 - z0) * t], 1)
                out = np.stack([np.cos(phi), np.sin(phi),
                                np.full(len(t), -(r1 - r0) / (z1 - z0))], 1)
                return p, -_unit(out)

            pieces.append((np.pi * (r0 + r1) * slant, side))
            above = [q for q in parts[i + 1:] if q["shape"] == "frustum" and q["z"][0] == z1]
            inner = above[0]["radius"][0] if above else 0.0
            if not any(q["shape"] == "ellipsoid" and q["center"][2] == z1 for q in parts):
                pieces.append((np.pi * (r1 ** 2 - inner ** 2),
                               lambda m, z=z1, a=inner, b=r1, cx=cx, cy=cy:
                               _disk(m, z, a, b, cx, cy, -1.0, rng)))
            if i == 0:
                pieces.append((np.pi * r0 ** 2, lambda m, z=z0, b=r0, cx=cx, cy=cy:
                               _disk(m, z, 0.0, b, cx, cy, 1.0, rng)))
        elif part["shape"] == "ellipsoid":
            c, radii = np.asarray(part["center"]), np.asarray(part["radii"])

            on_top = any(q["shape"] == "frustum" and q["z"][1] == c[2] for q in parts)

            def dome(m, c=c, radii=radii, on_top=on_top):
                u = _unit(rng.normal(size=(4 * m + 64, 3)))
                if on_top:
                    u[:, 2] = np.abs(u[:, 2])
                # the area element of the map from the unit sphere, over its largest
                grow = np.prod(radii) * np.linalg.norm(u / radii, axis=1)
                u = u[rng.random(len(u)) * np.prod(radii) / radii.min() < grow][:m]
                return c + u * radii, -_unit(u / radii ** 2)

            a, b, cz = radii                      # Thomsen's ellipsoid area, or half of it
            pieces.append(((2.0 if on_top else 4.0) * np.pi
                           * (((a * b) ** 1.6075 + (a * cz) ** 1.6075 + (b * cz) ** 1.6075)
                              / 3.0) ** (1 / 1.6075), dome))
        else:
            raise ValueError(f"unknown shape {part['shape']!r}")
    area = np.asarray([a for a, _ in pieces])
    which = rng.choice(len(pieces), size=n, p=area / area.sum())
    pts, nrm = np.zeros((n, 3)), np.zeros((n, 3))
    for k, (_, draw) in enumerate(pieces):
        sel = np.nonzero(which == k)[0]
        got = 0
        while got < len(sel):
            p, q = draw(len(sel) - got)
            pts[sel[got:got + len(p)]], nrm[sel[got:got + len(p)]] = p, q
            got += len(p)
    return pts, nrm


def _disk(m, z, a, b, cx, cy, inward_z, rng):
    """m points uniform on the annulus a <= r <= b at height z, and the
    inward normal (0, 0, inward_z)."""
    r = np.sqrt(rng.uniform(a * a, b * b, m))
    phi = rng.uniform(0.0, 2.0 * np.pi, m)
    p = np.stack([cx + r * np.cos(phi), cy + r * np.sin(phi), np.full(m, float(z))], 1)
    return p, np.tile([0.0, 0.0, inward_z], (m, 1))


def draw_filled(cfg: dict, seed: int) -> dict:
    """The seeded inputs of a filled object configuration: ``gaussians`` in
    ``load_gaussian_ply``'s schema (``n_gaussians`` above the opacity
    threshold and ``low_opacity_share`` of that below it, in a seeded
    order), each a point of the object's outer surface moved inward along
    the surface normal by a depth uniform in [0, ``shell``), its log-scales
    normal about log ``scale`` (sd 0.3); ``source``, the material field in
    ``load_material_ply``'s schema."""
    rng = np.random.default_rng(int(seed))
    parts = cfg["parts"]
    n = int(cfg["n_gaussians"])
    n_low = int(round(n * float(cfg["low_opacity_share"])))
    xyz, need = [], n + n_low
    while need > 0:
        p, inward = _surface_points(parts, need + need // 8 + 64, rng)
        p = p + inward * (float(cfg["shell"]) * rng.random((len(p), 1)))
        p = p[object_rollout.part_of(parts, p) >= 0][:need]
        xyz.append(p)
        need -= len(p)
    xyz = np.concatenate(xyz).astype(np.float32)
    m = n + n_low
    opacity = np.concatenate([rng.uniform(0.05, 0.99, n), rng.uniform(0.001, 0.015, n_low)])
    order = rng.permutation(m)
    gaussians = {
        "xyz": xyz,
        "f_dc": rng.normal(0.0, 0.5, (m, 1, 3)),
        "f_rest": rng.normal(0.0, 0.1, (m, 15, 3)),
        "scaling": rng.normal(np.log(float(cfg["scale"])), 0.3, (m, 3)),
        "rotation": rng.normal(size=(m, 4)),
        "opacity": np.log(opacity / (1.0 - opacity))[order][:, None],
    }
    gaussians = {k: torch.as_tensor(np.ascontiguousarray(v, np.float32))
                 for k, v in gaussians.items()}
    return {"gaussians": gaussians, "source": _source(cfg, rng)}


def _source(cfg: dict, rng) -> dict:
    """The material source: the centres of a ``voxel_grid``^3 grid over
    ``voxel_box`` that lie in a part, each drawing density, E and nu
    uniformly in its part's range (``object_rollout.draw_object``'s)."""
    parts = cfg["parts"]
    lo, hi = (np.asarray(cfg["voxel_box"][k], np.float64) for k in ("low", "high"))
    g = int(cfg["voxel_grid"])
    centres = lo + (hi - lo) * (np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                                         -1).reshape(-1, 3) + 0.5) / g
    which = object_rollout.part_of(parts, centres)
    centres, which = centres[which >= 0], which[which >= 0]

    def draw(key):
        lo_hi = np.asarray([part[key] for part in parts], np.float64)[which]
        return rng.uniform(lo_hi[:, 0], lo_hi[:, 1]).astype(np.float32)

    ids = np.asarray([part["id"] for part in parts], np.int32)
    return {"pos": centres.astype(np.float32), "density": draw("density"), "E": draw("E"),
            "nu": draw("nu"), "material_id": ids[which], "part_labels": which.astype(np.int32),
            "conf": np.ones(len(which), np.float32)}


# -- the cell ---------------------------------------------------------------------------------

class Cell:
    work_name = "substeps"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        # first: a program without the set-up function fails here, at once
        from pixie_tpu_torch.sim.driver import setup_simulation
        from pixie_tpu_torch.sim.params import decode_params

        if "n_particles" in cfg:
            raise ValueError("a filled object's configuration gives no n_particles: the set-up "
                             "counts them and writes the count here")
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        obj = draw_filled(cfg, seed)
        g = obj["gaussians"]
        self.inputs = {"xyz": g["xyz"], "opacity_logit": g["opacity"][:, 0],
                       "scaling": g["scaling"], "rotation": g["rotation"],
                       "source": obj["source"]}
        sim = setup_simulation(obj["source"], decode_params(object_rollout.class_config(cfg)),
                               g, device=self.device)
        solver = self.solver = sim.solver
        self.gs_num = int(sim.gs_payload["gs_num"])
        if self.gs_num != int(cfg["n_gaussians"]):
            raise ValueError(f"{self.gs_num} gaussians after the opacity filter, "
                             f"not the configuration's {cfg['n_gaussians']}")
        cfg["n_particles"] = solver.state.n_particles
        self.dt, self.frame_substeps = sim.substep_dt, sim.steps_per_frame
        self.rest = {k: getattr(solver.state, k).clone() for k in _REST}
        self.cuboids = sim.auto_bcs
        solver.step_frame(int(traffic["setup_frame_substeps"]), self.dt)
        self.after_setup = {k: getattr(solver.state, k).clone() for k in ("x", "v", "F_trial")}
        for _ in range(int(traffic["warm_frames"])):
            solver.step_frame(self.frame_substeps, self.dt)
        self.check_unit = int(traffic["check_unit"])
        self.min_units = self.check_unit + 1
        self.units = 0
        self.start = {k: torch.empty_like(getattr(solver.state, k)) for k in _CARRIED}
        self.end = {k: torch.empty_like(getattr(solver.state, k)) for k in _COMPARED}
        self.start_time = solver.time
        self._sync()

    _sync = object_rollout.Cell._sync
    step = object_rollout.Cell.step
    name_step = object_rollout.Cell.name_step

    def check(self, control: str | None = None) -> dict:
        """Gaps between the program and the reference (see the module's
        docstring); frees the solver first.  With ``control`` (a dtype
        name), the reference computed in that dtype stands in the
        program's place, from the same inputs and start states."""
        assert self.units > self.check_unit, "the window ended before its checked frame"
        out = self.end
        self.solver = None
        dtype = torch.float64
        prm = ref.params(self.cfg, self.cuboids, self.device)
        rest = self.rest
        n_setup = int(self.traffic["setup_frame_substeps"])
        materials = {"grid_lim": self.cfg["grid_lim"], "n_grid": self.cfg["n_grid"],
                     "materials": [{"id": SAND, "name": "sand"}]}

        def rest_state(dt):
            return mpm_object.initial_state(*(rest[k] for k in _REST), dtype=dt)

        def frame_start(dt):
            r = {_REF_NAMES.get(k, k): self.start[k].to(dt) for k in _CARRIED}
            r.update(F=r["F_trial"].clone(), material=rest["material"],
                     mass=(rest["density"].double() * rest["vol"].double()).to(dt),
                     vol=rest["vol"].to(dt))
            return r

        gaps = self.setup_gaps(control)
        after_setup = self.after_setup
        if control is not None:
            cdt = getattr(torch, control)
            after_setup = ref.frame(rest_state(cdt), prm, 0.0, n_setup)
            out = ref.frame(frame_start(cdt), prm, self.start_time, self.frame_substeps)
        r = ref.frame(rest_state(dtype), prm, 0.0, n_setup)
        gaps.update({f"{k}.frame0": v for k, v in compare(
            after_setup, r, materials, rest["material"], per_material=False).items()})
        del r
        r = ref.frame(frame_start(dtype), prm, self.start_time, self.frame_substeps)
        gaps.update(compare(out, r, materials, rest["material"], per_material=True))
        moved = float((r["x"] - self.start["x"].double()).abs().max())
        gaps["dx_gap"] = float((out["x"].double() - r["x"]).abs().max()) / max(moved, 1e-30)
        return gaps

    def setup_gaps(self, control: str | None = None) -> dict:
        """The set-up against the reference's, recomputed in float64 from
        the seeded inputs, the program's filled particles standing in for
        the reference's own in what follows the filling:
        ``setup.fill_share``, the cells filled by one and not the other
        over the reference's filled cells (a filled particle's cell is its
        position over the fill grid's dx less the jitter drawn for it);
        ``setup.x_gap``, the gaussians' largest gap in cells and a filled
        particle's largest gap from its cell plus its jitter; the shares of
        particles whose volume, material id, or density, E or nu differ
        (``_DIFFERS``); the cuboids' largest gap in point or size, in
        cells (infinite where their number or kinds differ).  With
        ``control``, the reference in that dtype stands in the program's
        place."""
        inp = self.inputs
        gauss = {k: inp[k].to(self.device) for k in ("xyz", "opacity_logit", "scaling",
                                                     "rotation")}
        src = {k: torch.as_tensor(np.asarray(v), device=self.device)
               for k, v in inp["source"].items()}
        if control is None:
            got, gs_num = dict(self.rest, cuboids=self.cuboids), self.gs_num
        else:
            got = ref.setup(gauss, src, self.cfg, getattr(torch, control))
            gs_num = got["gs_num"]
        filled = got["x"][gs_num:].double()
        want = ref.setup(gauss, src, self.cfg, torch.float64, filled=filled)
        keys = ("setup.fill_share", "setup.x_gap", "setup.vol_share", "setup.material_share",
                "setup.param_share", "setup.cuboid_gap")
        if gs_num != want["gs_num"]:
            return dict.fromkeys(keys, float("inf"))
        dx = float(self.cfg["grid_lim"]) / int(self.cfg["n_grid"])
        fdx, fill = want["fill"]["dx"], want["fill"]
        n_fill = fill["internal"].shape[0]
        u = filled / fdx - torch.as_tensor(ref.fill_jitter(len(filled)),
                                           device=self.device).double()
        cell = torch.round(u)
        x_gap = float((got["x"][:gs_num].double() - want["x"][:gs_num]).abs().max()) / dx
        if len(filled):
            x_gap = max(x_gap, float((u - cell).abs().max()) * fdx / dx)
        cell = torch.clamp(cell.long(), -1, n_fill)
        in_grid = ((cell >= 0) & (cell < n_fill)).all(1)
        theirs = torch.unique((cell[:, 0] * n_fill + cell[:, 1]) * n_fill + cell[:, 2])
        ours = torch.nonzero((fill["surface"] | fill["internal"]).flatten()).flatten()
        odd = (int((~torch.isin(theirs, ours)).sum()) + int((~torch.isin(ours, theirs)).sum())
               + int((~in_grid).sum()))

        def differs(key):
            a, b = got[key].double(), want[key].double()
            return (a - b).abs() > _DIFFERS * b.abs()

        out = {"setup.fill_share": odd / max(len(ours), 1), "setup.x_gap": x_gap,
               "setup.vol_share": float(differs("vol").double().mean()),
               "setup.material_share": float((got["material"].long() != want["material"].long())
                                             .double().mean()),
               "setup.param_share": float((differs("density") | differs("E") | differs("nu"))
                                          .double().mean())}
        cub = float("inf")
        if [c["type"] for c in got["cuboids"]] == [c["type"] for c in want["cuboids"]]:
            cub = max((float((torch.as_tensor(a[k], dtype=torch.float64, device=self.device)
                              - b[k].double()).abs().max())
                       for a, b in zip(got["cuboids"], want["cuboids"]) for k in ("point", "size")),
                      default=0.0) / dx
        out["setup.cuboid_gap"] = cub
        return out


# -- faults planted in the window's frames --------------------------------------------------

@contextlib.contextmanager
def _sand_as_jelly(cell):
    """The sand particles' material ids are set to jelly in the solver's
    state, in place (so that each frame's graphs read them), for the window."""
    material = cell.solver.state.material
    sand = material == SAND
    material[sand] = JELLY
    try:
        yield
    finally:
        if cell.solver is not None:
            cell.solver.state.material[sand] = SAND


FAULTS = {**SCENE_FAULTS, "sand_as_jelly": _sand_as_jelly}
