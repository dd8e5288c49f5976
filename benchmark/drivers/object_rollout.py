"""Traffic driver: MPM frames of one object on the pipeline's normal GS path:
``run_simulation``'s set-up (``pixie_tpu_torch.sim.driver.setup_simulation``)
from a seeded 3DGS model and a seeded material field, then
``MPMSolver.step_frame``, as ``run_simulation``'s frame loop calls it.

The inputs are drawn from the seed on the host (``draw_object``): the
gaussians of an object made of the configuration's parts, and the material
source in ``mapped_preds.ply``'s schema, the occupied voxels of a grid over
it, each with density, E and nu drawn in its part's range.  Set-up runs the
GS set-up, the material field (kNN smoothing, the ground and stationary
cuboids), the config's impulse, then frame 0 (which holds the impulse) and
the warm frames.  Each unit of the window is one frame; the window's frame
``check_unit`` has its start and end states copied aside.

``check`` compares the set-up and two stretches with
``reference/mpm_object.py`` in float64.  The set-up is recomputed from the
seeded inputs (``setup_gaps``): the particles' positions and volumes, the
material field's ids, density, E and nu, the ground and stationary
cuboids.  The stretches each start from a state the program produced:
frame 0 from the rest state the set-up left (the impulse), and the window's
frame ``check_unit`` from its own start state; the reference takes the
set-up's particles, volumes, materials and cuboids as given and recomputes
the dynamics.  Their gaps are the scene cells' (``mpm_rollout.compare``: x
in cells, v and C over the reference's largest, F_trial by material) and
``dx_gap``, x's gap over the largest displacement of the checked frame.

``FAULTS`` plant faults in the window's frames: the scene driver's three
and the cuboid BCs skipped.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from benchmark.drivers.mpm_rollout import FAULTS as SCENE_FAULTS
from benchmark.drivers.mpm_rollout import compare
from benchmark.reference import mpm_object as ref

# the state a frame starts from (F is recomputed from F_trial in its first substep)
_CARRIED = ("x", "v", "C", "F_trial", "mu", "lam", "yield_stress")
_COMPARED = ("x", "v", "C", "F_trial")
_REST = ("x", "material", "density", "E", "nu", "vol")
_REF_NAMES = {"yield_stress": "ys"}
# a set-up value differs from the reference's past this share of it: float32's
# rounding is 1e-7 of it, one neighbour of ten swapped moves a mean by ~1e-2
_DIFFERS = 1e-4


def _inside(part: dict, p: np.ndarray) -> np.ndarray:
    """Which points (M,3) lie in a part."""
    if part["shape"] == "frustum":          # a cone's slice about a vertical axis
        (z0, z1), (r0, r1) = part["z"], part["radius"]
        t = (p[:, 2] - z0) / (z1 - z0)
        r = r0 + (r1 - r0) * np.clip(t, 0.0, 1.0)
        d = np.hypot(p[:, 0] - part["center"][0], p[:, 1] - part["center"][1])
        return (t >= 0.0) & (t <= 1.0) & (d <= r)
    if part["shape"] == "ellipsoid":
        q = (p - np.asarray(part["center"])) / np.asarray(part["radii"])
        return (q * q).sum(1) <= 1.0
    raise ValueError(f"unknown shape {part['shape']!r}")


def part_of(parts: list, p: np.ndarray) -> np.ndarray:
    """Index of the first part that holds each point, -1 for none."""
    out = np.full(len(p), -1, np.int64)
    for i, part in enumerate(parts):
        out[(out < 0) & _inside(part, p)] = i
    return out


def draw_object(cfg: dict, seed: int) -> dict:
    """The seeded inputs of an object configuration: ``gaussians`` in
    ``load_gaussian_ply``'s schema (n_particles above the opacity threshold
    and ``low_opacity_share`` of that below it, in a seeded order) and
    ``source``, the material field in ``load_material_ply``'s schema."""
    rng = np.random.default_rng(int(seed))
    parts = cfg["parts"]
    lo, hi = (np.asarray(cfg["voxel_box"][k], np.float64) for k in ("low", "high"))
    n = int(cfg["n_particles"])
    n_low = int(round(n * float(cfg["low_opacity_share"])))

    xyz, need = [], n + n_low
    while need > 0:                         # uniform in the union of the parts
        p = lo + (hi - lo) * rng.random((12 * need + 1024, 3))
        p = p[part_of(parts, p) >= 0][:need]
        xyz.append(p)
        need -= len(p)
    xyz = np.concatenate(xyz).astype(np.float32)
    opacity = np.concatenate([rng.uniform(0.05, 0.99, n), rng.uniform(0.001, 0.015, n_low)])
    order = rng.permutation(n + n_low)
    m = n + n_low
    gaussians = {
        "xyz": xyz,
        "f_dc": rng.normal(0.0, 0.5, (m, 1, 3)),
        "f_rest": rng.normal(0.0, 0.1, (m, 15, 3)),
        "scaling": rng.normal(np.log(0.006), 0.3, (m, 3)),
        "rotation": rng.normal(size=(m, 4)),
        "opacity": np.log(opacity / (1.0 - opacity))[order][:, None],
    }
    gaussians = {k: torch.as_tensor(np.ascontiguousarray(v, np.float32))
                 for k, v in gaussians.items()}

    g = int(cfg["voxel_grid"])
    centres = lo + (hi - lo) * (np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                                         -1).reshape(-1, 3) + 0.5) / g
    which = part_of(parts, centres)
    centres, which = centres[which >= 0], which[which >= 0]

    def draw(key):
        lo_hi = np.asarray([part[key] for part in parts], np.float64)[which]
        return rng.uniform(lo_hi[:, 0], lo_hi[:, 1]).astype(np.float32)

    ids = np.asarray([part["id"] for part in parts], np.int32)
    source = {"pos": centres.astype(np.float32), "density": draw("density"), "E": draw("E"),
              "nu": draw("nu"), "material_id": ids[which],
              "part_labels": which.astype(np.int32),
              "conf": np.ones(len(which), np.float32)}
    return {"gaussians": gaussians, "source": source}


def class_config(cfg: dict) -> dict:
    """The configuration as a class config: its frame is substeps_per_frame
    substeps (= frame_dt / substep_dt; the CPU tests shorten it)."""
    return dict(cfg, frame_dt=int(cfg["substeps_per_frame"]) * float(cfg["substep_dt"]))


class Cell:
    work_name = "substeps"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        # first: a program without the set-up function fails here, at once
        from pixie_tpu_torch.sim.driver import setup_simulation
        from pixie_tpu_torch.sim.params import decode_params

        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        obj = draw_object(cfg, seed)
        self.inputs = {"xyz": obj["gaussians"]["xyz"],
                       "opacity_logit": obj["gaussians"]["opacity"][:, 0],
                       "source": obj["source"]}
        sim = setup_simulation(obj["source"], decode_params(class_config(cfg)),
                               obj["gaussians"], device=self.device)
        solver = self.solver = sim.solver
        if solver.state.n_particles != int(cfg["n_particles"]):
            raise ValueError(f"{solver.state.n_particles} particles after the opacity filter, "
                             f"not the configuration's {cfg['n_particles']}")
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

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> int:
        """One frame; returns its substeps."""
        kept = self.units == self.check_unit
        if kept:
            for k in _CARRIED:
                self.start[k].copy_(getattr(self.solver.state, k))
            self.start_time = self.solver.time
        self.solver.step_frame(self.frame_substeps, self.dt)
        if kept:
            for k in _COMPARED:
                self.end[k].copy_(getattr(self.solver.state, k))
        self.units += 1
        self._sync()
        return self.frame_substeps

    def name_step(self) -> int:
        """A frame of the traffic's ``name_substeps``; returns its substeps."""
        n = int(self.traffic["name_substeps"])
        self.solver.step_frame(n, self.dt)
        self._sync()
        return n

    def check(self, control: str | None = None) -> dict:
        """Gaps between the program and the reference (see the module's
        docstring); frees the solver first.  With ``control`` (a dtype
        name), the reference computed in that dtype stands in the
        program's place, from the same start states."""
        assert self.units > self.check_unit, "the window ended before its checked frame"
        out = self.end
        self.solver = None
        dtype = torch.float64
        prm = ref.params(self.cfg, self.cuboids, self.device)
        rest = self.rest
        (imp,) = [b for b in self.cfg["boundary_conditions"] if b["type"] == "particle_impulse"]
        point, size = (torch.tensor(imp.get(k, [1.0, 1.0, 1.0]), dtype=dtype, device=self.device)
                       for k in ("point", "size"))
        start = float(imp.get("start_time", 0.0))
        impulse = dict(mask=((rest["x"].double() - point).abs() < size).all(1),
                       force=torch.tensor(imp["force"], dtype=dtype, device=self.device),
                       start=start, end=float(np.float32(start + self.dt * imp["num_dt"])))
        n_setup = int(self.traffic["setup_frame_substeps"])
        materials = {"grid_lim": self.cfg["grid_lim"], "n_grid": self.cfg["n_grid"],
                     "materials": [{"id": p["id"], "name": p["material"]}
                                   for p in self.cfg["parts"]]}

        def rest_state(dt):
            return ref.initial_state(*(rest[k] for k in ("x", "material", "density", "E", "nu",
                                                         "vol")), dtype=dt)

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
            after_setup = ref.frame(rest_state(cdt), prm, 0.0, n_setup, dict(
                impulse, force=impulse["force"].to(cdt)))
            out = ref.frame(frame_start(cdt), prm, self.start_time, self.frame_substeps)
        r = ref.frame(rest_state(dtype), prm, 0.0, n_setup, impulse)
        gaps.update({f"{k}.impulse": v for k, v in compare(
            after_setup, r, materials, rest["material"], per_material=False).items()})
        del r
        r = ref.frame(frame_start(dtype), prm, self.start_time, self.frame_substeps)
        gaps.update(compare(out, r, materials, rest["material"], per_material=True))
        # x's gap over the frame's largest displacement: scale-free, so a frame
        # whose motion is near float32's rounding of x still tells motion from none
        moved = float((r["x"] - self.start["x"].double()).abs().max())
        gaps["dx_gap"] = float((out["x"].double() - r["x"]).abs().max()) / max(moved, 1e-30)
        return gaps


    def setup_gaps(self, control: str | None = None) -> dict:
        """The set-up against the reference's, recomputed in float64 from
        the seeded inputs: x's largest gap in cells; the shares of particles
        whose volume, material id, or density, E or nu differ
        (``_DIFFERS``); the cuboids' largest gap in point or size, in cells
        (infinite where their number or kinds differ).  With ``control``,
        the reference in that dtype stands in the program's place."""
        inp = self.inputs
        src = {k: torch.as_tensor(np.asarray(v), device=self.device)
               for k, v in inp["source"].items()}

        def recompute(dtype):
            return ref.setup(inp["xyz"].to(self.device), inp["opacity_logit"].to(self.device),
                             src, self.cfg, dtype)

        want = recompute(torch.float64)
        if control is None:
            got = dict(self.rest, cuboids=self.cuboids)
        else:
            got = recompute(getattr(torch, control))
        if len(got["x"]) != len(want["x"]):
            return dict.fromkeys(("setup.x_gap", "setup.vol_share", "setup.material_share",
                                  "setup.param_share", "setup.cuboid_gap"), float("inf"))
        dx = float(self.cfg["grid_lim"]) / int(self.cfg["n_grid"])

        def differs(key):
            a, b = got[key].double(), want[key].double()
            return (a - b).abs() > _DIFFERS * b.abs()

        out = {"setup.x_gap": float((got["x"].double() - want["x"]).abs().max()) / dx,
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

def _cuboids_skipped(cell):
    """The grid stage applies no cuboid BC (the ground and the pot go free)."""
    from pixie_tpu_torch.sim import bc

    return mock.patch.object(bc.CuboidVelocity, "apply",
                             lambda self, time, dt, grid_v, node_x, cfg: grid_v)


FAULTS = {**SCENE_FAULTS, "cuboids_skipped": _cuboids_skipped}
