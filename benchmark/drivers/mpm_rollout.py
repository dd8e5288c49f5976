"""Traffic driver: MPM frames of a scene configuration through the port's
``MPMSolver.step_frame`` (unfused or fused, as the traffic file says).

Set-up draws the scene from the seed on the device, builds the solver with
the configuration's materials, sticky ground collider and impulse, and
advances the frame that carries the impulse (and the warm frames).  Each
unit of the window is one frame of ``substeps_per_frame`` substeps.  The
window's frame number ``check_unit`` (the traffic file's; the window runs
at least that far, whatever its speed) has its start and end states copied
aside, so that the reference can follow it.

``check`` compares two stretches with ``reference/mpm.py`` in float64:
the set-up frame, from the seeded rest state (the impulse), and the
window's frame ``check_unit``, from its own start state.

``FAULTS`` plant faults in the window's frames (``control.py --what
fault:<name>``, and the CPU tests): each returns a context manager.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from benchmark.reference import mpm as ref

# the state a frame starts from (F is recomputed from F_trial in its first substep)
_CARRIED = ("x", "v", "C", "F_trial", "mu", "lam", "yield_stress")
# the state that ``compare`` judges
_COMPARED = ("x", "v", "C", "F_trial")
_REF_NAMES = {"yield_stress": "ys"}


def draw_scene(cfg: dict, seed: int, device) -> dict:
    """Particle positions (float32, on ``device``) and per-particle material
    arrays (host numpy) of a scene configuration, from the seed."""
    n = int(cfg["n_particles"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    mats = cfg["materials"]
    counts = [int(n * m["share"]) for m in mats[:-1]]
    counts.append(n - sum(counts))
    xs = []
    for m, k in zip(mats, counts):
        if m["shape"] == "box":
            lo = torch.tensor(m["low"], dtype=torch.float32, device=device)
            hi = torch.tensor(m["high"], dtype=torch.float32, device=device)
            xs.append(lo + (hi - lo) * torch.rand((k, 3), generator=gen, device=device))
        elif m["shape"] == "ball":
            d = torch.randn((k, 3), generator=gen, device=device)
            d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
            r = m["radius"] * torch.rand((k, 1), generator=gen, device=device) ** (1.0 / 3.0)
            xs.append(torch.tensor(m["center"], dtype=torch.float32, device=device) + d * r)
        else:
            raise ValueError(f"unknown shape {m['shape']!r}")

    def per(key, dtype=np.float32):
        return np.concatenate([np.full(k, m[key], dtype) for m, k in zip(mats, counts)])

    return dict(x=torch.cat(xs).contiguous(), material=per("id", np.int32),
                density=per("density"), E=per("E"), nu=per("nu"), yield_stress=per("yield_stress"),
                vol=np.full(n, cfg["grid_lim"] ** 3 * cfg["volume_fill"] / n, np.float32))


class Cell:
    work_name = "substeps"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from pixie_tpu_torch.sim import bc
        from pixie_tpu_torch.sim.solver import MPMSolver
        from pixie_tpu_torch.sim.types import MPMConfig, finalize_mu_lam, make_state

        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.dt = float(cfg["substep_dt"])
        self.frame_substeps = int(cfg["substeps_per_frame"])
        scene = draw_scene(cfg, seed, self.device)
        x_host = scene["x"].cpu().numpy()
        self.inputs = scene
        solver = MPMSolver(n_grid=cfg["n_grid"], grid_lim=cfg["grid_lim"], device=self.device,
                           fused=bool(traffic["fused"]))
        solver.cfg = MPMConfig(
            n_grid=int(cfg["n_grid"]), grid_lim=float(cfg["grid_lim"]),
            gravity=tuple(cfg["gravity"]), rpic_damping=float(cfg["rpic_damping"]),
            grid_v_damping_scale=float(cfg["grid_v_damping_scale"]),
            hardening=float(cfg["hardening"]), xi=float(cfg["xi"]),
            friction_angle=float(cfg["friction_angle"]),
            plastic_viscosity=float(cfg["plastic_viscosity"]), softening=float(cfg["softening"]),
            active_materials=tuple(sorted({m["id"] for m in cfg["materials"]})))
        solver.state = finalize_mu_lam(make_state(
            x_host, scene["vol"], density=scene["density"], E=scene["E"], nu=scene["nu"],
            material=scene["material"], yield_stress=scene["yield_stress"], device=self.device))
        col, imp = cfg["collider"], cfg["impulse"]
        solver.bcs = [bc.make_surface_collider(col["point"], col["normal"], col["surface"],
                                               device=self.device),
                      bc.make_particle_impulse(x_host, imp["force"], self.dt, point=imp["point"],
                                               size=imp["size"], num_dt=imp["num_dt"],
                                               device=self.device)]
        self.solver = solver
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
        """A frame of the traffic's ``name_substeps`` (for the trace that
        names the idle gaps, whose recorded host operations are costly to
        read); returns its substeps."""
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
        prm = ref.params(self.cfg, self.device)
        sc = self.inputs
        material = torch.as_tensor(sc["material"], device=self.device)
        imp = self.cfg["impulse"]
        x0 = sc["x"]
        point, size = (torch.tensor(imp[k], dtype=torch.float64, device=self.device)
                       for k in ("point", "size"))
        impulse = dict(mask=((x0.double() - point).abs() < size).all(1),
                       force=torch.tensor(imp["force"], dtype=dtype, device=self.device),
                       start=0.0, end=float(np.float32(self.dt * imp["num_dt"])))
        n_setup = int(self.traffic["setup_frame_substeps"])

        def rest(dt):
            return ref.initial_state(x0, material, *(torch.as_tensor(sc[k], device=self.device)
                                                     for k in ("density", "E", "nu",
                                                               "yield_stress", "vol")), dtype=dt)

        def frame_start(dt):
            r = {_REF_NAMES.get(k, k): self.start[k].to(dt) for k in _CARRIED}
            r.update(F=r["F_trial"].clone(), material=material,
                     mass=torch.as_tensor(sc["density"] * sc["vol"], device=self.device).to(dt),
                     vol=torch.as_tensor(sc["vol"], device=self.device).to(dt))
            return r

        after_setup = self.after_setup
        if control is not None:
            cdt = getattr(torch, control)
            after_setup = ref.frame(rest(cdt), prm, 0.0, n_setup, dict(
                impulse, force=impulse["force"].to(cdt)))
            out = ref.frame(frame_start(cdt), prm, self.start_time, self.frame_substeps)
        r = ref.frame(rest(dtype), prm, 0.0, n_setup, impulse)
        gaps = {f"{k}.impulse": v for k, v in compare(after_setup, r, self.cfg,
                                                      material, per_material=False).items()}
        del r
        r = ref.frame(frame_start(dtype), prm, self.start_time, self.frame_substeps)
        gaps.update(compare(out, r, self.cfg, material, per_material=True))
        return gaps


def compare(prog: dict, r: dict, cfg: dict, material, per_material: bool) -> dict:
    """The widest gaps between the program's state and the reference's:
    x in cells; v and C relative to the reference's largest; F_trial
    (about the identity) absolute, overall or by material."""
    dx = cfg["grid_lim"] / cfg["n_grid"]

    def gap(a, b):
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())

    out = {"x_gap": gap(prog["x"], r["x"]) / dx,
           "v_gap": gap(prog["v"], r["v"]) / max(float(r["v"].abs().max()), 1e-12)}
    if per_material:
        out["C_gap"] = gap(prog["C"], r["C"]) / max(float(r["C"].abs().max()), 1e-12)
        for m in cfg["materials"]:
            sel = material == m["id"]
            out[f"F_gap.{m['name']}"] = gap(prog["F_trial"][sel], r["F_trial"][sel])
    else:
        out["F_gap"] = gap(prog["F_trial"], r["F_trial"])
    return out


# -- faults planted in the window's frames --------------------------------------------------

def _state_unchanged(cell):
    """Every substep of the window leaves the particles' state as it was
    (the fused frame's closing G2P still runs)."""
    from pixie_tpu_torch.ops import fused_substep as fs
    from pixie_tpu_torch.sim import solver as sv

    if not cell.solver.fused:
        return mock.patch.object(sv, "_substep", lambda state, *a, **k: (state, None))
    real = fs.fused_substep

    def kept(state, grid_v, cfg, dt, active):
        saved = {k: getattr(state, k).clone() for k in fs.UPDATED_FIELDS
                 if getattr(state, k, None) is not None}
        grid = real(state, grid_v, cfg, dt, active)
        for k, t in saved.items():
            getattr(state, k).copy_(t)
        return grid

    return mock.patch.object(sv.fs, "fused_substep", kept)


def _half_left_out(cell):
    """Half of the particles (every other one in the frame's order) skip
    the substep's particle update: G2P unfused, B6 fused."""
    from pixie_tpu_torch.sim import solver as sv

    if cell.solver.fused:
        real = sv.fs.fused_substep

        def half(state, grid_v, cfg, dt, active):
            keep = torch.zeros_like(active)
            keep[::2] = True
            return real(state, grid_v, cfg, dt, active & keep)

        return mock.patch.object(sv.fs, "fused_substep", half)
    real = sv.g2p

    def half(state, grid_v, cfg, dt):
        kept = {k: getattr(state, k).clone() for k in _COMPARED}
        out = real(state, grid_v, cfg, dt)
        for k, t in kept.items():
            getattr(out, k)[1::2] = t[1::2]
        return out

    return mock.patch.object(sv, "g2p", half)


def _answer_altered(cell):
    """One particle is moved a cell along z at the end of each frame."""
    real = cell.solver.step_frame

    def altered(n, dt):
        fused = real(n, dt)
        cell.solver.state.x[7, 2] += cell.solver.cfg.dx
        return fused

    return mock.patch.object(cell.solver, "step_frame", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}
