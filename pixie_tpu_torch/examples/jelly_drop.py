"""Minimal rollout demo: an elastic jelly block dropped onto a pinned ground
(port of examples/jelly_drop.py).

Usage:  python -m pixie_tpu_torch.examples.jelly_drop [--particles 10000]
        [--frames 10] [--out DIR] [--cpu]

Mirrors the reference's sim driver flow (gs_simulation.py:377-641) on a
synthetic block: build state -> set materials -> ground BC -> frame loop of
substeps -> export particle PLY per frame (frame 0, which builds the
kernels, is timed apart and not written).
"""

import argparse
import time
from pathlib import Path

import numpy as np

from pixie_tpu_torch.examples import default_out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="jelly_drop")
    ap.add_argument("--particles", type=int, default=10000)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--substeps", type=int, default=400)
    ap.add_argument("--dt", type=float, default=1e-4)
    ap.add_argument("--out", type=str, default=default_out("jelly_drop"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--fast", action="store_true",
                    help="JAX's tile-blocked solver; the port has one card path, which "
                         "this flag leaves as it is")
    args = ap.parse_args(argv)

    import torch

    from pixie_tpu_torch.sim.solver import MPMSolver
    from pixie_tpu_torch.utils.io import make_material_vertex, write_ply

    device = "cpu" if args.cpu else "cuda"
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.75, 1.25, (args.particles, 3)).astype(np.float32)
    x[:, 2] += 0.3  # hover above the ground
    vol = np.full(args.particles, (0.5**3) / args.particles, np.float32)

    solver = MPMSolver(device=device)
    solver.load_initial_data(x, vol, n_grid=50, grid_lim=2.0)
    solver.set_parameters_dict(
        {
            "material": "jelly",
            "E": 2e5,
            "nu": 0.4,
            "density": 200.0,
            "g": [0.0, 0.0, -9.8],
        }
    )
    solver.finalize_mu_lam()
    # thin pinned ground slab like fix_to_ground (material_field.py:485-545)
    solver.set_velocity_on_cuboid(
        point=[1.0, 1.0, 0.5], size=[1.0, 1.0, 0.025],
        velocity=[0.0, 0.0, 0.0], start_time=0.0, end_time=1e9, reset=1,
    )

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    # frame 0 builds (or loads) the kernels
    t0 = time.time()
    solver.step_frame(args.substeps, args.dt)
    sync()
    print(f"frame 0 (incl. build): {time.time() - t0:.2f}s")

    times, plys = [], []
    for frame in range(1, args.frames):
        t0 = time.time()
        solver.step_frame(args.substeps, args.dt)
        pos = solver.export_particle_x()
        times.append(time.time() - t0)
        st = solver.state
        v = make_material_vertex(
            coords=pos,
            density=st.density.cpu().numpy(),
            E=st.E.cpu().numpy(),
            nu=st.nu.cpu().numpy(),
            material_id=st.material.cpu().numpy(),
        )
        plys.append(out_dir / f"frame_{frame:04d}.ply")
        write_ply(plys[-1], v)
        print(
            f"frame {frame}: {times[-1]*1e3:.1f}ms "
            f"({args.substeps/times[-1]:.0f} substeps/s), "
            f"z range [{pos[:,2].min():.3f}, {pos[:,2].max():.3f}]"
        )

    if times:
        med = float(np.median(times))
        print(
            f"\nmedian frame: {med*1e3:.1f}ms = {args.substeps/med:.0f} substeps/s "
            f"@ {args.particles} particles on {device}"
        )
    return {"plys": plys, "frame_s": times, "x": solver.export_particle_x()}


if __name__ == "__main__":
    main()
