"""Process-group workers of the port's sharded tests
(tests/test_torch_solver_dist.py, tests/test_torch_unet_sp.py,
tests/test_torch_cuda.py).

``run_ranks`` spawns ``world`` processes (gloo on the CPU, ``file://``
rendezvous under a temporary directory) that each run one task of
``TASKS`` and save its result; the parent reads them back.  This module
imports no JAX, so the processes start quickly.
"""

from __future__ import annotations

import numpy as np
import torch

# -- MPM cases -------------------------------------------------------------------------


def mpm_inputs(n: int, seed: int = 0, material: int = 0, scene: str = "block") -> dict:
    """numpy inputs of a sharded-MPM case.  ``block``: tests/test_solver_dist.py's
    ``_state`` (a cube in [0.7, 1.3]^3, density 300, E 2e5, nu 0.35);
    ``realscene``: __graft_entry__.py's real-scene-shaped case (sand, snow and
    plasticine in [1.2, 2.0]^3 of a grid_lim 3 domain); ``clamp``: half the
    block's particles in x [0.90, 0.98] (the last x-tile of slab 0 at n_grid
    48, grid_lim 2 on 2 ranks; ``CLAMP_V0`` sends them over the slab's face),
    half resting in x [1.06, 1.14] on the other side, y and z in [0.6, 0.9]."""
    rng = np.random.default_rng(seed)
    if scene in ("block", "clamp"):
        x = rng.uniform(0.7, 1.3, (n, 3)).astype(np.float32)
        if scene == "clamp":
            x = rng.uniform((0.90, 0.6, 0.6), (0.98, 0.9, 0.9), (n, 3)).astype(np.float32)
            x[n // 2:, 0] += np.float32(0.16)
        return dict(x=x, vol=np.full(n, 1e-6, np.float32), density=300.0, E=2e5, nu=0.35,
                    material=material, yield_stress=0.0)
    assert scene == "realscene", scene
    x = rng.uniform(1.2, 2.0, (n, 3)).astype(np.float32)
    mats = np.zeros(n, np.int32)
    mats[: n // 2] = 2
    mats[n // 2: 3 * n // 4] = 5
    mats[3 * n // 4:] = 3
    return dict(x=x, vol=np.full(n, (3.0 ** 3) * 0.1 / n, np.float32), density=1200.0,
                E=2e6, nu=0.3, material=mats,
                yield_stress=np.where(mats == 3, 3e4, 0.0).astype(np.float32))


def clamp_v0(n: int) -> np.ndarray:
    """The ``clamp`` scene's velocities: 300 m/s along x for the first half
    (3.6 cells of n_grid 48 over 5 substeps of 1e-4), at rest for the rest."""
    v = np.zeros((n, 3), np.float32)
    v[: n // 2, 0] = 300.0
    return v


def torch_state(inputs: dict, device="cpu"):
    from pixie_tpu_torch.sim.types import finalize_mu_lam, make_state

    kw = {k: v for k, v in inputs.items() if k not in ("x", "vol")}
    return finalize_mu_lam(make_state(inputs["x"], inputs["vol"], device=device, **kw))


def torch_bcs(specs, x: np.ndarray, device="cpu") -> tuple:
    """The port's BCs from ``(kind, kwargs)`` specs: ``collider`` (a
    sticky surface collider) or ``impulse`` (a particle impulse on the
    particles with z above ``z``)."""
    from pixie_tpu_torch.sim import bc

    out = []
    for kind, kw in specs:
        if kind == "collider":
            out.append(bc.make_surface_collider(kw["point"], kw["normal"], "sticky",
                                                device=device))
        else:
            out.append(bc.ParticleImpulse(
                force=torch.tensor(kw["force"], dtype=torch.float32, device=device),
                mask=torch.as_tensor(x[:, 2] > kw["z"], device=device),
                start_time=0.0, end_time=1.0))
    return tuple(out)


def fake_cell_order(seed: int):
    """Make the port's P2G return a random permutation as its order (the
    card returns its cell order; the CPU none), so a frame's per-rank order
    bookkeeping runs on the CPU."""
    from pixie_tpu_torch.ops import transfer

    gen = torch.Generator().manual_seed(seed)
    plain = transfer.p2g

    def p2g(*args, return_order=False, **kw):
        grid = plain(*args, **kw)
        if not return_order:
            return grid
        return grid, torch.randperm(args[0].shape[0], generator=gen)

    transfer.p2g = p2g


def mpm_case(case: dict, world: int, device: str = "cpu") -> dict:
    """One sharded frame of ``case`` on this rank: its inputs, config,
    BCs, ``substeps`` and ``path`` (``sharded``: shard_particles +
    simulate_substeps_sharded, this rank's rows; ``rollout``:
    rollout_fast_sharded; ``halo``: rollout_halo_sharded), with
    ``fake_order`` a random per-rank cell order (``fake_cell_order``)."""
    from pixie_tpu_torch.ops import transfer
    from pixie_tpu_torch.sim import solver_dist as sd
    from pixie_tpu_torch.sim.types import MPMConfig

    inputs = mpm_inputs(**case["inputs"])
    cfg = MPMConfig(**case["cfg"])
    st = torch_state(inputs, device)
    if "v0" in case:
        st = st.replace(v=torch.as_tensor(case["v0"], device=device))
    bcs = torch_bcs(case.get("bcs", ()), inputs["x"], device)
    plain = transfer.p2g
    if case.get("fake_order"):
        fake_cell_order(seed=world)
    n_sub, dt = case["substeps"], 1e-4
    extra = {}
    launches = transfer.P2G_LAUNCHES, transfer.G2P_LAUNCHES
    try:
        if case["path"] == "sharded":
            local, lbcs = sd.shard_particles(st, bcs)
            extra = {"selection_in": local.selection.cpu().numpy(),
                     "x_in": local.x.cpu().numpy()}
            out = sd.simulate_substeps_sharded(local, cfg, lbcs, 0.0, dt, n_sub)
        elif case["path"] == "rollout":
            out = sd.rollout_fast_sharded(st, cfg, bcs, n_sub, dt)
        else:
            out = sd.rollout_halo_sharded(st, cfg, bcs, n_sub, dt)
            lay = sd.build_halo_layout(inputs["x"], cfg.n_grid, cfg.inv_dx, world)
            extra = {"bytes": sd.halo_bytes_a_substep(cfg.n_grid, lay["nx"])}
    finally:
        transfer.p2g = plain
    return {"x": out.x.cpu().numpy(), "v": out.v.cpu().numpy(), "F": out.F.cpu().numpy(),
            "selection": out.selection.cpu().numpy(),
            "launches": (transfer.P2G_LAUNCHES - launches[0], transfer.G2P_LAUNCHES - launches[1]),
            **extra}


def _mpm_task(rank: int, world: int, args: dict, device: str) -> list:
    return [mpm_case(c, world, device) for c in args["cases"]]


# -- U-Net spatial sharding ---------------------------------------------------------------

def unet_steps(make_trainer, batches) -> list:
    """One ``train_step`` of a fresh trainer on each (feat, target, mask)
    batch: the loss, the metrics and every parameter's gradient.  (After an
    Adam step the weights of two runs differ by up to ~lr where a gradient
    is rounding noise, as a bias ahead of a norm has, so later gradients of
    such tensors would compare noise.)"""
    out = []
    for batch in batches:
        trainer = make_trainer()
        loss, aux = trainer.train_step(batch)
        out.append({"loss": loss, "aux": aux,
                    "grads": {n: p.grad.detach().cpu().clone()
                              for n, p in trainer.model.named_parameters()}})
    return out


def unet_grads64(cfg_kw: dict, params: dict, batch, device="cpu") -> dict:
    """One process's gradient of the trainer's loss in float64 (every row
    at weight 1)."""
    from pixie_tpu_torch.train.trainer import (
        TrainConfig, build_model, continuous_loss, discrete_loss,
    )

    cfg = TrainConfig(**cfg_kw)
    model = build_model(cfg)
    model.load_state_dict(params)
    model = model.double().to(device)
    feat, target, mask = (torch.as_tensor(x).to(device) for x in batch)
    out = model(feat.double())
    w = torch.ones(len(feat), dtype=torch.float64, device=device)
    if cfg.mode == "discrete":
        loss = discrete_loss(out, target, None, cfg.background_id, w)
    else:
        loss = continuous_loss(out, target.double(), mask.double(), cfg.lambda_cont, w)[0]
    loss.backward()
    return {n: p.grad.cpu() for n, p in model.named_parameters()}


def check_sp_grads(got: dict, want: dict, want64: dict, rtol: float, floor: float = 1e-3):
    """Every gradient of an sp run within ``rtol`` of its scale (its largest
    |value|, at least ``floor`` of the net's largest) of one process's, or,
    where one process's own float32 gradient misses its float64 one by more
    than that (a LeakyReLU input within rounding of 0 took the other slope),
    within twice that miss of the float64 gradient.  Returns the worst
    error over its scale."""
    top = max(float(g.abs().max()) for g in want64.values())
    worst = 0.0
    for k, w in want.items():
        scale = max(float(w.abs().max()), floor * top)
        err = float((got[k].cpu() - w.cpu()).abs().max()) / scale
        if err > rtol:
            own = float((w.cpu().double() - want64[k]).abs().max())
            assert own > rtol * scale, (k, err)
            assert float((got[k].cpu().double() - want64[k]).abs().max()) <= 2 * own, (k, err)
        worst = max(worst, err)
    return worst


def load_batches(paths) -> list:
    out = []
    for path in paths:
        d = np.load(path)
        out.append((d["feat"], d["target"], d["mask"]))
    return out


def _unet_task(rank: int, world: int, args: dict, device: str) -> list:
    """For each run of ``args["runs"]``, a (dp, sp) Trainer from its saved
    weights over its saved batches (``unet_steps``)."""
    from pixie_tpu_torch.parallel.mesh import get_mesh
    from pixie_tpu_torch.train.trainer import TrainConfig, Trainer

    out = []
    for run in args["runs"]:
        mesh = get_mesh(run["dp"], run["sp"])
        params = torch.load(run["params"])

        def make_trainer():
            trainer = Trainer(TrainConfig(**run["cfg"]), device=device, mesh=mesh)
            trainer.setup(1, params=params)
            return trainer

        out.append(unet_steps(make_trainer, load_batches(run["batches"])))
    return out


def _halo_jacobian_task(rank: int, world: int, args: dict, device: str) -> dict:
    """DepthHalo's Jacobian in float64, both ways: each column by central
    differences (every rank runs each forward, the column's owner perturbs
    its element) and each row by a backward whose cotangent is 1 at one
    output element of one rank.  The output is gathered over the ranks so
    that every rank sees the whole function."""
    import torch.distributed as dist

    from pixie_tpu_torch.models.unet3d import DepthHalo, SpatialShard
    from pixie_tpu_torch.parallel.mesh import all_gather_grad

    shard = SpatialShard(None, rank, world, tuple(range(world)))
    lo, hi = args["lo"], args["hi"]
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(args["shape"], generator=gen, dtype=torch.float64)

    def f(x):
        return all_gather_grad(DepthHalo.apply(x, lo, hi, shard), 2).reshape(-1)

    n_in = x.numel()
    n_out = f(x).numel()
    eps = 1e-6
    num = torch.zeros(n_out, world * n_in, dtype=torch.float64)
    for owner in range(world):
        for i in range(n_in):
            cols = []
            for sign in (1.0, -1.0):
                xp = x.clone()
                if rank == owner:
                    xp.view(-1)[i] += sign * eps
                cols.append(f(xp))
            num[:, owner * n_in + i] = (cols[0] - cols[1]) / (2 * eps)
    ana = torch.zeros(n_out, world * n_in, dtype=torch.float64)
    for j in range(n_out):
        xr = x.clone().requires_grad_(True)
        y = f(xr)
        cot = torch.zeros_like(y)
        if rank == 0:
            cot[j] = 1.0
        y.backward(cot)
        g = xr.grad.reshape(-1).clone()
        parts = [torch.zeros_like(g) for _ in range(world)]
        dist.all_gather(parts, g)
        ana[j] = torch.cat(parts)
    return {"numerical": num, "analytical": ana, "out": f(x)}


def unet64_case(cfg_kw: dict, params: dict, feat: np.ndarray, cot: np.ndarray, shard=None):
    """The trainer's net in float64 on ``feat`` (B, D, H, W, C) or, with
    ``shard``, on its slab of D: the output and the gradients of
    sum(output * cot) (``cot`` cut to the same planes)."""
    from pixie_tpu_torch.models.unet3d import set_spatial_shard
    from pixie_tpu_torch.train.trainer import TrainConfig, build_model

    model = build_model(TrainConfig(**cfg_kw))
    model.load_state_dict(params)
    model = set_spatial_shard(model.double(), shard)
    if shard is not None:
        feat, cot = feat[:, shard.planes(feat.shape[1])], cot[:, shard.planes(cot.shape[1])]
    out = model(torch.as_tensor(feat, dtype=torch.float64))
    (out * torch.as_tensor(cot, dtype=torch.float64)).sum().backward()
    return out.detach(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _unet64_task(rank: int, world: int, args: dict, device: str) -> list:
    """``unet64_case`` on this rank's slab of an sp group of the whole
    world; each gradient summed over the ranks (what DDP's sum gives)."""
    import torch.distributed as dist

    from pixie_tpu_torch.models.unet3d import SpatialShard
    from pixie_tpu_torch.parallel.mesh import get_mesh

    shard = SpatialShard.of(get_mesh(1, world))
    out = []
    for case in args["cases"]:
        d = np.load(case["data"])
        y, grads = unet64_case(case["cfg"], torch.load(case["params"]), d["feat"], d["cot"],
                               shard)
        for g in grads.values():
            dist.all_reduce(g)
        out.append({"out": y, "grads": grads})
    return out


TASKS = {"mpm": _mpm_task, "unet": _unet_task, "unet64": _unet64_task,
         "halo_jacobian": _halo_jacobian_task}


def worker(rank: int, world: int, init_file: str, task: str, args: dict, out_path: str,
           device: str = "cpu") -> None:
    import os

    import torch.distributed as dist

    from pixie_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    if device == "cuda":        # NCCL, one card a rank
        device = f"cuda:{rank}"
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    backend_dev = device if device.startswith("cuda") and not args.get("gloo", True) else "cpu"
    assert initialize_distributed(backend_dev, init_method=f"file://{init_file}", world=world,
                                  rank_id=rank, timeout_s=120) == world
    result = TASKS[task](rank, world, args, device)
    torch.save(result, f"{out_path}.{rank}")
    dist.destroy_process_group()


def run_ranks(tmp_path, world: int, task: str, args: dict, device: str = "cpu",
              timeout_s: int = 120) -> list:
    """``world`` processes of ``worker`` under a deadline; each rank's
    result.  ``device`` "cuda" gives rank r the card cuda:r over NCCL
    (``args["gloo"]`` False); "cuda:0" with gloo shares one card."""
    import torch.multiprocessing as mp

    init = tmp_path / f"rendezvous_{task}_{world}"
    out = tmp_path / f"out_{task}_{world}"
    ctx = mp.start_processes(worker, nprocs=world, join=False, start_method="spawn",
                             args=(world, str(init), task, args, str(out), device))
    try:
        for _ in range(timeout_s):
            if ctx.join(timeout=1):
                break
        else:
            raise TimeoutError(f"the {world} ranks did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
