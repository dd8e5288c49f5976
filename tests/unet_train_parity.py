"""Shared helpers of the U-Net training parity tests
(tests/test_torch_unet_train.py, tests/test_torch_train_data.py,
tests/test_torch_cuda.py).

Sizes are tests/test_training.py:41 ``SMALL`` (grid 8, 12 features,
channels 8, mult (1, 2), one res block).  The DDP worker imports no JAX, so
the processes it runs in start quickly.
"""

from __future__ import annotations

import numpy as np
import torch

SMALL = dict(feature_channels=12, cond_dim=8, model_channels=8, num_res_blocks=1,
             channel_mult=(1, 2), grid_size=8)
# CombinedInference / run_inference's model_kwargs at SMALL's widths
SMALL_KW = dict(cond_dim=8, model_channels=8, num_res_blocks=1, channel_mult=(1, 2))


def seeded_params(cfg, seed: int) -> dict:
    """Random non-zero weights (zeroed output convs included) for cfg's net."""
    from pixie_tpu_torch.models.unet3d import seeded_state_dict
    from pixie_tpu_torch.train.trainer import build_model

    return seeded_state_dict(build_model(cfg), seed)


def ddp_worker(rank: int, world: int, init_file: str, cfg_kw: dict, params_path: str,
               batch_paths: list, out_path: str, device: str = "cpu") -> None:
    """One rank of a process group (gloo on the CPU, NCCL on a card, one
    card a rank): for each saved global batch, a fresh Trainer from the
    saved weights takes one train_step; the loss, the metrics and every
    parameter's (averaged) gradient are saved."""
    import os

    import torch.distributed as dist

    from pixie_tpu_torch.parallel.mesh import initialize_distributed
    from pixie_tpu_torch.train.trainer import TrainConfig, Trainer

    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)    # as torchrun sets it
    assert initialize_distributed(device, init_method=f"file://{init_file}", world=world,
                                  rank_id=rank, timeout_s=120) == world
    params = torch.load(params_path)
    results = []
    for path in batch_paths:
        data = np.load(path)
        trainer = Trainer(TrainConfig(**cfg_kw), device=device)
        trainer.setup(1, params=params)
        loss, aux = trainer.train_step((data["feat"], data["target"], data["mask"]))
        results.append({"loss": loss, "aux": aux, "world": trainer.world,
                        "device": str(trainer.device),
                        "grads": {n: p.grad.cpu() for n, p in
                                  trainer.model.named_parameters()}})
    torch.save(results, f"{out_path}.{rank}")
    dist.destroy_process_group()


def ddp_batches(tmp_path, rng, sizes=(4, 3), fg=((0.1, 0.1, 0.7, 0.7), (0.2, 0.6, 0.4))):
    """Global batches whose rows hold different foreground shares, saved for
    ``ddp_worker``: returns their paths and (feat, mat_id, mask)."""
    d, fc = SMALL["grid_size"], SMALL["feature_channels"]
    paths, batches = [], []
    for b, shares in zip(sizes, fg):
        feat = rng.normal(size=(b, d, d, d, fc)).astype(np.float32)
        mask = np.stack([(rng.uniform(size=(d, d, d)) < f).astype(np.float32)
                         for f in shares])
        mat_id = np.where(mask > 0, rng.integers(0, 7, mask.shape), 7).astype(np.int64)
        path = tmp_path / f"batch{b}.npz"
        np.savez(path, feat=feat, target=mat_id, mask=mask)
        paths.append(str(path))
        batches.append((feat, mat_id, mask))
    return paths, batches


def run_ddp(tmp_path, world: int, cfg_kw: dict, params: dict, batch_paths: list,
            device: str = "cpu", timeout_s: int = 180) -> list:
    """``world`` processes of ``ddp_worker`` (spawned, ``file://``
    rendezvous under tmp_path) under a deadline; each rank's results."""
    import torch.multiprocessing as mp

    torch.save(params, tmp_path / "params.pt")
    ctx = mp.start_processes(ddp_worker, nprocs=world, join=False, start_method="spawn", args=(
        world, str(tmp_path / "rendezvous"), cfg_kw, str(tmp_path / "params.pt"), batch_paths,
        str(tmp_path / "out"), device))
    try:
        for _ in range(timeout_s):
            if ctx.join(timeout=1):
                break
        else:
            raise TimeoutError(f"the DDP processes did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(tmp_path / f"out.{r}") for r in range(world)]
