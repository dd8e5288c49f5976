"""U-Net trainers: discrete material segmentation and continuous regression
(port of pixie_tpu/train/trainer.py; reference trainer/training_discrete.py
:103-330 and training_continuous_mse.py:130-390).

The JAX package's TPU formulations become the functions they compute:

  * the mesh-sharded jitted step -> one process a card, DDP across
    processes (``parallel/mesh.py``); one process on one card otherwise;
  * optax's Adam and ``exponential_decay(staircase=True)`` ->
    ``torch.optim.Adam`` (eps 1e-8, optax's) with the learning rate set
    before each update from the count of updates made (``learning_rate``);
  * ``optax.clip_by_global_norm`` -> ``clip_by_global_norm`` (torch's
    ``clip_grad_norm_`` adds 1e-6 to the norm, so it is another function);
  * orbax checkpoints -> the reference's ``epoch_{k}.pth``
    (``model_state_dict``, ``optimizer_state_dict``, ``epoch``, and the
    schedule's ``step``), which ``train.inference.load_params`` and the JAX
    package's ``convert_torch.load_torch_checkpoint`` read.

Both nets train in float32, as the JAX package's ``build_model`` (no
dtype).  PyTorch runs float32 convolutions in TF32 on CUDA by default; the
trainer turns that off, as ``CombinedInference`` does.

The masked losses are means over the *global* batch.  DDP averages the
ranks' gradients, and each rank's masked mean would have its own
denominator, so a plain DDP wrap computes another function whenever ranks
hold different numbers of foreground voxels.  Each rank's loss is its
numerator over the denominator summed over the ranks (without gradient),
times the world size: the average of the ranks' gradients is then the
gradient of one process on the whole batch.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.parallel import DistributedDataParallel

from pixie_tpu_torch.models.unet3d import RegressionUNet, SegmentationUNet
from pixie_tpu_torch.parallel.mesh import (
    all_sum, initialize_distributed, local_batch, local_device, rank, rank_rows,
)
from pixie_tpu_torch.train.data import MaterialVoxelDataset, save_splits, train_test_split
from pixie_tpu_torch.utils.metrics import compute_accuracy, masked_mean


@dataclasses.dataclass
class TrainConfig:
    mode: str = "discrete"  # "discrete" | "continuous"
    feature_channels: int = 768
    cond_dim: int = 32
    model_channels: int = 64
    num_res_blocks: int = 3
    channel_mult: tuple = (1, 1, 2, 4)
    attention_resolutions: tuple = ()
    grid_size: int = 64
    num_classes: int = 8
    background_id: int = 7
    batch_size: int = 4           # global batch (reference: 4 per GPU x world)
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    lr_decay: bool = True
    lr_decay_rate: float = 0.998
    epochs: int = 300
    seed: int = 69
    train_size: float = 0.9
    eval_interval: int = 10
    save_interval: int = 10
    lambda_cont: float = 1.0
    grad_clip: float | None = None


def build_model(cfg: TrainConfig):
    common = dict(
        feature_channels=cfg.feature_channels,
        cond_dim=cfg.cond_dim,
        model_channels=cfg.model_channels,
        num_res_blocks=cfg.num_res_blocks,
        channel_mult=tuple(cfg.channel_mult),
        attention_resolutions=tuple(cfg.attention_resolutions),
        grid_size=cfg.grid_size,
    )
    if cfg.mode == "discrete":
        return SegmentationUNet(num_classes=cfg.num_classes, **common)
    return RegressionUNet(out_channels=3, **common)


def learning_rate(cfg: TrainConfig, steps_per_epoch: int, step: int) -> float:
    """The learning rate of update ``step`` (counted from 0):
    optax.exponential_decay(lr, steps_per_epoch, rate, staircase=True), the
    reference's per-epoch ExponentialLR (training_discrete.py:268)."""
    if not cfg.lr_decay:
        return cfg.lr
    return cfg.lr * cfg.lr_decay_rate ** (step // max(steps_per_epoch, 1))


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient times
    max_norm / norm where the global norm is at least max_norm.  Returns the
    norm (no host sync)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def _valid(mat_id, background_id: int, sample_w=None):
    valid = (mat_id != background_id).to(torch.float32)
    return valid if sample_w is None else valid * sample_w[:, None, None, None]


def discrete_loss(logits, mat_id, mask, background_id: int, sample_w=None, valid_total=None):
    """Masked CE with ignore_index=background (training_discrete.py:224):
    sum of CE over the non-background voxels (times ``sample_w``, (B,), which
    zeroes padded samples) over max(their weight, 1), so an all-background
    batch gives 0.  Channel-last logits (B, D, H, W, K).  ``valid_total``
    replaces the denominator when the batch is one rank's part of a global
    batch."""
    valid = _valid(mat_id, background_id, sample_w)
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, mat_id[..., None]).squeeze(-1)
    den = valid.sum() if valid_total is None else valid_total
    return (ce * valid).sum() / den.clamp(min=1.0)


def continuous_loss(pred, cont_gt, mask, lambda_cont: float = 1.0, sample_w=None,
                    weight_total=None):
    """Foreground-masked MSE (training_continuous_mse.py:103-126).
    pred/cont_gt: (N,D,H,W,3); mask (N,D,H,W).  Each sample's masked mean,
    averaged over channels, then over samples weighted by ``sample_w``;
    ``weight_total`` replaces the weights' sum when the batch is one rank's
    part of a global batch."""
    fg = mask[..., None]
    diff_sq = (pred - cont_gt) ** 2
    per_sample = masked_mean(diff_sq, fg.expand_as(diff_sq), (1, 2, 3))
    if sample_w is not None:
        den = sample_w.sum() if weight_total is None else weight_total
        loss = (per_sample.mean(-1) * sample_w).sum() / den.clamp(min=1.0)
        loss = loss * lambda_cont
    else:
        loss = per_sample.mean() * lambda_cont
    aux = {
        "density_mse": masked_mean(diff_sq[..., 0:1], fg, (1, 2, 3)).mean(),
        "youngs_mse": masked_mean(diff_sq[..., 1:2], fg, (1, 2, 3)).mean(),
        "poisson_mse": masked_mean(diff_sq[..., 2:3], fg, (1, 2, 3)).mean(),
    }
    return loss, aux


class Trainer:
    """Trainer of either U-Net: one process, or one rank of a DDP group."""

    def __init__(self, cfg: TrainConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        # join torchrun's group first (a no-op for one process), as the JAX
        # trainer joins the pod runtime (training_utils.py:50-55 ddp_setup)
        self.world = initialize_distributed(device)
        self.rank = rank()
        self.device = local_device(device)
        if self.device.type == "cuda":
            if self.world > 1:
                torch.cuda.set_device(self.device)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = None
        self.net = None         # the model, or its DDP wrapper
        self.opt = None
        self.steps_per_epoch = 1
        self.step = 0           # updates made: the schedule's count
        self.epoch = 0

    @property
    def params(self) -> dict | None:
        """A copy of the weights (the JAX trainer's params are immutable)."""
        if self.model is None:
            return None
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    # -- init / checkpointing -------------------------------------------------
    def init_params(self, rng_seed: int | None = None) -> dict:
        """The reference's initialization (PyTorch's defaults, zeroed output
        convs) drawn from the CPU generator seeded with ``cfg.seed``; the
        process's own generator state is left as it was."""
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(self.cfg.seed if rng_seed is None else rng_seed)
            self.model = build_model(self.cfg)
        self.model.to(self.device)
        return self.params

    def setup(self, steps_per_epoch: int, params: dict | None = None):
        """Optimizer and schedule; ``params``, a state dict, replaces the
        initial weights."""
        if params is not None:
            if self.model is None:
                self.model = build_model(self.cfg).to(self.device)
            self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        if self.model is None:
            self.init_params()
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.opt = make_optimizer(self.cfg, self.model.parameters())
        self.step = 0
        self.net = self.model
        if self.world > 1:
            self.net = DistributedDataParallel(
                self.model, device_ids=[self.device.index] if self.device.type == "cuda"
                else None)

    def _tensors(self, batch, sample_w):
        if sample_w is None:
            batch, sample_w = local_batch(batch, self.world, self.rank)
        feat, target, mask = (torch.as_tensor(x).to(self.device) for x in batch)
        w = torch.as_tensor(sample_w, dtype=torch.float32, device=self.device)
        return feat.to(torch.float32), target, mask.to(torch.float32), w

    def _accuracy(self, logits, mat_id):
        """JAX's in-step accuracy: mask=None, so every row of the padded
        batch counts; over DDP, the ranks' counts are added."""
        acc = compute_accuracy(logits.movedim(-1, 1), mat_id, ignore_index=self.cfg.background_id)
        if self.world > 1:
            total = (mat_id != self.cfg.background_id).sum().to(torch.float32)
            acc = all_sum(acc * total) / all_sum(total).clamp(min=1.0)
        return acc

    def _mean_over_ranks(self, aux: dict) -> dict:
        # every rank holds the same number of rows (mesh.rank_rows)
        return {k: all_sum(v) / self.world for k, v in aux.items()}

    def train_step(self, batch, sample_w=None) -> tuple[float, dict]:
        """One update on a global batch: (feat, mat_id, mask) discrete or
        (feat, cont, mask) continuous, channel-last, numpy or tensors.  Each
        rank takes its rows (``mesh.local_batch``); with ``sample_w`` given,
        ``batch`` is already this rank's rows and those their weights.
        Returns the global batch's loss and metrics."""
        cfg = self.cfg
        feat, target, mask, w = self._tensors(batch, sample_w)
        lr = learning_rate(cfg, self.steps_per_epoch, self.step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.zero_grad(set_to_none=True)
        out = self.net(feat)
        if cfg.mode == "discrete":
            valid_total = all_sum(_valid(target, cfg.background_id, w).sum())
            loss = discrete_loss(out, target, mask, cfg.background_id, w, valid_total)
            aux = {"accuracy": self._accuracy(out.detach(), target)}
        else:
            loss, aux = continuous_loss(out, target, mask, cfg.lambda_cont, w, all_sum(w.sum()))
            aux = self._mean_over_ranks({k: v.detach() for k, v in aux.items()})
        (loss * self.world if self.world > 1 else loss).backward()
        if cfg.grad_clip:
            clip_by_global_norm([p.grad for p in self.model.parameters()], cfg.grad_clip)
        self.opt.step()
        self.step += 1
        return float(all_sum(loss)), {k: float(v) for k, v in aux.items()}

    @torch.no_grad()
    def eval_step(self, batch) -> dict:
        cfg = self.cfg
        feat, target, mask, _ = self._tensors(batch, None)
        out = self.model(feat)
        if cfg.mode == "discrete":
            return {"accuracy": float(self._accuracy(out, target))}
        _, aux = continuous_loss(out, target, mask)
        return {k: float(v) for k, v in self._mean_over_ranks(aux).items()}

    # -- epoch_k.pth checkpoints ----------------------------------------------
    def save_checkpoint(self, ckpt_dir: str | Path, epoch: int) -> str:
        """``ckpt_dir/epoch_{epoch}.pth`` (written by rank 0)."""
        path = Path(ckpt_dir) / f"epoch_{epoch}.pth"
        if self.rank == 0:
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save({"model_state_dict": self.model.state_dict(),
                        "optimizer_state_dict": self.opt.state_dict(),
                        "epoch": epoch, "step": self.step}, path)
        return str(path)

    def load_checkpoint(self, path: str | Path):
        """Weights, Adam's moments, the epoch and the schedule's count of a
        checkpoint ``save_checkpoint`` wrote (after ``setup``)."""
        # on the host: the model and Adam copy to their device (Adam keeps
        # its step counts on the host)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(ckpt["model_state_dict"])
        self.opt.load_state_dict(ckpt["optimizer_state_dict"])
        self.epoch = int(ckpt["epoch"])
        self.step = int(ckpt.get("step", 0))


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    """Highest ``epoch_k.pth`` file (training_utils.py:137-188 auto-latest
    discovery): the reference's checkpoint names, the only format
    ``train.inference.load_params`` reads.  The JAX package's
    latest_checkpoint picks the highest orbax ``epoch_k`` directory
    instead, which this port cannot load."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    candidates = []
    for p in ckpt_dir.glob("epoch_*.pth"):
        k = p.stem.split("_", 1)[1]
        if p.is_file() and k.isdigit():
            candidates.append((int(k), p))
    return max(candidates)[1] if candidates else None


def train_loop(
    cfg: TrainConfig,
    dataset: MaterialVoxelDataset,
    ckpt_dir: str | Path,
    log_every: int = 10,
    max_steps: int | None = None,
    device: str | torch.device = "cuda",
    on_step=None,
):
    """Full training loop mirroring the reference's epoch structure, step
    for step as pixie_tpu/train/trainer.py:train_loop.  Each rank loads its
    rows of every global batch only, with the features as stored (float16
    CLIP grids), which ``train_step`` copies to the device and casts there
    to float32: the values of the JAX loop's host cast, from half the bytes.
    ``on_step(info)``, when given, gets each step's ``step``, ``epoch``,
    ``loss``, the metrics, ``data_s`` (the host's load of the batch) and
    ``step_s`` (the update with the batch's copy to the device, ending in
    the loss's host sync)."""
    rng = np.random.default_rng(cfg.seed)
    train_idx, test_idx = train_test_split(len(dataset), cfg.train_size, seed=42)
    trainer = Trainer(cfg, device=device)
    if trainer.rank == 0:
        save_splits(Path(ckpt_dir) / "train_test_splits.json", dataset, train_idx, test_idx)

    steps_per_epoch = max(len(train_idx) // cfg.batch_size, 1)
    trainer.setup(steps_per_epoch)
    rows, w = rank_rows(cfg.batch_size, trainer.world, trainer.rank)

    history = []
    step_count = 0
    for epoch in range(cfg.epochs):
        order = rng.permutation(train_idx)
        t0 = time.time()
        losses = []
        # full global batches only (drop_remainder)
        for start in range(0, len(order) - cfg.batch_size + 1, cfg.batch_size):
            chunk = order[start:start + cfg.batch_size]
            t_data = time.perf_counter()
            # the features as stored: the trainer casts them on the card
            feat, cont, mat_id, mask, _, _ = next(dataset.batches(len(rows), chunk[rows],
                                                                  feature_dtype=None))
            t_step = time.perf_counter()
            batch = (feat, mat_id, mask) if cfg.mode == "discrete" else (feat, cont, mask)
            loss, aux = trainer.train_step(batch, sample_w=w)
            losses.append(loss)
            if on_step is not None:
                on_step({"step": step_count, "epoch": epoch, "loss": loss, **aux,
                         "data_s": t_step - t_data, "step_s": time.perf_counter() - t_step})
            step_count += 1
            if max_steps and step_count >= max_steps:
                break
        history.append({"epoch": epoch, "loss": float(np.mean(losses)) if losses else None,
                        "time_s": time.time() - t0})
        if epoch % log_every == 0:
            logging.info("epoch %d loss %.5f (%.1fs)", epoch, history[-1]["loss"] or -1,
                         history[-1]["time_s"])
        if (epoch + 1) % cfg.save_interval == 0 or epoch == cfg.epochs - 1:
            trainer.save_checkpoint(ckpt_dir, epoch)
        if max_steps and step_count >= max_steps:
            break
    if trainer.rank == 0:
        Path(ckpt_dir, "history.json").write_text(json.dumps(history))
    return trainer, history
