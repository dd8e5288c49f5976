"""Masked metrics of U-Net training and inference, and the image PSNR
(port of pixie_tpu/utils/metrics.py).

Reference: pixie/training_utils.py:68-87 (masked_mean, compute_accuracy) and
pixie/metrics.py (per-object accumulation, mean +/- SE / CI90 reports).
``masked_mean`` and ``compute_accuracy`` take tensors; ``mean_se_ci90`` and
``psnr`` are host numpy, copied unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dims, eps: float = 1e-8) -> torch.Tensor:
    """Mean over entries where mask==1, keeping batch (and channel) dims.

    Matches pixie/training_utils.py:68-73: the denominator is clamped to >= 1
    and then an eps is added, so an empty mask gives 0, not NaN.
    """
    num = (x * mask).sum(dims)
    den = mask.sum(dims).clamp(min=1)
    return num / (den + eps)


def compute_accuracy(pred_logits: torch.Tensor, target: torch.Tensor, mask=None,
                     ignore_index: int | None = None) -> torch.Tensor:
    """Voxel-wise accuracy excluding ``ignore_index`` (training_utils.py:76-87);
    channel-first logits.  0.0 when nothing is counted."""
    pred = pred_logits.argmax(1)
    mask = target != ignore_index if mask is None else mask.bool()
    correct = (pred == target) & mask
    total = mask.sum()
    return torch.where(total == 0, 0.0, correct.sum() / total.clamp(min=1))


def mean_se_ci90(values: np.ndarray) -> dict:
    """mean +/- standard error and 90% CI (pixie/metrics.py report conventions)."""
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    mean = float(values.mean()) if n else float("nan")
    se = float(values.std(ddof=1) / math.sqrt(n)) if n > 1 else 0.0
    z90 = 1.6448536269514722
    return {
        "mean": mean,
        "se": se,
        "ci90_lo": mean - z90 * se,
        "ci90_hi": mean + z90 * se,
        "n": n,
    }


def psnr(pred, target, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB (reference: gaussian-splatting
    utils/image_utils.py psnr; nerfstudio eval loop)."""
    pred = np.asarray(pred, np.float32)
    target = np.asarray(target, np.float32)
    mse = float(np.mean((pred - target) ** 2))
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(max_val) - 10.0 * np.log10(mse))
