"""Image metrics (port of pixie_tpu/utils/metrics.py ``psnr``, host numpy
copied unchanged).  The masked training metrics wait for the U-Net training
slice (ROADMAP.md 'Next slices' (e)).
"""

from __future__ import annotations

import numpy as np


def psnr(pred, target, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB (reference: gaussian-splatting
    utils/image_utils.py psnr; nerfstudio eval loop)."""
    pred = np.asarray(pred, np.float32)
    target = np.asarray(target, np.float32)
    mse = float(np.mean((pred - target) ** 2))
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(max_val) - 10.0 * np.log10(mse))
