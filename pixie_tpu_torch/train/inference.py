"""Combined U-Net inference: the discrete and continuous nets on one grid
(port of pixie_tpu/train/inference.py; reference
trainer/inference_combined.py).

Checkpoints are the reference's ``epoch_*.pth`` files, read natively
(``{"model_state_dict": ...}``, DDP ``module.`` prefixes stripped).  The two
nets run as two ``nn.Module``s; the JAX package's lane-packed joint net
(models/joint.py) is a TPU formulation and is not ported.

Precision: both nets run in float32.  PyTorch runs float32 convolutions
through cuDNN in TF32 by default (``torch.backends.cudnn.allow_tf32``), which
keeps ~3 decimal digits and can flip argmax classes where two logits are
close.  The class maps are meant to match the float32 JAX nets, so
``CombinedInference`` turns TF32 off for convolutions and matmuls on CUDA.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.models.unet3d import RegressionUNet, SegmentationUNet


def load_params(path: str | Path) -> dict[str, torch.Tensor]:
    """A reference ``epoch_*.pth`` checkpoint -> state_dict (CPU tensors)."""
    path = Path(path)
    if path.suffix != ".pth":
        raise ValueError(f"{path}: only torch .pth checkpoints are read by this port "
                         "(orbax checkpoints of the JAX package are not)")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    return {(k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v)
            for k, v in sd.items()}


def _as_numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class CombinedInference:
    def __init__(
        self,
        seg_params,
        cont_params,
        grid_size: int = 64,
        feature_channels: int = 768,
        num_classes: int = 8,
        background_id: int = 7,
        model_kwargs: dict | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        kw = dict(feature_channels=feature_channels, grid_size=grid_size,
                  **(model_kwargs or {}))
        self.num_classes = num_classes
        self.background_id = background_id
        self.seg_model = SegmentationUNet(num_classes=num_classes, **kw)
        self.cont_model = RegressionUNet(out_channels=3, **kw)
        for model, sd in ((self.seg_model, seg_params), (self.cont_model, cont_params)):
            model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
            model.to(self.device).eval()

    @torch.inference_mode()
    def _fwd(self, feat: torch.Tensor):
        return self.seg_model(feat), self.cont_model(feat)

    def predict(self, feat: np.ndarray):
        """feat (B,D,H,W,C) -> (seg_logits (B,D,H,W,K), cont (B,D,H,W,3)), numpy."""
        x = torch.as_tensor(np.asarray(feat, np.float32), device=self.device)
        seg, cont = self._fwd(x)
        return _as_numpy(seg), _as_numpy(cont)

    def predict_device(self, feat_dev: torch.Tensor):
        """Single grid already on the device: (D,H,W,C) tensor of any float
        dtype -> (seg_logits (D,H,W,K), cont (D,H,W,3)) tensors on the device."""
        x = torch.as_tensor(feat_dev, device=self.device).to(torch.float32)[None]
        seg, cont = self._fwd(x)
        return seg[0], cont[0]

    def combined_prediction(self, seg_logits, cont_pred) -> np.ndarray:
        """(3+K, D, H, W): continuous channels + one-hot argmax classes
        (save_predictions, inference_combined.py:189-199)."""
        seg_pred = np.argmax(_as_numpy(seg_logits), axis=-1)
        cont = np.moveaxis(_as_numpy(cont_pred), -1, 0)
        onehot = np.moveaxis(np.eye(self.num_classes, dtype=np.float32)[seg_pred], -1, 0)
        return np.concatenate([cont, onehot], axis=0)


def infer_single_device(
    infer: CombinedInference,
    feat_dev,
    mask: np.ndarray,
    obj_id: str,
    sample_id: int,
    output_dir: str | Path,
) -> Path:
    """Single-object inference from a feature grid on the device; writes
    ``sample_{k}_pred.npy`` / ``_mask.npy`` / ``_info.json`` as
    pixie_tpu/train/inference.py:infer_single_device does."""
    obj_dir = Path(output_dir) / obj_id
    obj_dir.mkdir(parents=True, exist_ok=True)
    seg, cont = infer.predict_device(feat_dev)
    pred_path = obj_dir / f"sample_{sample_id}_pred.npy"
    np.save(pred_path, infer.combined_prediction(seg, cont))
    np.save(obj_dir / f"sample_{sample_id}_mask.npy", np.asarray(mask, np.float32))
    (obj_dir / f"sample_{sample_id}_info.json").write_text(json.dumps(
        {"obj_id": obj_id, "sample_id": sample_id,
         "source": "device-resident voxel grid (pixie_tpu_torch)"}))
    logging.info("Device-resident inference: %s -> %s", obj_id, pred_path)
    return pred_path
