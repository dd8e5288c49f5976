"""Combined U-Net inference: the discrete and continuous nets on one grid
(port of pixie_tpu/train/inference.py; reference
trainer/inference_combined.py).

Checkpoints are the reference's ``epoch_*.pth`` files, read natively
(``{"model_state_dict": ...}``, DDP ``module.`` prefixes stripped).  The two
nets run as two ``nn.Module``s on one card; the JAX package's lane-packed
joint net (models/joint.py) and its padding of a batch to the mesh's dp
axis are TPU formulations and are not ported.

``run_inference`` is the batched pass over a dataset: per-object artifacts
(sample_{k}_pred.npy with 3 continuous channels + one-hot argmax classes,
sample_{k}_gt.npy, sample_{k}_mask.npy, sample_{k}_info.json;
inference_combined.py:173-217) and the metrics.json /
per_class_metrics.json reports (pixie/metrics.py).

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
from pixie_tpu_torch.train.data import MaterialVoxelDataset
from pixie_tpu_torch.utils.metrics import mean_se_ci90


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


def run_inference(
    dataset: MaterialVoxelDataset,
    seg_ckpt: str | Path,
    cont_ckpt: str | Path,
    output_dir: str | Path,
    batch_size: int = 4,
    indices=None,
    model_kwargs: dict | None = None,
    obj_class_lookup=None,
    device: str | torch.device = "cuda",
) -> dict:
    """Full inference pass: per-object artifacts + metrics report
    (pixie_tpu/train/inference.py:run_inference)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    infer = CombinedInference(
        load_params(seg_ckpt), load_params(cont_ckpt),
        grid_size=dataset.grid_size,
        feature_channels=dataset.feature_channels,
        num_classes=dataset.num_material_classes,
        background_id=dataset.background_id,
        model_kwargs=model_kwargs,
        device=device,
    )

    per_object = {}
    for feat, cont_gt, mat_id, mask, infos, n_valid in dataset.batches(
        batch_size, indices, pad_to_batch=True
    ):
        # the rows pad_to_batch repeated are not run: one device needs no
        # batch of a fixed size (JAX runs and drops them)
        seg_logits, cont_pred = infer.predict(feat[:n_valid])

        for i in range(n_valid):
            obj_id = infos[i]["obj_id"]
            sample_id = infos[i]["sample_id"]
            fg = mask[i]
            diff_sq = (cont_pred[i] - cont_gt[i]) ** 2

            pred_cls = np.argmax(seg_logits[i], axis=-1)
            valid = fg > 0
            acc = float(
                ((pred_cls == mat_id[i]) & valid).sum() / max(valid.sum(), 1)
            )
            dens = float(diff_sq[..., 0][valid].mean()) if valid.any() else 0.0
            yng = float(diff_sq[..., 1][valid].mean()) if valid.any() else 0.0
            poi = float(diff_sq[..., 2][valid].mean()) if valid.any() else 0.0
            per_object[obj_id] = {
                "seg_acc": acc,
                "density_mse": dens,
                "youngs_mse": yng,
                "poisson_mse": poi,
                "cont_mse": (dens + yng + poi) / 3.0,
            }

            obj_dir = output_dir / obj_id
            obj_dir.mkdir(exist_ok=True)
            combined = infer.combined_prediction(seg_logits[i], cont_pred[i])
            np.save(obj_dir / f"sample_{sample_id}_pred.npy", combined)
            gt = np.concatenate(
                [np.moveaxis(cont_gt[i], -1, 0), mat_id[i][None].astype(np.float32)], 0
            )
            np.save(obj_dir / f"sample_{sample_id}_gt.npy", gt)
            np.save(obj_dir / f"sample_{sample_id}_mask.npy", mask[i])
            with open(obj_dir / f"sample_{sample_id}_info.json", "w") as f:
                json.dump(infos[i], f)

    report = generate_metrics_report(per_object)
    (output_dir / "metrics.json").write_text(json.dumps(report, indent=2))
    (output_dir / "evaluated_obj_ids.json").write_text(
        json.dumps(sorted(per_object.keys()))
    )
    if obj_class_lookup is not None:
        per_class = generate_class_report(per_object, obj_class_lookup)
        (output_dir / "per_class_metrics.json").write_text(
            json.dumps(per_class, indent=2)
        )
    logging.info("Inference complete: %d objects -> %s", len(per_object), output_dir)
    return report


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


def generate_metrics_report(per_object: dict) -> dict:
    """Aggregate mean +/- SE / CI90 (pixie/metrics.py:333-415)."""
    report: dict = {"n_objects": len(per_object), "per_object": per_object}
    if per_object:
        keys = next(iter(per_object.values())).keys()
        for k in keys:
            report[k] = mean_se_ci90(np.array([m[k] for m in per_object.values()]))
    return report


def generate_class_report(per_object: dict, obj_class_lookup) -> dict:
    """Per-class metric tables (generate_class_table, pixie/metrics.py:226)."""
    by_class: dict[str, list] = {}
    for obj_id, m in per_object.items():
        by_class.setdefault(obj_class_lookup(obj_id) or "unknown", []).append(m)
    out = {}
    for cls, ms in sorted(by_class.items()):
        entry = {"n_objects": len(ms)}
        for k in ms[0]:
            entry[k] = mean_se_ci90(np.array([m[k] for m in ms]))
        out[cls] = entry
    return out
