"""Field adapter: world-space point queries against a trained field (port of
pixie_tpu/recon/field_adapter.py; reference f3rm_robot/field_adapter.py:28-72).

Density, alpha, RGB and distilled features per (x, y, z), with the
world -> [0,1]^3 map applied on the fly: the ``dataparser_transforms.json``
transform and scale where one sits beside the checkpoint (real scenes,
f3rm_robot/load.py:136-169), then the [-1,1] box onto [0,1]^3.  The map
runs on the host in float32 numpy, as the JAX package runs it.

It is the duck type the voxelizer consumes: ``query(points) -> {"density",
"feature"}``, ``get_rgb(points)``, and ``query_packed_chunks`` for the whole
grid, a loop over fixed-size chunks on the adapter's device.  The fields'
MLPs run in float32 with TF32 off on CUDA, so the card's features match the
CPU's.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.recon.field import NerfField, feature_field_for
from pixie_tpu_torch.voxel.voxelize import pack_rows


def world_to_unit(world_points, scale: float, transform: np.ndarray | None) -> np.ndarray:
    """(B,3) world points -> the fields' [0,1]^3 (float32 numpy)."""
    p = np.asarray(world_points, np.float32)
    if transform is not None:
        ph = np.concatenate([p, np.ones((len(p), 1), np.float32)], axis=1)
        p = (transform @ ph.T).T[:, :3]
    p = p * scale
    return p * 0.5 + 0.5


def use_fp32_matmuls(device: torch.device) -> None:
    """Full float32 products and convolutions on CUDA (no TF32)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def query_grid_chunks(density_feature, rgb, points01: np.ndarray, chunk_size: int, delta,
                      alpha_weighted: bool, device: torch.device):
    """(features (T,C) fp16, alphas_rgb (T,4) fp16) on ``device`` for the
    [0,1]^3 points, ``chunk_size`` at a time: ``density_feature(pts) ->
    (density, feature)`` and ``rgb(pts)`` on each chunk, packed by
    ``pack_rows``; column 0 of alphas_rgb is alpha, 1:4 rgb."""
    pts = torch.as_tensor(np.ascontiguousarray(points01, np.float32), device=device)
    feats = alphas_rgb = None
    with torch.inference_mode():
        for i in range(0, pts.shape[0], chunk_size):
            chunk = pts[i:i + chunk_size]
            density, feature = density_feature(chunk)
            f16, a16, r16 = pack_rows(density, feature, rgb(chunk), delta, alpha_weighted)
            if feats is None:
                feats = torch.empty((pts.shape[0], f16.shape[1]), dtype=torch.float16,
                                    device=device)
                alphas_rgb = torch.empty((pts.shape[0], 4), dtype=torch.float16, device=device)
            feats[i:i + chunk_size] = f16
            alphas_rgb[i:i + chunk_size, :1] = a16
            alphas_rgb[i:i + chunk_size, 1:] = r16
    return feats, alphas_rgb


class FieldAdapter:
    """``NerfField`` (+ ``FeatureField``) state dicts on ``device``."""

    def __init__(self, nerf_params, feat_params=None, feature_dim: int = 768,
                 world_to_nerf_scale: float = 1.0,
                 world_to_nerf_transform: np.ndarray | None = None,
                 encoding: str = "mxu", device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        use_fp32_matmuls(self.device)
        self.nerf = NerfField(encoding=encoding)
        self.nerf.load_state_dict(nerf_params)
        self.nerf.to(self.device).eval()
        self.feat = None
        if feat_params:
            self.feat = feature_field_for(feat_params, encoding)
            self.feat.load_state_dict(feat_params)
            self.feat.to(self.device).eval()
            width = self.feat.mlp.out.out_features
            if width != feature_dim:
                raise ValueError(f"feature field is {width} wide, expected {feature_dim}")
        self.scale = float(world_to_nerf_scale)
        self.transform = (np.asarray(world_to_nerf_transform, np.float32)
                          if world_to_nerf_transform is not None else None)

    def _to_unit(self, world_points) -> torch.Tensor:
        return torch.as_tensor(world_to_unit(world_points, self.scale, self.transform),
                               device=self.device)

    def _density_feature(self, pts01: torch.Tensor):
        density = self.nerf(pts01, None, True)
        if self.feat is not None:
            return density, self.feat(pts01)
        return density, torch.cat([density, torch.zeros_like(density)], dim=-1)

    def _rgb(self, pts01: torch.Tensor) -> torch.Tensor:
        return self.nerf(pts01, torch.zeros_like(pts01), False)[1]

    @torch.inference_mode()
    def query(self, world_points) -> dict:
        density, feature = self._density_feature(self._to_unit(world_points))
        return {"density": density, "feature": feature}

    def get_density(self, world_points) -> torch.Tensor:
        return self.query(world_points)["density"]

    def get_alpha(self, world_points, delta: float) -> torch.Tensor:
        return 1.0 - torch.exp(-self.get_density(world_points) * delta)

    @torch.inference_mode()
    def get_rgb(self, world_points) -> torch.Tensor:
        return self._rgb(self._to_unit(world_points))

    def query_packed_chunks(self, world_points, chunk_size: int, delta,
                            alpha_weighted: bool = True):
        """The voxelizer's grid query: (features (T,C) fp16, alphas_rgb
        (T,4) fp16) on the device (``query_grid_chunks``)."""
        return query_grid_chunks(self._density_feature, self._rgb,
                                 world_to_unit(world_points, self.scale, self.transform),
                                 chunk_size, delta, alpha_weighted, self.device)


def load_field_adapter(output_dir: str | Path,
                       device: str | torch.device = "cuda") -> FieldAdapter:
    """The field checkpoint of ``output_dir`` (``train_field.save_field_checkpoint``)
    and the dataparser transform beside it, on ``device``."""
    from pixie_tpu_torch.recon.train_field import load_field_checkpoint  # noqa: PLC0415

    params = load_field_checkpoint(output_dir)
    meta_path = Path(output_dir) / "checkpoints" / "field_meta.json"
    feature_dim, encoding = 768, "mxu"
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        feature_dim = meta.get("feature_dim", 768)
        encoding = meta.get("encoding", "mxu")
    scale, transform = 1.0, None
    dp = Path(output_dir) / "dataparser_transforms.json"
    if dp.exists():
        d = json.loads(dp.read_text())
        scale = float(d["scale"])
        transform = np.asarray(d["transform"], np.float32)
    return FieldAdapter(params["nerf"], params.get("feat"), feature_dim=feature_dim,
                        world_to_nerf_scale=scale, world_to_nerf_transform=transform,
                        encoding=encoding, device=device)
