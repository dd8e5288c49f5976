"""Dense CLIP patch-feature extraction for feature-field distillation (port
of pixie_tpu/recon/clip_features.py).

Reference: f3rm/features/clip_extract.py:11-89 (``CLIPArgs`` /
``extract_clip_features``): ViT-L/14@336px dense patch embeddings per image,
the centre crop skipped, cached to disk; the trainer then takes each ray's
nearest patch (``recon/train_field.make_ray_fn``).

The weights come from a local Hugging Face snapshot: a directory holding
``config.json`` and ``model.safetensors`` (or ``pytorch_model.bin``), given
as ``model_name`` itself or found under the hub cache's layout for that name
(``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
``~/.cache/huggingface/hub``: ``models--<org>--<name>/snapshots/<rev>/``).
Nothing is downloaded: without a snapshot, extraction raises
``CLIPWeightsUnavailable``, a ``RuntimeError("CLIP weights unavailable
...")`` as the JAX package raises where it cannot load them.  The
safetensors file is read with numpy (an 8-byte header length, a JSON
header, raw little-endian bytes).  The tower is ``recon/clip_tower.py``.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.recon.clip_tower import (
    CLIPVisionConfig, convert_clip_vision_state_dict, extract_clip_features_torch,
)


class CLIPWeightsUnavailable(RuntimeError):
    """No local snapshot of the CLIP weights."""


class CLIPArgs:
    model_name: str = "openai/clip-vit-large-patch14-336"
    patch_size: int = 14
    feature_dim: int = 768


_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64,
                       "I64": np.int64, "I32": np.int32, "BF16": np.uint16}


def read_safetensors(path: str | Path, keep=lambda name: True) -> dict[str, np.ndarray]:
    """The tensors of a ``.safetensors`` file whose names ``keep`` accepts,
    as numpy arrays (bfloat16 widened to float32)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        base = 8 + n
        out = {}
        for name, info in header.items():
            if name == "__metadata__" or not keep(name):
                continue
            if info["dtype"] not in _SAFETENSORS_DTYPES:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
            start, end = info["data_offsets"]
            f.seek(base + start)
            a = np.frombuffer(bytearray(f.read(end - start)),
                              dtype=np.dtype(_SAFETENSORS_DTYPES[info["dtype"]]).newbyteorder("<"))
            if info["dtype"] == "BF16":
                a = (a.astype(np.uint32) << 16).view(np.float32)
            out[name] = a.reshape(info["shape"])
    return out


def _hub_cache() -> Path:
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    home = os.environ.get("HF_HOME") or Path.home() / ".cache" / "huggingface"
    return Path(home) / "hub"


def find_snapshot(model_name: str) -> Path | None:
    """The local snapshot directory of ``model_name`` (a directory with a
    ``config.json``, or the hub cache's ``refs/main`` snapshot, else its
    only one), or None."""
    direct = Path(model_name)
    if (direct / "config.json").is_file():
        return direct
    repo = _hub_cache() / ("models--" + model_name.replace("/", "--"))
    ref = repo / "refs" / "main"
    if ref.is_file():
        snap = repo / "snapshots" / ref.read_text().strip()
        if (snap / "config.json").is_file():
            return snap
    snaps = sorted(p for p in (repo / "snapshots").glob("*") if (p / "config.json").is_file())
    return snaps[0] if len(snaps) == 1 else None


def load_clip_vision(model_name: str = CLIPArgs.model_name):
    """(CLIPVisionConfig, the tower's state dict) from the local snapshot of
    ``model_name``; CLIPWeightsUnavailable where there is none."""
    snap = find_snapshot(model_name)
    weights = None
    if snap is not None:
        weights = next((snap / n for n in ("model.safetensors", "pytorch_model.bin")
                        if (snap / n).is_file()), None)
    if weights is None:
        raise CLIPWeightsUnavailable(
            f"CLIP weights unavailable (no local snapshot of {model_name!r} with config.json and "
            f"model.safetensors or pytorch_model.bin, as a directory or under {_hub_cache()}); "
            f"provide precomputed features")
    hf = json.loads((snap / "config.json").read_text())
    hf = hf.get("vision_config", hf)          # a CLIPModel's config nests the tower's
    cfg = CLIPVisionConfig(
        hidden_size=hf["hidden_size"], intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"], patch_size=hf["patch_size"],
        image_size=hf["image_size"], layer_norm_eps=hf.get("layer_norm_eps", 1e-5))

    def vision(name):
        return name.startswith("vision_model.")

    if weights.suffix == ".safetensors":
        state = read_safetensors(weights, keep=vision)
    else:
        state = {k: v for k, v in torch.load(weights, map_location="cpu",
                                             weights_only=True).items() if vision(k)}
    return cfg, convert_clip_vision_state_dict(state, cfg)


def load_views(image_paths, image_size: int, patch_size: int) -> np.ndarray:
    """The images, RGB in [0, 1], each resized (PIL bicubic) so that its
    shortest edge is ``image_size``, both sides snapped to multiples of the
    patch (no centre crop, as CLIPArgs skips it)."""
    from PIL import Image  # noqa: PLC0415

    imgs = []
    for p in image_paths:
        im = Image.open(p).convert("RGB")
        w, h = im.size
        s = image_size / min(w, h)
        nw = max(round(w * s / patch_size), 1) * patch_size
        nh = max(round(h * s / patch_size), 1) * patch_size
        imgs.append(np.asarray(im.resize((nw, nh), Image.BICUBIC), np.float32) / 255.0)
    return np.stack(imgs)


def extract_clip_features(
    image_paths: list[str | Path],
    cache_path: str | Path | None = None,
    model_name: str = CLIPArgs.model_name,
    batch_size: int = 4,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = torch.bfloat16,
) -> np.ndarray:
    """Images -> (N, Hp, Wp, hidden) float16 dense patch features
    (pre-projection hidden states, as f3rm uses), read from ``cache_path``
    where it exists and written there otherwise."""
    if cache_path is not None and Path(cache_path).exists():
        logging.info("loading cached CLIP features from %s", cache_path)
        return np.load(cache_path)
    cfg, params = load_clip_vision(model_name)
    images = load_views(image_paths, cfg.image_size, cfg.patch_size)
    feats = extract_clip_features_torch(images, params, cfg, dtype=dtype,
                                        batch_size=batch_size, device=device)
    feats = feats.astype(np.float16)
    if cache_path is not None:
        Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
        np.save(cache_path, feats)
        logging.info("cached CLIP features to %s", cache_path)
    return feats
