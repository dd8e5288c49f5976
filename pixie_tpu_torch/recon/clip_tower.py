"""CLIP vision tower for dense patch-feature extraction (port of
pixie_tpu/recon/clip_jax.py).

Channel-last patchify as one product, pre-LN transformer blocks, the class
token first, as HF's ``CLIPVisionModel`` computes ``last_hidden_state``.
f3rm extracts at shortest edge 336 without a centre crop
(f3rm/features/clip_extract.py:11-89), so rectangular patch grids are the
common case: the position embedding's grid is resized as JAX's
``jax.image.resize(..., "cubic")`` resizes it (Keys a = -0.5, antialiased
when shrinking), which is ``F.interpolate(mode="bicubic", antialias=True)``.

With ``dtype`` (bfloat16, as ``extract_clip_features_torch`` runs by
default) the residual stream, the products and their outputs are in that
dtype, as flax's ``dtype=`` runs them: LayerNorm statistics are taken in
float32 (E[x^2] - E[x]^2, flax's fast variance), attention logits and
softmax in float32.

``convert_clip_vision_state_dict`` maps an HF ``CLIPVisionModel`` (or
``CLIPModel``) state dict onto the tower's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    patch_size: int = 14
    image_size: int = 336
    layer_norm_eps: float = 1e-5

    @classmethod
    def vit_l_14_336(cls):
        return cls()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: float32 statistics (fast variance), the
    result in ``x``'s dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """A linear layer in ``x``'s dtype (flax ``Dense(dtype=...)``)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        self.ln1 = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.qkv = nn.Linear(c.hidden_size, 3 * c.hidden_size)   # rows q, k, v
        self.proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.ln2 = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, t, _ = h.shape
        heads, hd = c.num_attention_heads, c.hidden_size // c.num_attention_heads
        qkv = _dense(self.ln1(h), self.qkv).reshape(b, t, 3, heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))      # (b, heads, t, hd)
        # float32 logits and softmax (bfloat16 products are exact in float32)
        logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
        attn = torch.softmax(logits * (1.0 / math.sqrt(hd)), dim=-1)
        out = torch.matmul(attn.to(v.dtype), v).transpose(1, 2).reshape(b, t, c.hidden_size)
        h = h + _dense(out, self.proj)
        return h + _dense(quick_gelu(_dense(self.ln2(h), self.fc1)), self.fc2)


def resize_position_grid(grid: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """(side, side, C) -> (hp, wp, C): ``jax.image.resize(..., "cubic")``."""
    out = F.interpolate(grid.permute(2, 0, 1)[None], size=(hp, wp), mode="bicubic",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0)


class CLIPVisionTower(nn.Module):
    """pixel_values (B, H, W, 3) channel-last, CLIP-normalized, H and W
    multiples of the patch -> last_hidden_state (B, 1 + Hp*Wp, hidden),
    the class token first, as HF.  ``dtype``: the dtype the blocks run in
    (None: the input's, float32)."""

    def __init__(self, cfg: CLIPVisionConfig, dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        p, side = cfg.patch_size, cfg.image_size // cfg.patch_size
        self.patch_kernel = nn.Parameter(torch.zeros(p * p * 3, cfg.hidden_size))
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.position_embedding = nn.Parameter(torch.zeros(1 + side * side, cfg.hidden_size))
        self.pre_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, h, w, _ = pixel_values.shape
        p = c.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} is not a multiple of the patch size {p}")
        hp, wp = h // p, w // p
        # patchify as one product: (B, Hp*Wp, p*p*3) @ (p*p*3, hidden)
        x = pixel_values.reshape(b, hp, p, wp, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, hp * wp, p * p * 3)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x @ self.patch_kernel.to(x.dtype)

        side = c.image_size // p
        pos_cls, pos_grid = self.position_embedding[:1], self.position_embedding[1:]
        if (hp, wp) != (side, side):
            pos_grid = resize_position_grid(pos_grid.reshape(side, side, -1), hp, wp)
            pos_grid = pos_grid.reshape(hp * wp, -1)
        x = torch.cat([self.class_embedding.to(x.dtype).expand(b, 1, -1), x], dim=1)
        x = x + torch.cat([pos_cls, pos_grid], dim=0).to(x.dtype)
        x = self.pre_ln(x)
        for layer in self.layers:
            x = layer(x)
        return x


def convert_clip_vision_state_dict(state_dict, cfg: CLIPVisionConfig) -> dict:
    """HF CLIPVisionModel state dict (torch tensors or numpy; keys
    ``vision_model.embeddings.*``, ``vision_model.encoder.layers.{i}.*``,
    ``vision_model.pre_layrnorm.*``, the prefix optional) -> the state dict
    of ``CLIPVisionTower``."""

    def get(k):
        return torch.as_tensor(np.asarray(state_dict[k], np.float32)
                               if not isinstance(state_dict[k], torch.Tensor)
                               else state_dict[k].detach().to(torch.float32).cpu())

    pref = "vision_model." if any(k.startswith("vision_model.") for k in state_dict) else ""
    conv = get(pref + "embeddings.patch_embedding.weight")     # (hidden, 3, p, p)
    out = {
        # (p_row, p_col, rgb) flattening, as the channel-last patchify
        "patch_kernel": conv.permute(2, 3, 1, 0).reshape(-1, conv.shape[0]),
        "class_embedding": get(pref + "embeddings.class_embedding"),
        "position_embedding": get(pref + "embeddings.position_embedding.weight"),
        "pre_ln.weight": get(pref + "pre_layrnorm.weight"),
        "pre_ln.bias": get(pref + "pre_layrnorm.bias"),
    }
    for i in range(cfg.num_hidden_layers):
        hf, mine = f"{pref}encoder.layers.{i}.", f"layers.{i}."
        out[mine + "qkv.weight"] = torch.cat(
            [get(f"{hf}self_attn.{n}_proj.weight") for n in "qkv"], dim=0)
        out[mine + "qkv.bias"] = torch.cat([get(f"{hf}self_attn.{n}_proj.bias") for n in "qkv"])
        for src, dst in (("self_attn.out_proj", "proj"), ("layer_norm1", "ln1"),
                         ("layer_norm2", "ln2"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            for leaf in ("weight", "bias"):
                out[f"{mine}{dst}.{leaf}"] = get(f"{hf}{src}.{leaf}")
    return out


# CLIP image normalization (HF CLIPImageProcessor defaults)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@torch.no_grad()
def extract_clip_features_torch(
    images: np.ndarray,
    params: dict,
    cfg: CLIPVisionConfig | None = None,
    dtype: torch.dtype | None = torch.bfloat16,
    batch_size: int = 4,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """images (N, H, W, 3) float [0,1], patch-aligned, and the tower's state
    dict -> dense patch features (N, Hp, Wp, hidden) float32:
    last_hidden_state less the class token, the layout f3rm distills
    (clip_extract.py:60-89)."""
    cfg = cfg or CLIPVisionConfig.vit_l_14_336()
    tower = CLIPVisionTower(cfg, dtype=dtype)
    tower.load_state_dict(params)
    tower.to(device).eval()
    n, h, w, _ = images.shape
    hp, wp = h // cfg.patch_size, w // cfg.patch_size
    norm = ((np.asarray(images, np.float32) - CLIP_MEAN) / CLIP_STD).astype(np.float32)
    out = torch.empty((n, hp * wp, cfg.hidden_size), dtype=torch.float32, device=device)
    for i in range(0, n, batch_size):
        px = torch.as_tensor(norm[i:i + batch_size], device=device)
        out[i:i + batch_size] = tower(px)[:, 1:].to(torch.float32)
    return out.cpu().numpy().reshape(n, hp, wp, cfg.hidden_size)
