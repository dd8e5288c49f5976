"""3D U-Net material predictors as ``nn.Module``s (port of
pixie_tpu/models/unet3d.py; reference Wavelet-Generation
models/module/diffusion_network.py, training_discrete.py:50-88,
training_continuous_mse.py:48-89).

Modules and attribute names follow the reference torch code, so the
``state_dict`` keys are the released ``epoch_*.pth`` keys that
pixie_tpu/models/convert_torch.py reads (``projector.net.*``,
``unet.input_blocks.*``, ``unet.middle_block.*``, ``unet.output_blocks.*``,
``unet.out.*``): a released checkpoint loads with no conversion.

Inside the nets the layout is NCDHW.  The heads take and return
channel-last (B, D, H, W, C) tensors, the JAX package's layout.  The TPU
formulations of the JAX package (3x3x3 convs as 2D convs, split-input convs,
lane-packed joint nets) are not ported: convolutions are ``nn.Conv3d``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _act() -> nn.Module:
    return nn.LeakyReLU(0.02)


def _conv(cin: int, cout: int, k: int = 3, stride: int = 1) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, stride=stride, padding=k // 2)


def _zero(m: nn.Module) -> nn.Module:
    """zero_module (nn.py:68-74): output convs start at zero."""
    for p in m.parameters():
        nn.init.zeros_(p)
    return m


class SpatialLayerNorm(nn.LayerNorm):
    """LayerNorm over the three spatial dims of NCDHW with (sp,sp,sp) affine
    shared across channels (the reference's normalization of MyResBlock)."""

    def __init__(self, sp: int, eps: float = 1e-5):
        super().__init__([sp, sp, sp], eps=eps)


class MyResBlock(nn.Module):
    """LayerNorm-act-conv x2 residual block (diffusion_network.py:639-710)."""

    def __init__(self, in_channels: int, out_channels: int, sp: int):
        super().__init__()
        self.in_layers = nn.Sequential(SpatialLayerNorm(sp), _act(),
                                       _conv(in_channels, out_channels))
        # the reference's (training-only) dropout sits at index 2, so the
        # output conv keeps its checkpoint key out_layers.3
        self.out_layers = nn.Sequential(SpatialLayerNorm(sp), _act(), nn.Dropout(0.0),
                                        _zero(_conv(out_channels, out_channels)))
        self.skip_connection = (nn.Identity() if in_channels == out_channels
                                else _conv(in_channels, out_channels, 1))

    def forward(self, x):
        return self.skip_connection(x) + self.out_layers(self.in_layers(x))


class AttentionBlock(nn.Module):
    """Self-attention over flattened voxels (diffusion_network.py:192-262):
    GroupNorm(32), 1x1 qkv, softmax(q k / sqrt(sqrt(d))) in float32; one head,
    as every shipped config."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(min(32, channels), channels, eps=1e-5)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = _zero(nn.Conv1d(channels, channels, 1))

    def forward(self, x):
        b, c, *spatial = x.shape
        flat = x.reshape(b, c, -1)
        q, k, v = self.qkv(self.norm(flat)).split(c, dim=1)
        scale = float(1.0 / np.sqrt(np.sqrt(np.float32(c))))
        weight = torch.einsum("bct,bcs->bts", q * scale, k * scale)
        weight = torch.softmax(weight.float(), dim=-1).to(weight.dtype)
        a = torch.einsum("bts,bcs->bct", weight, v)
        return (flat + self.proj_out(a)).reshape(b, c, *spatial)


class Downsample(nn.Module):
    """Stride-2 conv (diffusion_network.py:75-97)."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = _conv(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest x2 + conv (diffusion_network.py:50-71)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class FeatureProjector(nn.Module):
    """CLIP-feature projector (diffusion_network.py:534-589): deep variant
    [1x1 conv, GN, SiLU, 3x3 conv, GN, SiLU, 1x1 conv, GN] when a hidden width
    is given, else [1x1 conv, GN, SiLU]."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int | None = None):
        super().__init__()
        if hidden_channels is None:
            self.net = nn.Sequential(
                _conv(in_channels, out_channels, 1),
                nn.GroupNorm(max(out_channels // 2, 1), out_channels, eps=1e-5),
                nn.SiLU())
        else:
            gh, go = min(32, hidden_channels), min(32, out_channels)
            self.net = nn.Sequential(
                _conv(in_channels, hidden_channels, 1),
                nn.GroupNorm(gh, hidden_channels, eps=1e-5), nn.SiLU(),
                _conv(hidden_channels, hidden_channels, 3),
                nn.GroupNorm(gh, hidden_channels, eps=1e-5), nn.SiLU(),
                _conv(hidden_channels, out_channels, 1),
                nn.GroupNorm(go, out_channels, eps=1e-5))

    def forward(self, x):
        return self.net(x)


class MyUNetModel(nn.Module):
    """The reference U-Net (diffusion_network.py:712-935), NCDHW."""

    def __init__(self, in_channels: int, model_channels: int = 64, out_channels: int = 8,
                 num_res_blocks: int = 3, channel_mult: Sequence[int] = (1, 1, 2, 4),
                 attention_resolutions: Sequence[int] = (), spatial_size: int = 64):
        super().__init__()
        mc = model_channels
        self.input_blocks = nn.ModuleList([nn.Sequential(_conv(in_channels, mc))])
        chans, ch, ds, sp, sizes = [mc], mc, 1, spatial_size, [spatial_size]
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [MyResBlock(ch, mult * mc, sp)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch))
                self.input_blocks.append(nn.Sequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.Sequential(Downsample(ch)))
                chans.append(ch)
                sizes.append(sp)
                ds *= 2
                sp = (sp + 1) // 2
        self.middle_block = nn.Sequential(MyResBlock(ch, ch, sp), AttentionBlock(ch),
                                          MyResBlock(ch, ch, sp))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [MyResBlock(ch + chans.pop(), mc * mult, sp)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                    sp = sizes.pop()
                self.output_blocks.append(nn.Sequential(*layers))
        self.out = nn.Sequential(SpatialLayerNorm(sp), _act(), _zero(_conv(ch, out_channels)))

    def forward(self, x):
        hs = []
        h = x
        for block in self.input_blocks:
            h = block(h)
            hs.append(h)
        h = self.middle_block(h)
        for block in self.output_blocks:
            skip = hs.pop()
            # crop odd sizes (diffusion_network.py:913-919)
            h = h[:, :, :skip.shape[2], :skip.shape[3], :skip.shape[4]]
            h = block(torch.cat([h, skip], dim=1))
        return self.out(h)


class _MaterialHead(nn.Module):
    """Projector + U-Net; channel-last (B, D, H, W, C) in and out."""

    def __init__(self, out_channels: int, feature_channels: int = 768, cond_dim: int = 32,
                 model_channels: int = 64, num_res_blocks: int = 3,
                 channel_mult: Sequence[int] = (1, 1, 2, 4),
                 attention_resolutions: Sequence[int] = (), grid_size: int = 64):
        super().__init__()
        if feature_channels != cond_dim:
            hidden = 128 if feature_channels > cond_dim else None
            self.projector = FeatureProjector(feature_channels, cond_dim, hidden)
        else:
            self.projector = None
        self.unet = MyUNetModel(cond_dim, model_channels, out_channels, num_res_blocks,
                                tuple(channel_mult), tuple(attention_resolutions), grid_size)

    def forward(self, feat_grid: torch.Tensor) -> torch.Tensor:
        x = feat_grid.permute(0, 4, 1, 2, 3)
        if self.projector is not None:
            x = self.projector(x)
        return self.unet(x).permute(0, 2, 3, 4, 1)


class SegmentationUNet(_MaterialHead):
    """Discrete material classifier (training_discrete.py:50-88)."""

    def __init__(self, num_classes: int = 8, **kw):
        super().__init__(num_classes, **kw)


class RegressionUNet(_MaterialHead):
    """Continuous (density, E, nu) regressor (training_continuous_mse.py:48-89)."""

    def __init__(self, out_channels: int = 3, **kw):
        super().__init__(out_channels, **kw)


def seeded_state_dict(model: nn.Module, seed: int, head_scale: float = 1.0) -> dict:
    """Random non-zero weights for ``model`` from a numpy seed (no released
    weights are needed to drive or test the nets).

    Conv weights ~ N(0, 1/fan_in), biases ~ N(0, 0.05^2), norm affines
    1 + N(0, 0.1^2) and N(0, 0.1^2).  The U-Net's output conv
    (``unet.out.2``) is scaled by ``head_scale``.  Zero-initialized convs get
    random weights too, so every weight takes part.
    """
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("weight") and len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name.endswith("weight"):
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif len(shape) == 3:  # SpatialLayerNorm bias (sp, sp, sp)
            a = 0.1 * rng.normal(size=shape)
        else:
            a = 0.05 * rng.normal(size=shape)
        if name.startswith("unet.out.2."):
            a = a * head_scale
        out[name] = torch.as_tensor(a.astype(np.float32))
    return out
