"""Radiance and distilled-feature fields (port of pixie_tpu/recon/field.py:34-146).

``NerfField`` (density + RGB, Nerfacto-lite) and ``FeatureField`` (the
distilled CLIP feature field, f3rm/feature_field.py:20-120): a hash encoding
(the MXU layout by default, ``encoding="hashgrid"`` for the tcnn layout)
into small ReLU MLPs.  The proposal field and the volume renderer belong to
field training and are not in this port.

``state_dict_from_jax`` carries a field's flax parameters (numpy arrays in
the JAX package's tree) into the state dict of the module here, as
``models/convert.py`` does for the U-Nets.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from pixie_tpu_torch.recon.hashgrid import (
    HashGridConfig, HashGridEncoding, frequency_encoding, sh_encoding,
)
from pixie_tpu_torch.recon.mxu_hash import MXUHashConfig, MXUHashEncoding

# the feature field's MXU table layout (field.py:106, PIXIE_FEAT_LOHI's default)
FEAT_LOHI = (128, 32)


class MLP(nn.Module):
    """``depth`` hidden ReLU layers of width ``hidden`` (``dense_{i}``), then
    a linear ``out`` layer."""

    def __init__(self, in_dim: int, hidden: int, depth: int, out: int):
        super().__init__()
        dims = [in_dim] + [hidden] * depth
        self.depth = depth
        for i in range(depth):
            setattr(self, f"dense_{i}", nn.Linear(dims[i], hidden))
        self.out = nn.Linear(dims[-1], out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
        return self.out(x)


def _encoding(kind: str, mxu: MXUHashConfig, hashgrid: HashGridConfig) -> nn.Module:
    if kind == "mxu":
        return MXUHashEncoding(mxu)
    if kind == "hashgrid":
        return HashGridEncoding(hashgrid)
    raise ValueError(f"unknown field encoding {kind!r}: expected 'mxu' or 'hashgrid'")


class NerfField(nn.Module):
    """Density + RGB field: encoding -> density MLP (64, 1 layer) -> density
    exp(clip(h0 - 1, -15, 15)) and a 15-wide geometry feature -> with the
    SH (degree 4) of the view direction -> colour MLP (64, 2 layers) ->
    sigmoid."""

    def __init__(self, geo_dim: int = 15, encoding: str = "mxu"):
        super().__init__()
        self.grid = _encoding(
            encoding,
            MXUHashConfig(n_levels=16, features_per_level=2, lo=128, hi=64,
                          base_resolution=16, max_resolution=512),
            HashGridConfig(n_levels=16, features_per_level=2, log2_table_size=19,
                           base_resolution=16, max_resolution=1024))
        self.density_mlp = MLP(32, 64, 1, 1 + geo_dim)
        self.color_mlp = MLP(geo_dim + 16, 64, 2, 3)

    def forward(self, positions: torch.Tensor, directions: torch.Tensor | None = None,
                density_only: bool = False):
        h = self.density_mlp(self.grid(positions))
        density = torch.exp(torch.clamp(h[..., :1] - 1.0, -15.0, 15.0))
        if density_only:
            return density
        if directions is None:
            directions = torch.zeros_like(positions)
        rgb = self.color_mlp(torch.cat([h[..., 1:], sh_encoding(directions, degree=4)], dim=-1))
        return density, torch.sigmoid(rgb)


class FeatureField(nn.Module):
    """Distilled CLIP feature field: encoding (12 levels x 8) [+ frequency
    PE] -> MLP (64, 2 layers) -> ``feature_dim``.  ``lohi`` is the MXU
    table's (LO, HI) layout."""

    def __init__(self, feature_dim: int = 768, use_pe: bool = True, pe_n_freq: int = 6,
                 encoding: str = "mxu", lohi: tuple[int, int] = FEAT_LOHI):
        super().__init__()
        self.use_pe, self.pe_n_freq = use_pe, pe_n_freq
        self.grid = _encoding(
            encoding,
            MXUHashConfig(n_levels=12, features_per_level=8, lo=lohi[0], hi=lohi[1],
                          base_resolution=16, max_resolution=128),
            HashGridConfig(n_levels=12, features_per_level=8, log2_table_size=19,
                           base_resolution=16, max_resolution=128))
        self.mlp = MLP(96 + (3 * 2 * pe_n_freq if use_pe else 0), 64, 2, feature_dim)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        enc = self.grid(positions)
        if self.use_pe:
            enc = torch.cat([enc, frequency_encoding(positions, self.pe_n_freq)], dim=-1)
        return self.mlp(enc)


def feature_field_for(state_dict: Mapping, encoding: str = "mxu") -> FeatureField:
    """A FeatureField shaped for ``state_dict``: its feature width from the
    MLP's last layer, its MXU (LO, HI) from the table."""
    dim = int(state_dict["mlp.out.weight"].shape[0])
    if encoding == "mxu":
        lo, hi = (int(s) for s in state_dict["grid.table"].shape[1:3])
        return FeatureField(feature_dim=dim, encoding=encoding, lohi=(lo, hi))
    return FeatureField(feature_dim=dim, encoding=encoding)


def state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """A field's flax variables (``{"params": tree}`` or the tree) as numpy or
    JAX arrays -> the state dict of ``NerfField`` / ``FeatureField``: flax
    ``Dense`` kernels (in, out) become ``Linear`` weights (out, in); the
    encodings' ``table`` is carried as stored (the forward shifts it)."""
    tree = params.get("params", params)
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, value in node.items():
            name = f"{prefix}{key}"
            if isinstance(value, Mapping):
                walk(value, name + ".")
            elif key == "kernel":
                out[f"{prefix}weight"] = torch.as_tensor(np.ascontiguousarray(
                    np.asarray(value, np.float32).T))
            else:
                out[name] = torch.as_tensor(np.array(value, np.float32))

    walk(tree, "")
    return out
