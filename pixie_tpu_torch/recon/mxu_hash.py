"""The MXU-layout hash encoding of the JAX package, as a gather (port of
pixie_tpu/recon/mxu_hash.py).

The JAX package stores each level's table as ``tab[lo, hi, f]`` for table
index ``idx = hi * LO + lo`` and looks corners up with two one-hot
contractions on the TPU's matrix unit (mxu_hash.py:93-148).  The one-hot
products select one row each, so the same function is a gather of
``table[level, idx % LO, idx // LO]``: that is what this module computes.
LO and HI are read from the table's shape.

With ``bf16_dots`` (the JAX default) the contraction's operands are bfloat16:
the trilinear weight and the table are rounded to bfloat16 before the
product, which is then exact in float32, and the 8 corners accumulate in
float32 in corner order, as JAX's dot with float32 accumulation does.  The
stored table is shifted by -1e-4 before the rounding (mxu_hash.py:170).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from pixie_tpu_torch.recon.hashgrid import (
    TABLE_SHIFT, cell_corners, gather_rows, hash_corners, sum_corners,
)


@dataclasses.dataclass(frozen=True)
class MXUHashConfig:
    n_levels: int = 12
    features_per_level: int = 8
    lo: int = 64
    hi: int = 64
    base_resolution: int = 16
    max_resolution: int = 128
    bf16_dots: bool = True  # bfloat16 operands, float32 accumulation

    @property
    def table_size(self) -> int:
        return self.lo * self.hi

    @property
    def growth(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return float(np.exp((np.log(self.max_resolution) - np.log(self.base_resolution))
                            / (self.n_levels - 1)))

    @property
    def resolutions(self) -> tuple[int, ...]:
        return tuple(int(np.floor(self.base_resolution * self.growth ** l))
                     for l in range(self.n_levels))

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.features_per_level


def encode_points(pts: torch.Tensor, table: torch.Tensor, cfg: MXUHashConfig) -> torch.Tensor:
    """(B, 3) in [0, 1] x (L, LO, HI, F) table (already shifted) -> (B, L*F)."""
    _, lo, hi, f = table.shape
    if cfg.bf16_dots:
        table = table.to(torch.bfloat16).to(torch.float32)
    outs = []
    for level, res in enumerate(cfg.resolutions):
        rows = table[level].reshape(lo * hi, f)
        cells, w = cell_corners(pts * res, res)
        idx = hash_corners(*cells.unbind(-1), lo * hi, res)
        if cfg.bf16_dots:
            w = w.to(torch.bfloat16).to(torch.float32)
        outs.append(sum_corners(w[..., None] * gather_rows(rows, (idx % lo) * hi + idx // lo)))
    return torch.cat(outs, dim=-1)


class MXUHashEncoding(nn.Module):
    """The JAX package's MXU hash encoding: input (..., 3) in [0, 1] ->
    (..., n_levels * features_per_level).  Parameter ``table``
    (n_levels, lo, hi, features_per_level)."""

    def __init__(self, config: MXUHashConfig = MXUHashConfig()):
        super().__init__()
        self.config = config
        self.table = nn.Parameter(torch.zeros(
            config.n_levels, config.lo, config.hi, config.features_per_level))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = encode_points(x.reshape(-1, 3), self.table - TABLE_SHIFT, self.config)
        return out.reshape(*x.shape[:-1], self.config.out_dim)
