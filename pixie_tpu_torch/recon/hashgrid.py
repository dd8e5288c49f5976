"""Multiresolution hash-grid encoding (port of pixie_tpu/recon/hashgrid.py).

tiny-cuda-nn's HashGrid as the reference's feature field and Nerfacto's
density field use it (f3rm/feature_field.py:32-39): Instant-NGP hashing
(Mueller et al. 2022), h(x) = xor_i(x_i * pi_i) mod T with primes
(1, 2654435761, 805459861); levels whose dense size (res+1)^3 fits the table
index directly.  Trilinear interpolation of 8 corners a level; features
concatenated across levels.

The table parameter is stored as the JAX package stores it, U(0, 2e-4) at
init, and the forward subtracts 1e-4 (hashgrid.py:89).  The hash is taken
in int64 with the products cut to 32 bits, which is JAX's uint32 arithmetic
with wraparound.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
TABLE_SHIFT = 1e-4   # the stored table is U(0, 2e-4); the encodings use U(-1e-4, 1e-4)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 12
    features_per_level: int = 8
    log2_table_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 128

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


def hash_corners(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, table_size: int,
                 res: int) -> torch.Tensor:
    """Integer corner coordinates in [0, res] -> int64 table indices: dense
    where (res+1)^3 fits the table, else the xor-prime hash mod T."""
    cx, cy, cz = (c.to(torch.int64) for c in (cx, cy, cz))
    if (res + 1) ** 3 <= table_size:
        return cx * (res + 1) * (res + 1) + cy * (res + 1) + cz
    h = (cx * PRIMES[0]) & _U32
    h = h ^ ((cy * PRIMES[1]) & _U32)
    h = h ^ ((cz * PRIMES[2]) & _U32)
    return h % table_size


@functools.lru_cache(maxsize=None)
def _corner_offsets(x_bit: int, device: torch.device) -> torch.Tensor:
    """(8, 3) int64 offsets of corners 0..7 on ``device``, made once: a
    small tensor put on the card is a synchronizing copy."""
    bits = [[(c >> x_bit) & 1, (c >> 1) & 1, (c >> (2 - x_bit)) & 1] for c in range(8)]
    with torch.inference_mode(False):
        return torch.tensor(bits, dtype=torch.int64, device=device)


def cell_corners(pos: torch.Tensor, hi: int, x_bit: int = 2):
    """(cells, w) of the 8 corners of each (B, 3) grid position's cell:
    cells (B, 8, 3) int64, the corners' integer coordinates clipped to
    [0, hi], and w (B, 8), their trilinear weights (x * y) * z; corner k at
    [:, k].  Corner bit ``x_bit`` is the x offset and bit 2 - x_bit the z
    offset (2: the JAX package's encodings; 0: tcnn's).  All 8 corners in
    one op each: the encodings are launch-bound on the card."""
    off = _corner_offsets(x_bit, pos.device)
    floor = torch.floor(pos)
    frac = (pos - floor)[:, None, :]
    cells = torch.clamp(floor.to(torch.int64)[:, None, :] + off, 0, hi)
    w = torch.where(off == 1, frac, 1.0 - frac)
    return cells, (w[..., 0] * w[..., 1]) * w[..., 2]


def sum_corners(terms: torch.Tensor) -> torch.Tensor:
    """(B, 8, F) -> (B, F): the corners' terms added one at a time to 0 in
    corner order, as the JAX package sums them."""
    acc = torch.zeros_like(terms[:, 0])
    for k in range(8):
        acc = acc + terms[:, k]
    return acc


class HashGridEncoding(nn.Module):
    """Trilinearly interpolated multiresolution hash encoding.

    Input (..., 3) in [0, 1]; output (..., n_levels * features_per_level).
    Parameter ``table`` (n_levels, 2^log2_table_size, features_per_level).
    """

    def __init__(self, config: HashGridConfig = HashGridConfig()):
        super().__init__()
        self.config = config
        self.table = nn.Parameter(torch.zeros(
            config.n_levels, 2 ** config.log2_table_size, config.features_per_level))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        table = self.table - TABLE_SHIFT
        pts = x.reshape(-1, 3)
        outs = []
        for level, res in enumerate(cfg.resolutions):
            cells, w = cell_corners(pts * res, res)
            idx = hash_corners(*cells.unbind(-1), 2 ** cfg.log2_table_size, res)
            outs.append(sum_corners(w[..., None] * table[level, idx]))
        return torch.cat(outs, dim=-1).reshape(*x.shape[:-1], cfg.out_dim)


def frequency_encoding(x: torch.Tensor, n_frequencies: int = 6) -> torch.Tensor:
    """NeRF positional encoding: [sin(2^k pi x), cos(2^k pi x)]_k (per dim)."""
    freqs = 2.0 ** torch.arange(n_frequencies, dtype=x.dtype, device=x.device) * math.pi
    ang = x[..., None] * freqs
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return enc.reshape(*x.shape[:-1], x.shape[-1] * 2 * n_frequencies)


def sh_encoding(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical-harmonics basis up to ``degree`` (tcnn's SH direction
    encoding)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        comps += [-0.48860251190291987 * y, 0.48860251190291987 * z,
                  -0.48860251190291987 * x]
    if degree > 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        comps += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.31539156525252005 * (2.0 * zz - xx - yy),
            -1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if degree > 3:
        comps += [
            0.5900435899266435 * y * (3 * x * x - y * y),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (4 * z * z - x * x - y * y),
            0.3731763325901154 * z * (2 * z * z - 3 * x * x - 3 * y * y),
            0.4570457994644658 * x * (4 * z * z - x * x - y * y),
            1.445305721320277 * z * (x * x - y * y),
            0.5900435899266435 * x * (x * x - 3 * y * y),
        ]
    return torch.stack(comps, dim=-1)
