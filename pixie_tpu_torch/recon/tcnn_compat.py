"""tiny-cuda-nn checkpoint compatibility (port of pixie_tpu/recon/tcnn_compat.py).

The reference trains its fields with tcnn (f3rm/feature_field.py:71-82
``tcnn.NetworkWithInputEncoding``; nerfstudio MLPWithHashEncoding,
field_components/mlp.py:251-269) and its checkpoints store each field as
ONE flat parameter vector.  This module reproduces tcnn's inference
semantics in plain PyTorch and splits the flat vector, so that an upstream
f3rm ``step-*.ckpt`` can be voxelized:

  * per-level scale_l = base_resolution * growth^l - 1;
    resolution_l = ceil(scale_l) + 1
  * entries per level = next_multiple(min(resolution^3, 2^log2_hashmap), 8)
  * sampling: pos = x * scale + 0.5; floor/fract; trilinear over 8 corners,
    corners clipped to [0, resolution - 1]
  * dense index (stride: dim 0 fastest) when resolution^3 fits the table,
    else xor-hash with primes (1, 2654435761, 805459861), modulo entries
  * frequency encoding: per dim, per frequency, (sin, cos) with
    angle = x * 2^f * pi, dim-major
  * MLP: no biases, widths padded to multiples of 16, weights row-major
    (out, in) concatenated layer by layer; encoded inputs padded with ONES
  * the flat buffer is [network params | encoding params] (network first),
    which ``detect_layout`` checks by the parameters' magnitudes.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np
import torch
from torch import nn

from pixie_tpu_torch.recon.field_adapter import (
    query_grid_chunks, use_fp32_matmuls, world_to_unit,
)
from pixie_tpu_torch.recon.hashgrid import PRIMES, cell_corners, sh_encoding, sum_corners

_U32 = 0xFFFFFFFF


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class TcnnGridConfig:
    """HashGrid hyperparameters (tcnn encoding_config)."""

    n_levels: int = 12
    features_per_level: int = 8
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    growth: float = 1.0  # per_level_scale

    @classmethod
    def from_min_max(cls, n_levels, features_per_level, log2_hashmap_size,
                     base_resolution, max_resolution) -> "TcnnGridConfig":
        growth = (float(np.exp((np.log(max_resolution) - np.log(base_resolution))
                               / (n_levels - 1))) if n_levels > 1 else 1.0)
        return cls(n_levels, features_per_level, log2_hashmap_size, base_resolution, growth)

    def level_scale(self, level: int) -> float:
        # tcnn grid.h: scale = exp2(level * log2_per_level_scale) * base - 1
        return float(np.exp2(level * np.log2(self.growth)) * self.base_resolution - 1.0)

    def level_resolution(self, level: int) -> int:
        return int(np.ceil(self.level_scale(level))) + 1

    def level_entries(self, level: int) -> int:
        res = self.level_resolution(level)
        return _next_multiple(min(res ** 3, 1 << self.log2_hashmap_size), 8)

    def level_is_hashed(self, level: int) -> bool:
        return self.level_resolution(level) ** 3 > (1 << self.log2_hashmap_size)

    @property
    def level_offsets(self) -> tuple[int, ...]:
        offs, acc = [], 0
        for l in range(self.n_levels):
            offs.append(acc)
            acc += self.level_entries(l)
        return tuple(offs + [acc])

    @property
    def n_params(self) -> int:
        return self.level_offsets[-1] * self.features_per_level

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.features_per_level


class TcnnHashGrid(nn.Module):
    """HashGrid encoding with tcnn's indexing.  Parameter ``table``
    (total entries, features_per_level), levels concatenated."""

    def __init__(self, config: TcnnGridConfig):
        super().__init__()
        self.config = config
        self.table = nn.Parameter(torch.zeros(config.level_offsets[-1],
                                              config.features_per_level))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        pts = x.reshape(-1, 3).to(torch.float32)
        outs = []
        for level in range(cfg.n_levels):
            res, entries = cfg.level_resolution(level), cfg.level_entries(level)
            offset = cfg.level_offsets[level]
            # tcnn's corner order: bit 0 is the x offset
            cells, w = cell_corners(pts * cfg.level_scale(level) + 0.5, res - 1, x_bit=0)
            cx, cy, cz = cells.unbind(-1)
            if cfg.level_is_hashed(level):
                h = (cx * PRIMES[0]) & _U32
                h = h ^ ((cy * PRIMES[1]) & _U32)
                h = h ^ ((cz * PRIMES[2]) & _U32)
                idx = h % entries
            else:   # dense stride: dim 0 fastest (tcnn grid_index)
                idx = cx + cy * res + cz * res * res
            outs.append(sum_corners(w[..., None] * self.table[offset + idx]))
        return torch.cat(outs, dim=-1).reshape(*x.shape[:-1], cfg.out_dim)


def tcnn_frequency_encoding(x: torch.Tensor, n_frequencies: int) -> torch.Tensor:
    """tcnn Frequency encoding: dim-major, per frequency (sin, cos),
    angle = x * 2^f * pi (frequency.h)."""
    freqs = (2.0 ** torch.arange(n_frequencies, dtype=torch.float32, device=x.device)) * np.pi
    ang = x[..., :, None] * freqs
    pairs = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pairs.reshape(*x.shape[:-1], x.shape[-1] * n_frequencies * 2)


@dataclasses.dataclass(frozen=True)
class TcnnMLPConfig:
    """FullyFusedMLP widths (no biases; padded to multiples of 16)."""

    in_dim: int          # unpadded encoding output width
    out_dim: int         # unpadded network output width
    hidden: int = 64
    n_hidden_layers: int = 2

    @property
    def in_padded(self) -> int:
        return _next_multiple(self.in_dim, 16)

    @property
    def out_padded(self) -> int:
        return _next_multiple(self.out_dim, 16)

    @property
    def layer_shapes(self) -> tuple[tuple[int, int], ...]:
        """(out, in) row-major matrices, input layer first."""
        shapes = [(self.hidden, self.in_padded)]
        shapes += [(self.hidden, self.hidden)] * (self.n_hidden_layers - 1)
        shapes.append((self.out_padded, self.hidden))
        return tuple(shapes)

    @property
    def n_params(self) -> int:
        return sum(o * i for o, i in self.layer_shapes)


class TcnnMLP(nn.Module):
    """ReLU MLP with tcnn's padded, bias-free layout: parameters ``w{i}``
    (out, in); the input is padded to the padded width with ``pad_value``
    (tcnn pads encoded outputs with 1.0)."""

    def __init__(self, config: TcnnMLPConfig, pad_value: float = 1.0):
        super().__init__()
        self.config, self.pad_value = config, pad_value
        for li, shape in enumerate(config.layer_shapes):
            setattr(self, f"w{li}", nn.Parameter(torch.zeros(shape)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        pad = cfg.in_padded - x.shape[-1]
        if pad:
            x = torch.cat([x, torch.full((*x.shape[:-1], pad), self.pad_value, dtype=x.dtype,
                                         device=x.device)], dim=-1)
        n = len(cfg.layer_shapes)
        for li in range(n):
            x = x @ getattr(self, f"w{li}").T
            if li < n - 1:
                x = torch.relu(x)
        return x[..., :cfg.out_dim]


class TcnnNetworkWithInputEncoding(nn.Module):
    """HashGrid [+ Frequency PE] -> FullyFusedMLP, tcnn's layout: f3rm's
    FeatureField (feature_field.py:46-83) with ``pe_n_freq`` 6, nerfstudio's
    MLPWithHashEncoding with 0."""

    def __init__(self, grid: TcnnGridConfig, mlp: TcnnMLPConfig, pe_n_freq: int = 0):
        super().__init__()
        self.pe_n_freq = pe_n_freq
        self.grid = TcnnHashGrid(grid)
        self.mlp = TcnnMLP(mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc = self.grid(x)
        if self.pe_n_freq:
            enc = torch.cat([enc, tcnn_frequency_encoding(x, self.pe_n_freq)], dim=-1)
        return self.mlp(enc)


# -- flat-buffer conversion ------------------------------------------------------

def detect_layout(flat: np.ndarray, n_net: int, n_enc: int) -> bool:
    """True if the buffer is [network | encoding]: hash tables start at
    U(-1e-4, 1e-4) and stay far smaller than the MLP's weights."""
    head = flat[:min(n_net, n_enc)]
    tail = flat[-min(n_net, n_enc):]
    return float(np.abs(head).mean()) >= float(np.abs(tail).mean())


def _mlp_state(net_flat: np.ndarray, mlp: TcnnMLPConfig, prefix: str = "") -> dict:
    out, off = {}, 0
    for li, (o, i) in enumerate(mlp.layer_shapes):
        out[f"{prefix}w{li}"] = torch.as_tensor(net_flat[off:off + o * i].reshape(o, i).copy())
        off += o * i
    return out


def split_tcnn_params(flat: np.ndarray, grid: TcnnGridConfig, mlp: TcnnMLPConfig,
                      network_first: bool | None = None) -> dict[str, torch.Tensor]:
    """Flat tcnn buffer -> state dict of ``TcnnNetworkWithInputEncoding``."""
    flat = np.asarray(flat, np.float32).ravel()
    n_net, n_enc = mlp.n_params, grid.n_params
    if flat.size != n_net + n_enc:
        raise ValueError(f"tcnn buffer has {flat.size} params; expected {n_net} (network) + "
                         f"{n_enc} (encoding) = {n_net + n_enc}")
    if network_first is None:
        network_first = detect_layout(flat, n_net, n_enc)
        logging.info("tcnn layout autodetect: network_first=%s", network_first)
    net_flat, enc_flat = ((flat[:n_net], flat[n_net:]) if network_first
                          else (flat[n_enc:], flat[:n_enc]))
    table = enc_flat.reshape(grid.level_offsets[-1], grid.features_per_level)
    return {"grid.table": torch.as_tensor(table.copy()), **_mlp_state(net_flat, mlp, "mlp.")}


# -- f3rm / nerfacto checkpoint loading -------------------------------------------

F3RM_GRID = TcnnGridConfig.from_min_max(12, 8, 19, 16, 128)
F3RM_MLP = TcnnMLPConfig(in_dim=F3RM_GRID.out_dim + 3 * 6 * 2,  # hashgrid 96 + PE 36
                         out_dim=768, hidden=64, n_hidden_layers=2)
NERFACTO_HEAD_MLP = TcnnMLPConfig(
    # SH degree-4 dirs (16) + geo_feat (15) + appearance embedding (32)
    in_dim=16 + 15 + 32, out_dim=3, hidden=64, n_hidden_layers=2)


def f3rm_feature_field() -> TcnnNetworkWithInputEncoding:
    """The reference CLIP feature field (feature_field.py:20-83)."""
    return TcnnNetworkWithInputEncoding(F3RM_GRID, F3RM_MLP, pe_n_freq=6)


def nerfacto_density_field(num_levels=16, features_per_level=2, log2_hashmap_size=19,
                           base_res=16, max_res=2048, hidden_dim=64, num_layers=2,
                           geo_feat_dim=15) -> TcnnNetworkWithInputEncoding:
    """Nerfacto's mlp_base (nerfacto_field.py:134-146): hashgrid -> MLP ->
    (density before activation, geo_feat)."""
    grid = TcnnGridConfig.from_min_max(num_levels, features_per_level, log2_hashmap_size,
                                       base_res, max_res)
    mlp = TcnnMLPConfig(in_dim=grid.out_dim, out_dim=1 + geo_feat_dim, hidden=hidden_dim,
                        n_hidden_layers=num_layers - 1)
    return TcnnNetworkWithInputEncoding(grid, mlp, pe_n_freq=0)


def find_tcnn_buffers(state_dict: dict) -> dict:
    """Locate the flat tcnn buffers in a nerfstudio checkpoint state dict."""
    out = {}
    for key, value in state_dict.items():
        if key.endswith("feature_field.field.params"):
            out["feature_field"] = np.asarray(value, np.float32)
        elif key.endswith("field.mlp_base.model.params") or key.endswith("field.mlp_base.params"):
            out["mlp_base"] = np.asarray(value, np.float32)
        elif "mlp_head" in key and key.endswith("params"):
            out["mlp_head"] = np.asarray(value, np.float32)
        elif key.endswith("embedding_appearance.embedding.weight"):
            out["appearance"] = np.asarray(value, np.float32)
    return out


def _loaded(module: nn.Module, state: dict) -> dict:
    module.load_state_dict(state)
    return {"module": module, "params": state}


class TcnnFieldAdapter:
    """World-space queries over converted tcnn fields, the duck type the
    voxelizer consumes (f3rm_robot/field_adapter.py:28-72): density from
    nerfacto's mlp_base, average_init_density * exp(clip(h, -15, 15));
    CLIP features from the feature field; RGB from the SH-direction colour
    head with the mean appearance embedding, as nerfstudio's eval does
    (nerfacto_field.py:253-257).  Without mlp_base the density is 1, and
    without the head the colour 0.5."""

    def __init__(self, fields: dict, world_to_nerf_scale: float = 1.0,
                 world_to_nerf_transform: np.ndarray | None = None,
                 average_init_density: float = 1.0, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        use_fp32_matmuls(self.device)
        self.fields = fields
        self.feat = fields["feature_field"]["module"].to(self.device).eval()
        self.base = fields["mlp_base"]["module"].to(self.device).eval() \
            if "mlp_base" in fields else None
        self.head = fields["mlp_head"]["module"].to(self.device).eval() \
            if "mlp_head" in fields else None
        app = fields.get("appearance")
        self.appearance = (None if app is None else
                           torch.as_tensor(app["mean"], device=self.device))
        self.average_init_density = float(average_init_density)
        self.scale = float(world_to_nerf_scale)
        self.transform = (np.asarray(world_to_nerf_transform, np.float32)
                          if world_to_nerf_transform is not None else None)

    def _to_unit(self, world_points) -> torch.Tensor:
        return torch.as_tensor(world_to_unit(world_points, self.scale, self.transform),
                               device=self.device)

    def _density_feature(self, pts01: torch.Tensor):
        feature = self.feat(pts01)
        if self.base is None:
            return torch.ones((*pts01.shape[:-1], 1), device=self.device), feature
        h = self.base(pts01)
        return self.average_init_density * torch.exp(torch.clamp(h[..., :1], -15.0, 15.0)), \
            feature

    def _rgb(self, pts01: torch.Tensor) -> torch.Tensor:
        if self.base is None or self.head is None:
            return torch.full((*pts01.shape[:-1], 3), 0.5, device=self.device)
        geo = self.base(pts01)[..., 1:16]
        d = sh_encoding(torch.zeros_like(pts01), degree=4)
        emb = (self.appearance.expand(*pts01.shape[:-1], -1) if self.appearance is not None
               else torch.zeros((*pts01.shape[:-1], 32), device=self.device))
        return torch.sigmoid(self.head(torch.cat([d, geo, emb], dim=-1)))

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
        """The voxelizer's grid query on the device (``query_grid_chunks``)."""
        return query_grid_chunks(self._density_feature, self._rgb,
                                 world_to_unit(world_points, self.scale, self.transform),
                                 chunk_size, delta, alpha_weighted, self.device)


def load_f3rm_checkpoint(ckpt_path: str | Path, network_first: bool | None = None) -> dict:
    """A nerfstudio/f3rm ``step-*.ckpt`` -> {"feature_field": {"module",
    "params"}, "mlp_base": ..., "mlp_head": ..., "appearance": {"mean",
    "dim"}}, each present where the checkpoint has it; the modules hold
    their parameters, on the CPU."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state = ckpt.get("pipeline", ckpt)
    state = {k: v for k, v in state.items() if hasattr(v, "numpy")}
    buffers = find_tcnn_buffers({k: v.float().numpy() for k, v in state.items()})
    if "feature_field" not in buffers:
        raise KeyError(f"no feature_field.field.params in {ckpt_path}; keys tail: "
                       f"{sorted(state)[-5:]}")
    out = {"feature_field": _loaded(f3rm_feature_field(), split_tcnn_params(
        buffers["feature_field"], F3RM_GRID, F3RM_MLP, network_first))}
    if "mlp_base" in buffers:
        # max_res is nerfacto's one free size: match the buffer's length
        for max_res in (2048, 1024, 4096, 8192, 512):
            mod = nerfacto_density_field(max_res=max_res)
            try:
                params = split_tcnn_params(buffers["mlp_base"], mod.grid.config,
                                           mod.mlp.config, network_first)
            except ValueError:
                continue
            out["mlp_base"] = _loaded(mod, params)
            break
        else:
            logging.warning("mlp_base buffer size matches no known nerfacto config; "
                            "skipping density field")
    if "mlp_head" in buffers:
        flat = np.asarray(buffers["mlp_head"], np.float32).ravel()
        if flat.size == NERFACTO_HEAD_MLP.n_params:
            out["mlp_head"] = _loaded(TcnnMLP(NERFACTO_HEAD_MLP),
                                      _mlp_state(flat, NERFACTO_HEAD_MLP))
        else:
            logging.warning("mlp_head buffer size %d matches no known config", flat.size)
    if "appearance" in buffers:
        emb = np.asarray(buffers["appearance"], np.float32)
        # eval-time nerfstudio uses the MEAN appearance embedding
        # (nerfacto_field.py:253-257, use_average_appearance_embedding)
        out["appearance"] = {"mean": emb.mean(axis=0), "dim": emb.shape[1]}
    return out
