"""Radiance and distilled-feature fields and their volume renderers (port of
pixie_tpu/recon/field.py).

``NerfField`` (density + RGB, Nerfacto-lite) and ``FeatureField`` (the
distilled CLIP feature field, f3rm/feature_field.py:20-120): a hash encoding
(the MXU layout by default, ``encoding="hashgrid"`` for the tcnn layout)
into small ReLU MLPs; ``ProposalField``, the small density field that picks
the full fields' samples.  ``render_rays`` (a stratified pass, inverse-CDF
resampling, one evaluation on the sorted union) and ``render_rays_prop``
(proposal sampling with the mip-NeRF 360 interlevel loss) compute the JAX
package's functions: its one-hot ``_gather_last`` is ``torch.gather`` and
its compare-count bisects are ``torch.searchsorted``, which return the same
indices and values.  The renders take their uniforms as arguments
(``draw_uniforms`` makes them from a ``torch.Generator``), so that a test
can pass JAX's own draws.

As in the JAX package (``PIXIE_DETACH_SAMPLES=0``, its default), the fine
sample positions are not detached: the rgb loss reaches the proposal field
through them, besides the interlevel loss (nerfacto detaches them).

``state_dict_from_jax`` carries a field's flax parameters (numpy arrays in
the JAX package's tree) into the state dict of the module here, as
``models/convert.py`` does for the U-Nets.
"""

from __future__ import annotations

import dataclasses
import functools
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
    sigmoid.  ``MXU`` / ``HASHGRID``: the two encodings' shipped configs."""

    MXU = MXUHashConfig(n_levels=16, features_per_level=2, lo=128, hi=64,
                        base_resolution=16, max_resolution=512)
    HASHGRID = HashGridConfig(n_levels=16, features_per_level=2, log2_table_size=19,
                              base_resolution=16, max_resolution=1024)

    def __init__(self, geo_dim: int = 15, encoding: str = "mxu"):
        super().__init__()
        self.grid = _encoding(encoding, self.MXU, self.HASHGRID)
        self.density_mlp = MLP(self.grid.config.out_dim, 64, 1, 1 + geo_dim)
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
    table's (LO, HI) layout (None: ``MXU``'s)."""

    MXU = MXUHashConfig(n_levels=12, features_per_level=8, lo=FEAT_LOHI[0], hi=FEAT_LOHI[1],
                        base_resolution=16, max_resolution=128)
    HASHGRID = HashGridConfig(n_levels=12, features_per_level=8, log2_table_size=19,
                              base_resolution=16, max_resolution=128)

    def __init__(self, feature_dim: int = 768, use_pe: bool = True, pe_n_freq: int = 6,
                 encoding: str = "mxu", lohi: tuple[int, int] | None = None):
        super().__init__()
        self.use_pe, self.pe_n_freq = use_pe, pe_n_freq
        mxu = self.MXU if lohi is None else dataclasses.replace(self.MXU, lo=lohi[0], hi=lohi[1])
        self.grid = _encoding(encoding, mxu, self.HASHGRID)
        self.mlp = MLP(self.grid.config.out_dim + (3 * 2 * pe_n_freq if use_pe else 0), 64, 2,
                       feature_dim)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        enc = self.grid(positions)
        if self.use_pe:
            enc = torch.cat([enc, frequency_encoding(positions, self.pe_n_freq)], dim=-1)
        return self.mlp(enc)


class ProposalField(nn.Module):
    """Density-only field for proposal sampling (nerfstudio's
    HashMLPDensityField analog): an MXU hash encoding (5 levels x 2, LO 128,
    HI 16, resolution 16 -> 128) -> MLP (16, 1 layer) -> exp(clip(h - 1,
    -15, 15))."""

    def __init__(self):
        super().__init__()
        self.grid = MXUHashEncoding(MXUHashConfig(n_levels=5, features_per_level=2, lo=128,
                                                  hi=16, base_resolution=16, max_resolution=128))
        self.density_mlp = MLP(10, 16, 1, 1)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        return torch.exp(torch.clamp(self.density_mlp(self.grid(positions)) - 1.0, -15.0, 15.0))


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
    JAX arrays -> the state dict of ``NerfField`` / ``FeatureField`` /
    ``ProposalField``: flax ``Dense`` kernels (in, out) become ``Linear``
    weights (out, in); the encodings' ``table`` is carried as stored (the
    forward shifts it)."""
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


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_coarse: int = 64
    n_fine: int = 64
    near: float = 0.05
    far: float = 3.0
    bg_color: float = 0.0  # BlenderNeRF data has a black background


@functools.lru_cache(maxsize=None)
def _linspace(start: float, stop: float, num: int, device: torch.device) -> torch.Tensor:
    """``jnp.linspace`` in float32, as it computes it (start (1 - s) + stop s
    for s = i / (num - 1), the last value ``stop``), made once a device."""
    with torch.inference_mode(False):
        s = torch.arange(num - 1, dtype=torch.float32, device=device) / np.float32(num - 1)
        out = np.float32(start) * (1.0 - s) + np.float32(stop) * s
        return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def draw_uniforms(n_rays: int, cfg: RenderConfig, generator: torch.Generator):
    """The train-mode renders' uniforms from ``generator`` (on its device):
    (n_rays, n_coarse) for the stratified jitter, (n_rays, n_fine) for the
    inverse CDF."""
    kw = dict(generator=generator, device=generator.device)
    return (torch.rand((n_rays, cfg.n_coarse), **kw),
            torch.rand((n_rays, cfg.n_fine), **kw))


def _alpha_weights(alpha: torch.Tensor) -> torch.Tensor:
    """alpha times the exclusive product of (1 - alpha + 1e-10)."""
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    return alpha * torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)


def _weights_from_sigma(sigma: torch.Tensor, t_edges: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant volume-rendering weights per interval."""
    return _alpha_weights(1.0 - torch.exp(-sigma * (t_edges[..., 1:] - t_edges[..., :-1])))


def _composite(w, rgb, t, bg_color: float) -> dict:
    """rgb (over ``bg_color``), accumulation and depth from the weights."""
    acc = w.sum(-1)
    return {"rgb": (w[..., None] * rgb).sum(-2) + bg_color * (1.0 - acc[..., None]),
            "accumulation": acc, "depth": (w * t).sum(-1), "weights": w}


def _features(feat, pts01, w, out: dict) -> dict:
    """The feature render with detached weights: the feature loss must not
    shape the geometry (f3rm/model.py)."""
    out["feature"] = (w.detach()[..., None] * feat(pts01)).sum(-2)
    return out


def render_rays(nerf, feat, origins, directions, cfg: RenderConfig, train: bool = True,
                with_features: bool = True, draws=None) -> dict:
    """Hierarchical volume rendering of rgb / features / depth / accumulation:
    n_coarse stratified samples (jittered by ``draws[0]`` in training, bin
    centres otherwise), n_fine inverse-CDF samples from their weights
    (``draws[1]``, else evenly spaced), one evaluation of ``nerf`` (and
    ``feat``) on the sorted union."""
    n_rays, dev = origins.shape[0], origins.device
    t_coarse = _linspace(cfg.near, cfg.far, cfg.n_coarse + 1, dev)
    lower, upper = t_coarse[:-1], t_coarse[1:]
    if train:
        u, u2 = draws
    else:
        u = torch.full((n_rays, cfg.n_coarse), 0.5, device=dev)
        u2 = _linspace(0.0, 1.0 - 1e-4, cfg.n_fine, dev).expand(n_rays, cfg.n_fine)
    t_c = lower[None] + (upper - lower)[None] * u

    pts_c = origins[:, None, :] + t_c[..., None] * directions[:, None, :]
    sigma_c = nerf(pts_c * 0.5 + 0.5, None, True)[..., 0]
    delta_c = torch.diff(t_c, dim=-1,
                         append=t_c[..., -1:] + (cfg.far - cfg.near) / cfg.n_coarse)
    w_c = _alpha_weights(1.0 - torch.exp(-sigma_c * delta_c))

    cdf = torch.cumsum(w_c + 1e-5, dim=-1)
    cdf = cdf / cdf[..., -1:]
    # left bisect: the count of cdf < u2
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u2.contiguous()), 0, cfg.n_coarse - 1)
    t_f = torch.gather(t_c, -1, idx)

    t_all = torch.sort(torch.cat([t_c, t_f], dim=-1), dim=-1).values
    pts01 = (origins[:, None, :] + t_all[..., None] * directions[:, None, :]) * 0.5 + 0.5
    sigma, rgb = nerf(pts01, directions[:, None, :].expand(pts01.shape), False)
    delta = torch.diff(t_all, dim=-1, append=t_all[..., -1:] + 1e10)
    out = _composite(_alpha_weights(1.0 - torch.exp(-sigma[..., 0] * delta)), rgb, t_all,
                     cfg.bg_color)
    if with_features and feat is not None:
        _features(feat, pts01, out["weights"], out)
    return out


def _searchsorted_right(sorted_ref: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """The count of ref <= q along the last axis (a right bisect)."""
    return torch.searchsorted(sorted_ref.contiguous(), queries.contiguous(), right=True)


def _sample_pdf(t_edges, weights, u, train: bool):
    """Inverse-CDF sampling of ``u``'s points (sorted in training; evenly
    spaced otherwise) from the piecewise-constant pdf over the intervals
    (NeRF sample_pdf, linear in a bin)."""
    n_rays, n_bins = weights.shape
    cdf = torch.cumsum(weights + 1e-5, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    cdf = cdf / cdf[..., -1:]
    idx = torch.clamp(_searchsorted_right(cdf, u) - 1, 0, n_bins - 1)
    cdf_lo, cdf_hi = torch.gather(cdf, -1, idx), torch.gather(cdf, -1, idx + 1)
    t_lo, t_hi = torch.gather(t_edges, -1, idx), torch.gather(t_edges, -1, idx + 1)
    denom = torch.where(cdf_hi - cdf_lo < 1e-8, 1.0, cdf_hi - cdf_lo)
    t = t_lo + (u - cdf_lo) / denom * (t_hi - t_lo)
    return torch.sort(t, dim=-1).values if train else t


def _outer_measure(t_ref, w_ref, t_query):
    """Sum of reference mass over the bins that meet each query interval
    (mip-NeRF 360's inner_outer upper bound; multinerf stepfun.py)."""
    cw = torch.cumsum(w_ref, dim=-1)
    cw = torch.cat([torch.zeros_like(cw[..., :1]), cw], -1)
    n_bins = w_ref.shape[-1]
    t_ref = t_ref.contiguous()
    idx_lo = torch.clamp(_searchsorted_right(t_ref, t_query[..., :-1]) - 1, 0, n_bins)
    idx_hi = torch.clamp(torch.searchsorted(t_ref, t_query[..., 1:].contiguous()), 0, n_bins)
    return torch.gather(cw, -1, idx_hi) - torch.gather(cw, -1, torch.minimum(idx_lo, idx_hi))


def proposal_loss(t_prop, w_prop, t_fine, w_fine, eps: float = 1e-7):
    """Interlevel loss: proposal mass under-covering the final distribution
    (mip-NeRF 360 eq. 13; its gradient reaches the proposal only)."""
    w = w_fine.detach()
    bound = _outer_measure(t_prop, w_prop, t_fine)
    return torch.mean(torch.clamp(w - bound, min=0.0) ** 2 / (w + eps))


def render_rays_prop(prop, nerf, feat, origins, directions, cfg: RenderConfig,
                     train: bool = True, with_features: bool = True, draws=None) -> dict:
    """Proposal-sampled rendering: n_coarse samples (bin centres jittered by
    ``draws[0]`` in training) through ``prop`` pick n_fine samples
    (``draws[1]``) for ``nerf`` (and ``feat``); the render plus
    ``"prop_loss"``, the interlevel loss."""
    n_rays, dev = origins.shape[0], origins.device
    t_edges = _linspace(cfg.near, cfg.far, cfg.n_coarse + 1, dev).expand(n_rays, -1)
    mids = 0.5 * (t_edges[..., 1:] + t_edges[..., :-1])
    if train:
        u_jitter, u = draws
        t_p = mids + (u_jitter - 0.5) * (t_edges[..., 1:] - t_edges[..., :-1])
    else:
        t_p = mids
        u = _linspace(1e-4, 1.0 - 1e-4, cfg.n_fine, dev).expand(n_rays, cfg.n_fine)

    pts_p = origins[:, None, :] + t_p[..., None] * directions[:, None, :]
    w_p = _weights_from_sigma(prop(pts_p * 0.5 + 0.5)[..., 0], t_edges)
    t_f = _sample_pdf(t_edges, w_p, u, train)
    # the final intervals: midpoints between the samples, closed by near/far
    t_f_edges = torch.cat([torch.full_like(t_f[..., :1], cfg.near),
                           0.5 * (t_f[..., 1:] + t_f[..., :-1]),
                           torch.full_like(t_f[..., :1], cfg.far)], dim=-1)

    pts01 = (origins[:, None, :] + t_f[..., None] * directions[:, None, :]) * 0.5 + 0.5
    sigma, rgb = nerf(pts01, directions[:, None, :].expand(pts01.shape), False)
    out = _composite(_weights_from_sigma(sigma[..., 0], t_f_edges), rgb, t_f, cfg.bg_color)
    out["prop_loss"] = proposal_loss(t_edges, w_p, t_f_edges, out["weights"])
    if with_features and feat is not None:
        _features(feat, pts01, out["weights"], out)
    return out
