"""Differentiable Gaussian-splat rasterizer (port of pixie_tpu/recon/rasterizer.py).

``project_gaussians``  EWA projection to screen: means2D, 2D covariance,
                       depth, rgb, opacity (forward.cu preprocessCUDA).
``rasterize``          the dense oracle: one global depth sort and a loop
                       over 256-splat chunks blended against the whole
                       image (O(N·H·W); tests only).
``rasterize_tiled``    the tile pipeline: depth sort, fixed-fanout
                       (tile, depth-rank) key duplication over each
                       splat's 3-sigma tile bbox, one key sort, per-tile
                       ranges, then the tile blend of ``ops/gs_stream.py``
                       (the CUDA kernels on CUDA tensors).

Both are differentiable: autograd of plain PyTorch for ``rasterize``; for
``rasterize_tiled`` the blend's own backward (``gs_stream.blend``) gives
d feat, and autograd carries it through the projection to the params.  The
keys, sort and ranges are integer work and carry no gradient.
``mean2d_offset`` (N, 2), added to the projected means, is JAX's hook for
the per-gaussian screen-space gradient that drives densification.

The binning is plain PyTorch, as XLA ops surround the Pallas kernel in the
JAX package.  Every truncation of the JAX tiled path is mirrored: a splat
reaches at most ``max_tiles_side``² tiles from its clamped bbox start, a
tile blends its front-most ``tile_cap`` splats, and on JAX's stream branch
a tile whose 128-row chunks overflow ``stream_cap`` rows renders empty.
JAX's two kernel layouts of the list, the 128-aligned stream
(``blend_stream``, tile_cap a multiple of 128 up to 1152) and the dense
(T, tile_cap) slot table (``blend_tiles``, any other tile_cap), are TPU
layouts of one function: both run here on the exact per-tile index lists,
and only the stream's budget changes the counts.  JAX's third branch, the
XLA scan for ``tile != 16`` or ``use_pallas_blend=False``, is no kernel
there: it is plain PyTorch here (``_blend_scan``), with its own numerics.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from pixie_tpu_torch.ops import gs_stream
from pixie_tpu_torch.recon import gaussians as G


@dataclasses.dataclass(frozen=True)
class Camera:
    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float


_PACK6 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def congruence6(r):
    """(6,6) matrix T such that packed(R C R^T) = packed(C) @ T.T for any
    symmetric C packed upper-triangular [c00,c01,c02,c11,c12,c22]:
    T[p,q] = R_ai R_bj + R_aj R_bi (i<j) or R_ai R_bi (i==j), p=(a,b),
    q=(i,j).  Takes a 3x3 tensor or numpy array and returns the same kind."""
    rows = []
    for a, b in _PACK6:
        row = []
        for i, j in _PACK6:
            v = r[a, i] * r[b, j]
            if i != j:
                v = v + r[a, j] * r[b, i]
            row.append(v)
        rows.append(row)
    if isinstance(r, torch.Tensor):
        return torch.stack([torch.stack(row) for row in rows])
    import numpy as np  # noqa: PLC0415

    return np.array(rows, dtype=np.asarray(r).dtype)


def project_gaussians(params, viewmat, cam: Camera, scaling_modifier=1.0):
    """World gaussians -> (means2d (N,2), cov2d (N,3), depth (N,), rgb (N,3),
    opacity (N,)), EWA splatting as in preprocessCUDA (forward.cu:74-155):
    cov2D = J W Sigma W^T J^T + 0.3 on the diagonal.

    Precomputed inputs are honored when present in ``params``:
    ``cov6_precomp`` (N,6) packed world covariance, ``cov3d_precomp``
    (N,3,3), ``colors_precomp`` (N,3) and ``opacity_precomp`` (N,) or (N,1).
    Gaussians at depth <= 0.01 are culled by zeroing their opacity."""
    xyz = params["xyz"]
    r = viewmat[:3, :3]
    t = viewmat[:3, 3]
    p_cam = xyz @ r.T + t  # camera looks down +z
    depth = p_cam[:, 2]
    x, y, z = p_cam[:, 0], p_cam[:, 1], torch.clamp(p_cam[:, 2], min=1e-4)
    means2d = torch.stack([cam.fx * x / z + cam.cx, cam.fy * y / z + cam.cy], -1)

    if "cov6_precomp" in params:
        cov6 = params["cov6_precomp"] * (scaling_modifier ** 2)
    elif "cov3d_precomp" in params:
        m = params["cov3d_precomp"] * (scaling_modifier ** 2)
        cov6 = torch.stack([m[:, 0, 0], m[:, 0, 1], m[:, 0, 2],
                            m[:, 1, 1], m[:, 1, 2], m[:, 2, 2]], -1)
    else:
        cov6 = G.covariance_upper(params, scaling_modifier)
    cov_cam6 = cov6 @ congruence6(r).T
    # Jacobian of the perspective projection (forward.cu:91-103)
    j00 = cam.fx / z
    j02 = -cam.fx * x / (z * z)
    j11 = cam.fy / z
    j12 = -cam.fy * y / (z * z)
    a, b, c = cov_cam6[:, 0], cov_cam6[:, 1], cov_cam6[:, 2]
    d, e, f = cov_cam6[:, 3], cov_cam6[:, 4], cov_cam6[:, 5]
    c00 = j00 * (j00 * a + j02 * c) + j02 * (j00 * c + j02 * f) + 0.3
    c01 = j00 * (j11 * b + j12 * c) + j02 * (j11 * e + j12 * f)
    c11 = j11 * (j11 * d + j12 * e) + j12 * (j11 * e + j12 * f) + 0.3

    if "colors_precomp" in params:
        rgb = params["colors_precomp"]
    else:
        cam_pos = -r.T @ t
        dirs = xyz - cam_pos
        dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
        shs = G.get_shs(params)
        rgb = torch.clamp(G.eval_sh(shs, dirs, G.sh_degree_of(shs)), min=0.0)

    if "opacity_precomp" in params:
        opacity = params["opacity_precomp"].reshape(-1)
    else:
        opacity = G.get_opacity(params)[:, 0]
    opacity = torch.where(depth > 0.01, opacity, 0.0)
    return means2d, torch.stack([c00, c01, c11], -1), depth, rgb, opacity


def _conic(cov2d):
    """Inverse 2D covariance with det clamped to 1e-8 (forward.cu:222-230);
    returns (conic (N,3), det (N,))."""
    det = torch.clamp(cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2, min=1e-8)
    conic = torch.stack([cov2d[:, 2] / det, -cov2d[:, 1] / det, cov2d[:, 0] / det], -1)
    return conic, det


def rasterize(params, viewmat, cam: Camera, bg_color=1.0, scaling_modifier=1.0,
              chunk: int = 256, mean2d_offset=None):
    """Dense oracle: (image (H,W,3), alpha (H,W)) by a global depth sort and
    chunked blending of every splat against every pixel."""
    means2d, cov2d, depth, rgb, opacity = project_gaussians(
        params, viewmat, cam, scaling_modifier)
    if mean2d_offset is not None:
        means2d = means2d + mean2d_offset
    dev = means2d.device
    order = torch.sort(depth, stable=True).indices
    means2d, cov2d, rgb, opacity = means2d[order], cov2d[order], rgb[order], opacity[order]
    conic, _ = _conic(cov2d)
    px = torch.arange(cam.width, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(cam.height, dtype=torch.float32, device=dev) + 0.5
    grid_y, grid_x = torch.meshgrid(py, px, indexing="ij")      # (H, W)
    color = torch.zeros((cam.height, cam.width, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((cam.height, cam.width), dtype=torch.float32, device=dev)
    for s in range(0, means2d.shape[0], chunk):
        m, cn, col, o = (v[s:s + chunk] for v in (means2d, conic, rgb, opacity))
        dx = grid_x[..., None] - m[:, 0]                        # (H, W, C)
        dy = grid_y[..., None] - m[:, 1]
        power = -0.5 * (cn[:, 0] * dx * dx + cn[:, 2] * dy * dy) - cn[:, 1] * dx * dy
        alpha = torch.clamp(o * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
        alpha = torch.where(alpha < 1.0 / 255.0, 0.0, alpha)
        one_minus = 1.0 - alpha
        cum = torch.cumprod(one_minus, -1)
        w = alpha * (cum / one_minus) * trans[..., None]
        color = color + torch.stack([torch.sum(w * col[:, e], -1) for e in range(3)], -1)
        trans = trans * cum[..., -1]
    return color + bg_color * trans[..., None], 1.0 - trans


@dataclasses.dataclass
class TileBins:
    """Per-tile splat lists of one frame (the blend kernel's inputs)."""

    feat: torch.Tensor     # (N, 9) [mx, my, conic3, rgb3, opacity]
    idx: torch.Tensor      # (M,) int32 gaussian index, sorted by (tile, depth)
    starts: torch.Tensor   # (T,) int32 first entry of each tile
    counts: torch.Tensor   # (T,) int32 entries blended, min(raw, tile_cap)
    raw: torch.Tensor      # (T,) int64 entries before the tile_cap cut
    tx_n: int


def on_stream_branch(tile: int, tile_cap: int, stream_cap: int | None = 0,
                     use_pallas_blend: bool | None = None) -> bool:
    """Whether JAX's rasterize_tiled takes its stream branch (rasterizer.py:433-435)."""
    if use_pallas_blend is None:
        use_pallas_blend = tile == 16
    ch = gs_stream.CH
    return (stream_cap is not None and use_pallas_blend and tile == 16
            and tile_cap % ch == 0 and 1 <= tile_cap // ch <= 9)


def stream_counts(raw: torch.Tensor, tile_cap: int, n: int, stream_cap: int) -> torch.Tensor:
    """Entries blended per tile under JAX's stream budget (rasterizer.py:439-453):
    min(raw, tile_cap), zeroed for every tile whose chunks of 128, summed over
    the tiles before it and itself, exceed ``stream_cap // 128``; stream_cap
    0 is JAX's default, 4N rows plus one chunk a tile."""
    ch, n_tiles = gs_stream.CH, raw.shape[0]
    if stream_cap == 0:
        stream_cap = (-(-4 * n // ch) + n_tiles) * ch
    if stream_cap % ch:
        raise ValueError(f"stream_cap={stream_cap} must be a multiple of {ch}")
    count = torch.clamp(raw, max=tile_cap)
    fits = torch.cumsum((count + ch - 1) // ch, 0) <= stream_cap // ch
    return torch.where(fits, count, 0)


def bin_tiles(params, viewmat, cam: Camera, scaling_modifier=1.0, tile: int = 16,
              tile_cap: int = 512, max_tiles_side: int = 6, mean2d_offset=None,
              stream_cap: int | None = 0) -> TileBins:
    """Projection and tile binning of ``rasterize_tiled`` (rasterizer.py:363-454);
    ``feat`` carries the gradient back to ``params`` and ``mean2d_offset``.
    Where JAX's stream branch would run (``on_stream_branch``), the counts
    carry its ``stream_cap`` budget."""
    means2d, cov2d, depth, rgb, opacity = project_gaussians(
        params, viewmat, cam, scaling_modifier)
    if mean2d_offset is not None:
        means2d = means2d + mean2d_offset
    dev = means2d.device
    n = means2d.shape[0]
    ty_n, tx_n = cam.height // tile, cam.width // tile
    n_tiles = ty_n * tx_n
    # stable depth order: ties break by index, as lax.sort's
    perm = torch.sort(depth, stable=True).indices     # blend position -> gaussian
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(n, device=dev)          # gaussian -> blend position

    conic, det = _conic(cov2d)
    # 3-sigma pixel radius (forward.cu:205-209)
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    tx0 = torch.floor((means2d[:, 0] - radius) / tile).to(torch.int64)
    ty0 = torch.floor((means2d[:, 1] - radius) / tile).to(torch.int64)
    tx1 = torch.floor((means2d[:, 0] + radius) / tile).to(torch.int64)
    ty1 = torch.floor((means2d[:, 1] + radius) / tile).to(torch.int64)
    tx0c, tx1c = torch.clamp(tx0, 0, tx_n - 1), torch.clamp(tx1, 0, tx_n - 1)
    ty0c, ty1c = torch.clamp(ty0, 0, ty_n - 1), torch.clamp(ty1, 0, ty_n - 1)
    on_screen = ((tx1 >= 0) & (tx0 <= tx_n - 1) & (ty1 >= 0) & (ty0 <= ty_n - 1)
                 & (opacity > 0.0))

    # fixed fanout over max_tiles_side^2 slots from the clamped bbox start;
    # key = tile_id * N + depth rank (int64 where JAX has int32), invalid
    # slots sort last under the sentinel n_tiles * N
    ks = max_tiles_side
    di = torch.arange(ks, device=dev)
    gx = tx0c[None, :] + di.repeat_interleave(ks)[:, None]   # (ks^2, N)
    gy = ty0c[None, :] + di.repeat(ks)[:, None]
    valid = (gx <= tx1c[None, :]) & (gy <= ty1c[None, :]) & on_screen[None, :]
    key = torch.where(valid, (gy * tx_n + gx) * n + rank[None, :], n_tiles * n)
    skey = torch.sort(key.reshape(-1)).values
    bounds = torch.arange(n_tiles + 1, device=dev) * n
    starts = torch.searchsorted(skey, bounds[:-1], side="left")
    ends = torch.searchsorted(skey, bounds[1:], side="left")
    raw = ends - starts
    n_valid = int(valid.sum())
    idx = perm[skey[:n_valid] % max(n, 1)].to(torch.int32)
    feat = torch.cat([means2d, conic, rgb, opacity[:, None]], -1).contiguous()
    counts = (stream_counts(raw, tile_cap, n, stream_cap)
              if on_stream_branch(tile, tile_cap, stream_cap) else torch.clamp(raw, max=tile_cap))
    return TileBins(feat=feat, idx=idx, starts=starts.to(torch.int32),
                    counts=counts.to(torch.int32), raw=raw, tx_n=tx_n)


def jax_stream_overflows(bins: TileBins) -> bool:
    """Whether the stream budget blanked a tile of these bins: a tile with
    entries and a count of 0 (tile_cap is at least 128 on the stream branch,
    so nothing else zeroes a count)."""
    return bool(((bins.counts == 0) & (bins.raw > 0)).any())


def slot_table_chunk(tile_cap: int, chunk: int) -> int | None:
    """The chunk JAX's slot-table branch blends with (rasterizer.py:502-522),
    or None on the stream branch (tile_cap a multiple of 128 up to 1152).
    Raises where JAX raises: ``tile_cap % chunk``, and a carry-grown chunk
    (the TPU kernel keeps at most 4 chunk carries) that does not divide
    tile_cap."""
    if tile_cap % chunk:
        raise ValueError(f"tile_cap={tile_cap} must be a multiple of chunk={chunk}")
    if tile_cap % gs_stream.CH == 0 and 1 <= tile_cap // gs_stream.CH <= 9:
        return None
    kchunk = chunk
    while tile_cap // kchunk - 1 > 4:
        kchunk *= 2
    if tile_cap % kchunk:
        raise ValueError(
            f"tile_cap={tile_cap} is not divisible by the carry-grown chunk {kchunk} "
            f"(from chunk={chunk}); pick tile_cap as a multiple of a power-of-two "
            f"chunk (e.g. 512/128, 1024/256)")
    return kchunk


def _blend_scan(bins: TileBins, tile: int, tile_cap: int, chunk: int, bg_color: float):
    """JAX's XLA-scan blend (rasterizer.py:535-595) in plain PyTorch: each
    tile's front-most tile_cap entries in chunks of ``chunk`` against all
    its pixels, the exclusive product as cum / (1 - alpha); differentiable
    in ``bins.feat`` by autograd, each chunk recomputed in the backward as
    JAX's ``jax.checkpoint`` does.  Returns (color + bg T, T) per tile
    pixel, (T, tile, tile, ...)."""
    n_tiles, dev, m = bins.starts.shape[0], bins.feat.device, bins.idx.shape[0]
    slot = torch.arange(tile_cap, device=dev)
    slot_ok = slot[None, :] < bins.counts.to(torch.int64)[:, None]          # (T, C)
    pos = torch.clamp(bins.starts.to(torch.int64)[:, None] + slot[None, :], 0, max(m - 1, 0))
    gidx = torch.where(slot_ok, bins.idx[pos].to(torch.int64), 0) if m else \
        torch.zeros_like(pos)
    g = torch.where(slot_ok[..., None], bins.feat[gidx], 0.0)               # (T, C, 9)
    t_ids = torch.arange(n_tiles, device=dev)
    px = torch.arange(tile, dtype=torch.float32, device=dev) + 0.5
    pix_x = (((t_ids % bins.tx_n) * tile).to(torch.float32)[:, None, None]
             + px[None, None, :]).expand(n_tiles, tile, tile)
    pix_y = (((t_ids // bins.tx_n) * tile).to(torch.float32)[:, None, None]
             + px[None, :, None]).expand(n_tiles, tile, tile)

    def blend_chunk(color, trans, gk):
        m2, cn, col, o = gk[..., 0:2], gk[..., 2:5], gk[..., 5:8], gk[..., 8]
        dx = pix_x[..., None] - m2[:, None, None, :, 0]                  # (T, t, t, chunk)
        dy = pix_y[..., None] - m2[:, None, None, :, 1]
        power = (-0.5 * (cn[:, None, None, :, 0] * dx * dx + cn[:, None, None, :, 2] * dy * dy)
                 - cn[:, None, None, :, 1] * dx * dy)
        alpha = torch.clamp(o[:, None, None, :] * torch.exp(torch.clamp(power, max=0.0)),
                            max=gs_stream.ALPHA_MAX)
        alpha = torch.where(alpha < gs_stream.ALPHA_MIN, 0.0, alpha)
        one_minus = 1.0 - alpha
        cum = torch.cumprod(one_minus, -1)
        w = alpha * (cum / one_minus) * trans[..., None]
        color = color + torch.stack(
            [torch.sum(w * col[:, None, None, :, e], -1) for e in range(3)], -1)
        return color, trans * cum[..., -1]

    color = torch.zeros((n_tiles, tile, tile, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((n_tiles, tile, tile), dtype=torch.float32, device=dev)
    for k in range(tile_cap // chunk):
        gk = g[:, k * chunk:(k + 1) * chunk]
        if torch.is_grad_enabled() and g.requires_grad:
            color, trans = checkpoint(blend_chunk, color, trans, gk, use_reentrant=False)
        else:
            color, trans = blend_chunk(color, trans, gk)
    return color + bg_color * trans[..., None], trans


def _tiles_to_image(per_tile: torch.Tensor, tx_n: int, tile: int) -> torch.Tensor:
    """(T, tile, tile, ...) per-tile pixels -> (H, W, ...) image."""
    ty_n, rest = per_tile.shape[0] // tx_n, per_tile.shape[3:]
    img = per_tile.reshape(ty_n, tx_n, tile, tile, *rest).transpose(1, 2)
    return img.reshape(ty_n * tile, tx_n * tile, *rest)


def rasterize_tiled(params, viewmat, cam: Camera, bg_color=1.0, scaling_modifier=1.0,
                    tile: int = 16, tile_cap: int = 512, max_tiles_side: int = 6,
                    chunk: int = 128, mean2d_offset=None, use_pallas_blend: bool | None = None,
                    stream_cap: int | None = 0):
    """Tile-culled differentiable rasterization: (image (H,W,3), alpha (H,W)),
    with JAX's signature and branches.  H and W must be multiples of ``tile``.

    ``use_pallas_blend`` (None: ``tile == 16``) selects JAX's kernel
    branches, the stream (rasterizer.py:433-488) and the slot table (B5,
    :490-533); both blend each tile's front-most ``tile_cap`` splats, and
    here both run in ``ops/gs_stream.blend`` (the CUDA kernels on CUDA
    tensors), which takes 16x16 tiles.  On the stream branch (``stream_cap``
    not None, tile_cap a multiple of 128 up to 1152) a tile whose chunks
    overflow ``stream_cap`` rows (0: 4N plus a chunk a tile) renders empty,
    as in JAX; ``chunk`` decides, as in JAX, which tile_caps are accepted.
    ``use_pallas_blend=False`` is JAX's XLA scan in chunks of ``chunk``
    (``_blend_scan``), for any tile size."""
    if use_pallas_blend is None:
        use_pallas_blend = tile == 16
    if use_pallas_blend and tile != 16:
        raise NotImplementedError(f"tile={tile}: the blend kernels take 16x16 tiles "
                                  f"(use_pallas_blend=False blends any tile)")
    if cam.height % tile or cam.width % tile:
        raise ValueError(f"image {cam.height}x{cam.width} is not a multiple of {tile}")
    if use_pallas_blend:
        slot_table_chunk(tile_cap, chunk)
    elif tile_cap % chunk:
        raise ValueError(f"tile_cap={tile_cap} must be a multiple of chunk={chunk}")
    stream = on_stream_branch(tile, tile_cap, stream_cap, use_pallas_blend)
    bins = bin_tiles(params, viewmat, cam, scaling_modifier, tile, tile_cap, max_tiles_side,
                     mean2d_offset, stream_cap if stream else None)
    if not use_pallas_blend:
        img, trans = _blend_scan(bins, tile, tile_cap, chunk, float(bg_color))
        return _tiles_to_image(img, bins.tx_n, tile), _tiles_to_image(1.0 - trans, bins.tx_n,
                                                                      tile)
    img, trans = gs_stream.blend(bins.feat, bins.idx, bins.starts, bins.counts,
                                 bins.tx_n, float(bg_color))
    return img, 1.0 - trans
