"""Per-tile front-to-back splat blend: the CUDA kernel and its plain
PyTorch version.

The kernel (``csrc/gs_stream.cu``) replaces the TPU's
``pixie_tpu/ops/gs_stream.py:blend_stream`` forward; its source note says
what bounds it and why it is shaped as it is.  Both versions take the same
inputs, built by ``recon/rasterizer.py:rasterize_tiled``:

  feat    (N, 9) float32  per gaussian [mx, my, conic c0 c1 c2, r g b, opacity]
  idx     (M,)   int32    gaussian index of each (tile, depth)-sorted entry
  starts  (T,)   int32    first entry of tile t in ``idx``
  counts  (T,)   int32    entries blended for tile t (capped at tile_cap)

and return ``(img (H, W, 3) = color + bg * T, trans (H, W))`` for the
16x16 tiles laid out ``tx_n`` to a row.  Entries must lie in ``idx`` and
name rows of ``feat``; the kernel skips any that do not.

Dispatch is by device, with no fallback: CPU tensors take ``blend_plain``;
CUDA tensors launch the kernel on the current stream, or raise.
``BLEND_LAUNCHES`` counts kernel launches (plain calls are not counted).
"""

from __future__ import annotations

import ctypes

import torch

from pixie_tpu_torch.ops.build import check_tensor, load_library, raise_on_error

TILE = 16
P = TILE * TILE      # pixels per tile
CH = 128             # splats per chunk of the plain (JAX-form) version
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99

BLEND_LAUNCHES = 0

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = load_library("gs_stream")
    if not getattr(lib, "_pixie_typed", False):
        lib.pixie_gs_blend.argtypes = [_c_void_p] * 4 + [_c_int] * 4 + [
            _c_float, _c_void_p, _c_void_p, _c_void_p]
        lib.pixie_gs_blend.restype = _c_int
        lib.pixie_error_string.argtypes = [_c_int]
        lib.pixie_error_string.restype = ctypes.c_char_p
        lib._pixie_typed = True
    return lib


def build() -> None:
    """Compile (or load from the build cache) the blend kernel."""
    _lib()


def _tiles_to_image(per_tile: torch.Tensor, tx_n: int) -> torch.Tensor:
    """(T, P, ...) per-tile pixels -> (H, W, ...) image."""
    ty_n = per_tile.shape[0] // tx_n
    rest = per_tile.shape[2:]
    img = per_tile.reshape(ty_n, tx_n, TILE, TILE, *rest).transpose(1, 2)
    return img.reshape(ty_n * TILE, tx_n * TILE, *rest)


def blend_plain(feat, idx, starts, counts, tx_n: int, bg: float = 0.0):
    """Plain PyTorch blend in the JAX kernel's per-chunk form
    (``_fwd_kernel``, gs_stream.py:94-125): chunks of 128 splats per tile,
    ``logm = log1p(-alpha)``, exclusive transmittance
    ``exp(cumsum(logm) - logm)``, ``T_out = T_in * exp(sum(logm))``."""
    n_tiles, dev = starts.shape[0], feat.device
    m = idx.shape[0]
    t = torch.arange(n_tiles, device=dev)[:, None]
    i = torch.arange(P, device=dev)[None, :]
    px = ((t % tx_n) * TILE + i % TILE).to(torch.float32) + 0.5   # (T, P)
    py = ((t // tx_n) * TILE + i // TILE).to(torch.float32) + 0.5
    color = torch.zeros((n_tiles, P, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((n_tiles, P), dtype=torch.float32, device=dev)
    counts = counts.to(torch.int64)
    n_chunks = -(-int(counts.max()) // CH) if n_tiles and m else 0
    j = torch.arange(CH, device=dev)
    for k in range(n_chunks):
        slot = k * CH + j                                          # (CH,)
        live = slot[None, :] < counts[:, None]                     # (T, CH)
        pos = torch.clamp(starts.to(torch.int64)[:, None] + slot[None, :], 0, m - 1)
        g = feat[idx[pos].to(torch.int64)]                         # (T, CH, 9)
        mx, my = g[:, None, :, 0], g[:, None, :, 1]
        c0, c1, c2 = g[:, None, :, 2], g[:, None, :, 3], g[:, None, :, 4]
        op = g[:, None, :, 8]
        dx = px[..., None] - mx                                    # (T, P, CH)
        dy = py[..., None] - my
        power = -0.5 * (c0 * dx * dx + c2 * dy * dy) - c1 * dx * dy
        alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)), max=ALPHA_MAX)
        alpha = torch.where((alpha >= ALPHA_MIN) & live[:, None, :], alpha, 0.0)
        logm = torch.log1p(-alpha)
        w = trans[..., None] * (alpha * torch.exp(torch.cumsum(logm, -1) - logm))
        color = color + torch.stack(
            [torch.sum(w * g[:, None, :, 5 + e], -1) for e in range(3)], -1)
        trans = trans * torch.exp(torch.sum(logm, -1))
    img = color + bg * trans[..., None]
    return _tiles_to_image(img, tx_n), _tiles_to_image(trans, tx_n)


def blend(feat, idx, starts, counts, tx_n: int, bg: float = 0.0):
    """Blend every tile's depth-sorted splats front to back; see the module
    docstring for the inputs.  Returns (img (H,W,3), trans (H,W))."""
    if feat.device.type == "cpu":
        return blend_plain(feat, idx, starts, counts, tx_n, bg)
    if feat.device.type != "cuda":
        raise ValueError(f"blend: unsupported device {feat.device}")
    global BLEND_LAUNCHES
    dev, n, m, n_tiles = feat.device, feat.shape[0], idx.shape[0], starts.shape[0]
    if tx_n <= 0 or n_tiles % tx_n:
        raise ValueError(f"{n_tiles} tiles do not fill rows of tx_n={tx_n}")
    if max(n, m) >= 2**31:
        raise ValueError(f"{n} gaussians / {m} entries exceed the kernel's int32 indexing")
    check_tensor("feat", feat, (n, 9), torch.float32, dev)
    check_tensor("idx", idx, (m,), torch.int32, dev)
    check_tensor("starts", starts, (n_tiles,), torch.int32, dev)
    check_tensor("counts", counts, (n_tiles,), torch.int32, dev)
    h, w = n_tiles // tx_n * TILE, tx_n * TILE
    img = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((h, w), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.pixie_gs_blend(feat.data_ptr(), idx.data_ptr(), starts.data_ptr(),
                              counts.data_ptr(), n, m, n_tiles, tx_n, float(bg),
                              img.data_ptr(), trans.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, code, "gs blend")
    BLEND_LAUNCHES += 1
    return img, trans
