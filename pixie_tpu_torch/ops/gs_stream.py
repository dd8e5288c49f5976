"""Per-tile front-to-back splat blend and its gradient: the CUDA kernels
and their plain PyTorch versions.

The kernels (``csrc/gs_stream.cu``) replace the TPU's
``pixie_tpu/ops/gs_stream.py:blend_stream``: ``blend_kernel`` its forward
(``_fwd_kernel``), ``blend_backward_kernel`` its VJP (``_stream_bwd`` /
``_bwd_kernel``); the source notes say what bounds each and why it is
shaped as it is.  All versions take the same inputs, built by
``recon/rasterizer.py:rasterize_tiled``:

  feat    (N, 9) float32  per gaussian [mx, my, conic c0 c1 c2, r g b, opacity]
  idx     (M,)   int32    gaussian index of each (tile, depth)-sorted entry
  starts  (T,)   int32    first entry of tile t in ``idx``
  counts  (T,)   int32    entries blended for tile t (capped at tile_cap)

and return ``(img (H, W, 3) = color + bg * T, trans (H, W))`` for the
16x16 tiles laid out ``tx_n`` to a row.  Entries must lie in ``idx`` and
name rows of ``feat``; the kernel skips any that do not.

``blend`` is differentiable in ``feat``: its backward returns d feat
(N, 9), one row per gaussian summed over every tile entry and pixel it
touched, from the cotangents of img and trans (the cotangent of T is
``bg * sum_c d img_c + d trans``, as row 3 of JAX's ``ct``).

Dispatch is by device, with no fallback: CPU tensors take ``blend_plain``
and ``blend_backward_plain``; CUDA tensors launch the kernels on the
current stream, or raise.  ``BLEND_LAUNCHES`` and ``BLEND_BWD_LAUNCHES``
count kernel launches (plain calls are not counted).
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
BLEND_BWD_LAUNCHES = 0
# ablation modes of the backward kernel (csrc/gs_stream.cu flags): timed by
# chip_smoke.py, called by no path of the port
BWD_MODES = {"noreduce": 2, "pass1": 4}

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = load_library("gs_stream")
    if not getattr(lib, "_pixie_typed", False):
        lib.pixie_gs_blend.argtypes = [_c_void_p] * 4 + [_c_int] * 4 + [
            _c_float] + [_c_void_p] * 4
        lib.pixie_gs_blend.restype = _c_int
        lib.pixie_gs_blend_backward.argtypes = [_c_int] + [_c_void_p] * 4 + [_c_int] * 4 + [
            _c_float] + [_c_void_p] * 6
        lib.pixie_gs_blend_backward.restype = _c_int
        lib.pixie_error_string.argtypes = [_c_int]
        lib.pixie_error_string.restype = ctypes.c_char_p
        lib._pixie_typed = True
    return lib


def build() -> None:
    """Compile (or load from the build cache) the blend kernels."""
    _lib()


def _tiles_to_image(per_tile: torch.Tensor, tx_n: int) -> torch.Tensor:
    """(T, P, ...) per-tile pixels -> (H, W, ...) image."""
    ty_n = per_tile.shape[0] // tx_n
    rest = per_tile.shape[2:]
    img = per_tile.reshape(ty_n, tx_n, TILE, TILE, *rest).transpose(1, 2)
    return img.reshape(ty_n * TILE, tx_n * TILE, *rest)


def _pixel_centres(n_tiles: int, tx_n: int, dev):
    """(T, P) pixel-centre x and y of every tile's pixels."""
    t = torch.arange(n_tiles, device=dev)[:, None]
    i = torch.arange(P, device=dev)[None, :]
    px = ((t % tx_n) * TILE + i % TILE).to(torch.float32) + 0.5
    py = ((t // tx_n) * TILE + i // TILE).to(torch.float32) + 0.5
    return px, py


def _chunk(feat, idx, starts, counts, k: int, px, py):
    """Chunk k (CH splats) of every tile against its pixels, as the JAX
    kernel's ``_chunk_geometry``: (g (T, CH, 9) rows, gaussian index (T, CH),
    live (T, CH), alpha, e, dx, dy (T, P, CH), pgate = power < 0)."""
    m = idx.shape[0]
    slot = k * CH + torch.arange(CH, device=feat.device)
    live = slot[None, :] < counts[:, None]
    pos = torch.clamp(starts.to(torch.int64)[:, None] + slot[None, :], 0, m - 1)
    gi = idx[pos].to(torch.int64)
    g = feat[gi]
    mx, my = g[:, None, :, 0], g[:, None, :, 1]
    c0, c1, c2 = g[:, None, :, 2], g[:, None, :, 3], g[:, None, :, 4]
    dx = px[..., None] - mx
    dy = py[..., None] - my
    power = -0.5 * (c0 * dx * dx + c2 * dy * dy) - c1 * dx * dy
    e = torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.clamp(g[:, None, :, 8] * e, max=ALPHA_MAX)
    alpha = torch.where((alpha >= ALPHA_MIN) & live[:, None, :], alpha, 0.0)
    return g, gi, live, alpha, e, dx, dy, (power < 0.0) & live[:, None, :]


def _n_chunks(counts, m: int) -> int:
    return -(-int(counts.max()) // CH) if counts.shape[0] and m else 0


def blend_plain(feat, idx, starts, counts, tx_n: int, bg: float = 0.0):
    """Plain PyTorch blend in the JAX kernel's per-chunk form
    (``_fwd_kernel``, gs_stream.py:94-125): chunks of 128 splats per tile,
    ``logm = log1p(-alpha)``, exclusive transmittance
    ``exp(cumsum(logm) - logm)``, ``T_out = T_in * exp(sum(logm))``."""
    n_tiles, dev = starts.shape[0], feat.device
    px, py = _pixel_centres(n_tiles, tx_n, dev)
    color = torch.zeros((n_tiles, P, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((n_tiles, P), dtype=torch.float32, device=dev)
    counts = counts.to(torch.int64)
    for k in range(_n_chunks(counts, idx.shape[0])):
        g, _, _, alpha, _, _, _, _ = _chunk(feat, idx, starts, counts, k, px, py)
        logm = torch.log1p(-alpha)
        w = trans[..., None] * (alpha * torch.exp(torch.cumsum(logm, -1) - logm))
        color = color + torch.stack(
            [torch.sum(w * g[:, None, :, 5 + e], -1) for e in range(3)], -1)
        trans = trans * torch.exp(torch.sum(logm, -1))
    img = color + bg * trans[..., None]
    return _tiles_to_image(img, tx_n), _tiles_to_image(trans, tx_n)


def _image_to_tiles(img: torch.Tensor, tx_n: int) -> torch.Tensor:
    """(H, W, ...) image -> (T, P, ...) per-tile pixels."""
    ty_n = img.shape[0] // TILE
    rest = img.shape[2:]
    t = img.reshape(ty_n, TILE, tx_n, TILE, *rest).transpose(1, 2)
    return t.reshape(ty_n * tx_n, P, *rest)


def blend_backward_plain(feat, idx, starts, counts, tx_n: int, bg: float, d_img, d_trans):
    """d feat (N, 9) of the blend, in the JAX kernel's per-chunk form
    (``_bwd_kernel``, gs_stream.py:128-196): the forward's chunk carries
    (transmittance at each chunk's start), then the chunks in reverse, each
    recomputed from its carry, with the suffix sums of the later splats in
    the chunk and the cotangent of T carried from chunk to chunk.  Nothing
    per (pixel, splat) is kept from one chunk to the next."""
    n_tiles, dev = starts.shape[0], feat.device
    px, py = _pixel_centres(n_tiles, tx_n, dev)
    counts = counts.to(torch.int64)
    n_chunks = _n_chunks(counts, idx.shape[0])
    d_feat = torch.zeros_like(feat)
    dc = _image_to_tiles(d_img, tx_n)                          # (T, P, 3)
    dtrans = bg * dc.sum(-1) + _image_to_tiles(d_trans, tx_n)  # d loss / d T_final
    carries, trans = [], torch.ones((n_tiles, P), dtype=torch.float32, device=dev)
    for k in range(n_chunks):
        carries.append(trans)
        alpha = _chunk(feat, idx, starts, counts, k, px, py)[3]
        trans = trans * torch.exp(torch.sum(torch.log1p(-alpha), -1))
    for k in reversed(range(n_chunks)):
        g, gi, live, alpha, e, dx, dy, pgate = _chunk(feat, idx, starts, counts, k, px, py)
        trans_in = carries[k][..., None]
        logm = torch.log1p(-alpha)
        exl = torch.exp(torch.cumsum(logm, -1) - logm)
        u = alpha * exl
        w = trans_in * u
        dw = sum(dc[..., e_c, None] * g[:, None, :, 5 + e_c] for e_c in range(3))
        dwu = dw * u
        # sum over the later splats of the chunk (JAX: the strict-triangular matmul)
        suff = torch.flip(torch.cumsum(torch.flip(dwu, (-1,)), -1), (-1,))
        suff = torch.cat([suff[..., 1:], torch.zeros_like(suff[..., :1])], -1)
        t_gain = torch.exp(torch.sum(logm, -1))
        d_log = trans_in * suff + (dtrans * carries[k] * t_gain)[..., None]
        d_alpha = dw * trans_in * exl - d_log / (1.0 - alpha)
        d_trans_in = torch.sum(dwu, -1) + dtrans * t_gain
        dtrans = torch.where(live.any(-1, keepdim=True), d_trans_in, dtrans)
        d_ae = torch.where((alpha > 0.0) & (alpha < ALPHA_MAX), d_alpha, 0.0)
        d_pow = torch.where(pgate, d_ae * g[:, None, :, 8] * e, 0.0)
        c0, c1, c2 = g[:, None, :, 2], g[:, None, :, 3], g[:, None, :, 4]
        terms = torch.stack([
            d_pow * (c0 * dx + c1 * dy),       # d mx
            d_pow * (c2 * dy + c1 * dx),       # d my
            d_pow * (-0.5 * dx * dx),          # d c0
            d_pow * (-dx * dy),                # d c1
            d_pow * (-0.5 * dy * dy),          # d c2
            dc[..., 0, None] * w, dc[..., 1, None] * w, dc[..., 2, None] * w,
            d_ae * e,                          # d opacity
        ], -1).sum(1)                          # (T, CH, 9), summed over pixels
        d_feat.index_add_(0, gi[live], terms[live])
    return d_feat


def _check(feat, idx, starts, counts, tx_n: int):
    dev, n, m, n_tiles = feat.device, feat.shape[0], idx.shape[0], starts.shape[0]
    if tx_n <= 0 or n_tiles % tx_n:
        raise ValueError(f"{n_tiles} tiles do not fill rows of tx_n={tx_n}")
    if max(n, m) >= 2**31:
        raise ValueError(f"{n} gaussians / {m} entries exceed the kernel's int32 indexing")
    check_tensor("feat", feat, (n, 9), torch.float32, dev)
    check_tensor("idx", idx, (m,), torch.int32, dev)
    check_tensor("starts", starts, (n_tiles,), torch.int32, dev)
    check_tensor("counts", counts, (n_tiles,), torch.int32, dev)
    return n, m, n_tiles


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def blend_forward(feat, idx, starts, counts, tx_n: int, bg: float = 0.0,
                  keep_state: bool = False):
    """The blend without autograd: (img (H,W,3), trans (H,W)), and with
    ``keep_state`` also the state (H*W, 4) float64 that the backward kernel
    reads on CUDA tensors (None on CPU tensors): each pixel's colour before
    the background, summed in double, and its final T."""
    img, trans, state = _blend_forward(feat, idx, starts, counts, tx_n, bg, keep_state)
    return (img, trans, state) if keep_state else (img, trans)


def _blend_forward(feat, idx, starts, counts, tx_n: int, bg: float, keep_state: bool):
    if feat.device.type == "cpu":
        return (*blend_plain(feat, idx, starts, counts, tx_n, bg), None)
    if feat.device.type != "cuda":
        raise ValueError(f"blend: unsupported device {feat.device}")
    global BLEND_LAUNCHES
    n, m, n_tiles = _check(feat, idx, starts, counts, tx_n)
    h, w = n_tiles // tx_n * TILE, tx_n * TILE
    img = torch.empty((h, w, 3), dtype=torch.float32, device=feat.device)
    trans = torch.empty((h, w), dtype=torch.float32, device=feat.device)
    state = (torch.empty((h * w, 4), dtype=torch.float64, device=feat.device) if keep_state
             else None)
    lib = _lib()
    code = lib.pixie_gs_blend(feat.data_ptr(), idx.data_ptr(), starts.data_ptr(),
                              counts.data_ptr(), n, m, n_tiles, tx_n, float(bg),
                              img.data_ptr(), trans.data_ptr(),
                              0 if state is None else state.data_ptr(), _stream(feat.device))
    raise_on_error(lib, code, "gs blend")
    BLEND_LAUNCHES += 1
    return img, trans, state


def _launch_backward(mode: int, feat, idx, starts, counts, tx_n: int, bg: float, d_img,
                     d_trans, state):
    n, m, n_tiles = _check(feat, idx, starts, counts, tx_n)
    h, w = n_tiles // tx_n * TILE, tx_n * TILE
    check_tensor("d_img", d_img, (h, w, 3), torch.float32, feat.device)
    check_tensor("d_trans", d_trans, (h, w), torch.float32, feat.device)
    if mode != BWD_MODES["pass1"]:
        if state is None:
            raise ValueError("blend backward: the kernel reads the forward's state "
                             "(blend_forward(..., keep_state=True))")
        check_tensor("state", state, (h * w, 4), torch.float64, feat.device)
    per_pixel = mode == BWD_MODES["noreduce"]
    out = torch.zeros((h * w, 9) if per_pixel else (n, 9), dtype=torch.float32,
                      device=feat.device)
    lib = _lib()
    code = lib.pixie_gs_blend_backward(
        mode, feat.data_ptr(), idx.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        n, m, n_tiles, tx_n, float(bg), d_img.data_ptr(), d_trans.data_ptr(),
        0 if state is None else state.data_ptr(),
        0 if per_pixel else out.data_ptr(), out.data_ptr() if per_pixel else 0,
        _stream(feat.device))
    raise_on_error(lib, code, "gs blend backward")
    return out


def blend_backward(feat, idx, starts, counts, tx_n: int, bg: float, d_img, d_trans,
                   state=None):
    """d feat (N, 9) of the blend for the cotangents d_img (H,W,3) and
    d_trans (H,W); CPU tensors take ``blend_backward_plain``, CUDA tensors
    need the forward's ``state`` (``blend_forward(..., keep_state=True)``)."""
    if feat.device.type == "cpu":
        return blend_backward_plain(feat, idx, starts, counts, tx_n, bg, d_img, d_trans)
    if feat.device.type != "cuda":
        raise ValueError(f"blend backward: unsupported device {feat.device}")
    global BLEND_BWD_LAUNCHES
    d_feat = _launch_backward(0, feat, idx, starts, counts, tx_n, bg, d_img, d_trans, state)
    BLEND_BWD_LAUNCHES += 1
    return d_feat


def blend_backward_variant(mode: str, feat, idx, starts, counts, tx_n: int, bg: float, d_img,
                           d_trans, state=None):
    """An ablation of the backward kernel on CUDA tensors (``BWD_MODES``):
    d feat (N, 9) (pass1), or each pixel's 9 terms summed over its entries,
    (H*W, 9) (noreduce).  Not counted in BLEND_BWD_LAUNCHES."""
    if feat.device.type != "cuda":
        raise ValueError(f"blend backward {mode}: a kernel ablation, CUDA only")
    return _launch_backward(BWD_MODES[mode], feat, idx, starts, counts, tx_n, bg, d_img,
                            d_trans, state)


class _Blend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, idx, starts, counts, tx_n, bg):
        img, trans, state = _blend_forward(feat, idx, starts, counts, tx_n, bg,
                                           ctx.needs_input_grad[0])
        ctx.save_for_backward(feat, idx, starts, counts, state)
        ctx.tx_n, ctx.bg = tx_n, bg
        return img, trans

    @staticmethod
    def backward(ctx, d_img, d_trans):
        feat, idx, starts, counts, state = ctx.saved_tensors
        d_feat = blend_backward(feat, idx, starts, counts, ctx.tx_n, ctx.bg,
                                d_img.contiguous(), d_trans.contiguous(), state)
        return d_feat, None, None, None, None, None


def blend(feat, idx, starts, counts, tx_n: int, bg: float = 0.0):
    """Blend every tile's depth-sorted splats front to back; see the module
    docstring for the inputs.  Returns (img (H,W,3), trans (H,W)),
    differentiable in ``feat``."""
    return _Blend.apply(feat, idx, starts, counts, tx_n, float(bg))
