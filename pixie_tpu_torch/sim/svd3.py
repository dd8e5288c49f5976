"""Batched 3x3 SVD with Warp's ``wp.svd3`` sign convention (port of
pixie_tpu/sim/svd3.py).

Convention: U and V are proper rotations, singular values are sorted
descending and the smallest carries sign(det F).  ``torch.linalg.svd`` does
not follow it, so the algorithm itself is ported: cyclic Jacobi on F^T F,
a 3-element sorting network, Gram-Schmidt re-orthonormalization of V with
cross-product completion, and U columns from F v_i.  Elementwise arithmetic
follows the JAX code term for term.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def det3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3)."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def matmul_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b for (...,3,3)."""
    return a.transpose(-1, -2) @ b


def matmul_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T for (...,3,3)."""
    return a @ b.transpose(-1, -2)


def diag_mm_nt(u: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """U diag(s) V^T."""
    return (u * s[..., None, :]) @ v.transpose(-1, -2)


def _jacobi_rotation(app, aqq, apq):
    """Stable symmetric Schur rotation (c, s) annihilating apq."""
    trivial = apq.abs() < _EPS
    safe_apq = torch.where(trivial, 1.0, apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, 1.0, t)  # tau==0 -> 45 degree rotation
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(trivial, 1.0, c)
    s = torch.where(trivial, 0.0, s)
    return c, s


def _rotate_pq(s, v, c, sn, p: int, q: int):
    """(G^T S G, V G) for the Givens rotation G in the (p, q) plane."""
    c = c[..., None]
    sn = sn[..., None]
    sp, sq = s[..., :, p], s[..., :, q]
    s1 = s.clone()
    s1[..., :, p] = c * sp - sn * sq
    s1[..., :, q] = sn * sp + c * sq
    rp, rq = s1[..., p, :], s1[..., q, :]
    s2 = s1.clone()
    s2[..., p, :] = c * rp - sn * rq
    s2[..., q, :] = sn * rp + c * rq
    vp, vq = v[..., :, p], v[..., :, q]
    v1 = v.clone()
    v1[..., :, p] = c * vp - sn * vq
    v1[..., :, q] = sn * vp + c * vq
    return s2, v1


def _eigh3(s_mat: torch.Tensor, sweeps: int = 5):
    """Cyclic Jacobi eigendecomposition of symmetric (N,3,3): (w (N,3), V)."""
    s = s_mat
    v = torch.eye(3, dtype=s_mat.dtype, device=s_mat.device).expand(s_mat.shape)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            c, sn = _jacobi_rotation(s[..., p, p], s[..., q, q], s[..., p, q])
            s, v = _rotate_pq(s, v, c, sn, p, q)
    w = torch.stack([s[..., 0, 0], s[..., 1, 1], s[..., 2, 2]], dim=-1)
    return w, v


def _norm3(x, keepdim=False):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def _normalize(x):
    return x / torch.clamp(_norm3(x, keepdim=True), min=_EPS)


def _axis(i: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros(3, dtype=like.dtype, device=like.device)
    e[i] = 1.0
    return e.expand(like.shape)


def svd3(f: torch.Tensor, sweeps: int = 5):
    """(u, sigma, v) with f = u diag(sigma) v^T in Warp's convention."""
    ft_f = matmul_tn(f, f)
    w, v = _eigh3(ft_f, sweeps=sweeps)

    # sort eigenpairs descending (same sorting network as the JAX code)
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    v0, v1, v2 = v[..., :, 0], v[..., :, 1], v[..., :, 2]

    def cswap(wa, va, wb, vb):
        swap = wa < wb
        sw = swap[..., None]
        return (torch.where(swap, wb, wa), torch.where(sw, vb, va),
                torch.where(swap, wa, wb), torch.where(sw, va, vb))

    w0, v0, w1, v1 = cswap(w0, v0, w1, v1)
    w0, v0, w2, v2 = cswap(w0, v0, w2, v2)
    w1, v1, w2, v2 = cswap(w1, v1, w2, v2)
    w = torch.stack([w0, w1, w2], dim=-1)

    # V as a proper rotation: Gram-Schmidt + cross completion (det V = +1)
    v0 = _normalize(v0)
    v1 = v1 - torch.sum(v1 * v0, dim=-1, keepdim=True) * v0
    exv, eyv = _axis(0, v0), _axis(1, v0)
    alt_v = torch.linalg.cross(v0, exv, dim=-1)
    alt_v = torch.where(_norm3(alt_v, keepdim=True) < 1e-6,
                        torch.linalg.cross(v0, eyv, dim=-1), alt_v)
    v1 = torch.where(_norm3(v1, keepdim=True) < 1e-6, _normalize(alt_v), _normalize(v1))
    v2 = torch.linalg.cross(v0, v1, dim=-1)
    v = torch.stack([v0, v1, v2], dim=-1)

    sigma = torch.sqrt(torch.clamp(w, min=0.0))

    # U columns: normalize F v_i, orthogonal completion for tiny sigma
    fv = f @ v
    u0 = _normalize(fv[..., :, 0])
    u1_raw = fv[..., :, 1]
    u1_raw = u1_raw - torch.sum(u1_raw * u0, dim=-1, keepdim=True) * u0
    ex, ey, ez = _axis(0, u0), _axis(1, u0), _axis(2, u0)
    alt = torch.linalg.cross(u0, ex, dim=-1)
    alt = torch.where(_norm3(alt, keepdim=True) < 1e-6,
                      torch.linalg.cross(u0, ey, dim=-1), alt)
    u1 = torch.where(
        _norm3(u1_raw, keepdim=True) < 1e-6 * torch.clamp(sigma[..., :1], min=1e-6),
        _normalize(alt),
        _normalize(u1_raw),
    )
    u2 = torch.linalg.cross(u0, u1, dim=-1)  # det U = +1
    tiny = (sigma[..., 0] < 1e-10)[..., None]
    u0 = torch.where(tiny, ex, u0)
    u1 = torch.where(tiny, ey, u1)
    u2 = torch.where(tiny, ez, u2)
    u = torch.stack([u0, u1, u2], dim=-1)

    # sigma[2] carries sign(det F) (Warp's convention)
    det_f = det3(f)
    s2 = sigma[..., 2] * torch.where(det_f < 0.0, -1.0, 1.0)
    sigma = torch.stack([sigma[..., 0], sigma[..., 1], s2], dim=-1)
    return u, sigma, v
