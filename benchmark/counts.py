"""The yardstick: the card's published peaks and the frozen counts of the
work the timed paths must do, from their shapes alone.

A count here is of the algorithm, not of an implementation: each
particle's state is read and written once, the grid written and read once,
and the operations are those of the equations, so a later PR that fuses,
reorders or drops kernels is held to the same least time.  Where the
amount of arithmetic depends on the method (the 3x3 SVD), the count is a
floor, so that no implementation reads above 100 % of its roofline.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense): HBM3 bandwidth and the float32 rate
# outside the tensor cores (TF32 is off in every timed path)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# -- MPM, per particle --------------------------------------------------------------------
# quadratic B-spline weights and their derivatives on 3 axes
_SPLINE = 3 * 18
# P2G, per node of the 27: weight product 2, weight gradient 9, x_i - x_p 6,
# C (x_i - x_p) 15, v + C dx 3, w m 1, momentum 3, stress force 15, sum 3,
# grid adds 4; per particle: -vol dt stress 10
P2G_FLOPS = _SPLINE + 10 + 27 * 61
# G2P, per node: weight 2, gradient 9, x_i - x_p 6, w v 3, v sum 3, C outer
# product 18, grad v 18; per particle: C scale 9, advection 6,
# F_trial = (I + dt grad v) F 57
G2P_FLOPS = _SPLINE + 27 * 59 + 9 + 6 + 57
# return mapping and Kirchhoff stress: F^T F 45, a floor of 210 for the
# eigen-rotations of one Jacobi sweep, U = F V / s 45, the mapping of the
# singular values ~60, U diag(t) U^T 60
CONSTITUTIVE_FLOPS = 45 + 210 + 45 + 60 + 60
SUBSTEP_FLOPS = P2G_FLOPS + G2P_FLOPS + CONSTITUTIVE_FLOPS

# bytes of one particle: float32 x, v (12 each), C, F, F_trial, stress (36
# each), mu, lam, yield stress, mass, vol, bulk (4 each), int32 material
# and selection (4 each), the bool active mask (1)
# P2G reads x, v, C, stress, mass, vol, active
P2G_PARTICLE_BYTES = 12 + 12 + 36 + 36 + 4 + 4 + 1
# G2P reads x, F, selection and writes x, v, C, F_trial
G2P_PARTICLE_BYTES = (12 + 36 + 4) + (12 + 12 + 36 + 36)
# the fused substep reads x, F, mu, lam, yield stress, mass, vol, material,
# active and writes x, v, C, F, F_trial, stress, mu, lam, yield stress
FUSED_PARTICLE_BYTES = (12 + 36 + 12 + 8 + 4 + 1) + (12 + 12 + 36 * 4 + 12)
# a whole substep carries x, v, C, F, mu, lam, yield stress from one
# substep to the next (read and written once) and reads mass, vol,
# material and active
SUBSTEP_PARTICLE_BYTES = (12 + 12 + 36 + 36 + 12) * 2 + 8 + 4 + 1
# grid nodes: momentum + mass (16 B) out of P2G, velocity (12 B) into G2P
GRID_P2G_BYTES, GRID_G2P_BYTES = 16, 12


def least_time(flops: float, nbytes: float) -> float:
    """Seconds the card needs at least: the larger of the two bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S)


def p2g_work(n: int, n_grid: int) -> tuple[float, float]:
    """(flops, bytes) of one P2G of n particles into an n_grid^3 grid."""
    return n * P2G_FLOPS, n * P2G_PARTICLE_BYTES + n_grid ** 3 * GRID_P2G_BYTES


def g2p_work(n: int, n_grid: int) -> tuple[float, float]:
    return n * G2P_FLOPS, n * G2P_PARTICLE_BYTES + n_grid ** 3 * GRID_G2P_BYTES


def fused_work(n: int, n_grid: int) -> tuple[float, float]:
    """G2P(s), the constitutive pass and P2G(s+1) in one pass."""
    return (n * SUBSTEP_FLOPS,
            n * FUSED_PARTICLE_BYTES + n_grid ** 3 * (GRID_G2P_BYTES + GRID_P2G_BYTES))


def substep_work(n: int, n_grid: int) -> tuple[float, float]:
    """One whole substep: the particles once, the grid written and read once."""
    return n * SUBSTEP_FLOPS, n * SUBSTEP_PARTICLE_BYTES + n_grid ** 3 * 2 * GRID_P2G_BYTES


# -- U-Nets ---------------------------------------------------------------------------------

def _conv(cin: int, cout: int, k: int, out_side: int) -> int:
    return 2 * cin * cout * k ** 3 * out_side ** 3


def unet_flops(cfg: dict, out_channels: int) -> dict:
    """Multiply-add operations (x2) of one net on one grid, by kind:
    "conv3d" (every 3-D convolution, the projector's included) and
    "attention" (the 1x1 projections and both products of each attention
    block).  Norms, activations and biases are not counted."""
    side, fc, cd = cfg["grid_size"], cfg["feature_channels"], cfg["cond_dim"]
    mc, mult, nrb = cfg["model_channels"], cfg["channel_mult"], cfg["num_res_blocks"]
    attn_res = cfg["attention_resolutions"]
    conv = attn = 0
    if fc != cd:
        if fc > cd:
            conv += _conv(fc, 128, 1, side) + _conv(128, 128, 3, side) + _conv(128, cd, 1, side)
        else:
            conv += _conv(fc, cd, 1, side)

    def res(cin, cout, s):
        return _conv(cin, cout, 3, s) + _conv(cout, cout, 3, s) + (
            _conv(cin, cout, 1, s) if cin != cout else 0)

    def attention(c, s):
        t = s ** 3
        return 2 * c * 3 * c * t + 2 * 2 * t * t * c + 2 * c * c * t

    conv += _conv(cd, mc, 3, side)
    chans, ch, ds, s, sizes = [mc], mc, 1, side, [side]
    for level, m in enumerate(mult):
        for _ in range(nrb):
            conv += res(ch, m * mc, s)
            ch = m * mc
            attn += attention(ch, s) if ds in attn_res else 0
            chans.append(ch)
        if level != len(mult) - 1:
            s_out = (s + 1) // 2
            conv += _conv(ch, ch, 3, s_out)
            chans.append(ch)
            sizes.append(s)
            ds, s = ds * 2, s_out
    conv += 2 * res(ch, ch, s)
    attn += attention(ch, s)
    for level, m in list(enumerate(mult))[::-1]:
        for j in range(nrb + 1):
            conv += res(ch + chans.pop(), mc * m, s)
            ch = mc * m
            attn += attention(ch, s) if ds in attn_res else 0
            if level and j == nrb:
                s = sizes.pop()
                conv += _conv(ch, ch, 3, s)
                ds //= 2
    conv += _conv(ch, out_channels, 3, s)
    return {"conv3d": conv, "attention": attn}


def material_flops(cfg: dict) -> float:
    """Both nets' operations on one grid."""
    return sum(sum(unet_flops(cfg, k).values())
               for k in (cfg["num_classes"], cfg["cont_channels"]))
