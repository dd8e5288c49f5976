"""The P2G ablation probe: four variants of the shipped P2G splat, the CUDA
kernels and their plain PyTorch versions.

Counterpart of ``scripts/probe_kernel_ablation.py`` (its ``pallas_call`` at
:112), which ablated the TPU's P2G body.  Here the variants ablate the
Hopper splat of ``csrc/transfer.cu`` (``p2g_kernel``); ``csrc/probe_ablation.cu``
says what each removes and which TPU variant it stands for:

  * ``full``: the shipped B1 splat, (G,G,G,4); its plain version is
    ``transfer.p2g_plain``;
  * ``noweights``: weight, weight gradient and APIC offset the constant
    ``ABLATE`` at every node, same nodes and scatter, (G,G,G,4);
  * ``noatomics``: every node's contribution as in ``full``, summed over
    the 27 nodes per particle instead of scattered, (N,4);
  * ``minimal``: the sum of the particle's 26 input floats in the order x,
    v, C, stress, mass, vol, (N,).

Inactive particles contribute nothing (0 in the per-particle outputs).

Dispatch is by the device of the tensors, with no fallback: CPU tensors
take the plain version, CUDA tensors launch the kernel on the current
stream or raise.  ``LAUNCHES[mode]`` counts kernel launches (plain-version
calls are not counted).
"""

from __future__ import annotations

import ctypes

import torch

from pixie_tpu_torch.ops import transfer
from pixie_tpu_torch.ops.build import check_tensor, load_library, raise_on_error
from pixie_tpu_torch.sim.types import MPMConfig

MODES = ("full", "noweights", "noatomics", "minimal")
LAUNCHES = dict.fromkeys(MODES, 0)
ABLATE = 0.1   # csrc/mpm.cuh kAblate

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = load_library("probe_ablation")
    if not getattr(lib, "_pixie_typed", False):
        lib.pixie_p2g_probe.argtypes = ([_c_int] + [_c_void_p] * 9
                                        + [_c_int, _c_int] + [_c_float] * 4 + [_c_void_p])
        lib.pixie_p2g_probe.restype = _c_int
        lib.pixie_error_string.argtypes = [_c_int]
        lib.pixie_error_string.restype = ctypes.c_char_p
        lib._pixie_typed = True
    return lib


def build() -> None:
    """Compile (or load from the build cache) the probe's kernels."""
    _lib()


def _fold(x, v, C, stress, mass, vol, active) -> torch.Tensor:
    """(N,) sum of the 26 input floats of each particle, added one at a time
    in the kernel's order; 0 for inactive particles."""
    n = x.shape[0]
    cols = torch.cat([x, v, C.reshape(n, 9), stress.reshape(n, 9), mass[:, None],
                      vol[:, None]], dim=1)
    acc = cols[:, 0]
    for k in range(1, cols.shape[1]):
        acc = acc + cols[:, k]
    return torch.where(active, acc, 0.0)


def p2g_variant_plain(mode: str, x, v, C, stress, mass, vol, active, cfg: MPMConfig,
                      dt) -> torch.Tensor:
    """Plain PyTorch version of ``p2g_variant``."""
    args = (x, v, C, stress, mass, vol, active, cfg, dt)
    if mode == "full":
        return transfer.p2g_plain(*args)
    if mode == "noweights":
        weight, dweight, dpos, flat, in_bounds = transfer._stencil(x, cfg.n_grid, cfg.inv_dx)
        const = (torch.full_like(weight, ABLATE), torch.full_like(dweight, ABLATE) * cfg.inv_dx,
                 torch.full_like(dpos, ABLATE), flat, in_bounds)
        return transfer.scatter_to_grid(*transfer.p2g_contributions(*args, stencil=const),
                                        cfg.n_grid)
    if mode == "noatomics":
        return transfer.p2g_contributions(*args)[0].sum(0)
    if mode == "minimal":
        return _fold(x, v, C, stress, mass, vol, active)
    raise ValueError(f"p2g_variant: unknown mode {mode!r}, expected one of {MODES}")


def p2g_variant(mode: str, x, v, C, stress, mass, vol, active, cfg: MPMConfig,
                dt) -> torch.Tensor:
    """One P2G variant of the ablation probe.

    x, v (N,3); C, stress (N,3,3); mass, vol (N,); active (N,) bool.
    Returns (G,G,G,4) for ``full`` and ``noweights``, (N,4) for
    ``noatomics`` and (N,) for ``minimal``.
    """
    if mode not in MODES:
        raise ValueError(f"p2g_variant: unknown mode {mode!r}, expected one of {MODES}")
    if x.device.type == "cpu":
        return p2g_variant_plain(mode, x, v, C, stress, mass, vol, active, cfg, dt)
    if x.device.type != "cuda":
        raise ValueError(f"p2g_variant: unsupported device {x.device}")
    n, g, dev, f32 = x.shape[0], cfg.n_grid, x.device, torch.float32
    for name, t, shape in (("x", x, (n, 3)), ("v", v, (n, 3)), ("C", C, (n, 3, 3)),
                           ("stress", stress, (n, 3, 3)), ("mass", mass, (n,)),
                           ("vol", vol, (n,))):
        check_tensor(name, t, shape, f32, dev)
    check_tensor("active", active, (n,), torch.bool, dev)
    lib = _lib()
    grid = out = None
    if mode in ("full", "noweights"):
        grid = torch.zeros((g, g, g, 4), dtype=f32, device=dev)
    else:
        out = torch.empty((n, 4) if mode == "noatomics" else (n,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.pixie_p2g_probe(
        MODES.index(mode), x.data_ptr(), v.data_ptr(), C.data_ptr(), stress.data_ptr(),
        mass.data_ptr(), vol.data_ptr(), active.data_ptr(),
        None if grid is None else grid.data_ptr(), None if out is None else out.data_ptr(),
        n, g, cfg.dx, cfg.inv_dx, float(dt), cfg.rpic_damping, stream)
    raise_on_error(lib, code, f"p2g_variant[{mode}]")
    LAUNCHES[mode] += 1
    return out if grid is None else grid
