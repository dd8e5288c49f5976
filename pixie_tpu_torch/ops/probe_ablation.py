"""The P2G ablation probe: four variants of the shipped P2G, the CUDA
kernels and their plain PyTorch versions.

Counterpart of ``scripts/probe_kernel_ablation.py`` (its ``pallas_call`` at
:112), which ablated the TPU's P2G body.  Here the variants ablate B1, the
Hopper P2G of ``ops/transfer.py``: every variant runs behind B1's bin keys
(``transfer.p2g_bin_keys``) and ``torch.sort``, and its kernel takes the
sorted positions as B1's splat does.  ``csrc/probe_ablation.cu`` says what
each removes and which TPU variant it stands for:

  * ``full``: B1 itself, (G,G,G,4); its plain version is
    ``transfer.p2g_plain``;
  * ``noweights``: weight, weight gradient and APIC offset the constant
    ``ABLATE`` at every node, same runs and scatter, (G,G,G,4);
  * ``noatomics``: (N,4), row q (a sorted position) the sum over the run of
    same-cell lanes that ends at q, in its warp of 32, of its particles'
    in-grid node values; 0 at every position that ends no run of live
    lanes (``run_sums_plain`` emulates the runs);
  * ``minimal``: the sum of the particle's 26 input floats in the order x,
    v, C, stress, mass, vol, (N,).

A particle whose key names no bin (inactive, not finite, or its stencil off
the grid) contributes nothing (0 in ``minimal``).

Dispatch is by the device of the tensors, with no fallback: CPU tensors
take the plain version, CUDA tensors launch the kernel on the current
stream or raise.  ``LAUNCHES[mode]`` counts kernel launches (plain-version
calls are not counted; the key kernel and the sort are part of each).
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
        lib.pixie_p2g_probe.argtypes = ([_c_int] + [_c_void_p] * 10 + [_c_int] * 4
                                        + [_c_float] * 4 + [_c_void_p])
        lib.pixie_p2g_probe.restype = _c_int
        lib.pixie_error_string.argtypes = [_c_int]
        lib.pixie_error_string.restype = ctypes.c_char_p
        lib._pixie_typed = True
    return lib


def build() -> None:
    """Compile (or load from the build cache) the probe's kernels."""
    _lib()


def sorted_keys(x, active, cfg: MPMConfig):
    """(keys, perm): B1's bin keys sorted ascending (``transfer.p2g_bin_keys``,
    its key kernel on CUDA tensors), stably, so that the plain version of
    ``noatomics`` forms the same runs as the kernel."""
    return torch.sort(transfer.p2g_bin_keys(x, active, cfg.n_grid, cfg.inv_dx), stable=True)


def _live(keys: torch.Tensor, n_grid: int) -> torch.Tensor:
    """Whether each key names a bin (the particle splats)."""
    nb, hbits = transfer.bin_layout(n_grid)
    return (keys >> hbits) < nb ** 3


def _fold(x, v, C, stress, mass, vol, live) -> torch.Tensor:
    """(N,) sum of the 26 input floats of each particle, added one at a time
    in the kernel's order; 0 where the particle is not live."""
    n = x.shape[0]
    cols = torch.cat([x, v, C.reshape(n, 9), stress.reshape(n, 9), mass[:, None],
                      vol[:, None]], dim=1)
    acc = cols[:, 0]
    for k in range(1, cols.shape[1]):
        acc = acc + cols[:, k]
    return torch.where(live, acc, 0.0)


def run_sums_plain(rows: torch.Tensor, keys: torch.Tensor, perm: torch.Tensor, x,
                   cfg: MPMConfig) -> torch.Tensor:
    """(N,4) of ``noatomics``: sorted position q takes particle perm[q]; in
    each warp of 32 positions, each run of adjacent live positions with one
    base cell sums its particles' ``rows`` (their in-grid node values summed)
    into the run's last position; every other position is 0."""
    n, g = keys.shape[0], cfg.n_grid
    live = _live(keys, g)
    base = torch.floor(x[perm] * cfg.inv_dx - 0.5)
    base = torch.where(live[:, None], base, 0.0).to(torch.int64) + 2
    lane = torch.arange(n, device=x.device) % 32
    label = torch.where(live, (base[:, 0] * (g + 2) + base[:, 1]) * (g + 2) + base[:, 2],
                        -1 - lane)
    step = torch.ones(n, dtype=torch.bool, device=x.device)
    step[1:] = label[1:] != label[:-1]
    head = step | (lane == 0)
    last = torch.ones_like(head)
    last[:-1] = head[1:]
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    sums = torch.zeros((int(run[-1]) + 1 if n else 0, 4), dtype=torch.float32, device=x.device)
    sums.index_add_(0, run, torch.where(live[:, None], rows[perm], 0.0))
    return torch.where((live & last)[:, None], sums[run], 0.0)


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
    # the plain keys on any device: the reference shares no kernel with
    # what it checks (sorted stably, as the kernel's are)
    keys, perm = torch.sort(transfer.p2g_bin_keys_plain(x, active, cfg.n_grid, cfg.inv_dx),
                            stable=True)
    if mode == "noatomics":
        return run_sums_plain(transfer.p2g_contributions(*args)[0].sum(0), keys, perm, x, cfg)
    if mode == "minimal":
        live = torch.empty_like(active)
        live[perm] = _live(keys, cfg.n_grid)
        return _fold(x, v, C, stress, mass, vol, live)
    raise ValueError(f"p2g_variant: unknown mode {mode!r}, expected one of {MODES}")


def p2g_variant(mode: str, x, v, C, stress, mass, vol, active, cfg: MPMConfig,
                dt) -> torch.Tensor:
    """One P2G variant of the ablation probe.

    x, v (N,3); C, stress (N,3,3); mass, vol (N,); active (N,) bool.
    Returns (G,G,G,4) for ``full`` and ``noweights``, (N,4) for
    ``noatomics`` (rows by sorted position) and (N,) for ``minimal``.  On
    CUDA: B1's key kernel, ``torch.sort`` of the keys, the variant's kernel.
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
    nb, hbits = transfer.bin_layout(g)
    keys, perm = sorted_keys(x, active, cfg)
    lib = _lib()
    grid = out = None
    if mode in ("full", "noweights"):
        grid = torch.zeros((g, g, g, 4), dtype=f32, device=dev)
    else:
        out = torch.empty((n, 4) if mode == "noatomics" else (n,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.pixie_p2g_probe(
        MODES.index(mode), keys.data_ptr(), perm.data_ptr(), x.data_ptr(), v.data_ptr(),
        C.data_ptr(), stress.data_ptr(), mass.data_ptr(), vol.data_ptr(),
        None if grid is None else grid.data_ptr(), None if out is None else out.data_ptr(),
        n, g, nb, hbits, cfg.dx, cfg.inv_dx, float(dt), cfg.rpic_damping, stream)
    raise_on_error(lib, code, f"p2g_variant[{mode}]")
    LAUNCHES[mode] += 1
    return out if grid is None else grid
