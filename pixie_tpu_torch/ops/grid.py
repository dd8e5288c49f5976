"""The grid stage on the card: momentum to velocity, gravity, damping and
every grid BC in one CUDA kernel launch (B8, ``csrc/grid.cu``).

``sim.solver.grid_update`` dispatches by the grid's device, with no
fallback: CPU tensors take the plain version (``grid_momentum_to_velocity``
then ``apply_grid_bcs``), CUDA tensors ``grid_stage`` here, which launches
the kernel on the current stream or raises.

The kernel replaces no TPU kernel: the JAX package leaves its jnp grid
stage to XLA, which fuses it, where eager PyTorch launches ~14 kernels over
the whole grid a substep.  It applies the BCs from a table built on the host
(``bc_table``) out of each grid BC's ``table_entry`` at the substep's time,
which ``sim.bc`` computes from the BC's host decisions and float32 host
copies next to its ``apply``: nothing is read back from the device, so a CUDA graph captures the table of
its substep, and the frame replays it only while the BCs' ``host_key``s
hold.  A table holds ``TABLE_CAPACITY`` entries; a longer list of BCs runs
the kernel again, in place, on the next part.

``GRID_LAUNCHES`` counts kernel launches (one a call unless the BCs
overflow a table); while a tracer is on, the counter ``sim.grid.launches``
counts them too.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from pixie_tpu_torch.ops.build import check_tensor, load_library, raise_on_error
from pixie_tpu_torch.sim import bc as bc_mod
from pixie_tpu_torch.sim.bc import (  # noqa: F401  (the table's kinds)
    BOUNDING_BOX, BOX_SET, ENTRY_FLOATS, HALFSPACE_CUT, HALFSPACE_FRICTION, HALFSPACE_SLIP,
    HALFSPACE_ZERO, ZERO_ALL)
from pixie_tpu_torch.sim.types import MPMConfig
from pixie_tpu_torch.utils import observability as obs

GRID_LAUNCHES = 0

TABLE_CAPACITY = 16   # csrc/grid.cu kMaxBCs

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = load_library("grid")
    if not getattr(lib, "_pixie_typed", False):
        lib.pixie_grid_stage.argtypes = ([_c_void_p] * 2 + [_c_int] * 2 + [_c_float] * 2
                                         + [_c_int] + [_c_float] * 3 + [_c_int, _c_float, _c_int]
                                         + [_c_void_p] * 3)
        lib.pixie_grid_stage.restype = _c_int
        lib.pixie_error_string.argtypes = [_c_int]
        lib.pixie_error_string.restype = ctypes.c_char_p
        lib._pixie_typed = True
    return lib


def build() -> None:
    """Compile (or load from the build cache) the grid stage kernel."""
    _lib()


def bc_table(bcs: Sequence, t, dt) -> list[tuple[np.ndarray, np.ndarray]]:
    """The grid BCs of ``bcs`` that act at substep time ``t``, in their
    order, as tables of at most TABLE_CAPACITY entries: each an (k,) int32
    array of kinds and a (k, ENTRY_FLOATS) float32 array, of the BCs'
    ``table_entry``s.  The BCs other than ``sim.bc.GRID_BC_TYPES``, as the
    plain ``apply_grid_bcs`` does, and the BCs inactive at t are left out; a
    grid BC without a ``table_entry`` raises.  No table for no entry."""
    entries = []
    for b in bcs:
        if not isinstance(b, bc_mod.GRID_BC_TYPES):
            continue
        if not hasattr(b, "table_entry"):
            raise TypeError(f"{type(b).__name__} has no table entry for the card's grid stage")
        entry = b.table_entry(t, dt)
        if entry is not None:
            entries.append(entry)
    return [(np.array([k for k, _ in part], np.int32),
             np.stack([v for _, v in part]).astype(np.float32))
            for part in (entries[i:i + TABLE_CAPACITY]
                         for i in range(0, len(entries), TABLE_CAPACITY))]


def grid_stage(grid: torch.Tensor, cfg: MPMConfig, dt, t, bcs: Sequence) -> torch.Tensor:
    """``sim.solver.grid_update`` on the card: the (G, G, G, 4) momentum
    and mass grid -> the (G, G, G, 3) velocity grid after gravity, damping
    and the grid BCs of ``bcs`` active at ``t``, in a new tensor."""
    global GRID_LAUNCHES
    dev, g = grid.device, cfg.n_grid
    if dev.type != "cuda":
        raise ValueError(f"grid_stage: unsupported device {dev}")
    check_tensor("grid", grid, (g, g, g, 4), torch.float32, dev)
    if grid.data_ptr() % 16:
        raise ValueError("grid must start on a 16-byte boundary")
    if g ** 3 > 2 ** 29:
        raise ValueError(f"n_grid {g} is too large for the grid kernel")
    out = torch.empty((g, g, g, 3), dtype=torch.float32, device=dev)
    dtg = np.float32(dt) * np.asarray(cfg.gravity, np.float32)
    damping = cfg.grid_v_damping_scale
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tables = bc_table(bcs, t, dt) or [(np.zeros(0, np.int32), np.zeros((0, ENTRY_FLOATS),
                                                                        np.float32))]
    for i, (kinds, vals) in enumerate(tables):
        code = lib.pixie_grid_stage(
            (grid if i == 0 else out).data_ptr(), out.data_ptr(), g, int(i == 0),
            float(cfg.dx), float(cfg.inv_dx), int(dtg.any()), *(float(a) for a in dtg),
            int(damping < 1.0), float(damping), len(kinds), kinds.ctypes.data,
            vals.ctypes.data, stream)
        raise_on_error(lib, code, "grid stage")
        GRID_LAUNCHES += 1
        obs.count("sim.grid.launches", 1)
    return out
