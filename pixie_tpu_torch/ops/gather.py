"""take_along_axis on a 2-D float32 table: the CUDA kernels and their plain
PyTorch version.

Counterpart of ``scripts/probe_vmem_gather.py`` (``kernel_axis0`` :30,
``kernel_axis1`` :36, called at :48), which probed the TPU's in-VMEM dynamic
gather; ``csrc/gather.cu`` says what bounds each axis on Hopper.  Both
compute ``np.take_along_axis(table, idx, axis)`` for a (T, L) float32 table
and (T, L) int32 indices:

  * axis 0: ``out[i, j] = table[idx[i, j], j]``;
  * axis 1: ``out[i, j] = table[i, idx[i, j]]``.

Indices are promised in bounds, as ``mode="promise_in_bounds"`` there: the
kernels do not check them, and the plain version raises ``IndexError`` on
one out of range.

Dispatch is by the device of the tensors, with no fallback: CPU tensors
take ``take_along_axis_plain``, CUDA tensors launch the kernel on the
current stream or raise.  ``LAUNCHES[axis]`` counts kernel launches
(plain-version calls are not counted).  ``torch.gather`` computes the same
function; ``chip_smoke.py`` times it as the kernels' yardstick, and the
package never calls it.
"""

from __future__ import annotations

import ctypes

import torch

from pixie_tpu_torch.ops.build import check_tensor, load_library, raise_on_error

LAUNCHES = {0: 0, 1: 0}
MAX_AXIS1_ROW = 12288   # axis 1 stages a row in 48 KB of shared memory

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load_library("gather")
    if not getattr(lib, "_pixie_typed", False):
        lib.pixie_take_along_axis.argtypes = [_c_void_p] * 3 + [_c_int] * 3 + [_c_void_p]
        lib.pixie_take_along_axis.restype = _c_int
        lib.pixie_error_string.argtypes = [_c_int]
        lib.pixie_error_string.restype = ctypes.c_char_p
        lib._pixie_typed = True
    return lib


def build() -> None:
    """Compile (or load from the build cache) the gather kernels."""
    _lib()


def _check_args(table, idx, axis) -> None:
    if axis not in (0, 1):
        raise ValueError(f"take_along_axis: axis must be 0 or 1, got {axis}")
    if table.dim() != 2 or tuple(idx.shape) != tuple(table.shape):
        raise ValueError(f"take_along_axis: table {tuple(table.shape)} and idx "
                         f"{tuple(idx.shape)} must be one (T, L) shape")


def take_along_axis_plain(table: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain PyTorch version: flat indices into ``table.reshape(-1)``."""
    _check_args(table, idx, axis)
    t, l = table.shape
    hi = table.shape[axis]
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= hi):
        raise IndexError(f"take_along_axis: index out of range [0, {hi}) on axis {axis}")
    idx = idx.to(torch.int64)
    if axis == 0:
        flat = idx * l + torch.arange(l, device=idx.device)[None, :]
    else:
        flat = torch.arange(t, device=idx.device)[:, None] * l + idx
    return table.reshape(-1)[flat]


def take_along_axis(table: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``np.take_along_axis(table, idx, axis)`` for (T, L) float32 ``table``
    and (T, L) int32 ``idx``, axis 0 or 1; returns (T, L) float32."""
    _check_args(table, idx, axis)
    if table.device.type == "cpu":
        return take_along_axis_plain(table, idx, axis)
    if table.device.type != "cuda":
        raise ValueError(f"take_along_axis: unsupported device {table.device}")
    t, l = table.shape
    dev = table.device
    check_tensor("table", table, (t, l), torch.float32, dev)
    check_tensor("idx", idx, (t, l), torch.int32, dev)
    if axis == 1 and l > MAX_AXIS1_ROW:
        raise ValueError(f"take_along_axis: axis 1 takes rows of at most {MAX_AXIS1_ROW} "
                         f"values, got {l}")
    lib = _lib()
    out = torch.empty((t, l), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.pixie_take_along_axis(table.data_ptr(), idx.data_ptr(), out.data_ptr(), t, l,
                                     axis, stream)
    raise_on_error(lib, code, f"take_along_axis[axis {axis}]")
    LAUNCHES[axis] += 1
    return out
