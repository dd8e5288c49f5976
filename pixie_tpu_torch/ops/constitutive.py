"""The constitutive pass: the return map of F_trial and the Kirchhoff stress
of the result, as one CUDA kernel launch, with its plain PyTorch version.

Dispatch is by the device of the tensors, with no fallback:

  * CPU tensors take ``sim.constitutive.compute_stress_from_F_trial``
    unchanged;
  * CUDA tensors launch the hand-written kernel of ``csrc/constitutive.cu``
    (B7) on the current stream, or raise;
  * any other device raises.

The kernel replaces no TPU kernel: the JAX package leaves its plain pass to
XLA, which fuses it into a few kernels, where eager PyTorch launches ~2,070
small ones a substep.  Its per-particle math is ``mpm.cuh``'s
``constitutive_update``, which the fused substep (B6) runs too.

Like the plain version the pass is functional: F, stress, mu, lam and
yield_stress (``OUTPUTS``) come back in new tensors, or in the tensors
given as ``out``, and the caller's state is not written.
``CONSTITUTIVE_LAUNCHES`` counts kernel launches (plain-version calls are
not counted).
"""

from __future__ import annotations

import ctypes

import torch

from pixie_tpu_torch.ops.build import check_tensor, load_library, raise_on_error
from pixie_tpu_torch.ops.fused_substep import material_mask
from pixie_tpu_torch.sim.constitutive import compute_stress_from_F_trial
from pixie_tpu_torch.sim.types import MPMConfig, MPMState

CONSTITUTIVE_LAUNCHES = 0

OUTPUTS = ("F", "stress", "mu", "lam", "yield_stress")
_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = load_library("constitutive")
    if not getattr(lib, "_pixie_typed", False):
        lib.pixie_constitutive.argtypes = ([_c_void_p] * 14 + [_c_int] + [_c_float] * 6
                                           + [_c_int, _c_void_p])
        lib.pixie_constitutive.restype = _c_int
        lib.pixie_error_string.argtypes = [_c_int]
        lib.pixie_error_string.restype = ctypes.c_char_p
        lib._pixie_typed = True
    return lib


def build() -> None:
    """Compile (or load from the build cache) the constitutive kernel."""
    _lib()


def constitutive_pass(state: MPMState, cfg: MPMConfig, dt,
                      out: dict[str, torch.Tensor] | None = None) -> MPMState:
    """``compute_stress_from_F_trial``: the material's return map of
    ``state.F_trial``, then the symmetrized Kirchhoff stress of the
    returned F, for the particles with selection == 0; the others keep F,
    stress, mu, lam and yield_stress.  Returns the state with those five
    fields replaced by new tensors, or by ``out``'s (a tensor for each name
    of ``OUTPUTS``, none of them the state's own), which the pass writes;
    ``state`` itself is not written."""
    dev = state.F_trial.device
    if dev.type == "cpu":
        new = compute_stress_from_F_trial(state, cfg, dt)
        if out is None:
            return new
        for k in OUTPUTS:
            out[k].copy_(getattr(new, k))
        return state.replace(**out)
    if dev.type != "cuda":
        raise ValueError(f"constitutive_pass: unsupported device {dev}")
    global CONSTITUTIVE_LAUNCHES
    new = _launch(state, cfg, dt, out)
    CONSTITUTIVE_LAUNCHES += 1
    return new


def _launch(state: MPMState, cfg: MPMConfig, dt, out=None) -> MPMState:
    n, dev, f32 = state.n_particles, state.F_trial.device, torch.float32
    for name, shape in (("F_trial", (n, 3, 3)), ("F", (n, 3, 3)), ("stress", (n, 3, 3)),
                        ("mu", (n,)), ("lam", (n,)), ("yield_stress", (n,)), ("bulk", (n,))):
        check_tensor(name, getattr(state, name), shape, f32, dev)
    for name in ("material", "selection"):
        check_tensor(name, getattr(state, name), (n,), torch.int32, dev)
    if out is None:
        out = {k: torch.empty_like(getattr(state, k)) for k in OUTPUTS}
    for k in OUTPUTS:
        check_tensor(f"out[{k!r}]", out[k], tuple(getattr(state, k).shape), f32, dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.pixie_constitutive(
        *(getattr(state, k).data_ptr() for k in ("F_trial", "F", "stress", "mu", "lam",
                                                  "yield_stress", "material", "bulk",
                                                  "selection")),
        *(out[k].data_ptr() for k in OUTPUTS), n, float(dt), float(cfg.hardening),
        float(cfg.xi), float(cfg.alpha), float(cfg.plastic_viscosity), float(cfg.softening),
        material_mask(cfg), stream)
    raise_on_error(lib, code, "constitutive")
    return state.replace(**out)
