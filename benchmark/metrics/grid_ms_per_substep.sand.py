"""The grid's device time a substep on a large grid: every kernel and
memset of the device-only trace but the particles' own, B1
(``p2g_keys_kernel``, torch.sort's radix passes, ``p2g_binned_kernel``), B2
(``g2p_kernel``) and B7 (``constitutive_kernel``), over the traced
substeps, in ms.  What is left is B8 (the grid update with its BCs), the
P2G grid's zero fill and memsets, and the re-sort's gathers; copies are
not counted."""

_PARTICLE_KERNELS = ("p2g_keys_kernel", "RadixSort", "p2g_binned_kernel", "g2p_kernel",
                     "constitutive_kernel")


def read(run):
    t = run.trace
    if t is None or not t.busy_s:
        return None
    n, seconds = t.kernel_seconds(lambda name: not name.startswith("Memcpy")
                                  and not any(k in name for k in _PARTICLE_KERNELS))
    return 1e3 * seconds / t.work if n else None
