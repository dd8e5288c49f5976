"""The arithmetic of the metric readers (``metrics/<name>.py`` each bind one
of these as their ``read``).  Which cells a metric is read in is
``BENCHMARK.json``'s to say (its ``workloads``); a reader returns None only
where its run has nothing to read: an untraced run, a kernel that did not
run."""

from __future__ import annotations

from benchmark import counts


def rate(run):
    """Work done in the window over the window's wall time, from its start
    to the synchronised end of its last unit."""
    return run.work / run.window_s if run.work else None


def setup_s(run):
    """Process start to the window's start: imports, CUDA context, the
    kernels' libraries, seeded inputs, warm-up."""
    return run.setup_s


def _traced(run):
    t = run.trace
    return t if t is not None and t.busy_s else None


def idle_share(run):
    """Share (%) of the time in which no device activity ran: the device's
    busy time a unit of work in the device-only trace, against the time a
    unit of work takes untraced (even device-only tracing slows the host's
    launches)."""
    t = _traced(run)
    if t is None:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.work) / (run.window_s / run.work))


def launches_per_substep(run):
    """Kernels that ran on the device in the traced window, over its substeps."""
    t = _traced(run)
    return None if t is None or not t.launches else t.launches / t.work


def substep_roofline(run):
    """The least time of one substep's work (``counts.substep_work``) over
    the mean substep time of the traced run's untraced units, in %."""
    if _traced(run) is None:
        return None
    least = counts.least_time(*counts.substep_work(run.cfg["n_particles"], run.cfg["n_grid"]))
    return 100.0 * least / (run.window_s / run.work)


def substep_mfu(run):
    """The substeps' float32 operations (``counts.SUBSTEP_FLOPS`` a particle)
    over the traced run's untraced units, as a share (%) of the card's
    float32 peak."""
    if _traced(run) is None:
        return None
    flops = counts.substep_work(run.cfg["n_particles"], run.cfg["n_grid"])[0] * run.work
    return 100.0 * flops / run.window_s / counts.PEAK_F32_FLOPS


def unet_mfu(run):
    """Both nets' operations a grid (``counts.material_flops``) times the
    traced run's untraced grids, over their time, as a share (%) of the
    card's float32 peak (TF32 is off)."""
    if _traced(run) is None:
        return None
    return 100.0 * counts.material_flops(run.cfg) * run.work / run.window_s / counts.PEAK_F32_FLOPS


def kernel_roofline(calls_of, time_of, work):
    """A kernel's least time (``work(n, n_grid)`` -> (flops, bytes)) over its
    device time a call, in %: ``calls_of`` names the kernel counted once a
    call, ``time_of`` every kernel that call launches."""
    def read(run):
        t = _traced(run)
        if t is None:
            return None
        calls, _ = t.kernel_seconds(calls_of)
        if not calls:
            return None
        _, seconds = t.kernel_seconds(time_of)
        least = counts.least_time(*work(run.cfg["n_particles"], run.cfg["n_grid"]))
        return 100.0 * least / (seconds / calls)
    return read


def _b1(name):
    # B1 (ops/transfer.py p2g): the key kernel, torch.sort's radix passes, the binned splat
    return "p2g_keys_kernel" in name or "p2g_binned_kernel" in name or "RadixSort" in name


p2g_roofline = kernel_roofline(lambda n: "p2g_binned_kernel" in n, _b1, counts.p2g_work)
g2p_roofline = kernel_roofline(lambda n: "g2p_kernel" in n, lambda n: "g2p_kernel" in n,
                               counts.g2p_work)
fused_roofline = kernel_roofline(lambda n: "fused_substep_kernel" in n,
                                 lambda n: "fused_substep_kernel" in n, counts.fused_work)


def device_ms_per_unit(run):
    """The device's busy time a unit of work (substep, grid) in the
    device-only trace, in ms: steadier than the host-clock rate it stands
    beside, and moved only by the work on the device."""
    t = _traced(run)
    return None if t is None else 1e3 * t.busy_s / t.work
