"""B8's share of its roofline: the grid stage's least time at the run's
n_grid (``grid_counts.grid_least_time``, 28 B a node) over
``grid_stage_kernel``'s mean device time a launch in the device-only
trace, in %; None where the kernel did not run (the plain grid stage of a
program without B8)."""

from benchmark import grid_counts


def read(run):
    t = run.trace
    if t is None or not t.busy_s:
        return None
    calls, seconds = t.kernel_seconds(lambda name: "grid_stage_kernel" in name)
    if not calls:
        return None
    return 100.0 * grid_counts.grid_least_time(int(run.cfg["n_grid"])) / (seconds / calls)
