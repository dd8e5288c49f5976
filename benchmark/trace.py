"""Reading torch.profiler windows: device busy time, kernels by name and
launches from a trace of the device alone, and the idle gaps named by what
the host was doing from a trace of both.

The profiler's raw events (``kineto_results.events()``) are read once,
without building the profiler's own summaries, so a window of a million
kernels reads in seconds.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

# device activity that is not a kernel launch
_NOT_KERNEL = ("Memcpy", "Memset")
# the benchmark's own spans (record_function) start with this
SPAN_PREFIX = "bench."


@dataclasses.dataclass
class TraceSummary:
    window_s: float                        # the traced window, host clock
    work: int                              # work done in it (substeps, grids)
    busy_s: float                          # union of device activity in it
    launches: int                          # kernels that ran on the device
    kernels: dict                          # name -> [count, seconds]
    idle_gaps: list = dataclasses.field(default_factory=list)  # [[host activity, s], ...]

    def kernel_seconds(self, match) -> tuple[int, float]:
        """(count, seconds) of the kernels whose name ``match`` accepts."""
        n, s = 0, 0.0
        for name, (c, sec) in self.kernels.items():
            if match(name):
                n, s = n + c, s + sec
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        return {"device_ops": [[name[:160], sec] for name, (_, sec) in ops],
                "idle_gaps": self.idle_gaps[:top]}


def _events(prof):
    """(device, host, span) events of a profiler, each (start_ns, end_ns,
    name), the device's sorted by start."""
    dev, host, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind, ev = str(e.device_type()), (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if kind.endswith("CUDA"):
            if not ev[2].startswith(SPAN_PREFIX):      # the spans' shadows on the device
                dev.append(ev)
        elif kind.endswith("CPU"):
            (spans if ev[2].startswith(SPAN_PREFIX) else host).append(ev)
    dev.sort()
    return dev, host, spans


def _busy_and_gaps(dev):
    """Union of the device's activity (ns) and its idle gaps [(start, end)]."""
    if not dev:
        return 0, []
    busy, gaps = 0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, gaps


def summarize(prof, window_s: float, work: int) -> TraceSummary:
    """Summary of the profiler ``prof`` whose traced window lasted
    ``window_s`` on the host clock and did ``work``."""
    dev, _, _ = _events(prof)
    kernels: dict = defaultdict(lambda: [0, 0.0])
    launches = 0
    for s, e, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (e - s) * 1e-9
        launches += not name.startswith(_NOT_KERNEL)
    busy, _ = _busy_and_gaps(dev)
    return TraceSummary(window_s, work, busy * 1e-9, launches, dict(kernels))


def idle_gaps(prof) -> list:
    """The device's idle gaps in a profiler that traced the host too,
    summed by what the host was doing at each gap's middle: the innermost
    of the benchmark's spans and the innermost other host event there
    ("python" where the host ran no recorded operation), e.g.
    "bench.substeps/aten::index"; longest first."""
    dev, host, spans = _events(prof)
    _, gaps = _busy_and_gaps(dev)
    host.sort()
    spans.sort()
    hs, ss = [h[0] for h in host], [s[0] for s in spans]
    total: dict = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        span = _innermost(spans, ss, mid, len(spans))
        op = _innermost(host, hs, mid, 64) or "python"
        total[f"{span}/{op}" if span else op] += (e - s) * 1e-9
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])]


def _innermost(events, starts, t: int, depth: int) -> str:
    """Name of the latest-starting event of ``events`` (sorted by start)
    that covers t, looking back ``depth`` events; "" if none."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(events[max(0, i - depth):i]):
        if e >= t:
            return name
    return ""
