"""Per-call timing of a kernel wrapper for the probes.

On a CUDA device each call is bracketed by two CUDA events, and a sleep
kernel is queued before it so that the device is still busy when the host
has enqueued the call: the events then bracket the call's device work (the
kernel, and the memset of a zeroed output) and not the host's launch
overhead, which for a kernel of a few microseconds is larger than the
kernel.  On the CPU the host clock is read around each call.
"""

from __future__ import annotations

import time

import torch

SLEEP_CYCLES = 4_000_000   # ~2 ms at the H100's 1.98 GHz boost clock


def time_calls(fn, calls: list[tuple], device: torch.device, warmup: int = 3) -> list[float]:
    """Milliseconds of ``fn(*args)`` for each ``args`` in ``calls``, after
    ``warmup`` untimed calls on the first."""
    for _ in range(warmup):
        fn(*calls[0])
    if device.type != "cuda":
        times = []
        for args in calls:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        return times
    events = []
    for args in calls:
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]
