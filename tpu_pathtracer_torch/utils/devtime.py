"""Device time of a callable, from torch.profiler's CUDA activity.

The port of `tpu_pathtracer.utils.devtime`.  The JAX package reads the
device spans of its XLA programs from a `jax.profiler` trace; here the
profiler records the card's kernels, copies and fills through CUPTI, the
counterpart of the reference's GPU timestamp queries (reference:
src/timing.ts:28-146): time spent on the device, not host wall time.
Nothing is written to disk.
"""

from __future__ import annotations

from typing import Callable


def device_time(fn: Callable[[], object], *, device="cuda", match: str = "") -> dict:
    """Run `fn` under the profiler; return device-side timing totals.

    Returns {"total_s": the summed duration of the device activity whose
    name contains `match` (every kernel, copy and fill by default),
    "count": how many such activities were recorded, "programs": {name:
    seconds}, "ok": bool}.  For a `device` that is not a CUDA device
    nothing is profiled and "ok" is False: the profiler's CUDA activity is
    requested only where a card runs the work."""
    import torch

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return {"total_s": 0.0, "count": 0, "programs": {}, "ok": False,
                "error": f"no CUDA activity on device {device}"}
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    programs: dict = {}
    count = 0
    for evt in prof.key_averages():  # CUDA activity only: kernels, copies, fills
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            programs[evt.key] = us / 1e6
            count += evt.count if match in evt.key else 0
    total = sum(dur for name, dur in programs.items() if match in name)
    return {"total_s": total, "count": count, "programs": programs, "ok": bool(programs)}
