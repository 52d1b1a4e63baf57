"""Device time from jax.profiler traces.

A traced call's `.xplane.pb` holds one plane per accelerator
("/device:GPU:0", ...), whose lines carry the kernels that ran on it
with device start times and durations.  `device_events` reads those
planes with nothing but JAX (`jax.profiler.ProfileData`); `busy_ms` is
the union of the kernel intervals, the device's busy time in the
window; `kernel_ms` sums durations per kernel name.  The analogue of
the reference's GLTimerQueries (src/GLTimerQueries.cpp).
"""

from __future__ import annotations

import collections
import glob
import os
import tempfile


def latest_xplane(root: str) -> str:
    cands = sorted(glob.glob(os.path.join(root, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not cands:
        raise FileNotFoundError(f"no *.xplane.pb under {root}")
    return cands[-1]


def is_device_plane(name: str) -> bool:
    """Accelerator planes are "/device:<KIND>:<n>"; host planes are not."""
    return name.startswith("/device:") and not name.startswith("/device:CPU")


def device_events(root: str):
    """[(plane, line, kernel name, start_ns, duration_ns)] of every event
    on the accelerator planes of the newest trace under `root`."""
    import jax

    prof = jax.profiler.ProfileData.from_file(latest_xplane(root))
    out = []
    for plane in prof.planes:
        if not is_device_plane(plane.name):
            continue
        for line in plane.lines:
            for e in line.events:
                out.append((plane.name, line.name, e.name, e.start_ns,
                            e.duration_ns))
    return out


def busy_ms(events) -> float:
    """Union of the event intervals (ms): the device's busy time."""
    spans = sorted((s, s + d) for _p, _l, _n, s, d in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def kernel_ms(events) -> dict[str, float]:
    """Total device ms per kernel name, largest first."""
    agg = collections.Counter()
    for _p, _l, name, _s, d in events:
        agg[name] += d / 1e6
    return dict(agg.most_common())


def device_ms(fn, *args, reps: int = 1) -> float:
    """Device busy ms of `reps` calls of an already-compiled `fn`."""
    import jax

    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
        events = device_events(d)
    if not events:
        raise RuntimeError("the trace holds no accelerator events")
    return busy_ms(events)
