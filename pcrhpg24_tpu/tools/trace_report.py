"""Summarize a jax.profiler device trace: per-kernel time table.

The equivalent of the reference's GLTimerQueries ImPlot panel
(src/GLTimerQueries.cpp:43-153, Renderer.cpp:371-459): reads the newest
`.xplane.pb` under a trace directory, keeps the accelerator planes
(utils/devtime.py), and prints total/avg time per kernel, descending —
per-kernel attribution for a captured frame chain.

Usage:
  python -m pcrhpg24_tpu.tools.trace_report /tmp/trace_dir [-n 30]
"""

from __future__ import annotations

import argparse
import re
import sys

from ..utils.devtime import busy_ms, device_events, latest_xplane

_SUFFIX_RE = re.compile(r"\.\d+$")


def canonical(name: str) -> str:
    """fusion.123 -> fusion; keep custom-call/kernel names intact."""
    return _SUFFIX_RE.sub("", name)


def report(root: str, top: int = 30) -> str:
    events = device_events(root)
    agg: dict[str, list] = {}
    total = 0.0
    for _plane, _line, name, _s, d in events:
        ms = d / 1e6
        row = agg.setdefault(canonical(name), [0.0, 0])
        row[0] += ms
        row[1] += 1
        total += ms
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    out = [f"trace: {latest_xplane(root)}",
           f"device kernel time total: {total:.3f} ms, "
           f"busy (union): {busy_ms(events):.3f} ms",
           f"{'ms':>10} {'%':>6} {'count':>7}  kernel"]
    for name, (ms, cnt) in rows:
        out.append(f"{ms:10.3f} {100 * ms / max(total, 1e-9):6.1f} "
                   f"{cnt:7d}  {name[:110]}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace_dir")
    ap.add_argument("-n", "--top", type=int, default=30)
    args = ap.parse_args(argv)
    print(report(args.trace_dir, args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
