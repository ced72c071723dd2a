#!/usr/bin/env python
"""Summarize a jax.profiler trace: device time per line, per annotated
operation, per kernel class and per kernel.

Usage:  python benchmarks/trace_summary.py TRACE_DIR [--top 30]

Reads the newest ``*.xplane.pb`` under TRACE_DIR with
jax.profiler.ProfileData.  The window is the span of the host's
TraceAnnotation events (chip_smoke.py --trace writes "encrypt" and
"decrypt" ones), or of all device events when there are none.  For every
device plane and line it prints the event count, the summed event time,
the busy time (union of event intervals) and the idle share of the
window, then the ``--top`` event names by summed time on the busiest
line.

Then, for each host annotation name (one row per name, averaged over its
occurrences), the events of the busiest line that start inside the
annotation: the device span (first start to last end), the busy time,
the gaps (span - busy), the kernel count, and the summed time per kernel
class: "gemm" (XLA's GEMM fusions and library calls: names holding gemm,
cublas, matmul or dot), "memcpy", and "other" (the elementwise and
reduction fusions), followed by the ``--top`` kernels of that operation.
Every number is a device time from the trace.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re

GEMM = re.compile(r"gemm|cublas|matmul|dot", re.IGNORECASE)


def kernel_class(name):
    if name.startswith("Memcpy"):
        return "memcpy"
    return "gemm" if GEMM.search(name) else "other"


def busy_ns(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def top_kernels(evs, top, per=1):
    agg = collections.defaultdict(lambda: [0, 0.0])
    for name, s, e in evs:
        agg[name][0] += 1
        agg[name][1] += e - s
    total = sum(v[1] for v in agg.values())
    print(f"  {len(agg)} kernel names; top {top} (time and count per call):")
    for name, (cnt, dur) in sorted(agg.items(), key=lambda kv: -kv[1][1])[
        :top
    ]:
        print(f"  {dur / per / 1e6:10.3f} ms {100 * dur / total:6.2f}% "
              f"{cnt / per:9.1f}x  {name[:110]}")


def per_operation(spans, evs, top):
    """Device events of the busiest line split by host annotation."""
    for op, occ in sorted(spans.items()):
        k = len(occ)
        span = busy = 0.0
        cls = collections.Counter()
        cnt = collections.Counter()
        mine = []
        for lo, hi in occ:
            sel = [(n, s, e) for n, s, e in evs if lo <= s < hi]
            if not sel:
                continue
            mine += sel
            span += max(e for _, _, e in sel) - min(s for _, s, _ in sel)
            busy += busy_ns([(s, e) for _, s, e in sel])
            for n, s, e in sel:
                c = kernel_class(n)
                cls[c] += e - s
                cnt[c] += 1
        if not mine:
            print(f"op {op}: no device events")
            continue
        tot = sum(cls.values())
        split = ", ".join(
            f"{c} {cls[c] / k / 1e6:.3f} ms ({100 * cls[c] / tot:.1f}%, "
            f"{cnt[c] / k:.1f} kernels)"
            for c in ("gemm", "other", "memcpy")
        )
        print(f"op {op}: {k} x; per call: device span {span / k / 1e6:.3f} ms, "
              f"busy {busy / k / 1e6:.3f} ms, gaps {(span - busy) / k / 1e6:.3f}"
              f" ms ({100 * (span - busy) / span:.2f}%), "
              f"{len(mine) / k:.1f} kernels")
        print(f"  by class (summed kernel time): {split}")
        top_kernels(mine, top, per=k)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    from jax.profiler import ProfileData

    paths = glob.glob(
        os.path.join(args.trace_dir, "**", "*.xplane.pb"), recursive=True
    )
    path = max(paths, key=os.path.getmtime)
    pd = ProfileData.from_file(path)
    spans = {}
    devices = []
    for plane in pd.planes:
        for line in plane.lines:
            evs = [(e.name, e.start_ns, e.start_ns + e.duration_ns)
                   for e in line.events]
            if plane.name.startswith("/device:"):
                devices.append((plane.name, line.name, evs))
            elif line.name == "python":
                for name, s, e in evs:
                    if name in ("encrypt", "decrypt"):
                        spans.setdefault(name, []).append((s, e))
    if spans:
        lo = min(s for v in spans.values() for s, _ in v)
        hi = max(e for v in spans.values() for _, e in v)
        for name, v in spans.items():
            print(f"host span {name}: {len(v)} x, "
                  f"{sum(e - s for s, e in v) / 1e6:.3f} ms")
    else:
        lo = min(s for _, _, evs in devices for _, s, _ in evs)
        hi = max(e for _, _, evs in devices for _, _, e in evs)
    window = hi - lo
    print(f"window: {window / 1e6:.3f} ms ({path})")
    busiest = None
    for plane, line, evs in devices:
        evs = [(n, s, e) for n, s, e in evs if s >= lo and e <= hi]
        if not evs:
            continue
        busy = busy_ns([(s, e) for _, s, e in evs])
        total = sum(e - s for _, s, e in evs)
        print(f"{plane} | {line}: {len(evs)} events, sum {total / 1e6:.3f} ms, "
              f"busy {busy / 1e6:.3f} ms, idle share {1 - busy / window:.4f}")
        if busiest is None or busy > busiest[0]:
            busiest = (busy, plane, line, evs)
    if busiest is None:
        print("no device events in the window")
        return 1
    _, plane, line, evs = busiest
    print(f"kernels on {plane} | {line}, whole window:")
    top_kernels(evs, args.top)
    if spans:
        per_operation(spans, evs, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
