"""Reading a torch.profiler trace of a stretch of jobs.

The trace's device activities (kernels, copies, sets) give the seconds in
which the card was busy (the union of their intervals), the device time by
operation name, and the idle gaps between them; each gap is labelled by the
innermost host range that was open at its middle: the benchmark's
"frontend" range or the program's "prove.<phase>" and "zerocheck.stage<i>"
ranges (`torch.profiler.record_function`).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_RANGE_PREFIXES = ("frontend", "prove.", "zerocheck.stage")


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    span_s: float                 # first device activity's start to the last's end
    device_s_by_name: dict        # operation name -> device seconds
    idle_s_by_range: dict         # host range -> idle seconds
    n_device_ops: int


def _union_length(intervals: list) -> tuple[float, list]:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def summarize(prof) -> TraceSummary:
    """Summary of a finished `torch.profiler.profile`."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    device, ranges = [], []
    by_name: dict = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + dur * 1e-6
        elif cat == "user_annotation" and ev["name"].startswith(HOST_RANGE_PREFIXES):
            ranges.append((ts, ts + dur, ev["name"]))
    if not device:
        return TraceSummary(0.0, 0.0, {}, {}, 0)
    busy_us, merged = _union_length(device)
    ranges.sort()
    starts = [r[0] for r in ranges]
    idle: dict = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        label = "other"
        best = None
        for r in ranges[:bisect.bisect_right(starts, mid)]:
            if r[0] <= mid <= r[1] and (best is None or r[1] - r[0] < best[1] - best[0]):
                best = r
        if best is not None:
            label = best[2]
        idle[label] = idle.get(label, 0.0) + (s1 - e0) * 1e-6
    return TraceSummary(busy_us * 1e-6, (merged[-1][1] - merged[0][0]) * 1e-6, by_name, idle,
                        len(device))
