"""The traced run: torch.profiler over a stretch of the window, read back
from its Chrome trace.

`Trace` holds the device's kernels, copies and sets (name, start, end in
microseconds), the host's operations, and the stretch's length and unit
count. It gives the union of the device intervals (two streams that overlap
count once), the device time of kernels matched by name patterns, and the
breakdown: the device operations that took most time and the longest idle
gaps by what the host was doing then.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    return name.split("(")[0][:120]


class Trace:
    def __init__(self, events: list, window_s: float, units: int):
        self.window_s, self.units = window_s, units
        self.device = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in DEVICE_CATS]
        self.host = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") in HOST_CATS]
        self.busy = union((a, b) for _, a, b in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def device_seconds(self, patterns) -> float:
        """Summed device time of the kernels whose name matches a pattern."""
        rx = [re.compile(p) for p in patterns]
        return sum(b - a for n, a, b in self.device if any(r.search(n) for r in rx)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The `top` device operations by summed time, and the idle gaps
        between the device's busy intervals summed by the innermost host
        operation running at each gap's middle."""
        ops = {}
        for n, a, b in self.device:
            ops[short_name(n)] = ops.get(short_name(n), 0.0) + (b - a) / 1e6
        gaps, host, active, i = {}, sorted(self.host, key=lambda h: h[1]), [], 0
        for (_, end), (start, _) in zip(self.busy, self.busy[1:]):
            mid = 0.5 * (end + start)  # the gaps come in time order
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= mid]
            label = min(active, key=lambda h: h[2] - h[1])[0] if active else "host idle"
            gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e6
        ranked = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


class Profiled:
    """Context manager over a stretch of the window: syncs the device, runs
    torch.profiler (host and CUDA activity) and, on exit, syncs, reads the
    trace and deletes its file. `units` is set by the caller."""

    def __init__(self, device):
        self.device, self.units, self.trace = device, 0, None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X" and "dur" in e]
        finally:
            os.remove(path)
        self.trace = Trace(events, window_s, self.units)
        return False
