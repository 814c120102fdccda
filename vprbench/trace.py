"""The traced run's reading of the device: ``torch.profiler`` (CPU and
CUDA) around the measured window, exported as a Chrome trace into a
temporary directory, read back, and deleted. Device events (kernels,
copies, sets) come back as intervals on the harness's clock
(``time.perf_counter`` seconds), placed by a mark that the harness sets at
a known time when the window opens.
"""

import bisect
import json
import os
import re
import shutil
import tempfile
import time

import torch

MARK = "vprbench.mark"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals):
    """Sorted, merged list of (t0, t1)."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def covered(merged, t0, t1):
    """Seconds of the merged (sorted, disjoint) intervals inside [t0, t1]."""
    i = bisect.bisect_right(merged, (t0, float("inf"))) - 1
    total = 0.0
    for a, b in merged[max(i, 0):]:
        if a >= t1:
            break
        total += max(0.0, min(b, t1) - max(a, t0))
    return total


class Trace:
    """Device and host events of one traced window, harness clock."""

    def __init__(self, events, offset, window):
        self.window = window
        self.device = []  # (t0, t1, name)
        self.host = []  # (t0, t1, name) CPU ops and runtime calls
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0 = e["ts"] * 1e-6 + offset
            item = (t0, t0 + e["dur"] * 1e-6, e.get("name", ""))
            if e.get("cat") in DEVICE_CATS:
                self.device.append(item)
            elif e.get("cat") in ("cpu_op", "cuda_runtime"):
                self.host.append(item)
        self.device.sort()
        self.host.sort()
        self.busy = union((a, b) for a, b, _ in self.device)

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    @property
    def busy_s(self):
        return covered(self.busy, *self.window)

    def idle_share(self):
        """The share of the window with no device work, in % (None for a
        window of no length)."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, names):
        """Device seconds of the kernels whose name holds one of ``names``
        as a word, and how many such launches."""
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        hits = [b - a for a, b, n in self.device if pat.search(n)]
        return sum(hits), len(hits)

    def top_ops(self, n=10):
        by = {}
        for a, b, name in self.device:
            by[name] = by.get(name, 0.0) + (b - a)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, spans, n=10):
        """The ``n`` longest gaps with no device work inside the window,
        each named by the harness span and the innermost host operation
        open at its middle."""
        t_lo, t_hi = self.window
        gaps, prev = [], t_lo
        for a, b in self.busy:
            if a > prev:
                gaps.append((prev, min(a, t_hi)))
            prev = max(prev, b)
        if prev < t_hi:
            gaps.append((prev, t_hi))
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            span = next((s for s, s0, s1 in spans if s0 <= mid <= s1),
                        "outside the harness's spans")
            ops = [h for h in self.host[:bisect.bisect_right(
                self.host, (mid, float("inf")))] if h[1] >= mid]
            op = max(ops)[2] if ops else "no host operation"
            out.append([f"{span}: {op}", b - a])
        return out


class Tracer:
    """``with Tracer(on, counters) as tr: ...``; ``tr.trace`` is a Trace
    (or None when off). ``tr.open()`` marks the window's start.
    ``counters``: {name: a function that reads a count}; ``tr.counts``
    holds each one's growth over the window."""

    def __init__(self, on, counters=None):
        self.on = on
        self.counters = counters or {}
        self.counts = {}
        self.trace = None
        self._prof = None
        self._mark = None
        self._t0 = None
        self._before = {}

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def open(self):
        """Set the mark: the window opens now."""
        self._before = {k: read() for k, read in self.counters.items()}
        self._t0 = time.perf_counter()
        if self.on:
            with torch.profiler.record_function(MARK):
                self._mark = time.perf_counter()
        return self._t0

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.counts = {k: read() - self._before.get(k, 0)
                       for k, read in self.counters.items()}
        if not self.on:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        tmp = tempfile.mkdtemp(prefix="vprbench-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        marks = [e for e in events if e.get("name") == MARK]
        if not marks:
            raise RuntimeError("the profiler's trace lost the window's mark")
        offset = self._mark - marks[0]["ts"] * 1e-6
        self.trace = Trace(events, offset, (self._t0, t1))
        return False
