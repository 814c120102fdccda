"""Tracing and phase timing (port of openibl_tpu/utils/profiling.py).

  * ``trace(logdir)``: a ``torch.profiler`` trace of the host and, where
    there is one, the CUDA device around a block, written under ``logdir``
    as a Chrome trace (open it in Perfetto or chrome://tracing).
  * ``PhaseTimer`` accumulates wall clock per named phase (mining / train /
    eval). On a CUDA device a phase ends with ``torch.cuda.synchronize`` so
    its time holds the device work it queued, and the timer keeps each
    phase's peak allocated device memory
    (``torch.cuda.max_memory_allocated``).
  * ``device_memory_stats()``: device memory in use, its peak and the
    card's size per CUDA device, under the JAX package's keys.
"""

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(logdir):
    """Host (and CUDA, when a card is present) trace around a block, saved
    as ``logdir/trace_<pid>_<time>.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class PhaseTimer:
    """with timer.phase("mining"): ...; print(timer.summary())"""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.peak_bytes = defaultdict(int)

    def _on_card(self):
        return self.device is not None and self.device.type == "cuda"

    @contextlib.contextmanager
    def phase(self, name):
        if self._on_card():
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._on_card():
                torch.cuda.synchronize(self.device)
                self.peak_bytes[name] = max(
                    self.peak_bytes[name],
                    torch.cuda.max_memory_allocated(self.device))
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        lines = ["phase timings:"]
        total = sum(self.totals.values()) or 1.0
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            peak = (f"  peak {self.peak_bytes[name] / 2**30:.2f} GiB"
                    if name in self.peak_bytes else "")
            lines.append(
                f"  {name:<16} {t:8.2f}s  ({t / total:5.1%})  "
                f"x{self.counts[name]}{peak}")
        return "\n".join(lines)



def device_memory_stats():
    """Per CUDA device: ``bytes_in_use`` and ``peak_bytes_in_use``
    (PyTorch's caching allocator, ``torch.cuda.memory_stats``) and
    ``bytes_limit`` (the card's memory, ``torch.cuda.mem_get_info``). Without
    a card one ``"cpu"`` entry whose value is None, as the JAX package gives
    a device without stats."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return stats
