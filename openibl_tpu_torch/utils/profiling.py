"""Phase timing (port of openibl_tpu/utils/profiling.py's PhaseTimer).

``PhaseTimer`` accumulates wall clock per named phase (mining / train /
eval). On a CUDA device a phase ends with ``torch.cuda.synchronize`` so its
time holds the device work it queued, and the timer keeps each phase's peak
allocated device memory (``torch.cuda.max_memory_allocated``) in place of
the JAX package's device memory stats. The torch.profiler trace hook comes
with the tooling item (ROADMAP Queue 1 item 15).
"""

import contextlib
import time
from collections import defaultdict

import torch


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

