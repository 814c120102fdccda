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
  * ``span(name, stream=None, **ids)``: a stage of the port's own work
    (``serve.*`` in ``serving.RetrievalService``, ``extract.*`` in
    ``parallel.extract.extract_features``, ``train.*`` in
    ``engine.trainer.Trainer.step``). A span records only while a
    ``torch.profiler`` session is active (``trace()``, or any other): then
    it keeps a ``SpanRecord`` in a bounded in-memory buffer, read back by
    ``recorded(t0, t1)``, and enters ``torch.profiler.record_function
    (name)``, so the stage shows in the Chrome trace that session exports.
    Otherwise it reads one flag and returns a shared null context: no
    clock, no record, no allocation.
"""

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque

import torch
from torch.autograd import profiler as _autograd_profiler


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


# records kept: a 51-s traced serving window at 59 requests a second makes
# ~21,000; a record holds its two CUDA events until its stream time is read
SPAN_RECORDS = 1 << 18
_records = deque(maxlen=SPAN_RECORDS)
_index = itertools.count()
_open = threading.local()  # each thread's stack of open spans
_OFF = contextlib.nullcontext()


class SpanRecord:
    """One recorded span. ``name``; ``thread`` (``threading.get_ident``);
    ``t0`` and ``t1``, ``time.perf_counter`` seconds at entry and exit
    (``t1`` None while open); ``index``, its place among the process's
    spans; ``parent``, the index of the innermost span open on the same
    thread at entry (None for a root); ``root``, the index of its root
    (its own for a root); ``ids``, its own and its parents' ids."""

    __slots__ = ("index", "name", "thread", "t0", "t1", "parent", "root",
                 "ids", "_events", "_stream_ms")

    def __init__(self, index, name, parent, ids):
        self.index, self.name = index, name
        self.thread = threading.get_ident()
        self.t0 = self.t1 = None
        self.parent = None if parent is None else parent.index
        self.root = index if parent is None else parent.root
        self.ids = ids if parent is None else (
            {**parent.ids, **ids} if ids else parent.ids)
        self._events = None
        self._stream_ms = None

    @property
    def stream_ms(self):
        """Milliseconds the span's CUDA stream took from the span's entry
        to its exit: the work the span queued there, with any gap in
        which the stream waited on the host. Waits for the exit's event.
        None for a span opened without a CUDA device."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._stream_ms = start.elapsed_time(end)
            self._events = None
        return self._stream_ms


class _Span:
    """The context of a span that records (see ``span``)."""

    __slots__ = ("name", "stream", "ids", "record", "function")

    def __init__(self, name, stream, ids):
        self.name, self.ids = name, ids
        self.stream = None
        if stream is not None:
            device = torch.device(stream)
            if device.type == "cuda":
                self.stream = torch.cuda.current_stream(device)

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        rec = SpanRecord(next(_index), self.name,
                         stack[-1] if stack else None, self.ids)
        rec.t0 = time.perf_counter()
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        if self.stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            rec._events = (start, None)
        stack.append(rec)
        _records.append(rec)
        self.record = rec
        return rec

    def __exit__(self, *exc):
        rec = self.record
        if rec._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            rec._events = (rec._events[0], end)
        _open.stack.pop()
        self.function.__exit__(*exc)
        rec.t1 = time.perf_counter()
        return False


def span(name, stream=None, **ids):
    """``with span("serve.forward", stream=device): ...``: one stage of the
    port's work, recorded while a ``torch.profiler`` session is active.

    ``ids`` (e.g. ``request=7``, ``batch=3``) tag the record; spans opened
    inside it on the same thread inherit them. ``stream``: the device the
    stage works on; on a CUDA device the span also records a timing event
    on that device's current stream at entry and at exit, which give the
    record's ``stream_ms``. With no profiler active this reads one flag and
    returns a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, stream, ids)


def recorded(t0=None, t1=None):
    """The finished ``SpanRecord``s whose span started inside [t0, t1]
    (``time.perf_counter`` seconds; None leaves that side open), in the
    order they started. The buffer keeps the last ``SPAN_RECORDS``."""
    lo = -float("inf") if t0 is None else t0
    hi = float("inf") if t1 is None else t1
    return [r for r in list(_records)
            if r.t1 is not None and lo <= r.t0 <= hi]
