"""The port's own spans in a traced run (``openibl_tpu_torch.utils.
profiling.span``): the records that started inside the traced window,
grouped by their root (a request, an ``extract_features`` call, a train
step), and what the per-layer readers take from them. A span's name is
``<driver>.<stage>``, the driver being the cell's (``serve``,
``extract``, ``train``), so one reader serves every cell kind.

A port without spans records none: every reading is then None, and the
metric is left out of the result.

Times are ``time.perf_counter`` seconds, the clock of the harness's
window and of its device trace, so an idle gap of the device can be put
down to the spans open at that moment (``name_gaps``).
"""

import collections
import math
import statistics


def records(run):
    """The port's span records that started inside the traced window,
    in the order they started; [] untraced or where the port has none."""
    if run.trace is None:
        return []
    try:
        from openibl_tpu_torch.utils import profiling
    except ImportError:
        return []
    recorded = getattr(profiling, "recorded", None)
    return [] if recorded is None else recorded(*run.trace.window)


def stage(run, name):
    """The full name of the cell's stage ``name``: ``serve.lock_wait``."""
    return f"{run.traffic['driver']}.{name}"


def by_root(recs):
    """{root's index: [the root's record, then its spans']} of the roots
    among ``recs``; spans whose root is not among them are left out."""
    groups = {r.index: [] for r in recs if r.parent is None}
    for r in recs:
        if r.root in groups:
            groups[r.root].append(r)
    return groups


def duration_ms(rec):
    return 1e3 * (rec.t1 - rec.t0)


def device_ms(rec):
    """The span's stream time. Work on the CPU (the benchmark's own tests)
    runs as it is issued and has no stream: there the span's duration
    stands for it."""
    ms = rec.stream_ms
    return duration_ms(rec) if ms is None else ms


def nearest_rank(values, q):
    """The q-quantile of ``values`` by nearest rank; None for none."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)] if v else None


def median(values):
    values = list(values)
    return statistics.median(values) if values else None


def device_median(run, name):
    """The median device time, in ms, of the cell's stage ``name``."""
    full = stage(run, name)
    return median(device_ms(r) for r in records(run) if r.name == full)


def per_root_sum(recs, names):
    """Per root that holds one of ``names``, the summed durations (ms) of
    its spans of those names."""
    out = []
    for group in by_root(recs).values():
        hits = [duration_ms(r) for r in group if r.name in names]
        if hits:
            out.append(sum(hits))
    return out


def open_at(recs, t):
    """Per thread, the innermost span open at ``t``: the latest started
    of those that hold it."""
    inner = {}
    for r in recs:
        if r.t0 <= t <= r.t1 and (r.thread not in inner
                                  or r.t0 >= inner[r.thread].t0):
            inner[r.thread] = r
    return list(inner.values())


def gap_name(recs, t):
    """The innermost span open at ``t`` on each thread, counted by name:
    "serve.lock_wait x3, serve.results"; "no port span" for none."""
    names = collections.Counter(r.name for r in open_at(recs, t))
    if not names:
        return "no port span"
    return ", ".join(n if c == 1 else f"{n} x{c}"
                     for n, c in sorted(names.items()))


def name_gaps(trace, recs, n=10):
    """The ``n`` longest gaps with no device work inside the traced
    window (found as ``Trace.idle_gaps`` finds them), longest first, as
    [name (``gap_name`` at the gap's middle), seconds, middle]."""
    t_lo, t_hi = trace.window
    gaps, prev = [], t_lo
    for a, b in trace.busy:
        if a > prev:
            gaps.append((prev, min(a, t_hi)))
        prev = max(prev, b)
    if prev < t_hi:
        gaps.append((prev, t_hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:n]
    return [[gap_name(recs, 0.5 * (a + b)), b - a, 0.5 * (a + b)]
            for a, b in gaps]
