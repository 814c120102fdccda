"""The readers of the port's spans (``vprbench/spans.py`` and the
``metrics/`` files that use it) on synthetic records: the traced window's
filter, grouping by root, the nearest-rank p95, the host stages' sum, the
stage prefix taken from the cell's driver, the gaps named by the spans
open in them, and a port without spans read as nothing. Each new
per-layer entry of BENCHMARK.json has a reader and lists only cells that
report the metric it moves."""

import collections
import os
import types

import pytest

from conftest import HERE, ROOT, load_json

SPAN_METRICS = {
    "lock_wait_p95_ms.serve", "host_stages_ms.serve",
    "forward_device_ms.serve", "search_device_ms.serve",
    "forward_device_ms.build", "h2d_device_ms.build",
    "forward_device_ms.train", "backward_device_ms.train",
    "h2d_device_ms.train"}


def rec(index, name, t0, t1, parent=None, root=None, thread=1,
        stream_ms=None, **ids):
    return types.SimpleNamespace(
        index=index, name=name, t0=t0, t1=t1, parent=parent,
        root=index if root is None else root, thread=thread, ids=ids,
        stream_ms=stream_ms)


def request(first, t0, lock_ms, thread=1, request_id=0):
    """One served request's seven spans from ``t0`` (s): host stages of 1,
    2 and 3 ms, a lock wait of ``lock_ms``, device stages of 4 and 0.5 ms
    stream time."""
    r = {"request": request_id}
    t = t0
    out = [rec(first, "serve.query", t0, t0 + 1.0, thread=thread, **r)]
    for k, (name, host, dev) in enumerate([
            ("serve.preprocess", 1.0, None),
            ("serve.lock_wait", lock_ms, None),
            ("serve.h2d", 2.0, 0.25),
            ("serve.forward", 0.1, 4.0),
            ("serve.search", 0.1, 0.5),
            ("serve.results", 3.0, None)]):
        out.append(rec(first + 1 + k, name, t, t + host * 1e-3, first,
                       first, thread, dev, **r))
        t += host * 1e-3
    return out


def reading(driver, window):
    """What a reader gets of a traced run of a cell of ``driver``."""
    return types.SimpleNamespace(trace=types.SimpleNamespace(window=window),
                                 traffic={"driver": driver})


@pytest.fixture
def port(monkeypatch):
    """The port's span buffer, holding what the test puts in it."""
    from openibl_tpu_torch.utils import profiling

    buf = collections.deque()
    monkeypatch.setattr(profiling, "_records", buf)
    return buf


def reader(name):
    from vprbench import run as bench_run

    return bench_run.load_file_module(bench_run.metric_reader(name),
                                      "vprbench_metric_" + name)


def test_window_filter_and_grouping_by_root(port):
    from vprbench import spans

    port.extend(request(0, 0.5, 1.0, request_id=0)
                + request(10, 1.5, 2.0, request_id=1)
                + request(20, 2.5, 3.0, request_id=2))
    run = reading("serve", (1.0, 2.0))
    recs = spans.records(run)
    # only the request that started inside the window
    assert [r.ids["request"] for r in recs] == [1] * 7
    groups = spans.by_root(recs)
    assert list(groups) == [10] and len(groups[10]) == 7
    # a span whose root started before the window is no request's
    assert spans.by_root(recs[1:]) == {}
    assert spans.records(reading("serve", (0.0, 9.0))) == list(port)
    assert spans.records(types.SimpleNamespace(trace=None)) == []


@pytest.mark.parametrize("n", [1, 19, 20, 21, 100])
def test_lock_wait_p95_is_the_nearest_rank(n, port):
    for i in range(n):
        port.extend(request(10 * i, 1.0 + i, float(i + 1), request_id=i))
    got = reader("lock_wait_p95_ms.serve").read(
        reading("serve", (0.0, 1e3)))
    # nearest rank: the ceil(0.95 n)-th smallest wait
    assert got == pytest.approx(-(-95 * n // 100))


def test_host_stages_sum_preprocess_h2d_and_results(port):
    port.extend(request(0, 1.0, 5.0) + request(10, 2.0, 9.0, request_id=1)
                + request(20, 3.0, 1.0, request_id=2))
    port[-1].t1 = port[-1].t0 + 0.009  # the last request's results: 9 ms
    got = reader("host_stages_ms.serve").read(reading("serve", (0, 10)))
    # 1 + 2 + 3 ms for two requests, 1 + 2 + 9 for the third: the median
    assert got == pytest.approx(6.0)


@pytest.mark.parametrize("driver, metric, want", [
    ("serve", "forward_device_ms.serve", 4.0),
    ("serve", "search_device_ms.serve", 0.5),
    ("extract", "forward_device_ms.build", 20.0),
    ("extract", "h2d_device_ms.build", 2.5),
    ("train", "forward_device_ms.train", 700.0),
    ("train", "backward_device_ms.train", 90.0),
    ("train", "h2d_device_ms.train", 22.0),
])
def test_device_stages_read_the_cells_driver_prefix(driver, metric, want,
                                                    port):
    ms = {"forward": {"extract": 20.0, "train": 700.0},
          "h2d": {"extract": 2.5, "train": 22.0},
          "backward": {"train": 90.0}}
    i = 0
    for step in range(3):
        root = i
        port.append(rec(i, f"{driver}.root", 1.0 + step, 1.9 + step))
        i += 1
        for stage, by in ms.items():
            if driver in by:
                port.append(rec(i, f"{driver}.{stage}", 1.0 + step,
                                1.1 + step, root, root,
                                stream_ms=by[driver] + step - 1))
                i += 1
    if driver == "serve":
        port.extend(request(100, 1.0, 1.0) + request(110, 2.0, 1.0))
    # a stage of another driver's name is not this cell's
    other = "train" if driver != "train" else "serve"
    port.append(rec(999, f"{other}.forward", 1.0, 1.1, stream_ms=1e6))
    assert reader(metric).read(reading(driver, (0, 10))) == \
        pytest.approx(want)


def test_cpu_spans_stand_in_with_their_duration(port):
    from vprbench import spans

    port.append(rec(0, "serve.forward", 1.0, 1.003))
    assert spans.device_median(reading("serve", (0, 2)), "forward") == \
        pytest.approx(3.0)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_a_port_without_spans_reads_nothing(metric, port, monkeypatch):
    from openibl_tpu_torch.utils import profiling

    port.extend(request(0, 1.0, 1.0))
    monkeypatch.delattr(profiling, "recorded")
    driver = {"serve": "serve", "build": "extract",
              "train": "train"}[metric.split(".")[1]]
    assert reader(metric).read(reading(driver, (0, 10))) is None
    # and untraced, none either
    run = types.SimpleNamespace(trace=None, traffic={"driver": driver})
    assert reader(metric).read(run) is None


def test_gaps_are_named_by_the_innermost_spans_open(port):
    from vprbench import spans

    recs = request(0, 1.0, 200.0, thread=1) \
        + request(10, 1.0, 100.0, thread=2, request_id=1)
    # a third thread between stages: only its root is open
    recs.append(rec(20, "serve.query", 1.0, 1.5, thread=3, request=2))
    trace = types.SimpleNamespace(
        window=(1.0, 3.0), busy=[(0.5, 1.05), (1.3, 1.35), (1.9, 2.5)])
    gaps = spans.name_gaps(trace, recs)
    assert [(g[0], round(g[1], 6), round(g[2], 6)) for g in gaps] == [
        ("serve.query x2", 0.55, 1.625),
        ("no port span", 0.5, 2.75),
        # thread 1 in its lock wait, threads 2 and 3 between stages
        ("serve.lock_wait, serve.query x2", 0.25, 1.175)]
    assert spans.gap_name(recs, 1.0005) == "serve.preprocess x2, " \
        "serve.query"


def test_each_span_metric_has_a_reader_and_reports_its_moves():
    from vprbench import run as bench_run

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert SPAN_METRICS <= set(entries)
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        path = bench_run.metric_reader(name)
        assert os.path.exists(path) and path.startswith(
            os.path.join(HERE, "metrics"))
        moves = next(e for e in bench["end_to_end"]
                     if e["name"] == m["moves"])
        assert m["workloads"] and set(m["workloads"]) <= set(
            moves["workloads"]), name
        for cell in m["workloads"]:
            assert name in [x["name"] for x in bench_run.metrics_of(
                bench, cell, "per_layer")]
