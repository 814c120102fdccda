"""The serving cell's open loop: its Poisson arrivals, the requests' times
in service, the sweep's knee test, and the per-layer readers of a traced
window, at a tiny size on the CPU."""

import dataclasses
import math
import os

import numpy as np
import pytest

from conftest import HERE, cells, tiny_context

SERVE = [c for c in cells() if c.startswith("serve-")]


def test_arrivals_are_poisson_with_the_count_fixed():
    from vprbench.drivers.serve import arrivals

    a = arrivals(7, 64.0, 51.0)
    assert len(a) == round(64.0 * 51.0)
    assert np.all(np.diff(a) >= 0) and 0.0 <= a[0] and a[-1] < 51.0
    assert np.array_equal(a, arrivals(7, 64.0, 51.0))
    b = arrivals(2**31 + 99, 64.0, 51.0)
    assert len(b) == len(a) and not np.array_equal(a, b)
    # gaps of a Poisson process: exponential, mean 1 / rate, and as many
    # short bursts as chance makes (no smoothing of the order)
    gaps = np.diff(np.concatenate([a, b]))
    gaps = gaps[gaps > 0]
    assert np.mean(gaps) == pytest.approx(1 / 64.0, rel=0.05)
    assert np.std(gaps) == pytest.approx(1 / 64.0, rel=0.1)
    # counts in quarter seconds spread as a Poisson count's do (variance
    # about the mean), where gaps dealt out evenly would spread far less
    counts = np.histogram(a, bins=np.arange(0.0, 51.0 + 1e-9, 0.25))[0]
    assert 0.75 < counts.var() / counts.mean() < 1.3


def test_in_service_leaves_out_the_wait_behind_others():
    from vprbench.drivers.serve import in_service

    sent = [0.0, 0.001, 0.050, 0.051]
    done = [0.010, 0.020, 0.060, math.nan]
    assert in_service(sent, done) == [(0.0, 0.010), (0.010, 0.020),
                                      (0.050, 0.060)]


def test_sweep_knee_test():
    from vprbench.sweep import backlog, sustained

    due = np.arange(0.0, 10.0, 0.1)
    steady = due + 0.05
    growing = due + 0.05 + 0.05 * np.arange(len(due))
    assert backlog(due, steady, 3.0, 6.0) == pytest.approx(0.5, abs=0.01)
    first, last = backlog(due, growing, 0.0, 3.3), backlog(due, growing,
                                                          6.6, 9.9)
    assert last > 1.5 * first + 1.0
    line = {"answered": 1.0, "lag_p95_ms": 1.0, "backlog_first": 0.5,
            "backlog_last": 0.6}
    assert sustained([line], 5.0, 1.5)
    assert not sustained([dict(line, lag_p95_ms=40.0)], 5.0, 1.5)
    assert not sustained([line, dict(line, backlog_last=first + 5)], 5.0,
                         1.5)


@pytest.mark.parametrize("cell", SERVE)
def test_traced_serving_window_is_read_by_every_metric(cell):
    from vprbench import run as bench_run
    from vprbench.trace import Tracer
    from vprbench.work import peaks

    driver, ctx = tiny_context(cell)
    ctx = dataclasses.replace(ctx, trace=True, tracer=Tracer(True))
    outcome = driver.run(ctx)
    service = outcome.info["service"]
    assert len(service) == outcome.attempted - outcome.failed
    assert all(a < b <= c for (a, b), (c, _) in zip(service, service[1:]))
    bench = bench_run.load_json(os.path.join(os.path.dirname(HERE),
                                             "BENCHMARK.json"))
    reading = bench_run.Reading(ctx.config, ctx.traffic, outcome, {},
                                peaks(), bench_run.kernel_map())
    for m in bench_run.metrics_of(bench, cell, "per_layer"):
        value = bench_run.load_file_module(
            bench_run.metric_reader(m["name"]), "m").read(reading)
        assert value is not None and math.isfinite(value), m["name"]
    assert set(ctx.setup_steps) >= {"weights (harness)",
                                    "RetrievalService() (port)"}


def test_a_split_metric_falls_back_to_its_quantity_reader():
    from vprbench import run as bench_run

    assert bench_run.metric_reader("device_idle.build").endswith(
        os.path.join("metrics", "device_idle.py"))
    assert bench_run.metric_reader("mfu.serve").endswith(
        os.path.join("metrics", "mfu.serve.py"))
