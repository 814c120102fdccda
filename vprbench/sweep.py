"""The serving knee on the card: one service, set up once, under the
open loop at each of several offered rates, ``--seconds`` a rate, once
for each seed of ``--seeds`` (each seed draws its own Poisson arrivals).
For each rate and seed: the answered share, p50 and p95 of the latency
from the due time, the generator's p95 lag (send time minus due time: a
request waits for a free client thread once ``clients`` are out), and the
backlog: the mean number of requests in the system (due and not yet
answered) over the window's first and last thirds.

A rate is sustained where, on every seed, the generator keeps to its
schedule (``lag_p95_ms`` at most ``--lag-ms``) and the backlog does not
grow (its last third's mean at most ``--growth`` times its first third's,
plus one request). The knee is the highest rate sustained, below the
lowest that is not; a serving mix's rate is set once, at about four
fifths of it, and written into its file.

  python3 -m vprbench.sweep --workload <serve cell> --rates 70,75,80
      [--seconds 30] [--seeds 1,2] [--lag-ms 5] [--growth 1.5]
"""

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np


def backlog(due, done, t_lo, t_hi, points=2000):
    """The mean number of requests in the system (due, not yet answered)
    over [t_lo, t_hi], sampled at ``points`` even times."""
    ts = np.linspace(t_lo, t_hi, points)
    due = np.sort(np.asarray(due))
    done = np.sort(np.where(np.isnan(done), np.inf, done))
    return float(np.mean(np.searchsorted(due, ts, side="right")
                         - np.searchsorted(done, ts, side="right")))


def reading(rate, seed, due, sent, done, lat):
    """One line of the sweep: what the window at ``rate`` showed."""
    from vprbench.drivers import serve

    n = len(lat)
    lag = sorted(s - d for s, d in zip(sent, due) if math.isfinite(s))
    t_lo, t_hi = due[0], due[-1]
    third = (t_hi - t_lo) / 3
    first = backlog(due, done, t_lo, t_lo + third)
    last = backlog(due, done, t_hi - third, t_hi)
    return {"rate": rate, "seed": seed, "requests": n,
            "answered": sum(math.isfinite(x) for x in lat) / n,
            "p50_ms": 1e3 * serve.nearest_rank(lat, 0.5),
            "p95_ms": 1e3 * serve.nearest_rank(lat, 0.95),
            "lag_p95_ms": 1e3 * lag[max(0, math.ceil(0.95 * len(lag)) - 1)],
            "backlog_first": first, "backlog_last": last}


def sustained(lines, lag_ms, growth):
    """Whether every reading of one rate kept to the schedule and showed
    no growing backlog."""
    return all(x["answered"] == 1.0 and x["lag_p95_ms"] <= lag_ms
               and x["backlog_last"] <= growth * x["backlog_first"] + 1.0
               for x in lines)


def main(argv=None):
    from vprbench import run as bench_run
    from vprbench.common import Context
    from vprbench.drivers import serve
    from vprbench.trace import Tracer

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seeds", default="1,2")
    p.add_argument("--lag-ms", type=float, default=5.0)
    p.add_argument("--growth", type=float, default=1.5)
    args = p.parse_args(argv)

    import torch

    bench = bench_run.load_json(
        os.path.join(bench_run.ROOT, "BENCHMARK.json"))
    _, config, traffic, _ = bench_run.cell_spec(bench, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctx = Context(config=config, traffic=traffic,
                  seed=seeds[0], seconds=args.seconds, trace=False,
                  device=torch.device("cuda", 0),
                  t_start=time.perf_counter(), tracer=Tracer(False))
    service, pool, frames, _ = serve.setup(ctx)
    knee = None
    for rate in [float(r) for r in args.rates.split(",")]:
        lines = []
        for seed in seeds:
            due, _, sent, done, _, lat = serve.window(
                dataclasses.replace(ctx, seed=seed), service, pool, frames,
                rate, Tracer(False))
            lines.append(reading(rate, seed, due, sent, done, lat))
            print(json.dumps(lines[-1]), flush=True)
        ok = sustained(lines, args.lag_ms, args.growth)
        print(json.dumps({"rate": rate, "sustained": ok}), flush=True)
        if not ok:
            break
        knee = rate
    print(json.dumps({"knee": knee, "rate_at_four_fifths":
                      None if knee is None else 0.8 * knee}), flush=True)
    pool.shutdown()
    service.close()


if __name__ == "__main__":
    main()
