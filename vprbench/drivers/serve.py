"""Open-loop serving: ``RetrievalService.query(images=[frame], topk)`` on
a resident exact f32 index, at a fixed offered rate.

Set-up: the weights, the index rows and a pool of frames from the seed;
the service built on the rows and given the weights; one query at batch
1 from each client thread. The window: the arrivals of a Poisson process
at ``rate_per_s`` over ``--seconds``, drawn from the seed (see
``arrivals``), each handed at its due time to one of ``clients`` threads
that calls ``query``; a request is timed from its due time to the return
of ``query``. The check: a sample of the finished requests, drawn from the
seed and holding the slowest, whose top-k ids and squared distances are
judged against the plain reference (f64 descriptor, f64 scan of the same
rows).
"""

import concurrent.futures
import math
import threading
import time

import numpy as np
import torch

from vprbench import inputs
from vprbench.common import (Outcome, free, load_into, now, peak_bytes,
                             reset_peak, sync)
from vprbench.reference import model as ref_model
from vprbench.reference import search


def arrivals(seed, rate, seconds):
    """Due times (s from the window's start) of the arrivals of a Poisson
    process at ``rate`` over ``seconds``, given that it has n =
    round(rate * seconds) of them in the window: n independent uniform
    times, sorted. The seed draws where the bursts fall; every seed offers
    the same number of requests, so the offered load is the cell's."""
    n = max(1, round(rate * seconds))
    rng = inputs.host_rng(seed, "arrivals")
    return np.sort(rng.uniform(0.0, seconds, n))


def in_service(sent, done):
    """The answered requests' times in service, as [(start, end)]: the
    service runs one request at a time (its lock), so a request is in
    service from when it was sent, or from when the request answered
    before it was done if that is later, to its answer. The intervals
    do not overlap and cover every moment at which some request was in
    the service; the wait behind other requests is left out."""
    order = sorted((d, s) for s, d in zip(sent, done) if not math.isnan(d))
    out, prev = [], -math.inf
    for d, s in order:
        out.append((max(s, prev), d))
        prev = d
    return out


def nearest_rank(values, q):
    """The q-quantile of ``values`` by nearest rank (no interpolation)."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def warm_clients(pool, clients, service, frames, topk):
    """One query from each of the pool's ``clients`` threads at once: a
    thread's first call into the card makes its cuBLAS and cuDNN handles,
    which belongs to set-up, not to the window."""
    barrier = threading.Barrier(clients)

    def one(i):
        barrier.wait(timeout=600)
        service.query([frames[i % len(frames)]], topk=topk)

    for f in [pool.submit(one, i) for i in range(clients)]:
        f.result()


def open_loop(service, frames, order, due, topk, pool, drain_s, tracer):
    """Send request i at ``due[i]`` to a thread of ``pool``; returns (t0,
    sent, done, results)."""
    n = len(due)
    sent, done = np.full(n, np.nan), np.full(n, np.nan)
    results = [None] * n

    def one(i):
        sent[i] = now()
        try:
            results[i] = service.query([frames[order[i]]], topk=topk)[0]
        except Exception as exc:  # a failed request counts as failed
            results[i] = exc
        done[i] = now()

    t0 = tracer.open() + 0.005
    futures = []
    for i in range(n):
        delay = t0 + due[i] - now()
        if delay > 0:
            time.sleep(delay)
        futures.append(pool.submit(one, i))
    concurrent.futures.wait(futures, timeout=drain_s + due[-1])
    return t0, sent, done, results


def dist_gap(ids, dists, d_ref, k):
    """The widest gap, over the requests and ranks, between a returned
    squared distance and the reference's distance of the returned id, or
    between that and the reference's own distance at that rank. ``ids`` and
    ``dists``: (R, k) of the port (or the control); ``d_ref``: (R, N) f64."""
    if any(len(row) != k for row in ids):
        return math.inf
    ids = torch.as_tensor(np.asarray(ids), device=d_ref.device)
    at_ids = d_ref.gather(1, ids)
    best = torch.topk(d_ref, k, dim=1, largest=False, sorted=True).values
    got = torch.as_tensor(np.asarray(dists), dtype=d_ref.dtype,
                          device=d_ref.device)
    return float(torch.maximum((got - at_ids).abs(),
                               (at_ids - best).abs()).max())


def reference_dists(ctx, saved, prec):
    """(R, N) squared distances of the saved requests' frames to every row,
    in ``prec``, on the run's device."""
    cfg = ctx.config
    w = {k: v.to(ctx.device) for k, v in saved["weights"].items()}
    q = ref_model.descriptors(saved["frames"], w, prec)
    rows = inputs.gallery(ctx.seed, cfg["index_rows"], cfg["index_dim"],
                          ctx.device)
    return search.sq_dists(q, rows, prec)


def check(ctx, saved):
    d_ref = reference_dists(ctx, saved, "f64")
    return {"dist_gap": dist_gap(saved["ids"], saved["dists"], d_ref,
                                 ctx.traffic["topk"])}


def control(ctx, saved):
    """The control in the port's place: the reference in TF32."""
    k = ctx.traffic["topk"]
    d_c = reference_dists(ctx, saved, "tf32")
    dc, ic = search.topk(d_c, k)
    d_ref = reference_dists(ctx, saved, "f64")
    return {"dist_gap": dist_gap(ic.cpu().numpy(), dc.cpu().numpy(), d_ref,
                                 k)}


def faults(ctx, saved):
    """The numbers of a fault planted where the answer is produced: each
    sampled request's nearest id replaced by the next row's."""
    n = ctx.config["index_rows"]
    ids = [[(row[0] + 1) % n] + row[1:] for row in saved["ids"]]
    d_ref = reference_dists(ctx, saved, "f64")
    return {"answer_altered": {"dist_gap": dist_gap(
        ids, saved["dists"], d_ref, ctx.traffic["topk"])}}


def setup(ctx):
    """The weights, the index rows and the frames from the seed; the
    service built and given the weights, warmed at batch 1. Returns the
    service, the frames and the weights' host copy."""
    from openibl_tpu_torch.serving import RetrievalService

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    h, w = cfg["height"], cfg["width"]
    ctx.mark("the driver's imports")
    weights = inputs.make_weights(ctx.seed, cfg, dev)
    weights_host = {n: v.cpu() for n, v in weights.items()}
    ctx.mark("weights (harness)")
    rows = inputs.gallery(ctx.seed, cfg["index_rows"], cfg["index_dim"],
                          dev).cpu().numpy()
    frames = inputs.frames(inputs.stream(ctx.seed, "frames", dev),
                           mix["frames"], h, w, dev)
    del weights
    free(dev)
    reset_peak(dev)
    ctx.mark("index rows and frames (harness)")
    service = RetrievalService({"descriptors": rows}, height=h, width=w,
                               device=dev)
    del rows
    ctx.mark("RetrievalService() (port)")
    load_into(service._model, weights_host)
    ctx.mark("weights into the model")
    pool = concurrent.futures.ThreadPoolExecutor(mix["clients"])
    warm_clients(pool, mix["clients"], service, frames, mix["topk"])
    sync(dev)
    ctx.mark("warm-up: a query from each client (port)")
    return service, pool, frames, weights_host


def window(ctx, service, pool, frames, rate, tracer):
    """The open loop at ``rate`` for ``ctx.seconds``: (due times on the
    harness clock, sent, done, results, latencies in s)."""
    mix = ctx.traffic
    due = arrivals(ctx.seed, rate, ctx.seconds)
    order = inputs.host_rng(ctx.seed, "order").integers(0, len(frames),
                                                        len(due))
    with tracer as tr:
        t0, sent, done, results = open_loop(
            service, frames, order, due, mix["topk"], pool, mix["drain_s"],
            tr)
    lat = [(done[i] - t0 - due[i]) if isinstance(r, list) else math.inf
           for i, r in enumerate(results)]
    return t0 + due, order, sent, done, results, lat


def run(ctx):
    mix, dev = ctx.traffic, ctx.device
    service, pool, frames, weights_host = setup(ctx)
    setup_s = now() - ctx.t_start
    due, order, sent, done, results, lat = window(
        ctx, service, pool, frames, mix["rate_per_s"], ctx.tracer)
    memory = peak_bytes(dev)
    pool.shutdown(wait=False, cancel_futures=True)
    service.close()
    del service
    free(dev)

    ok = [i for i, r in enumerate(results) if isinstance(r, list)]
    values = {"query_p50_ms": 1e3 * nearest_rank(lat, 0.50),
              "query_p95_ms": 1e3 * nearest_rank(lat, 0.95),
              "setup_s": setup_s}
    if not ok:
        raise RuntimeError("no request was answered")
    rng = inputs.host_rng(ctx.seed, "check")
    slowest = max(ok, key=lambda i: lat[i])
    others = [i for i in ok if i != slowest]
    pick = sorted(rng.choice(others, min(len(others),
                                         mix["check_requests"] - 1),
                             replace=False).tolist() + [slowest])
    saved = {"frames": frames[order[pick]], "weights": weights_host,
             "ids": [[m["index"] for m in results[i]] for i in pick],
             "dists": [[m["sq_dist"] for m in results[i]] for i in pick]}
    checks = check(ctx, saved)
    spans = [("query", sent[i], done[i]) for i in range(len(due))
             if not math.isnan(done[i])]
    info = {"due": due, "sent": sent, "done": done, "spans": spans,
            "service": in_service(sent, done), "saved": saved}
    return Outcome(attempted=len(due), failed=len(due) - len(ok),
                   values=values, checks=checks, memory_peak_bytes=memory,
                   trace=ctx.tracer.trace, info=info)
