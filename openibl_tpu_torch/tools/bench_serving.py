"""Serving latency per index storage variant and batch bucket (port of
scripts/bench_serving.py).

  python -m openibl_tpu_torch.tools.bench_serving [--gallery-size 100000]
      [--iters 9] [--variants f32,f16,int8,ivf_f32,pq,pq_rerank]
      [--device-time [--scan-n 30]] [--device cuda|cpu]
      [--out logs/torch/serving_latency.json]

The end-to-end latency of ``serving.RetrievalService`` (uint8 pixels in,
ranked matches out) over one gallery stored six ways: ``f32``; ``f16``
(half-width rows); ``int8`` (per-row scales,
``ops.distance.quantize_index_int8``); ``ivf_f32`` (IVF cells over the f32
rows, ``--ivf-nlist`` 256, ``--ivf-nprobe`` 32); ``pq`` (m=64 codes,
exhaustive ADC through kernel K2); ``pq_rerank`` (an ADC shortlist of
``--pq-shortlist`` 128 re-ranked by exact distance). For each variant and
each batch bucket (1/4/16) the p50 of the host clock around
``service.query``, which ends on the host with the matches: bucket 1 takes
``--iters`` samples, a larger bucket max(5, iters // bucket). The model
(VGG16 + NetVLAD K=64 through kernel K1 + PCA to 4096, seeded random
weights) runs in f32 at ``--height`` x ``--width``.

The gallery: ``--gallery-size`` unit-norm rows drawn on the device from a
seeded ``torch.Generator`` (their content does not change the latency: the
top-k cost does not depend on the data). Every index is built on the
device from it (IVF and PQ with 16,384 training rows), right before its
variant is measured.

``--device-time`` measures instead, per variant, the device time of a
query: ``--scan-n`` distinct images drawn on the card, each through the
forward and the search, back to back, CUDA events around the run, over n
(the counterpart of the JAX script's single ``lax.scan``). It also records
``host_syncs``: where one query of the variant waits for the card (each
synchronizing CUDA operation, ``torch.cuda.set_sync_debug_mode("warn")``,
as file:line), since a wait inside a search turns device time into host
time. It needs the card: with ``--device cpu`` it exits 2.

Each variant's row is written to ``--out`` as soon as it is measured
(atomically); a variant already there is skipped, per pass: ``bs1`` marks
the synchronous pass done, ``device_ms_per_query`` the device pass. A
timed-out run is finished by running it again. Unknown variants are
refused.
"""

import argparse
import json
import pathlib
import statistics
import sys
import time
import traceback
import warnings

import numpy as np
import torch

from openibl_tpu_torch.hub import vgg16_netvlad
from openibl_tpu_torch.ops.distance import quantize_index_int8, topk_nearest
from openibl_tpu_torch.ops.ivf import build_ivf, fill_lists, ivf_search
from openibl_tpu_torch.ops.pq import build_pq, pq_search, pq_search_rerank
from openibl_tpu_torch.serving import RetrievalService
from openibl_tpu_torch.tools._common import (
    ARTIFACTS, ROOT, add_device_flag, call_times_ms, device_name,
    write_json)
from openibl_tpu_torch.utils import f32_precision, resolve_device, to_numpy

VARIANTS = ("f32", "f16", "int8", "ivf_f32", "pq", "pq_rerank")
# the device pass builds the cheapest indexes first, so a stall loses the
# fewest rows
DEVICE_ORDER = ("f32", "f16", "int8", "pq", "pq_rerank", "ivf_f32")
PQ_BUILD = {"m": 64, "train_size": 16384, "iters": 10}


def p50(samples):
    return float(np.percentile(np.asarray(samples), 50))


def make_gallery(n, dim, device):
    """(n, dim) unit-norm f32 rows drawn on ``device``, seeded."""
    gen = torch.Generator(device).manual_seed(0)
    raw = torch.randn((n, dim), generator=gen, device=device)
    return raw / raw.norm(dim=1, keepdim=True)


def host_syncs(fn):
    """Where one call of ``fn`` waits for the card: for each synchronizing
    CUDA operation it runs, the innermost frame of this package's code on
    the stack, as file:line from the repository's root."""
    pkg = ROOT / "openibl_tpu_torch"
    where = set()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        for frame in reversed(traceback.extract_stack()[:-1]):
            path = pathlib.Path(frame.filename)
            if path.is_relative_to(pkg):
                where.add(f"{path.relative_to(ROOT)}:{frame.lineno}")
                return
        where.add(f"{filename}:{lineno}")

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        # switching the mode on warns once a process by itself; only what
        # ``fn`` runs is recorded
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return sorted(where)


def _service_kwargs(name, g, g_dev, args, stage):
    """RetrievalService arguments of variant ``name`` over the host gallery
    ``g``; its IVF / PQ tables are built on the device from ``g_dev``."""
    if name == "f32":
        return {"index": {"descriptors": g}}
    if name == "f16":
        return {"index": {"descriptors": g.astype(np.float16)}}
    if name == "int8":
        codes, scales = quantize_index_int8(g)
        stage("int8 quantized")
        return {"index": {"descriptors": codes, "scales": scales}}
    if name == "ivf_f32":
        # a cheap coarse quantizer: the latency depends on the nlist,
        # maxlen and nprobe shapes, not on the centroids' quality
        ivf = build_ivf(g_dev, nlist=args.ivf_nlist, iters=8,
                        train_size=16384)
        stage("ivf built")
        return {"index": {"descriptors": g, "ivf_centroids": ivf["centroids"],
                          "ivf_lists": ivf["lists"]},
                "ivf_nprobe": args.ivf_nprobe}
    payload = build_pq(g_dev, **PQ_BUILD)
    stage(f"{name}: pq built")
    if name == "pq":
        return {"index": payload}
    return {"index": {**payload, "descriptors": g},
            "pq_rerank": args.pq_shortlist}


def _sync_pass(args, results, todo, g_dev, stage, out, device):
    g = to_numpy(g_dev)
    rng = np.random.default_rng(1)  # the query images
    for name in todo:
        kw = _service_kwargs(name, g, g_dev, args, stage)
        svc = RetrievalService(kw.pop("index"), weights=None,
                               height=args.height, width=args.width,
                               device=device, **kw)
        svc.warmup()
        stage(f"{name}: service warm (index on the device, every bucket "
              f"run once)")
        table = {}
        for bucket in svc.buckets:
            imgs = list(rng.integers(
                0, 256, (bucket, svc.height, svc.width, 3)).astype(np.uint8))
            svc.query(imgs)  # one settled warm query at this bucket
            samples = []
            for _ in range(max(args.iters // bucket, 5)):
                t0 = time.perf_counter()
                svc.query(imgs)
                samples.append((time.perf_counter() - t0) * 1e3)
            row = {"p50_ms": round(p50(samples), 4),
                   "p50_ms_per_image": round(p50(samples) / bucket, 4),
                   "iters": len(samples)}
            table[f"bs{bucket}"] = row
            print(f"{name} bs{bucket}: p50 {row['p50_ms']} ms "
                  f"({row['p50_ms_per_image']} ms/img) on "
                  f"{results['platform']}", flush=True)
        # merge: a device pass may already have written its keys here
        results["variants"].setdefault(name, {}).update(table)
        write_json(out, results)
        svc.close()
        del svc, kw
        if device.type == "cuda":
            torch.cuda.empty_cache()


def _device_searches(args, g_dev, stage):
    """{variant: () -> search(desc) -> ids}: each index built on the card
    from the resident gallery when its builder is called."""
    n2 = torch.sum(g_dev * g_dev, dim=1)

    def f32():
        return lambda d: topk_nearest(d, g_dev, k=10, gallery_sqnorm=n2)[1]

    def f16():
        g16 = g_dev.half()
        return lambda d: topk_nearest(d, g16, k=10, gallery_sqnorm=n2)[1]

    def int8():
        s = torch.clamp(torch.amax(torch.abs(g_dev), dim=1) / 127.0,
                        min=1e-30)
        c = torch.clamp(torch.round(g_dev / s[:, None]), -127, 127).to(
            torch.int8)
        n2i = torch.sum(torch.square(c.float() * s[:, None]), dim=1)
        return lambda d: topk_nearest(d, c, k=10, gallery_scale=s,
                                      gallery_sqnorm=n2i)[1]

    def ivf_f32():
        nlist = args.ivf_nlist
        maxlen = -(-2 * g_dev.shape[0] // nlist)
        centroids = g_dev[:nlist]  # random rows serve as centroids here
        _, ranked = topk_nearest(g_dev, centroids, k=min(8, nlist))
        lists = torch.from_numpy(fill_lists(
            to_numpy(ranked), nlist, maxlen, x=g_dev,
            centroids=to_numpy(centroids))).to(g_dev.device)
        stage("ivf lists filled")
        nprobe = min(args.ivf_nprobe, nlist)
        return lambda d: ivf_search(d, g_dev, centroids, lists, k=10,
                                    nprobe=nprobe, gallery_sqnorm=n2)[1]

    def _pq():
        payload = build_pq(g_dev, **PQ_BUILD)
        stage("pq built (on the device)")
        return (torch.from_numpy(payload["pq_codes"]).to(g_dev.device),
                torch.from_numpy(payload["pq_codebooks"]).to(g_dev.device))

    def pq():
        codes, cb = _pq()
        return lambda d: pq_search(d, codes, cb, k=10)[1]

    def pq_rerank():
        codes, cb = _pq()
        return lambda d: pq_search_rerank(
            d, codes, cb, g_dev, k=10, shortlist=args.pq_shortlist,
            gallery_sqnorm=n2)[1]

    return {"f32": f32, "f16": f16, "int8": int8, "ivf_f32": ivf_f32,
            "pq": pq, "pq_rerank": pq_rerank}


def _device_time_pass(args, results, todo, g_dev, stage, out):
    device = g_dev.device
    model = vgg16_netvlad(None, device=device)
    builders = _device_searches(args, g_dev, stage)
    n = args.scan_n
    for name in sorted(todo, key=DEVICE_ORDER.index):
        with torch.inference_mode(), f32_precision():
            search = builders[name]()
            stage(f"{name}: index ready")
            gen = torch.Generator(device).manual_seed(2)

            def query():
                im = torch.randn((1, args.height, args.width, 3),
                                 generator=gen, device=device) * 40
                return search(model(im))

            query()  # a first call's one-time work is not the query's
            syncs = host_syncs(query)
            ms = statistics.mean(call_times_ms(query, device, n, warmup=1))
        row = results["variants"].setdefault(name, {})
        row["device_ms_per_query"] = round(ms, 4)
        row["device_scan_n"] = n
        row["host_syncs"] = syncs
        print(f"{name}: device {ms:.4f} ms/query (run of {n}), host syncs "
              f"{syncs or 'none'} on {results['platform']}", flush=True)
        write_json(out, results)
        del search
        torch.cuda.empty_cache()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gallery-size", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=4096,
                    help="must match the model's descriptor (EmbedNetPCA: "
                         "4096)")
    ap.add_argument("--iters", type=int, default=9,
                    help="p50 samples at bucket 1; a larger bucket takes "
                         "max(5, iters // bucket)")
    ap.add_argument("--ivf-nlist", type=int, default=256)
    ap.add_argument("--ivf-nprobe", type=int, default=32)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--out", default=str(ARTIFACTS / "serving_latency.json"))
    ap.add_argument("--pq-shortlist", type=int, default=128,
                    help="pq_rerank: the ADC shortlist re-ranked exactly")
    ap.add_argument("--variants", type=str, default=",".join(VARIANTS),
                    help="the variants to measure; those already in --out "
                         "are skipped (resume)")
    ap.add_argument("--device-time", action="store_true",
                    help="measure each variant's device time per query "
                         "(forward + search, --scan-n distinct queries "
                         "back to back) and its host syncs instead")
    ap.add_argument("--scan-n", type=int, default=30,
                    help="queries per device-time run")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.device_time and args.device != "cuda":
        ap.error("--device-time times the card: it needs --device cuda")
    return args


def main(argv=None):
    """Measure the variants not yet in ``--out``; return the summary line
    (``measured``: the variants this call measured)."""
    args = parse(argv)
    wanted = [v for v in args.variants.split(",") if v]
    unknown = [v for v in wanted if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants: {unknown}")
    device = resolve_device(args.device)
    t_start = time.perf_counter()

    def stage(msg):
        print(f"[{time.perf_counter() - t_start:7.1f}s] {msg}",
              file=sys.stderr, flush=True)

    out = pathlib.Path(args.out)
    results = {
        "gallery_size": args.gallery_size,
        "dim": args.dim,
        "iters": args.iters,
        "resolution": [args.height, args.width],
        "platform": device_name(device),
        "ivf": {"nlist": args.ivf_nlist, "nprobe": args.ivf_nprobe},
        "variants": {},
    }
    if out.is_file():  # resume: keep the rows an earlier run wrote
        try:
            results["variants"] = json.loads(
                out.read_text()).get("variants", {})
        except (json.JSONDecodeError, OSError):
            pass
    # each pass resumes on its own key: a row holding only the other
    # pass's result must not mark this pass done
    key = "device_ms_per_query" if args.device_time else "bs1"
    todo = [v for v in wanted if key not in results["variants"].get(v, {})]
    mode = "device-time" if args.device_time else "sync"
    if not todo:
        summary = {"artifact": str(out), "ok": True, "mode": mode,
                   "measured": [],
                   "skipped": "all variants already captured"}
        print(json.dumps(summary))
        return summary
    stage(f"variants to measure: {todo} (resumed: "
          f"{sorted(results['variants'])})")

    g_dev = make_gallery(args.gallery_size, args.dim, device)
    stage("gallery drawn on the device")
    if args.device_time:
        _device_time_pass(args, results, todo, g_dev, stage, out)
    else:
        _sync_pass(args, results, todo, g_dev, stage, out, device)
    summary = {"artifact": str(out), "ok": True, "mode": mode,
               "measured": todo, "device": results["platform"]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
