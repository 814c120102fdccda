"""Throughput and latency of the port on one card: descriptor extraction,
the end-to-end query, the SARE train step and the SFRS step (port of
bench.py).

  python bench_torch.py [--metric extract|query|train|sfrs]
      [--batch-size N] [--height 480] [--width 640] [--iters 10] [--quick]
      [--dtype bfloat16|float32] [--no-fused] [--int8 | --no-int8]
      [--gallery-size 100000] [--ivf-nprobe P] [--device-time] [--verbose]
      [--max-seconds 1500] [--device cuda|cpu]
  (or python -m openibl_tpu_torch.tools.bench ...)

Prints one JSON line per measured mode under bench.py's metric names and
keys (``metric``, ``value``, ``unit``, ``vs_baseline``; ``tflops`` and
``mfu`` for bf16 runs), plus ``device``: the card's name and power limit as
``nvidia-smi`` gives them, or ``cpu``. ``main(argv)`` returns the lines
printed, as dicts.

The model is bench.py's: VGG16 (``--dtype``, ``channels_last``) + NetVLAD
K=64 + PCA 32768 -> 4096, seeded random weights, in eval mode. On the card
the NetVLAD head is kernel K1 unless ``--no-fused`` asks for the plain
head; on the CPU it is the plain head. ``--int8`` swaps the backbone for
``ops/quant.py``'s (kernel K3 from conv2_1 on), calibrated on 8 seeded
``randn x 40`` frames. An f32 model runs its forward in full f32 (no TF32,
``utils.f32_precision``), as every f32 entry point of the port.

  extract  images/s at each batch size of a sweep (``--batch-size`` 0;
           ``--quick``: 8 and 16), the best one reported: a warm call,
           then ``--iters`` forwards with two batches in flight (the host
           waits for batch i-2's descriptors while i-1 and i run), host
           clock. On the card the default runs two modes, bf16 (or
           ``--dtype``) then ``_int8``, one line each; on the CPU only the
           first. A sweep stops at the first batch size that runs out of
           device memory; if no batch size completes the exit code is 1.
  query    one 480x640 image -> descriptor -> top-10 of a
           ``--gallery-size`` x 4096 gallery drawn on the device from a
           seeded generator (``ops.distance.topk_nearest``, chunk 16384;
           ``--ivf-nprobe`` P: ``ops.ivf.ivf_search`` over 256 cells whose
           centroids are gallery rows, filled by ``fill_lists``). The p50
           of max(iters, 10) synchronous queries (host clock, the ids
           copied to the host). ``--device-time``: n = max(iters, 50)
           distinct images, each drawn on the device, through forward and
           search back to back with nothing copied to the host, one
           synchronize at the end: ms a query, under bench.py's
           ``query_device_ms_..._scan{n}`` name.
  train    ``engine.trainer.Trainer`` (SARE-ind, lr 1e-3, no remat) on
           the EmbedNet with conv1-4 frozen, a (ts, 12, H, W, 3) seeded
           ``randn x 40`` batch on the device (ts = ``--batch-size`` or
           4): one warm step, then three groups of iters // 3 steps, each
           ended by the loss on the host; the median tuples/s.
  sfrs     ``engine.sfrs.SFRSTrainer`` (SARE-ind, 10 negatives) at
           generation 1 against a teacher seeded apart (ts 1 by default).
           The port's step takes each tuple as one union of 1 + 1 + 10 +
           10 = 22 images, which it splits into the easy tuple (12) and
           the difficult one (11); bench.py passes those two separately.
           The work is the same: both run the student over the union.

FLOPs. Extraction: ``vgg16_netvlad_flops`` (analytic, 2 x MACs, bench.py's
function as it is). Train and SFRS: the warm step runs under
``torch.utils.flop_counter.FlopCounterMode``, which counts the products and
convolutions that autograd actually runs. Like XLA's post-DCE count in
bench.py it leaves out the backward of the frozen conv1-4, which autograd
never runs; unlike it, it counts the taps of a padded convolution that
fall on the padding, as cuDNN computes them (1.7% of a 480x640 train
step, tests/test_torch_bench.py). ``mfu`` divides by the H100 SXM's
dense bf16 peak (data sheet, 989 TFLOP/s) for bf16 runs only; the int8
line's ``mfu`` stays that bf16-peak lower bound (its int8 layers could
reach the 1,979 TOPS int8 peak).

``--max-seconds`` arms an ``os._exit(3)`` timer, cancelled when the run
ends, so that a hung run ends without a result.
"""

import argparse
import collections
import json
import os
import statistics
import sys
import threading
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from openibl_tpu_torch import models
from openibl_tpu_torch.engine.sfrs import SFRSTrainer
from openibl_tpu_torch.engine.trainer import Trainer
from openibl_tpu_torch.ops.distance import topk_nearest
from openibl_tpu_torch.ops.ivf import fill_lists, ivf_search
from openibl_tpu_torch.ops.quant import quantize_model_params
from openibl_tpu_torch.tools._common import add_device_flag, card_label
from openibl_tpu_torch.utils import resolve_device, to_numpy

# bench.py's estimates of the reference stack's per-GPU rates (torch fp32
# on the 11GB-class GPUs its docs assume), the vs_baseline denominators
REFERENCE_GPU_IMG_PER_SEC = 50.0
REFERENCE_GPU_TRAIN_TUPLES_PER_SEC = 0.7
REFERENCE_GPU_QUERY_MS = 40.0
REFERENCE_GPU_SFRS_TUPLES_PER_SEC = 0.5

# H100 SXM dense tensor-core peaks (data sheet, 700 W), 2 x MAC convention
H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_INT8_OPS = 1979e12

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NUM_CLUSTERS, PCA_DIM = 64, 4096
IVF_NLIST = 256


def vgg16_netvlad_flops(height, width):
    """Analytic forward FLOPs/image (2*MACs) of VGG16-conv5 + NetVLAD + PCA.

    The conv stack is ~99.7% of the work (187.9 GFLOP at 480x640); the head
    adds the 1x1 soft-assign conv, the factorized VLAD accumulation
    (models/netvlad.py) and the 32768->4096 PCA matmul (~0.6 GFLOP).
    Returns (total, per_stage) where per_stage maps conv block -> FLOPs.
    """
    blocks = [  # VGG16 conv blocks to conv5_3 (pool follows all but 5)
        [(3, 64), (64, 64)],
        [(64, 128), (128, 128)],
        [(128, 256), (256, 256), (256, 256)],
        [(256, 512), (512, 512), (512, 512)],
        [(512, 512), (512, 512), (512, 512)],
    ]
    per_stage = {}
    h, w = height, width
    for bi, block in enumerate(blocks, start=1):
        fl = sum(2 * h * w * cin * cout * 9 for cin, cout in block)
        per_stage[f"conv{bi}"] = fl
        h, w = h // 2, w // 2  # pool1..4 halve; pool5 absent (cut at conv5)
    npix = (height // 16) * (width // 16)
    head = (2 * npix * 512 * 64      # soft-assignment logits (1x1 conv)
            + 2 * npix * 512 * 64    # factorized VLAD accumulation
            + 2 * 64 * 512 * 4096)   # PCA projection 32768 -> 4096
    per_stage["head"] = head
    return sum(per_stage.values()), per_stage


def _mfu_fields(rate, flops_per_call, per_call, dtype):
    """``tflops`` and ``mfu`` for a bf16 run (against the H100's dense bf16
    peak); nothing for f32, which has no single comparable peak."""
    if not flops_per_call or dtype != "bfloat16":
        return {}
    tflops = rate * flops_per_call / per_call / 1e12
    return {"tflops": round(tflops, 1),
            "mfu": round(tflops * 1e12 / H100_PEAK_BF16_FLOPS, 3)}


def seeded_images(seed, shape):
    """``randn x 40`` float images from a seeded CPU generator: the same
    pixels whatever device they are moved to."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen) * 40


def device_images(seed, shape, device):
    """``randn x 40`` float images drawn on ``device`` from a seeded
    generator (no host-to-device copy)."""
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device) * 40


def extract_model(args, quantized, device):
    """bench.py's extraction model on ``device``, in eval mode: K1 on the
    card unless ``--no-fused``; with ``quantized`` the int8 backbone."""
    gen = torch.Generator().manual_seed(0)
    model = models.create(
        "embednetpca",
        base=models.VGG16(compute_dtype=DTYPES[args.dtype], generator=gen),
        net_vlad=models.NetVLAD(num_clusters=NUM_CLUSTERS,
                                fused=device.type == "cuda"
                                and not args.no_fused, generator=gen),
        pca_dim=PCA_DIM, generator=gen)
    model = model.to(device, memory_format=torch.channels_last).eval()
    if quantized:
        calib = seeded_images(7, (8, args.height, args.width, 3)).to(device)
        model = quantize_model_params(model, calib)
    return model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _line(result, device):
    result["device"] = card_label(device)
    print(json.dumps(result), flush=True)
    return result


def _extract_seconds(model, x, iters):
    """A warm forward, then ``iters`` forwards with two batches in flight:
    seconds on the host clock until the last descriptors are on the host."""
    with torch.inference_mode():
        model(x).cpu()
        t0 = time.perf_counter()
        pending = collections.deque()
        for _ in range(iters):
            pending.append(model(x))
            if len(pending) > 2:
                pending.popleft().cpu()
        for out in pending:
            out.cpu()
        return time.perf_counter() - t0


def bench_extract(args, device):
    if args.int8 is None:
        modes = [False, True] if device.type == "cuda" else [False]
    else:
        modes = [bool(args.int8)]
    flops_per_img, _ = vgg16_netvlad_flops(args.height, args.width)
    lines = []
    for quantized in modes:
        model = extract_model(args, quantized, device)
        batches = [args.batch_size] if args.batch_size else (
            [8, 16] if args.quick else
            [16, 32, 64, 128] if quantized else [16, 32, 64, 128, 192, 256])
        best, best_bs = 0.0, 0
        for bs in batches:
            x = seeded_images(0, (bs, args.height, args.width, 3)).to(device)
            try:
                dt = _extract_seconds(model, x, args.iters)
            except torch.OutOfMemoryError as e:
                if args.verbose:
                    print(f"batch {bs}: {str(e)[:200]}", file=sys.stderr)
                del x
                torch.cuda.empty_cache()
                break
            rate = bs * args.iters / dt
            if args.verbose:
                tag = "int8 " if quantized else ""
                print(f"{tag}batch {bs}: {rate:.1f} img/s", file=sys.stderr)
            if rate > best:
                best, best_bs = rate, bs
            del x
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if best_bs == 0:
            print("bench: no batch size completed (out of device memory)",
                  file=sys.stderr, flush=True)
            continue
        qtag = "_int8" if quantized else ""
        lines.append(_line({
            "metric": f"descriptor_images_per_sec_per_chip_{args.height}x"
                      f"{args.width}_{args.dtype}{qtag}_bs{best_bs}",
            "value": round(best, 2),
            "unit": "images/sec/chip",
            "vs_baseline": round(best / REFERENCE_GPU_IMG_PER_SEC, 2),
            **_mfu_fields(best, flops_per_img, 1, args.dtype),
        }, device))
    if not lines:
        sys.exit(1)
    return lines


def ivf_index(gallery, nlist=IVF_NLIST):
    """bench.py's IVF over the random gallery: its first ``nlist`` rows as
    centroids (random rows are k-means-quality centroids for data with no
    cluster structure), each row's 8 nearest cells ranked on the device,
    the capacity-capped cells filled on the host (only overflow rows are
    gathered there). Returns (centroids, lists) on the gallery's device."""
    maxlen = -(-2 * gallery.shape[0] // nlist)
    centroids = gallery[:nlist]
    _, ranked = topk_nearest(gallery, centroids, k=min(8, nlist))
    lists = fill_lists(to_numpy(ranked), nlist, maxlen, x=gallery,
                       centroids=to_numpy(centroids))
    return centroids, torch.from_numpy(lists).to(gallery.device)


def bench_query(args, device):
    model = extract_model(args, False, device)
    gen = torch.Generator(device).manual_seed(0)
    gallery = torch.randn((args.gallery_size, PCA_DIM), generator=gen,
                          device=device)
    img = seeded_images(0, (1, args.height, args.width, 3)).to(device)
    suffix = ""
    if args.ivf_nprobe:
        centroids, lists = ivf_index(gallery)
        nprobe = min(args.ivf_nprobe, IVF_NLIST)
        suffix = f"_ivf{nprobe}of{IVF_NLIST}"

        def search(desc):
            return ivf_search(desc, gallery, centroids, lists, k=10,
                              nprobe=nprobe)[1]
    else:
        def search(desc):
            return topk_nearest(desc, gallery, k=10, chunk=16384)[1]

    with torch.inference_mode():
        search(model(img)).cpu()  # first-call work, not a query's
        if args.device_time:
            n = max(args.iters, 50)
            qgen = torch.Generator(device).manual_seed(2)

            def query():
                im = torch.randn((1, args.height, args.width, 3),
                                 generator=qgen, device=device) * 40
                return search(model(im))

            query()
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n):
                query()
            _sync(device)
            amort = (time.perf_counter() - t0) / n * 1e3
            return [_line({
                "metric": f"query_device_ms_{args.gallery_size}gallery"
                          f"{suffix}_scan{n}",
                "value": round(amort, 2),
                "unit": "ms",
                "vs_baseline": round(REFERENCE_GPU_QUERY_MS / amort, 2),
            }, device)]
        times = []
        for _ in range(max(args.iters, 10)):
            t0 = time.perf_counter()
            search(model(img)).cpu()
            times.append(time.perf_counter() - t0)
    p50 = statistics.median(times) * 1e3
    return [_line({
        "metric": f"query_p50_latency_ms_{args.gallery_size}gallery{suffix}",
        "value": round(p50, 2),
        "unit": "ms",
        "vs_baseline": round(REFERENCE_GPU_QUERY_MS / p50, 2),
    }, device)]


def counted_flops(fn):
    """(fn's result, the FLOPs of the products and convolutions it ran)."""
    with FlopCounterMode(display=False) as counter:
        out = fn()
    return out, counter.get_total_flops()


def _step_rate(step, iters, t_size):
    """Median tuples/s over three groups of iters // 3 steps, each ended by
    the last step's loss on the host."""
    group = max(iters // 3, 1)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(group):
            loss = step()
        float(loss)
        rates.append(t_size * group / (time.perf_counter() - t0))
    return statistics.median(rates)


def train_model(args, device, name, seed=0, tuple_size=1):
    """A seeded EmbedNet / EmbedRegionNet (the eager head) on ``device``,
    conv1-4 frozen."""
    gen = torch.Generator().manual_seed(seed)
    kw = {"tuple_size": tuple_size} if name == "embedregionnet" else {}
    model = models.create(
        name, base=models.VGG16(compute_dtype=DTYPES[args.dtype],
                                generator=gen),
        net_vlad=models.NetVLAD(num_clusters=NUM_CLUSTERS, generator=gen),
        **kw)
    model.base.freeze("conv5")
    return model.to(device, memory_format=torch.channels_last)


def train_step(args, device):
    """(step() -> loss, tuples a step) of bench.py's SARE train metric."""
    t_size = args.batch_size or 4
    trainer = Trainer(train_model(args, device, "embednet"),
                      loss_type="sare_ind", lr=1e-3, remat=False)
    trainer.init()
    tup = device_images(1, (t_size, 12, args.height, args.width, 3), device)
    return (lambda: trainer.step(tup)), t_size


def sfrs_step(args, device):
    """(step() -> loss_hard, tuples a step) of bench.py's SFRS metric:
    generation 1 against a teacher seeded apart."""
    t_size = args.batch_size or 1
    student = train_model(args, device, "embedregionnet", 0, t_size)
    teacher = train_model(args, device, "embedregionnet", 1,
                          t_size).requires_grad_(False)
    trainer = SFRSTrainer(student, loss_type="sare_ind", neg_num=10,
                          lr=1e-3)
    trainer.init_generation()
    union = device_images(2, (t_size, 22, args.height, args.width, 3),
                          device)
    return (lambda: trainer.step(teacher, union, 1)[0]), t_size


def bench_train(args, device, sfrs):
    step, t_size = (sfrs_step if sfrs else train_step)(args, device)
    loss, flops = counted_flops(step)  # the warm step
    float(loss)
    rate = _step_rate(step, args.iters, t_size)
    prefix, ref = (("sfrs", REFERENCE_GPU_SFRS_TUPLES_PER_SEC) if sfrs else
                   ("sare", REFERENCE_GPU_TRAIN_TUPLES_PER_SEC))
    return [_line({
        "metric": f"{prefix}_train_tuples_per_sec_{args.height}x{args.width}"
                  f"_{args.dtype}_ts{t_size}",
        "value": round(rate, 3),
        "unit": "tuples/sec/chip",
        "vs_baseline": round(rate / ref, 2),
        **_mfu_fields(rate, flops, t_size, args.dtype),
    }, device)]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch-size", type=int, default=0,
                   help="0 = sweep and report the best")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--quick", action="store_true", help="small sweep")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=sorted(DTYPES))
    p.add_argument("--no-fused", action="store_true",
                   help="the plain NetVLAD head on the card instead of K1")
    p.add_argument("--int8", action="store_true", default=None,
                   help="extract only: ONLY the int8 backbone (K3); the "
                        "default on the card runs both modes, one line "
                        "each")
    p.add_argument("--no-int8", dest="int8", action="store_false",
                   help="extract only: the float backbone alone")
    p.add_argument("--metric", type=str, default="extract",
                   choices=["extract", "query", "train", "sfrs"])
    p.add_argument("--gallery-size", type=int, default=100_000)
    p.add_argument("--ivf-nprobe", type=int, default=0,
                   help="query only: >0 searches an IVF index of 256 cells, "
                        "probing this many")
    p.add_argument("--device-time", action="store_true",
                   help="query only: ms a query over many queries back to "
                        "back on the device")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--max-seconds", type=int, default=1500,
                   help="exit(3) without a result after this many seconds "
                        "(0: no limit)")
    add_device_flag(p)
    args = p.parse_args(argv)
    if args.int8 is not None and args.metric != "extract":
        p.error(f"--int8/--no-int8 applies to --metric extract only (got "
                f"--metric {args.metric})")
    return args


def _deadline(seconds):
    def fire():
        print(f"bench exceeded --max-seconds={seconds}: aborting without a "
              f"result", file=sys.stderr, flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    return timer


def main(argv=None):
    """Run the metric; return the JSON lines printed, as dicts."""
    args = parse(argv)
    timer = _deadline(args.max_seconds) if args.max_seconds > 0 else None
    try:
        device = resolve_device(args.device)
        if args.metric == "extract":
            return bench_extract(args, device)
        if args.metric == "query":
            return bench_query(args, device)
        return bench_train(args, device, sfrs=args.metric == "sfrs")
    finally:
        # an embedding process must not inherit a live os._exit timer
        if timer is not None:
            timer.cancel()


if __name__ == "__main__":
    main()
