"""GPU smoke run of the PyTorch port (openibl_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Builds the port's six CUDA libraries from this checkout, one nvcc each,
in parallel: the fused NetVLAD head (K1, csrc/netvlad.cu), the PQ ADC tile
scorer (K2, csrc/pq_adc.cu), the six kernels of the Mosaic layout probes
(P1-P7, csrc/mosaic_probe.cu), the int8 3x3 convolution with the fused
requantize epilogue (K3, csrc/quant_conv.cu) and the f32 3x3 convolution
in split TF32 with its bias and ReLU (K4, csrc/conv_f32.cu: each layer of
VGG16 at 480x640 at batch 16 and 1 against the f64 convolution, timed
beside its plain version, cuDNN's f32 convolution and every forced
geometry; its launches are counted on each main-path run below and held
to its forwards: 13 an f32 forward, 10 a step that trains conv5, 2 a
quantized forward) and the f32 linear layer in split TF32 with its bias
(K5, csrc/linear_f32.cu: each of AnyLoc's ViT-g/14 linears at batch 16
and 1 against the f64 product, timed beside its plain version,
torch.matmul and both tile shapes; its launches counted on the AnyLoc
extract path, 125 a forward). Holds each to its plain
PyTorch version on the card at the main path's shapes (the probes at the TPU script's own toy
sizes, each row driven through the port's probe tool as its own path),
then drives the serving path at full width:
VGG16 + NetVLAD (K=64) + PCA 32768→4096 at 480x640, a RetrievalService over
a 100,000 x 4096 f32 gallery with 32 planted rows, queries through
examples/serve_torch.py's HTTP handler on localhost, and Recall@1 over the
planted rows. Then the int8 backbone (ops/quant.py) served: a
RetrievalService with quant_backbone=True over the same gallery,
calibrated on four frames; K3 held to its plain version bit for bit at the
eleven quantized layers' shapes (batch 1, the model's own activations, f32
and bf16 prefix), on a second run, through the masked forward at a ragged
odd extent and with quant_from="conv1_1" (Cin = 3, padded); every planted
row at top-1; the conv5_3 map against the f32 model's (rel < 0.08, cosine
> 0.995), each int8 descriptor's nearest f32 descriptor its own image's,
and the VLAD and served descriptors' cosines against the f32 model's;
extraction img/s with an f32 and a bf16 prefix under bench.py's ``_int8``
names; the exact query p50; and each layer's K3 time at batch 16 and at
batch 1 (the served query) with its launch geometry, beside its bound, its
plain version, torch._int_mm on the same GEMM, cuDNN's bf16 convolution
and the time of one block a tile beside K3's persistent grid. K3's ptxas
report and, where cuobjdump exists, its SASS counts of IGMMA, UTMALDG,
UTMASTG and IMMA are printed and checked after the build, before any
kernel runs. Then the index family over the same gallery, built on the
card (PQ m=64, OPQ, IVF and IVFADC with 256 cells), and its served modes:
a codes-only PQ index, IVFADC, the PQ re-rank and full-width IVF, each
through a RetrievalService (PQ also through HTTP) with its Recall@1/5/10.
Then the training slice at full width: a synthetic world at 480x640 (24
places x 4 images), the EmbedNet (VGG16, K=64) from seeded weights with
NetVLAD bootstrapped from its conv5 features, and one epoch of
engine/pipeline.run_baseline_training (SARE-ind, tuples of 1 anchor + 1
positive + 10 negatives, 4 a step, 3 steps): mining and evaluation through
K1, training through the eager head, validation eval and the final PCA
eval. It checks K1 on a mining batch, the tuples mined from K1's
descriptors against the plain head's (up to ties), the losses, the frozen
layers (bit-equal) and one train step on the card against the same step on
the CPU, and prints the train step's tuples/s and the mining extraction's
img/s (steady over five passes, with the decode and the device apart).
Then checkpoint evaluation at full width, Tokyo 24/7: a mini Tokyo root
(64 gallery PNGs at 480x640, 16 queries re-rendered at mixed sizes and
orientations, 16 TokyoTM images), the serving model's EmbedNet saved as a
JAX-layout .npz checkpoint, and engine/pipeline.run_eval on the default
device with NMS and a PCA fitted on demand: bucket-padded queries through
the masked forward (eager head), the gallery through K1. It checks the
masked descriptors against per-shape batch-1 forwards on the card and one
query per bucket against the CPU, K1 on a gallery batch, run_eval's recalls
against the per-shape descriptors' and which pass launched K1, and prints
the masked img/s per bucket (with its fill), the per-shape loop's img/s,
the masking's cost, the gallery's img/s and run_eval's phases; then one
run_eval with the k-reciprocal rerank (k1 25, lambda 0), its recalls held
to the CPU's rerank of the same descriptors and its time printed.
Then SFRS at full width on the training phase's world: the EmbedRegionNet
(VGG16, K=64, C=512) from seeded weights, and engine/pipeline
.run_sfrs_training for 2 generations x 1 epoch (SARE-ind, 1 anchor + 1
positive + 10 negatives + 10 difficult positives a tuple, 3 steps a
generation), so gen 1 mines with k-reciprocal Jaccard distances (the
native C++ library built from csrc/rerank.cpp by g++, required: a failed
build fails the run), trains on the hardest-region negatives and the soft
loss. It checks K1 on a mining batch, gen 1's tuples from K1's
descriptors against the plain head's (up to ties), the device Jaccard
engine against the native one, the losses, the frozen layers after each
generation and one gen-1 step on the card against the CPU, and prints the
gen-1 step's tuples/s, run_sfrs_training's phases and which Jaccard
engine mining used.
Then on-device ColorJitter (ops/augment.py) on that world: a tuple batch
of 1 + 1 + 10 images jittered on the card against the CPU with the same
draws (atol 1e-3 on the 0..255 scale), zero ranges bit for bit, one
device_jitter=True train step and one SFRS gen-1 step (cuDNN off; with
it, printed against the card's f64 step) on the card against the same
steps on the CPU at the training phases' gate, and the jitter pass's time
and share of the jittered step.
Then the mesh (parallel/mesh.py): a one-rank torchrun environment on a
free localhost port, maybe_init_distributed and get_mesh (NCCL), sharded
extraction through K1 and the sharded kNN over the 100k gallery against
the unsharded ones, run_eval(mesh=) on the Tokyo root against run_eval,
the all-gather's and the sharded kNN's times; the group destroyed, then
two ranks spawned on the one card through gloo over CUDA tensors, their
sharded extraction and kNN held to the single-process results.
Then data-parallel training on the training phase's world: the baseline
example (examples/train_baseline_torch.py) run in a one-rank torchrun
environment on a free localhost port (NCCL), with the training phase's
config, so run_baseline_training takes its mesh branch with real
collectives; its losses, final parameters and recalls held to the
training phase's single-process run at the training gate, K1 counted on
it; then two gloo ranks on the one card, each one tuple of a
tuple_size=2 batch, taking one device_jitter=True SARE-ind step and one
SFRS gen-1 step (cuDNN off) from the same parameters, held to the
one-process step on both tuples at the training gate and to each other
bit for bit; each path's wall time and the gradient all-reduce's time
(CUDA events) printed.
Then mesh-sharded serving (phase 8b, after the served modes, on the
served gallery and its OPQ m=64 codes): RetrievalService(mesh=) in a
one-rank torchrun environment (NCCL), exact and PQ, against the
single-device services' top-10 for the 32 planted queries, with its p50 at
batch 1; then two gloo ranks on the one card (rank 0 serves, rank 1
follows in lockstep), exact and PQ over 100,000 and 99,999 rows, each rank
holding ceil(N/2) rows, against single-device answers, K2 on each rank's
resident codes against the plain scorer, K1's launches on rank 0 and K2's
on each rank, rank 0's p50 and the per-query cost of the lockstep header,
the descriptor broadcast and the candidates' all-gather; then
examples/serve_torch.py --n-devices 1 --pq under a one-rank torchrun
(/healthz, one POST /query against the single-device PQ service, SIGTERM to
rank 0, every rank's exit code 0); then graft_entry_torch's
dryrun_multichip(2, backend="gloo") on the card and entry()'s descriptor.
Then the seven measurement tools of openibl_tpu_torch/tools (phase 9h),
each through its main(argv) at full width, with K1's and K2's launches
counted per tool: ivf_recall at its defaults (recall@10 1.0 at nprobe =
nlist, >= 0.95 at nlist/8) and pq_recall (m=16 recall@10 >= 0.95, >= 0.98
in the top 40, IVFADC >= 0.98 at full probe: tests/test_pq.py's gates)
on EmbedNet descriptors of the synthetic world; time_sfrs_rerank at
Pitts30k's union (n=17,000, 1,000 anchors, r1 skipped) with the device
Jaccard held to the host's (rtol 1e-5 / atol 1e-6), then with r1 at
n=4,000; profile_head at batch 128, then K1 held to the plain head (rtol
1e-4 / atol 1e-5) and the f32 PCA bit-equal with the global TF32 flag on
and off; profile_backbone at batch 16 and 128 (conv_ms + head_ms =
full_ms); profile_phases at 480x640 in a process of its own, its trace
naming K1's three kernels; bench_serving over 100,000 rows, all six
variants, the synchronous pass and the device pass (finite p50s per
bucket, a device time per query, the host syncs of each search), then
both again, which skip everything (resume).
Then the bench lane (phase 9i): tools/bench.py (bench_torch.py) through
its main(argv) at 480x640 over a 100,000-row gallery: extraction at batch
16 in its default modes (bf16, then _int8), in f32 and with --no-fused;
the query p50 and --device-time, each also with --ivf-nprobe 32; the
SARE step (4 tuples) and the SFRS step (1), f32 and bf16; each line
under bench.py's exact metric name with a finite value > 0, the f32
extraction within 15% of phase 7's and the f32 SARE step within 15% of
the train phase's, K1 counted
on each run (> 0 fused, 0 with --no-fused) and K3 on the int8 extract (11
a forward); probe_index_paths at its defaults (8 variants timed, none
failed; f32_full and f32_norms give topk_nearest's top-10 up to ties);
then bench_all's entries the in-process runs leave out (the three
extracts at batch 128), each a bench_torch.py process (every rc 0,
fused_speedup and int8_speedup present), and bench_all again, which
skips them all (resume).
Beside the served path it measures what cuDNN's TF32 (on as
PyTorch ships it) does to an f32 descriptor at 480x640 and to the top-10
over the 100k gallery, through the model's parts and through the entry
point, which runs in f32 whatever the flag.

The quant phase's K1 and K3 counts cover its served queries.
Weights are random from a seed; the NetVLAD layer is bootstrapped from
clusters of the model's own conv5 features (the package's
netvlad_init_from_clusters, as a trainer initializes it), and the PCA
layer's bias centres the VLADs on their mean over the bootstrap images, as
a PCA fit does, because the raw random init maps every image to nearly the
same descriptor. Each served
path, the training run, the SFRS run, the two Tokyo eval runs, the
mesh's sharded extraction, sharded eval and two-rank run, the
torchrun training run, each mesh-served path (on rank 1, its whole
follow(), warm-up and timed queries included), each tool's run and each
in-process bench run run with the kernels' launch counts set to 0 just
before and read just after.
K1 is also checked at a ragged P (30x41) and at K = 17, for
the same bits on a second run, and against its split-precision arithmetic
run in plain PyTorch; K2 also at 3 and 17 queries. Prints timing
lines (CUDA events, or the host clock for service.query) with the card's
name and power limit on every line that holds a number, each kernel's time
per call beside its bytes/operations bound (the larger of its bytes over
3.35 TB/s and its operations over the peak for their type, the H100 SXM
data sheet's: f32 on CUDA cores 67 TFLOP/s; K1's split-precision products
on the tensor cores, 3 TF32 products at 495 TFLOP/s, with the f32
CUDA-core bound of the same products beside it; K3's int8 products at
1,979 TOPS) and, where one PyTorch call computes the same function, that
call's time (K3 has none: two yardsticks instead). P6 and P7 also run at
a K2-sized shape, one query's LUT at m=64 (64, 256) against the served
gallery's 100,000 codes, checked bit for bit and timed beside their bound
and yardstick (not entries of the kernels line). Then, after every timed
phase, the launch floor (the device time of an empty kernel, printed as
``floor: ...``) and each kernel's and each yardstick's device time
(torch.profiler, ``device_ms`` / ``library_device_ms``); every bound is
restated as the larger of bytes, operations and that floor (``bound_by``
names which). One JSON line on the kernels, and as its last line {"ok":
true, "device": {...}}. Any failed check raises: the exit code is then
non-zero and the last line is not printed. ``--seed`` (default 0) seeds
the inputs the script makes (the probe tool's rows keep the TPU script's
own seeds). Needs CUDA; imports no jax.
"""

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import os.path as osp
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

ROOT = osp.dirname(osp.abspath(__file__))
N_IMG, H, W = 16, 480, 640
GALLERY, DIM, PLANTED = 100_000, 4096, 32
BOOT_IMGS = 64  # images whose features initialize NetVLAD and centre PCA
RTOL, ATOL = 1e-4, 1e-5  # K1: both sides upcast the same values to f32
# K2: the kernel and its plain version add the same f32 values in the same
# subspace order
K2_TOL = 1e-5
K2_ROWS = (1_000_000, 999_983, GALLERY)  # 1M codes, a ragged N, main path
PQ_M, NLIST, NPROBE, SHORTLIST = 64, 256, 16, 256
KERNELS = {"netvlad": ["netvlad.cu"], "pq_adc": ["pq_adc.cu"],
           "mosaic_probe": ["mosaic_probe.cu"],
           "quant_conv": ["quant_conv.cu"], "conv_f32": ["conv_f32.cu"],
           "linear_f32": ["linear_f32.cu"]}
# H100 SXM at 700 W (data sheet): HBM bytes, f32 CUDA-core operations and
# dense tensor-core operations (TF32, bf16) per ms
HBM_BYTES_PER_MS, F32_OPS_PER_MS = 3.35e9, 67e9
TF32_OPS_PER_MS, BF16_OPS_PER_MS = 495e9, 989e9
INT8_OPS_PER_MS = 1979e9  # dense int8 tensor-core operations
# the training phase: tuples of 1 anchor + 1 positive + 10 negatives, 4 a
# step, 3 steps, on the default synthetic world (24 places x 4 images)
TRAIN_TS, TRAIN_NEG, TRAIN_ITERS = 4, 10, 3
MINE_REPS = 5  # timed passes of the mining extraction, after a warm-up
# the SFRS phase: the reference recipe's tuples (1 anchor + 1 positive + 10
# negatives + 10 difficult positives, one a step), 3 steps a subset
SFRS_NEG, SFRS_POS, SFRS_ITERS = 10, 10, 3
# the Tokyo 24/7 phase: 32 panorama directories of 2 gallery images at
# H x W, 16 queries re-rendered from them at the sizes (w, h) below (both
# orientations, odd extents; TestTransform(tokyo=True) then sets the
# shorter side to max(H, W)), TokyoTM train 4 places x 3 timestamps and
# val 2 x 2 at H x W, the PCA fitted on the 12 train images (8 components)
TOKYO_DIRS, TOKYO_PCA_DIM = 32, 8
TOKYO_QUERY_SIZES = (
    (1000, 750), (750, 1000), (1280, 720), (997, 743), (720, 1280),
    (743, 997), (1024, 768), (768, 1024), (1200, 900), (900, 1200),
    (1100, 825), (1333, 1000), (1023, 767), (600, 800), (1280, 960),
    (1281, 721))
# card vs CPU ColorJitter, f32 on the 0..255 scale (about 65 ulps at 255)
JITTER_ATOL = 1e-3
# the tools phase's depth (the tools' defaults: 6, 12, 9): OPQ alternations
# in pq_recall, iterations a prefix in profile_backbone, p50 samples at
# bucket 1 in bench_serving
TOOLS_OPQ_ITERS, TOOLS_BACKBONE_ITERS, TOOLS_SERVING_ITERS = 2, 6, 9
# the bench phase: extraction at batch 16, 10 timed forwards (bench.py's
# default), and the bench_all entries its in-process runs leave out (the
# three extracts at batch 128, whose ratios are bench_all's speed-ups)
BENCH_BATCH, BENCH_ITERS = 16, 10
BENCH_ALL_ONLY = ("extract_int8", "extract_fused", "extract_nofused")
CARD = ""  # the card's name and power limit, set by run()


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what} [{CARD}]")
    print(f"  ok: {what} [{CARD}]", flush=True)


def card_line():
    from openibl_tpu_torch.tools._common import card_label

    return card_label(torch.device("cuda", 0))


def cuda_ms(fn, reps=20, warmup=3):
    """Median time of one call of ``fn`` on the current stream, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=20):
    """Device time of one call of ``fn``: the time of the CUDA kernels in a
    torch.profiler trace of ``reps`` calls, over ``reps`` (None if the trace
    holds no device time), and each kernel's share of it by name. Unlike
    cuda_ms it leaves out the host work."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            parts[name] = e.self_device_time_total / reps / 1e3
    total = sum(parts.values())
    return (total if total > 0 else None), parts


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4g} ms"


def bound(nbytes, ops, ops_per_ms=F32_OPS_PER_MS):
    """The least time (ms) the card could take to move ``nbytes`` and do
    ``ops`` operations at ``ops_per_ms`` (default: f32 on CUDA cores), and
    which of the two sets it."""
    b, o = nbytes / HBM_BYTES_PER_MS, ops / ops_per_ms
    return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o else
            "operations"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def p50_query_ms(service, images, n=30, warm=5):
    """Median host-clock latency of a batch-1 service.query, top-10."""
    lat = []
    for j in range(n):
        t0 = time.perf_counter()
        service.query([images[j % len(images)]], topk=10)
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat[warm:])


def scenes(rng, n):
    """uint8 (n, H, W, 3) images: smooth random colour fields (a random
    grid of 2..24 rows, bilinearly upsampled) plus pixel noise. White noise
    alone gives a random network nearly one descriptor for every image."""
    out = []
    for _ in range(n):
        gh = rng.randint(2, 25)
        small = rng.randint(0, 256, (gh, gh * 4 // 3, 3)).astype(np.uint8)
        img = np.asarray(Image.fromarray(small).resize((W, H), Image.BILINEAR),
                         np.int16) + rng.randint(-20, 21, (H, W, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def same_top10(d_a, i_a, d_b, i_b, what, tie=1e-5):
    """Two top-10 results agree: per query the same set of rows, and the
    sorted distances within ``tie``. Rows whose distances lie within ``tie``
    of each other may swap ranks (f32 sums in another order); those swaps
    are counted."""
    sets = all(set(a) == set(b) for a, b in zip(i_a.tolist(), i_b.tolist()))
    gap = float((d_a - d_b).abs().max())
    swaps = int((i_a != i_b).sum())
    return (sets and gap < tie,
            f"{what}: same top-10 rows, distances within {gap:.3g} "
            f"(< {tie}), {swaps} rank swaps among near-ties")


def same_top10_up_to_cut(d_a, i_a, d_b, i_b, what, tie):
    """Like same_top10, but a row may also be swapped for another across
    the 10th place when its distance lies within ``tie`` of the 10th."""
    d_a, i_a, d_b, i_b = (t.cpu() for t in (d_a, i_a, d_b, i_b))
    gap = float((d_a - d_b).abs().max())
    ok, cut = gap < tie, 0
    for da, ia, db, ib in zip(d_a, i_a.tolist(), d_b, i_b.tolist()):
        for pos, i in enumerate(ia):
            if i not in ib:
                cut += 1
                ok = ok and abs(float(da[pos]) - float(db[-1])) < tie
    return (ok, f"{what}: same top-10 rows, distances within {gap:.3g} "
                f"(< {tie}), {cut} swapped across the 10th among near-ties")


def reference_state(model):
    """The port model as a reference-layout torch state dict (.pth)."""
    from openibl_tpu_torch.models.convert import TORCH_VGG16_CONV_INDEX

    sd = {}
    for idx, name in TORCH_VGG16_CONV_INDEX.items():
        conv = getattr(model.base, name)
        sd[f"base_model.base.{idx}.weight"] = conv.weight.detach().cpu() \
            .contiguous()
        sd[f"base_model.base.{idx}.bias"] = conv.bias.detach().cpu()
    nv, pca = model.net_vlad, model.pca_layer
    sd["net_vlad.conv.weight"] = nv.assign_w.detach().t().cpu()[:, :, None,
                                                                None].contiguous()
    sd["net_vlad.centroids"] = nv.centroids.detach().cpu()
    sd["pca_layer.weight"] = pca.w.detach().t().cpu()[:, :, None,
                                                      None].contiguous()
    sd["pca_layer.bias"] = pca.b.detach().cpu()
    return sd


def build_kernels(card):
    """One nvcc per source, all started together."""
    from openibl_tpu_torch.ops import _build

    def one(name):
        t0 = time.perf_counter()
        _build.load_library(name, KERNELS[name])
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        done = list(pool.map(one, KERNELS))
    print(f"phase build: {len(done)} kernels in parallel, "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    for name, secs in done:
        lib_path = _build.library_path(name, KERNELS[name])
        print(f"  {osp.relpath(lib_path, ROOT)}: {secs:.2f} s [{card}]")
        with open(lib_path[:-3] + ".log") as f:
            print("".join(f"  ptxas: {ln}" for ln in f if "Used" in ln
                          or "spill" in ln or "smem" in ln
                          or "arning" in ln), end="")


def check_sass(card, label, lib_name, ops, must, what):
    """A kernel library's SASS, where the toolkit has cuobjdump: the count
    of each opcode of ``ops``, then ``check(must(counts), what)``."""
    from openibl_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not osp.isfile(tool):
        print(f"  {label} SASS: no cuobjdump on this machine [{card}]")
        return
    lib = _build.library_path(lib_name, KERNELS[lib_name])
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
    print(f"  {label} SASS ({osp.basename(lib)}): " + ", ".join(
        f"{k} {v}" for k, v in counts.items()) + f" [{card}]")
    check(must(counts), what)


def k3_sass(card):
    """K3's SASS: int8 wgmma (IGMMA) fed by TMA (UTMALDG, UTMASTG), no
    mma.sync int8 (IMMA)."""
    check_sass(card, "K3", "quant_conv", ("IGMMA", "UTMALDG", "UTMASTG",
                                          "IMMA"),
               lambda c: c["IGMMA"] > 0 and c["UTMALDG"] > 0
               and c["IMMA"] == 0,
               "K3 runs int8 wgmma fed by TMA (IGMMA, UTMALDG) and no "
               "mma.sync (IMMA)")


def k4_sass(card):
    """K4's SASS: TF32 wgmma (HGMMA) fed by TMA (UTMALDG, UTMASTG), no
    mma.sync (HMMA)."""
    check_sass(card, "K4", "conv_f32", ("HGMMA", "UTMALDG", "UTMASTG",
                                        "HMMA"),
               lambda c: c["HGMMA"] > 0 and c["UTMALDG"] > 0
               and c["HMMA"] == 0,
               "K4 runs wgmma fed by TMA (HGMMA, UTMALDG) and no mma.sync "
               "(HMMA)")


def gate_ratio(out, ref, rtol=RTOL, atol=ATOL):
    """max |out - ref| / (atol + rtol |ref|): at most 1 passes the gate."""
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())


def check_k1(dev, card, seed):
    """K1 against its plain version at the main-path shape, at a ragged P
    and at K = 17; its bits repeat from run to run, and it tracks its
    split-precision arithmetic run in plain PyTorch (products in f64)
    within a tenth of the gate."""
    from openibl_tpu_torch.ops import netvlad_kernel as nk

    g = torch.Generator(device=dev).manual_seed(seed)
    fmap = torch.randn((N_IMG, 30, 40, 512), generator=g, device=dev)
    assign_w = torch.randn((512, 64), generator=g, device=dev) * 2
    cent = torch.rand((64, 512), generator=g, device=dev)
    ragged = torch.randn((4, 30, 41, 512), generator=g, device=dev)
    w17 = torch.randn((512, 17), generator=g, device=dev) * 2
    cent17 = torch.rand((17, 512), generator=g, device=dev)
    max_err = 0.0
    cases = [(fmap, assign_w, cent, post) for post in (False, True)]
    cases += [(ragged, w, c, True) for w, c in ((assign_w, cent),
                                                (w17, cent17))]
    for dtype in (torch.float32, torch.bfloat16):
        for f, w, c, post in cases:
            x = f.to(dtype)
            out = nk.netvlad_fused(x, w, c, postprocess=post)
            again = nk.netvlad_fused(x, w, c, postprocess=post)
            ref = nk.netvlad_plain(x, w, c, postprocess=post)
            emu = nk.netvlad_split_emulation(x, w, c, postprocess=post)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            max_err = max(max_err, err)
            torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
            r_plain, r_emu = gate_ratio(out, ref), gate_ratio(out, emu)
            check(torch.equal(out, again) and r_emu < 0.1,
                  f"K1 == plain head, {str(dtype)[6:]} fmap "
                  f"{tuple(x.shape)}, K={w.shape[1]}, postprocess={post}, "
                  f"max_abs_err={err:.3g} (rtol {RTOL}, atol {ATOL}; "
                  f"{r_plain:.4f} of that gate, {r_emu:.4f} of it from the "
                  f"split-precision emulation, < 0.1); a second run gives "
                  f"the same bits")
    def k1():
        return nk.netvlad_fused(fmap, assign_w, cent, postprocess=True)

    k1_ms = cuda_ms(k1)
    plain_ms = cuda_ms(lambda: nk.netvlad_plain(fmap, assign_w, cent,
                                                postprocess=True))
    fb = fmap.to(torch.bfloat16)
    k1_bf16_ms = cuda_ms(lambda: nk.netvlad_fused(fb, assign_w, cent,
                                                  postprocess=True))
    plain_bf16_ms = cuda_ms(lambda: nk.netvlad_plain(fb, assign_w, cent,
                                                     postprocess=True))
    # f32 with postprocess: each of the two products (logits x·W and the
    # aggregation aᵀx) is N·HW·C·K multiply-adds; fmap, weights and the
    # (N, K, C) output each cross HBM once. Both products run on the tensor
    # cores in split precision, 3 TF32 products each for an f32 fmap (3 bf16
    # ones for bf16): that is the restated bound. The products as f32 on
    # CUDA cores give a larger bound, printed beside it
    n, hw, c, k = N_IMG, 30 * 40, 512, 64
    flops = 2 * 2 * n * hw * c * k
    io = nbytes(fmap, assign_w, cent) + n * k * c * 4
    b = bound(io, 3 * flops, TF32_OPS_PER_MS)
    b_cores = bound(io, flops)
    b16 = bound(io - nbytes(fmap) // 2, 3 * flops, BF16_OPS_PER_MS)
    # the scratch, measured: the peak allocation of one call less its output
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k1()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base - n * k * c * 4
    print(f"timing K1 (16,30,40,512) f32 postprocess: kernel {k1_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}: 3 TF32 products at 495 TFLOP/s; as f32 on "
          f"CUDA cores {b_cores['bound_ms']:.4f} ms), scratch {scratch} "
          f"bytes (peak allocation of a call less its output; the layout's "
          f"{nk.scratch_bytes(n, hw, c, k)}) | bf16: kernel "
          f"{k1_bf16_ms:.4f} ms, plain {plain_bf16_ms:.4f} ms, bound "
          f"{b16['bound_ms']:.4f} ms ({b16['bound_by']}: 3 bf16 products at "
          f"989 TFLOP/s) [{card}]")
    entry = {"max_abs_err": max_err, "ms": k1_ms, "plain_ms": plain_ms, **b,
             "library_ms": None}
    bf16_entry = {"ms": k1_bf16_ms, **b16}
    return entry, [("K1 (16,30,40,512) f32 postprocess", k1, entry),
                   ("K1 (16,30,40,512) bf16 postprocess",
                    lambda: nk.netvlad_fused(fb, assign_w, cent,
                                             postprocess=True), bf16_entry)]


def check_k2(dev, card, seed):
    """K2 against its plain version: m=64, ksub=256, 1 and 16 queries, over
    1M codes, a ragged N and the served gallery's 100k, f32 and bf16 LUT."""
    from openibl_tpu_torch.ops import pq_kernel as pk

    g = torch.Generator(device=dev).manual_seed(seed + 2)
    codes_all = torch.randint(0, 256, (K2_ROWS[0], PQ_M), generator=g,
                              device=dev, dtype=torch.uint8)
    luts = {q: torch.rand((PQ_M, q, 256), generator=g, device=dev) * 0.1
            for q in (1, 3, 16, 17)}
    max_err = 0.0
    for n in K2_ROWS:
        codes = codes_all[:n]
        for q, lut in luts.items():
            if q in (3, 17) and n == K2_ROWS[0]:
                continue  # Q=3 and 17 at the ragged N and at 100k
            for precise in (True, False):
                out = pk.adc_tile(lut, codes, precise=precise)
                ref = pk.adc_tile_plain(lut, codes, precise=precise)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                max_err = max(max_err, err)
                torch.testing.assert_close(out, ref, rtol=K2_TOL, atol=K2_TOL)
                check(True, f"K2 == plain scorer, Q={q} N={n} m={PQ_M} "
                            f"ksub=256 precise={precise}, max_abs_err="
                            f"{err:.3g} (rtol/atol {K2_TOL})")
    times = {}
    for n in (K2_ROWS[0], GALLERY):
        codes = codes_all[:n]
        for q in (1, 16):
            lut = luts[q]
            for precise in (False, True):
                k = cuda_ms(lambda: pk.adc_tile(lut, codes, precise))
                p = cuda_ms(lambda: pk.adc_tile_plain(lut, codes, precise))
                times[n, q, precise] = (k, p)
                print(f"timing K2 Q={q} N={n} "
                      f"{'f32' if precise else 'bf16'} LUT: kernel "
                      f"{k:.4f} ms, plain {p:.4f} ms "
                      f"({n * PQ_M / k / 1e6:.1f} GB/s of codes) [{card}]")
    # the served PQ path's launch: one query, the 100k-row gallery, bf16 LUT;
    # codes and LUT read once, (Q, N) f32 written once, m adds per row
    k2_ms, plain_ms = times[GALLERY, 1, False]
    b = bound(nbytes(codes_all[:GALLERY], luts[1]) + GALLERY * 4,
              GALLERY * PQ_M)
    b16 = bound(nbytes(codes_all, luts[16]) + 16 * K2_ROWS[0] * 4,
                16 * K2_ROWS[0] * PQ_M)
    lut1, codes = luts[1], codes_all[:GALLERY]
    print(f"bound K2 Q=1 N={GALLERY}: {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}); Q=16 N={K2_ROWS[0]}: {b16['bound_ms']:.4f} ms "
          f"({b16['bound_by']}) [{card}]")
    entry = {"max_abs_err": max_err, "ms": k2_ms, "plain_ms": plain_ms, **b,
             "library_ms": None}
    codes_1m, lut16 = codes_all, luts[16]
    q16 = {"ms": times[K2_ROWS[0], 16, False][0], **b16}
    return entry, [(f"K2 Q=1 N={GALLERY} bf16 LUT",
                    lambda: pk.adc_tile(lut1, codes), entry),
                   (f"K2 Q=16 N={K2_ROWS[0]} bf16 LUT",
                    lambda: pk.adc_tile(lut16, codes_1m), q16)]


def probe_library_call(key, args, kw):
    """One PyTorch call computing the probe's function, as a yardstick
    (the port never calls it): (description, zero-argument callable)."""
    if key in ("P1", "P2"):
        x, width = args[0], kw["width"]
        return "torch.flip of the (R, pieces, width) view", (
            lambda: torch.flip(x.view(x.shape[0], -1, width), [1]))
    if key == "P3":
        x, ones = args[0][None, None], args[0].new_ones((1, 1, 3, 1))
        return "F.conv2d with a (3, 1) kernel of ones", (
            lambda: torch.nn.functional.conv2d(x, ones))
    if key == "P4":
        return "torch.maximum on strided views", (
            lambda: torch.maximum(args[0][0::2], args[0][1::2]))
    if key == "P5":
        return "torch.matmul", lambda: torch.matmul(*args)
    idx = args[1].long()
    if key == "P6":
        return "torch.take_along_dim", (
            lambda: torch.take_along_dim(args[0], idx, dim=1))
    return "lut[:, idx]", lambda: args[0][:, idx[0]]


def probe_ops(key, args, out):
    """The f32 operations a probe's function needs on these inputs."""
    if key == "P3":
        return 2 * out.numel()  # two adds per output
    if key == "P4":
        return out.numel()  # one max per output
    if key == "P5":
        return 2 * args[0].numel() * args[1].shape[1]  # M·K·N FMAs
    # P1, P2 and P6 move data only. P7 computes the gather lut[:, idx]: its
    # one-hot product is the kernel's way there, not work the function needs
    return 0


def check_probes(dev, card):
    """(e) The Mosaic layout probes P1-P7: each row run through the port's
    probe tool on the card as its own path (all probe counts 0 just before,
    its count read just after), the tool's command once, then each kernel
    against its plain version on the same inputs on the card, timed beside
    its plain version, its bound and one library call. Returns their
    entries of the kernels line and their calls for device_times."""
    from openibl_tpu_torch.tools import mosaic_probe as mp

    wrappers = {p.kernel for p in mp.PROBES}
    out = {}
    for p in mp.PROBES:
        for w in wrappers:
            w.launches = 0  # the probe's path starts
        name, status, _ = p.run(dev)
        launches = p.kernel.launches  # the probe's path ends
        check(status == "OK" and launches >= 1,
              f"{p.key} '{name}' through the probe tool: {status}, "
              f"{launches} launch(es)")
        out[p.key] = {"name": f"mosaic_probe {p.key} {name}", "route": "cuda",
                      "source": "openibl_tpu_torch/csrc/mosaic_probe.cu",
                      "replaces": f"scripts/mosaic_probe.py:{p.site}",
                      "launches": launches}
    check(mp.main(["--device", "cuda"]) == 0,
          "python -m openibl_tpu_torch.tools.mosaic_probe: every row OK")
    device_calls = []
    for p in mp.PROBES:
        args = p.tensors(dev)
        got = p.kernel(*args, **p.kwargs)
        ref = p.plain(*args, **p.kwargs)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(p.agrees(got, ref),
              f"{p.key} kernel == plain "
              + ("bit for bit" if p.atol == 0 else
                 f"within atol {p.atol} (the script's; f32 sums in another "
                 f"order)") + f", max_abs_err={err:.3g}")
        what, lib = probe_library_call(p.key, args, p.kwargs)
        lib_same = torch.allclose(lib().reshape(got.shape), got, rtol=1e-5,
                                  atol=1e-4)

        def kernel(p=p, args=args):
            return p.kernel(*args, **p.kwargs)

        k_ms = cuda_ms(kernel)
        plain_ms = cuda_ms(lambda: p.plain(*args, **p.kwargs))
        lib_ms = cuda_ms(lib)
        b = bound(nbytes(*args, got), probe_ops(p.key, args, got))
        print(f"timing {p.key} '{p.name}' "
              f"{[tuple(a.shape) for a in args]}: kernel {k_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, {what} {lib_ms:.4f} ms (same "
              f"values: {lib_same}), bound {b['bound_ms']:.3g} ms "
              f"({b['bound_by']}); launch-bound toy size [{card}]")
        out[p.key].update(max_abs_err=err, ms=k_ms, plain_ms=plain_ms, **b,
                          library_ms=lib_ms)
        device_calls.append((f"{p.key} '{p.name}'", kernel, out[p.key]))
        device_calls.append((f"{p.key} yardstick {what}", lib,
                             out[p.key], "library_device_ms"))
    return list(out.values()), device_calls


def check_probes_k2(dev, card, seed):
    """P6 and P7 at a K2-sized shape, for K2's next inner loop: one query's
    LUT at m=64, ksub=256 (64, 256) f32; P6 gathers it with the served
    gallery's PQ codes transposed, (64, 100000) int32, P7 with one row of
    them, (1, 100000). Each bit for bit against its plain version, timed
    beside its plain version, yardstick and bytes bound (P7 also beside its
    design's own tensor-core work). Timing only: these are not rows of the
    probe tool nor entries of the kernels line. Returns their calls for
    device_times."""
    from openibl_tpu_torch.tools import mosaic_probe as mp

    g = torch.Generator(device=dev).manual_seed(seed + 3)
    lut = torch.randn((PQ_M, 256), generator=g, device=dev)
    codes = torch.randint(0, 256, (PQ_M, GALLERY), generator=g, device=dev,
                          dtype=torch.int32)
    calls = []
    for key, kernel, plain, args in (
            ("P6", mp.take_lut, mp.take_lut_plain, (lut, codes)),
            ("P7", mp.onehot_dot, mp.onehot_dot_plain, (lut, codes[:1]))):
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, ref),
              f"{key} kernel == plain bit for bit at K2's shape "
              f"{[tuple(a.shape) for a in args]}")
        what, lib = probe_library_call(key, args, {})

        def call(kernel=kernel, args=args):
            return kernel(*args)

        entry = {"max_abs_err": float((got - ref).abs().max()),
                 "ms": cuda_ms(call), "plain_ms": cuda_ms(lambda: plain(*args)),
                 "library_ms": cuda_ms(lib), **bound(nbytes(*args, got), 0)}
        design = ""
        if key == "P7":  # its 3 bf16 products, the design's own work
            entry["design_ms"] = (3 * 2 * lut.numel() * args[1].numel()
                                  / BF16_OPS_PER_MS)
            design = (f", its 3 bf16 products {entry['design_ms']:.4g} ms at "
                      f"989 TFLOP/s (at most "
                      f"{entry['bound_ms'] / entry['design_ms']:.1%} of the "
                      f"bound by construction)")
        print(f"timing {key} at K2's shape {[tuple(a.shape) for a in args]}: "
              f"kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms,"
              f" {what} {entry['library_ms']:.4f} ms, bound "
              f"{entry['bound_ms']:.4g} ms ({entry['bound_by']}){design} "
              f"[{card}]")
        calls.append((f"{key} at K2's shape", call, entry))
        calls.append((f"{key} at K2's shape, yardstick {what}", lib, entry,
                      "library_device_ms"))
    return calls


def launch_floor(dev):
    """The card's launch floor: the device time (profiler, 100 launches) of
    csrc/mosaic_probe.cu's empty kernel, one warp and no memory access,
    launched through ops/_build.launch. Not a port of a TPU kernel."""
    from openibl_tpu_torch.ops._build import launch
    from openibl_tpu_torch.tools import mosaic_probe as mp

    dev = torch.empty(0, device=dev).device  # with its index

    def empty():
        launch(empty, mp._lib().mosaic_empty, dev)

    empty.launches = 0
    return device_ms(empty, reps=100)[0]


def restate_bound(entry, floor):
    """Raise ``entry``'s bound to the launch floor where the floor is the
    larger (``bound_by`` then reads ``launch floor``); returns the
    bytes/operations bound it had."""
    raw = entry["bound_ms"], entry["bound_by"]
    if floor > raw[0]:
        entry.update(bound_ms=floor, bound_by="launch floor")
    return raw


def enqueue_times(calls, card, n=200):
    """Host time to enqueue one call of each kernel (host clock over ``n``
    calls, no synchronise inside), stored as ``enqueue_ms``: the wrapper's
    checks, its allocations, the ctypes call and the launch. Taken before
    any profiler session."""
    for what, fn, entry, *key in calls:
        if key:
            continue
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        entry["enqueue_ms"] = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        print(f"host {what}: {entry['enqueue_ms']:.4f} ms to enqueue a call "
              f"(host clock, {n} calls) [{card}]")


def device_times(calls, dev, card):
    """The launch floor first; then each kernel's device time
    (torch.profiler) beside its per-call time and its bound restated with
    the floor, stored in its entry as ``device_ms``; a yardstick's (a call
    of four) as ``library_device_ms`` of its probe's entry. Taken after
    every timed phase: a profiler session may leave host cost on the
    launches that follow it."""
    # the first profiler session of a process recorded no kernel on the
    # H100: one throwaway session first
    device_ms(lambda: torch.ones(1, device="cuda").add_(1), reps=1)
    floor = launch_floor(dev)
    check(floor is not None, "the empty kernel's device time is traced")
    print(f"floor: empty kernel {floor:.4g} ms on the device [{card}]")
    for what, fn, entry, *key in calls:
        ms, parts = device_ms(fn)
        if key:  # a yardstick: <name>_device_ms beside its <name>_ms
            entry[key[0]] = ms
            per_call = entry[key[0].replace("device_ms", "ms")]
            print(f"device {what}: {fmt_ms(ms)} (profiler); per call "
                  f"{per_call:.4f} ms [{card}]")
            continue
        entry["device_ms"] = ms
        raw_ms, raw_by = restate_bound(entry, floor)
        share = "" if ms is None else (
            f", {entry['bound_ms'] / ms:.3%} of bound on the device, "
            f"{entry['bound_ms'] / entry['ms']:.3%} per call; per call "
            f"minus device {entry['ms'] - ms:.4f} ms (host work)")
        if ms is not None and "design_ms" in entry:
            share += (f"; its design's work caps the share at "
                      f"{entry['bound_ms'] / entry['design_ms']:.1%}")
        print(f"device {what}: {fmt_ms(ms)} (profiler); per call "
              f"{entry['ms']:.4f} ms, bound {entry['bound_ms']:.3g} ms "
              f"({entry['bound_by']}; bytes/operations {raw_ms:.3g} ms, "
              f"{raw_by}){share} [{card}]")
        if len(parts) > 1:
            print(f"  its kernels: " + ", ".join(
                f"{k} {v:.4g} ms" for k, v in parts.items()) + f" [{card}]")


def build_indexes(gallery, desc, dev, card):
    """(b) The index family over the device gallery, built on the card, and
    pq_search through K2 against pq_search through the plain scorer (the
    same call on CPU copies)."""
    from openibl_tpu_torch.ops.ivf import build_ivf
    from openibl_tpu_torch.ops.pq import build_ivfpq, build_pq, pq_search

    built = {}
    for name, fn in (
            ("pq", lambda: build_pq(gallery, m=PQ_M)),
            # OPQ at D=4096: one D x D SVD per outer iteration, so one
            # iteration keeps the build to seconds
            ("opq", lambda: build_pq(gallery, m=PQ_M, opq_iters=1)),
            ("ivf", lambda: build_ivf(gallery, nlist=NLIST)),
            ("ivfpq", lambda: build_ivfpq(gallery, nlist=NLIST, m=PQ_M))):
        t0 = time.perf_counter()
        built[name] = fn()
        torch.cuda.synchronize()
        print(f"phase index build {name}: {time.perf_counter() - t0:.2f} s, "
              + ", ".join(f"{k} {v.shape}" for k, v in built[name].items())
              + f" [{card}]")
    pq, opq, ivf, ivfpq = (built[k] for k in ("pq", "opq", "ivf", "ivfpq"))
    for p in (pq, opq):
        check(p["pq_codes"].shape == (GALLERY, PQ_M)
              and p["pq_codes"].dtype == np.uint8
              and p["pq_codebooks"].shape == (PQ_M, 256, DIM // PQ_M),
              f"PQ payload: codes {p['pq_codes'].shape} uint8, codebooks "
              f"{p['pq_codebooks'].shape}")
    rot = opq["pq_rotation"]
    r64 = rot.astype(np.float64)
    orth = float(np.abs(r64 @ r64.T - np.eye(DIM)).max())
    check(orth < 1e-3,
          f"OPQ rotation is orthogonal: |R R^T - I| = {orth:.3g} (< 1e-3)")
    for name, lists in (("ivf", ivf["lists"]), ("ivfpq", ivfpq["ivf_lists"])):
        check(lists.shape[0] == NLIST
              and np.array_equal(np.sort(lists[lists >= 0]),
                                 np.arange(GALLERY)),
              f"{name}: {NLIST} cells x {lists.shape[1]} partition the "
              f"{GALLERY} rows")
    print(f"  IVFADC cells equal build_ivf's: "
          f"{np.array_equal(ivf['lists'], ivfpq['ivf_lists'])} [{card}]")
    # K2 vs the plain scorer through pq_search. The two LUTs come from f32
    # products in another order (~1e-6 apart): 1e-5 with the f32 LUT; with
    # the bf16 LUT an entry may round to the neighbouring bf16 value (one
    # ulp, ~2.4e-4 at ~0.03), so 1e-3 there
    for name, p, r in (("PQ", pq, None), ("OPQ", opq, rot)):
        codes_dev = torch.from_numpy(p["pq_codes"]).to(dev)
        codes_cpu = torch.from_numpy(p["pq_codes"])
        for precise, tie in ((True, 1e-5), (False, 1e-3)):
            d_k2, i_k2 = pq_search(desc, codes_dev, p["pq_codebooks"], k=10,
                                   precise=precise, rotation=r)
            d_pl, i_pl = pq_search(desc.cpu(), codes_cpu, p["pq_codebooks"],
                                   k=10, precise=precise, rotation=r)
            check(*same_top10_up_to_cut(
                d_k2, i_k2, d_pl, i_pl,
                f"{name} pq_search K2 vs plain scorer, {len(desc)} queries, "
                f"precise={precise}", tie))
    return built


def serve_modes(index, built, weights, images, rows, dev, card, serve_torch):
    """(c) Each served mode of the index family through a RetrievalService,
    PQ also through the HTTP handler; the kernels' counts cover its queries
    only. Returns (per-mode results, K2 launches over the served modes)."""
    from http.server import ThreadingHTTPServer

    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops import pq_kernel as pk
    from openibl_tpu_torch.serving import RetrievalService

    paths, desc = index["paths"], index["descriptors"]
    pq, opq, ivf, ivfpq = (built[k] for k in ("pq", "opq", "ivf", "ivfpq"))
    # name: (index, service options, top-n the planted row must reach,
    #        whether the path runs K2)
    modes = {
        "pq": ({"paths": paths, **opq}, {"use_pq": True}, 10, True),
        "ivfadc": ({"paths": paths, **ivfpq},
                   {"use_pq": True, "ivf_nprobe": NPROBE}, 10, False),
        "pq_rerank": ({"descriptors": desc, "paths": paths, **pq},
                      {"pq_rerank": SHORTLIST}, 1, True),
        "ivf": ({"descriptors": desc, "paths": paths,
                 "ivf_centroids": ivf["centroids"],
                 "ivf_lists": ivf["lists"]},
                {"ivf_nprobe": NPROBE}, 1, False),
    }
    out, k2_launches = {}, 0
    for name, (idx, kw, gate, runs_k2) in modes.items():
        t0 = time.perf_counter()
        service = RetrievalService(idx, weights=weights, height=H, width=W,
                                   device=dev, **kw)
        service.warmup()
        torch.cuda.synchronize()
        print(f"phase serve {name}: {kw}, built and warmed in "
              f"{time.perf_counter() - t0:.2f} s over {service.index_size} "
              f"rows [{card}]")
        nk.netvlad_fused.launches = pk.adc_tile.launches = 0  # path starts
        if name == "pq":
            server = ThreadingHTTPServer(("127.0.0.1", 0),
                                         serve_torch.make_handler(service))
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            try:
                base = f"http://127.0.0.1:{server.server_address[1]}"
                for j in range(2):
                    buf = io.BytesIO()
                    Image.fromarray(images[j]).save(buf, format="PNG")
                    req = urllib.request.Request(base + "/query?topk=10",
                                                 data=buf.getvalue(),
                                                 method="POST")
                    with urllib.request.urlopen(req, timeout=120) as r:
                        got = [m["index"] for m in
                               json.loads(r.read())["matches"]]
                    row = int(rows[j])
                    rank = got.index(row) + 1 if row in got else None
                    check(rank is not None, f"HTTP /query pq image {j}: "
                                            f"planted row {row} at rank {rank}")
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=60)
        results = service.query(list(images), topk=10)
        k1, k2 = nk.netvlad_fused.launches, pk.adc_tile.launches  # path ends
        ids = [[m["index"] for m in r] for r in results]
        recall = [float(np.mean([int(rows[j]) in ids[j][:n]
                                 for j in range(len(ids))]))
                  for n in (1, 5, 10)]
        print(f"  {name}: Recall@1/5/10 = {recall} over {len(ids)} planted "
              f"queries; launches K1 {k1}, K2 {k2} [{card}]")
        check(all(len(r) == 10 and [m["rank"] for m in r] == list(
                  range(1, 11)) for r in results),
              f"{name}: 10 matches per query, ranks 1..10")
        check(recall[(1, 5, 10).index(gate)] == 1.0,
              f"{name}: the planted row is in every query's top-{gate}")
        check(k1 > 0, f"{name}: K1 launched {k1} times on the served path")
        if runs_k2:
            check(k2 > 0, f"{name}: K2 launched {k2} times on the served "
                          f"path")
            k2_launches += k2
        out[name] = {"recall": recall, "results": results,
                     "p50_ms": p50_query_ms(service, images)}
        del service
        torch.cuda.empty_cache()
    return out, k2_launches


def time_searches(gallery, desc, built, dev, card):
    """(d) pq_search (K2) against the exact topk_nearest, per call, at
    batch 1 and 16 over the 100k gallery."""
    from openibl_tpu_torch.ops.distance import topk_nearest
    from openibl_tpu_torch.ops.pq import pq_search

    codes = torch.from_numpy(built["pq"]["pq_codes"]).to(dev)
    cb = torch.from_numpy(built["pq"]["pq_codebooks"]).to(dev)
    for b in (1, 16):
        q = desc[:b].contiguous()
        pq_ms = cuda_ms(lambda: pq_search(q, codes, cb, k=10))
        ex_ms = cuda_ms(lambda: topk_nearest(q, gallery, k=10))
        print(f"timing search batch {b}, top-10 of {GALLERY}: pq_search "
              f"(m={PQ_M}, K2) {pq_ms:.4f} ms, exact topk_nearest (f32) "
              f"{ex_ms:.4f} ms, per call, CUDA events [{card}]")


def tf32_gap(model, imgs_dev, gallery, card):
    """(g) What cuDNN's TF32 does to an f32 descriptor at 480x640: the
    planted images' descriptors with ``torch.backends.cudnn.allow_tf32`` as
    PyTorch ships it (True) and off, through the model's parts called
    directly (no f32 scope) and through the entry point ``model(x)``
    (EmbedNetPCA.forward, inside utils.f32_precision); for each the VLAD
    (32768-d) and PCA (4096-d) gaps against the JAX package's f32 gate, and
    the top-10 change over the 100k gallery. The entry point's descriptor
    must be bit-equal with the flag on and off (the check that guards the
    f32 scope); the parts' gap is printed, not gated."""
    from openibl_tpu_torch.ops.distance import topk_nearest

    cudnn = torch.backends.cudnn
    shipped = cudnn.allow_tf32

    def parts(x):
        vlad = model.net_vlad.descriptor(model.base(x)[1])
        return vlad, model.pca_layer(vlad)

    def run_with(flag, fn):
        cudnn.allow_tf32 = flag
        try:
            with torch.inference_mode():
                outs = [fn(imgs_dev[s:s + N_IMG])
                        for s in range(0, len(imgs_dev), N_IMG)]
        finally:
            cudnn.allow_tf32 = shipped
        if isinstance(outs[0], tuple):
            return [torch.cat(o) for o in zip(*outs)]
        return [None, torch.cat(outs)]

    for what, fn in (("model parts, no scope", parts),
                     ("entry point model(x)", model)):
        on, off = run_with(True, fn), run_with(False, fn)
        gaps = []
        for name, a, b in (("VLAD 32768-d", on[0], off[0]),
                           ("PCA 4096-d", on[1], off[1])):
            if a is None:
                continue
            gaps.append(f"{name} max |gap| {float((a - b).abs().max()):.3g}"
                        f" ({gate_ratio(a, b):.3g} of the rtol {RTOL} / atol "
                        f"{ATOL} gate)")
        d_on, i_on = topk_nearest(on[1], gallery, k=10)
        d_off, i_off = topk_nearest(off[1], gallery, k=10)
        changed = sum(set(a) != set(b) for a, b in zip(i_on.tolist(),
                                                       i_off.tolist()))
        swaps = int((i_on != i_off).sum())
        top1 = int((i_on[:, 0] != i_off[:, 0]).sum())
        print(f"tf32 {what}: allow_tf32 {shipped} (as shipped) vs False: "
              + "; ".join(gaps) + f"; top-10 over {GALLERY}: {changed} of "
              f"{len(i_on)} queries' sets changed, {swaps} rank changes, "
              f"{top1} top-1 changes [{card}]")
        if what.startswith("entry"):
            check(torch.equal(on[1], off[1]),
                  "the entry point's f32 descriptor does not depend on the "
                  "global TF32 flag (EmbedNetPCA.forward runs in f32)")


def record_k3(fn):
    """Run ``fn`` with ops/quant.py's int8_conv recording each call: a list
    of (x, wq, scale, bias, kwargs, out), synchronized."""
    from openibl_tpu_torch.ops import quant

    calls, launch = [], quant.int8_conv

    def recorded(x, wq, scale, bias, **kw):
        out = launch(x, wq, scale, bias, **kw)
        calls.append((x, wq, scale, bias, kw, out))
        return out

    quant.int8_conv = recorded
    try:
        with torch.inference_mode():
            fn()
    finally:
        quant.int8_conv = launch
    torch.cuda.synchronize()
    return calls


def hold_k3(calls, what):
    """Each recorded K3 call against its plain version on the same inputs,
    bit for bit. Returns the largest |difference| (0 when it holds)."""
    from openibl_tpu_torch.ops import quant_kernel as qk

    err = 0.0
    for x, wq, scale, bias, kw, out in calls:
        ref = qk.int8_conv_plain(x, wq, scale, bias, **kw)
        err = max(err, float((out.double() - ref.double()).abs().max()))
        check(out.dtype == ref.dtype and torch.equal(out, ref),
              f"K3 == plain, bit for bit, {what}: {tuple(x.shape)} -> "
              f"{tuple(out.shape)} {str(out.dtype)[6:]}, {kw['mode']}, "
              f"relu={kw['relu']}")
    return err


def quant_phase(model, index, weights, images, rows, desc_f32, rates, dev,
                card, seed):
    """(i) The int8 backbone (ops/quant.py) at full width: a RetrievalService
    with quant_backbone=True over the served gallery, calibrated on four
    scenes() frames. K3 against its plain version, bit for bit, at the
    eleven quantized layers' shapes at 480x640 (batch 1, the served model's
    own activations, f32 and bf16 prefix), a second run, a ragged odd
    extent through the masked forward and quant_from="conv1_1" (Cin = 3,
    padded); the planted rows at top-1 (K1's and K3's counts 0 just before
    the queries, read just after); the conv5_3 map against the f32
    model's (the JAX package's map gates), each int8 descriptor's nearest
    f32 one, and the VLAD and PCA descriptors' cosines (printed);
    extraction img/s with an f32 and a bf16 prefix; the exact query p50;
    each layer's K3 time at batch 16 and at batch 1 (the served query's
    shape) with its geometry, beside its bound, its plain version, two
    yardsticks (torch._int_mm on the im2col GEMM shape, im2col not timed;
    cuDNN's bf16 convolution) and, beside K3's persistent grid, the time of
    one block a tile. Returns (K1 launches, K3 launches, K3's largest
    error, the per-layer calls for the device times)."""
    import torch.nn.functional as F

    from openibl_tpu_torch.models.vgg import VGG16_LAYERS
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops import quant
    from openibl_tpu_torch.ops import quant_kernel as qk
    from openibl_tpu_torch.serving import RetrievalService
    from openibl_tpu_torch.utils import f32_precision

    rng = np.random.RandomState(seed + 9)
    t0 = time.perf_counter()
    service = RetrievalService(index, weights=weights, height=H, width=W,
                               device=dev, quant_backbone=True,
                               calib_images=scenes(rng, 4))
    service.warmup()
    torch.cuda.synchronize()
    qmodel, qbase = service._model, service._model.base
    print(f"phase quant: quant_backbone service (calibrated on 4 frames) "
          f"built and warmed in {time.perf_counter() - t0:.2f} s over "
          f"{service.index_size} rows; prefix {qbase.quant_from} "
          f"{str(qbase.compute_dtype)[6:]} [{card}]")
    check(qbase.conv4_2.wq.dtype == torch.int8,
          "the quantized service's backbone is int8 (conv4_2.wq)")

    # -- K3 against its plain version at the main path's shapes -------------
    one = torch.from_numpy(images[:1]).to(dev)
    first = record_k3(lambda: qbase(one))
    n_layers = len(VGG16_LAYERS) - 2
    check(len(first) == n_layers, f"a quantized forward launches K3 "
                                  f"{len(first)} times (conv2_1..conv5_3)")
    err = hold_k3(first, f"{H}x{W} batch 1, f32 prefix")
    again = record_k3(lambda: qbase(one))
    check(all(torch.equal(a[-1], b[-1]) for a, b in zip(first, again)),
          "K3: a second run gives the same bits at every layer")
    qbase.compute_dtype = torch.bfloat16
    err = max(err, hold_k3(record_k3(lambda: qbase(one)),
                           f"{H}x{W} batch 1, bf16 prefix"))
    qbase.compute_dtype = torch.float32
    ragged = np.zeros((2, H, W, 3), np.uint8)
    ragged[0, :H - 3, :W - 9] = images[1, :H - 3, :W - 9]
    ragged[1] = images[2]
    valid = torch.tensor([[H - 3, W - 9], [H, W]], device=dev)
    err = max(err, hold_k3(record_k3(lambda: qmodel.forward_masked(
        torch.from_numpy(ragged).to(dev), valid)),
        f"masked, extents ({H - 3}, {W - 9}) and ({H}, {W})"))
    conv1 = quant.QuantVGG16(
        quant.quantize_vgg16(model.base, scenes(rng, 2),
                             quant_from="conv1_1"),
        quant_from="conv1_1", compute_dtype=torch.float32).to(dev)
    calls = record_k3(lambda: conv1(one))
    check(len(calls) == n_layers + 2 and calls[0][0].shape[-1] == 3,
          f"quant_from=conv1_1: {len(calls)} K3 launches, the first on "
          f"Cin = 3")
    err = max(err, hold_k3(calls, "quant_from=conv1_1"))
    del first, again, calls, conv1
    torch.cuda.empty_cache()

    # -- the served path: planted rows, launches ----------------------------
    with k4_counted("serve_exact_quant"):
        nk.netvlad_fused.launches = qk.int8_conv.launches = 0  # path starts
        results = service.query(list(images), topk=10)
        k1, k3 = nk.netvlad_fused.launches, qk.int8_conv.launches  # ends
    top1 = float(np.mean([r[0]["index"] == int(rows[j])
                          for j, r in enumerate(results)]))
    print(f"  quant: planted top-1 {top1} over {len(results)} queries; "
          f"launches K1 {k1}, K3 {k3} [{card}]")
    check(top1 == 1.0, "quant service: every planted row at top-1")
    check(k1 > 0 and k3 == n_layers * k1,
          f"quant service: K3 launched {k3} times, {n_layers} a forward, "
          f"K1 {k1} times on the served path")
    # fidelity against the f32 model on the same queries, at each level
    imgs_dev = torch.from_numpy(images).to(dev)

    def levels(m):
        with torch.inference_mode(), f32_precision():
            out = []
            for s in range(0, len(images), N_IMG):
                fmap = m.base(imgs_dev[s:s + N_IMG])[1].float()
                vlad = m.net_vlad.descriptor(fmap)
                out.append((fmap, vlad, m.pca_layer(vlad)))
        return [torch.cat(t) for t in zip(*out)]

    (f32_map, f32_vlad, f32_pca), (q_map, q_vlad, q_pca) = (levels(model),
                                                            levels(qmodel))
    check(torch.allclose(f32_pca, desc_f32, rtol=0, atol=1e-4),
          "the f32 model's parts give the served f32 descriptors")
    rel = float((f32_map - q_map).norm() / f32_map.norm())
    mcos = float((f32_map * q_map).sum() / (f32_map.norm() * q_map.norm()))
    check(rel < 0.08 and mcos > 0.995,
          f"int8 vs f32 conv5_3 map: rel {rel:.4f} (< 0.08), cosine "
          f"{mcos:.6f} (> 0.995), tests/test_quant.py's map gates")
    own = (q_pca @ f32_pca.t()).argmax(dim=1).cpu()
    check(torch.equal(own, torch.arange(len(images))),
          "every int8 descriptor's nearest f32 descriptor is its own image's")
    vcos, pcos = (q_vlad * f32_vlad).sum(1), (q_pca * f32_pca).sum(1)
    print(f"  quant: int8 vs f32 descriptor cosine: VLAD 32768-d min "
          f"{float(vcos.min()):.6f} median {float(vcos.median()):.6f}; "
          f"served PCA 4096-d min {float(pcos.min()):.6f} median "
          f"{float(pcos.median()):.6f} (tests/test_quant.py's 0.999 holds "
          f"for a random NetVLAD, whose centroids outweigh the map; this "
          f"NetVLAD is bootstrapped from conv5 clusters and its PCA centred, "
          f"which both amplify the int8 error) [{card}]")

    # -- rates --------------------------------------------------------------
    batch = imgs_dev[:N_IMG]
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            qbase.compute_dtype = dtype
            ms = cuda_ms(lambda: qmodel(batch), reps=10, warmup=2)
            name = (f"descriptor_images_per_sec_per_chip_{H}x{W}_"
                    f"{str(dtype)[6:]}_int8_bs{N_IMG}")
            print(f"timing extraction {name}: {N_IMG / ms * 1e3:.2f} img/s "
                  f"({ms:.3f} ms/batch; without int8 "
                  f"{rates[dtype]:.2f} img/s) [{card}]")
        qbase.compute_dtype = torch.float32
    p50 = p50_query_ms(service, images)
    print(f"timing service.query exact quant_backbone batch 1, top-10 of "
          f"{GALLERY}: p50 {p50:.3f} ms (host clock, 25 queries) [{card}]")

    # -- K3 per layer at batch 16 and at batch 1 (the served query) --------
    shapes, h, w = [], H, W
    for name, cin, cout, relu, pool in VGG16_LAYERS:
        if name not in ("conv1_1", "conv1_2"):
            shapes.append((name, h, w, cin, cout, relu))
        if pool:
            h, w = h // 2, w // 2
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    big = max(N_IMG * s[1] * s[2] * s[3] for s in shapes)
    x_all = torch.randint(0, 128, (big,), generator=g, device=dev,
                          dtype=torch.int8)
    xb_all = x_all.to(torch.bfloat16)
    a_all = torch.randint(-128, 128, (9 * big,), generator=g, device=dev,
                          dtype=torch.int8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    calls = []
    for batch in (N_IMG, 1):
        for name, h, w, cin, cout, relu in shapes:
            layer = getattr(qbase, name)
            scale, bias = (layer.m, layer.bq) if hasattr(layer, "m") else \
                (layer.sxsw, layer.b)
            kw = ({"mode": "requant", "relu": relu} if hasattr(layer, "m")
                  else {"mode": "dequant", "relu": relu})
            m = batch * h * w
            x = x_all[:m * cin].view(batch, h, w, cin)
            wq = layer.wq
            a = a_all[:m * 9 * cin].view(m, 9 * cin)
            b = wq.reshape(cout, 9 * cin).t()
            xb = xb_all[:m * cin].view(batch, h, w, cin).permute(0, 3, 1, 2)
            wb = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)

            def launch_k3(x=x, wq=wq, scale=scale, bias=bias, kw=kw):
                return qk.int8_conv(x, wq, scale, bias, **kw)

            out_nbytes = 1 if kw["mode"] == "requant" else 4
            geo = qk.conv_geometry(batch, h, w, cin, cout, sms, out_nbytes)
            io = nbytes(x, wq, scale, bias) + m * cout * out_nbytes
            ops = 2 * m * 9 * cin * cout
            entry = {"layer": name, "batch": batch,
                     "geometry": (f"{geo.th}x{geo.tw} BN {geo.bn} BK "
                                  f"{geo.bk}{' halo' if geo.halo else ''}"
                                  f"{' pingpong' if geo.pingpong else ''} "
                                  f"S {geo.stages} grid {geo.blocks}"),
                     "ms": cuda_ms(launch_k3),
                     "plain_ms": cuda_ms(lambda: qk.int8_conv_plain(
                         x, wq, scale, bias, **kw), reps=3, warmup=1),
                     "int_mm_ms": cuda_ms(lambda: torch._int_mm(a, b)),
                     "cudnn_bf16_ms": cuda_ms(lambda: F.conv2d(
                         xb, wb, padding=1)),
                     **bound(io, ops, INT8_OPS_PER_MS)}
            # one block a tile, in the same run, beside the persistent grid
            # (at most one block an SM walking the tiles) K3 runs
            tgeo = qk.conv_geometry(batch, h, w, cin, cout, sms, out_nbytes,
                                    persistent=False)
            entry["one_a_tile_ms"] = cuda_ms(
                lambda: qk._launch(x, wq, scale, bias, kw["mode"],
                                   kw["relu"], torch.float32, geometry=tgeo))
            what = f"K3 {name} ({batch},{h},{w},{cin})->{cout}"
            print(f"timing {what}: kernel {entry['ms']:.4f} ms "
                  f"({entry['geometry']}; one block a tile, grid "
                  f"{tgeo.blocks}: {entry['one_a_tile_ms']:.4f} ms), plain "
                  f"{entry['plain_ms']:.4f} ms, torch._int_mm ({m}, "
                  f"{9 * cin}, {cout}) {entry['int_mm_ms']:.4f} ms, cuDNN "
                  f"bf16 conv {entry['cudnn_bf16_ms']:.4f} ms, bound "
                  f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
                  f"{ops / 1e9:.1f} G int8 ops at 1,979 TOPS, "
                  f"{io / 1e6:.1f} MB at 3.35 TB/s) [{card}]")
            calls += [(what, launch_k3, entry),
                      (f"{what}, yardstick torch._int_mm",
                       lambda a=a, b=b: torch._int_mm(a, b), entry,
                       "int_mm_device_ms"),
                      (f"{what}, yardstick cuDNN bf16 conv",
                       lambda xb=xb, wb=wb: F.conv2d(xb, wb, padding=1),
                       entry, "cudnn_bf16_device_ms")]
    del service
    torch.cuda.empty_cache()
    return k1, k3, err, calls


def k3_entry(calls):
    """K3's kernels-line entry: the sums over one quantized forward's eleven
    launches at batch 16 (per call, device, plain, yardsticks, bounds), the
    same sums at batch 1 (the served query's shape) under ``batch1``, and
    each layer's geometry at both."""
    def sums(batch):
        entries = [c[2] for c in calls if len(c) == 3
                   and c[2]["batch"] == batch]

        def total(key):
            vals = [e.get(key) for e in entries]
            return None if any(v is None for v in vals) else sum(vals)

        by_ops = sum(e["bound_ms"] for e in entries if e["bound_by"] ==
                     "operations")
        return {"ms": total("ms"), "plain_ms": total("plain_ms"),
                "bound_ms": total("bound_ms"),
                "bound_by": "operations" if by_ops >= total("bound_ms") / 2
                else "bytes",
                "library_ms": None, "device_ms": total("device_ms"),
                "enqueue_ms": total("enqueue_ms"),
                "one_a_tile_ms": total("one_a_tile_ms"),
                "int_mm_ms": total("int_mm_ms"),
                "int_mm_device_ms": total("int_mm_device_ms"),
                "cudnn_bf16_ms": total("cudnn_bf16_ms"),
                "cudnn_bf16_device_ms": total("cudnn_bf16_device_ms"),
                "geometry": {e["layer"]: e["geometry"] for e in entries},
                "per": f"one quantized forward at batch {batch}, {H}x{W}: "
                       f"{len(entries)} launches, summed"}

    return {**sums(N_IMG), "batch1": sums(1)}


def k4_split_error(y, x, wt, b, relu):
    """max over outputs of |y - the f64 convolution| / (the output's sum of
    |x| * |w| + |b|): tests/test_torch_conv_kernel.py's measure."""
    import torch.nn.functional as F

    def conv(a, k, c):
        return F.conv2d(a.double().permute(0, 3, 1, 2), k.double(),
                        c.double(), padding=1).permute(0, 2, 3, 1)

    ref = conv(x, wt, b)
    if relu:
        ref = ref.clamp_min(0)
    scale = conv(x.abs(), wt.abs(), b.abs())
    err = float(((y.double() - ref).abs() / scale).max())
    del ref, scale
    return err


K4_LAUNCHES = {}  # K4's launches on each main-path run, by path


@contextlib.contextmanager
def k4_counted(path):
    """K4's launches on a main-path run: the count set to 0 at entry, read
    at exit into ``K4_LAUNCHES[path]`` and held to what the run's forwards
    launch: each f32 VGG16 forward on the card, every convolution before
    the first whose weight needs a gradient (13 with none, 10 in a step
    that trains conv5), and each quantized forward's f32 prefix (the layers
    before ``quant_from``: 2)."""
    from openibl_tpu_torch.models.vgg import VGG16, VGG16_LAYERS
    from openibl_tpu_torch.ops import conv_kernel as ck
    from openibl_tpu_torch.ops.quant import QuantVGG16

    names = [layer[0] for layer in VGG16_LAYERS]
    want = [0]
    vgg_forward, quant_forward = VGG16.forward, QuantVGG16.forward

    def f32_on_card(module, images):
        return images.is_cuda and module.compute_dtype == torch.float32

    def vgg(self, images, *args, **kwargs):
        if f32_on_card(self, images):
            grads = [torch.is_grad_enabled()
                     and getattr(self, name).weight.requires_grad
                     for name in names]
            want[0] += grads.index(True) if any(grads) else len(names)
        return vgg_forward(self, images, *args, **kwargs)

    def quant(self, images, *args, **kwargs):
        if f32_on_card(self, images):
            want[0] += names.index(self.quant_from)
        return quant_forward(self, images, *args, **kwargs)

    VGG16.forward, QuantVGG16.forward = vgg, quant
    ck.conv3x3_f32.launches = 0  # the path starts
    try:
        yield
    finally:
        VGG16.forward, QuantVGG16.forward = vgg_forward, quant_forward
    launches = K4_LAUNCHES[path] = ck.conv3x3_f32.launches  # path ends
    check(launches == want[0] > 0,
          f"K4 launched {launches} times on the {path} path, as its "
          f"forwards launch ({want[0]})")


def k4_phase(dev, card, seed):
    """K4 at the main path's shapes: each of conv1_1..conv5_3 at 480x640
    (conv1_1's 3 channels padded to 32 by the wrapper, the padding timed
    with it) on seeded post-ReLU inputs and Kaiming weights, at batch 16 and
    1, held to
    the f64 convolution (within 2e-6 of each output's sum of |x| * |w| +
    |b|, tests/test_torch_conv_kernel.py's SPLIT_TOL; cuDNN's f32 and TF32
    errors printed beside), timed (CUDA events) beside its plain version
    (cuDNN f32 + ReLU, TF32 off), cuDNN's f32 convolution (TF32 off, one
    call: the yardstick, never called by the port) and every forced
    geometry. Returns (the per-layer rows, the calls for phase 10's
    device times)."""
    import torch.nn.functional as F

    from openibl_tpu_torch.models.vgg import VGG16_LAYERS
    from openibl_tpu_torch.ops import conv_kernel as ck
    from openibl_tpu_torch.utils import f32_precision

    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    layers, h, w = [], H, W
    for name, cin, cout, relu, pool in VGG16_LAYERS:
        layers.append((name, cin, cout, relu, h, w))
        if pool:
            h, w = h // 2, w // 2

    def inputs(n, hh, ww, cin, cout):
        x = torch.relu(torch.randn(n, hh, ww, cin, generator=gen,
                                   device=dev)) * 2
        wt = torch.randn(cout, cin, 3, 3, generator=gen, device=dev) * (
            2 / (9 * cin)) ** 0.5
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        return x, wt, b

    def cudnn(xc, wt, b):
        with f32_precision():
            return F.conv2d(xc, wt, b, padding=1)

    print(f"phase K4: f32 3x3 convolutions in split TF32 at {H}x{W} "
          f"[{card}]", flush=True)
    rows, calls = [], []
    for n in (N_IMG, 1):
        for name, cin, cout, relu, hh, ww in layers:
            x, wt, b = inputs(n, hh, ww, cin, cout)
            xc = x.permute(0, 3, 1, 2)
            y = ck.conv3x3_f32(x, wt, b, relu=relu)
            again = ck.conv3x3_f32(x, wt, b, relu=relu)
            torch.cuda.synchronize()
            check(torch.equal(y, again), f"K4 {name} batch {n}: the same "
                  f"bits on a second run")
            err = k4_split_error(y, x, wt, b, relu)
            with f32_precision():
                plain = ck.conv3x3_plain(x, wt, b, relu=relu)
            plain_err = k4_split_error(plain, x, wt, b, relu)
            prev = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            tf32 = ck.conv3x3_plain(x, wt, b, relu=relu)
            torch.backends.cudnn.allow_tf32 = prev
            tf32_err = k4_split_error(tf32, x, wt, b, relu)
            del y, again, plain, tf32
            check(err <= 2e-6, f"K4 {name} batch {n} ({n},{hh},{ww},{cin})"
                  f"->{cout}: error {err:.3g} of the sum of |x * w| "
                  f"(cuDNN f32 {plain_err:.3g}, TF32 {tf32_err:.3g})")
            cin_k = ck._padded(cin)  # conv1_1: 3 channels run as 32
            geo = ck.conv_geometry(n, hh, ww, cin_k, cout, sms)

            def k4(x=x, wt=wt, b=b, relu=relu):
                return ck.conv3x3_f32(x, wt, b, relu=relu)

            def plain_fn(x=x, wt=wt, b=b, relu=relu):
                with f32_precision():
                    return ck.conv3x3_plain(x, wt, b, relu=relu)

            ms = cuda_ms(k4)
            forced = {}
            for th, tw, bn in ck.TILES:
                if cout % bn:
                    continue
                ty, tx = -(-hh // th), -(-ww // tw)
                st = ck.conv_stages(th, tw, bn)
                tiles = n * ty * tx * (cout // bn)
                g = ck.ConvGeometry(th, tw, ty, tx, bn, st, min(tiles, sms),
                                    ck.conv_smem_bytes(th, tw, bn, st))
                forced[f"{th}x{tw}/{bn}"] = cuda_ms(
                    lambda g=g: ck._launch(x, wt, b, relu, geometry=g),
                    reps=5, warmup=1)
            best = min(forced, key=forced.get)
            ops = 2 * 9 * n * hh * ww * cin * cout
            moved = 4 * (n * hh * ww * (cin + cout) + 9 * cin * cout + cout)
            entry = {"layer": name, "batch": n, "ms": ms,
                     "plain_ms": cuda_ms(plain_fn),
                     "cudnn_f32_ms": cuda_ms(lambda: cudnn(xc, wt, b)),
                     "error": err, "cudnn_f32_error": plain_err,
                     "tf32_error": tf32_err,
                     "geometry": f"{geo.th}x{geo.tw}/{geo.bn} "
                                 f"s{geo.stages} b{geo.blocks}",
                     "best_forced": f"{best} {forced[best]:.4f} ms",
                     "forced_ms": {k: round(v, 4) for k, v in forced.items()},
                     "tflops": ops / ms / 1e9, "ops": ops, "bytes": moved,
                     **bound(moved, ops, TF32_OPS_PER_MS)}
            rows.append(entry)
            print(f"  K4 {name} batch {n}: {ms:.4f} ms ({entry['tflops']:.1f}"
                  f" TFLOP/s of f32 work), {entry['geometry']}; best forced "
                  f"{entry['best_forced']}; plain {entry['plain_ms']:.4f} ms,"
                  f" cuDNN f32 {entry['cudnn_f32_ms']:.4f} ms; bound "
                  f"{entry['bound_ms']:.4f} ms [{card}]", flush=True)
            print(f"    forced: {entry['forced_ms']} [{card}]")
            calls.append((f"K4 {name} batch {n}", k4, entry))
            calls.append((f"cuDNN f32 {name} batch {n}",
                          lambda xc=xc, wt=wt, b=b: cudnn(xc, wt, b), entry,
                          "cudnn_f32_device_ms"))
    return rows, calls


def k4_entry(layers):
    """K4's kernels-line entry: the sums over one f32 forward's thirteen
    launches at batch 16 and, under ``batch1``, at batch 1, with the
    per-layer rows."""
    def sums(batch):
        rows = [r for r in layers if r["batch"] == batch]

        def total(key):
            vals = [r.get(key) for r in rows]
            return None if any(v is None for v in vals) else sum(vals)

        ops, moved = total("ops"), total("bytes")
        out = {"ms": total("ms"), "plain_ms": total("plain_ms"),
               "library_ms": total("cudnn_f32_ms"),
               "device_ms": total("device_ms"),
               "library_device_ms": total("cudnn_f32_device_ms"),
               **bound(moved, ops, TF32_OPS_PER_MS),
               "per": f"one f32 forward's conv1_1..conv5_3 at batch "
                      f"{batch}, {H}x{W}: {len(rows)} launches, summed"}
        if out["device_ms"]:
            out["share"] = out["bound_ms"] / out["device_ms"]
        return out

    return {**sums(N_IMG), "batch1": sums(1), "layers": layers}


def k5_sass(card):
    """K5's SASS: TF32 wgmma (HGMMA) fed by TMA (UTMALDG), no mma.sync
    (HMMA)."""
    check_sass(card, "K5", "linear_f32", ("HGMMA", "UTMALDG", "HMMA"),
               lambda c: c["HGMMA"] > 0 and c["UTMALDG"] > 0
               and c["HMMA"] == 0,
               "K5 runs wgmma fed by TMA (HGMMA, UTMALDG) and no mma.sync "
               "(HMMA)")


def k5_error(y, x, w, b):
    """max over outputs of |y - the f64 product| / (the output's sum of
    |x| * |w| + |b|): tests/test_torch_linear_kernel.py's measure."""
    import torch.nn.functional as F

    ref = F.linear(x.double(), w.double(), b.double())
    scale = F.linear(x.double().abs(), w.double().abs(), b.double().abs())
    err = float(((y.double() - ref).abs() / scale).max())
    del ref, scale
    return err


# AnyLoc's ViT-g/14 linears: (name, K, N, launches a forward); token rows an
# image: 1531, the facet's value rows 1530 (the patch tokens)
K5_LINEARS = (("qkv", 1536, 4608, 31), ("proj", 1536, 1536, 31),
              ("w12", 1536, 8192, 31), ("w3", 4096, 1536, 31),
              ("facet_value", 1536, 1536, 1))


def k5_phase(dev, card, seed):
    """K5 at AnyLoc's shapes: each ViT linear at batch 16 and 1 on seeded
    activations N(0, 1) and weights N(0, 0.02), held to the f64 product
    (within 2e-6 of each output's sum of |x| * |w| + |b|, and no worse
    there than cuBLAS's f32 GEMM), timed (CUDA events) beside its plain
    version (``F.linear``, TF32 off) and ``torch.matmul`` on the same
    operands (one call, TF32 off: the yardstick, never called by the port);
    then K5's launches on the AnyLoc extract path (the
    published model through ``extract_features``: 125 a forward). Returns
    (the per-shape rows, the calls for phase 10's device times)."""
    import torch.nn.functional as F

    from openibl_tpu_torch.hub import anyloc_dinov2_vitg14
    from openibl_tpu_torch.ops import linear_kernel as lk
    from openibl_tpu_torch.parallel.extract import extract_features
    from openibl_tpu_torch.utils import f32_precision

    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"phase K5: AnyLoc's ViT linears in split TF32 [{card}]",
          flush=True)
    rows, calls = [], []
    for n_img in (N_IMG, 1):
        for name, k, n, per_forward in K5_LINEARS:
            m = n_img * (1530 if name == "facet_value" else 1531)
            x = torch.randn(m, k, generator=gen, device=dev)
            w = torch.randn(n, k, generator=gen, device=dev) * 0.02
            b = torch.randn(n, generator=gen, device=dev) * 0.02
            y = lk.linear_f32(x, w, b)
            again = lk.linear_f32(x, w, b)
            torch.cuda.synchronize()
            check(torch.equal(y, again), f"K5 {name} batch {n_img}: the "
                  f"same bits on a second run")
            err = k5_error(y, x, w, b)

            def plain_fn(x=x, w=w, b=b):
                with f32_precision():
                    return lk.linear_plain(x, w, b)

            def matmul_fn(x=x, w=w):
                with f32_precision():
                    return torch.matmul(x, w.T)

            plain_err = k5_error(plain_fn(), x, w, b)
            del y, again
            check(err <= 2e-6 and err <= plain_err,
                  f"K5 {name} batch {n_img} ({m},{k})x({n},{k}): error "
                  f"{err:.3g} of the sum of |x * w| (cuBLAS f32 "
                  f"{plain_err:.3g})")

            def k5(x=x, w=w, b=b):
                return lk.linear_f32(x, w, b)

            ms = cuda_ms(k5)
            ops = 2 * m * k * n
            moved = 4 * (m * (k + n) + n * k + n)
            entry = {"layer": name, "batch": n_img, "m": m, "k": k, "n": n,
                     "per_forward": per_forward, "ms": ms,
                     "plain_ms": cuda_ms(plain_fn),
                     "matmul_ms": cuda_ms(matmul_fn), "error": err,
                     "cublas_f32_error": plain_err,
                     "blocks": lk.linear_blocks(m, n, sms),
                     "tflops": ops / ms / 1e9, "ops": ops, "bytes": moved,
                     **bound(moved, ops, TF32_OPS_PER_MS)}
            rows.append(entry)
            print(f"  K5 {name} batch {n_img}: {ms:.4f} ms "
                  f"({entry['tflops']:.1f} TFLOP/s of f32 work), "
                  f"{entry['blocks']} blocks; plain "
                  f"{entry['plain_ms']:.4f} ms, torch.matmul "
                  f"{entry['matmul_ms']:.4f} ms; bound "
                  f"{entry['bound_ms']:.4f} ms [{card}]", flush=True)
            calls.append((f"K5 {name} batch {n_img}", k5, entry))
            calls.append((f"torch.matmul {name} batch {n_img}", matmul_fn,
                          entry, "matmul_device_ms"))

    # the main path: the published model through the index build's entry
    model = anyloc_dinov2_vitg14(device=dev)
    frames = np.random.RandomState(seed).randint(0, 256, (2, H, W, 3),
                                                  dtype=np.uint8)
    loader = [(frames, np.arange(2 * i, 2 * i + 2), 2) for i in range(2)]
    lk.linear_f32.launches = 0
    with torch.inference_mode():
        desc = extract_features(model.eval(), loader, sort=False)
    launches = lk.linear_f32.launches
    check(desc.shape == (4, 49152) and launches == 2 * 125,
          f"K5 launched {launches} times on the AnyLoc extract path "
          f"(2 forwards, 125 linears each)")
    del model
    torch.cuda.empty_cache()
    return rows, calls, launches


def k5_entry(rows):
    """K5's kernels-line entry: the sums over one AnyLoc forward's 125
    linears (each shape's time by its launches a forward) at batch 16 and,
    under ``batch1``, at batch 1, with the per-shape rows."""
    def sums(batch):
        these = [r for r in rows if r["batch"] == batch]

        def total(key):
            vals = [r.get(key) for r in these]
            return None if any(v is None for v in vals) else sum(
                r["per_forward"] * v for r, v in zip(these, vals))

        ops, moved = total("ops"), total("bytes")
        out = {"ms": total("ms"), "plain_ms": total("plain_ms"),
               "library_ms": total("matmul_ms"),
               "device_ms": total("device_ms"),
               "library_device_ms": total("matmul_device_ms"),
               **bound(moved, ops, TF32_OPS_PER_MS),
               "per": f"one AnyLoc forward's 125 linears at batch {batch}, "
                      f"summed"}
        if out["device_ms"]:
            out["share"] = out["bound_ms"] / out["device_ms"]
        return out

    return {**sums(N_IMG), "batch1": sums(1), "layers": rows}


def tuples_tie_equal(ours, theirs, qf, gf, n_q, tie=5e-3):
    """Mined tuples agree anchor by anchor; a differing positive, or a
    differing negative at one rank, must be a distance tie (sq-dist gap
    < ``tie`` in ``qf``/``gf``'s space), the JAX oracle's test
    (tests/test_e2e.py:421-441). Returns the number of tie swaps."""
    a_ours, a_theirs = {t[0]: t for t in ours}, {t[0]: t for t in theirs}
    if set(a_ours) != set(a_theirs):
        return None
    swaps = 0
    for a, to in a_ours.items():
        tt = a_theirs[a]
        ids = sorted(set(to[1:]) | set(tt[1:]))
        d = dict(zip(ids, ((qf[a][None] - gf[np.asarray(ids) - n_q]) ** 2)
                     .sum(1).tolist()))
        pairs = [(to[1], tt[1])] + list(zip(sorted(to[2:], key=d.get),
                                            sorted(tt[2:], key=d.get)))
        for x, y in pairs:
            if x != y:
                if abs(d[x] - d[y]) >= tie:
                    return None
                swaps += 1
    return swaps


def train_phase(dev, card, seed, tmp):
    """(f) The training slice at full width on the card: a synthetic world
    at 480x640 (24 places x 4 images) under ``tmp`` (the SFRS phase reuses
    it and the centroid cache), the full-width EmbedNet (VGG16,
    K=64) from seeded weights with NetVLAD bootstrapped by
    pipeline.bootstrap_centroids, then pipeline.run_baseline_training for
    one epoch (SARE-ind, tuples of 1 + 1 + 10, 4 a step, 3 steps),
    validation eval and the final PCA eval. K1's count is 0 just before the
    run and read just after. Then its checks: K1 on a mining batch, the
    tuples mined from K1's descriptors against the plain head's, the
    losses, the frozen layers, one step on the card against the CPU.
    Returns K1's launches in the run and the run itself for the mesh
    training phase: its config, the initial parameters, the step losses,
    the final parameters (f64 on the CPU) and the recalls."""
    import copy

    from openibl_tpu_torch.config import DataConfig, TrainConfig
    from openibl_tpu_torch.data.loader import ImageSource
    from openibl_tpu_torch.data.sampler import TupleSampler
    from openibl_tpu_torch.data.synthetic import SyntheticDataset
    from openibl_tpu_torch.data.transforms import TestTransform
    from openibl_tpu_torch.engine import pipeline
    from openibl_tpu_torch.engine.trainer import Trainer
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.parallel.extract import make_extract_fn
    from openibl_tpu_torch.utils import f32_precision
    from openibl_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    world = SyntheticDataset(osp.join(tmp, "data", "synthetic"),
                             img_size=(H, W), seed=seed)
    print(f"phase train: synthetic world at {H}x{W}, "
          f"{len(world.q_train)} train queries, {len(world.db_train)} "
          f"train gallery images, in {time.perf_counter() - t0:.2f} s "
          f"(host) [{card}]")
    cfg = TrainConfig(
        data=DataConfig(dataset="synthetic", scale=None,
                        data_dir=osp.join(tmp, "data"), height=H,
                        width=W, test_batch_size=N_IMG),
        loss_type="sare_ind", tuple_size=TRAIN_TS, neg_num=TRAIN_NEG,
        iters=TRAIN_ITERS, epochs=1, print_freq=100, seed=seed,
        logs_dir=osp.join(tmp, "logs"), init_dir=osp.join(tmp, "logs"))
    dataset = pipeline.load_dataset(cfg)
    t0 = time.perf_counter()
    # the run's own initial state: seeded weights, and the centroid
    # cache bootstrap_centroids writes here and the run reads
    before = {k: v.detach().clone() for k, v in pipeline.build_model(
        cfg, dataset, dev).state_dict().items()}
    torch.cuda.synchronize()
    print(f"phase train: seeded EmbedNet (K=64) + bootstrap_centroids "
          f"in {time.perf_counter() - t0:.2f} s [{card}]")

    losses = []
    step = Trainer.step

    def counted_step(self, images, generator=None):
        losses.append(step(self, images, generator))
        return losses[-1]

    timer = PhaseTimer(dev)
    Trainer.step = counted_step
    t0 = time.perf_counter()
    try:
        with k4_counted("train"):
            nk.netvlad_fused.launches = 0  # the training path starts
            model, final, history = pipeline.run_baseline_training(
                cfg, device=dev, verbose=False, timer=timer)
            launches = nk.netvlad_fused.launches  # the training path ends
    finally:
        Trainer.step = step
    wall = time.perf_counter() - t0
    print(f"phase train: run_baseline_training in "
          f"{wall:.2f} s; val recall@1/5/10 "
          f"{[list(map(float, r)) for _, r in history]}, PCA test "
          f"recall@1/5/10 {list(map(float, final))}; K1 launches "
          f"{launches} [{card}]")
    print("  " + timer.summary().replace("\n", "\n  ") + f" [{card}]")
    check(launches > 0, f"K1 launched {launches} times on the training "
                        f"path (mining, validation, PCA fit, test)")
    losses = [float(x) for x in losses]
    single = dict(cfg=cfg, before={k: v.cpu() for k, v in before.items()},
                  losses=losses, history=history, final=final, wall=wall,
                  after={k: v.detach().cpu().double()
                         for k, v in model.state_dict().items()})
    check(len(losses) == TRAIN_ITERS and all(np.isfinite(losses)),
          f"{len(losses)} train steps of {TRAIN_TS} tuples x "
          f"{2 + TRAIN_NEG} images, every loss finite: {losses}")
    check(len(history) == 1 and len(final) == 3
          and all(0 <= float(r) <= 1 for r in final),
          "one validation eval and Recall@1/5/10 of the PCA test eval")
    after = model.state_dict()
    frozen = [k for k in before if k.startswith("base.conv")
              and not k.startswith("base.conv5")]
    moved = [k for k in before if k not in frozen]
    check(all(torch.equal(before[k], after[k]) for k in frozen)
          and all(not torch.equal(before[k], after[k]) for k in moved),
          f"conv1_1..conv4_3 bit-equal to their values before training "
          f"({len(frozen)} tensors); conv5_* and NetVLAD moved "
          f"({len(moved)} tensors)")
    # K1 on one mining batch of the trained model
    src = ImageSource(dataset.q_train + dataset.db_train,
                      dataset.images_dir,
                      TestTransform(H, W, device_normalize=True))
    n_q = len(dataset.q_train)
    batch = torch.from_numpy(np.stack(
        [src.load(n_q + i) for i in range(N_IMG)])).to(dev)
    with torch.inference_mode(), f32_precision():
        fmap = model.base(batch)[1]
        nv = model.net_vlad
        got = nk.netvlad_fused(fmap, nv.assign_w, nv.centroids,
                               postprocess=True)
        ref = nk.netvlad_plain(fmap, nv.assign_w, nv.centroids,
                               postprocess=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    check(True, f"K1 == plain head on a mining batch {tuple(fmap.shape)}"
                f" of the trained model, max_abs_err "
                f"{float((got - ref).abs().max()):.3g} ({gate_ratio(got, ref):.4f}"
                f" of the rtol {RTOL} / atol {ATOL} gate)")

    # tuples mined from K1's descriptors and from the plain head's
    subset = np.arange(n_q)
    mined, feats = [], []
    for view in (pipeline.eval_view(model), model):
        g = pipeline._extract(view, ImageSource(
            dataset.db_train, dataset.images_dir, src.transform), cfg,
            "vlad")
        q = pipeline._extract(view, ImageSource(
            dataset.q_train, dataset.images_dir, src.transform), cfg,
            "vlad")
        sampler = TupleSampler(n_q, len(dataset.db_train),
                               dataset.train_pos, dataset.train_neg,
                               neg_num=TRAIN_NEG, neg_pool=cfg.neg_pool,
                               seed=cfg.seed)
        sampler.set_epoch(cfg.seed)
        mined.append(sampler.refresh(q, g, subset))
        feats.append((q.cpu().numpy(), g.cpu().numpy()))
    swaps = tuples_tie_equal(mined[0], mined[1], *feats[1], n_q)
    check(swaps is not None,
          f"tuples mined from K1's descriptors == from the plain head's "
          f"for {n_q} anchors x (1 + {TRAIN_NEG}), up to ties (sq-dist "
          f"gap < 5e-3): {swaps} tie swaps")

    # the mining extraction's rate, steady: the 32-image train gallery
    # through pipeline._extract (BatchLoader, eval_view) MINE_REPS times
    # after a warm-up pass; beside it the decode alone (host, one
    # thread, as BatchLoader's producer) and the device alone (the
    # decoded batches, H2D included)
    emodel = pipeline.eval_view(model)
    gsrc = ImageSource(dataset.db_train, dataset.images_dir,
                       src.transform)
    n_g = len(gsrc)
    passes = []
    for _ in range(1 + MINE_REPS):
        t0 = time.perf_counter()
        pipeline._extract(emodel, gsrc, cfg, "vlad")
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    passes = passes[1:]
    t0 = time.perf_counter()
    for _ in range(MINE_REPS):
        decoded = [gsrc.load(i) for i in range(n_g)]
    decode_s = (time.perf_counter() - t0) / MINE_REPS
    fwd = make_extract_fn(emodel)
    batches = [np.stack(decoded[s:s + N_IMG])
               for s in range(0, n_g, N_IMG)]
    with torch.no_grad():
        dev_ms = cuda_ms(lambda: [fwd(torch.from_numpy(b).to(dev))
                                  for b in batches],
                         reps=MINE_REPS, warmup=1)
    print(f"timing mining extraction {H}x{W} batch {N_IMG}, {n_g} "
          f"gallery images, {MINE_REPS} passes after a warm-up: "
          f"{n_g / statistics.median(passes):.2f} img/s end to end "
          f"(pipeline._extract, host clock to a synchronize, PNG decode "
          f"included; passes {', '.join(f'{x:.4f}' for x in passes)} "
          f"s); decode alone {n_g / decode_s:.2f} img/s (PIL, one "
          f"thread, host clock); device alone "
          f"{n_g / dev_ms * 1e3:.2f} img/s (VGG16 f32 + K1 on decoded "
          f"batches, H2D included, CUDA events) [{card}]")
    del emodel, decoded, batches

    # one step on the card against the same step on the CPU
    tup = np.stack([src.load(i) for i in mined[1][0]])[None]
    steps, models_ = [], []
    t0 = time.perf_counter()
    for where in (dev, torch.device("cpu")):
        m = copy.deepcopy(model).to(where)
        tr = Trainer(m, loss_type=cfg.loss_type, margin=cfg.margin,
                     lr=cfg.lr, momentum=cfg.momentum,
                     weight_decay=cfg.weight_decay)
        tr.init()
        steps.append(float(tr.step(tup)))
        models_.append({k: v.detach().cpu() for k, v in
                        m.state_dict().items()})
    print(f"  card vs CPU step on one tuple {tup.shape}: "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    rel = abs(steps[0] - steps[1]) / abs(steps[1])
    ok, worst = rel < 1e-4, 0.0
    for k in moved:
        old = after[k].detach().cpu()
        a, b = models_[0][k], models_[1][k]
        ulp = float(np.spacing(np.float32(old.abs().max())))
        ok = ok and torch.allclose(a, b, rtol=1e-3, atol=1e-7)
        up_a, up_b = a - old, b - old
        err = float(((up_a - up_b).abs() / (1e-3 * up_b.abs().max()
                                             + ulp + 1e-3 * up_b.abs()))
                    .max())
        worst = max(worst, err)
    check(ok and worst <= 1.0,
          f"one train step on the card (f32, TF32 off) == on the CPU: "
          f"loss {steps[0]:.7g} vs {steps[1]:.7g} (rel {rel:.2g} < 1e-4),"
          f" updated parameters within rtol 1e-3, updates at "
          f"{worst:.3g} of rtol 1e-3 of each layer's largest")

    # the train step's rate: 4 tuples x 12 images a step, on a copy
    m = copy.deepcopy(model)
    tr = Trainer(m, loss_type=cfg.loss_type, margin=cfg.margin,
                 lr=cfg.lr)
    tr.init()
    tuples = np.stack([np.stack([src.load(i) for i in t])
                       for t in mined[1][:TRAIN_TS]])
    ms = cuda_ms(lambda: tr.step(tuples), reps=5, warmup=1)
    single["tuples_per_s"] = TRAIN_TS / ms * 1e3
    print(f"timing train step sare_ind {H}x{W} f32, {TRAIN_TS} tuples x "
          f"{2 + TRAIN_NEG} images (conv5 + NetVLAD trained): "
          f"{TRAIN_TS / ms * 1e3:.3f} tuples/s "
          f"(sare_train_tuples_per_sec_480x640_float32_ts4; {ms:.2f} "
          f"ms/step, CUDA events, H2D of the uint8 batch included) "
          f"[{card}]")
    del m, tr, model
    torch.cuda.empty_cache()
    return launches, single


def sfrs_tuples_tie_equal(ours, theirs, qf, gf, jac, n_q, neg_num,
                          tie=5e-3, jac_tie=1e-4):
    """SFRS tuples agree anchor by anchor: [anchor, positive, negatives] as
    tuples_tie_equal; each difficult positive equal, or swapped with one
    whose Jaccard distance (``jac``: anchor -> (Jaccard row over the
    gallery)) lies within ``jac_tie`` or whose sq-dist lies within ``tie``.
    Returns the number of tie swaps, or None."""
    easy = tuples_tie_equal([t[:2 + neg_num] for t in ours],
                            [t[:2 + neg_num] for t in theirs], qf, gf, n_q,
                            tie)
    if easy is None:
        return None
    swaps = easy
    by_anchor = {t[0]: t for t in theirs}
    for t in ours:
        u = by_anchor[t[0]]
        for x, y in zip(t[2 + neg_num:], u[2 + neg_num:]):
            if x == y:
                continue
            jx, jy = jac[t[0]][x - n_q], jac[t[0]][y - n_q]
            dx, dy = (float(((qf[t[0]] - gf[i - n_q]) ** 2).sum())
                      for i in (x, y))
            if abs(jx - jy) >= jac_tie and abs(dx - dy) >= tie:
                return None
            swaps += 1
    return swaps


def step_gap(ours, theirs, before):
    """Two runs of one train step, each (losses, {name: parameter as f64 on
    the CPU}), from the parameters ``before``: (the losses' largest
    relative gap, (updates at x of rtol 1e-3 of each layer's largest,
    where), (parameters at x of rtol 1e-3 / atol 1e-7, where), whether
    the parameters lie within rtol 1e-3 / atol 1e-3 of the layer's
    largest update and the untouched ones are bit-equal)."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(ours[0], theirs[0]))
    up_err = par_err = (0.0, None)
    close = True
    for k, old in before.items():
        old = old.cpu().double()
        a, b = ours[1][k], theirs[1][k]
        if torch.equal(b, old):
            close = close and torch.equal(a, old)
            continue
        ulp = float(np.spacing(np.float32(old.abs().max())))
        up_a, up_b = a - old, b - old
        scale = 1e-3 * float(up_b.abs().max()) + ulp
        close = close and torch.allclose(a, b, rtol=1e-3, atol=scale)
        err = float(((up_a - up_b).abs() / (
            scale + 1e-3 * up_b.abs())).max())
        up_err = max(up_err, (err, k), key=lambda e: e[0])
        err = float(((a - b).abs() / (1e-7 + 1e-3 * b.abs())).max())
        par_err = max(par_err, (err, k), key=lambda e: e[0])
    return rel, up_err, par_err, close


def gap_text(gap):
    rel, up_err, par_err, _ = gap
    return (f"losses rel {rel:.2g}, updates at {up_err[0]:.3g} of rtol "
            f"1e-3 of each layer's largest ({up_err[1]}), parameters at "
            f"{par_err[0]:.3g} of rtol 1e-3 / atol 1e-7 ({par_err[1]})")


def sfrs_phase(dev, card, seed, tmp):
    """(f2) SFRS training at full width on the card, on the training phase's
    synthetic world (480x640) and centroid cache under ``tmp``: the
    full-width EmbedRegionNet (VGG16, K=64, C=512) from seeded weights with
    NetVLAD bootstrapped, then pipeline.run_sfrs_training for 2 generations
    x 1 epoch (SARE-ind, tuple_size 1, neg_num 10, pos_num 10, the
    reference recipe; 3 steps a subset), so gen 1 mines with Jaccard
    distances, trains on the hardest-region negatives and the soft loss;
    validation after each generation and the final PCA eval. K1's count is
    0 just before the run and read just after. Then its checks: the native
    rerank library built from csrc/rerank.cpp and loaded (before the run),
    K1 on a mining batch, gen 1's mined tuples from K1's descriptors
    against the plain head's, the device Jaccard engine against the native
    one on the gen-1 union, the losses, the frozen layers after each
    generation, one gen-1 step on the card against the CPU; and the gen-1
    step's tuples/s. Returns K1's launches in the run."""
    import copy

    from openibl_tpu_torch.config import DataConfig, SFRSConfig
    from openibl_tpu_torch.data.loader import ImageSource
    from openibl_tpu_torch.data.sampler import DiffTupleSampler
    from openibl_tpu_torch.data.transforms import TestTransform
    from openibl_tpu_torch.engine import pipeline
    from openibl_tpu_torch.engine.sfrs import SFRSTrainer, make_teacher
    from openibl_tpu_torch.models.convert import params_to_jax
    from openibl_tpu_torch.ops import _native, rerank
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.utils import f32_precision
    from openibl_tpu_torch.utils.checkpoint import read_checkpoint
    from openibl_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    lib = _native.require()  # a failed g++ build fails the run here
    check(True, f"native rerank library built from "
                f"openibl_tpu_torch/csrc/rerank.cpp and loaded: "
                f"{osp.relpath(lib, ROOT)} ({time.perf_counter() - t0:.2f} s"
                f" with the build)")
    cfg = SFRSConfig(
        data=DataConfig(dataset="synthetic", scale=None,
                        data_dir=osp.join(tmp, "data"), height=H, width=W,
                        test_batch_size=N_IMG),
        loss_type="sare_ind", tuple_size=1, neg_num=SFRS_NEG,
        pos_num=SFRS_POS, iters=SFRS_ITERS, epochs=1, generations=2,
        print_freq=100, seed=seed, logs_dir=osp.join(tmp, "sfrs_logs"),
        init_dir=osp.join(tmp, "logs"))
    dataset = pipeline.load_dataset(cfg)
    t0 = time.perf_counter()
    before = {k: v.detach().clone() for k, v in pipeline.build_model(
        cfg, dataset, dev, region=True).state_dict().items()}
    torch.cuda.synchronize()
    print(f"phase sfrs: seeded EmbedRegionNet (K=64) + centroids in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")

    steps, engines = [], []
    step, query = SFRSTrainer.step, rerank.JaccardEngine.query

    def counted_step(self, teacher, images, gen, generator=None):
        steps.append((gen, *step(self, teacher, images, gen, generator)))
        return steps[-1][1:]

    def seen_query(self, *a, **kw):
        out = query(self, *a, **kw)
        engines.append(self.last_engine)
        return out

    timer = PhaseTimer(dev)
    SFRSTrainer.step, rerank.JaccardEngine.query = counted_step, seen_query
    t0 = time.perf_counter()
    try:
        with k4_counted("sfrs"):
            nk.netvlad_fused.launches = 0  # the SFRS path starts
            model, final = pipeline.run_sfrs_training(
                cfg, device=dev, verbose=False, timer=timer)
            launches = nk.netvlad_fused.launches  # the SFRS path ends
    finally:
        SFRSTrainer.step, rerank.JaccardEngine.query = step, query
    print(f"phase sfrs: run_sfrs_training (2 generations x 1 epoch) in "
          f"{time.perf_counter() - t0:.2f} s; PCA test recall@1/5/10 "
          f"{list(map(float, final))}; K1 launches {launches}; Jaccard "
          f"engine {engines} [{card}]")
    print("  " + timer.summary().replace("\n", "\n  ") + f" [{card}]")
    print(f"timing sfrs mining_jaccard (gen 1, the {len(dataset.q_train)} + "
          f"{len(dataset.db_train)} item union, k1=20): "
          f"{timer.totals['mining_jaccard']:.4f} s over "
          f"{timer.counts['mining_jaccard']} subset(s) (host clock to a "
          f"synchronize) [{card}]")
    check(launches > 0, f"K1 launched {launches} times on the SFRS path "
                        f"(mining, validation, PCA fit, test)")
    check(engines == ["native"],
          f"gen 1's Jaccard mining ran on the native host engine (auto "
          f"routing at this union): {engines}")
    vals = [float(x) for _, lh, ls in steps for x in (lh, ls)]
    check(len(steps) == 2 * SFRS_ITERS and all(np.isfinite(vals))
          and [g for g, _, _ in steps] == [0] * SFRS_ITERS + [1] * SFRS_ITERS
          and all(float(ls) > 0 for _, _, ls in steps),
          f"{len(steps)} steps of 1 + 1 + {SFRS_NEG} + {SFRS_POS} images "
          f"(gens 0 and 1), hard and soft losses finite (the soft loss "
          f"reported at gen 0 too): "
          f"{[(g, round(float(a), 5), round(float(b), 5)) for g, a, b in steps]}")
    check(len(final) == 3 and all(0 <= float(r) <= 1 for r in final),
          "Recall@1/5/10 of the PCA test eval")
    pristine = params_to_jax(before)["base"]
    frozen, moved = True, 0
    for g in range(2):
        ckpt = read_checkpoint(osp.join(cfg.logs_dir,
                                        f"checkpoint{g}_0.npz"))[0]
        for name, leaf in ckpt["params"]["base"].items():
            same = all(np.array_equal(leaf[k], pristine[name][k])
                       for k in ("w", "b"))
            if name.startswith("conv5"):
                moved += not same
            else:
                frozen = frozen and same
    check(frozen and moved == 6,
          f"conv1_1..conv4_3 bit-equal to their initial values after each "
          f"generation; conv5_* moved in both ({moved} of 6 checkpoints x "
          f"layers)")

    # K1 on one mining batch of the trained model
    src = ImageSource(dataset.q_train + dataset.db_train, dataset.images_dir,
                      TestTransform(H, W, device_normalize=True))
    n_q = len(dataset.q_train)
    batch = torch.from_numpy(np.stack(
        [src.load(n_q + i) for i in range(N_IMG)])).to(dev)
    with torch.inference_mode(), f32_precision():
        fmap = model.base(batch)[1]
        nv = model.net_vlad
        got = nk.netvlad_fused(fmap, nv.assign_w, nv.centroids,
                               postprocess=True)
        ref = nk.netvlad_plain(fmap, nv.assign_w, nv.centroids,
                               postprocess=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    check(True, f"K1 == plain head on an SFRS mining batch "
                f"{tuple(fmap.shape)}, max_abs_err "
                f"{float((got - ref).abs().max()):.3g} "
                f"({gate_ratio(got, ref):.4f} of the rtol {RTOL} / atol "
                f"{ATOL} gate)")
    del batch, fmap, got, ref

    # gen 1's mining from K1's descriptors and from the plain head's
    subset = np.arange(n_q)
    mined, feats, jacs = [], [], []
    for view in (pipeline.eval_view(model), model):
        g = pipeline._extract(view, ImageSource(
            dataset.db_train, dataset.images_dir, src.transform), cfg, "vlad")
        q = pipeline._extract(view, ImageSource(
            dataset.q_train, dataset.images_dir, src.transform), cfg, "vlad")
        jac = pipeline._jaccard_rows(q, g, subset, cfg.rerank_lambda)
        sampler = DiffTupleSampler(n_q, len(dataset.db_train),
                                   dataset.train_pos, dataset.train_neg,
                                   pos_num=SFRS_POS, pos_pool=cfg.pos_pool,
                                   neg_num=SFRS_NEG, neg_pool=cfg.neg_pool,
                                   seed=cfg.seed)
        sampler.set_epoch(cfg.seed)
        mined.append(sampler.refresh(q, g, subset, jaccard_rows=jac))
        feats.append((q, g))
        jacs.append(jac)
    qf, gf = (x.cpu().numpy() for x in feats[1])
    swaps = sfrs_tuples_tie_equal(mined[0], mined[1], qf, gf, jacs[1], n_q,
                                  SFRS_NEG)
    # the Jaccard rows move where the two unions' k-reciprocal rankings
    # differ: only between neighbours at near-equal distances
    ranks = [rerank.build_v_sparse(torch.cat(f), k1=20)[3] for f in feats]
    plain = torch.cat(feats[1])
    d2 = torch.cdist(plain, plain).square().cpu().numpy()
    moved = np.argwhere(ranks[0] != ranks[1])
    rank_gap = max((abs(float(d2[i, ranks[0][i, j]] - d2[i, ranks[1][i, j]]))
                    for i, j in moved), default=0.0)
    check(swaps is not None and rank_gap < 1e-4,
          f"gen-1 tuples mined from K1's descriptors == from the plain "
          f"head's for {n_q} anchors x (1 + {SFRS_NEG} + {SFRS_POS} "
          f"difficult positives), up to ties (sq-dist < 5e-3, Jaccard < "
          f"1e-4): {swaps} tie swaps; Jaccard rows K1 vs plain max |gap| "
          f"{float(np.abs(jacs[0] - jacs[1]).max()):.3g}, the unions' "
          f"({len(plain)} x 21) rankings differ at {len(moved)} entries, "
          f"between neighbours whose sq-dists differ by {rank_gap:.3g} (< "
          f"1e-4) at most; "
          f"sq-dists of the union: median {float(np.median(d2)):.3g}")

    # the device Jaccard engine against the native one on the gen-1 union
    union = torch.cat(feats[0])
    rows, cols, vals_, _, _ = rerank.build_v_sparse(union, k1=20)
    eng = rerank.JaccardEngine(rows, cols, vals_, len(union), device=dev)
    t0 = time.perf_counter()
    host = eng.query(subset, prefer="host")
    host_s = time.perf_counter() - t0
    eng.query(subset, prefer="device")  # builds the slabs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_dev = eng.query(subset, prefer="device")
    dev_s = time.perf_counter() - t0
    gap = float(np.abs(on_dev - host).max())
    np.testing.assert_allclose(on_dev, host, rtol=1e-5, atol=1e-6)
    check(True, f"device Jaccard engine (scatter_add_ on the card) == "
                f"native host engine on the gen-1 union ({len(union)} "
                f"items, {len(rows)} V entries, {len(subset)} queries): max "
                f"|gap| {gap:.3g} (rtol 1e-5 / atol 1e-6); host "
                f"{host_s * 1e3:.3f} ms, device {dev_s * 1e3:.3f} ms (host "
                f"clock, D2H included)")
    del feats, union, eng

    # one gen-1 step on the card against the same step on the CPU, as gen 1
    # starts: the student at the run's initial weights, gen 1's teacher
    # (its checkpoint's)
    teacher = make_teacher(model)
    pipeline._load_params(teacher, ckpt["teacher"])
    student = copy.deepcopy(model)
    student.load_state_dict(before)
    tup = np.stack([src.load(i) for i in mined[1][0]])[None]
    runs = {}
    t0 = time.perf_counter()
    # the card, the CPU, the card without cuDNN (PyTorch's own convolution
    # kernels) and the card in f64 (the reference the f32 steps are read
    # against)
    for name, where, dt, cudnn in (
            ("card", dev, torch.float32, True),
            ("cpu", torch.device("cpu"), torch.float32, True),
            ("card_no_cudnn", dev, torch.float32, False),
            ("card_f64", dev, torch.float64, True)):
        m, t = (copy.deepcopy(x).to(where, dt) for x in (student, teacher))
        m.base.compute_dtype = t.base.compute_dtype = dt
        tr = SFRSTrainer(m, loss_type=cfg.loss_type, margin=cfg.margin,
                         temps=cfg.temperature, soft_weight=cfg.soft_weight,
                         neg_num=SFRS_NEG, lr=cfg.lr, momentum=cfg.momentum,
                         weight_decay=cfg.weight_decay)
        tr.init_generation()
        prev, torch.backends.cudnn.enabled = torch.backends.cudnn.enabled, \
            cudnn
        try:
            got = [float(x) for x in tr.step(t, tup, 1)]
        finally:
            torch.backends.cudnn.enabled = prev
        runs[name] = (got, {k: v.detach().cpu().double()
                            for k, v in m.state_dict().items()})
        del m, t, tr
    print(f"  card vs CPU SFRS gen-1 step on one tuple {tup.shape} (and "
          f"the card without cuDNN, the card in f64): "
          f"{time.perf_counter() - t0:.2f} s [{card}]")

    vs_cpu = step_gap(runs["card"], runs["cpu"], before)
    check(vs_cpu[0] < 1e-4 and vs_cpu[1][0] <= 1.0 and vs_cpu[3],
          f"one SFRS gen-1 step on the card (f32, TF32 off) == on the CPU: "
          f"hard/soft losses {runs['card'][0]} vs {runs['cpu'][0]}; "
          f"{gap_text(vs_cpu)} (gates: losses 1e-4, updates 1, parameters "
          f"within rtol 1e-3 / atol 1e-3 of the layer's largest update)")
    print(f"  the f32 steps against the card's f64 step "
          f"{runs['card_f64'][0]}: " + "; ".join(
              f"{name}: "
              f"{gap_text(step_gap(runs[name], runs['card_f64'], before))}"
              for name in ("card", "cpu", "card_no_cudnn")) + f" [{card}]")

    # the gen-1 step's rate: 1 tuple of 1 + 1 + 10 + 10 images a step (one
    # 22-image student forward and backward, an 11-image teacher forward)
    m = copy.deepcopy(student)
    tr = SFRSTrainer(m, loss_type=cfg.loss_type, temps=cfg.temperature,
                     neg_num=SFRS_NEG, lr=cfg.lr)
    tr.init_generation()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(lambda: tr.step(teacher, tup, 1), reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"timing sfrs train step gen 1 sare_ind {H}x{W} f32, 1 tuple x "
          f"{2 + SFRS_NEG + SFRS_POS} images (22-image student forward + "
          f"backward, 11-image teacher forward; conv5 + NetVLAD trained): "
          f"{1 / ms * 1e3:.3f} tuples/s "
          f"(sfrs_train_tuples_per_sec_480x640_float32_ts1; {ms:.2f} "
          f"ms/step, CUDA events, H2D of the uint8 batch included; peak "
          f"{peak:.2f} GiB) [{card}]")
    del m, tr, model, teacher, student
    torch.cuda.empty_cache()
    return launches


def _mat_cell(paths):
    out = np.empty((len(paths), 1), dtype=object)
    for i, p in enumerate(paths):
        out[i, 0] = np.array([p])
    return out


def write_db_struct(path, db, db_utm, q, q_utm, time_stamps=False):
    """A NetVLAD-release dbStruct .mat in the field order the parsers read:
    Tokyo 24/7's, or TokyoTM's with ``time_stamps``."""
    from scipy.io import savemat

    fields = [("whichSet", "test"), ("dbImage", _mat_cell(db)),
              ("utmDb", np.asarray(db_utm, np.float64).T)]
    if time_stamps:
        fields.append(("dbTimeStamp", np.zeros((1, len(db)))))
    fields += [("qImage", _mat_cell(q)),
               ("utmQ", np.asarray(q_utm, np.float64).T)]
    if time_stamps:
        fields.append(("qTimeStamp", np.zeros((1, len(q)))))
    fields += [("numDb", float(len(db))), ("numQ", float(len(q)))]
    struct = np.array([tuple(v for _, v in fields)],
                      dtype=[(k, object) for k, _ in fields])
    savemat(path, {"dbStruct": struct})


def tokyo_world(raw, rng):
    """A mini Tokyo root under ``raw``: TokyoTM train (4 places x 3
    timestamps) and val (2 x 2) at H x W; Tokyo 24/7 with TOKYO_DIRS
    panorama directories of 2 PNGs at H x W (two crops of one scene) and
    one query per TOKYO_QUERY_SIZES entry, the scene of directory j at that
    size (scaled by H / 480), 5 m from it. Returns the number of images."""
    def put(rel, img):
        path = osp.join(raw, rel)
        os.makedirs(osp.dirname(path), exist_ok=True)
        Image.fromarray(img).save(path, compress_level=1)

    os.makedirs(raw)
    n = 0
    for split, places, stamps, x0 in (("train", 4, 3, 0.0),
                                      ("val", 2, 2, 500.0)):
        db, db_utm, q, q_utm = [], [], [], []
        for i in range(places):
            utm = [x0 + 100.0 * i, 0.0]
            names = [f"images/{split}{i}/20{10 + t}/v.jpg"
                     for t in range(stamps)]
            db += names[:-1]
            db_utm += [utm] * (stamps - 1)
            q.append(names[-1])
            q_utm.append(utm)
        write_db_struct(osp.join(raw, f"tokyoTM_{split}.mat"), db, db_utm,
                        q, q_utm, time_stamps=True)
        for rel, img in zip(db + q, scenes(rng, len(db + q))):
            put(f"tokyoTM/images/{rel}", img)
            n += 1
    db = [f"dir{i}/p{j}.jpg" for i in range(TOKYO_DIRS) for j in range(2)]
    db_utm = [[1000.0 * i, 0.0] for i in range(TOKYO_DIRS) for _ in range(2)]
    q = [f"q{j:02d}.jpg" for j in range(len(TOKYO_QUERY_SIZES))]
    q_utm = [[1000.0 * j + 5.0, 0.0] for j in range(len(q))]
    write_db_struct(osp.join(raw, "tokyo247.mat"), db, db_utm, q, q_utm)
    views = scenes(rng, TOKYO_DIRS)
    crop = H // 16
    for i, rel in enumerate(db):
        img = views[i // 2] if i % 2 == 0 else np.asarray(
            Image.fromarray(views[i // 2][crop:]).resize((W, H),
                                                         Image.BILINEAR))
        put(f"tokyo247/images/{rel[:-3]}png", img)
    scale = H / 480
    for j, (rel, (w, h)) in enumerate(zip(q, TOKYO_QUERY_SIZES)):
        size = (round(w * scale), round(h * scale))
        put(f"tokyo247/query/{rel}", np.asarray(
            Image.fromarray(views[j]).resize(size, Image.BILINEAR)))
    return n + len(db) + len(q)


def recalls_tie_equal(a, b, q, g, gt, pids, tie=1e-4, topk=(1, 5, 10),
                      d=None):
    """Recall@topk ``a`` == ``b``, or they differ only where a query's
    first true positive lies within ``tie`` (squared distance, after NMS
    over 12 x max(topk)) of its k-th candidate, where two kNNs may order
    near-equal rows either way; ``d`` (Q, G) replaces the squared distances
    (e.g. reranked ones). Returns (ok, near-ties found)."""
    from openibl_tpu_torch.engine.evaluator import spatial_nms

    ties = 0
    if d is None:
        d = torch.cdist(q.float(), g.float()).square().cpu().numpy()
    for i, row in enumerate(d):
        order = spatial_nms(list(np.argsort(row, kind="stable")), pids,
                            12 * max(topk))
        ranked = row[np.asarray(order)]
        first = next((r for r, j in enumerate(order) if j in gt[i]), None)
        for k in topk:
            if first is not None and k <= len(ranked) and first != k - 1 \
                    and abs(ranked[first] - ranked[k - 1]) < tie:
                ties += 1
    return bool(np.array_equal(a, b)) or ties > 0, ties


def tokyo_phase(eval_tree, dev, card, seed, tmp):
    """(h) Checkpoint evaluation at full width on the card, Tokyo 24/7: a
    mini Tokyo root (tokyo_world, under ``tmp``, where the mesh phase reads
    it too), the serving model's EmbedNet (VGG16,
    K=64, its bootstrapped NetVLAD) saved as a JAX-layout .npz checkpoint,
    and engine/pipeline.run_eval with NMS and a PCA fitted on demand on the
    TokyoTM train images, on the default device. K1's count is 0 just
    before the run and read just after; each pass's launches are read
    around Evaluator.extract. Then its checks: every query's masked
    descriptor against its own per-shape batch-1 forward on the card, one
    query per bucket against the CPU, K1 on a gallery batch, run_eval's
    recalls against the per-shape descriptors'. Then one run_eval with the
    k-reciprocal rerank (k1 25, lambda 0), its recalls against the CPU's
    rerank of the same descriptors; and the rates. Returns K1's launches in
    the eval run and in the rerank run."""
    import copy

    from openibl_tpu_torch.config import DataConfig, EvalConfig
    from openibl_tpu_torch.data.loader import (ImageSource,
                                               PaddedBatchLoader)
    from openibl_tpu_torch.data.transforms import TestTransform
    from openibl_tpu_torch.engine import pipeline
    from openibl_tpu_torch.engine.evaluator import (Evaluator,
                                                    evaluate_descriptors)
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops.pca import PCA
    from openibl_tpu_torch.parallel.extract import (extract_features,
                                                    make_extract_fn)
    from openibl_tpu_torch.utils import array_file, f32_precision
    from openibl_tpu_torch.utils.checkpoint import save_checkpoint
    from openibl_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 4)
    n_files = tokyo_world(osp.join(tmp, "data", "tokyo", "raw"), rng)
    ckpt = save_checkpoint(osp.join(tmp, "logs", "model_best.npz"),
                           {"params": eval_tree}, {"epoch": 0})
    print(f"phase tokyo: mini Tokyo 24/7 root, {n_files} images, and a "
          f"JAX-layout checkpoint in {time.perf_counter() - t0:.2f} s "
          f"(host) [{card}]")
    cfg = EvalConfig(
        data=DataConfig(dataset="tokyo", data_dir=osp.join(tmp, "data"),
                        height=H, width=W, test_batch_size=N_IMG),
        checkpoint=ckpt, nms=True, reduction=True, pca_dataset="tokyo",
        pca_dim=TOKYO_PCA_DIM)

    passes = []
    extract = Evaluator.extract

    def counted_extract(self, loader, *a, **kw):
        before = nk.netvlad_fused.launches
        out = extract(self, loader, *a, **kw)
        passes.append((type(loader).__name__,
                       nk.netvlad_fused.launches - before, out))
        return out

    timer = PhaseTimer(dev)
    Evaluator.extract = counted_extract
    t0 = time.perf_counter()
    try:
        with k4_counted("tokyo_eval"):
            nk.netvlad_fused.launches = 0  # the Tokyo eval path starts
            recalls = pipeline.run_eval(cfg, verbose=False, timer=timer)
            launches = nk.netvlad_fused.launches  # ... and ends
    finally:
        Evaluator.extract = extract
    wall = time.perf_counter() - t0
    print(f"phase tokyo: run_eval (tokyo, NMS, PCA {TOKYO_PCA_DIM} "
          f"fitted on demand) in {wall:.2f} s; Recall@1/5/10 "
          f"{list(map(float, recalls))}; K1 launches {launches} "
          f"[{card}]")
    print("  " + timer.summary().replace("\n", "\n  ") + f" [{card}]")
    check([(kind, n > 0) for kind, n, _ in passes]
          == [("PaddedBatchLoader", False), ("BatchLoader", True)],
          f"K1 launched {launches} times on the Tokyo eval path: "
          f"{', '.join(f'{k} pass {n}' for k, n, _ in passes)} "
          f"(the masked query pass takes the eager head), the rest on "
          f"the PCA fit")

    # the evaluated model, rebuilt from the checkpoint as run_eval does
    dataset = pipeline.load_dataset(cfg)
    model = pipeline.new_embednet(cfg)
    pipeline._load_eval_weights(model, ckpt)
    cpu_model = copy.deepcopy(model).eval()
    model = model.to(dev, memory_format=torch.channels_last).eval()
    emodel = pipeline.eval_view(model)
    q_src = ImageSource(dataset.q_test, dataset.images_dir,
                        TestTransform(H, W, tokyo=True,
                                      device_normalize=True))
    n_q = len(q_src)
    fwd = make_extract_fn(emodel)
    with torch.inference_mode():
        loader = PaddedBatchLoader(q_src, batch_size=N_IMG)
        masked = extract_features(emodel, loader,
                                  masked_apply_fn=emodel.forward_masked,
                                  device_output=True)
        per_shape = [torch.tensor(q_src.load(i)[None]).to(dev)
                     for i in range(n_q)]
        ps = torch.cat([fwd(x) for x in per_shape])
    torch.cuda.synchronize()
    gap = float((masked - ps).abs().max())
    torch.testing.assert_close(masked, ps, rtol=RTOL, atol=ATOL)
    check(True, f"{n_q} Tokyo queries: masked bucket-padded descriptor "
                f"(32768-d) == own per-shape batch-1 forward (K1) on the "
                f"card, max |gap| {gap:.3g} ({gate_ratio(masked, ps):.4f}"
                f" of the rtol {RTOL} / atol {ATOL} gate)")
    buckets = list(loader)
    cpu_fwd = make_extract_fn(cpu_model)
    for images, hws, idx, count in buckets:
        i = int(idx[0])
        with torch.no_grad():
            ref = cpu_fwd(torch.tensor(q_src.load(i)[None]))
        got = masked[i:i + 1].cpu()
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        check(True, f"query {i} ({hws[0][0]}x{hws[0][1]} in the "
                    f"{images.shape[1]}x{images.shape[2]} bucket): card "
                    f"masked == CPU plain path at its own shape, max "
                    f"|gap| {float((got - ref).abs().max()):.3g} "
                    f"({gate_ratio(got, ref):.4f} of the gate)")

    # K1 on a gallery batch against the plain head
    g_src = ImageSource(dataset.db_test, dataset.images_dir,
                        TestTransform(H, W, device_normalize=True))
    gb = torch.from_numpy(np.stack(
        [g_src.load(i) for i in range(N_IMG)])).to(dev)
    nv = model.net_vlad
    with torch.inference_mode(), f32_precision():
        fmap = model.base(gb)[1]
        got = nk.netvlad_fused(fmap, nv.assign_w, nv.centroids,
                               postprocess=True)
        ref = nk.netvlad_plain(fmap, nv.assign_w, nv.centroids,
                               postprocess=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    check(True, f"K1 == plain head on a Tokyo gallery batch "
                f"{tuple(fmap.shape)}, max_abs_err "
                f"{float((got - ref).abs().max()):.3g} "
                f"({gate_ratio(got, ref):.4f} of the gate)")

    # run_eval's recalls against the per-shape descriptors' (through
    # the PCA run_eval fitted and the gallery it extracted)
    pca = PCA(TOKYO_PCA_DIM, params_path=array_file(osp.join(
        tmp, "logs", "pca_params_model_best.h5")))
    q_red, g_red = pca.infer(ps), passes[1][2]
    pids = [it[1] for it in dataset.db_test]
    want = evaluate_descriptors(q_red, g_red, dataset.test_pos, pids,
                                nms=True, print_results=False)
    q_run = passes[0][2]
    ok, ties = recalls_tie_equal(recalls, want, q_red, g_red,
                                 dataset.test_pos, pids)
    check(ok, f"run_eval Recall@1/5/10 {list(map(float, recalls))} == "
              f"per-shape descriptors' {list(map(float, want))} through "
              f"evaluate_descriptors, up to ties ({ties} near-ties at a "
              f"cut); reduced query descriptors {q_run.shape[1]}-d, "
              f"run_eval's vs per-shape max |gap| "
              f"{float((q_run - q_red).abs().max()):.3g}")

    # the k-reciprocal rerank on the card: run_eval(rerank=True) (k1 25,
    # lambda 0; the PCA fitted above is loaded), against the CPU's
    # rerank of the same descriptors
    from openibl_tpu_torch.ops.rerank import (composite_rank_key,
                                              re_ranking)

    rr_cfg = dataclasses.replace(cfg, rerank=True, rr_topk=25,
                                 lambda_value=0.0)
    passes.clear()
    rr_timer = PhaseTimer(dev)
    Evaluator.extract = counted_extract
    t0 = time.perf_counter()
    try:
        with k4_counted("tokyo_eval_rerank"):
            nk.netvlad_fused.launches = 0  # the rerank eval path starts
            rr_recalls = pipeline.run_eval(rr_cfg, verbose=False,
                                           timer=rr_timer)
            rr_launches = nk.netvlad_fused.launches  # ... and ends
    finally:
        Evaluator.extract = extract
    print(f"phase tokyo: run_eval with the k-reciprocal rerank (k1 25, "
          f"lambda 0) in {time.perf_counter() - t0:.2f} s; Recall@1/5/10"
          f" {list(map(float, rr_recalls))} (without: "
          f"{list(map(float, recalls))}); K1 launches {rr_launches} "
          f"[{card}]")
    print("  " + rr_timer.summary().replace("\n", "\n  ")
          + f" [{card}]")
    print(f"timing tokyo rerank in run_eval ({n_q} queries + "
          f"{len(dataset.db_test)} gallery, materialized re_ranking): "
          f"{rr_timer.totals['rerank']:.4f} s (host clock to a "
          f"synchronize) [{card}]")
    q_rr, g_rr = (x[2].cpu() for x in passes)
    want = evaluate_descriptors(q_rr, g_rr, dataset.test_pos, pids,
                                nms=True, rerank=True, rr_topk=25,
                                print_results=False)
    sq = lambda a, b: torch.cdist(a, b).square().numpy()  # noqa: E731
    final = re_ranking(sq(q_rr, g_rr), sq(q_rr, q_rr), sq(g_rr, g_rr),
                       k1=25, k2=1, lambda_value=0.0, device="cpu")
    ok, ties = recalls_tie_equal(
        rr_recalls, want, q_rr, g_rr, dataset.test_pos, pids,
        d=composite_rank_key(final, sq(q_rr, g_rr)))
    check(ok and rr_launches > 0,
          f"rerank on the card: Recall@1/5/10 "
          f"{list(map(float, rr_recalls))} == the CPU's rerank of the "
          f"same descriptors {list(map(float, want))}, up to ties "
          f"({ties} near-ties at a cut, final distance < 1e-4); K1 "
          f"launched {rr_launches} times (gallery pass)")
    passes.clear()

    # rates: each bucket through the masked forward, the same batch
    # unmasked (K1) and the backbone alone both ways (the re-zeroing's
    # cost), the reference's per-shape batch-1 loop, the gallery (K1)
    with torch.inference_mode():
        for images, hws, idx, count in buckets:
            x = torch.from_numpy(images).to(dev)
            hw = torch.from_numpy(hws).to(dev)
            fill = sum(int(h) * int(w) for h, w in hws[:count]) / (
                count * images.shape[1] * images.shape[2])
            ms = cuda_ms(lambda: emodel.forward_masked(x, hw), reps=5,
                         warmup=1)
            plain = cuda_ms(lambda: emodel(x), reps=5, warmup=1)
            with f32_precision():
                b_m = cuda_ms(lambda: model.base(x, hw), reps=5,
                              warmup=1)
                b_p = cuda_ms(lambda: model.base(x), reps=5, warmup=1)
            print(f"timing tokyo masked query bucket "
                  f"{images.shape[1]}x{images.shape[2]}, {count} "
                  f"queries padded to batch {len(images)}, fill "
                  f"{fill:.3f}: {len(images) / ms * 1e3:.2f} img/s "
                  f"({ms:.2f} ms/batch, {count / ms * 1e3:.2f} queries/s)"
                  f"; unmasked at the same shape (K1) "
                  f"{len(images) / plain * 1e3:.2f} img/s ({plain:.2f} "
                  f"ms); backbone masked {b_m:.2f} ms vs unmasked "
                  f"{b_p:.2f} ms (+{(b_m / b_p - 1) * 100:.2f}%) "
                  f"[{card}]")
            del x
        ms = cuda_ms(lambda: [fwd(x) for x in per_shape], reps=3,
                     warmup=1)
        print(f"timing tokyo per-shape batch-1 loop (the reference's "
              f"strategy), {n_q} queries at their own shapes through "
              f"K1: {n_q / ms * 1e3:.2f} img/s ({ms:.2f} ms) [{card}]")
        ms = cuda_ms(lambda: fwd(gb), reps=5, warmup=1)
        print(f"timing tokyo gallery {H}x{W} batch {N_IMG} through K1: "
              f"{N_IMG / ms * 1e3:.2f} img/s ({ms:.2f} ms/batch) "
              f"[{card}]")
    del model, emodel, cpu_model, per_shape, masked, ps, gb, fmap
    passes.clear()
    torch.cuda.empty_cache()
    return launches, rr_launches


def jitter_phase(dev, card, seed, tmp):
    """(j) On-device ColorJitter at full width on the training phase's
    world under ``tmp``: a tuple batch of 1 + 1 + 10 images at 480x640.
    Checks apply_jitter on the card against the CPU with the same draws
    (atol JITTER_ATOL on the 0..255 scale: the contrast mean sums in
    another order, and the card multiplies by a scalar's reciprocal where
    the CPU divides), zero ranges bit for bit, one device_jitter=True
    Trainer.step and one SFRS gen-1 step (1 + 1 + 10 + 10 images) on the
    card against the same steps on the CPU from the same generator seeds,
    at the training phases' gate (step_gap); the SFRS step with cuDNN off
    on the card, its cuDNN step printed beside it against the card's f64
    step. Prints the jitter pass's time per tuple batch and its share of
    the jittered step (CUDA events)."""
    import copy

    from openibl_tpu_torch.config import DataConfig, SFRSConfig, TrainConfig
    from openibl_tpu_torch.data.loader import ImageSource
    from openibl_tpu_torch.data.transforms import TestTransform
    from openibl_tpu_torch.engine import pipeline
    from openibl_tpu_torch.engine.sfrs import SFRSTrainer, make_teacher
    from openibl_tpu_torch.engine.trainer import Trainer, device_jitter_batch
    from openibl_tpu_torch.ops import augment

    data = DataConfig(dataset="synthetic", scale=None,
                      data_dir=osp.join(tmp, "data"), height=H, width=W,
                      test_batch_size=N_IMG)
    logs = dict(logs_dir=osp.join(tmp, "jitter_logs"),
                init_dir=osp.join(tmp, "logs"))  # the cached centroids
    cfg = TrainConfig(data=data, loss_type="sare_ind", neg_num=TRAIN_NEG,
                      seed=seed, device_jitter=True, **logs)
    dataset = pipeline.load_dataset(cfg)
    src = ImageSource(dataset.q_train + dataset.db_train, dataset.images_dir,
                      TestTransform(H, W, device_normalize=True))
    n_img = 2 + TRAIN_NEG
    tup = np.stack([src.load(i) for i in range(n_img)])[None]
    x = torch.from_numpy(tup[0])
    x_dev = x.to(dev)
    factors, orders = augment.draw_jitter(
        n_img, torch.Generator().manual_seed(seed))
    on_cpu = augment.apply_jitter(x, factors, orders)
    on_card = augment.apply_jitter(x_dev, factors, orders)
    err = float((on_card.cpu() - on_cpu).abs().max())
    check(on_card.device == x_dev.device and err <= JITTER_ATOL,
          f"apply_jitter on the card == on the CPU for {tuple(x.shape)} "
          f"uint8 images, the same factors and op orders: max |gap| "
          f"{err:.3g} (atol {JITTER_ATOL} on the 0..255 scale)")
    zero = augment.color_jitter_batch(x_dev, torch.Generator(), 0, 0, 0, 0)
    check(torch.equal(zero.cpu(), x.float()),
          "color_jitter_batch with all four ranges at 0 on the card: the "
          "f32 input bit for bit")

    cpu = torch.device("cpu")

    def step_runs(model, make_trainer, step, variants):
        """The step from copies of ``model`` in each (name, device, dtype,
        cuDNN on) variant: {name: (losses, {name: parameter as f64 on the
        CPU})}."""
        runs = {}
        for name, where, dt, cudnn in variants:
            m = copy.deepcopy(model).to(where, dt)
            m.base.compute_dtype = dt
            prev, torch.backends.cudnn.enabled = \
                torch.backends.cudnn.enabled, cudnn
            try:
                losses = [float(v) for v in step(make_trainer(m), where,
                                                  dt)]
            finally:
                torch.backends.cudnn.enabled = prev
            runs[name] = (losses, {k: v.detach().cpu().double()
                                   for k, v in m.state_dict().items()})
            del m
        return runs

    model = pipeline.build_model(cfg, dataset, dev)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def trainer(m):
        tr = Trainer(m, loss_type=cfg.loss_type, margin=cfg.margin,
                     lr=cfg.lr, momentum=cfg.momentum,
                     weight_decay=cfg.weight_decay, device_jitter=True)
        tr.init()
        return tr

    t0 = time.perf_counter()
    runs = step_runs(model, trainer, lambda tr, *_: [tr.step(
        tup, torch.Generator().manual_seed(seed + 7))],
        (("card", dev, torch.float32, True),
         ("cpu", cpu, torch.float32, True)))
    gap = step_gap(runs["card"], runs["cpu"], before)
    check(gap[0] < 1e-4 and gap[1][0] <= 1.0 and gap[3],
          f"one device_jitter=True train step on the card == on the CPU "
          f"(one generator seed, {n_img} images jittered on each): loss "
          f"{runs['card'][0]} vs {runs['cpu'][0]}; {gap_text(gap)} (gates: "
          f"loss 1e-4, updates 1, parameters within rtol 1e-3 / atol 1e-3 "
          f"of the layer's largest update; {time.perf_counter() - t0:.2f} "
          f"s)")

    # the jitter pass against the jittered step it runs in (CUDA events;
    # the step's H2D of the uint8 batch included, as the train phase's)
    tr = trainer(copy.deepcopy(model))
    jit_ms = cuda_ms(lambda: device_jitter_batch(
        x_dev, torch.Generator().manual_seed(1)), reps=10, warmup=2)
    step_ms = cuda_ms(lambda: tr.step(
        tup, torch.Generator().manual_seed(1)), reps=5, warmup=1)
    print(f"timing device jitter {n_img} images {H}x{W} (ColorJitter "
          f"0.7/0.7/0.7/0.5 + mean subtraction): {jit_ms:.3f} ms per tuple "
          f"batch, {jit_ms / step_ms * 100:.2f}% of the jittered train step "
          f"({step_ms:.2f} ms, 1 tuple x {n_img} images, sare_ind f32; "
          f"CUDA events) [{card}]")
    del tr, model

    scfg = SFRSConfig(data=data, loss_type="sare_ind", tuple_size=1,
                      neg_num=SFRS_NEG, pos_num=SFRS_POS, seed=seed,
                      device_jitter=True, **logs)
    student = pipeline.build_model(scfg, dataset, dev, region=True)
    before = {k: v.detach().clone() for k, v in student.state_dict().items()}
    teacher = make_teacher(student)
    stup = np.stack([src.load(i) for i in range(2 + SFRS_NEG + SFRS_POS)])

    def sfrs_step(tr, where, dt):
        t = copy.deepcopy(teacher).to(where, dt)
        t.base.compute_dtype = dt
        return tr.step(t, stup[None], 1,
                       torch.Generator().manual_seed(seed + 8))

    def sfrs_trainer(m):
        tr = SFRSTrainer(m, loss_type=scfg.loss_type, margin=scfg.margin,
                         temps=scfg.temperature,
                         soft_weight=scfg.soft_weight, neg_num=SFRS_NEG,
                         lr=scfg.lr, momentum=scfg.momentum,
                         weight_decay=scfg.weight_decay, device_jitter=True)
        tr.init_generation()
        return tr

    # the SFRS phase's step sits near the gate on the card with cuDNN's f32
    # convolutions (their error, PERF.md §6 PR 8): the jittered step is
    # gated on the card with PyTorch's own convolutions, and with cuDNN it
    # is printed beside both against the card's f64 step
    t0 = time.perf_counter()
    runs = step_runs(student, sfrs_trainer, sfrs_step, (
        ("card_no_cudnn", dev, torch.float32, False),
        ("cpu", cpu, torch.float32, True),
        ("card", dev, torch.float32, True),
        ("card_f64", dev, torch.float64, True)))
    gap = step_gap(runs["card_no_cudnn"], runs["cpu"], before)
    check(gap[0] < 1e-4 and gap[1][0] <= 1.0 and gap[3],
          f"one device_jitter=True SFRS gen-1 step (1 + 1 + {SFRS_NEG} + "
          f"{SFRS_POS} images jittered once, then split) on the card "
          f"(cuDNN off) == on the CPU: hard/soft losses "
          f"{runs['card_no_cudnn'][0]} vs {runs['cpu'][0]}; {gap_text(gap)} "
          f"(gates as above; {time.perf_counter() - t0:.2f} s for the "
          f"four steps)")
    print(f"  the jittered SFRS step with cuDNN on the card against the "
          f"CPU: {gap_text(step_gap(runs['card'], runs['cpu'], before))}; "
          f"against the card's f64 step {runs['card_f64'][0]}: " + "; ".join(
              f"{name}: "
              f"{gap_text(step_gap(runs[name], runs['card_f64'], before))}"
              for name in ("card", "cpu", "card_no_cudnn")) + f" [{card}]")
    del student, teacher
    torch.cuda.empty_cache()


class Arrays:
    """An image source over an in-memory uint8 (N, H, W, 3) array."""

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def load(self, i):
        return self.images[i]


def torchrun_env(port):
    """A one-rank torchrun environment on ``port``; returns the values it
    replaced, for ``restore_env``."""
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    return saved


def restore_env(saved):
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def eval_model(ckpt, device):
    """``eval_view`` of the EmbedNet (K=64) of a JAX-layout checkpoint, on
    ``device``: K1 on the card."""
    from openibl_tpu_torch import models
    from openibl_tpu_torch.engine import pipeline
    from openibl_tpu_torch.models.convert import params_from_jax
    from openibl_tpu_torch.utils.checkpoint import read_checkpoint

    model = models.create("embednet", net_vlad=models.NetVLAD(num_clusters=64))
    model.load_state_dict(params_from_jax(read_checkpoint(ckpt)[0]["params"]))
    return pipeline.eval_view(
        model.to(device, memory_format=torch.channels_last).eval())


def planted_gallery(device, seed, rows, desc, n_rows):
    """The served gallery, made from its seed on ``device``: ``n_rows``
    random unit rows, ``desc`` planted at ``rows``."""
    gg = torch.Generator(device=device).manual_seed(seed + 1)
    gallery = torch.randn((n_rows, desc.shape[1]), generator=gg,
                          device=device)
    gallery /= gallery.norm(dim=1, keepdim=True)
    gallery[torch.as_tensor(rows, device=device)] = torch.as_tensor(
        desc, device=device)
    return gallery


def gloo_rank(rank, tmp, seed, device):
    """One of the mesh phase's two ranks on the one card (``device``, e.g.
    "cuda"): a gloo group over its tensors (file store under ``tmp``),
    extract_features_sharded
    through K1 and topk_nearest_sharded over the gallery; the results and
    K1's launches go to ``tmp``/rank<r>.npz."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops.distance import topk_nearest_sharded
    from openibl_tpu_torch.parallel.extract import extract_features_sharded
    from openibl_tpu_torch.parallel.mesh import get_mesh
    from openibl_tpu_torch.utils import f32_precision

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=2)
    try:
        mesh = get_mesh(2, device=device)
        inputs = np.load(osp.join(tmp, "mesh_inputs.npz"))
        model = eval_model(osp.join(tmp, "model.npz"), mesh.device)
        nk.netvlad_fused.launches = 0  # the 2-rank path starts
        feats = extract_features_sharded(model, Arrays(inputs["images"]),
                                         batch_size=int(inputs["batch"]),
                                         mesh=mesh)
        launches = nk.netvlad_fused.launches  # ... and ends
        desc = torch.from_numpy(inputs["desc"]).to(mesh.device)
        gallery = planted_gallery(mesh.device, seed, inputs["rows"], desc,
                                  int(inputs["n_rows"]))
        # a CPU rehearsal of this phase passes device "cpu"
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        with f32_precision():
            topk_nearest_sharded(desc, gallery, mesh, k=10)
            sync()
            t0 = time.perf_counter()
            d, i = topk_nearest_sharded(desc, gallery, mesh, k=10)
            sync()
            knn_ms = (time.perf_counter() - t0) * 1e3
        np.savez(osp.join(tmp, f"rank{rank}.npz"), feats=feats,
                 d=d.cpu().numpy(), i=i.cpu().numpy(), launches=launches,
                 knn_ms=knn_ms, device=str(mesh.device))
    finally:
        dist.destroy_process_group()


def mesh_phase(eval_tree, gallery, desc, rows, dev, card, seed, tmp):
    """(m) The process-group mesh on the card. World size 1 through NCCL: a
    one-rank torchrun environment on a free localhost port, then
    maybe_init_distributed() and get_mesh(); extract_features_sharded
    (K1) against extract_features on 37 scenes at 480x640,
    topk_nearest_sharded over the 100,000 x 4096 gallery against
    topk_nearest (the same top-10 up to ties), run_eval(mesh=) on the Tokyo
    phase's mini root under ``tmp`` against the unsharded run_eval (each
    fitting its PCA on demand), and the times of the all-gather and the
    sharded kNN beside the unsharded ones; the group is destroyed after.
    Then two ranks on the one card through gloo (NCCL refuses two ranks on
    one device; gloo takes CUDA tensors for the all-gather), two spawned
    processes whose sharded extraction and kNN are held to the
    single-process results. K1's count is 0 just before each path and
    read just after. Returns K1's launches by path."""
    import multiprocessing

    import torch.distributed as dist

    from openibl_tpu_torch.config import DataConfig, EvalConfig
    from openibl_tpu_torch.data.loader import BatchLoader
    from openibl_tpu_torch.engine import pipeline
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops.distance import (topk_nearest,
                                                topk_nearest_sharded)
    from openibl_tpu_torch.parallel.extract import (extract_features,
                                                    extract_features_sharded)
    from openibl_tpu_torch.parallel.mesh import (all_gather_rows, get_mesh,
                                                 maybe_init_distributed)
    from openibl_tpu_torch.utils import f32_precision
    from openibl_tpu_torch.utils.checkpoint import save_checkpoint

    launches = {}
    images = scenes(np.random.RandomState(seed + 5), 37)
    save_checkpoint(osp.join(tmp, "model.npz"), {"params": eval_tree})
    model = eval_model(osp.join(tmp, "model.npz"), dev)
    saved = torchrun_env(free_port())
    try:
        t0 = time.perf_counter()
        maybe_init_distributed(device=dev)
        mesh = get_mesh(device=dev)
        check(dist.get_backend() == "nccl" and (mesh.rank, mesh.size)
              == (0, 1) and mesh.device.type == dev.type,
              f"maybe_init_distributed + get_mesh in a one-rank torchrun "
              f"environment: NCCL, rank 0 of 1 on {mesh.device} "
              f"({time.perf_counter() - t0:.2f} s)")

        # extraction: sharded (one rank: one plain pass) against plain
        src = Arrays(images)
        plain = extract_features(model, BatchLoader(src, batch_size=N_IMG),
                                 device_output=True)
        nk.netvlad_fused.launches = 0  # the sharded extraction starts
        sharded = extract_features_sharded(model, src, batch_size=N_IMG,
                                           mesh=mesh, device_output=True)
        launches["sharded_extract"] = nk.netvlad_fused.launches
        torch.testing.assert_close(sharded, plain, rtol=RTOL, atol=ATOL)
        check(launches["sharded_extract"] > 0,
              f"extract_features_sharded at world size 1 (NCCL) == "
              f"extract_features on {len(images)} images {H}x{W}: max |gap| "
              f"{float((sharded - plain).abs().max()):.3g}; K1 launched "
              f"{launches['sharded_extract']} times")
        ext_s = []
        for fn in (lambda: extract_features(
                model, BatchLoader(src, batch_size=N_IMG),
                device_output=True),
                lambda: extract_features_sharded(
                    model, src, batch_size=N_IMG, mesh=mesh,
                    device_output=True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ext_s.append(time.perf_counter() - t0)

        # the kNN over the gallery: sharded (one rank) against plain
        with f32_precision():
            d_p, i_p = topk_nearest(desc, gallery, k=10)
            d_s, i_s = topk_nearest_sharded(desc, gallery, mesh, k=10)
            check(*same_top10(d_s, i_s, d_p, i_p,
                              f"topk_nearest_sharded (NCCL, world size 1) "
                              f"vs topk_nearest, {len(desc)} queries over "
                              f"{GALLERY} x {DIM}"))
            check(torch.equal(i_s[:, 0].cpu(), torch.as_tensor(rows)),
                  "sharded kNN: every top-1 is its planted row")
            knn_ms = cuda_ms(lambda: topk_nearest(desc, gallery, k=10))
            sknn_ms = cuda_ms(lambda: topk_nearest_sharded(
                desc, gallery, mesh, k=10))
        pairs = (d_s, i_s, plain)
        gather_ms = [cuda_ms(lambda: all_gather_rows(mesh, t))
                     for t in pairs]
        print(f"timing mesh world size 1 (NCCL): extract_features "
              f"{ext_s[0]:.4f} s, extract_features_sharded {ext_s[1]:.4f} s "
              f"({len(images)} images, host clock to a synchronize); "
              f"topk_nearest {knn_ms:.4f} ms, topk_nearest_sharded "
              f"{sknn_ms:.4f} ms ({len(desc)} queries, top-10 of "
              f"{GALLERY} x {DIM}, CUDA events); all_gather_rows of the "
              f"(Q, 10) distances {gather_ms[0]:.4f} ms, indices "
              f"{gather_ms[1]:.4f} ms, the ({len(images)}, "
              f"{plain.shape[1]}) descriptors {gather_ms[2]:.4f} ms [{card}]")

        # run_eval on the Tokyo root: unsharded, and with the mesh
        recalls, walls = {}, {}
        for run in ("one", "mesh"):
            ckpt = save_checkpoint(osp.join(tmp, f"eval_{run}",
                                            "model_best.npz"),
                                   {"params": eval_tree}, {"epoch": 0})
            cfg = EvalConfig(
                data=DataConfig(dataset="tokyo",
                                data_dir=osp.join(tmp, "data"), height=H,
                                width=W, test_batch_size=N_IMG),
                checkpoint=ckpt, nms=True, reduction=True,
                pca_dataset="tokyo", pca_dim=TOKYO_PCA_DIM)
            t0 = time.perf_counter()
            nk.netvlad_fused.launches = 0  # the sharded eval path starts
            recalls[run] = pipeline.run_eval(
                cfg, device=dev, verbose=False,
                mesh=mesh if run == "mesh" else None)
            n = nk.netvlad_fused.launches  # ... and ends
            walls[run] = time.perf_counter() - t0
            if run == "mesh":
                launches["sharded_eval"] = n
        check(np.array_equal(recalls["mesh"], recalls["one"])
              and launches["sharded_eval"] > 0,
              f"run_eval(mesh=) on the Tokyo root (NCCL, world size 1; PCA "
              f"fitted on demand through the sharded extraction) == "
              f"run_eval: Recall@1/5/10 {list(map(float, recalls['mesh']))}"
              f"; K1 launched {launches['sharded_eval']} times")
        print(f"timing mesh run_eval tokyo: {walls['mesh']:.2f} s with the "
              f"mesh, {walls['one']:.2f} s without (host clock, PCA fit "
              f"included) [{card}]")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        restore_env(saved)
    check(not dist.is_initialized(), "the NCCL process group is destroyed")

    # two ranks on the one card through gloo, against the results above
    np.savez(osp.join(tmp, "mesh_inputs.npz"), images=images,
             desc=desc.cpu().numpy(), rows=np.asarray(rows),
             n_rows=len(gallery), batch=N_IMG)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=gloo_rank, args=(r, tmp, seed, dev.type))
             for r in range(2)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"two gloo ranks on the one card ran to their end: exit codes "
          f"{[p.exitcode for p in procs]} ({time.perf_counter() - t0:.2f} s "
          f"with start-up)")
    outs = [np.load(osp.join(tmp, f"rank{r}.npz")) for r in range(2)]
    for key in ("feats", "d", "i"):
        check(np.array_equal(outs[0][key], outs[1][key]),
              f"two gloo ranks: both hold the same {key}")
    got = torch.from_numpy(outs[0]["feats"])
    ref = plain.cpu()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    launches["two_rank_gloo"] = int(sum(o["launches"] for o in outs))
    check(launches["two_rank_gloo"] > 0
          and all(str(o["device"]) == str(mesh.device) for o in outs),
          f"extract_features_sharded on 2 gloo ranks on {mesh.device} "
          f"({len(images)} images: 19 each, the last one padded) == "
          f"single-process extract_features: max |gap| "
          f"{float((got - ref).abs().max()):.3g} ({gate_ratio(got, ref):.4f} "
          f"of the rtol {RTOL} / atol {ATOL} gate); K1 launched "
          f"{launches['two_rank_gloo']} times over both ranks")
    check(*same_top10(torch.from_numpy(outs[0]["d"]),
                      torch.from_numpy(outs[0]["i"]), d_p.cpu(), i_p.cpu(),
                      f"topk_nearest_sharded on 2 gloo ranks ({GALLERY // 2} "
                      f"rows each) vs single-process topk_nearest"))
    print(f"timing mesh 2 gloo ranks on one card: topk_nearest_sharded "
          f"{float(outs[0]['knn_ms']):.4f} ms on rank 0 ({len(desc)} "
          f"queries, top-10 of {GALLERY} x {DIM}; host clock to a "
          f"synchronize, the all-gather through host memory) [{card}]")
    del model, plain, sharded
    torch.cuda.empty_cache()
    return launches


def mesh_train_rank(rank, tmp, seed, device):
    """One of the mesh training phase's two ranks on the one card
    (``device``, e.g. "cuda"): a gloo group over its tensors (file store
    under ``tmp``), then from the initial parameters in ``tmp`` one
    device_jitter=True SARE-ind Trainer step and one SFRS gen-1 step
    (cuDNN off), each on this rank's tuple of a tuple_size=2 batch, each
    with the mesh; the all-reduce of the trained gradients timed (CUDA
    events). Losses, trained parameters and times go to
    ``tmp``/mesh_train<r>.npz."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from openibl_tpu_torch.parallel.mesh import all_reduce_mean_, get_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp}/mesh_store",
                            rank=rank, world_size=2)
    try:
        mesh = get_mesh(2, device=device)
        inputs = np.load(osp.join(tmp, "mesh_train_inputs.npz"))
        state = torch.load(osp.join(tmp, "mesh_train_state.pt"))
        out = {}
        # a CPU rehearsal of this phase passes device "cpu"
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        for name, region in (("base", False), ("sfrs", True)):
            model = mesh_train_model(state, region, mesh.device)
            prev = torch.backends.cudnn.enabled
            torch.backends.cudnn.enabled = not region
            try:
                sync()
                t0 = time.perf_counter()
                losses, trainer = mesh_train_step(
                    model, region, inputs[name][rank:rank + 1], seed, mesh)
                sync()
                out[f"{name}:wall_s"] = time.perf_counter() - t0
            finally:
                torch.backends.cudnn.enabled = prev
            out[f"{name}:losses"] = np.asarray(losses)
            for k, p in model.named_parameters():
                if p.requires_grad:
                    out[f"{name}:{k}"] = p.detach().cpu().numpy()
            grads = [torch.zeros_like(p) for p in
                     trainer.optimizer.param_groups[0]["params"]]
            out[f"{name}:grad_bytes"] = sum(g.numel() * g.element_size()
                                            for g in grads)
            out[f"{name}:all_reduce_ms"] = (
                cuda_ms(lambda: all_reduce_mean_(mesh, grads), reps=5,
                        warmup=1) if device == "cuda" else 0.0)
            del model, trainer, grads
        np.savez(osp.join(tmp, f"mesh_train{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def mesh_train_model(state, region, device):
    """The full-width EmbedNet (K=64; the EmbedRegionNet with ``region``)
    from ``state``, conv5 and NetVLAD trainable, on ``device``."""
    from openibl_tpu_torch import models

    model = models.create("embedregionnet" if region else "embednet",
                          net_vlad=models.NetVLAD(num_clusters=64))
    model.load_state_dict(state)
    model.base.freeze("conv5")
    return model.to(device, memory_format=torch.channels_last)


def mesh_train_step(model, region, tuples, seed, mesh=None):
    """One device_jitter=True step of the training phases' recipe on
    ``tuples`` (SARE-ind, lr 1e-3; SFRS at gen 1 against a teacher copied
    from the student): (losses, the trainer)."""
    from openibl_tpu_torch.engine.sfrs import SFRSTrainer, make_teacher
    from openibl_tpu_torch.engine.trainer import Trainer

    kw = dict(loss_type="sare_ind", lr=1e-3, mesh=mesh, device_jitter=True)
    if region:
        teacher = make_teacher(model)
        tr = SFRSTrainer(model, neg_num=SFRS_NEG, **kw)
        tr.init_generation()
        losses = tr.step(teacher, tuples, 1,
                         torch.Generator().manual_seed(seed + 10))
    else:
        tr = Trainer(model, **kw)
        tr.init()
        losses = [tr.step(tuples, torch.Generator().manual_seed(seed + 9))]
    return [float(x) for x in losses], tr


def mesh_train_phase(dev, card, seed, tmp, single):
    """(t) Data-parallel training on the card, on the training phase's
    world under ``tmp``. World size 1 through NCCL:
    examples/train_baseline_torch.py's main() in a one-rank torchrun
    environment on a free localhost port, with the training phase's config
    (its centroid cache), so run_baseline_training takes its mesh branch
    with real collectives; its step losses, final parameters and recalls
    held to the training phase's single-process run (``single``) at the
    training gate (step_gap), K1's launches counted on the run. Then two
    gloo ranks on the one card (NCCL refuses two ranks on one device): one
    device_jitter=True SARE-ind step and one SFRS gen-1 step (cuDNN off)
    at full width, each rank one tuple of a tuple_size=2 batch, held to
    the one-process step on both tuples at the training gate, and the two
    ranks' trained parameters bit for bit. Prints each path's wall time
    and the all-reduce's time. Returns K1's launches on the torchrun
    run."""
    import multiprocessing

    import torch.distributed as dist

    from openibl_tpu_torch.data.loader import ImageSource
    from openibl_tpu_torch.data.transforms import TestTransform
    from openibl_tpu_torch.engine import pipeline
    from openibl_tpu_torch.engine.trainer import Trainer
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.parallel.mesh import all_reduce_mean_, get_mesh

    cfg = single["cfg"]
    spec = importlib.util.spec_from_file_location(
        "train_baseline_torch", osp.join(ROOT, "examples",
                                         "train_baseline_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["-d", "synthetic", "--data-dir", cfg.data.data_dir,
            "--logs-dir", osp.join(tmp, "mesh_train_logs"), "--init-dir",
            cfg.init_dir, "--height", str(H), "--width", str(W),
            "--test-batch-size", str(N_IMG), "--loss-type", cfg.loss_type,
            "--tuple-size", str(cfg.tuple_size), "--neg-num",
            str(cfg.neg_num), "--iters", str(cfg.iters), "--epochs",
            str(cfg.epochs), "--print-freq", str(cfg.print_freq), "--seed",
            str(cfg.seed), "--n-devices", "1", "--device", dev.type]
    _, cli_cfg = example.parse(argv)
    same = dataclasses.replace(
        cli_cfg, logs_dir=cfg.logs_dir,
        data=dataclasses.replace(cli_cfg.data, scale=cfg.data.scale))
    check(same == cfg, "the example's command line gives the training "
                       "phase's config (its logs directory apart)")

    saved = torchrun_env(free_port())
    losses, step = [], Trainer.step

    def counted_step(self, images, generator=None):
        losses.append(step(self, images, generator))
        return losses[-1]

    stdout = sys.stdout
    Trainer.step = counted_step
    t0 = time.perf_counter()
    try:
        nk.netvlad_fused.launches = 0  # the torchrun training path starts
        model, final, history = example.main(argv)
        launches = nk.netvlad_fused.launches  # ... and ends
        wall = time.perf_counter() - t0
        mesh = get_mesh(device=dev)
        check(dist.get_backend() == "nccl" and (mesh.rank, mesh.size)
              == (0, 1), f"the example joined a one-rank NCCL group on "
                         f"{mesh.device} and trained through its mesh branch")
        grads = [torch.zeros_like(p) for p in model.parameters()
                 if p.requires_grad]
        reduce_ms = cuda_ms(lambda: all_reduce_mean_(mesh, grads))
        grad_mb = sum(g.numel() * g.element_size() for g in grads) / 2**20
    finally:
        Trainer.step = step
        if sys.stdout is not stdout:  # the example's rank-0 log
            sys.stdout.close()
            sys.stdout = stdout
        if dist.is_initialized():
            dist.destroy_process_group()
        restore_env(saved)
    check(not dist.is_initialized(), "the NCCL process group is destroyed")
    ours = ([float(x) for x in losses],
            {k: v.detach().cpu().double()
             for k, v in model.state_dict().items()})
    gap = step_gap(ours, (single["losses"], single["after"]),
                   single["before"])
    check(len(ours[0]) == len(single["losses"]) and gap[0] < 1e-4
          and gap[1][0] <= 1.0 and gap[3],
          f"examples/train_baseline_torch.py under a one-rank torchrun "
          f"(NCCL) == the training phase's run_baseline_training: "
          f"{len(ours[0])} steps, losses {ours[0]} vs {single['losses']}; "
          f"{gap_text(gap)} (gates: loss 1e-4, updates 1, parameters "
          f"within rtol 1e-3 / atol 1e-3 of the layer's largest update)")
    check([list(map(float, r)) for _, r in history]
          == [list(map(float, r)) for _, r in single["history"]]
          and list(map(float, final)) == list(map(float, single["final"])),
          f"the same validation and PCA test Recall@1/5/10: "
          f"{[list(map(float, r)) for _, r in history]}, "
          f"{list(map(float, final))}")
    check(launches > 0, f"K1 launched {launches} times on the torchrun "
                        f"training path (mining, validation, PCA fit, test)")
    print(f"timing mesh training world size 1 (NCCL): the example's run "
          f"{wall:.2f} s, the training phase's run_baseline_training "
          f"{single['wall']:.2f} s (host clock; that one the process's "
          f"first training run); all_reduce_mean_ "
          f"of the {len(grads)} trained gradients ({grad_mb:.2f} MiB f32) "
          f"{reduce_ms:.4f} ms (CUDA events) [{card}]")
    del model, grads

    # two gloo ranks on the one card, each one tuple of a tuple_size=2
    # batch, against one process on both tuples
    dataset = pipeline.load_dataset(cfg)
    src = ImageSource(dataset.q_train + dataset.db_train, dataset.images_dir,
                      TestTransform(H, W, device_normalize=True))
    inputs = {name: np.stack([src.load(i % len(src)) for i in range(2 * g)])
              .reshape(2, g, H, W, 3) for name, g in (
                  ("base", 2 + TRAIN_NEG), ("sfrs", 2 + SFRS_NEG + SFRS_POS))}
    np.savez(osp.join(tmp, "mesh_train_inputs.npz"), **inputs)
    torch.save(single["before"], osp.join(tmp, "mesh_train_state.pt"))
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_train_rank, args=(r, tmp, seed,
                                                        dev.type))
             for r in range(2)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    spawn_s = time.perf_counter() - t0
    check(all(p.exitcode == 0 for p in procs),
          f"two gloo ranks on the one card trained to their end: exit codes "
          f"{[p.exitcode for p in procs]} ({spawn_s:.2f} s with start-up)")
    outs = [dict(np.load(osp.join(tmp, f"mesh_train{r}.npz")))
            for r in range(2)]
    for name, region in (("base", False), ("sfrs", True)):
        keys = [k for k in outs[0] if k.startswith(f"{name}:")
                and k.split(":", 1)[1] in single["before"]]
        check(all(np.array_equal(outs[0][k], outs[1][k]) for k in keys)
              and np.array_equal(outs[0][f"{name}:losses"],
                                 outs[1][f"{name}:losses"]),
              f"two gloo ranks: both hold the same {len(keys)} trained "
              f"tensors and losses after the {name} step, bit for bit")
        model = mesh_train_model(single["before"], region, dev)
        prev = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = not region
        try:
            one, _ = mesh_train_step(model, region, inputs[name], seed)
        finally:
            torch.backends.cudnn.enabled = prev
        trained = {k: v.detach().cpu().double()
                   for k, v in model.named_parameters() if v.requires_grad}
        two = ([float(x) for x in outs[0][f"{name}:losses"]],
               {k.split(":", 1)[1]: torch.from_numpy(outs[0][k]).double()
                for k in keys})
        gap = step_gap(two, (one, trained),
                       {k: single["before"][k] for k in trained})
        check(gap[0] < 1e-4 and gap[1][0] <= 1.0 and gap[3],
              f"the {name} step (device_jitter=True"
              f"{', cuDNN off' if region else ''}) on 2 gloo ranks, one "
              f"tuple each, == one process on both tuples: losses "
              f"{two[0]} vs {one}; {gap_text(gap)} (gates as above)")
        print(f"timing mesh training 2 gloo ranks on one card, {name} step "
              f"(1 tuple a rank, {H}x{W}): {outs[0][f'{name}:wall_s']:.4f} "
              f"s on rank 0 (host clock to a synchronize, first step of "
              f"the process); all_reduce_mean_ of the trained gradients "
              f"({outs[0][f'{name}:grad_bytes'] / 2**20:.2f} MiB f32, "
              f"through host memory) {outs[0][f'{name}:all_reduce_ms']:.4f}"
              f" ms (CUDA events) [{card}]")
        del model
    torch.cuda.empty_cache()
    return launches


def matches_di(results):
    """A service's match lists → (sq_dists, indices) tensors (Q, k)."""
    return (torch.tensor([[m["sq_dist"] for m in r] for r in results]),
            torch.tensor([[m["index"] for m in r] for r in results]))


def serve_cases(inputs, gallery):
    """The mesh_serve phase's two-rank cases: (name, index, service
    options, rows) for the exact and PQ index over the whole gallery and
    over all rows but the last (a ragged split: the last rank's shard is
    padded)."""
    pq = {k: inputs[k] for k in ("pq_codes", "pq_codebooks", "pq_rotation")}
    cases = []
    for n in (len(gallery), len(gallery) - 1):
        cases.append((f"exact_{n}", {"descriptors": gallery[:n]}, {}, n))
        cases.append((f"pq_{n}", {**pq, "pq_codes": pq["pq_codes"][:n]},
                      {"use_pq": True}, n))
    return cases


def mesh_serve_rank(rank, tmp, seed, device):
    """One of the mesh_serve phase's two gloo ranks on the one card: every
    case of ``serve_cases`` as a RetrievalService(mesh=) (rank 0 queries
    the planted images, rank 1 follows), each rank's resident rows, K2's
    and K1's launches on the served path, each rank's K2 on its resident
    codes against the plain scorer, rank 0's p50 at batch 1, and the
    per-query cost of the lockstep header, the descriptor broadcast and
    the candidates' all-gather (host clock on rank 0); results to
    ``tmp``/serve_rank<r>.npz."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops import pq_kernel as pk
    from openibl_tpu_torch.ops.distance import merge_across_ranks
    from openibl_tpu_torch.ops.pq import _split_subspaces, _sub_d2
    from openibl_tpu_torch.parallel.mesh import Lockstep, get_mesh
    from openibl_tpu_torch.serving import RetrievalService

    dist.init_process_group("gloo", init_method=f"file://{tmp}/serve_store",
                            rank=rank, world_size=2)
    out = {}
    try:
        mesh = get_mesh(2, device=device)
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        inputs = np.load(osp.join(tmp, "serve_inputs.npz"))
        desc = torch.from_numpy(inputs["desc"]).to(mesh.device)
        n_rows, images = int(inputs["n_rows"]), inputs["images"]
        # the served gallery, made from its seed as the parent made it,
        # then held on the host: each service keeps only its rank's rows
        gallery = planted_gallery(mesh.device, seed, inputs["rows"], desc,
                                  n_rows).cpu().numpy()
        if device == "cuda":
            torch.cuda.empty_cache()
        for name, idx, kw, n in serve_cases(inputs, gallery):
            svc = RetrievalService(idx, weights=str(inputs["weights"]),
                                   height=images.shape[1],
                                   width=images.shape[2], mesh=mesh,
                                   device=mesh.device, **kw)
            out[f"{name}:rows"] = svc._gallery.shape[0]
            if rank:
                pk.adc_tile.launches = 0  # the follower's path starts
                svc.follow()
                out[f"{name}:k2"] = pk.adc_tile.launches  # ... and ends
            else:
                svc.warmup()
                nk.netvlad_fused.launches = pk.adc_tile.launches = 0
                d, i = matches_di(svc.query(list(images), topk=10))
                out[f"{name}:k1"] = nk.netvlad_fused.launches
                out[f"{name}:k2"] = pk.adc_tile.launches
                out[f"{name}:d"], out[f"{name}:i"] = d.numpy(), i.numpy()
                if n == n_rows:
                    out[f"{name}:p50"] = p50_query_ms(svc, images)
                svc.close()
            if name == f"pq_{n_rows}":
                # K2 on this rank's resident codes against the plain scorer
                q = desc @ svc._pq_rotation
                lut = _sub_d2(_split_subspaces(q, svc._gallery.shape[1]),
                              svc._pq_codebooks).contiguous()
                got = pk.adc_tile(lut, svc._gallery)
                ref = pk.adc_tile_plain(lut, svc._gallery)
                sync()
                out["k2_err"] = float((got - ref).abs().max())
                out["k2_close"] = bool(torch.allclose(got, ref, rtol=K2_TOL,
                                                      atol=K2_TOL))
            del svc
        # what one batch-1 query adds on rank 0's path: the header, the
        # (1, 4096) descriptors' broadcast, the candidates' all-gather
        lockstep = Lockstep(mesh)
        one = desc[:1].contiguous()
        cand_d = torch.rand((1, 10), device=mesh.device)
        cand_i = torch.arange(10, device=mesh.device)[None]
        parts = {"header": lambda: (lockstep.send(1, 1, 10) if rank == 0
                                    else lockstep.recv()),
                 "broadcast": lambda: dist.broadcast(one, src=0),
                 "all_gather": lambda: merge_across_ranks(mesh, cand_d,
                                                          cand_i, 10)}
        for part, fn in parts.items():
            times = []
            for _ in range(60):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"{part}_ms"] = statistics.median(times[10:])
        out["device"] = str(mesh.device)
        np.savez(osp.join(tmp, f"serve_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def mesh_serve_phase(index, built, weights, images, rows, desc, single, dev,
                     card, seed, tmp):
    """(s) Mesh-sharded serving on the card. World size 1 through NCCL (a
    one-rank torchrun environment): RetrievalService(mesh=) over the
    100,000 x 4096 gallery (exact) and its OPQ m=64 codes (PQ), the planted
    queries' top-10 against the single-device services' (``single``), K1
    and K2 counted, p50 at batch 1. Then two gloo ranks on the card
    (``mesh_serve_rank``; rank 0 serves, rank 1 follows) over 100,000 and
    99,999 rows, against single-device searches of the same descriptors.
    Then examples/serve_torch.py --n-devices 1 under a one-rank torchrun:
    /healthz, one POST /query against the single-device PQ service,
    SIGTERM to rank 0 and every rank's clean exit. Then
    graft_entry_torch.dryrun_multichip(2, backend="gloo") and entry().
    Returns {path: launches} for K1 and for K2."""
    import multiprocessing

    import torch.distributed as dist

    from graft_entry_torch import dryrun_multichip, entry
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops import pq_kernel as pk
    from openibl_tpu_torch.ops.distance import topk_nearest
    from openibl_tpu_torch.ops.pq import pq_search
    from openibl_tpu_torch.parallel.mesh import (get_mesh,
                                                 maybe_init_distributed)
    from openibl_tpu_torch.serving import RetrievalService

    k1, k2, errs = {}, {}, []
    paths, gallery = index["paths"], index["descriptors"]
    opq = built["opq"]
    served = {"exact": ({"descriptors": gallery, "paths": paths}, {}),
              "pq": ({"paths": paths, **opq}, {"use_pq": True})}
    tie = {"exact": 1e-5, "pq": 1e-3}

    # -- world size 1 through NCCL -------------------------------------------
    saved = torchrun_env(free_port())
    try:
        maybe_init_distributed(device=dev)
        mesh = get_mesh(device=dev)
        check(dist.get_backend() == "nccl" and mesh.size == 1,
              "mesh_serve: a one-rank NCCL group")
        for mode, (idx, kw) in served.items():
            t0 = time.perf_counter()
            svc = RetrievalService(idx, weights=weights, height=H, width=W,
                                   mesh=mesh, device=dev, **kw)
            svc.warmup()
            torch.cuda.synchronize()
            built_s = time.perf_counter() - t0
            nk.netvlad_fused.launches = pk.adc_tile.launches = 0  # starts
            d, i = matches_di(svc.query(list(images), topk=10))
            k1[f"mesh_serve_{mode}_nccl"] = nk.netvlad_fused.launches
            if mode == "pq":
                k2["mesh_serve_pq_nccl"] = pk.adc_tile.launches  # ends
            sd, si = matches_di(single[mode])
            check(*same_top10_up_to_cut(
                d, i, sd, si, f"RetrievalService(mesh=) {mode} (NCCL, world "
                f"size 1, {svc._gallery.shape[0]} resident rows) vs the "
                f"single-device service, {len(images)} planted queries",
                tie[mode]))
            check(nk.netvlad_fused.launches > 0 and (
                mode == "exact" or pk.adc_tile.launches > 0),
                f"mesh_serve {mode} (NCCL): K1 launched "
                f"{nk.netvlad_fused.launches} times, K2 "
                f"{pk.adc_tile.launches}")
            p50 = p50_query_ms(svc, images)
            print(f"timing mesh_serve {mode} (NCCL, world size 1) batch 1, "
                  f"top-10 of {GALLERY}: p50 {p50:.4f} ms, single-device "
                  f"p50 {single[mode + '_p50']:.4f} ms (host clock, 25 "
                  f"queries; built and warmed in {built_s:.2f} s) [{card}]")
            svc.close()
            del svc
            torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        restore_env(saved)
    check(not dist.is_initialized(), "the NCCL process group is destroyed")

    # -- two gloo ranks on the one card --------------------------------------
    np.savez(osp.join(tmp, "serve_inputs.npz"), images=images,
             desc=desc.cpu().numpy(), rows=np.asarray(rows),
             n_rows=len(gallery), weights=np.asarray(weights), **opq)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_serve_rank, args=(r, tmp, seed,
                                                       dev.type))
             for r in range(2)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"mesh_serve: two gloo ranks on the one card ran to their end: "
          f"exit codes {[p.exitcode for p in procs]} "
          f"({time.perf_counter() - t0:.2f} s with start-up)")
    outs = [dict(np.load(osp.join(tmp, f"serve_rank{r}.npz")))
            for r in range(2)]
    g_dev = torch.from_numpy(gallery).to(dev)
    codes = torch.from_numpy(opq["pq_codes"]).to(dev)
    for name, _, _, n in serve_cases(opq, gallery):
        mode = name.split("_")[0]
        per = -(-n // 2)
        check(all(int(o[f"{name}:rows"]) == per for o in outs),
              f"mesh_serve {name}: each rank holds {per} of {n} rows on the "
              f"card ({[int(o[f'{name}:rows']) for o in outs]})")
        if n == GALLERY:
            sd, si = matches_di(single[mode])
        elif mode == "exact":
            sd, si = topk_nearest(desc, g_dev[:n], k=10)
        else:
            sd, si = pq_search(desc, codes[:n], opq["pq_codebooks"], k=10,
                               rotation=opq["pq_rotation"])
        d = torch.from_numpy(outs[0][f"{name}:d"])
        i = torch.from_numpy(outs[0][f"{name}:i"])
        check(bool((i < n).all() & (i >= 0).all()),
              f"mesh_serve {name}: every id is a real row (< {n})")
        check(*same_top10_up_to_cut(
            d, i, sd, si, f"RetrievalService(mesh=) {name} on 2 gloo ranks "
            f"vs single-device, {len(images)} planted queries", tie[mode]))
        k1[f"mesh_serve_{name}_gloo_rank0"] = int(outs[0][f"{name}:k1"])
        check(k1[f"mesh_serve_{name}_gloo_rank0"] > 0,
              f"mesh_serve {name}: K1 launched "
              f"{k1[f'mesh_serve_{name}_gloo_rank0']} times on rank 0")
        if mode == "pq":
            for r, o in enumerate(outs):
                k2[f"mesh_serve_{name}_gloo_rank{r}"] = int(o[f"{name}:k2"])
            check(all(int(o[f"{name}:k2"]) > 0 for o in outs),
                  f"mesh_serve {name}: K2 launched "
                  f"{[int(o[f'{name}:k2']) for o in outs]} times on ranks "
                  f"0 and 1")
    for r, o in enumerate(outs):
        errs.append(float(o["k2_err"]))
        check(bool(o["k2_close"]),
              f"mesh_serve rank {r}: K2 on its {int(o[f'pq_{GALLERY}:rows'])}"
              f" resident codes == plain scorer, max_abs_err "
              f"{float(o['k2_err']):.3g} (rtol/atol {K2_TOL})")
    print(f"timing mesh_serve 2 gloo ranks on one card, rank 0, batch 1, "
          f"top-10 of {GALLERY}: p50 exact "
          f"{float(outs[0][f'exact_{GALLERY}:p50']):.4f} ms, PQ "
          f"{float(outs[0][f'pq_{GALLERY}:p50']):.4f} ms (single-device "
          f"{single['exact_p50']:.4f}, {single['pq_p50']:.4f}); per query: "
          f"header {float(outs[0]['header_ms']):.4f} ms, descriptor "
          f"broadcast {float(outs[0]['broadcast_ms']):.4f} ms, candidates' "
          f"all-gather {float(outs[0]['all_gather_ms']):.4f} ms (host "
          f"clock, medians of 50) [{card}]")
    del g_dev, codes
    torch.cuda.empty_cache()

    # -- examples/serve_torch.py under a one-rank torchrun --------------------
    idx_path = osp.join(tmp, "pq_index.npz")
    np.savez(idx_path, paths=paths, **opq)
    http_port = free_port()
    log_path = osp.join(tmp, "serve_torchrun.log")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK")}
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node=1", f"--master-port={free_port()}",
             osp.join(ROOT, "examples", "serve_torch.py"), idx_path,
             "--weights", weights, "--pq", "--n-devices", "1",
             "--height", str(H), "--width", str(W),
             "--port", str(http_port), "--device", dev.type],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    try:
        base = f"http://127.0.0.1:{http_port}"
        health, deadline = None, time.time() + 300
        while health is None and time.time() < deadline \
                and proc.poll() is None:
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    health = json.loads(r.read())
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        check(health == {"ok": True, "index_size": GALLERY},
              f"serve_torch.py --n-devices 1 under torchrun: /healthz "
              f"{health} after {up_s:.2f} s")
        buf = io.BytesIO()
        Image.fromarray(images[0]).save(buf, format="PNG")
        req = urllib.request.Request(base + "/query?topk=10",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())["matches"]
        d, i = matches_di([got])
        sd, si = matches_di(single["pq"][:1])
        check(*same_top10_up_to_cut(
            d, i, sd, si, "serve_torch.py --n-devices 1 POST /query vs the "
            "single-device PQ service, image 0", tie["pq"]))
        pid = int(re.search(r"pid (\d+)", open(log_path).read()).group(1))
        os.kill(pid, signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = open(log_path).read()
    check(rc == 0 and "stopping" in text,
          f"serve_torch.py under torchrun: SIGTERM to rank 0 closed the "
          f"service and every rank exited 0 (torchrun exit code {rc})")

    # -- the dry-run twin on the card, and entry() ----------------------------
    t0 = time.perf_counter()
    dryrun_multichip(2, device=dev.type, backend="gloo")
    dry_s = time.perf_counter() - t0
    fn, args = entry(dev)
    with torch.inference_mode():
        out = fn(*args)
    norm = float(out.norm())
    check(tuple(out.shape) == (1, DIM) and bool(out.isfinite().all())
          and abs(norm - 1) < 1e-4,
          f"graft_entry_torch: dryrun_multichip(2, backend='gloo') passed "
          f"on the card in {dry_s:.2f} s; entry() gives a "
          f"{tuple(out.shape)} descriptor of norm {norm:.6f}")
    del fn, args, out
    torch.cuda.empty_cache()
    return k1, k2, max(errs)



def tools_phase(dev, card, tmp):
    """The seven measurement tools of openibl_tpu_torch/tools on the card at
    full width, each through its ``main(argv)`` as ``python -m`` runs it
    (profile_phases in a process of its own: its profiler session would add
    host cost to this process's later launches), with their artifacts under
    ``tmp``. Checks each against its gate and returns the K1 and K2 launches
    of each tool's run ({label: count}, counts set to 0 just before)."""
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops import pq_kernel as pk
    from openibl_tpu_torch.tools import (
        bench_serving, ivf_recall, pq_recall, profile_backbone, profile_head,
        time_sfrs_rerank)

    k1, k2 = {}, {}

    def run_tool(label, fn):
        nk.netvlad_fused.launches = pk.adc_tile.launches = 0
        t0 = time.perf_counter()
        out = fn()
        k1[label], k2[label] = nk.netvlad_fused.launches, pk.adc_tile.launches
        print(f"phase tools {label}: {time.perf_counter() - t0:.2f} s, K1 "
              f"launches {k1[label]}, K2 launches {k2[label]} [{card}]",
              flush=True)
        print(f"timing tools {label}: {json.dumps(out)} [{card}]", flush=True)
        return out

    # recall on model descriptors (EmbedNet K=8 over the synthetic world)
    ivf = run_tool("ivf_recall", lambda: ivf_recall.main(
        ["--out", osp.join(tmp, "ivf_recall.json")]))
    curve, nlist = ivf["recall_at_k_vs_exact"], ivf["nlist"]
    check(curve[nlist] == 1.0 and curve[nlist // 8] >= 0.95,
          f"ivf_recall over {ivf['gallery']} descriptors: recall@10 "
          f"{curve[nlist]} at nprobe = nlist = {nlist} (gate 1.0), "
          f"{curve[nlist // 8]} at nlist/8 (gate >= 0.95)")
    check(k1["ivf_recall"] > 0, "ivf_recall's extraction launched K1")
    pq = run_tool("pq_recall", lambda: pq_recall.main(
        ["--opq-iters", str(TOOLS_OPQ_ITERS),
         "--out", osp.join(tmp, "pq_recall.json")]))
    row, ivfpq = pq["pq"][16], pq["ivfpq"]
    full = ivfpq["recall_in_top_4k_by_nprobe"][ivfpq["nlist"]]
    check(row["recall_at_k"] >= 0.95 and row["recall_at_k_in_top_4k"] >= 0.98
          and full >= 0.98,
          f"pq_recall m=16: recall@10 {row['recall_at_k']} (gate >= 0.95), "
          f"in top-40 {row['recall_at_k_in_top_4k']} (>= 0.98); IVFADC at "
          f"full probe {full} (>= 0.98)")
    check(k2["pq_recall"] > 0, "pq_recall's searches launched K2")

    # the SFRS refresh's Jaccard: Pitts30k's union, then r1 at a smaller n
    big = run_tool("time_sfrs_rerank_17000", lambda: time_sfrs_rerank.main(
        ["--n", "17000", "--queries", "1000", "--skip-r1",
         "--out", osp.join(tmp, "sfrs_17000.json")]))
    check(big["engines_max_abs_diff"] <= time_sfrs_rerank.ATOL
          + time_sfrs_rerank.RTOL,
          f"time_sfrs_rerank n=17000: device Jaccard within rtol 1e-5 / "
          f"atol 1e-6 of the host's (max |diff| "
          f"{big['engines_max_abs_diff']:.3g}; the tool checks allclose)")
    run_tool("time_sfrs_rerank_4000", lambda: time_sfrs_rerank.main(
        ["--n", "4000", "--n-q", "1722", "--queries", "1000",
         "--out", osp.join(tmp, "sfrs_4000.json")]))

    # the head's pieces at batch 128, then K1 and the f32 PCA held
    run_tool("profile_head", lambda: profile_head.main(["--batch", "128"]))
    vp, pp, fmap, desc = profile_head.inputs(128, dev)
    pieces = profile_head.head_pieces(vp, pp)
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    with torch.inference_mode():
        ratio = gate_ratio(pieces["netvlad_fused"](fmap),
                           pieces["netvlad_xla"](fmap))
        try:
            flags.allow_tf32 = True
            on = pieces["pca_highest"](desc)
            flags.allow_tf32 = False
            off = pieces["pca_highest"](desc)
        finally:
            flags.allow_tf32 = prev
    check(ratio <= 1, f"profile_head batch 128: K1's descriptor vs the plain "
          f"head's within rtol 1e-4 / atol 1e-5 ({ratio:.3f} of the gate)")
    check(torch.equal(on, off), "profile_head pca_highest bit-equal with the "
          "global TF32 flag on and off")
    del vp, pp, fmap, desc, pieces, on, off
    torch.cuda.empty_cache()

    for batch in (16, 128):
        bb = run_tool(f"profile_backbone_bs{batch}",
                      lambda b=batch: profile_backbone.main(
                          ["--batch", str(b), "--iters",
                           str(TOOLS_BACKBONE_ITERS)]))
        gap = abs(bb["conv_ms"] + bb["head_ms"] - bb["full_ms"])
        check(gap < 1e-3 and len(bb["layers"]) == 13
              and all(np.isfinite(r["ms"]) for r in bb["layers"]),
              f"profile_backbone batch {batch}: 13 layers, conv_ms "
              f"{bb['conv_ms']} + head_ms {bb['head_ms']} = full_ms "
              f"{bb['full_ms']} (within {gap:.2g})")
        torch.cuda.empty_cache()

    # one training epoch's phases, traced, in a process of its own
    trace_dir = osp.join(tmp, "traces")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "openibl_tpu_torch.tools.profile_phases",
         "--trace-dir", trace_dir], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    check(res.returncode == 0, f"profile_phases exit code {res.returncode}"
          f"{'' if res.returncode == 0 else ': ' + res.stderr[-2000:]}")
    phases = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"phase tools profile_phases: {time.perf_counter() - t0:.2f} s "
          f"(a process of its own) [{card}]")
    print(f"timing tools profile_phases: {json.dumps(phases)} [{card}]")
    names = set()
    for path in os.listdir(trace_dir):
        with open(osp.join(trace_dir, path)) as f:
            names |= set(re.findall(r"vlad_(?:assign|aggregate|norm)_kernel",
                                    f.read()))
    check(phases["image_hw"] == [480, 640]
          and set(phases["phases"]) == {"mining_extract", "mining_refresh",
                                        "train", "eval"}
          and names == {"vlad_assign_kernel", "vlad_aggregate_kernel",
                        "vlad_norm_kernel"},
          f"profile_phases at 480x640: phases {sorted(phases['phases'])}, "
          f"its trace names K1's kernels {sorted(names)}")

    # the serving table: both passes, then a second call of each skips
    out = osp.join(tmp, "serving_latency.json")
    argv = ["--out", out, "--iters", str(TOOLS_SERVING_ITERS)]
    run_tool("bench_serving", lambda: bench_serving.main(argv))
    run_tool("bench_serving_device_time",
             lambda: bench_serving.main(argv + ["--device-time"]))
    with open(out) as f:
        table = json.load(f)
    for name in bench_serving.VARIANTS:
        r = table["variants"][name]
        p50s = [r[f"bs{b}"]["p50_ms"] for b in (1, 4, 16)]
        check(all(np.isfinite(p50s)) and np.isfinite(
            r["device_ms_per_query"]),
              f"bench_serving {name} over {table['gallery_size']} rows: p50 "
              f"bs1/4/16 {p50s} ms, device {r['device_ms_per_query']} "
              f"ms/query, host syncs {r['host_syncs'] or 'none'}")
    t0 = time.perf_counter()
    again = [bench_serving.main(argv)["measured"],
             bench_serving.main(argv + ["--device-time"])["measured"]]
    check(again == [[], []], f"bench_serving called again skips every "
          f"variant of both passes (resume, {time.perf_counter() - t0:.2f} s)")
    check(k1["bench_serving"] > 0 and k2["bench_serving"] > 0
          and k1["bench_serving_device_time"] > 0
          and k2["bench_serving_device_time"] > 0,
          "bench_serving launched K1 and K2 in both passes")
    return ({label: n for label, n in k1.items() if n},
            {label: n for label, n in k2.items() if n})


def bench_phase(dev, card, tmp, extract_f32, train_f32):
    """(v) The bench lane at full width: tools/bench.py's metrics through
    its ``main(argv)`` in process, probe_index_paths at its defaults, then
    bench_all's entries the in-process runs leave out, as subprocesses of
    ``bench_torch.py`` with their artifact under ``tmp``, and bench_all
    again, which must skip every entry. ``extract_f32`` and ``train_f32``
    are phase 7's f32 extraction img/s and the train phase's SARE tuples/s
    at the same shapes. Returns K1's and K3's launches per bench run
    ({label: count}, counts set to 0 just before each)."""
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops import quant_kernel as qk
    from openibl_tpu_torch.ops.distance import topk_nearest
    from openibl_tpu_torch.tools import bench, bench_all
    from openibl_tpu_torch.tools import probe_index_paths as probe
    from openibl_tpu_torch.utils import f32_precision

    t_phase = time.perf_counter()
    keys = {"metric", "value", "unit", "vs_baseline"}
    size = ["--height", str(H), "--width", str(W), "--device", dev.type,
            "--max-seconds", "600"]
    k1, k3, lines = {}, {}, {}

    def run_bench(label, argv, names):
        nk.netvlad_fused.launches = qk.int8_conv.launches = 0
        t0 = time.perf_counter()
        out = bench.main(argv + size)
        k1[label], k3[label] = nk.netvlad_fused.launches, \
            qk.int8_conv.launches
        print(f"phase bench {label}: {time.perf_counter() - t0:.2f} s, K1 "
              f"launches {k1[label]}, K3 launches {k3[label]} [{card}]",
              flush=True)
        for ln in out:
            print(f"timing bench {label}: {json.dumps(ln)} [{card}]")
        check([ln["metric"] for ln in out] == names
              and all(keys <= set(ln) and np.isfinite(ln["value"])
                      and ln["value"] > 0 for ln in out),
              f"bench {' '.join(argv)}: one line each named {names}, "
              f"values {[ln['value'] for ln in out]} finite and > 0")
        lines[label] = out
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    bs, it = str(BENCH_BATCH), str(BENCH_ITERS)
    img = f"descriptor_images_per_sec_per_chip_{H}x{W}"
    run_bench("extract", ["--batch-size", bs, "--iters", it],
              [f"{img}_bfloat16_bs{bs}", f"{img}_bfloat16_int8_bs{bs}"])
    run_bench("extract_f32", ["--batch-size", bs, "--iters", it, "--dtype",
                              "float32", "--no-int8"],
              [f"{img}_float32_bs{bs}"])
    run_bench("extract_nofused", ["--batch-size", bs, "--iters", it,
                                  "--no-int8", "--no-fused"],
              [f"{img}_bfloat16_bs{bs}"])
    query = ["--metric", "query", "--gallery-size", str(GALLERY)]
    run_bench("query", query, [f"query_p50_latency_ms_{GALLERY}gallery"])
    run_bench("query_device", query + ["--device-time"],
              [f"query_device_ms_{GALLERY}gallery_scan50"])
    run_bench("query_ivf32", query + ["--ivf-nprobe", "32"],
              [f"query_p50_latency_ms_{GALLERY}gallery_ivf32of256"])
    run_bench("query_ivf32_device", query + ["--ivf-nprobe", "32",
                                             "--device-time"],
              [f"query_device_ms_{GALLERY}gallery_ivf32of256_scan50"])
    for dtype in ("float32", "bfloat16"):
        tag = "_f32" if dtype == "float32" else ""
        run_bench(f"train{tag}", ["--metric", "train", "--dtype", dtype],
                  [f"sare_train_tuples_per_sec_{H}x{W}_{dtype}_ts4"])
        run_bench(f"sfrs{tag}", ["--metric", "sfrs", "--dtype", dtype],
                  [f"sfrs_train_tuples_per_sec_{H}x{W}_{dtype}_ts1"])

    f32 = lines["extract_f32"][0]["value"]
    check(abs(f32 / extract_f32 - 1) < 0.15,
          f"bench f32 extraction {f32} img/s within 15% of phase 7's "
          f"{extract_f32:.2f} (batch {bs}, {H}x{W})")
    sare = lines["train_f32"][0]["value"]
    check(abs(sare / train_f32 - 1) < 0.15,
          f"bench SARE f32 ts4 {sare} tuples/s within 15% of the train "
          f"phase's {train_f32:.3f}")
    forwards = BENCH_ITERS + 1  # a warm forward, then the timed ones
    check(k1["extract"] > 0 and k1["extract_f32"] > 0
          and k1["extract_nofused"] == 0 and k1["query"] > 0
          and k1["query_device"] > 0 and k1["query_ivf32"] > 0
          and k1["query_ivf32_device"] > 0,
          f"K1 launched on the fused extracts ({k1['extract']}, "
          f"{k1['extract_f32']}) and the queries ({k1['query']}, "
          f"{k1['query_device']}, {k1['query_ivf32']}, "
          f"{k1['query_ivf32_device']}), not on --no-fused "
          f"({k1['extract_nofused']})")
    check(k3["extract"] == 11 * forwards,
          f"K3 launched {k3['extract']} times on the int8 extract: 11 "
          f"layers x {forwards} forwards")

    # the index probe at its defaults, then f32_full and f32_norms held to
    # topk_nearest on the first query batch
    t0 = time.perf_counter()
    pargv = ["--n", str(GALLERY), "--d", str(DIM), "--device", dev.type]
    probed = probe.main(pargv)
    print(f"phase bench probe_index_paths: {time.perf_counter() - t0:.2f} s"
          f" [{card}]", flush=True)
    print(f"timing bench probe_index_paths: {json.dumps(probed)} [{card}]")
    check(len(probed["rows"]) == 8 and all(
        "error" not in r and np.isfinite(r["ms_per_call"])
        for r in probed["rows"]),
          f"probe_index_paths: 8 variants timed, none failed: "
          f"{probed['summary']}")
    args = probe.parse(pargv)
    g32, qs = probe.inputs(args, dev)
    fns = probe.variants(g32, args.k)
    with torch.inference_mode(), f32_precision():
        d_ref, i_ref = topk_nearest(qs[0], g32, k=args.k)
        for name in ("f32_full", "f32_norms"):
            check(*same_top10_up_to_cut(*fns[name](qs[0]), d_ref, i_ref,
                                        f"probe {name} vs topk_nearest over "
                                        f"{GALLERY} rows", 1e-5))
    del g32, qs, fns, d_ref, i_ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # bench_all: the entries not run above, each a process of its own, then
    # a second call that must skip them all
    t0 = time.perf_counter()
    argv = ["--round", "0", "--out", osp.join(tmp, "bench_r00.json"),
            "--only", ",".join(BENCH_ALL_ONLY)]
    with contextlib.redirect_stdout(io.StringIO()):  # the artifact, again
        out = bench_all.main(argv)
    print(f"phase bench bench_all: {time.perf_counter() - t0:.2f} s, "
          f"{len(out['entries'])} entries [{card}]", flush=True)
    for name, e in out["entries"].items():
        print(f"timing bench_all {name}: rc {e['rc']}, {e['wall_s']} s, "
              f"{json.dumps(e['result'])} [{card}]")
    check(sorted(out["entries"]) == sorted(BENCH_ALL_ONLY) and all(
        e["rc"] == 0 and e["result"] and np.isfinite(e["result"]["value"])
        and e["result"]["value"] > 0 for e in out["entries"].values())
          and "fused_speedup" in out and "int8_speedup" in out,
          f"bench_all {','.join(BENCH_ALL_ONLY)}: every entry rc 0 with a "
          f"finite value; fused_speedup {out.get('fused_speedup')}, "
          f"int8_speedup {out.get('int8_speedup')}")
    ran, run_one = [], bench_all.run_one
    bench_all.run_one = lambda extra, **kw: ran.append(extra)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            again = bench_all.main(argv)
    finally:
        bench_all.run_one = run_one
    check(ran == [] and again["entries"] == out["entries"],
          "bench_all called again skips every entry (resume)")
    print(f"phase bench: {time.perf_counter() - t_phase:.2f} s in all "
          f"[{card}]", flush=True)
    return ({label: n for label, n in k1.items() if n},
            {label: n for label, n in k3.items() if n})


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the inputs the script makes")
    seed = parser.parse_args().seed
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)
    run(torch.device("cuda"), seed)


def run(dev, seed=0):
    from openibl_tpu_torch.engine.evaluator import evaluate_descriptors
    from openibl_tpu_torch.hub import vgg16_netvlad
    from openibl_tpu_torch.models.convert import params_to_jax
    from openibl_tpu_torch.models.netvlad import netvlad_init_from_clusters
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops.distance import topk_nearest
    from openibl_tpu_torch.serving import RetrievalService
    from openibl_tpu_torch.utils import f32_precision

    global CARD
    card = CARD = card_line()
    print(card, flush=True)
    # the global TF32 flags stay as PyTorch ships them: the port's entry
    # points run their f32 work in f32 on their own (utils.f32_precision)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name} "
          f"[{card}]")

    # -- phase 1: build the kernels; phase 2: each against its plain -------
    build_kernels(card)
    k3_sass(card)
    k4_sass(card)
    k5_sass(card)
    k1, k1_calls = check_k1(dev, card, seed)
    k2, k2_calls = check_k2(dev, card, seed)
    probes, probe_calls = check_probes(dev, card)
    probe_k2_calls = check_probes_k2(dev, card, seed)
    k4_rows, k4_calls = k4_phase(dev, card, seed)
    k5_rows, k5_calls, k5_launches = k5_phase(dev, card, seed)

    # -- phase 3: the model, NetVLAD bootstrapped from its conv5 features ----
    rng = np.random.RandomState(seed)
    model = vgg16_netvlad(None, device=dev)
    check(model.net_vlad.fused and model.net_vlad.num_clusters == 64
          and model.pca_dim == DIM, "hub model: fused head, K=64, PCA 4096")
    boot = torch.from_numpy(scenes(rng, BOOT_IMGS)).to(dev)
    # the model's parts are called directly here, outside the entry
    # point's f32 scope: give them theirs
    with torch.inference_mode(), f32_precision():
        _, f5 = model.base(boot[:4])
    feats = f5.reshape(-1, 512).float().cpu().numpy()
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    clusters = feats[rng.choice(len(feats), 64, replace=False)]
    init = netvlad_init_from_clusters(clusters, feats)
    with torch.no_grad():
        model.net_vlad.assign_w.copy_(init["assign_w"])
        model.net_vlad.centroids.copy_(init["centroids"])
    # PCA centring: the bias maps the mean VLAD of the bootstrap images to
    # 0 (b = -mean·w, as a PCA fit sets it). Without it the random
    # projection keeps the VLADs' shared part, and all descriptors lie
    # closer together than PQ at m=64 can resolve
    with torch.inference_mode(), f32_precision():
        vlad = torch.cat([model.net_vlad.descriptor(model.base(
            boot[s:s + N_IMG])[1]) for s in range(0, BOOT_IMGS, N_IMG)])
        shift = -(vlad.mean(dim=0) @ model.pca_layer.w)
    with torch.no_grad():
        model.pca_layer.b.copy_(shift)
    # the EmbedNet half (VGG16 + NetVLAD) in the JAX layouts, the
    # checkpoint the Tokyo phase evaluates
    eval_tree = params_to_jax({k: v for k, v in model.state_dict().items()
                               if not k.startswith("pca_layer.")})

    images = scenes(rng, PLANTED)
    imgs_dev = torch.from_numpy(images).to(dev)
    with torch.inference_mode():
        desc_k1 = torch.cat([model(imgs_dev[s:s + N_IMG])
                             for s in range(0, PLANTED, N_IMG)])
        model.net_vlad.fused = False
        desc_plain = torch.cat([model(imgs_dev[s:s + N_IMG])
                                for s in range(0, PLANTED, N_IMG)])
        model.net_vlad.fused = True
    torch.cuda.synchronize()
    check(desc_k1.shape == (PLANTED, DIM) and bool(desc_k1.isfinite().all()),
          f"descriptors finite, shape {tuple(desc_k1.shape)}")
    norms = desc_k1.norm(dim=1)
    check(bool(((norms - 1).abs() < 1e-4).all()), "descriptors unit-norm")
    cos = float((desc_k1 * desc_plain).sum(dim=1).min())
    check(cos >= 0.99999, f"K1 vs plain head descriptors: min cosine {cos:.8f}")
    d2 = torch.cdist(desc_k1, desc_k1).square()
    d2 = d2[~torch.eye(PLANTED, dtype=torch.bool, device=dev)]
    print(f"  planted descriptors: pairwise sq-dist min {float(d2.min()):.4f}, "
          f"median {float(d2.median()):.4f} [{card}]")

    # -- phase 4: gallery on the device, planted rows, retrieval checks -------
    rows = torch.from_numpy(rng.choice(GALLERY, PLANTED, replace=False))
    gallery = planted_gallery(dev, seed, rows, desc_k1, GALLERY)
    torch.cuda.synchronize()
    d_k1, i_k1 = topk_nearest(desc_k1, gallery, k=10)
    d_pl, i_pl = topk_nearest(desc_plain, gallery, k=10)
    check(*same_top10(d_k1, i_k1, d_pl, i_pl, "K1 and plain-head queries"))
    d_full, i_full = topk_nearest(desc_k1, gallery, k=10, full_path=True)
    d_str, i_str = topk_nearest(desc_k1, gallery, k=10, full_path=False)
    check(*same_top10(d_full, i_full, d_str, i_str,
                      "topk_nearest full path and streaming path"))
    check(torch.equal(i_full[:, 0].cpu(), rows), "top-1 is the planted row")
    recalls = evaluate_descriptors(desc_plain, gallery,
                                   [[int(r)] for r in rows],
                                   print_results=False)
    check(recalls[0] == 1.0,
          f"evaluate_descriptors Recall@1/5/10 = {list(recalls)}")

    # -- phase 4b (g): cuDNN's TF32 on the f32 descriptor --------------------
    tf32_gap(model, imgs_dev, gallery, card)

    # -- phase 5 (b): the index family, built on the card --------------------
    built = build_indexes(gallery, desc_k1, dev, card)

    index = {"descriptors": gallery.cpu().numpy(),
             "paths": np.array([f"g{i:06d}.jpg" for i in range(GALLERY)])}
    spec = importlib.util.spec_from_file_location(
        "serve_torch", osp.join(ROOT, "examples", "serve_torch.py"))
    serve_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_torch)
    from http.server import ThreadingHTTPServer

    with tempfile.TemporaryDirectory() as tmp:
        weights = osp.join(tmp, "vgg16_netvlad_seeded.pth")
        torch.save(reference_state(model), weights)

        # -- phase 6: the exact served path: service + HTTP ------------------
        t0 = time.perf_counter()
        service = RetrievalService(index, weights=weights, height=H,
                                   width=W, device=dev)
        service.warmup()
        torch.cuda.synchronize()
        print(f"phase service: built and warmed in "
              f"{time.perf_counter() - t0:.2f} s over {service.index_size} "
              f"rows [{card}]")
        server = ThreadingHTTPServer(("127.0.0.1", 0),
                                     serve_torch.make_handler(service))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        with k4_counted("serve_exact"):
            nk.netvlad_fused.launches = 0  # the main path's run starts here
            try:
                base = f"http://127.0.0.1:{server.server_address[1]}"
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=120) as r:
                    health = json.loads(r.read())
                check(health == {"ok": True, "index_size": GALLERY},
                      f"/healthz {health}")
                for j in range(4):
                    buf = io.BytesIO()
                    Image.fromarray(images[j]).save(buf, format="PNG")
                    req = urllib.request.Request(base + "/query?topk=5",
                                                 data=buf.getvalue(),
                                                 method="POST")
                    with urllib.request.urlopen(req, timeout=120) as r:
                        matches = json.loads(r.read())["matches"]
                    check(matches[0]["index"] == int(rows[j])
                          and matches[0]["path"]
                          == f"g{int(rows[j]):06d}.jpg",
                          f"HTTP /query image {j}: top-1 = planted row "
                          f"{matches[0]['index']}, sq_dist "
                          f"{matches[0]['sq_dist']:.3g}")
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=60)
            results = service.query(list(images), topk=10)
            k1_launches = nk.netvlad_fused.launches  # the run ends
        check([r[0]["index"] for r in results] == rows.tolist(),
              f"service.query on {PLANTED} images: every top-1 is planted")
        check(k1_launches > 0,
              f"K1 launched {k1_launches} times on the served path")

        # -- phase 7: timings of extraction and the exact service ------------
        batch = imgs_dev[:N_IMG]
        rates = {}
        with torch.inference_mode(), k4_counted("extract"):
            for dtype in (torch.float32, torch.bfloat16):
                model.base.compute_dtype = dtype
                ms = cuda_ms(lambda: model(batch), reps=10, warmup=2)
                rates[dtype] = N_IMG / ms * 1e3
                print(f"timing extraction {H}x{W} batch {N_IMG} "
                      f"{str(dtype)[6:]}: {rates[dtype]:.2f} img/s "
                      f"({ms:.3f} ms/batch) [{card}]")
            model.base.compute_dtype = torch.float32
        exact_p50 = p50_query_ms(service, images)
        print(f"timing service.query batch 1, top-10 of {GALLERY}: p50 "
              f"{exact_p50:.3f} ms (host clock, 25 queries) [{card}]")
        del service

        # -- phase 7b (i): the int8 backbone, served -------------------------
        k1_quant, k3_launches, k3_err, k3_calls = quant_phase(
            model, index, weights, images, rows, desc_k1, rates, dev, card,
            seed)
        del model
        torch.cuda.empty_cache()

        # -- phase 8 (c): the served modes of the index family ---------------
        modes, k2_launches = serve_modes(index, built, weights, images, rows,
                                         dev, card, serve_torch)

        # -- phase 8b (s): mesh-sharded serving: NCCL at world size 1, two
        # gloo ranks, the example under torchrun, the dry-run twin --------
        single = {"exact": results, "exact_p50": exact_p50,
                  "pq": modes["pq"]["results"],
                  "pq_p50": modes["pq"]["p50_ms"]}
        k1_mesh_serve, k2_mesh_serve, k2_mesh_err = mesh_serve_phase(
            index, built, weights, images, rows, desc_k1, single, dev, card,
            seed, tmp)
        del single

    # -- phase 9 (d): timings of the served modes and the searches ----------
    for mode, r in {"exact": {"p50_ms": exact_p50}, **modes}.items():
        print(f"timing service.query {mode} batch 1, top-10 of {GALLERY}: "
              f"p50 {r['p50_ms']:.3f} ms (host clock, 25 queries) [{card}]")
    time_searches(gallery, desc_k1, built, dev, card)
    del built
    torch.cuda.empty_cache()

    # -- phase 9b (f): the training slice; 9d: SFRS on the same world; 9e
    # (j): the on-device jitter in both trainers, on that world too -------
    with tempfile.TemporaryDirectory() as train_tmp:
        train_launches, single = train_phase(dev, card, seed, train_tmp)
        sfrs_launches = sfrs_phase(dev, card, seed, train_tmp)
        jitter_phase(dev, card, seed, train_tmp)

        # -- phase 9c (h): checkpoint evaluation, Tokyo 24/7, and the
        # rerank; 9f (m): the mesh (NCCL at world size 1, then two gloo
        # ranks) ----------------------------------------------------------
        with tempfile.TemporaryDirectory() as tmp:
            tokyo_launches, rerank_launches = tokyo_phase(
                eval_tree, dev, card, seed, tmp)
            mesh_launches = mesh_phase(eval_tree, gallery, desc_k1, rows,
                                       dev, card, seed, tmp)
        del eval_tree

        # -- phase 9g (t): data-parallel training on the training phase's
        # world (NCCL at world size 1 through the example, two gloo ranks)
        mesh_launches["mesh_train_torchrun"] = mesh_train_phase(
            dev, card, seed, train_tmp, single)
        train_rate = single["tuples_per_s"]
        del single

    # -- phase 9h (u): the seven measurement tools ------------------------
    with tempfile.TemporaryDirectory() as tools_tmp:
        k1_tools, k2_tools = tools_phase(dev, card, tools_tmp)

    # -- phase 9i (v): the bench lane -------------------------------------
    with tempfile.TemporaryDirectory() as bench_tmp:
        k1_bench, k3_bench = bench_phase(dev, card, bench_tmp,
                                         rates[torch.float32], train_rate)

    # -- phase 10: each kernel's host enqueue time, then the launch floor
    # and each device time (after every timed phase) ------------------------
    calls = [*k1_calls, *k2_calls, *probe_calls, *probe_k2_calls,
             *k3_calls, *k4_calls, *k5_calls]
    enqueue_times(calls, card)
    device_times(calls, dev, card)
    k3 = k3_entry(k3_calls)
    for e in (k3, k3["batch1"]):
        print(f"K3 over one quantized forward ({e['per']}): per call "
              f"{e['ms']:.4f} ms (one block a tile "
              f"{e['one_a_tile_ms']:.4f} ms), device "
              f"{fmt_ms(e['device_ms'])}, plain "
              f"{e['plain_ms']:.4f} ms, torch._int_mm {e['int_mm_ms']:.4f} "
              f"ms (device {fmt_ms(e['int_mm_device_ms'])}), cuDNN bf16 "
              f"{e['cudnn_bf16_ms']:.4f} ms (device "
              f"{fmt_ms(e['cudnn_bf16_device_ms'])}), bound "
              f"{e['bound_ms']:.4f} ms [{card}]")
    k4 = k4_entry(k4_rows)
    for e in (k4, k4["batch1"]):
        share = e.get("share")
        print(f"K4 over {e['per']}: per call {e['ms']:.4f} ms, device "
              f"{fmt_ms(e['device_ms'])}, plain {e['plain_ms']:.4f} ms, "
              f"cuDNN f32 {e['library_ms']:.4f} ms (device "
              f"{fmt_ms(e['library_device_ms'])}), bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}, TF32 peak), share "
              f"{'not measured' if share is None else f'{share:.2%}'} "
              f"[{card}]")

    k5 = k5_entry(k5_rows)
    for e in (k5, k5["batch1"]):
        share = e.get("share")
        print(f"K5 over {e['per']}: per call {e['ms']:.4f} ms, device "
              f"{fmt_ms(e['device_ms'])}, plain {e['plain_ms']:.4f} ms, "
              f"torch.matmul {e['library_ms']:.4f} ms (device "
              f"{fmt_ms(e['library_device_ms'])}), bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}, TF32 peak), share "
              f"{'not measured' if share is None else f'{share:.2%}'} "
              f"[{card}]")

    print(json.dumps({"kernels": [
        {"name": "netvlad_fused", "route": "cuda",
         "source": "openibl_tpu_torch/csrc/netvlad.cu",
         "replaces": "openibl_tpu/ops/netvlad_kernel.py:74",
         "launches": (k1_launches + k1_quant + train_launches
                      + sfrs_launches + tokyo_launches + rerank_launches
                      + sum(mesh_launches.values())
                      + sum(k1_mesh_serve.values())
                      + sum(k1_tools.values()) + sum(k1_bench.values())),
         "launches_by_path": {"serve_exact": k1_launches,
                              "serve_exact_quant": k1_quant,
                              "train": train_launches,
                              "sfrs": sfrs_launches,
                              "tokyo_eval": tokyo_launches,
                              "tokyo_eval_rerank": rerank_launches,
                              **mesh_launches, **k1_mesh_serve,
                              **{f"tools_{k}": n
                                 for k, n in k1_tools.items()},
                              **{f"bench_{k}": n
                                 for k, n in k1_bench.items()}}, **k1},
        {"name": "pq_adc", "route": "cuda",
         "source": "openibl_tpu_torch/csrc/pq_adc.cu",
         "replaces": "openibl_tpu/ops/pq_kernel.py:84",
         "launches": (k2_launches + sum(k2_mesh_serve.values())
                      + sum(k2_tools.values())),
         "launches_by_path": {"serve_modes": k2_launches, **k2_mesh_serve,
                              **{f"tools_{k}": n
                                 for k, n in k2_tools.items()}},
         **k2, "max_abs_err": max(k2["max_abs_err"], k2_mesh_err)},
        *probes,
        {"name": "int8_conv", "route": "cuda",
         "source": "openibl_tpu_torch/csrc/quant_conv.cu",
         "replaces": "openibl_tpu/ops/quant.py:203 (XLA int8 conv, no "
                     "pallas_call)",
         "launches": k3_launches + sum(k3_bench.values()),
         "launches_by_path": {"serve_exact_quant": k3_launches,
                              **{f"bench_{k}": n
                                 for k, n in k3_bench.items()}},
         "max_abs_err": k3_err, **k3},
        {"name": "conv3x3_f32", "route": "cuda",
         "source": "openibl_tpu_torch/csrc/conv_f32.cu",
         "replaces": "openibl_tpu/models/vgg.py (XLA's f32 convolutions, "
                     "bias and ReLU, no pallas_call)",
         "launches": sum(K4_LAUNCHES.values()),
         "launches_by_path": dict(K4_LAUNCHES), **k4},
        {"name": "linear_f32", "route": "cuda",
         "source": "openibl_tpu_torch/csrc/linear_f32.cu",
         "replaces": "none (no ViT in openibl_tpu; cuBLAS's f32 GEMM in "
                     "models/dinov2.py before)",
         "launches": k5_launches,
         "launches_by_path": {"anyloc_extract": k5_launches}, **k5},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
