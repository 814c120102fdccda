"""GPU smoke run of the PyTorch port (openibl_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Builds the port's three CUDA libraries from this checkout, one nvcc each,
in parallel: the fused NetVLAD head (K1, csrc/netvlad.cu), the PQ ADC tile
scorer (K2, csrc/pq_adc.cu) and the six kernels of the Mosaic layout probes
(P1-P7, csrc/mosaic_probe.cu). Holds each to its plain PyTorch version on
the card at the main path's shapes (the probes at the TPU script's own toy
sizes, each row driven through the port's probe tool as its own path),
then drives the serving path at full width:
VGG16 + NetVLAD (K=64) + PCA 32768→4096 at 480x640, a RetrievalService over
a 100,000 x 4096 f32 gallery with 32 planted rows, queries through
examples/serve_torch.py's HTTP handler on localhost, and Recall@1 over the
planted rows. Then the index family over the same gallery, built on the
card (PQ m=64, OPQ, IVF and IVFADC with 256 cells), and its served modes:
a codes-only PQ index, IVFADC, the PQ re-rank and full-width IVF, each
through a RetrievalService (PQ also through HTTP) with its Recall@1/5/10.

Weights are random from a seed; the NetVLAD layer is bootstrapped from
clusters of the model's own conv5 features (the package's
netvlad_init_from_clusters, as a trainer initializes it), and the PCA
layer's bias centres the VLADs on their mean over the bootstrap images, as
a PCA fit does, because the raw random init maps every image to nearly the
same descriptor. Each served
path runs with the kernels' launch counts set to 0 just before it and read
just after. K1 is also checked at a ragged P (30x41) and at K = 17, for
the same bits on a second run, and against its split-precision arithmetic
run in plain PyTorch; K2 also at 3 and 17 queries. Prints timing
lines (CUDA events, or the host clock for service.query) with the card's
name and power limit on every line that holds a number, each kernel's time
per call beside its bytes/operations bound (the larger of its bytes over
3.35 TB/s and its operations over the peak for their type, the H100 SXM
data sheet's: f32 on CUDA cores 67 TFLOP/s; K1's split-precision products
on the tensor cores, 3 TF32 products at 495 TFLOP/s, with the f32
CUDA-core bound of the same products beside it) and, where one PyTorch
call computes the same function, that call's time. P6 and P7 also run at
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
import importlib.util
import io
import json
import os.path as osp
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
           "mosaic_probe": ["mosaic_probe.cu"]}
# H100 SXM at 700 W (data sheet): HBM bytes, f32 CUDA-core operations and
# dense tensor-core operations (TF32, bf16) per ms
HBM_BYTES_PER_MS, F32_OPS_PER_MS = 3.35e9, 67e9
TF32_OPS_PER_MS, BF16_OPS_PER_MS = 495e9, 989e9
CARD = ""  # the card's name and power limit, set by run()


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what} [{CARD}]")
    print(f"  ok: {what} [{CARD}]", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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
                          or "spill" in ln or "smem" in ln), end="")


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
        if key:
            entry[key[0]] = ms
            print(f"device {what}: {fmt_ms(ms)} (profiler); per call "
                  f"{entry['library_ms']:.4f} ms [{card}]")
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
        out[name] = {"recall": recall, "p50_ms": p50_query_ms(service,
                                                              images)}
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
    from openibl_tpu_torch.models.netvlad import netvlad_init_from_clusters
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops.distance import topk_nearest
    from openibl_tpu_torch.serving import RetrievalService

    global CARD
    card = CARD = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name} "
          f"[{card}]")

    # -- phase 1: build the kernels; phase 2: each against its plain -------
    build_kernels(card)
    k1, k1_calls = check_k1(dev, card, seed)
    k2, k2_calls = check_k2(dev, card, seed)
    probes, probe_calls = check_probes(dev, card)
    probe_k2_calls = check_probes_k2(dev, card, seed)

    # -- phase 3: the model, NetVLAD bootstrapped from its conv5 features ----
    rng = np.random.RandomState(seed)
    model = vgg16_netvlad(None, device=dev)
    check(model.net_vlad.fused and model.net_vlad.num_clusters == 64
          and model.pca_dim == DIM, "hub model: fused head, K=64, PCA 4096")
    boot = torch.from_numpy(scenes(rng, BOOT_IMGS)).to(dev)
    with torch.inference_mode():
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
    with torch.inference_mode():
        vlad = torch.cat([model.net_vlad.descriptor(model.base(
            boot[s:s + N_IMG])[1]) for s in range(0, BOOT_IMGS, N_IMG)])
        shift = -(vlad.mean(dim=0) @ model.pca_layer.w)
    with torch.no_grad():
        model.pca_layer.b.copy_(shift)

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
    gg = torch.Generator(device=dev).manual_seed(seed + 1)
    gallery = torch.randn((GALLERY, DIM), generator=gg, device=dev)
    gallery /= gallery.norm(dim=1, keepdim=True)
    rows = torch.from_numpy(rng.choice(GALLERY, PLANTED, replace=False))
    gallery[rows.to(dev)] = desc_k1
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
        nk.netvlad_fused.launches = 0  # the main path's run starts here
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            with urllib.request.urlopen(base + "/healthz", timeout=120) as r:
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
                      and matches[0]["path"] == f"g{int(rows[j]):06d}.jpg",
                      f"HTTP /query image {j}: top-1 = planted row "
                      f"{matches[0]['index']}, sq_dist "
                      f"{matches[0]['sq_dist']:.3g}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        results = service.query(list(images), topk=10)
        k1_launches = nk.netvlad_fused.launches  # the main path's run ends
        check([r[0]["index"] for r in results] == rows.tolist(),
              f"service.query on {PLANTED} images: every top-1 is planted")
        check(k1_launches > 0,
              f"K1 launched {k1_launches} times on the served path")

        # -- phase 7: timings of extraction and the exact service ------------
        batch = imgs_dev[:N_IMG]
        with torch.inference_mode():
            for dtype in (torch.float32, torch.bfloat16):
                model.base.compute_dtype = dtype
                ms = cuda_ms(lambda: model(batch), reps=10, warmup=2)
                print(f"timing extraction {H}x{W} batch {N_IMG} "
                      f"{str(dtype)[6:]}: {N_IMG / ms * 1e3:.2f} img/s "
                      f"({ms:.3f} ms/batch) [{card}]")
            model.base.compute_dtype = torch.float32
        exact_p50 = p50_query_ms(service, images)
        print(f"timing service.query batch 1, top-10 of {GALLERY}: p50 "
              f"{exact_p50:.3f} ms (host clock, 25 queries) [{card}]")
        del service, model
        torch.cuda.empty_cache()

        # -- phase 8 (c): the served modes of the index family ---------------
        modes, k2_launches = serve_modes(index, built, weights, images, rows,
                                         dev, card, serve_torch)

    # -- phase 9 (d): timings of the served modes and the searches ----------
    for mode, r in {"exact": {"p50_ms": exact_p50}, **modes}.items():
        print(f"timing service.query {mode} batch 1, top-10 of {GALLERY}: "
              f"p50 {r['p50_ms']:.3f} ms (host clock, 25 queries) [{card}]")
    time_searches(gallery, desc_k1, built, dev, card)

    # -- phase 10: each kernel's host enqueue time, then the launch floor
    # and each device time (after every timed phase) ------------------------
    calls = [*k1_calls, *k2_calls, *probe_calls, *probe_k2_calls]
    enqueue_times(calls, card)
    device_times(calls, dev, card)

    print(json.dumps({"kernels": [
        {"name": "netvlad_fused", "route": "cuda",
         "source": "openibl_tpu_torch/csrc/netvlad.cu",
         "replaces": "openibl_tpu/ops/netvlad_kernel.py:74",
         "launches": k1_launches, **k1},
        {"name": "pq_adc", "route": "cuda",
         "source": "openibl_tpu_torch/csrc/pq_adc.cu",
         "replaces": "openibl_tpu/ops/pq_kernel.py:84",
         "launches": k2_launches, **k2},
        *probes,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
