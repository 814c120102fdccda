"""GPU smoke run of the PyTorch port (openibl_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Builds the fused NetVLAD kernel (csrc/netvlad.cu) from this checkout, holds
it to its plain PyTorch version at the main path's shape, then drives the
serving path at full width: VGG16 + NetVLAD (K=64) + PCA 32768→4096 at
480x640, a RetrievalService over a 100,000 x 4096 f32 gallery with 32
planted rows, queries through examples/serve_torch.py's HTTP handler on
localhost, and Recall@1 over the planted rows. Weights are random from a
seed; the NetVLAD layer is bootstrapped from clusters of the model's own
conv5 features (the package's netvlad_init_from_clusters, as a trainer
initializes it), because the raw random init maps every image to nearly the
same descriptor. Prints timing lines (CUDA events) with the card's name and
power limit, one JSON line on the kernels, and as its last line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is then
non-zero and the last line is not printed. Needs CUDA; imports no jax.
"""

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

import numpy as np
import torch
from PIL import Image

ROOT = osp.dirname(osp.abspath(__file__))
N_IMG, H, W = 16, 480, 640
GALLERY, DIM, PLANTED = 100_000, 4096, 32
RTOL, ATOL = 1e-4, 1e-5  # both sides upcast the same values to f32


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok: {what}", flush=True)


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)
    from openibl_tpu_torch.engine.evaluator import evaluate_descriptors
    from openibl_tpu_torch.hub import vgg16_netvlad
    from openibl_tpu_torch.models.netvlad import netvlad_init_from_clusters
    from openibl_tpu_torch.ops import _build
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops.distance import topk_nearest
    from openibl_tpu_torch.serving import RetrievalService

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.library_path("netvlad", ["netvlad.cu"])
    _build.load_library("netvlad", ["netvlad.cu"])
    print(f"phase build: {osp.relpath(lib_path, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    with open(lib_path[:-3] + ".log") as f:
        print("".join(f"  ptxas: {ln}" for ln in f if "Used" in ln
                      or "spill" in ln or "smem" in ln), end="")

    # -- phase 2: K1 against its plain version at the main-path shape --------
    g = torch.Generator(device=dev).manual_seed(0)
    fmap = torch.randn((N_IMG, 30, 40, 512), generator=g, device=dev)
    assign_w = torch.randn((512, 64), generator=g, device=dev) * 2
    cent = torch.rand((64, 512), generator=g, device=dev)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x = fmap.to(dtype)
        for post in (False, True):
            out = nk.netvlad_fused(x, assign_w, cent, postprocess=post)
            ref = nk.netvlad_plain(x, assign_w, cent, postprocess=post)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            max_err = max(max_err, err)
            torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
            check(True, f"K1 == plain head, {str(dtype)[6:]} fmap "
                        f"{tuple(x.shape)}, postprocess={post}, "
                        f"max_abs_err={err:.3g} (rtol {RTOL}, atol {ATOL})")
    k1_ms = cuda_ms(lambda: nk.netvlad_fused(fmap, assign_w, cent,
                                             postprocess=True))
    plain_ms = cuda_ms(lambda: nk.netvlad_plain(fmap, assign_w, cent,
                                                postprocess=True))
    fb = fmap.to(torch.bfloat16)
    k1_bf16_ms = cuda_ms(lambda: nk.netvlad_fused(fb, assign_w, cent,
                                                  postprocess=True))
    plain_bf16_ms = cuda_ms(lambda: nk.netvlad_plain(fb, assign_w, cent,
                                                     postprocess=True))
    print(f"timing K1 (16,30,40,512) f32 postprocess: kernel {k1_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms | bf16: kernel {k1_bf16_ms:.4f} ms, "
          f"plain {plain_bf16_ms:.4f} ms [{card}]")
    del fmap, fb

    # -- phase 3: the model, NetVLAD bootstrapped from its conv5 features ----
    rng = np.random.RandomState(0)
    model = vgg16_netvlad(None, device=dev)
    check(model.net_vlad.fused and model.net_vlad.num_clusters == 64
          and model.pca_dim == DIM, "hub model: fused head, K=64, PCA 4096")
    with torch.inference_mode():
        _, f5 = model.base(torch.from_numpy(scenes(rng, 4)).to(dev))
    feats = f5.reshape(-1, 512).float().cpu().numpy()
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    clusters = feats[rng.choice(len(feats), 64, replace=False)]
    init = netvlad_init_from_clusters(clusters, feats)
    with torch.no_grad():
        model.net_vlad.assign_w.copy_(init["assign_w"])
        model.net_vlad.centroids.copy_(init["centroids"])

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

    # -- phase 4: gallery on the device, planted rows, retrieval checks -------
    gg = torch.Generator(device=dev).manual_seed(1)
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

    # -- phase 5: the served path: service + HTTP ------------------------------
    index = {"descriptors": gallery.cpu().numpy(),
             "paths": np.array([f"g{i:06d}.jpg" for i in range(GALLERY)])}
    del gallery
    with tempfile.TemporaryDirectory() as tmp:
        weights = osp.join(tmp, "vgg16_netvlad_seeded.pth")
        torch.save(reference_state(model), weights)
        t0 = time.perf_counter()
        service = RetrievalService(index, weights=weights, height=H,
                                   width=W, device=dev)
    service.warmup()
    torch.cuda.synchronize()
    print(f"phase service: built and warmed in {time.perf_counter() - t0:.2f}"
          f" s over {service.index_size} rows")
    spec = importlib.util.spec_from_file_location(
        "serve_torch", osp.join(ROOT, "examples", "serve_torch.py"))
    serve_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_torch)
    from http.server import ThreadingHTTPServer

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
                                         data=buf.getvalue(), method="POST")
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
    launches = nk.netvlad_fused.launches  # the main path's run ends here
    check([r[0]["index"] for r in results] == rows.tolist(),
          f"service.query on {PLANTED} images: every top-1 is planted")
    check(launches > 0, f"K1 launched {launches} times on the served path")

    # -- phase 6: timings -------------------------------------------------------
    batch = imgs_dev[:N_IMG]
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            model.base.compute_dtype = dtype
            ms = cuda_ms(lambda: model(batch), reps=10, warmup=2)
            print(f"timing extraction {H}x{W} batch {N_IMG} "
                  f"{str(dtype)[6:]}: {N_IMG / ms * 1e3:.2f} img/s "
                  f"({ms:.3f} ms/batch) [{card}]")
        model.base.compute_dtype = torch.float32
    lat = []
    for j in range(30):
        t0 = time.perf_counter()
        service.query([images[j % PLANTED]], topk=10)
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"timing service.query batch 1, top-10 of {GALLERY}: p50 "
          f"{statistics.median(lat[5:]):.3f} ms (host clock, 25 queries) "
          f"[{card}]")

    print(json.dumps({"kernels": [{
        "name": "netvlad_fused",
        "route": "cuda",
        "source": "openibl_tpu_torch/csrc/netvlad.cu",
        "replaces": "openibl_tpu/ops/netvlad_kernel.py:74",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
