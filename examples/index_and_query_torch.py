"""Build a descriptor index over an image directory and query it, on the
PyTorch port (the build/query CLI of examples/index_and_query.py):

  python examples/index_and_query_torch.py build gallery_dir/ index.npz --weights w.pth
  python examples/index_and_query_torch.py build gallery_dir/ index.npz --pq-m 64 --ivf-nlist 256
  python examples/index_and_query_torch.py query index.npz photo.jpg --topk 5

The .npz carries the same keys as the JAX package's, so either package's
RetrievalService (examples/serve.py, examples/serve_torch.py) loads it.
Extraction, k-means and PQ training run on ``--device`` (default cuda).
"""

import argparse
import glob
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def build(args):
    if args.pq_only and not args.pq_m:
        # validate BEFORE the extraction: failing after hours of descriptor
        # computation over a real gallery would discard all the work
        raise SystemExit("--pq-only requires --pq-m")
    if args.opq_iters and not args.pq_m:
        raise SystemExit("--opq-iters requires --pq-m")

    import torch

    from openibl_tpu_torch.data.loader import BatchLoader, ImageSource
    from openibl_tpu_torch.data.transforms import TestTransform
    from openibl_tpu_torch.hub import vgg16_netvlad
    from openibl_tpu_torch.parallel.extract import extract_features

    paths = sorted(
        p for p in glob.glob(osp.join(args.gallery, "**", "*"), recursive=True)
        if p.lower().endswith(IMAGE_EXTS)
    )
    if not paths:
        raise SystemExit(f"no images under {args.gallery}")
    print(f"indexing {len(paths)} images from {args.gallery} on {args.device}")
    model = vgg16_netvlad(args.weights, pca_params=args.pca_params,
                          device=args.device)
    src = ImageSource(
        [(p, i, 0.0, 0.0) for i, p in enumerate(paths)],
        transform=TestTransform(args.height, args.width, device_normalize=True),
    )
    feats = extract_features(model, BatchLoader(src, batch_size=args.batch_size),
                             verbose=True, device_output=True)
    index_path = args.index if args.index.endswith(".npz") else args.index + ".npz"
    # IVF/PQ are trained on the vectors the full-width search runs over
    # (after the store-dtype rounding): cells or codes fit on the floats
    # before it would mis-place rows near boundaries
    payload = {"paths": np.array(paths)}
    if args.store_dtype == "int8":
        from openibl_tpu_torch.ops.distance import quantize_index_int8

        codes, scales = quantize_index_int8(feats.cpu().numpy())
        payload.update(descriptors=codes, scales=scales)
        search_vectors = (torch.from_numpy(codes).to(feats.device).float()
                          * torch.from_numpy(scales).to(feats.device)[:, None])
    else:
        stored = feats.to(getattr(torch, args.store_dtype))
        payload.update(descriptors=stored.cpu().numpy())
        search_vectors = stored.float()
    if args.pq_m and args.ivf_nlist:
        from openibl_tpu_torch.ops.pq import build_ivfpq

        # IVFADC: one clustering gives both the IVF tables (usable by the
        # full-width ivf_nprobe path) and the residual-PQ codes
        payload.update(build_ivfpq(search_vectors, nlist=args.ivf_nlist,
                                   m=args.pq_m, opq_iters=args.opq_iters))
        print(f"IVFADC: {payload['ivf_lists'].shape[0]} cells x "
              f"{payload['ivf_lists'].shape[1]} capacity, m={args.pq_m} "
              f"residual codes"
              + (f", OPQ rotation ({args.opq_iters} iters)"
                 if args.opq_iters else ""))
    elif args.ivf_nlist:
        from openibl_tpu_torch.ops.ivf import build_ivf

        ivf = build_ivf(search_vectors, nlist=args.ivf_nlist)
        payload.update(ivf_centroids=ivf["centroids"],
                       ivf_lists=ivf["lists"])
        print(f"IVF: {ivf['lists'].shape[0]} cells x "
              f"{ivf['lists'].shape[1]} capacity")
    elif args.pq_m:
        from openibl_tpu_torch.ops.pq import build_pq

        payload.update(build_pq(search_vectors, m=args.pq_m,
                                opq_iters=args.opq_iters))
        print(f"PQ: m={args.pq_m} -> {args.pq_m} bytes/descriptor "
              f"({feats.shape[1] * 4 // args.pq_m}x smaller than f32)"
              + (f", OPQ rotation ({args.opq_iters} iters)"
                 if args.opq_iters else ""))
    if args.pq_only:  # arg combination validated at the top of build()
        del payload["descriptors"]
        payload.pop("scales", None)
    np.savez(index_path, **payload)
    stored = args.store_dtype
    if args.pq_m:
        kind = "ivfadc" if args.ivf_nlist else "pq"
        stored = (f"{kind} m={args.pq_m} only" if args.pq_only
                  else f"{stored} + {kind} m={args.pq_m}")
    print(f"wrote {index_path}: {tuple(feats.shape)} descriptors ({stored})")


def query(args):
    import torch
    from PIL import Image

    from openibl_tpu_torch.hub import DescriptorExtractor
    from openibl_tpu_torch.ops.distance import topk_nearest

    index_path = args.index if args.index.endswith(".npz") else args.index + ".npz"
    with np.load(index_path, allow_pickle=False) as f:
        data = {k: f[k] for k in f.files}
    paths = data["paths"]
    dev = torch.device(args.device)
    extractor = DescriptorExtractor(args.weights, args.height, args.width,
                                    pca_params=args.pca_params, device=dev)
    desc = torch.from_numpy(
        extractor(Image.open(args.image).convert("RGB"))).to(dev)

    def put(key):
        return torch.from_numpy(data[key]).to(dev)

    if "descriptors" in data:
        gallery = data["descriptors"]
        scales = put("scales") if gallery.dtype == np.int8 else None
        d, idx = topk_nearest(desc, put("descriptors"),
                              k=min(args.topk, len(gallery)),
                              gallery_scale=scales)
    elif "ivfpq_codes" in data:
        # IVFADC-only index (--pq-m --ivf-nlist --pq-only): probe nprobe
        # cells, ADC over their residual codes
        from openibl_tpu_torch.ops.pq import ivfpq_search

        nlist = data["ivf_centroids"].shape[0]
        rot = put("ivfpq_rotation") if "ivfpq_rotation" in data else None
        d, idx = ivfpq_search(desc, put("ivfpq_codes"),
                              put("ivfpq_codebooks"), put("ivf_centroids"),
                              put("ivf_lists"),
                              k=min(args.topk, len(data["ivfpq_codes"])),
                              nprobe=args.nprobe or max(nlist // 8, 1),
                              rotation=rot)
    else:  # PQ-only index (build --pq-m ... --pq-only): exhaustive ADC
        from openibl_tpu_torch.ops.pq import pq_search

        rot = put("pq_rotation") if "pq_rotation" in data else None
        d, idx = pq_search(desc, put("pq_codes"), put("pq_codebooks"),
                           k=min(args.topk, len(data["pq_codes"])),
                           rotation=rot)
    d, idx = d[0].cpu().numpy(), idx[0].cpu().numpy()
    # drop unfilled (inf, -1) slots: a low-nprobe IVFADC probe can return
    # fewer than topk candidates, and paths[-1] would be a phantom match
    filled = [(i, dist) for i, dist in zip(idx, d) if i >= 0]
    print(f"top-{len(filled)} matches for {args.image}:")
    for rank, (i, dist) in enumerate(filled, 1):
        print(f"  {rank}. {paths[i]}  (sq-dist {dist:.4f})")


def main():
    p = argparse.ArgumentParser(
        description="descriptor index build/query (PyTorch)")
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build")
    b.add_argument("gallery")
    b.add_argument("index")
    b.add_argument("--store-dtype", choices=["float32", "float16", "int8"],
                   default="float32",
                   help="float16 halves (int8 quarters, with per-row "
                        "scales) index size on disk and on the device")
    b.add_argument("--ivf-nlist", type=int, default=0,
                   help="also build an IVF coarse index with this many "
                        "cells (ops.ivf); serving can then probe only the "
                        "nearest cells per query (0 = exact-only index)")
    b.add_argument("--pq-m", type=int, default=0,
                   help="also product-quantize the index into this many "
                        "uint8 subcodes per descriptor (ops.pq; m bytes "
                        "each, 256x smaller than f32 at D=4096, m=64)")
    b.add_argument("--opq-iters", type=int, default=0,
                   help="with --pq-m: train an OPQ rotation for this many "
                        "alternating iterations before encoding; stored in "
                        "the index and applied to queries automatically")
    b.add_argument("--pq-only", action="store_true",
                   help="with --pq-m: store ONLY the PQ arrays (drop the "
                        "full-width descriptors)")
    q = sub.add_parser("query")
    q.add_argument("index")
    q.add_argument("image")
    q.add_argument("--topk", type=int, default=5)
    q.add_argument("--nprobe", type=int, default=0,
                   help="IVFADC-only indexes: cells probed per query "
                        "(default nlist/8)")
    for sp in (b, q):
        sp.add_argument("--weights", type=str, default=None)
        sp.add_argument("--pca-params", type=str, default=None,
                        help="PCA-whitening .h5/.npz for trainer checkpoints "
                             "(auto-discovered next to the checkpoint)")
        sp.add_argument("--height", type=int, default=480)
        sp.add_argument("--width", type=int, default=640)
        sp.add_argument("--batch-size", type=int, default=16)
        sp.add_argument("--device", type=str, default="cuda",
                        help="torch device for the model, the index build "
                             "and the search")
    args = p.parse_args()
    (build if args.cmd == "build" else query)(args)


if __name__ == "__main__":
    main()
