"""IVF recall against nprobe on model descriptors (port of
scripts/ivf_recall.py).

  python -m openibl_tpu_torch.tools.ivf_recall [--n-places 192] [--nlist 64]
      [--device cuda|cpu] [--out logs/torch/ivf_recall.json]

The accuracy side of the IVF trade: recall@k of ``ops.ivf.ivf_search``
against the exact search (``ops.distance.topk_nearest``) for every nprobe,
on descriptors the EmbedNet (VGG16 + NetVLAD with K=8, seeded random
weights) produces over the synthetic place dataset, which is clustered the
way a real place gallery is (i.i.d. random vectors are not). On the card
the NetVLAD head is the fused kernel K1 (``ops/netvlad_kernel.py``); the
index is built on the device and searched there. Products are f32 (TF32
off, ``utils.f32_precision``), as the JAX package's HIGHEST precision asks.

Hit rule (tie tolerant, the ANN convention): an IVF candidate is a hit when
its distance is within the exact k-th distance + 1e-5. Unit-norm
high-dimensional descriptors put unrelated gallery items at distances that
differ by < 1e-6 at the k boundary, so a raw id-set intersection would
under-report even the exact search against itself.

Writes the JSON artifact (the JAX script's keys plus ``device``, the card's
name) and prints a markdown table. tests/test_torch_tools_recall.py holds
``recall_curve`` to the JAX script's on one descriptor array.
"""

import argparse
import json
import tempfile

import numpy as np
import torch

from openibl_tpu_torch import models
from openibl_tpu_torch.data.loader import BatchLoader, ImageSource
from openibl_tpu_torch.data.synthetic import SyntheticDataset
from openibl_tpu_torch.data.transforms import TestTransform
from openibl_tpu_torch.ops.distance import topk_nearest
from openibl_tpu_torch.ops.ivf import build_ivf, ivf_search
from openibl_tpu_torch.parallel.extract import extract_features
from openibl_tpu_torch.tools._common import (
    ARTIFACTS, add_device_flag, device_name, write_json)
from openibl_tpu_torch.utils import f32_precision, resolve_device, to_numpy


def model_descriptors(n_places, imgs_per_place, height, width, batch_size=32,
                      device="cuda"):
    """EmbedNet descriptors (N, 8 * 512) f32 numpy of every image of a
    synthetic world written to a temporary directory; K1 on the card."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        ds = SyntheticDataset(tmp, n_places=n_places,
                              imgs_per_place=imgs_per_place,
                              img_size=(height, width))
        items = sorted(set(ds.q_train) | set(ds.db_train)
                       | set(ds.q_val) | set(ds.db_val)
                       | set(ds.q_test) | set(ds.db_test))
        src = ImageSource(items, root=ds.images_dir,
                          transform=TestTransform(height, width))
        model = models.create("embednet", net_vlad=models.NetVLAD(
            num_clusters=8, fused=device.type == "cuda"))
        model = model.to(device, memory_format=torch.channels_last).eval()
        feats = extract_features(model, BatchLoader(src,
                                                    batch_size=batch_size))
    return np.asarray(feats, np.float32)


def split_queries(desc, n_queries, seed):
    """(queries, gallery): ``n_queries`` rows drawn without replacement by
    ``default_rng(seed)``, the rest in order (the JAX scripts' split)."""
    rng = np.random.default_rng(seed)
    qid = rng.choice(len(desc), n_queries, replace=False)
    mask = np.ones(len(desc), bool)
    mask[qid] = False
    return desc[qid], desc[mask]


def nprobe_sweep(nlist):
    """Powers of two below ``nlist``, then ``nlist`` itself: the exhaustive
    row, which the table and the gates rely on, is always there."""
    nprobes, npb = [], 1
    while npb < nlist:
        nprobes.append(npb)
        npb *= 2
    return nprobes + [nlist]


def recall_curve(desc, n_queries, nlist, k=10, seed=0, device="cuda"):
    """{nprobe: tie-tolerant recall@k of ivf_search vs the exact ranking}."""
    device = resolve_device(device)
    q, g = split_queries(desc, n_queries, seed)
    q = torch.from_numpy(np.ascontiguousarray(q)).to(device)
    g = torch.from_numpy(np.ascontiguousarray(g)).to(device)
    with torch.no_grad(), f32_precision():
        d_exact, _ = topk_nearest(q, g, k=k)
        thresh = to_numpy(d_exact)[:, -1] + 1e-5  # per-query k-th distance
        ivf = build_ivf(g, nlist=nlist)
        curve = {}
        for nprobe in nprobe_sweep(nlist):
            d_iv, idx = ivf_search(q, g, ivf["centroids"], ivf["lists"], k=k,
                                   nprobe=nprobe)
            d_iv, idx = to_numpy(d_iv), to_numpy(idx)
            hits = np.mean(
                np.sum((idx >= 0) & (d_iv <= thresh[:, None]), axis=1) / k)
            curve[nprobe] = float(hits)
    return curve


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-places", type=int, default=192)
    ap.add_argument("--imgs-per-place", type=int, default=6)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--n-queries", type=int, default=96)
    ap.add_argument("--nlist", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    add_device_flag(ap)
    ap.add_argument("--out", default=str(ARTIFACTS / "ivf_recall.json"))
    return ap.parse_args(argv)


def main(argv=None):
    """Run the sweep, write the artifact and return its content."""
    args = parse(argv)
    device = resolve_device(args.device)
    desc = model_descriptors(args.n_places, args.imgs_per_place,
                             args.height, args.width, device=device)
    print(f"{len(desc)} model descriptors (D={desc.shape[1]}) on "
          f"{device_name(device)}")
    curve = recall_curve(desc, args.n_queries, args.nlist, k=args.k,
                         device=device)

    print(f"\n| nprobe (of {args.nlist}) | recall@{args.k} vs exact |")
    print("|---|---|")
    for npb, r in curve.items():
        print(f"| {npb} | {r:.3f} |")

    result = {
        "gallery": int(len(desc) - args.n_queries),
        "n_queries": args.n_queries, "nlist": args.nlist, "k": args.k,
        "descriptor_dim": int(desc.shape[1]),
        "recall_at_k_vs_exact": curve,
        "device": device_name(device),
    }
    write_json(args.out, result)
    print(json.dumps({"artifact": args.out, "ok": True,
                      "device": result["device"]}))
    return result


if __name__ == "__main__":
    main()
