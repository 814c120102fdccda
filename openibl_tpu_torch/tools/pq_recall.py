"""PQ / OPQ / IVFADC recall on model descriptors (port of
scripts/pq_recall.py).

  python -m openibl_tpu_torch.tools.pq_recall [--n-places 192] [--k 10]
      [--ms 8,16,32,64] [--opq-iters 6] [--device cuda|cpu]
      [--out logs/torch/pq_recall.json]

The accuracy side of the compression trade, the PQ counterpart of
``tools/ivf_recall.py`` on the same world and extractor
(``ivf_recall.model_descriptors``). For each subquantizer count m: PQ and
(with ``--opq-iters`` > 0) OPQ codes built on the device
(``ops.pq.build_pq``) and searched by exhaustive ADC (``pq_search``: the
ADC scorer K2, ``ops/pq_kernel.py``, on the card), recall@k of the top k
and of the top 4k, and the reconstruction error in the original frame
(``decode_pq``); then IVFADC (``build_ivfpq`` / ``ivfpq_search``) at the
middle m for every nprobe.

Hit rule: ADC distances approximate the exact ones, so a returned id is a
hit when its EXACT distance is within the exact k-th distance + 1e-5 (the
tie-tolerant rule of ``ivf_recall``, through an exact re-score of the
returned ids). Each OPQ build pays ``--opq-iters`` D x D Procrustes SVDs;
``--opq-iters 0`` skips the OPQ columns.

Writes the JSON artifact (the JAX script's keys plus ``device``) and prints
markdown tables. tests/test_torch_tools_recall.py holds ``recall_tables``
to the JAX script's on one descriptor array.
"""

import argparse
import json

import numpy as np
import torch

from openibl_tpu_torch.ops.distance import pairwise_sqdist
from openibl_tpu_torch.ops.pq import (
    build_ivfpq, build_pq, decode_pq, ivfpq_search, pq_search)
from openibl_tpu_torch.tools._common import (
    ARTIFACTS, add_device_flag, device_name, write_json)
from openibl_tpu_torch.tools.ivf_recall import (
    model_descriptors, nprobe_sweep, split_queries)
from openibl_tpu_torch.utils import f32_precision, resolve_device, to_numpy


def recall_tables(desc, n_queries, k, ms, nlist, seed=0, opq_iters=6,
                  device="cuda"):
    """(pq_rows {m: {column: value}}, ivfpq_rows {nprobe: recall in top
    4k}, the IVFADC m, the gallery size)."""
    device = resolve_device(device)
    q_np, g_np = split_queries(desc, n_queries, seed)
    q = torch.from_numpy(np.ascontiguousarray(q_np)).to(device)
    g = torch.from_numpy(np.ascontiguousarray(g_np)).to(device)

    with torch.no_grad(), f32_precision():
        d_all = to_numpy(pairwise_sqdist(q, g))
        thresh = np.sort(d_all, axis=1)[:, k - 1] + 1e-5  # exact k-th + eps

        def hit_rate(idx):
            idx = to_numpy(idx)
            safe = np.maximum(idx, 0)
            d_ex = np.take_along_axis(d_all, safe, axis=1)
            hits = (idx >= 0) & (d_ex <= thresh[:, None])
            return float(np.mean(np.minimum(hits.sum(axis=1), k) / k))

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        pq_rows = {}
        for m in ms:
            row = {}
            modes = [("", 0)] + ([("opq_", opq_iters)] if opq_iters else [])
            for tag, n_opq in modes:
                payload = build_pq(g, m=m, opq_iters=n_opq)
                codes, cb = payload["pq_codes"], payload["pq_codebooks"]
                rot = (put(payload["pq_rotation"])
                       if "pq_rotation" in payload else None)
                codes_t, cb_t = put(codes), put(cb)
                _, idx_k = pq_search(q, codes_t, cb_t, k=k, rotation=rot)
                _, idx_4k = pq_search(q, codes_t, cb_t, k=4 * k, rotation=rot)
                row[tag + "recall_at_k"] = hit_rate(idx_k)
                row[tag + "recall_at_k_in_top_4k"] = hit_rate(idx_4k)
                # the reconstruction error in the original frame: the OPQ
                # gain shows here even where tie-tolerant recall saturates
                y = decode_pq(cb, codes)
                if rot is not None:
                    y = y @ payload["pq_rotation"].T
                row[tag + "recon_mse"] = float(
                    np.mean(np.sum((g_np - y) ** 2, axis=1)))
            pq_rows[m] = row

        ivfpq_rows = {}
        m_ivf = ms[len(ms) // 2]
        payload = build_ivfpq(g, nlist=nlist, m=m_ivf)
        codes_t = put(payload["ivfpq_codes"])
        cb_t = put(payload["ivfpq_codebooks"])
        cent_t, lists_t = (put(payload["ivf_centroids"]),
                           put(payload["ivf_lists"]))
        for nprobe in nprobe_sweep(nlist):
            _, idx = ivfpq_search(q, codes_t, cb_t, cent_t, lists_t,
                                  k=4 * k, nprobe=nprobe)
            ivfpq_rows[nprobe] = hit_rate(idx)
    return pq_rows, ivfpq_rows, m_ivf, int(len(g_np))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-places", type=int, default=192)
    ap.add_argument("--imgs-per-place", type=int, default=6)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--n-queries", type=int, default=96)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ms", type=str, default="8,16,32,64",
                    help="PQ subquantizer counts to sweep")
    ap.add_argument("--nlist", type=int, default=64)
    ap.add_argument("--opq-iters", type=int, default=6,
                    help="OPQ alternations for the opq_ columns (0 = skip; "
                         "each pays a D x D SVD)")
    add_device_flag(ap)
    ap.add_argument("--out", default=str(ARTIFACTS / "pq_recall.json"))
    return ap.parse_args(argv)


def main(argv=None):
    """Run the tables, write the artifact and return its content."""
    args = parse(argv)
    device = resolve_device(args.device)
    desc = model_descriptors(args.n_places, args.imgs_per_place,
                             args.height, args.width, device=device)
    print(f"{len(desc)} model descriptors (D={desc.shape[1]}) on "
          f"{device_name(device)}")
    ms = [int(v) for v in args.ms.split(",") if v]
    pq_rows, ivfpq_rows, m_ivf, gallery_n = recall_tables(
        desc, args.n_queries, args.k, ms, args.nlist,
        opq_iters=args.opq_iters, device=device)

    print(f"\n| PQ m (bytes/desc) | recall@{args.k} | "
          f"recall@{args.k} in top-{4 * args.k} | recon MSE | "
          f"OPQ recall@{args.k} | OPQ in top-{4 * args.k} | OPQ recon MSE |")
    print("|---|---|---|---|---|---|---|")
    for m, row in pq_rows.items():
        opq = (f"{row['opq_recall_at_k']:.3f} | "
               f"{row['opq_recall_at_k_in_top_4k']:.3f} | "
               f"{row['opq_recon_mse']:.3e}"
               if "opq_recall_at_k" in row else "- | - | -")
        print(f"| {m} | {row['recall_at_k']:.3f} | "
              f"{row['recall_at_k_in_top_4k']:.3f} | "
              f"{row['recon_mse']:.3e} | {opq} |")
    print(f"\n| IVFADC m={m_ivf}, nprobe (of {args.nlist}) | "
          f"recall@{args.k} in top-{4 * args.k} |")
    print("|---|---|")
    for npb, r in ivfpq_rows.items():
        print(f"| {npb} | {r:.3f} |")

    result = {
        "gallery": gallery_n, "n_queries": args.n_queries, "k": args.k,
        "descriptor_dim": int(desc.shape[1]),
        "pq": pq_rows,
        "ivfpq": {"m": m_ivf, "nlist": args.nlist,
                  "recall_in_top_4k_by_nprobe": ivfpq_rows},
        "device": device_name(device),
    }
    write_json(args.out, result)
    print(json.dumps({"artifact": args.out, "ok": True,
                      "device": result["device"]}))
    return result


if __name__ == "__main__":
    main()
