"""Wall time of the SFRS refresh's Jaccard rerank, per implementation (port
of scripts/time_sfrs_rerank.py).

  python -m openibl_tpu_torch.tools.time_sfrs_rerank [--n 17000]
      [--queries 1000] [--skip-r1] [--device cuda|cpu]
      [--out logs/torch/sfrs_rerank_timing.json]

An SFRS refresh reranks ~1k subset anchors against the q∪db union (~17k
items for Pitts30k; reference: ibl/utils/data/sampler.py:126-151 and
ibl/utils/rerank.py:32). Two paths, on seeded clustered unit-norm features
of ``--dim`` dimensions:

  r1: the full ``ops.rerank.re_ranking``: the N x N distances computed on
      the device (``pairwise_sqdist``) and brought to the host, then the
      host's partial sort over N², the expansion sets and the Jaccard of
      every query (the reference reranks all of them). At N = 17,000 the
      host holds three slices of a 1.16 GB matrix and this takes minutes:
      ``--skip-r1`` leaves it out.
  r2: ``build_v_sparse`` (the union's top-k on the device, sparse V rows)
      and the Jaccard of the subset anchors only, by the host engine (the
      C++ loops of csrc/rerank.cpp, or scipy) and by the device engine
      (``scatter_add_`` on the card).

Each time is the host clock around work that ends on the host (numpy
results), so the device's share is inside it. The two Jaccard engines must
agree within rtol 1e-5 / atol 1e-6 (the device engine's atomics add in a
varying order): the command fails otherwise. Writes the JSON artifact,
under the JAX script's keys (``backend`` is the card's name), and prints
it.
"""

import argparse
import json
import time

import numpy as np
import torch

from openibl_tpu_torch.ops.distance import pairwise_sqdist
from openibl_tpu_torch.ops.rerank import (
    build_v_sparse, jaccard_for_queries, re_ranking)
from openibl_tpu_torch.tools._common import (
    ARTIFACTS, add_device_flag, device_name, write_json)
from openibl_tpu_torch.utils import f32_precision, resolve_device, to_numpy

# the device engine's gate against the host engine (the SFRS mining gate)
RTOL, ATOL = 1e-5, 1e-6


def features(n, dim):
    """(n, dim) unit-norm f32 rows around 64 seeded centres (the JAX
    script's draws)."""
    rng = np.random.RandomState(0)
    centers = rng.randn(64, dim).astype(np.float32)
    feats = centers[rng.randint(64, size=n)] + 0.3 * rng.randn(
        n, dim).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return feats


def time_rerank(n, n_q, queries, dim, k1, skip_r1, device):
    """(result, host Jaccard, device Jaccard): the timings under the JAX
    script's keys and the two engines' (queries, n) distances."""
    feats = features(n, dim)
    n_q = min(n_q, n - 1)
    result = {"n_union": n, "n_q": n_q, "subset_queries": queries, "k1": k1}

    if not skip_r1:
        t0 = time.perf_counter()
        with torch.no_grad(), f32_precision():
            u = torch.from_numpy(feats).to(device)
            d = to_numpy(pairwise_sqdist(u, u)).astype(np.float32, copy=False)
        del u
        d = np.sqrt(np.maximum(d, 0.0))
        t_dist = time.perf_counter() - t0
        t0 = time.perf_counter()
        re_ranking(d[:n_q, n_q:], d[:n_q, :n_q], d[n_q:, n_q:], k1=k1, k2=1,
                   lambda_value=0.0, device=device)
        t_r1 = time.perf_counter() - t0
        del d
        result["r1_distmat_s"] = round(t_dist, 3)
        result["r1_re_ranking_s"] = round(t_r1, 3)
        result["r1_total_s"] = round(t_dist + t_r1, 3)

    t0 = time.perf_counter()
    rows, cols, vals, _, _ = build_v_sparse(
        torch.from_numpy(feats).to(device), k1=k1)
    t_build = time.perf_counter() - t0
    qrows = np.arange(queries)

    t0 = time.perf_counter()
    host = jaccard_for_queries(rows, cols, vals, n, qrows, prefer="host",
                               device=device)
    t_host = time.perf_counter() - t0

    t0 = time.perf_counter()
    dev = jaccard_for_queries(rows, cols, vals, n, qrows, prefer="device",
                              device=device)
    t_dev = time.perf_counter() - t0

    result.update({
        "r2_build_v_s": round(t_build, 3),
        "r2_jaccard_host_s": round(t_host, 3),
        "r2_jaccard_device_s": round(t_dev, 3),
        "r2_total_s": round(t_build + min(t_host, t_dev), 3),
        "engines_max_abs_diff": float(np.abs(dev - host).max()),
    })
    if "r1_total_s" in result:
        result["speedup_vs_r1"] = round(
            result["r1_total_s"] / result["r2_total_s"], 2)
    return result, host, dev


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=17000,
                    help="union size (Pitts30k SFRS refresh is ~17k)")
    ap.add_argument("--n-q", type=int, default=7320,
                    help="query count in the union (Pitts30k train)")
    ap.add_argument("--queries", type=int, default=1000,
                    help="subset anchors actually mined per refresh")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--k1", type=int, default=20)
    ap.add_argument("--skip-r1", action="store_true")
    add_device_flag(ap)
    ap.add_argument("--out",
                    default=str(ARTIFACTS / "sfrs_rerank_timing.json"))
    return ap.parse_args(argv)


def main(argv=None):
    """Time both paths, check the engines agree, write the artifact and
    return its content."""
    args = parse(argv)
    device = resolve_device(args.device)
    result, host, dev = time_rerank(args.n, args.n_q, args.queries, args.dim,
                                    args.k1, args.skip_r1, device)
    result["backend"] = device_name(device)
    write_json(args.out, result)
    print(json.dumps(result))
    if not np.allclose(dev, host, rtol=RTOL, atol=ATOL):
        raise SystemExit(
            f"device and host Jaccard differ beyond rtol {RTOL} / atol "
            f"{ATOL}: max |diff| {result['engines_max_abs_diff']}")
    return result


if __name__ == "__main__":
    main()
