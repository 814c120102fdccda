"""Recall@N evaluation (port of openibl_tpu/engine/evaluator.py, single
device, unmasked, no rerank).

The kNN runs on the descriptors' device (ops.distance.topk_nearest); spatial
NMS and the recall scan are host index math. ``Evaluator.evaluate_sources``
extracts both sides from image sources (with the model's head, the fused
kernel on the card) and scores them. The mesh-sharded kNN, the
k-reciprocal rerank and the loader-driven masked ``evaluate`` come with
ROADMAP Queue 1 items 12, 10 and 8.
"""

import numpy as np
import torch

from openibl_tpu_torch.ops.distance import topk_nearest
from openibl_tpu_torch.utils import f32_precision, to_numpy


def spatial_nms(pred, db_ids, top_n):
    """Keep the first occurrence of each panorama id among the top ``top_n``
    predictions."""
    seen = set()
    out = []
    for p in pred[:top_n]:
        pid = db_ids[p]
        if pid not in seen:
            seen.add(pid)
            out.append(p)
    return out


def recalls_from_ranks(sorted_idx, ground_truth, gallery_pids=None,
                       topk=(1, 5, 10), nms=False):
    """Recall@k given per-query ranked gallery indices: a query counts for
    every k >= the rank of its first true positive; NMS first dedups by
    panorama id over the top 12*max(topk)."""
    topk = list(topk)
    if nms and gallery_pids is None:
        raise ValueError("nms=True requires gallery_pids")
    correct_at_n = np.zeros(len(topk))
    for q, pred in enumerate(sorted_idx):
        pred = list(pred)
        if nms:
            pred = spatial_nms(pred, gallery_pids, max(topk) * 12)
        gt = set(ground_truth[q])
        for i, k in enumerate(topk):
            if any(p in gt for p in pred[:k]):
                correct_at_n[i:] += 1
                break
    return correct_at_n / len(sorted_idx)


def evaluate_descriptors(q_feats, g_feats, ground_truth, gallery_pids=None,
                         topk=(1, 5, 10), nms=False, print_results=True):
    """Recall@topk from query and gallery descriptors (tensors on any one
    device, or numpy arrays, searched on the CPU)."""
    if nms and gallery_pids is None:
        raise ValueError("nms=True requires gallery_pids")  # before the kNN
    k_need = max(topk) * (12 if nms else 1)
    g = torch.as_tensor(g_feats)
    with f32_precision():  # the JAX kNN's Precision.HIGHEST
        _, idx = topk_nearest(torch.as_tensor(q_feats), g,
                              k=min(k_need, g.shape[0]))
    recalls = recalls_from_ranks(to_numpy(idx), ground_truth, gallery_pids,
                                 topk, nms)
    if print_results:
        print("Recall Scores:")
        for k, r in zip(topk, recalls):
            print(f"  top-{k:<4}{r:12.1%}")
    return recalls


class Evaluator:
    """Binds a model (e.g. ``pipeline.eval_view`` of the trained EmbedNet)
    and the feature it reads; evaluates image sources end to end."""

    def __init__(self, model, feature="vlad"):
        self.model = model
        self.feature = feature

    def evaluate_sources(self, q_source, db_source, ground_truth, pca=None,
                         batch_size=32, prefetch=2, print_results=True):
        """Extract queries and gallery (kept on the model's device), then
        Recall@1/5/10."""
        from openibl_tpu_torch.data.loader import BatchLoader
        from openibl_tpu_torch.parallel.extract import extract_features

        feats = [
            extract_features(self.model,
                             BatchLoader(src, batch_size=batch_size,
                                         prefetch=prefetch),
                             pca=pca, feature=self.feature,
                             device_output=True)
            for src in (q_source, db_source)
        ]
        return evaluate_descriptors(*feats, ground_truth,
                                    print_results=print_results)
