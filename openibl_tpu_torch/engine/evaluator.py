"""Recall@N evaluation (port of openibl_tpu/engine/evaluator.py).

The kNN runs on the descriptors' device (ops.distance.topk_nearest); spatial
NMS and the recall scan are host index math. ``Evaluator.evaluate`` scores
a query loader against a gallery loader; a bucket-padded query loader
(``PaddedBatchLoader``) goes through the evaluator's ``masked_apply_fn``.
``Evaluator.evaluate_sources`` extracts both sides from image sources. Both
read their descriptors with the model's head (the fused kernel on the card)
and keep them on its device.

With a mesh of more than one rank (parallel.mesh) ``evaluate_sources``
splits each extraction over the ranks (``extract_features_sharded``), and
the kNN pads the gallery to a multiple of the world size and searches it
sharded (``topk_nearest_sharded``); NMS, the rerank and the recall scan
run on the gathered results, the same on every rank.

``rerank=True`` adds the k-reciprocal rerank (ops.rerank, k2=1): up to
``_RERANK_DISTMAT_BUDGET_BYTES`` the three distance matrices are computed
on the descriptors' device and reranked on the host (``re_ranking``);
above it ``rerank_ranks_streaming`` computes the same ranking from the
descriptors. Both order by ``composite_rank_key``, so the two sides of the
threshold agree.
"""

import numpy as np
import torch

from openibl_tpu_torch.ops.distance import (pairwise_sqdist, topk_nearest,
                                            topk_nearest_sharded)
from openibl_tpu_torch.ops.rerank import (composite_rank_key, re_ranking,
                                          rerank_ranks_streaming)
from openibl_tpu_torch.parallel.extract import (extract_features,
                                                extract_features_sharded)
from openibl_tpu_torch.parallel.mesh import process_local_mesh
from openibl_tpu_torch.utils import f32_precision, to_numpy
from openibl_tpu_torch.utils.profiling import PhaseTimer


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


def _refuse(nms, gallery_pids):
    if nms and gallery_pids is None:
        raise ValueError("nms=True requires gallery_pids")


# host-RAM budget of the materializing rerank path: its peak holds the three
# distance matrices (one n² f32 block together), re_ranking's (n, n)
# normalized copy and the (n_q, n) Jaccard output at once, ~2x4n² bytes
_RERANK_DISTMAT_BUDGET_BYTES = 2 * 1024**3


def _print_recalls(recalls, topk):
    print("Recall Scores:")
    for k, r in zip(topk, recalls):
        print(f"  top-{k:<4}{r:12.1%}")


def rerank_order(q_feats, g_feats, k_need, rr_topk=25, lambda_value=0):
    """The k-reciprocal reranked order (Q, k_need) of the gallery for each
    query (k1 = ``rr_topk``, k2 = 1), from tensors on one device or numpy
    arrays (the CPU): materialized below the budget, streamed above."""
    q = torch.as_tensor(q_feats)
    g = torch.as_tensor(g_feats).to(q.device)
    n_union = len(q) + len(g)
    if 8 * n_union * n_union > _RERANK_DISTMAT_BUDGET_BYTES:
        order, _ = rerank_ranks_streaming(q, g, k1=rr_topk, k2=1,
                                          lambda_value=lambda_value,
                                          k_out=k_need)
        return order
    with f32_precision():
        d_qg, d_qq, d_gg = (to_numpy(pairwise_sqdist(a, b))
                            for a, b in ((q, g), (q, q), (g, g)))
    final = re_ranking(d_qg, d_qq, d_gg, k1=rr_topk, k2=1,
                       lambda_value=lambda_value, device=q.device)
    key = composite_rank_key(final, d_qg)
    return np.argsort(key, axis=1)[:, :k_need]


def evaluate_descriptors(q_feats, g_feats, ground_truth, gallery_pids=None,
                         topk=(1, 5, 10), nms=False, rerank=False,
                         rr_topk=25, lambda_value=0, print_results=True,
                         mesh=None):
    """Recall@topk from query and gallery descriptors (tensors on any one
    device, or numpy arrays, searched on the CPU); with ``rerank`` the
    k-reciprocal reranked recalls are returned (both are printed).

    With a ``mesh`` of more than one rank, every rank passes the whole
    descriptors; the gallery is padded to a multiple of the world size with
    rows of 1e3 (far from any unit-norm query) and searched sharded on the
    ranks' devices."""
    _refuse(nms, gallery_pids)  # before the kNN
    k_need = max(topk) * (12 if nms else 1)
    g = torch.as_tensor(g_feats)
    k = min(k_need, g.shape[0])
    with f32_precision():  # the JAX kNN's Precision.HIGHEST
        if mesh is not None and mesh.size > 1:
            pad = (-len(g)) % mesh.size
            if pad:
                g = torch.cat([g.float(), torch.full(
                    (pad, g.shape[1]), 1e3, device=g.device)])
            _, idx = topk_nearest_sharded(q_feats, g, mesh, k=k)
        else:
            _, idx = topk_nearest(torch.as_tensor(q_feats), g, k=k)
    recalls = recalls_from_ranks(to_numpy(idx), ground_truth, gallery_pids,
                                 topk, nms)
    if print_results:
        _print_recalls(recalls, topk)
    if not rerank:
        return recalls
    return reranked_recalls(q_feats, g_feats, ground_truth, gallery_pids,
                            topk, nms, rr_topk, lambda_value, print_results)


def reranked_recalls(q_feats, g_feats, ground_truth, gallery_pids=None,
                     topk=(1, 5, 10), nms=False, rr_topk=25, lambda_value=0,
                     print_results=True):
    """Recall@topk of the k-reciprocal reranked order (``rerank_order``)."""
    k_need = max(topk) * (12 if nms else 1)
    order = rerank_order(q_feats, g_feats, k_need, rr_topk, lambda_value)
    recalls = recalls_from_ranks(order, ground_truth, gallery_pids, topk, nms)
    if print_results:
        print("after re-ranking:")
        _print_recalls(recalls, topk)
    return recalls


class Evaluator:
    """Binds a model (e.g. ``pipeline.eval_view`` of the trained EmbedNet),
    the feature it reads and, for bucket-padded query loaders, its masked
    forward (e.g. ``model.forward_masked``); evaluates loaders or image
    sources end to end. Each evaluation's query pass, gallery pass, kNN and
    rerank are phases of ``timer`` ("query", "gallery", "knn", "rerank"; a
    ``PhaseTimer`` of its own by default). With a ``mesh`` (the model on
    its rank's device) the kNN is sharded over its ranks and
    ``evaluate_sources`` splits the extractions over them."""

    def __init__(self, model, feature="vlad", masked_apply_fn=None,
                 timer=None, mesh=None):
        self.model = model
        self.feature = feature
        self.masked_apply_fn = masked_apply_fn
        self.timer = timer if timer is not None else PhaseTimer()
        self.mesh = mesh

    def extract(self, loader, pca=None, verbose=False):
        """Descriptors of every item ``loader`` yields, in ascending index
        order, kept on the model's device (every rank extracts them all, on
        its own sub-mesh)."""
        return extract_features(self.model, loader,
                                mesh=process_local_mesh(self.mesh), pca=pca,
                                feature=self.feature, verbose=verbose,
                                masked_apply_fn=self.masked_apply_fn,
                                device_output=True)

    def extract_sharded(self, source, pca=None, batch_size=32, prefetch=2,
                        verbose=False):
        """Descriptors of every item of ``source``, in dataset order, on
        every rank, each rank extracting its slice
        (``extract_features_sharded``)."""
        return extract_features_sharded(
            self.model, source, batch_size=batch_size, mesh=self.mesh,
            pca=pca, feature=self.feature, verbose=verbose,
            prefetch=prefetch, device_output=True)

    def evaluate(self, query_loader, gallery_loader, ground_truth,
                 gallery_pids=None, pca=None, topk=(1, 5, 10), nms=False,
                 rerank=False, rr_topk=25, lambda_value=0, verbose=False,
                 print_results=True):
        """Recall@topk of ``query_loader``'s items against
        ``gallery_loader``'s (a ``BatchLoader`` or a ``PaddedBatchLoader``
        each). The rerank, when asked, is a phase of its own ("rerank")."""
        _refuse(nms, gallery_pids)  # before the extraction
        with self.timer.phase("query"):
            q_feats = self.extract(query_loader, pca=pca, verbose=verbose)
        with self.timer.phase("gallery"):
            g_feats = self.extract(gallery_loader, pca=pca, verbose=verbose)
        return self.score(q_feats, g_feats, ground_truth, gallery_pids, topk,
                          nms, rerank, rr_topk, lambda_value, print_results)

    def score(self, q_feats, g_feats, ground_truth, gallery_pids=None,
              topk=(1, 5, 10), nms=False, rerank=False, rr_topk=25,
              lambda_value=0, print_results=True):
        """The kNN (sharded over the mesh's ranks) and, when asked, the
        rerank of extracted descriptors, each a phase."""
        with self.timer.phase("knn"):
            recalls = evaluate_descriptors(
                q_feats, g_feats, ground_truth, gallery_pids, topk=topk,
                nms=nms, print_results=print_results, mesh=self.mesh)
        if not rerank:
            return recalls
        with self.timer.phase("rerank"):
            return reranked_recalls(q_feats, g_feats, ground_truth,
                                    gallery_pids, topk, nms, rr_topk,
                                    lambda_value, print_results)

    def evaluate_sources(self, q_source, db_source, ground_truth,
                         gallery_pids=None, pca=None, batch_size=32,
                         prefetch=2, topk=(1, 5, 10), nms=False,
                         rerank=False, rr_topk=25, lambda_value=0,
                         verbose=False, print_results=True):
        """``evaluate`` over two fixed-shape image sources, each extraction
        split over the mesh's ranks (``extract_sharded``)."""
        _refuse(nms, gallery_pids)  # before the extraction
        feats = []
        for phase, src in (("query", q_source), ("gallery", db_source)):
            with self.timer.phase(phase):
                feats.append(self.extract_sharded(
                    src, pca=pca, batch_size=batch_size, prefetch=prefetch,
                    verbose=verbose))
        return self.score(*feats, ground_truth, gallery_pids, topk, nms,
                          rerank, rr_topk, lambda_value, print_results)
