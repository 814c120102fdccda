"""Exact k-nearest-neighbour retrieval and hard-tuple mining (port of
openibl_tpu/ops/distance.py, retrieval and mining halves).

``topk_nearest`` either materializes the (Q, N) distance matrix and runs one
top-k (small problems) or streams the gallery in tiles and merges a running
top-k (O(Q*k) state). f16 and int8 galleries (with per-row scales) stay in
their storage dtype on the streaming path and are widened one tile at a
time. The JAX package leaves this step to XLA; here it is ``torch.matmul``
and ``torch.topk``; ``return_rowmax`` adds each query's largest distance
over the whole gallery (the k-reciprocal rerank's row normalization).
``mine_hard_tuples`` picks each anchor's easiest positive and hardest
negatives from one f32 (S, G) distance matrix, with TF32 off as the JAX
package's ``Precision.HIGHEST`` asks; ``rank_positives`` orders each
anchor's positives nearest first, and ``mine_hard_tuples_ranked`` does
both from one shared matrix (the SFRS refresh). ``topk_nearest_sharded``
splits the gallery over the ranks of a mesh (parallel.mesh), or searches
each rank's resident shard: each rank searches its rows and one
all-gather of (distance, index) candidates merges them
(``merge_across_ranks``, shared with ``ops.pq.pq_search_sharded``).
"""

import os

import numpy as np
import torch

from openibl_tpu_torch.parallel.mesh import all_gather_rows
from openibl_tpu_torch.utils import f32_precision


def pairwise_sqdist(x, y):
    """Squared euclidean distances (M, N) between rows of x (M, D), y (N, D)."""
    x, y = x.float(), y.float()
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    y2 = torch.sum(y * y, dim=1, keepdim=True).T
    return x2 + y2 - 2.0 * torch.matmul(x, y.T)


# distmats up to this size are materialized whole (one top-k); above it the
# streaming scan keeps memory at O(Q*k). The full path's peak is ~3x the
# distmat (d, top-k workspace), so this bounds it to ~1.5 GB.
_FULL_DISTMAT_BUDGET_BYTES = 512 * 1024**2

# budget for the transient f32 widening of an f16/int8 gallery on the full
# path; None = a quarter of the device's free memory (env override below)
_WIDEN_BUDGET_BYTES = None

# streaming tile target: each step widens one (chunk, D) f32 tile and holds
# ~3 copies of the (Q, chunk) distmat
_STREAM_TILE_BYTES = 256 * 1024**2


def _widen_budget_bytes(device=None):
    if _WIDEN_BUDGET_BYTES is not None:
        return _WIDEN_BUDGET_BYTES
    env = os.environ.get("OPENIBL_WIDEN_BUDGET_BYTES")
    if env:
        return int(env)
    if device is not None and torch.device(device).type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(free // 4, 256 * 1024**2)
    return 4 * 1024**3


def _auto_full_path(q_rows, n, feat_dim, gallery_widened, device=None):
    """Whether topk_nearest should materialize the full distance matrix:
    the f32 distmat fits its budget and, for reduced-precision galleries,
    the transient f32 copy of the gallery fits the widening budget."""
    if 4 * q_rows * n > _FULL_DISTMAT_BUDGET_BYTES:
        return False
    if gallery_widened and 4 * n * feat_dim > _widen_budget_bytes(device):
        return False
    return True


def _auto_chunk(n, feat_dim, q_rows=1):
    # budget both per-step transients: the (chunk, D) widened tile and the
    # ~3x (Q, chunk) distmat workspace
    denom = 4 * (feat_dim + 3 * max(int(q_rows), 1))
    rows = _STREAM_TILE_BYTES // max(denom, 1)
    return int(min(max(rows, 4096), max(n, 1)))


def quantize_index_int8(descriptors):
    """Symmetric per-row int8 quantization (numpy): (codes (N, D) int8,
    scales (N,) f32) with descriptors ≈ codes * scales[:, None]."""
    x = np.asarray(descriptors, np.float32)
    scales = np.abs(x).max(axis=1) / 127.0
    scales = np.maximum(scales, np.finfo(np.float32).tiny).astype(np.float32)
    codes = np.clip(np.rint(x / scales[:, None]), -127, 127).astype(np.int8)
    return codes, scales


def _widen(tile, scale):
    tile = tile.float()
    return tile if scale is None else tile * scale[:, None]


def _smallest(d, k):
    return torch.topk(d, k, dim=1, largest=False, sorted=True)


def _merge_topk(dist_a, idx_a, dist_b, idx_b, k):
    """Merge two top-k candidate sets (rowwise), keeping the k smallest."""
    d = torch.cat([dist_a, dist_b], dim=1)
    best_d, pos = _smallest(d, min(k, d.shape[1]))
    return best_d, torch.gather(torch.cat([idx_a, idx_b], dim=1), 1, pos)


def topk_nearest(query, gallery, k, chunk=None, full_path=None,
                 return_rowmax=False, gallery_scale=None,
                 gallery_sqnorm=None):
    """k nearest gallery rows per query row by squared L2.

    query (Q, D); gallery (N, D) f32, f16 or int8 (with ``gallery_scale``
    (N,) f32); ``gallery_sqnorm`` (N,) f32, the squared norms of the
    (dequantized) rows, precomputed once at index load. The search runs on
    the gallery's device. ``full_path=None`` chooses by the budgets above;
    ``chunk=None`` sizes streaming tiles to ~256 MB. Returns (dists (Q, k)
    f32, indices (Q, k) int64), nearest first; with ``return_rowmax`` also
    each query's largest distance over the whole gallery (Q,).
    """
    g = torch.as_tensor(gallery)
    q = torch.as_tensor(query).to(device=g.device, dtype=torch.float32)
    scale = (None if gallery_scale is None else
             torch.as_tensor(gallery_scale).to(g.device, torch.float32))
    sqn = (None if gallery_sqnorm is None else
           torch.as_tensor(gallery_sqnorm).to(g.device, torch.float32))
    n = g.shape[0]
    k = min(k, n)
    if chunk is None:
        chunk = _auto_chunk(n, g.shape[1], q.shape[0])
    if full_path is None:
        widened = scale is not None or g.dtype != torch.float32
        full_path = _auto_full_path(q.shape[0], n, g.shape[1], widened,
                                    g.device)
    q2 = torch.sum(q * q, dim=1, keepdim=True)
    if full_path:
        # int8 scales apply to the product's columns: (q·codes)·s == q·(codes·s)
        xy = torch.matmul(q, g.float().T)
        if scale is not None:
            xy = xy * scale[None, :]
        n2 = sqn if sqn is not None else torch.sum(
            torch.square(_widen(g, scale)), dim=1)
        d = q2 + n2[None, :] - 2.0 * xy
        best_d, best_i = _smallest(d, k)
        if return_rowmax:
            return best_d, best_i, torch.amax(d, dim=1)
        return best_d, best_i
    best_d = best_i = best_m = None
    for s in range(0, n, chunk):
        tile = _widen(g[s:s + chunk], None if scale is None
                      else scale[s:s + chunk])
        t2 = (sqn[s:s + chunk] if sqn is not None
              else torch.sum(tile * tile, dim=1))
        d = q2 + t2[None, :] - 2.0 * torch.matmul(q, tile.T)
        if return_rowmax:
            tm = torch.amax(d, dim=1)
            best_m = tm if best_m is None else torch.maximum(best_m, tm)
        td, ti = _smallest(d, min(k, tile.shape[0]))
        ti = ti + s
        if best_d is not None:
            td, ti = _merge_topk(best_d, best_i, td, ti, k)
        best_d, best_i = td, ti
    if return_rowmax:
        return best_d, best_i, best_m
    return best_d, best_i


def merge_across_ranks(mesh, d, idx, k):
    """The k smallest of every rank's (Q, k_local) candidates (``d`` with
    their global indices ``idx``, the same shapes on each rank): one
    all-gather of each over the mesh's group, then a top-k. The result is
    the same on every rank; without a group it is the top-k of ``d``."""
    q_n, k_local = d.shape

    def across_ranks(x):  # (Q, k_local) per rank → (Q, n · k_local)
        x = all_gather_rows(mesh, x).reshape(mesh.size, q_n, k_local)
        return x.permute(1, 0, 2).reshape(q_n, -1)

    d_all = across_ranks(d)
    best_d, pos = _smallest(d_all, min(k, d_all.shape[1]))
    return best_d, torch.gather(across_ranks(idx), 1, pos)


def topk_nearest_sharded(query, gallery, mesh, k, chunk=None,
                         gallery_scale=None, gallery_sqnorm=None,
                         resident=False):
    """k nearest neighbours with the gallery sharded over the ranks of
    ``mesh`` (parallel.mesh.Mesh).

    ``gallery`` (G, D) is the same on every rank (numpy or a tensor on any
    device), G a multiple of the world size: rank r moves rows
    [r·G/n, (r+1)·G/n) to its device and runs ``topk_nearest`` over them
    (k and ``chunk`` capped at G/n). With ``resident=True`` ``gallery`` is
    already this rank's shard, rows [r·S, (r+1)·S) of the whole for a shard
    of S rows, on its device, with ``gallery_scale`` / ``gallery_sqnorm``
    its own rows too: nothing is sliced or copied (a service's index). The
    per-rank (Q, k) candidates, their indices made global, are merged by
    ``merge_across_ranks``, so no rank holds more than G/n rows or ever
    forms Q x G. ``gallery_scale`` (int8 rows) and ``gallery_sqnorm`` (G,)
    are sharded like the gallery. Returns (dists (Q, k), global indices
    (Q, k)) on ``mesh.device``, the same on every rank.
    """
    if resident:
        per = gallery.shape[0]

        def shard(a):
            return a
    else:
        g_total = gallery.shape[0]
        if g_total % mesh.size:
            raise ValueError(f"gallery size {g_total} not divisible by "
                             f"{mesh.size}")
        per = g_total // mesh.size
        rows = slice(mesh.rank * per, (mesh.rank + 1) * per)

        def shard(a):
            return None if a is None else torch.as_tensor(a[rows]).to(
                mesh.device)

    d, idx = topk_nearest(
        torch.as_tensor(query).to(mesh.device), shard(gallery),
        k=min(k, per), chunk=None if chunk is None else min(chunk, per),
        gallery_scale=shard(gallery_scale),
        gallery_sqnorm=shard(gallery_sqnorm))
    return merge_across_ranks(mesh, d, idx + mesh.rank * per, k)


def _pos_distances(d2, pos_idx):
    """(S, P) distances to each anchor's UTM positives, inf where padded."""
    pos_d = torch.gather(d2, 1, torch.clamp(pos_idx, min=0))
    return torch.where(pos_idx >= 0, pos_d, torch.full_like(pos_d, np.inf))


def _mine_from_d2(d2, pos_idx, cand_idx, neg_num):
    pos_d = _pos_distances(d2, pos_idx)
    pos_choice = torch.gather(
        pos_idx, 1, torch.argmin(pos_d, dim=1, keepdim=True))[:, 0]
    cand_d = torch.gather(d2, 1, torch.clamp(cand_idx, min=0))
    cand_d = torch.where(cand_idx >= 0, cand_d,
                         torch.full_like(cand_d, np.inf))
    # a stable sort, not topk: equal distances keep candidate order, as
    # lax.top_k keeps them (the lower position first)
    top = torch.sort(cand_d, dim=1, stable=True).indices[:, :neg_num]
    return pos_choice, torch.gather(cand_idx, 1, top)


def _rank_from_d2(d2, pos_idx, pos_pool):
    pos_d = _pos_distances(d2, pos_idx)
    # stable, as jnp.argsort: equal distances keep the positives' order
    order = torch.sort(pos_d, dim=1, stable=True).indices[:, :pos_pool]
    ranked = torch.gather(pos_idx, 1, order)
    ranked_d = torch.gather(pos_d, 1, order)
    ranked = torch.where(torch.isfinite(ranked_d), ranked,
                         torch.full_like(ranked, -1))
    return ranked, ranked_d


def _mining_d2(q_feats, g_feats, *index_arrays):
    """The f32 (S, G) distance matrix on the gallery's device, and the
    index arrays there as int64 tensors."""
    g = torch.as_tensor(g_feats)
    dev = g.device
    idx = [torch.as_tensor(a, device=dev).long() for a in index_arrays]
    with f32_precision():
        d2 = pairwise_sqdist(torch.as_tensor(q_feats).to(dev), g)
    return d2, idx


def mine_hard_tuples(q_feats, g_feats, pos_idx, cand_idx, neg_num=10):
    """Hard-tuple mining on the features' device.

    The positive is the *easiest* (nearest by current descriptors) among
    each anchor's UTM positives; the negatives are the ``neg_num``
    *hardest* (nearest) of its candidates (a host-sampled random pool ∪
    the previous refresh's negatives, UTM-near items already excluded),
    nearest first; a -1 means too few valid candidates.

    Args:
      q_feats: (S, D) anchor descriptors; g_feats: (G, D) gallery.
      pos_idx: (S, P) gallery indices of UTM positives, -1 padded.
      cand_idx: (S, C) candidate negative indices, -1 padded.
    Returns:
      pos_choice (S,), neg_choice (S, neg_num) int64 tensors on the
      features' device.
    """
    d2, (pos_idx, cand_idx) = _mining_d2(q_feats, g_feats, pos_idx,
                                         cand_idx)
    return _mine_from_d2(d2, pos_idx, cand_idx, neg_num)


def rank_positives(q_feats, g_feats, pos_idx, pos_pool=20):
    """Each anchor's UTM positives ranked by current descriptor distance:
    (S, pos_pool) gallery indices nearest first (-1 padded) and their
    distances (inf where padded), on the features' device."""
    d2, (pos_idx,) = _mining_d2(q_feats, g_feats, pos_idx)
    return _rank_from_d2(d2, pos_idx, pos_pool)


def mine_hard_tuples_ranked(q_feats, g_feats, pos_idx, cand_idx, neg_num=10,
                            pos_pool=20):
    """``mine_hard_tuples`` and ``rank_positives`` from one shared (S, G)
    distance matrix (the SFRS refresh needs both; the product is the
    refresh's largest cost). Returns (pos_choice, neg_choice, ranked,
    ranked_d)."""
    d2, (pos_idx, cand_idx) = _mining_d2(q_feats, g_feats, pos_idx,
                                         cand_idx)
    pos_choice, neg_choice = _mine_from_d2(d2, pos_idx, cand_idx, neg_num)
    ranked, ranked_d = _rank_from_d2(d2, pos_idx, pos_pool)
    return pos_choice, neg_choice, ranked, ranked_d
