"""IVF (inverted-file) coarse-quantized gallery search (port of
openibl_tpu/ops/ivf.py).

The gallery is bucketed into ``nlist`` k-means cells and a query scores only
the ``nprobe`` cells nearest to it, which cuts the bytes read per query by
~nlist/nprobe; nprobe = nlist is exhaustive and gives the exact ranking.
Cells are capacity-capped at build time (overflow spills to the row's next
nearest open cell), so the (nlist, maxlen) id table, -1 padded, is a
partition of the gallery and every probe is a fixed-size gather. The search
walks the probe ranks and merges a running top-k, so at most one
(Q, maxlen, D) candidate tile is alive. f16/int8 galleries are widened one
tile at a time (int8 with per-row scales, ops.distance.quantize_index_int8).
"""

import warnings

import numpy as np
import torch

from openibl_tpu_torch.ops.distance import topk_nearest
from openibl_tpu_torch.ops.kmeans import kmeans
from openibl_tpu_torch.utils import to_numpy


def build_ivf(descriptors, nlist=None, maxlen=None, iters=25, seed=0,
              train_size=65536):
    """Cluster a descriptor index into capacity-capped IVF cells.

    Args:
      descriptors: (N, D) floats, numpy (built on the CPU) or a tensor (built
        on its device): the SAME vectors the search will run over (for an
        int8 index the dequantized ``codes * scales``).
      nlist: number of cells; default ~sqrt(N) rounded to a power of two.
      maxlen: per-cell capacity; default ceil(2 * N / nlist).
      iters: Lloyd iterations of the coarse quantizer (ops.kmeans).
      train_size: k-means subsample size.

    Returns dict {"centroids": (nlist, D) f32, "lists": (nlist, maxlen)
    int32, -1 padded}, numpy; every gallery id is in exactly one cell.
    """
    x = torch.as_tensor(descriptors).to(torch.float32)
    n = x.shape[0]
    if n == 0:
        raise ValueError("cannot build an IVF index over an empty gallery")
    if nlist is None:
        nlist = 2 ** int(np.round(np.log2(max(np.sqrt(n), 1.0))))
    nlist = int(min(max(nlist, 1), n))
    if maxlen is None:
        maxlen = -(-2 * n // nlist)
    maxlen = int(maxlen)
    if maxlen * nlist < n:
        raise ValueError(
            f"capacity nlist*maxlen={nlist * maxlen} < N={n}: every row "
            f"needs a cell"
        )

    rs = np.random.RandomState(seed)
    if n <= train_size:
        train = x
    else:
        sel = rs.choice(n, train_size, False)
        train = x[torch.as_tensor(sel, device=x.device)]
    centroids, _ = kmeans(train, nlist, iters=iters, seed=seed)

    # rank each row's nearest cells on the device, then fill the
    # capacity-capped cells greedily on the host
    depth = min(nlist, 8)
    _, ranked = topk_nearest(x, torch.from_numpy(centroids).to(x.device),
                             k=depth)
    lists = fill_lists(to_numpy(ranked), nlist, maxlen, x=x,
                       centroids=centroids)
    return {"centroids": centroids.astype(np.float32), "lists": lists}


def fill_lists(ranked, nlist, maxlen, x=None, centroids=None):
    """Greedy capacity-capped cell assignment from per-row cell rankings.

    ``ranked`` (N, depth) int: each row's nearest cells, best first. A row
    lands in its nearest cell with room. Rows whose ranked cells are ALL
    full spill to the nearest open cell by centroid distance when
    ``x``/``centroids`` are given (an arbitrary open cell would make them
    near-unreachable at low nprobe), else to the first open cell; a warning
    reports the overflow count. ``x`` may be a tensor on any device: only
    the overflow rows are gathered to the host. Returns the (nlist, maxlen)
    int32 id table, -1 padded.
    """
    n = ranked.shape[0]
    if nlist * maxlen < n:
        raise ValueError(
            f"capacity nlist*maxlen={nlist * maxlen} < N={n}: every row "
            f"needs a cell"
        )
    lists = np.full((nlist, maxlen), -1, np.int32)
    fill = np.zeros(nlist, np.int64)
    overflow = []
    for i in range(n):
        for c in ranked[i]:
            if fill[c] < maxlen:
                lists[c, fill[c]] = i
                fill[c] += 1
                break
        else:
            overflow.append(i)
    if overflow:  # all ranked cells full: spill to an open cell
        open_mask = fill < maxlen
        rank_geo = x is not None and centroids is not None
        if rank_geo:
            # one (O, nlist) distance block via a single matmul
            if isinstance(x, torch.Tensor):
                xo = to_numpy(x[torch.as_tensor(overflow, device=x.device)])
            else:
                xo = np.asarray(x)[np.asarray(overflow)]
            xo = np.asarray(xo, np.float32)
            cc = np.asarray(centroids, np.float32)
            d_all = (
                np.sum(np.square(xo), axis=1, keepdims=True)
                - 2.0 * xo @ cc.T
                + np.sum(np.square(cc), axis=1)[None]
            )
        for j, i in enumerate(overflow):
            if rank_geo:
                c = int(np.argmin(np.where(open_mask, d_all[j], np.inf)))
            else:
                c = int(np.argmax(open_mask))  # first open cell
            lists[c, fill[c]] = i
            fill[c] += 1
            if fill[c] == maxlen:
                open_mask[c] = False
        warnings.warn(
            f"IVF: {len(overflow)} rows overflowed their {ranked.shape[1]} "
            f"nearest cells and spilled to the "
            f"{'nearest' if rank_geo else 'first'} open cell — consider a "
            f"larger maxlen if this is a large fraction of the gallery",
            stacklevel=2,
        )
    return lists


def _probe_cells(q, centroids, nprobe):
    """(Q, nprobe) ids of each query's nearest cells, nearest first."""
    c2 = torch.sum(torch.square(centroids), dim=1)[None, :]
    return torch.topk(c2 - 2.0 * torch.matmul(q, centroids.T), nprobe,
                      dim=1, largest=False, sorted=True).indices


def _merge(best_d, best_i, d, ids, k):
    """Running top-k merge of (Q, k) state with a (Q, T) candidate tile."""
    md = torch.cat([best_d, d], dim=1)
    mi = torch.cat([best_i, ids], dim=1)
    md, pos = torch.topk(md, k, dim=1, largest=False, sorted=True)
    return md, torch.gather(mi, 1, pos)


def _candidate_d2(q, g, ids, scale=None, sqnorm=None):
    """Exact squared L2 (Q, T) from each query row to its own candidate rows
    ``ids`` (Q, T), all >= 0, of the gallery g (N, D). The rows are widened
    to f32 one tile at a time (int8 times its per-row ``scale``); ``sqnorm``
    (N,) is gathered in place of the rows' recomputed squared norms."""
    flat = ids.reshape(-1)
    rows = g[flat].to(torch.float32)
    if scale is not None:
        rows = rows * scale[flat][:, None]
    rows = rows.reshape(ids.shape + (g.shape[1],))
    if sqnorm is not None:
        t2 = sqnorm[flat].reshape(ids.shape)
    else:
        t2 = torch.sum(rows * rows, dim=2)
    q2 = torch.sum(q * q, dim=1, keepdim=True)
    return q2 + t2 - 2.0 * torch.bmm(rows, q[:, :, None])[:, :, 0]


def ivf_search(query, gallery, centroids, lists, k, nprobe,
               gallery_scale=None, gallery_sqnorm=None):
    """Approximate k nearest gallery rows via the ``nprobe`` nearest cells.

    query (Q, D); gallery (N, D) f32/f16/int8 (int8 with ``gallery_scale``
    (N,)); ``gallery_sqnorm`` (N,) f32, the (dequantized) rows' squared
    norms, gathered instead of recomputed; centroids/lists from build_ivf.
    Runs on the gallery's device. Returns (sq_dists (Q, k) f32, indices
    (Q, k) int64); unfilled slots (fewer than k candidates probed) are
    (inf, -1). The distances are exact squared L2 on the probed subset.

    Each query gathers its OWN nprobe cells, so probe traffic is
    Q * nprobe * maxlen rows; past ~N one shared exact scan is cheaper
    (serving routes on exactly that, serving._ivf_beats_exact).
    """
    g = torch.as_tensor(gallery)
    dev = g.device
    q = torch.as_tensor(query).to(dev, torch.float32)
    c = torch.as_tensor(centroids).to(dev, torch.float32)
    lists = torch.as_tensor(lists).to(dev, torch.int64)
    scale = (None if gallery_scale is None
             else torch.as_tensor(gallery_scale).to(dev, torch.float32))
    sqn = (None if gallery_sqnorm is None
           else torch.as_tensor(gallery_sqnorm).to(dev, torch.float32))
    nprobe = min(nprobe, c.shape[0])
    k = min(k, g.shape[0])
    qn = q.shape[0]

    probe_ids = _probe_cells(q, c, nprobe)
    best_d = torch.full((qn, k), float("inf"), device=dev)
    best_i = torch.full((qn, k), -1, dtype=torch.int64, device=dev)
    for j in range(nprobe):
        ids = lists[probe_ids[:, j]]  # (Q, maxlen)
        d = _candidate_d2(q, g, torch.clamp(ids, min=0), scale, sqn)
        d = torch.where(ids < 0, float("inf"), d)
        # cells partition the gallery: no id appears under two probes
        best_d, best_i = _merge(best_d, best_i, d, ids, k)
    return best_d, best_i
