"""k-reciprocal Jaccard re-ranking (CVPR'17, Zhong et al.), the port of
openibl_tpu/ops/rerank.py, used by evaluation's rerank and by SFRS mining:

  1. squared distances, normalized per row by the row max (the block matrix
     is symmetric, so this is the published column normalization)
  2. per item: the k-reciprocal neighbour set, expanded by the
     half-k-reciprocal sets of its members when they overlap > 2/3
  3. V = exp(-d) over the expansion set, L1-normalized (sparse rows)
  4. optional query expansion (k2 > 1: mean of the top-k2 neighbours' V rows)
  5. Jaccard distance from the sparse min/sum intersection of V rows
  6. final = (1-λ)·jaccard + λ·original

``re_ranking`` (numpy, from three distance matrices), ``_k_reciprocal``,
``_expansion_index``, ``_query_expand`` and ``composite_rank_key`` are the
JAX package's numpy code as it is. The expansion loop and the host Jaccard
intersection run in C++ (csrc/rerank.cpp through ops/_native.py) when it
builds, numpy/scipy otherwise. From descriptors, ``build_v_sparse`` ranks
the q∪g union with ``topk_nearest`` and computes the V weights by a
gather and dot on the features' device; ``JaccardEngine``'s device path is
a ``scatter_add_`` over padded CSC slabs (on a CUDA device its atomics sum
in a varying order: the last bits may differ from run to run, unlike the
host path, which sums each query in CSR order).
"""

import numpy as np
import torch

try:
    import scipy.sparse as sp
except ImportError:  # pragma: no cover
    sp = None

from openibl_tpu_torch.ops import _native
from openibl_tpu_torch.ops.distance import pairwise_sqdist, topk_nearest
from openibl_tpu_torch.utils import f32_precision, resolve_device, to_numpy


def _k_reciprocal(initial_rank, i, k):
    """k-reciprocal neighbors of item i (rank includes self at position 0)."""
    forward = initial_rank[i, : k + 1]
    backward = initial_rank[forward, : k + 1]
    fi = np.nonzero(backward == i)[0]
    return forward[fi]


def _expansion_index(initial_rank, k1):
    """Per-item k-reciprocal expansion sets (step 2). Returns a list of
    index arrays."""
    n = initial_rank.shape[0]
    half = int(np.around(k1 / 2.0))
    out = []
    for i in range(n):
        k_recip = _k_reciprocal(initial_rank, i, k1)
        expansion = k_recip
        for candidate in k_recip:
            cand_recip = _k_reciprocal(initial_rank, candidate, half)
            if len(np.intersect1d(cand_recip, k_recip)) > (2.0 / 3.0) * len(
                cand_recip
            ):
                expansion = np.append(expansion, cand_recip)
        out.append(np.unique(expansion))
    return out


def re_ranking(q_g_dist, q_q_dist, g_g_dist, k1=20, k2=6, lambda_value=0.3,
               initial_rank=None, device="cuda"):
    """Re-ranked (Q, G) distance matrix from the three distance matrices
    (numpy). ``initial_rank``: optional (N, >= max(k1+1, k2)) nearest-
    neighbour indices over the q∪g union. ``device`` serves the Jaccard
    engine's device path, taken only when the host path would be slow."""
    q_g_dist = np.asarray(q_g_dist, np.float32)
    n_q = q_g_dist.shape[0]
    n = n_q + q_g_dist.shape[1]
    # the squared, row-max-normalized block matrix, assembled in place
    original = np.empty((n, n), np.float32)
    original[:n_q, :n_q] = q_q_dist
    original[:n_q, n_q:] = q_g_dist
    original[n_q:, :n_q] = q_g_dist.T
    original[n_q:, n_q:] = g_g_dist
    np.multiply(original, original, out=original)
    rowmax = original.max(axis=1)
    original /= rowmax[:, None]
    query_num = n_q

    # only the top max(k1+1, k2) neighbours of a row are ever consulted:
    # a partial selection, O(N²) instead of a full argsort
    depth = min(max(k1 + 1, k2), n)
    if initial_rank is not None:
        assert initial_rank.shape[0] == n and initial_rank.shape[1] >= depth
        initial_rank = np.ascontiguousarray(initial_rank, np.int32)
    elif depth < n:
        part = np.argpartition(original, depth - 1, axis=1)[:, :depth]
        vals = np.take_along_axis(original, part, axis=1)
        order = np.argsort(vals, axis=1, kind="stable")
        initial_rank = np.take_along_axis(part, order, axis=1).astype(np.int32)
    else:
        initial_rank = np.argsort(original, axis=1).astype(np.int32)

    if _native.available() and initial_rank.shape[1] >= k1 + 1:
        rows, cols, vals = _native.expansion_weights(original, initial_rank, k1)
    else:
        expansion = _expansion_index(initial_rank, k1)
        rows = np.concatenate(
            [np.full(len(e), i, np.int32) for i, e in enumerate(expansion)]
        )
        cols = np.concatenate(expansion).astype(np.int32)
        weights = [np.exp(-original[i, e]) for i, e in enumerate(expansion)]
        vals = np.concatenate([w / w.sum() for w in weights]).astype(np.float32)

    if k2 != 1:
        rows, cols, vals = _query_expand(rows, cols, vals, initial_rank,
                                         k2, n)

    engine = JaccardEngine(np.asarray(rows, np.int32),
                           np.asarray(cols, np.int32),
                           np.asarray(vals, np.float32), n, device=device)
    jaccard = engine.query(np.arange(query_num))

    original_q = original[:query_num]
    final = jaccard * (1 - lambda_value) + original_q * lambda_value
    return final[:, query_num:]


def _pair_d2(u, r_idx, c_idx):
    """Squared distances of (row, col) index pairs of ``u``'s rows: a
    gather and a dot on ``u``'s device."""
    a, b = u[r_idx], u[c_idx]
    return (torch.sum(a * a, dim=1) + torch.sum(b * b, dim=1)
            - 2.0 * torch.sum(a * b, dim=1))


def _query_expand(rows, cols, vals, initial_rank, k2, n):
    """k2 query expansion: V ← mean of each row's k2 nearest rows, on the
    sparse triplet (shared by re_ranking and rerank_ranks_streaming).
    Returns the re-extracted row-major triplet; without scipy it goes
    through a dense (n, n) buffer."""
    if sp is None:
        v_dense = np.zeros((n, n), np.float32)
        v_dense[rows, cols] = vals
        v_dense = np.stack(
            [v_dense[initial_rank[i, :k2]].mean(axis=0) for i in range(n)]
        )
        e_rows, e_cols = (a.astype(np.int32) for a in np.nonzero(v_dense))
        return e_rows, e_cols, np.asarray(v_dense[e_rows, e_cols], np.float32)
    v_mat = sp.csr_matrix((vals, (rows, cols)), shape=(n, n),
                          dtype=np.float32)
    v_new = sp.lil_matrix((n, n), dtype=np.float32)
    for i in range(n):
        v_new[i] = v_mat[initial_rank[i, :k2]].mean(axis=0)
    coo = v_new.tocsr().sorted_indices().tocoo()
    return (coo.row.astype(np.int32), coo.col.astype(np.int32),
            coo.data.astype(np.float32))


def build_v_sparse(u_feats, k1, pair_chunk=1 << 16, depth=None):
    """The k-reciprocal V rows straight from descriptors, no N x N matrix.

    ``u_feats`` (N, D): a tensor (used on its device) or a numpy array (on
    the CPU). The ranking and each row's largest distance come from
    ``topk_nearest`` over the union; the expansion sets from that partial
    ranking (C++ or numpy); the exp(-d) weights from sparse pair distances
    recomputed from the features (f32, TF32 off). Returns (rows, cols,
    vals, initial_rank, rm2): the row-major V triplet (numpy), the (N,
    depth) ranking and the squared row maxima that normalize distances.
    """
    u = torch.as_tensor(u_feats).float()
    n = len(u)
    depth = min(depth or (k1 + 1), n)
    with f32_precision():
        _, initial_rank, rowmax = topk_nearest(u, u, k=depth,
                                               return_rowmax=True)
    initial_rank = to_numpy(initial_rank).astype(np.int32)
    rm2 = np.maximum(np.square(to_numpy(rowmax).astype(np.float32)), 1e-12)

    # a union smaller than k1+1 (toy galleries) takes the numpy path, whose
    # clamped slices reproduce a full ranking
    if _native.available() and initial_rank.shape[1] >= k1 + 1:
        rows, cols = _native.expansion_sets(initial_rank, k1)
    else:
        expansion = _expansion_index(initial_rank, k1)
        rows = np.concatenate(
            [np.full(len(e), i, np.int32) for i, e in enumerate(expansion)])
        cols = np.concatenate(expansion).astype(np.int32)
    d2_pairs = np.empty(len(rows), np.float32)
    for s in range(0, len(rows), pair_chunk):
        r = torch.from_numpy(rows[s:s + pair_chunk].astype(np.int64))
        c = torch.from_numpy(cols[s:s + pair_chunk].astype(np.int64))
        d2_pairs[s:s + len(r)] = to_numpy(
            _pair_d2(u, r.to(u.device), c.to(u.device)))
    vals = np.exp(-np.maximum(d2_pairs, 0.0) ** 2 / rm2[rows])
    # L1-normalize per row: rows are row-major and none is empty (an item
    # is always its own k-reciprocal neighbour)
    row_starts = np.searchsorted(rows, np.arange(n))
    sums = np.add.reduceat(vals, row_starts)
    vals = (vals / sums[rows]).astype(np.float32)
    return rows, cols, vals, initial_rank, rm2


def _pad_pow2(x, lo=8):
    p = lo
    while p < x:
        p *= 2
    return p


# above this per-column occupancy the padded device tables waste more than
# they gain: the host path takes over
_MAX_COL_OCCUPANCY = 4096
_DEVICE_TABLE_BUDGET_BYTES = 4 * 1024**3


class JaccardEngine:
    """Jaccard distances from sparse V rows, with reusable structure.

    * **host**: the C++ kernel (threaded over queries, each query summed in
      CSR order) when built, else a scipy CSR loop. V has ~1.5·k1 nonzeros
      a row, so a query touches a few thousand elements.
    * **device**: ``scatter_add_`` on ``device`` over power-of-two-padded
      CSC slabs; its fixed costs pay off at large query counts, or where
      no host path exists.

    ``query(prefer="auto")`` routes by the estimated host work, with the
    JAX package's budgets. Each layout is built once and reused across
    ``query`` calls.
    """

    def __init__(self, rows, cols, vals, n, device="cuda"):
        order = np.argsort(rows, kind="stable")  # row-major (already, but safe)
        self.rows = rows[order]
        self.cols = cols[order]
        self.vals = vals[order]
        self.n = n
        self.device = device
        self._host = None  # (v_csr, v_csc) scipy
        self._nat = None  # CSR/CSC plain arrays for the C++ kernel
        self._dev = None  # (csc_rows, csc_vals) tensors, or "host"
        self._row_starts = None
        self.last_engine = None  # "native", "scipy" or "device"

    # -- host engines ------------------------------------------------------
    @property
    def _host_available(self):
        return sp is not None or _native.available()

    def _query_host(self, query_rows):
        if _native.available():
            return self._query_native(query_rows)
        return self._query_scipy(query_rows)

    def _native_structs(self):
        if self._nat is None:
            n = self.n
            csr_indptr = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(self.rows, minlength=n), out=csr_indptr[1:])
            corder = np.argsort(self.cols, kind="stable")
            csc_indptr = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(self.cols, minlength=n), out=csc_indptr[1:])
            self._nat = (
                csr_indptr, self.cols, self.vals,
                csc_indptr,
                np.ascontiguousarray(self.rows[corder]),
                np.ascontiguousarray(self.vals[corder]),
            )
        return self._nat

    def _query_native(self, query_rows):
        self.last_engine = "native"
        ri, rc, rv, ci, cr, cv = self._native_structs()
        return _native.jaccard_queries(ri, rc, rv, ci, cr, cv, self.n,
                                       query_rows)

    def _host_structs(self):
        if self._host is None:
            v_csr = sp.csr_matrix(
                (self.vals, (self.rows, self.cols)),
                shape=(self.n, self.n), dtype=np.float32,
            )
            self._host = (v_csr, v_csr.T.tocsr())
        return self._host

    def _query_scipy(self, query_rows):
        self.last_engine = "scipy"
        v_csr, v_csc = self._host_structs()
        n = self.n
        out = np.empty((len(query_rows), n), np.float32)
        for out_i, i in enumerate(query_rows):
            row = v_csr.getrow(i)
            temp_min = np.zeros(n, np.float32)
            for j, vij in zip(row.indices, row.data):
                colj = v_csc.getrow(j)
                temp_min[colj.indices] += np.minimum(vij, colj.data)
            out[out_i] = 1.0 - temp_min / (2.0 - temp_min)
        return out

    # -- device engine -----------------------------------------------------
    def _device_structs(self):
        """The padded CSC slabs on the device, built once. None when the
        column occupancy is degenerate (hub items would blow the padded
        tables past any gain) and a host path can take over."""
        if self._dev is None:
            ccounts = np.bincount(self.cols, minlength=self.n)
            p = _pad_pow2(int(ccounts.max()) if len(self.cols) else 1)
            table_bytes = self.n * p * 8  # int32 rows + f32 vals
            oversized = (p > _MAX_COL_OCCUPANCY
                         or table_bytes > _DEVICE_TABLE_BUDGET_BYTES)
            if oversized and self._host_available:
                self._dev = "host"
            elif table_bytes > _DEVICE_TABLE_BUDGET_BYTES:
                raise MemoryError(
                    f"degenerate V-column occupancy (padded width {p}) "
                    f"makes the padded device Jaccard tables "
                    f"~{table_bytes / 1e9:.1f} GB and no sparse host "
                    "fallback is available (scipy missing, native kernel "
                    "unbuilt); install scipy, build csrc/rerank.cpp, or "
                    "reduce k1"
                )
            else:
                dev = resolve_device(self.device)
                corder = np.argsort(self.cols, kind="stable")
                cstarts = np.concatenate([[0], np.cumsum(ccounts)])
                csc_rows = np.full((self.n, p), -1, np.int64)
                csc_vals = np.zeros((self.n, p), np.float32)
                pos = np.arange(len(self.cols)) - cstarts[self.cols[corder]]
                csc_rows[self.cols[corder], pos] = self.rows[corder]
                csc_vals[self.cols[corder], pos] = self.vals[corder]
                self._dev = (torch.from_numpy(csc_rows).to(dev),
                             torch.from_numpy(csc_vals).to(dev))
        return None if isinstance(self._dev, str) else self._dev

    def _query_device(self, query_rows, query_chunk):
        structs = self._device_structs()
        if structs is None:  # degenerate occupancy, host path available
            return self._query_host(query_rows)
        self.last_engine = "device"
        csc_rows, csc_vals = structs
        dev = csc_rows.device
        n = self.n
        if self._row_starts is None:
            counts = np.bincount(self.rows, minlength=n)
            self._row_starts = np.concatenate([[0], np.cumsum(counts)])
        starts = self._row_starts
        m = _pad_pow2(
            int((starts[query_rows + 1] - starts[query_rows]).max())
            if len(query_rows) else 1
        )
        q_cols = np.full((len(query_rows), m), -1, np.int64)
        q_vals = np.zeros((len(query_rows), m), np.float32)
        for out_i, r in enumerate(query_rows):
            s, e = starts[r], starts[r + 1]
            q_cols[out_i, : e - s] = self.cols[s:e]
            q_vals[out_i, : e - s] = self.vals[s:e]

        out = np.empty((len(query_rows), n), np.float32)
        for s in range(0, len(query_rows), query_chunk):
            qc = torch.from_numpy(q_cols[s:s + query_chunk]).to(dev)
            qv = torch.from_numpy(q_vals[s:s + query_chunk]).to(dev)
            b = qc.shape[0]
            rows_g = csc_rows[qc.clamp(min=0)]  # (B, M, P)
            contrib = torch.minimum(qv[:, :, None], csc_vals[qc.clamp(min=0)])
            valid = (qc[:, :, None] >= 0) & (rows_g >= 0)
            contrib = torch.where(valid, contrib, 0.0)
            rows_safe = torch.where(valid, rows_g, 0)
            t = torch.zeros((b, n), dtype=torch.float32, device=dev)
            t.scatter_add_(1, rows_safe.reshape(b, -1), contrib.reshape(b, -1))
            out[s:s + b] = to_numpy(1.0 - t / (2.0 - t))
        return out

    def query(self, query_rows, query_chunk=512, prefer="auto",
              total_queries=None):
        """(len(query_rows), n) Jaccard distances. ``prefer`` = "auto" |
        "host" | "device": auto routes by the estimated host work per query
        (the sparse scatter-adds, ~avg row nnz squared, plus the O(n) dense
        accumulator), over the whole sweep when the caller passes
        ``total_queries``. The host budget is 1e10 with the C++ kernel,
        5e8 with scipy. ``last_engine`` says which engine ran."""
        if prefer not in ("auto", "host", "device"):
            raise ValueError(f"prefer={prefer!r}")
        query_rows = np.asarray(query_rows, np.int64)
        if prefer == "host" and not self._host_available:
            raise ImportError(
                "prefer='host' Jaccard requires scipy or the native kernel"
            )
        if self._host_available and prefer != "device":
            avg_row = len(self.vals) / max(self.n, 1)
            n_sweep = total_queries if total_queries else len(query_rows)
            est_host_vec_ops = n_sweep * (avg_row * avg_row + self.n)
            budget = 1e10 if _native.available() else 5e8
            if prefer == "host" or est_host_vec_ops < budget:
                return self._query_host(query_rows)
        return self._query_device(query_rows, query_chunk)


def jaccard_for_queries(rows, cols, vals, n, query_rows, query_chunk=512,
                        prefer="auto", device="cuda"):
    """One-shot wrapper over :class:`JaccardEngine` (see its docstring)."""
    return JaccardEngine(rows, cols, vals, n, device=device).query(
        query_rows, query_chunk=query_chunk, prefer=prefer
    )


def composite_rank_key(final, orig):
    """float64 ranking key: final (Jaccard-mixed) distance first, original
    feature distance as tie-break.

    The tie-break term for each element is scaled to 1e-3 of the f32 spacing
    at that element's own magnitude. Two *distinct* f32 finals a < b satisfy
    b - a >= spacing(a), while a's perturbation stays < spacing(a) * 1e-3 —
    so genuine final-distance differences dominate at every magnitude.
    Exactly-tied finals (the zero-overlap Jaccard tail at 1.0) share a scale
    and are ordered by the feature-distance fraction. Used by both the
    streaming and the materialized rerank paths so results agree on either
    side of the memory threshold.
    """
    frac = (orig / (orig.max() + 1.0)).astype(np.float64)
    scale = np.spacing(
        np.maximum(np.abs(final), 1e-30).astype(np.float32)
    ).astype(np.float64) * 1e-3
    return final.astype(np.float64) + frac * scale


def rerank_ranks_streaming(q_feats, g_feats, k1=25, k2=1, lambda_value=0.0,
                           k_out=None, pair_chunk=1 << 16, query_chunk=1024):
    """k-reciprocal re-ranking where no N x N matrix fits: the math of
    ``re_ranking`` computed from the descriptors (tensors, used on their
    device, or numpy arrays, on the CPU), keeping each query's best
    ``k_out`` gallery entries. Exact ties of the final distance (the
    zero-overlap Jaccard tail at 1.0) are broken by the original feature
    distance (``composite_rank_key``).

    Returns (indices (Q, k_out) int64 into the gallery, final dists (Q,
    k_out)) as numpy arrays.
    """
    q = torch.as_tensor(q_feats).float()
    g = torch.as_tensor(g_feats).float().to(q.device)
    n_q, n = len(q), len(q) + len(g)
    if k_out is None:
        k_out = min(len(g), 10 * 12)
    k_out = min(k_out, len(g))
    u = torch.cat([q, g])

    rows, cols, vals, initial_rank, rm2 = build_v_sparse(
        u, k1, pair_chunk=pair_chunk, depth=max(k1 + 1, k2)
    )

    if k2 != 1:
        if sp is None:
            raise ImportError(
                "rerank_ranks_streaming with k2 != 1 (query expansion) "
                "requires scipy; the reference call sites use k2=1"
            )
        rows, cols, vals = _query_expand(rows, cols, vals, initial_rank,
                                         k2, n)

    engine = JaccardEngine(rows, cols, vals, n, device=u.device)
    out_idx = np.empty((n_q, k_out), np.int64)
    out_dist = np.empty((n_q, k_out), np.float32)
    for s in range(0, n_q, query_chunk):
        e = min(s + query_chunk, n_q)
        final = engine.query(np.arange(s, e), total_queries=n_q)
        with f32_precision():
            d2_chunk = to_numpy(pairwise_sqdist(q[s:e], u)).astype(np.float32)
        orig_chunk = np.square(np.maximum(d2_chunk, 0.0)) / rm2[s:e, None]
        if lambda_value != 0:
            final = final * (1 - lambda_value) + orig_chunk * lambda_value
        final_g = final[:, n_q:]
        key = composite_rank_key(final_g, orig_chunk[:, n_q:])
        part = np.argpartition(key, k_out - 1, axis=1)[:, :k_out]
        pkeys = np.take_along_axis(key, part, axis=1)
        order = np.argsort(pkeys, axis=1, kind="stable")
        out_idx[s:e] = np.take_along_axis(part, order, axis=1)
        out_dist[s:e] = np.take_along_axis(
            np.take_along_axis(final_g, part, axis=1), order, axis=1
        )
    return out_idx, out_dist
