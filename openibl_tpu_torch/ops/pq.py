"""Product-quantized (PQ) descriptor index with ADC search (port of
openibl_tpu/ops/pq.py).

Each D-dim descriptor splits into ``m`` subvectors, each stored as one uint8
codebook id: m bytes per descriptor, 256x smaller than f32 at D=4096, m=64.
Search is ADC (asymmetric distance): queries stay f32, and a distance is a
sum of per-subspace lookup-table entries, so only the gallery side is
quantized (Jegou et al., "Product quantization for nearest neighbor
search", TPAMI 2011). Around it:

  * codebook training runs all m subspace k-means as one batched Lloyd
    program (the subspace axis leads every bmm), with the assignment pass
    tiled over rows so the (m, tile, ksub) distance block stays bounded;
  * ``pq_search`` scores code tiles with kernel K2 (ops/pq_kernel.py) on a
    CUDA device and with its plain version on the CPU, and merges a running
    top-k with ``torch.topk``;
  * OPQ (``train_opq``) learns an orthogonal rotation jointly with the
    codebooks (Ge et al., CVPR 2013); every search takes ``rotation=``;
  * IVFADC (``build_ivfpq`` / ``ivfpq_search``) encodes residuals to IVF
    cells and probes nprobe cells, scoring each cell's codes with a plain
    gather (as the JAX package leaves it to XLA's take_along_axis);
  * ``pq_search_rerank`` re-ranks an ADC shortlist by exact distance;
  * ``pq_search_sharded`` splits the codes over the ranks of a mesh
    (parallel.mesh): each rank scores its rows through ``pq_search`` and
    one all-gather merges the candidates, the padded rows masked.

Build functions return numpy arrays (the arrays an index .npz carries);
they accept numpy (run on the CPU) or tensors (run on their device). Search
functions run on the codes' device and return tensors. The random draws of
k-means++ come from a ``torch.Generator``: they cannot reproduce
``jax.random``'s bits, so trained codebooks differ from the JAX package's
for one seed while meeting the same quality gates. Products are f32 (the
JAX package's ``Precision.HIGHEST``), with TF32 off as PyTorch's default.
"""

import numpy as np
import torch

from openibl_tpu_torch.ops.distance import merge_across_ranks
from openibl_tpu_torch.ops.ivf import (
    _candidate_d2, _merge, _probe_cells, build_ivf)
from openibl_tpu_torch.ops.pq_kernel import adc_tile

# budget for one pq_search tile: its (Q, tile) f32 distances and ~2 more of
# that size in the top-k
_ADC_TILE_BYTES = 256 * 1024**2


def _as_f32(x, device=None):
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def _split_subspaces(x, m):
    """(N, D) -> (m, N, dsub) with the subspace axis leading."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"feature dim {d} not divisible by m={m}")
    return x.reshape(n, m, d // m).permute(1, 0, 2)


def _sub_d2(tiles, centers):
    """Squared L2 (m, T, k) between (m, T, dsub) rows and (m, k, dsub)
    centers, batched over the subspace axis."""
    t2 = torch.sum(torch.square(tiles), dim=2)[:, :, None]
    c2 = torch.sum(torch.square(centers), dim=2)[:, None, :]
    return t2 + c2 - 2.0 * torch.bmm(tiles, centers.transpose(1, 2))


def _pp_init_batched(generator, xm, ksub):
    """k-means++ seeding for all m subspace quantizers at once.

    xm (m, N, dsub) -> (m, ksub, dsub) f32 initial centers. Each step draws
    one center per subspace in proportion to D² (``torch.multinomial`` from
    ``generator``, on xm's device) and relaxes the running min-distance.
    Subspaces whose D² is all zero (duplicate-heavy) draw uniformly."""
    m, n, _ = xm.shape
    sub = torch.arange(m, device=xm.device)

    def pick(idx):
        return xm[sub, idx]  # (m, dsub)

    first = pick(torch.randint(0, n, (m,), generator=generator,
                               device=xm.device))
    d2 = torch.sum(torch.square(xm - first[:, None, :]), dim=2)  # (m, N)
    centers = [first]
    for _ in range(ksub - 1):
        total = torch.sum(d2, dim=1, keepdim=True)
        w = torch.where(total > 0, d2, torch.ones_like(d2))
        c = pick(torch.multinomial(w, 1, generator=generator)[:, 0])
        d2 = torch.minimum(d2, torch.sum(torch.square(xm - c[:, None, :]),
                                         dim=2))
        centers.append(c)
    return torch.stack(centers, dim=1)


def _lloyd_batched(xm, centers, iters, chunk):
    """Lloyd iterations for all m subspace quantizers at once.

    xm (m, N, dsub), centers (m, k, dsub). The assignment pass walks row
    tiles of ``chunk``, accumulating per-cluster sums/counts, so the
    (m, chunk, k) distance block is the peak transient. Empty clusters keep
    their previous center."""
    m, n, d = xm.shape
    k = centers.shape[1]
    for _ in range(iters):
        sums = torch.zeros((m, k, d), dtype=torch.float32, device=xm.device)
        counts = torch.zeros((m, k), dtype=torch.float32, device=xm.device)
        for s in range(0, n, chunk):
            tile = xm[:, s:s + chunk]
            a = torch.argmin(_sub_d2(tile, centers), dim=2)  # (m, T)
            oh = torch.nn.functional.one_hot(a, k).to(torch.float32)
            sums += torch.bmm(oh.transpose(1, 2), tile)
            counts += oh.sum(dim=1)
        new = sums / torch.clamp(counts, min=1.0)[:, :, None]
        centers = torch.where(counts[:, :, None] > 0, new, centers)
    return centers


def _subsample(descriptors, train_size, seed):
    """Shared train-set draw: host-drawn sorted indices gathered on the
    data's device. Returns (x, the RandomState for later draws)."""
    x = _as_f32(descriptors)
    n = x.shape[0]
    rs = np.random.RandomState(seed)
    if n > train_size:
        sel = np.sort(rs.choice(n, train_size, False))
        x = x[torch.as_tensor(sel, device=x.device)]
    return x, rs


def _procrustes(x, y):
    """Orthogonal R minimizing ||x @ R - y||_F: R = U Vᵀ of the SVD of xᵀy.

    On CUDA the SVD takes cuSOLVER's QR-based ``gesvd``: PyTorch's default
    there is the Jacobi ``gesvdj``, whose factors left R measurably
    non-orthogonal (|R Rᵀ - I| > 1e-3) at D=4096 on an H100."""
    driver = "gesvd" if x.is_cuda else None
    u, _, vt = torch.linalg.svd(torch.matmul(x.T, y), full_matrices=False,
                                driver=driver)
    return torch.matmul(u, vt)


def _decode_dev(codebooks, codes, m):
    """(N, m) codes -> (N, D) reconstructions, on the codes' device."""
    sub = torch.arange(m, device=codes.device)[None, :]
    return codebooks[sub, codes.long()].reshape(codes.shape[0], -1)


def _seeded_init(xm, ksub, rs):
    """++ seeding from a generator seeded by the next RandomState draw (the
    JAX package's PRNGKey takes the same draw); fewer rows than centers pad
    by repeating (rare, tests)."""
    n = xm.shape[1]
    gen = torch.Generator(device=xm.device)
    gen.manual_seed(int(rs.randint(2**31 - 1)))
    init = _pp_init_batched(gen, xm, min(ksub, n))
    if ksub > n:
        reps = -(-ksub // n)
        init = init.repeat(1, reps, 1)[:, :ksub]
    return init


def _check_pq_args(d, m, ksub):
    if d % m:
        raise ValueError(f"feature dim {d} not divisible by m={m}")
    if ksub > 256:
        raise ValueError(f"ksub={ksub} > 256 does not fit uint8 codes")


def _train_opq(descriptors, m, ksub, iters, opq_iters, seed, train_size,
               chunk, inner_iters):
    """train_opq on tensors: (rotation (D, D), codebooks) on x's device."""
    x, rs = _subsample(descriptors, train_size, seed)
    n, d = x.shape
    _check_pq_args(d, m, ksub)
    chunk = int(min(chunk, n))
    xm = _split_subspaces(x, m)
    cb = _lloyd_batched(xm, _seeded_init(xm, ksub, rs), inner_iters, chunk)
    rot = torch.eye(d, dtype=torch.float32, device=x.device)
    for _ in range(opq_iters):
        codes = _encode(xm, cb, chunk)
        y = _decode_dev(cb, codes, m)  # reconstructions in ROTATED space
        rot = _procrustes(x, y)
        xm = _split_subspaces(torch.matmul(x, rot), m)
        cb = _lloyd_batched(xm, cb, inner_iters, chunk)
    cb = _lloyd_batched(xm, cb, max(iters - inner_iters, 0), chunk)
    return rot, cb


def train_opq(descriptors, m=64, ksub=256, iters=25, opq_iters=8, seed=0,
              train_size=65536, chunk=4096, inner_iters=2):
    """OPQ: an orthogonal D×D rotation learned jointly with the codebooks
    (Ge et al., "Optimized Product Quantization", CVPR 2013, OPQ_NP).

    Alternates Lloyd updates of the codebooks on the rotated data with the
    closed-form orthogonal-Procrustes solve R = U Vᵀ of
    svd(Xᵀ·decode(encode(X·R))); the D×D SVD is the cost at D=4096.
    Returns numpy (rotation (D, D) f32, codebooks (m, ksub, dsub) f32);
    encode with ``encode_pq(cb, x @ R)``, search with ``rotation=R``.
    """
    rot, cb = _train_opq(descriptors, m, ksub, iters, opq_iters, seed,
                         train_size, chunk, inner_iters)
    return rot.cpu().numpy(), cb.cpu().numpy()


def train_pq(descriptors, m=64, ksub=256, iters=25, seed=0,
             train_size=65536, chunk=4096):
    """Train per-subspace codebooks. Returns (m, ksub, dsub) f32 numpy.

    Seeding is batched k-means++ (clustered descriptor data punishes a
    random-row init: Lloyd cannot move centers across empty space).
    ``train_size`` caps the Lloyd input. ``descriptors`` may be a device
    tensor: the subsample is a device gather of host-drawn indices."""
    x, rs = _subsample(descriptors, train_size, seed)
    n, d = x.shape
    _check_pq_args(d, m, ksub)
    xm = _split_subspaces(x, m)
    cb = _lloyd_batched(xm, _seeded_init(xm, ksub, rs), iters,
                        int(min(chunk, n)))
    return cb.cpu().numpy()


def _encode(xm, codebooks, chunk):
    """(m, N, dsub) rows -> (N, m) uint8 codes of the nearest codewords."""
    n = xm.shape[1]
    out = torch.empty((n, xm.shape[0]), dtype=torch.uint8, device=xm.device)
    for s in range(0, n, chunk):
        a = torch.argmin(_sub_d2(xm[:, s:s + chunk], codebooks), dim=2)
        out[s:s + chunk] = a.T.to(torch.uint8)
    return out


def encode_pq(codebooks, descriptors, chunk=4096):
    """Quantize (N, D) descriptors to (N, m) uint8 numpy codes (on the
    descriptors' device; only the codes come back)."""
    x = _as_f32(descriptors)
    cb = _as_f32(codebooks, x.device)
    xm = _split_subspaces(x, cb.shape[0])
    return _encode(xm, cb, int(min(chunk, max(x.shape[0], 1)))).cpu().numpy()


def decode_pq(codebooks, codes):
    """Reconstruct (N, D) f32 descriptors from codes (numpy)."""
    cb = np.asarray(codebooks, np.float32)  # (m, k, dsub)
    codes = np.asarray(codes)
    n, m = codes.shape
    out = cb[np.arange(m)[None, :], codes.astype(np.int64)]  # (N, m, dsub)
    return out.reshape(n, m * cb.shape[2])


def build_pq(descriptors, m=64, ksub=256, iters=25, seed=0,
             train_size=65536, opq_iters=0):
    """Train + encode in one call.

    Returns dict {"pq_codebooks": (m, ksub, dsub) f32, "pq_codes": (N, m)
    uint8}, numpy. ``opq_iters > 0`` trains an OPQ rotation first and adds
    "pq_rotation" (D, D) f32; the codes then encode the ROTATED
    descriptors, so searches must pass ``rotation=``.
    """
    if opq_iters:
        rot, cb = _train_opq(descriptors, m, ksub, iters, opq_iters, seed,
                             train_size, 4096, 2)
        x = _as_f32(descriptors, rot.device)
        return {"pq_codebooks": cb.cpu().numpy(),
                "pq_codes": encode_pq(cb, torch.matmul(x, rot)),
                "pq_rotation": rot.cpu().numpy()}
    cb = train_pq(descriptors, m=m, ksub=ksub, iters=iters, seed=seed,
                  train_size=train_size)
    return {"pq_codebooks": cb, "pq_codes": encode_pq(cb, descriptors)}


def pq_search_rerank(query, codes, codebooks, gallery, k, shortlist=None,
                     chunk=None, gallery_scale=None, gallery_sqnorm=None,
                     rotation=None):
    """ADC shortlist + exact re-rank: exact-quality top-k at code-scan cost.

    The ADC pass (pq_search) ranks ALL N codes; the top ``shortlist``
    (default 8k, clamped to N) candidates gather their full-width gallery
    rows (f32/f16/int8 with ``gallery_scale``) and re-rank by exact squared
    L2 (``gallery_sqnorm`` gathered when given). ``rotation`` applies to the
    ADC pass only: the re-rank scores the unrotated rows and query.

    Returns (exact sq_dists (Q, k), indices (Q, k) int64).
    """
    g = torch.as_tensor(gallery)
    dev = g.device
    q = _as_f32(query, dev)
    n = g.shape[0]
    k = min(k, n)
    if shortlist is None:
        shortlist = 8 * k
    shortlist = min(max(shortlist, k), n)
    _, cand = pq_search(q, codes, codebooks, k=shortlist, chunk=chunk,
                        rotation=rotation)
    cand = cand.to(dev)
    scale = (None if gallery_scale is None
             else _as_f32(gallery_scale, dev))
    sqnorm = (None if gallery_sqnorm is None
              else _as_f32(gallery_sqnorm, dev))
    d = _candidate_d2(q, g, cand, scale, sqnorm)  # (Q, S)
    d, pos = torch.topk(d, k, dim=1, largest=False, sorted=True)
    return d, torch.gather(cand, 1, pos)


def build_ivfpq(descriptors, nlist=None, m=64, ksub=256, iters=25, seed=0,
                train_size=65536, maxlen=None, opq_iters=0):
    """IVFADC: coarse IVF cells + PQ-encoded RESIDUALS (Jegou et al. 2011
    §IV, FAISS's IndexIVFPQ).

    Returns dict {"ivf_centroids", "ivf_lists", "ivfpq_codebooks",
    "ivfpq_codes"}, numpy: the cells/lists are exactly build_ivf's, the
    codes (N, m) uint8 of (x - centroid[cell(x)]). ``opq_iters > 0`` learns
    the OPQ rotation on the residuals and adds "ivfpq_rotation"; searches
    must then pass it.
    """
    x = _as_f32(descriptors)
    ivf = build_ivf(x, nlist=nlist, maxlen=maxlen, seed=seed,
                    train_size=train_size)
    lists = ivf["lists"]
    # invert lists -> per-row cell id (every row appears exactly once)
    cell_of = np.empty(x.shape[0], np.int64)
    valid = lists >= 0
    cell_of[lists[valid]] = np.nonzero(valid)[0]  # row of lists = cell id
    centroids = torch.from_numpy(ivf["centroids"]).to(x.device)
    residuals = x - centroids[torch.from_numpy(cell_of).to(x.device)]
    out = {"ivf_centroids": ivf["centroids"], "ivf_lists": lists}
    if opq_iters:
        rot, cb = _train_opq(residuals, m, ksub, iters, opq_iters, seed,
                             train_size, 4096, 2)
        residuals = torch.matmul(residuals, rot)
        out["ivfpq_rotation"] = rot.cpu().numpy()
        cb = cb.cpu().numpy()
    else:
        cb = train_pq(residuals, m=m, ksub=ksub, iters=iters, seed=seed,
                      train_size=train_size)
    out["ivfpq_codebooks"] = cb
    out["ivfpq_codes"] = encode_pq(cb, residuals)
    return out


def ivfpq_search(query, codes, codebooks, centroids, lists, k, nprobe,
                 rotation=None):
    """Approximate k-NN over residual-PQ codes via the nprobe nearest cells.

    query (Q, D); codes (N, m) uint8 residual codes, codebooks
    (m, ksub, dsub), centroids (nlist, D), lists (nlist, maxlen) from
    build_ivfpq. Runs on the codes' device. Returns (adc_sq_dists (Q, k),
    indices (Q, k) int64); unfilled slots are (inf, -1). Per probe rank the
    LUT is rebuilt in the probed cell's residual frame and the cell's codes
    score by a gather from it (a cell is too small a candidate set for K2).
    """
    codes = torch.as_tensor(codes)
    dev = codes.device
    q = _as_f32(query, dev)
    cb = _as_f32(codebooks, dev)
    c = _as_f32(centroids, dev)
    lists = torch.as_tensor(lists).to(dev, torch.int64)
    rot = None if rotation is None else _as_f32(rotation, dev)
    m = cb.shape[0]
    nprobe = min(nprobe, c.shape[0])
    k = min(k, codes.shape[0])
    qn = q.shape[0]

    probe_ids = _probe_cells(q, c, nprobe)
    best_d = torch.full((qn, k), float("inf"), device=dev)
    best_i = torch.full((qn, k), -1, dtype=torch.int64, device=dev)
    for j in range(nprobe):
        cid = probe_ids[:, j]  # (Q,)
        r = q - c[cid]  # (Q, D) residual frame
        if rot is not None:  # OPQ residuals: LUT in the codes' rotated frame
            r = torch.matmul(r, rot)
        lut = _sub_d2(_split_subspaces(r, m), cb).permute(1, 0, 2)  # (Q,m,k)
        ids = lists[cid]  # (Q, maxlen)
        safe = torch.clamp(ids, min=0)
        ctile = codes[safe.reshape(-1)].long().reshape(qn, -1, m)
        d = torch.gather(lut, 2, ctile.transpose(1, 2)).sum(dim=1)
        d = torch.where(ids < 0, float("inf"), d)
        kk = min(k, d.shape[1])
        d, pos = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        best_d, best_i = _merge(best_d, best_i, d,
                                torch.gather(ids, 1, pos), k)
    return best_d, best_i


def _auto_chunk(n, q_rows):
    rows = _ADC_TILE_BYTES // (3 * 4 * max(int(q_rows), 1))
    return int(min(max(rows, 4096), max(n, 1)))


def pq_search(query, codes, codebooks, k, chunk=None, precise=False,
              rotation=None):
    """Exhaustive-ADC k nearest codes per query row.

    query (Q, D); codes (N, m) uint8; codebooks (m, ksub, dsub) f32. Runs on
    the codes' device. Returns (sq_dists (Q, k) f32, indices (Q, k) int64):
    the ADC approximations ||q - decode(code)||² = Σ_j ||q_j -
    cb_j[code_j]||², ranked over ALL N codes. ``rotation``: the OPQ matrix
    of build_pq(opq_iters=...), applied to the query so ADC runs in the
    codes' rotated frame; the distances stay original-space.

    The LUT (m, Q, ksub) is ``_sub_d2`` in f32; each tile of ``chunk`` code
    rows is scored by ``pq_kernel.adc_tile`` (K2 on CUDA, its plain version
    on the CPU) and merged into a running top-k. ``chunk=None`` sizes tiles
    by a ~256 MB budget for the (Q, tile) distances. ``precise=False``
    (default) rounds the LUT entries to bf16 and sums in f32, as the JAX
    package's default does (~0.4% relative per entry, below PQ's own
    quantization error); ``precise=True`` keeps them f32.
    """
    codes = torch.as_tensor(codes).contiguous()
    dev = codes.device
    q = _as_f32(query, dev)
    if rotation is not None:
        q = torch.matmul(q, _as_f32(rotation, dev))
    cb = _as_f32(codebooks, dev)
    m = cb.shape[0]
    n = codes.shape[0]
    k = int(min(k, n))
    if chunk is None:
        chunk = _auto_chunk(n, q.shape[0])
    lut = _sub_d2(_split_subspaces(q, m), cb).contiguous()  # (m, Q, ksub)
    best_d = best_i = None
    for s in range(0, n, chunk):
        d = adc_tile(lut, codes[s:s + chunk], precise=precise)  # (Q, T)
        td, ti = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False,
                            sorted=True)
        ti = ti + s
        if best_d is not None:
            td, ti = _merge(best_d, best_i, td, ti, k)
        best_d, best_i = td, ti
    return best_d, best_i


def pq_search_sharded(query, codes, codebooks, mesh, k, chunk=None,
                      precise=False, rotation=None, total=None):
    """Exhaustive-ADC k-NN with the code matrix split over the ranks of
    ``mesh`` (parallel.mesh.Mesh): the tier above one card's codes.

    ``query`` (Q, D) is the same on every rank; the OPQ ``rotation`` is
    applied to it once, then each rank runs ``pq_search`` (K2 on a CUDA
    device) over its ceil(N/n) rows for ``min(k + pad, per)`` candidates,
    makes their ids global and masks the zero-padded rows to (+inf, -1)
    by global index before ``merge_across_ranks``: zero codes decode to
    real codebook entries, so a padded row could otherwise win.

    ``codes`` is either the whole (N, m) uint8 matrix (numpy or a tensor,
    the same on every rank: each rank moves its rows to ``mesh.device``,
    zero-padded to ceil(N/n)), or, with ``total=N``, this rank's resident
    shard: rows [r·per, (r+1)·per) of the whole, zero-padded past N, on
    its device. Returns (adc sq_dists (Q, k), global indices (Q, k)) on
    ``mesh.device``, the same on every rank.
    """
    if total is None:
        n = codes.shape[0]
        per = -(-n // mesh.size)
        shard = torch.as_tensor(
            codes[mesh.rank * per:(mesh.rank + 1) * per]).to(mesh.device)
        if shard.shape[0] < per:
            shard = torch.cat([shard, shard.new_zeros(
                (per - shard.shape[0], shard.shape[1]))])
    else:
        n, shard = int(total), torch.as_tensor(codes)
        per = shard.shape[0]
        if per * mesh.size < n:
            raise ValueError(f"{mesh.size} shards of {per} rows cannot "
                             f"hold {n} codes")
    pad = per * mesh.size - n
    k = int(min(k, n))
    q = _as_f32(query, shard.device)
    if rotation is not None:
        q = torch.matmul(q, _as_f32(rotation, shard.device))
    d, idx = pq_search(q, shard, codebooks, k=min(k + pad, per),
                       chunk=None if chunk is None else min(chunk, per),
                       precise=precise)
    gidx = idx + mesh.rank * per
    fake = gidx >= n
    d = torch.where(fake, float("inf"), d)
    gidx = torch.where(fake, -1, gidx)
    return merge_across_ranks(mesh, d, gidx, k)
