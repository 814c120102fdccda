"""The PQ index of the PyTorch port (PQ, OPQ, IVFADC, the PQ re-rank and
K2's plain version) against the JAX package and a float ADC oracle.

Inputs come from numpy seeds and go to both packages; the JAX side runs its
default XLA formulation (``kernel=False``) and, for K2, its Pallas kernel in
interpret mode, with ``OPENIBL_PQ_KERNEL`` unset. Tolerances:
  * rtol/atol 1e-5 between the packages and against the float64 oracle:
    both sum f32 LUT entries (~1e-1 here) built by f32 products in another
    order;
  * ties: PQ codes can repeat, so equal ADC distances are common and
    ``torch.topk`` and ``lax.top_k`` may order tied ids differently. Ids are
    compared up to ties (``_assert_same_up_to_ties``) or held to the oracle
    (``_assert_valid_topk``): the returned distances are the oracle's at
    the returned ids and no other row is nearer.
Training draws from ``torch.Generator`` and cannot reproduce jax.random's
bits, so trained codebooks are held by the JAX tests' own quality gates
(tests/test_pq.py) instead of by equality; Lloyd from a shared init is held
to JAX at 1e-5.
"""

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openibl_tpu.ops import pq as jpq  # noqa: E402
from openibl_tpu.ops.pq_kernel import adc_tile as jax_adc_tile  # noqa: E402
from openibl_tpu_torch.ops import distance as tdist  # noqa: E402
from openibl_tpu_torch.ops import pq as tpq  # noqa: E402
from openibl_tpu_torch.ops import pq_kernel as tpk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _lut(q, cb, precise=True):
    """float64 LUT (Q, m, ksub), entries rounded to bf16 unless precise."""
    qn = q.shape[0]
    m, ksub, dsub = cb.shape
    qs = q.reshape(qn, m, dsub).astype(np.float64)
    lut = ((qs[:, :, None, :] - cb[None].astype(np.float64)) ** 2).sum(-1)
    if not precise:
        lut = lut.astype(np.float32).astype(ml_dtypes.bfloat16).astype(
            np.float64)
    return lut


def _adc_oracle(q, codes, cb, precise=True):
    """dist[i, n] = sum_j lut[i, j, codes[n, j]] in float64."""
    lut = _lut(q, cb, precise)
    out = np.zeros((q.shape[0], codes.shape[0]))
    for j in range(cb.shape[0]):
        out += lut[:, j, codes[:, j].astype(np.int64)]
    return out


def _blobs(rs, n, d, n_clusters, spread=0.05):
    centers = rs.randn(n_clusters, d).astype(np.float32)
    labels = rs.randint(0, n_clusters, n)
    x = centers[labels] + spread * rs.randn(n, d).astype(np.float32)
    return x.astype(np.float32), labels


def _assert_valid_topk(d, idx, oracle, rtol=1e-5, atol=1e-5):
    """Each row: distances are the oracle's at the ids, ids distinct, and
    no unreturned row nearer than the k-th by more than the tolerance."""
    d, idx = np.asarray(d), np.asarray(idx)
    for dr, ir, orow in zip(d, idx, oracle):
        np.testing.assert_allclose(dr, orow[ir], rtol=rtol, atol=atol)
        assert len(set(ir.tolist())) == len(ir)
        kth = orow[ir].max()
        rest = np.delete(orow, ir)
        if rest.size:
            assert rest.min() >= kth - (atol + rtol * abs(kth))


def _assert_same_up_to_ties(d_a, i_a, d_b, i_b, rtol=1e-5, atol=1e-5):
    """Same distances per rank; an id may differ only where its distance
    ties another rank's, or ties the k-th (a tie across the cut)."""
    d_a, i_a = np.asarray(d_a), np.asarray(i_a)
    d_b, i_b = np.asarray(d_b), np.asarray(i_b)
    np.testing.assert_allclose(d_a, d_b, rtol=rtol, atol=atol)
    for da, ia, db, ib in zip(d_a, i_a, d_b, i_b):
        tol = atol + rtol * np.abs(db[np.isfinite(db)]).max()
        for p in np.nonzero(ia != ib)[0]:
            tied = np.abs(db - da[p]) <= tol
            assert ia[p] in ib[tied] or abs(da[p] - db[-1]) <= tol


def _world(seed, n=800, d=32, m=8, ksub=16, opq_iters=0, blobs=True):
    """JAX-built PQ payload, queries near gallery rows. Blob rows share
    codes (many exact ADC ties); unit-norm gaussian rows almost never do,
    and keep exact distances (~2) free of f32 cancellation above 1e-6."""
    rs = np.random.RandomState(seed)
    if blobs:
        x = _blobs(rs, n, d, 12)[0]
    else:
        x = rs.randn(n, d).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = (x[rs.choice(n, 5, replace=False)]
         + 0.02 * rs.randn(5, d)).astype(np.float32)
    p = jpq.build_pq(x, m=m, ksub=ksub, iters=6, opq_iters=opq_iters)
    return x, q, p


def test_split_and_sub_d2_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(40, 32).astype(np.float32)
    c = rs.randn(8, 16, 4).astype(np.float32)
    xm_t = tpq._split_subspaces(torch.from_numpy(x), 8)
    xm_j = jpq._split_subspaces(jnp.asarray(x), 8)
    np.testing.assert_array_equal(xm_t.numpy(), np.asarray(xm_j))
    np.testing.assert_allclose(
        tpq._sub_d2(xm_t, torch.from_numpy(c)).numpy(),
        np.asarray(jpq._sub_d2(xm_j, jnp.asarray(c))), **TOL)
    with pytest.raises(ValueError, match="not divisible"):
        tpq._split_subspaces(torch.zeros(3, 30), 8)


@pytest.mark.parametrize("chunk", [64, 500])
def test_lloyd_batched_from_shared_init_matches_jax(chunk):
    """Row tiles of 64 (a ragged last tile) and one tile: both equal the
    JAX scan from the same numpy init."""
    rs = np.random.RandomState(1)
    x, _ = _blobs(rs, 500, 32, 10)
    xm = np.ascontiguousarray(np.transpose(x.reshape(500, 8, 4), (1, 0, 2)))
    init = xm[:, rs.choice(500, 16, replace=False)]
    got = tpq._lloyd_batched(torch.from_numpy(xm), torch.from_numpy(init),
                             iters=8, chunk=chunk)
    want = jpq._lloyd_batched(jnp.asarray(xm), jnp.asarray(init), iters=8,
                              chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pp_init_batched_draws_rows_from_a_generator():
    """jax.random's bits cannot be reproduced, so: every center is a data
    row of its subspace, one seed gives one init, and a subspace whose rows
    all coincide (D² all zero) still seeds (uniform draws)."""
    rs = np.random.RandomState(2)
    xm = rs.randn(4, 300, 8).astype(np.float32)
    xm[1] = xm[1, :1]  # every row of subspace 1 is the same
    xt = torch.from_numpy(xm)

    def init(seed):
        return tpq._pp_init_batched(torch.Generator().manual_seed(seed), xt,
                                    16).numpy()

    a = init(5)
    assert a.shape == (4, 16, 8)
    for j in range(4):
        for c in a[j]:
            assert np.any(np.all(xm[j] == c, axis=1))
    assert (a[1] == xm[1, 0]).all()
    np.testing.assert_array_equal(a, init(5))
    assert not np.array_equal(a, init(6))
    for j in (0, 2, 3):  # ++ draws distinct rows where rows are distinct
        assert len(np.unique(a[j], axis=0)) == 16


def test_encode_pq_matches_jax():
    """Codes equal; a flip is allowed only where two codewords are within
    1e-5 of the row (a near-tie, f32 distances in another order)."""
    rs = np.random.RandomState(3)
    x = rs.randn(600, 32).astype(np.float32)
    cb = jpq.train_pq(x, m=8, ksub=16, iters=5)
    got = tpq.encode_pq(cb, torch.from_numpy(x), chunk=128)
    want = jpq.encode_pq(cb, x)
    assert got.dtype == np.uint8 and got.shape == (600, 8)
    flips = np.argwhere(got != want)
    xs = x.reshape(600, 8, 4).astype(np.float64)
    for r, j in flips:
        d = ((xs[r, j] - cb[j].astype(np.float64)) ** 2).sum(-1)
        assert abs(d[got[r, j]] - d[want[r, j]]) <= 1e-5
    assert len(flips) <= 2
    np.testing.assert_array_equal(
        tpq.decode_pq(cb, got), jpq.decode_pq(cb, got))


@pytest.mark.parametrize("opq", [False, True])
def test_pq_search_precise_matches_jax_and_oracle(opq):
    """f32 LUT on a trained payload over blobs (ties among blob-mates)."""
    x, q, p = _world(4, opq_iters=3 if opq else 0)
    rot = p.get("pq_rotation")
    codes, cb = p["pq_codes"], p["pq_codebooks"]
    dt, it = tpq.pq_search(torch.from_numpy(q), torch.from_numpy(codes), cb,
                           k=10, precise=True, rotation=rot)
    dj, ij = jpq.pq_search(q, codes, cb, k=10, precise=True, rotation=rot)
    assert it.dtype == torch.int64 and dt.shape == (5, 10)
    _assert_same_up_to_ties(dt.numpy(), it.numpy(), dj, ij, **TOL)
    qr = q if rot is None else q @ rot
    _assert_valid_topk(dt.numpy(), it.numpy(), _adc_oracle(qr, codes, cb),
                       **TOL)


@pytest.mark.parametrize("rotate", [False, True])
def test_pq_search_bf16_matches_jax_and_oracle(rotate):
    """precise=False rounds each LUT entry to bf16. Two f32 LUTs built in
    another order can sit on either side of a bf16 rounding boundary, so the
    data are dyadic (multiples of 1/8, codebooks and a signed-permutation
    rotation included): every LUT entry and ADC sum is exact in f32 in both
    packages, and the bf16 roundings are the same. Codes repeat (700 random
    rows of 16^8): exact ties."""
    rs = np.random.RandomState(10)
    m, ksub, dsub, n = 8, 16, 4, 700
    cb = (rs.randint(-12, 13, (m, ksub, dsub)) / 8).astype(np.float32)
    codes = rs.randint(0, 3, (n, m)).astype(np.uint8)
    q = (rs.randint(-12, 13, (5, m * dsub)) / 8).astype(np.float32)
    rot = None
    if rotate:
        rot = np.zeros((m * dsub, m * dsub), np.float32)
        rot[np.arange(m * dsub), rs.permutation(m * dsub)] = rs.choice(
            [-1.0, 1.0], m * dsub)
    dt, it = tpq.pq_search(torch.from_numpy(q), torch.from_numpy(codes), cb,
                           k=10, rotation=rot)
    dj, ij = jpq.pq_search(q, codes, cb, k=10, rotation=rot)
    _assert_same_up_to_ties(dt.numpy(), it.numpy(), dj, ij, **TOL)
    qr = q if rot is None else q @ rot
    _assert_valid_topk(dt.numpy(), it.numpy(),
                       _adc_oracle(qr, codes, cb, precise=False), **TOL)
    assert len(np.unique(codes, axis=0)) < n  # the ties are there


@pytest.mark.parametrize("precise", [True, False])
def test_adc_tile_plain_matches_jax_interpret(precise):
    """K2's plain version against the JAX Pallas kernel in interpret mode
    (which takes the codes transposed, (m, T))."""
    rs = np.random.RandomState(5)
    m, ksub, qn, t = 8, 16, 5, 97
    lut = rs.rand(m, qn, ksub).astype(np.float32)
    codes = rs.randint(0, ksub, (t, m)).astype(np.uint8)
    got = tpk.adc_tile(torch.from_numpy(lut), torch.from_numpy(codes),
                       precise=precise)
    assert got.shape == (qn, t) and got.dtype == torch.float32
    want = jax_adc_tile(lut, np.ascontiguousarray(codes.T), precise=precise,
                        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = np.zeros((qn, t))
    ref = lut if precise else lut.astype(ml_dtypes.bfloat16)
    for j in range(m):
        oracle += ref[j].astype(np.float64)[:, codes[:, j].astype(np.int64)]
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)


def test_pq_search_tiling_matches_one_tile():
    x, q, p = _world(6, n=300, blobs=False)
    args = (torch.from_numpy(q), torch.from_numpy(p["pq_codes"]),
            p["pq_codebooks"])
    d1, i1 = tpq.pq_search(*args, k=7, chunk=64, precise=True)
    d2, i2 = tpq.pq_search(*args, k=7, chunk=300, precise=True)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=1e-6, atol=1e-6)


def test_k_clamps_to_gallery_size():
    rs = np.random.RandomState(9)
    x = rs.randn(6, 16).astype(np.float32)
    cb = jpq.train_pq(x, m=4, ksub=4, iters=3)
    codes = jpq.encode_pq(cb, x)
    d, i = tpq.pq_search(x[:2], torch.from_numpy(codes), cb, k=50)
    assert d.shape == (2, 6)
    assert sorted(i[0].tolist()) == list(range(6))


@pytest.mark.parametrize("storage", ["float32", "int8", "opq"])
def test_pq_search_rerank_matches_jax(storage):
    """A covering shortlist on a JAX-built payload: the port's re-rank
    returns JAX's ids and exact distances, and the exact scan's ids."""
    x, q, p = _world(7, n=600, opq_iters=3 if storage == "opq" else 0,
                     blobs=False)
    gal, scales = x, None
    if storage == "int8":
        gal, scales = tdist.quantize_index_int8(x)
    rot = p.get("pq_rotation")
    dj, ij = jpq.pq_search_rerank(q, p["pq_codes"], p["pq_codebooks"], gal,
                                  k=5, shortlist=120, gallery_scale=scales,
                                  rotation=rot)
    dt, it = tpq.pq_search_rerank(
        torch.from_numpy(q), torch.from_numpy(p["pq_codes"]),
        p["pq_codebooks"], torch.from_numpy(gal), k=5, shortlist=120,
        gallery_scale=None if scales is None else torch.from_numpy(scales),
        rotation=rot)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    _, ie = tdist.topk_nearest(
        torch.from_numpy(q), torch.from_numpy(gal), k=5,
        gallery_scale=None if scales is None else torch.from_numpy(scales))
    np.testing.assert_array_equal(it.numpy(), ie.numpy())


def test_pq_search_rerank_with_sqnorm_and_clamps():
    x, q, p = _world(8, n=40, blobs=False)
    sqn = np.einsum("nd,nd->n", x, x)
    kw = dict(k=50, shortlist=10_000)
    dj, ij = jpq.pq_search_rerank(q[:2], p["pq_codes"], p["pq_codebooks"], x,
                                  gallery_sqnorm=sqn, **kw)
    dt, it = tpq.pq_search_rerank(q[:2], torch.from_numpy(p["pq_codes"]),
                                  p["pq_codebooks"], torch.from_numpy(x),
                                  gallery_sqnorm=torch.from_numpy(sqn), **kw)
    assert dt.shape == (2, 40)  # k and the shortlist clamp to N
    assert sorted(it[0].tolist()) == list(range(40))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)


@pytest.mark.parametrize("nprobe", [2, 6])
@pytest.mark.parametrize("opq", [False, True])
def test_ivfpq_search_matches_jax(nprobe, opq):
    rs = np.random.RandomState(9)
    x, _ = _blobs(rs, 480, 32, 10)
    q = (x[:4] + 0.02 * rs.randn(4, 32)).astype(np.float32)
    p = jpq.build_ivfpq(x, nlist=6, m=8, ksub=16, iters=5,
                        opq_iters=2 if opq else 0)
    args = (p["ivfpq_codes"], p["ivfpq_codebooks"], p["ivf_centroids"],
            p["ivf_lists"])
    rot = p.get("ivfpq_rotation")
    dj, ij = jpq.ivfpq_search(q, *args, k=10, nprobe=nprobe, rotation=rot)
    dt, it = tpq.ivfpq_search(torch.from_numpy(q),
                              torch.from_numpy(p["ivfpq_codes"]), *args[1:],
                              k=10, nprobe=nprobe, rotation=rot)
    _assert_same_up_to_ties(dt.numpy(), it.numpy(), dj, ij, **TOL)


def test_ivfpq_unfilled_slots_are_inf():
    rs = np.random.RandomState(24)
    x = rs.randn(40, 16).astype(np.float32)
    p = tpq.build_ivfpq(x, nlist=8, m=4, ksub=8, iters=3)
    d, idx = tpq.ivfpq_search(x[:2], torch.from_numpy(p["ivfpq_codes"]),
                              p["ivfpq_codebooks"], p["ivf_centroids"],
                              p["ivf_lists"], k=30, nprobe=1)
    d, idx = d.numpy(), idx.numpy()
    assert (idx[0] == -1).any()  # one cell holds at most maxlen=10 rows
    assert np.isinf(d[0][idx[0] == -1]).all()
    assert np.isfinite(d[0][idx[0] >= 0]).all()


def test_train_pq_meets_the_jax_recall_gates():
    """tests/test_pq.py::test_recall_on_clustered_gallery, on the port."""
    rs = np.random.RandomState(7)
    gallery, labels = _blobs(rs, 2000, 64, 50, spread=0.05)
    q_ids = rs.choice(2000, 32, replace=False)
    queries = gallery[q_ids] + 0.01 * rs.randn(32, 64).astype(np.float32)
    g = torch.from_numpy(gallery)
    cb = tpq.train_pq(g, m=8, ksub=64, iters=15, seed=0)
    assert cb.shape == (8, 64, 8) and cb.dtype == np.float32
    codes = tpq.encode_pq(cb, g)
    _, idx = tpq.pq_search(queries, torch.from_numpy(codes), cb, k=50)
    idx = idx.numpy()
    recall50 = np.mean([q_ids[r] in idx[r] for r in range(32)])
    recall20 = np.mean([q_ids[r] in idx[r, :20] for r in range(32)])
    blob1 = np.mean(
        [labels[idx[r, 0]] == labels[q_ids[r]] for r in range(32)])
    assert recall50 >= 0.95, recall50
    assert recall20 >= 0.8, recall20
    assert blob1 >= 0.95, blob1
    cb16 = tpq.train_pq(g, m=16, ksub=64, iters=15, seed=0)
    _, idx16 = tpq.pq_search(queries, torch.from_numpy(
        tpq.encode_pq(cb16, g)), cb16, k=10)
    recall10_16 = np.mean([q_ids[r] in idx16[r].tolist() for r in range(32)])
    assert recall10_16 >= 0.85, recall10_16


def _correlated(rs, n, d, latent, noise=0.05):
    lat = rs.randn(n, latent).astype(np.float32)
    mix = rs.randn(latent, d).astype(np.float32)
    return (lat @ mix + noise * rs.randn(n, d)).astype(np.float32)


def _recon_err(payload, x):
    y = tpq.decode_pq(payload["pq_codebooks"], payload["pq_codes"])
    if "pq_rotation" in payload:
        y = y @ payload["pq_rotation"].T  # back to original space
    return float(np.mean(np.sum((x - y) ** 2, axis=1)))


def test_train_opq_meets_the_jax_gates():
    """tests/test_pq.py::TestOPQ: an orthogonal rotation, and on latent-mix
    data OPQ's reconstruction error under 0.7x plain PQ's."""
    rs = np.random.RandomState(41)
    x = _correlated(rs, 1500, 64, 12)
    rot, cb = tpq.train_opq(x, m=8, ksub=32, iters=6, opq_iters=3)
    assert rot.shape == (64, 64) and rot.dtype == np.float32
    np.testing.assert_allclose(rot @ rot.T, np.eye(64), atol=1e-5)
    assert cb.shape == (8, 32, 8)
    e_pq = _recon_err(tpq.build_pq(x, m=8, ksub=32, iters=10), x)
    e_opq = _recon_err(tpq.build_pq(torch.from_numpy(x), m=8, ksub=32,
                                    iters=10, opq_iters=5), x)
    assert e_opq < 0.7 * e_pq, (e_opq, e_pq)


def test_build_payloads_and_errors():
    rs = np.random.RandomState(8)
    x = rs.randn(128, 32).astype(np.float32)
    p = tpq.build_pq(x, m=4, ksub=16, iters=3)
    assert p["pq_codebooks"].shape == (4, 16, 8)
    assert p["pq_codes"].shape == (128, 4) and p["pq_codes"].dtype == np.uint8
    assert "pq_rotation" not in p
    v = tpq.build_ivfpq(x, nlist=8, m=4, ksub=16, iters=3)
    assert "ivfpq_rotation" not in v
    assert v["ivfpq_codes"].shape == (128, 4)
    ids = v["ivf_lists"][v["ivf_lists"] >= 0]
    assert sorted(ids.tolist()) == list(range(128))  # exact partition
    with pytest.raises(ValueError, match="not divisible"):
        tpq.train_pq(x[:, :30], m=4, ksub=8, iters=2)
    with pytest.raises(ValueError, match="uint8"):
        tpq.train_pq(x, m=4, ksub=512, iters=2)
    with pytest.raises(ValueError, match="uint8"):
        tpq.train_opq(x, m=4, ksub=512, iters=2, opq_iters=1)
    tiny = tpq.train_pq(x[:6], m=4, ksub=16, iters=2)  # fewer rows than ksub
    assert tiny.shape == (4, 16, 8)


def test_residual_codes_beat_plain_pq():
    """tests/test_pq.py::TestIVFPQ: the coarse cells absorb the blobs, so
    residual-PQ reconstruction error undercuts plain PQ at the same m."""
    rs = np.random.RandomState(22)
    centers = rs.randn(30, 32).astype(np.float32) * 3.0
    labels = rs.randint(0, 30, 1500)
    x = (centers[labels] + 0.2 * rs.randn(1500, 32)).astype(np.float32)
    cb = tpq.train_pq(x, m=4, ksub=32, iters=10)
    plain_err = float(np.mean((x - tpq.decode_pq(cb, tpq.encode_pq(cb, x)))
                              ** 2))
    p = tpq.build_ivfpq(torch.from_numpy(x), nlist=32, m=4, ksub=32, iters=10)
    cell_of = np.empty(1500, np.int64)
    valid = p["ivf_lists"] >= 0
    cell_of[p["ivf_lists"][valid]] = np.nonzero(valid)[0]
    rec = (p["ivf_centroids"][cell_of]
           + tpq.decode_pq(p["ivfpq_codebooks"], p["ivfpq_codes"]))
    assert float(np.mean((x - rec) ** 2)) < plain_err


def test_ivfpq_opq_full_probe_matches_reconstruction_oracle():
    """Port-built IVFADC+OPQ at nprobe=nlist: the ADC distances are exact
    distances to centroid + rotated-back decoded residual."""
    rs = np.random.RandomState(44)
    x = _correlated(rs, 240, 32, 8)
    q = x[:3]
    p = tpq.build_ivfpq(x, nlist=6, m=4, ksub=16, iters=6, opq_iters=3)
    d, idx = tpq.ivfpq_search(q, torch.from_numpy(p["ivfpq_codes"]),
                              p["ivfpq_codebooks"], p["ivf_centroids"],
                              p["ivf_lists"], k=5, nprobe=6,
                              rotation=p["ivfpq_rotation"])
    cell_of = np.empty(240, np.int64)
    valid = p["ivf_lists"] >= 0
    cell_of[p["ivf_lists"][valid]] = np.nonzero(valid)[0]
    res = tpq.decode_pq(p["ivfpq_codebooks"], p["ivfpq_codes"])
    recon = res @ p["ivfpq_rotation"].T + p["ivf_centroids"][cell_of]
    oracle = np.sum((q[:, None].astype(np.float64)
                     - recon[None].astype(np.float64)) ** 2, axis=2)
    got = np.take_along_axis(oracle, idx.numpy(), axis=1)
    # rotated back through a learned f32 rotation: the JAX test's 1e-3
    np.testing.assert_allclose(d.numpy(), got, rtol=1e-3, atol=1e-3)
