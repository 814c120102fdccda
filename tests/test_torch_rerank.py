"""The port's k-reciprocal rerank and SFRS mining against the JAX package on
the CPU: the C++ expansion built from openibl_tpu_torch/csrc/rerank.cpp
against the JAX package's numpy expansion, ``re_ranking``,
``build_v_sparse`` (with ``topk_nearest(return_rowmax=True)``), both
``JaccardEngine`` paths, ``rerank_ranks_streaming`` against the
materialized path, ``composite_rank_key``, ``rank_positives`` /
``mine_hard_tuples_ranked`` and ``DiffTupleSampler.refresh`` with
Jaccard rows. Inputs are made with numpy from a seed and handed to both
packages.

Tolerances: distances and Jaccard values rtol 1e-4 / atol 1e-5 against the
JAX package (two f32 stacks), 1e-6 between the port's own engines on one
machine; rankings and mined tuples equal, or differing only between
entries whose distances tie within the stated gap.

The test marked ``cuda`` needs a card and skips here; on a GPU machine run
``pytest --noconftest -m cuda tests/test_torch_rerank.py`` (it imports no
jax).
"""

import os.path as osp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch.data.sampler import DiffTupleSampler  # noqa: E402
from openibl_tpu_torch.ops import _native, rerank  # noqa: E402
from openibl_tpu_torch.ops import distance as tdist  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _jax():
    jax = pytest.importorskip("jax")
    from openibl_tpu.ops import rerank as jrerank

    return jax, jrerank


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_rerank.py`")
    return torch.device("cuda")


def _unit(rng, n, d=16):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _planted(seed, n_clusters=4, per=8, d=16):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, d) * 5
    return np.concatenate([c + rng.randn(per, d) * 0.3
                           for c in centers]).astype(np.float32)


def _sq(a, b):
    return ((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1).astype(
        np.float32)


# --------------------------------------------------------------------------
# the native library
# --------------------------------------------------------------------------

def test_native_builds_from_the_port_sources():
    path = _native.require()
    assert osp.isfile(path) and path.startswith(_native.BUILD_DIR)
    assert osp.basename(path).startswith("librerank-")
    assert _native.SRC.endswith(osp.join("openibl_tpu_torch", "csrc",
                                         "rerank.cpp"))


@pytest.mark.parametrize("k1", [6, 25])
def test_native_expansion_matches_the_jax_numpy_path(k1):
    """The port's C++ expansion sets and weights equal the JAX package's
    numpy ``_expansion_index`` on one ranking."""
    _, jrerank = _jax()
    u = _unit(np.random.RandomState(k1), 90)
    d2 = _sq(u, u)
    d2 /= d2.max(axis=1, keepdims=True)
    ir = np.argsort(d2, axis=1, kind="stable")[:, :k1 + 1].astype(np.int32)
    rows, cols = _native.expansion_sets(ir, k1)
    expansion = jrerank._expansion_index(ir, k1)
    np.testing.assert_array_equal(
        rows, np.concatenate([np.full(len(e), i) for i, e in
                              enumerate(expansion)]))
    np.testing.assert_array_equal(cols, np.concatenate(expansion))
    w_rows, w_cols, vals = _native.expansion_weights(d2, ir, k1)
    np.testing.assert_array_equal(w_rows, rows)
    np.testing.assert_array_equal(w_cols, cols)
    want = np.concatenate([np.exp(-d2[i, e]) / np.exp(-d2[i, e]).sum()
                           for i, e in enumerate(expansion)])
    np.testing.assert_allclose(vals, want, rtol=1e-6, atol=1e-7)


def test_a_failed_build_falls_back_and_require_says_why(monkeypatch):
    """Without a compiler ``available()`` is False and the numpy/scipy
    paths give the same ranking; ``require()`` raises with the reason."""
    monkeypatch.setattr(_native, "_TRIED", False)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "library_path",
                        lambda: "/nonexistent/librerank.so")
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    feats = _planted(0)
    q, g = feats[:10], feats[10:]
    assert not _native.available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _native.require()
    fallback = rerank.re_ranking(_sq(q, g), _sq(q, q), _sq(g, g), k1=6, k2=1,
                                 lambda_value=0.1, device="cpu")
    monkeypatch.undo()
    native = rerank.re_ranking(_sq(q, g), _sq(q, q), _sq(g, g), k1=6, k2=1,
                               lambda_value=0.1, device="cpu")
    np.testing.assert_allclose(fallback, native, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# re_ranking and the streaming path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k1,k2,lam", [(6, 1, 0.1), (20, 6, 0.3),
                                       (25, 1, 0.0)])
def test_re_ranking_matches_jax(k1, k2, lam):
    _, jrerank = _jax()
    rng = np.random.RandomState(k1)
    q, g = _unit(rng, 12), _unit(rng, 70)
    args = (_sq(q, g), _sq(q, q), _sq(g, g))
    want = jrerank.re_ranking(*args, k1=k1, k2=k2, lambda_value=lam)
    got = rerank.re_ranking(*args, k1=k1, k2=k2, lambda_value=lam,
                            device="cpu")
    assert got.shape == (12, 70)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    key, jkey = (rerank.composite_rank_key(x, args[0]) for x in (got, want))
    np.testing.assert_array_equal(np.argsort(key, axis=1)[:, :10],
                                  np.argsort(jkey, axis=1)[:, :10])


def test_re_ranking_keeps_clusters_and_its_range():
    feats = _planted(1, n_clusters=3, per=10)
    labels = np.repeat(np.arange(3), 10)
    mask = np.ones(len(feats), bool)
    mask[::5] = False
    q, g = feats[~mask], feats[mask]
    out = rerank.re_ranking(_sq(q, g) ** 0.5, _sq(q, q) ** 0.5,
                            _sq(g, g) ** 0.5, k1=8, k2=1, lambda_value=0.1,
                            device="cpu")
    assert np.all(out >= -1e-6) and np.all(out <= 1 + 1e-6)
    assert (labels[mask][out.argmin(axis=1)] == labels[~mask]).all()


@pytest.mark.parametrize("full_path", [True, False])
def test_topk_nearest_rowmax_matches_jax(full_path):
    jax, _ = _jax()
    from openibl_tpu.ops import distance as jdist

    rng = np.random.RandomState(2)
    q, g = _unit(rng, 7), _unit(rng, 50)
    jd, ji, jm = jdist.topk_nearest(q, g, k=5, chunk=16, full_path=full_path,
                                    return_rowmax=True)
    d, i, m = tdist.topk_nearest(torch.from_numpy(q), torch.from_numpy(g),
                                 k=5, chunk=16, full_path=full_path,
                                 return_rowmax=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(m.numpy(), _sq(q, g).max(axis=1), rtol=RTOL,
                               atol=ATOL)


def test_build_v_sparse_matches_jax():
    _, jrerank = _jax()
    u = _unit(np.random.RandomState(3), 80)
    rows, cols, vals, ir, rm2 = rerank.build_v_sparse(torch.from_numpy(u),
                                                      k1=15)
    jrows, jcols, jvals, jir, jrm2 = jrerank.build_v_sparse(u, k1=15)
    np.testing.assert_array_equal(ir, jir)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_allclose(rm2, jrm2, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vals, jvals, rtol=RTOL, atol=ATOL)
    # a numpy union is taken on the CPU, the same V
    again = rerank.build_v_sparse(u, k1=15)
    np.testing.assert_array_equal(again[2], vals)


def test_jaccard_engines_agree_with_jax():
    """The C++ host engine, the scipy loop and the device scatter-add (on
    the CPU here) give the JAX engine's Jaccard distances; ``auto`` takes
    the host at this size and says so."""
    _, jrerank = _jax()
    u = _unit(np.random.RandomState(4), 120)
    rows, cols, vals, _, _ = rerank.build_v_sparse(u, k1=15)
    n = len(u)
    qrows = np.arange(0, 40, 3)
    want = jrerank.jaccard_for_queries(rows, cols, vals, n, qrows,
                                       prefer="host")
    eng = rerank.JaccardEngine(rows, cols, vals, n, device="cpu")
    native = eng.query(qrows)
    assert eng.last_engine == "native"
    scipy_ = eng._query_scipy(qrows)
    dev = eng.query(qrows, query_chunk=4, prefer="device")
    assert eng.last_engine == "device"
    np.testing.assert_allclose(native, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(scipy_, native, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dev, native, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        rerank.jaccard_for_queries(rows, cols, vals, n, qrows,
                                   prefer="device", device="cpu"),
        dev, rtol=0, atol=0)
    with pytest.raises(ValueError):
        eng.query(qrows, prefer="gpu")


def test_device_table_guard(monkeypatch):
    """Hub-heavy columns route the device path to the host; without a host
    path, modest tables still build and huge ones raise."""
    def engine(n, hub):
        rows = np.concatenate([np.arange(hub) % n, np.arange(n)])
        cols = np.concatenate([np.zeros(hub, np.int64), np.arange(n)])
        return rerank.JaccardEngine(rows.astype(np.int32),
                                    cols.astype(np.int32),
                                    np.ones(len(rows), np.float32), n,
                                    device="cpu")

    assert engine(2000, 5000)._device_structs() is None  # the host marker
    monkeypatch.setattr(rerank, "sp", None)
    monkeypatch.setattr(rerank._native, "available", lambda: False)
    assert engine(2000, 5000)._device_structs() is not None
    with pytest.raises(MemoryError):
        engine(300_000, 5000)._device_structs()


@pytest.mark.parametrize("k1,k2,lam", [(25, 1, 0.0), (25, 1, 0.3),
                                       (20, 6, 0.3)])
def test_streaming_matches_the_materialized_path(k1, k2, lam):
    rng = np.random.RandomState(5)
    q, g = _unit(rng, 25), _unit(rng, 180)
    full = rerank.re_ranking(_sq(q, g), _sq(q, q), _sq(g, g), k1=k1, k2=k2,
                             lambda_value=lam, device="cpu")
    idx, dist = rerank.rerank_ranks_streaming(
        torch.from_numpy(q), torch.from_numpy(g), k1=k1, k2=k2,
        lambda_value=lam, k_out=20, query_chunk=8)
    np.testing.assert_allclose(np.take_along_axis(full, idx, axis=1), dist,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.sort(dist, axis=1),
                               np.sort(full, axis=1)[:, :20], rtol=RTOL,
                               atol=ATOL)
    if k2 == 1:
        order = np.argsort(rerank.composite_rank_key(full, _sq(q, g)),
                           axis=1)[:, :20]
        np.testing.assert_array_equal(idx, order)


def test_streaming_matches_jax():
    _, jrerank = _jax()
    rng = np.random.RandomState(6)
    q, g = _unit(rng, 10), _unit(rng, 90)
    idx, dist = rerank.rerank_ranks_streaming(q, g, k1=20, k_out=15)
    jidx, jdist = jrerank.rerank_ranks_streaming(q, g, k1=20, k_out=15)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(dist, jdist, rtol=RTOL, atol=ATOL)


def test_composite_rank_key_matches_jax():
    _, jrerank = _jax()
    a = np.float32(1e-5)
    b = np.nextafter(a, np.float32(1.0), dtype=np.float32)
    final = np.array([[b, a, 1.0, 1.0], [1.0, 1.0, 1.0, 0.5]], np.float32)
    orig = np.array([[0.1, 5.0, 2.0, 3.0], [3.0, 1.0, 2.0, 0.5]], np.float32)
    key = rerank.composite_rank_key(final, orig)
    np.testing.assert_array_equal(key, jrerank.composite_rank_key(final,
                                                                  orig))
    np.testing.assert_array_equal(np.argsort(key, axis=1),
                                  [[1, 0, 2, 3], [3, 1, 2, 0]])


# --------------------------------------------------------------------------
# SFRS mining
# --------------------------------------------------------------------------

def _mining_world(seed, s=6, g=30, d=16, p=5):
    rng = np.random.RandomState(seed)
    q, gal = _unit(rng, s, d), _unit(rng, g, d)
    pos = [sorted(rng.choice(g, rng.randint(2, p + 1), replace=False))
           for _ in range(s)]
    neg = [sorted(set(x) | set(rng.choice(g, 3, replace=False)))
           for x in pos]
    return q, gal, pos, neg


def test_rank_positives_and_ranked_mining_match_jax():
    _jax()
    from openibl_tpu.ops import distance as jdist
    from openibl_tpu.utils import pad_index_lists

    q, gal, pos, _ = _mining_world(7)
    pos_idx, _ = pad_index_lists(pos)
    cand = np.stack([np.r_[np.arange(10, 22), -1, -1]] * len(q)).astype(
        np.int32)
    jr, jrd = jdist.rank_positives(q, gal, pos_idx, pos_pool=4)
    r, rd = tdist.rank_positives(torch.from_numpy(q), torch.from_numpy(gal),
                                 pos_idx, pos_pool=4)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), rtol=RTOL,
                               atol=ATOL)
    want = jdist.mine_hard_tuples_ranked(q, gal, pos_idx, cand, neg_num=3,
                                         pos_pool=4)
    got = tdist.mine_hard_tuples_ranked(torch.from_numpy(q),
                                        torch.from_numpy(gal), pos_idx, cand,
                                        neg_num=3, pos_pool=4)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (r.numpy() == -1).any()  # anchors with fewer than 4 positives


def _promoted_equal_up_to_ties(a, b, jac, tie=1e-6):
    """Two promoted-positive lists agree, or differ only where their
    Jaccard distances tie within ``tie``."""
    if len(a) != len(b):
        return False
    return all(x == y or abs(jac[x] - jac[y]) < tie for x, y in zip(a, b))


def test_jaccard_promoted_matches_jax():
    _jax()
    from openibl_tpu.data.sampler import DiffTupleSampler as JDiff

    rng = np.random.RandomState(8)
    for _ in range(20):
        p = rng.randint(1, 12)
        order = rng.choice(100, p, replace=False)
        jd = rng.rand(p).astype(np.float32)
        jd[rng.rand(p) < 0.3] = 1.0  # the zero-overlap tail ties
        for pos_num in (1, 3, 10):
            np.testing.assert_array_equal(
                DiffTupleSampler._jaccard_promoted(order, jd, pos_num),
                JDiff._jaccard_promoted(order, jd, pos_num))


@pytest.mark.parametrize("with_jaccard", [False, True])
def test_diff_sampler_refresh_matches_jax(with_jaccard):
    """Both DiffTupleSamplers, one seed: the same candidates, negatives,
    positives and tuple order; the difficult positives equal up to Jaccard
    ties, from the port's Jaccard rows and the JAX package's."""
    _, jrerank = _jax()
    from openibl_tpu.data.sampler import DiffTupleSampler as JDiff

    q, gal, pos, neg = _mining_world(9, s=8, g=40, p=6)
    kw = dict(pos_num=3, pos_pool=5, neg_num=3, neg_pool=12, seed=4)
    ours = DiffTupleSampler(len(q), len(gal), pos, neg, **kw)
    theirs = JDiff(len(q), len(gal), pos, neg, **kw)
    sub = np.array([0, 2, 3, 5, 7])
    jac = jjac = None
    if with_jaccard:
        union = np.concatenate([q, gal])
        rows, cols, vals, _, _ = rerank.build_v_sparse(union, k1=6)
        jac = rerank.jaccard_for_queries(rows, cols, vals, len(union), sub,
                                         device="cpu")[:, len(q):]
        jr, jc, jv, _, _ = jrerank.build_v_sparse(union, k1=6)
        jjac = jrerank.jaccard_for_queries(jr, jc, jv, len(union),
                                           sub)[:, len(q):]
        np.testing.assert_allclose(jac, jjac, rtol=RTOL, atol=ATOL)
    for epoch in range(2):  # the second refresh reads the negative cache
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = ours.refresh(torch.from_numpy(q[sub]), torch.from_numpy(gal),
                           sub, jaccard_rows=jac)
        want = theirs.refresh(q[sub], gal, sub, jaccard_rows=jjac)
        assert [t[:5] for t in got] == [t[:5] for t in want]
        np.testing.assert_array_equal(ours.neg_cache, theirs.neg_cache)
        for t, u in zip(got, want):
            row = list(sub).index(t[0])
            jd = (np.zeros(len(gal)) if jac is None
                  else np.r_[np.zeros(len(q)), jac[row]])
            assert _promoted_equal_up_to_ties(t[5:], u[5:], jd), (t, u)
        assert all(len(t) == 1 + 1 + 3 + 3 for t in got)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_device_jaccard_matches_the_native_engine(cuda_device):
    """The scatter-add engine on the card against the host C++ one on a
    union of 4096-d descriptors (atomics sum in a varying order: rtol 1e-5
    / atol 1e-6), and the V rows built on the card against the CPU's."""
    rng = np.random.RandomState(10)
    u = _unit(rng, 300, 4096)
    rows, cols, vals, ir, rm2 = rerank.build_v_sparse(
        torch.from_numpy(u).to(cuda_device), k1=20)
    crows, ccols, cvals, cir, crm2 = rerank.build_v_sparse(u, k1=20)
    np.testing.assert_array_equal(ir, cir)
    np.testing.assert_allclose(vals, cvals, rtol=1e-4, atol=1e-6)
    eng = rerank.JaccardEngine(rows, cols, vals, len(u), device=cuda_device)
    qrows = np.arange(0, 300, 7)
    host = eng.query(qrows, prefer="host")
    dev = eng.query(qrows, prefer="device")
    assert eng.last_engine == "device"
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-6)
