"""k-means and the IVF index of the PyTorch port against the JAX package.

Inputs are made with numpy seeds and given to both packages. k-means++
draws from one numpy RandomState in both, so the picks must be identical;
Lloyd from a shared init agrees to rtol 1e-5 (f32 products summed in other
orders). Galleries are unit-norm, so IVF distances (~2) agree to atol 1e-5,
and they are random (no exact ties), so the rankings must agree exactly.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openibl_tpu.ops import distance as jdist  # noqa: E402
from openibl_tpu.ops import ivf as jivf  # noqa: E402
from openibl_tpu.ops import kmeans as jkm  # noqa: E402
from openibl_tpu_torch.ops import distance as tdist  # noqa: E402
from openibl_tpu_torch.ops import ivf as tivf  # noqa: E402
from openibl_tpu_torch.ops import kmeans as tkm  # noqa: E402


def _clustered(seed, n_clusters=12, per=40, d=32):
    """Unit-norm rows around ``n_clusters`` well-separated centres."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, d).astype(np.float32) * 8
    g = np.concatenate(
        [c + rng.randn(per, d).astype(np.float32) * 0.4 for c in centers])
    return g / np.linalg.norm(g, axis=1, keepdims=True)


@pytest.mark.parametrize("seed, k", [(0, 16), (7, 5)])
def test_plus_plus_picks_match_jax(seed, k):
    x = _clustered(seed)
    got = tkm._plus_plus_init(seed, torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, jkm._plus_plus_init(seed, x, k))


def test_plus_plus_uniform_fallback_matches_jax():
    """Three distinct rows, five centres: the D² weights hit all-zero and
    both draw uniformly from the same RandomState."""
    x = np.repeat(np.eye(3, 8, dtype=np.float32), 4, axis=0)
    got = tkm._plus_plus_init(2, torch.from_numpy(x), 5).numpy()
    np.testing.assert_array_equal(got, jkm._plus_plus_init(2, x, 5))


def test_lloyd_from_shared_init_matches_jax():
    x = _clustered(1)
    init = x[np.random.RandomState(1).choice(len(x), 12, replace=False)]
    c_j, in_j = jkm._lloyd(jnp.asarray(x), jnp.asarray(init), 10)
    c_t, in_t = tkm._lloyd(torch.from_numpy(x), torch.from_numpy(init), 10)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(in_t), float(in_j), rtol=1e-5)


def test_kmeans_matches_jax():
    x = _clustered(2)
    c_t, in_t = tkm.kmeans(x, 12, iters=15, seed=3)
    c_j, in_j = jkm.kmeans(x, 12, iters=15, seed=3)
    assert c_t.shape == (12, 32) and c_t.dtype == np.float32
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(in_t, in_j, rtol=1e-5)


@pytest.mark.parametrize("geometry", [False, True])
def test_fill_lists_matches_jax(geometry):
    """Greedy fill with overflow: rows whose 2 ranked cells are full spill
    to the nearest (geometry) or the first open cell; identical tables."""
    rng = np.random.RandomState(4)
    n, nlist, maxlen = 120, 10, 13
    ranked = np.stack([rng.choice(3, 2, replace=False) for _ in range(n)])
    kw = {}
    if geometry:
        x = rng.randn(n, 8).astype(np.float32)
        kw = dict(x=x, centroids=rng.randn(nlist, 8).astype(np.float32))
    with pytest.warns(UserWarning, match="overflowed"):
        want = jivf.fill_lists(ranked, nlist, maxlen, **kw)
    if geometry:  # the port gathers overflow rows from a tensor
        kw["x"] = torch.from_numpy(kw["x"])
    with pytest.warns(UserWarning, match="overflowed"):
        got = tivf.fill_lists(ranked, nlist, maxlen, **kw)
    np.testing.assert_array_equal(got, want)
    assert sorted(got[got >= 0].tolist()) == list(range(n))


def test_fill_lists_capacity_errors():
    with pytest.raises(ValueError, match="capacity"):
        tivf.fill_lists(np.zeros((10, 1), np.int64), 2, 4)
    with pytest.raises(ValueError, match="capacity"):
        tivf.build_ivf(np.zeros((50, 8), np.float32), nlist=4, maxlen=2)
    with pytest.raises(ValueError, match="empty"):
        tivf.build_ivf(np.zeros((0, 8), np.float32))


def test_build_ivf_matches_jax():
    g = _clustered(5)
    got = tivf.build_ivf(torch.from_numpy(g), nlist=12, iters=10, seed=1)
    want = jivf.build_ivf(g, nlist=12, iters=10, seed=1)
    np.testing.assert_allclose(got["centroids"], want["centroids"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["lists"], want["lists"])
    assert got["lists"].dtype == np.int32


def test_build_ivf_subsample_and_default_sizing_match_jax():
    g = _clustered(6, n_clusters=8, per=50)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # spill warnings: same in both
        got = tivf.build_ivf(g, iters=5, train_size=100)
        want = jivf.build_ivf(g, iters=5, train_size=100)
    assert got["lists"].shape == want["lists"].shape
    np.testing.assert_allclose(got["centroids"], want["centroids"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["lists"], want["lists"])


def _storage(g, kind):
    """(gallery, scales or None, sqnorms) in the given storage format."""
    if kind == "int8":
        codes, scales = tdist.quantize_index_int8(g)
        w = codes.astype(np.float32) * scales[:, None]
        return codes, scales, np.einsum("nd,nd->n", w, w)
    w = g.astype(kind).astype(np.float32)
    return g.astype(kind), None, np.einsum("nd,nd->n", w, w)


@pytest.mark.parametrize("kind", ["float32", "int8"])
@pytest.mark.parametrize("nprobe", [3, 12])
@pytest.mark.parametrize("with_sqnorm", [False, True])
def test_ivf_search_matches_jax(kind, nprobe, with_sqnorm):
    g = _clustered(7)
    rng = np.random.RandomState(8)
    q = g[::23] + 0.05 * rng.randn(len(g[::23]), g.shape[1]).astype(
        np.float32)
    ivf = jivf.build_ivf(g, nlist=12, iters=10, seed=0)
    gal, scales, sqn = _storage(g, kind)
    sqn = sqn if with_sqnorm else None
    dj, ij = jivf.ivf_search(q, gal, ivf["centroids"], ivf["lists"], k=10,
                             nprobe=nprobe, gallery_scale=scales,
                             gallery_sqnorm=sqn)
    dt, it = tivf.ivf_search(
        torch.from_numpy(q), torch.from_numpy(gal), ivf["centroids"],
        ivf["lists"], k=10, nprobe=nprobe,
        gallery_scale=None if scales is None else torch.from_numpy(scales),
        gallery_sqnorm=None if sqn is None else torch.from_numpy(sqn))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)


def test_ivf_full_probe_matches_exact_topk():
    g = _clustered(9)
    q = g[::31] + 0.01
    ivf = tivf.build_ivf(g, nlist=12, iters=10)
    d, i = tivf.ivf_search(q, torch.from_numpy(g), ivf["centroids"],
                           ivf["lists"], k=8, nprobe=12)
    de, ie = tdist.topk_nearest(torch.from_numpy(q), torch.from_numpy(g), k=8)
    np.testing.assert_array_equal(i.numpy(), ie.numpy())
    np.testing.assert_allclose(d.numpy(), de.numpy(), atol=1e-5)
    dj, _ = jdist.topk_nearest(q, g, k=8)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), atol=1e-5)


def test_ivf_unfilled_slots_match_jax():
    """One probed cell holds fewer than k rows: the rest are (inf, -1) in
    both packages."""
    g = _clustered(10, n_clusters=6, per=10)
    ivf = jivf.build_ivf(g, nlist=6, iters=5)
    maxfill = int((ivf["lists"] >= 0).sum(axis=1).max())
    k = maxfill + 5
    dj, ij = jivf.ivf_search(g[:2], g, ivf["centroids"], ivf["lists"], k=k,
                             nprobe=1)
    dt, it = tivf.ivf_search(g[:2], torch.from_numpy(g), ivf["centroids"],
                             ivf["lists"], k=k, nprobe=1)
    it, dt = it.numpy(), dt.numpy()
    assert (it == -1).sum(axis=1).min() >= 5
    assert np.isinf(dt[it == -1]).all() and np.isfinite(dt[it >= 0]).all()
    np.testing.assert_array_equal(it, np.asarray(ij))
    np.testing.assert_allclose(dt[it >= 0], np.asarray(dj)[it >= 0],
                               atol=1e-5)
