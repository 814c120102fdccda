"""Retrieval, PCA and recall code of the PyTorch port against the JAX package.

Galleries are separated (queries are noisy copies of their own rows), so the
rankings are free of near-ties and must agree exactly; distances agree to
atol 1e-4 (f32 products summed in other orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openibl_tpu.engine import evaluator as jev  # noqa: E402
from openibl_tpu.ops import distance as jdist  # noqa: E402
from openibl_tpu.ops import pca as jpca  # noqa: E402
from openibl_tpu_torch.engine import evaluator as tev  # noqa: E402
from openibl_tpu_torch.ops import distance as tdist  # noqa: E402
from openibl_tpu_torch.ops import pca as tpca  # noqa: E402


def _gallery(seed, n=600, d=64, q=12):
    rng = np.random.RandomState(seed)
    g = rng.randn(n, d).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    rows = rng.choice(n, q, replace=False)
    qs = g[rows] + 0.05 * rng.randn(q, d).astype(np.float32)
    return qs.astype(np.float32), g, rows


def _index(g, storage):
    """(gallery array, scales or None) in the given storage format."""
    if storage == "int8":
        return tdist.quantize_index_int8(g)
    return g.astype(storage), None


@pytest.mark.parametrize("storage", ["float32", "float16", "int8"])
@pytest.mark.parametrize("with_sqnorm", [False, True])
def test_topk_full_stream_and_jax_agree(storage, with_sqnorm):
    qs, g, rows = _gallery(0)
    gal, scales = _index(g, storage)
    sqn = None
    if with_sqnorm:
        w = gal.astype(np.float32) * (1 if scales is None else scales[:, None])
        sqn = np.einsum("nd,nd->n", w, w).astype(np.float32)
    kw = dict(k=10, gallery_scale=scales, gallery_sqnorm=sqn)
    jd, ji = jdist.topk_nearest(jnp.asarray(qs), jnp.asarray(gal), **kw)
    tkw = dict(k=10,
               gallery_scale=None if scales is None else torch.from_numpy(scales),
               gallery_sqnorm=None if sqn is None else torch.from_numpy(sqn))
    full = tdist.topk_nearest(torch.from_numpy(qs), torch.from_numpy(gal),
                              full_path=True, **tkw)
    stream = tdist.topk_nearest(torch.from_numpy(qs), torch.from_numpy(gal),
                                full_path=False, chunk=128, **tkw)
    assert full[1].shape == (12, 10)
    np.testing.assert_array_equal(full[1][:, 0].numpy(), rows)
    for d, i in (full, stream):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-4)


def test_topk_k_clamps_and_numpy_inputs():
    qs, g, rows = _gallery(1, n=5, q=2)
    d, i = tdist.topk_nearest(qs, g, k=10, chunk=2, full_path=False)
    assert i.shape == (2, 5)
    np.testing.assert_array_equal(i[:, 0].numpy(), rows)


@pytest.mark.parametrize("args", [(1, 100_000, 4096, False),
                                  (16, 100_000, 4096, True),
                                  (40_000, 40_000, 8, False)])
def test_auto_path_choices_match_jax(args, monkeypatch):
    monkeypatch.setattr(jdist, "_WIDEN_BUDGET_BYTES", 4 * 1024**3)
    monkeypatch.setattr(tdist, "_WIDEN_BUDGET_BYTES", 4 * 1024**3)
    q, n, d, widened = args
    assert tdist._auto_full_path(q, n, d, widened) == \
        jdist._auto_full_path(q, n, d, widened)
    assert tdist._auto_chunk(n, d, q) == jdist._auto_chunk(n, d, q)


def test_pairwise_and_int8_quantization_match_jax():
    qs, g, _ = _gallery(2, n=50)
    np.testing.assert_allclose(
        tdist.pairwise_sqdist(torch.from_numpy(qs), torch.from_numpy(g)).numpy(),
        np.asarray(jdist.pairwise_sqdist(qs, g)), atol=1e-4)
    for a, b in zip(tdist.quantize_index_int8(g), jdist.quantize_index_int8(g)):
        np.testing.assert_array_equal(a, b)


def _pca_params(seed, d=48, k=16):
    rng = np.random.RandomState(seed)
    u, _ = np.linalg.qr(rng.randn(d, d))
    return {"U": u[:, :k].astype(np.float32),
            "lams": np.sort(rng.rand(k).astype(np.float32) + 0.1)[::-1].copy(),
            "mu": rng.randn(d, 1).astype(np.float32)}


@pytest.mark.parametrize("ext", [".h5", ".npz"])
def test_load_pca_and_projection_match_jax(ext, tmp_path):
    params = _pca_params(3)
    path = str(tmp_path / f"pca{ext}")
    jpca.save_pca(params, path)
    loaded = tpca.load_pca(path)
    for key in ("U", "lams", "mu"):
        np.testing.assert_array_equal(loaded[key], params[key])
    for whiten in (True, False):
        proj, bias = tpca.pca_projection(loaded, n_components=8,
                                         whiten=whiten)
        jproj, jbias = jpca.pca_projection(params, n_components=8,
                                           whiten=whiten)
        np.testing.assert_allclose(proj, np.asarray(jproj), rtol=1e-6)
        np.testing.assert_allclose(bias, np.asarray(jbias), rtol=1e-5,
                                   atol=1e-6)
        x = np.random.RandomState(4).randn(5, 48).astype(np.float32)
        out = tpca.pca_apply(torch.from_numpy(x), proj, bias).numpy()
        np.testing.assert_allclose(out, np.asarray(jpca.pca_apply(x, jproj,
                                                                  jbias)),
                                   atol=1e-5)


@pytest.mark.parametrize("nms", [False, True])
def test_recalls_from_ranks_match_jax(nms):
    rng = np.random.RandomState(5)
    ranks = np.stack([rng.permutation(40) for _ in range(20)])
    gt = [list(rng.choice(40, 2, replace=False)) for _ in range(20)]
    pids = rng.randint(0, 15, 40)  # panoramas: NMS dedups by these
    got = tev.recalls_from_ranks(ranks, gt, pids, topk=(1, 2, 3), nms=nms)
    want = jev.recalls_from_ranks(ranks, gt, pids, topk=(1, 2, 3), nms=nms)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="gallery_pids"):
        tev.recalls_from_ranks(ranks, gt, None, nms=True)


def test_evaluate_descriptors_matches_jax():
    qs, g, rows = _gallery(6, n=300, q=20)
    gt = [[int(r)] for r in rows]
    pids = np.arange(300) // 3
    for nms in (False, True):
        got = tev.evaluate_descriptors(torch.from_numpy(qs), g, gt, pids,
                                       nms=nms, print_results=False)
        want = jev.evaluate_descriptors(qs, g, gt, pids, nms=nms,
                                        print_results=False)
        np.testing.assert_array_equal(got, want)
        assert got[0] == 1.0
