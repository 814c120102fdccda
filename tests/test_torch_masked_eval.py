"""The port's masked variable-shape path, on the CPU, against itself and
against the JAX package (tests/test_masked_eval.py's oracle, one device).

Images zero-padded to a bucket shape and run with their valid extents give
each image's per-shape result: the port's masked descriptor equals its own
per-shape descriptor at the JAX test's atol 5e-7 (the backbone keeps
``channels_last``, so the padded and per-shape convolutions sum alike), and
the port's ``forward_masked`` agrees with the JAX ``apply_masked`` on
converted parameters at the JAX package's f32 gate (rtol 1e-4 / atol
1e-5). ``PaddedBatchLoader`` yields the JAX loader's batches exactly.
"""

from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

from openibl_tpu_torch import models  # noqa: E402
from openibl_tpu_torch.data.loader import (  # noqa: E402
    BatchLoader, ImageSource, PaddedBatchLoader,
)
from openibl_tpu_torch.data.transforms import TestTransform  # noqa: E402
from openibl_tpu_torch.models.convert import params_from_jax  # noqa: E402
from openibl_tpu_torch.parallel.extract import extract_features  # noqa: E402
from openibl_tpu_torch.utils import l2_normalize  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
SHAPES = [(48, 64), (64, 48), (37, 64), (33, 47)]


def _jax():
    """The JAX side, imported per test: a GPU machine need not carry the JAX
    package's dependencies, and runs this file's ``cuda`` test alone."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from openibl_tpu import models
    from openibl_tpu.data import loader
    from openibl_tpu.data.transforms import TestTransform
    from openibl_tpu.parallel.extract import extract_features

    return SimpleNamespace(jax=jax, jnp=jnp, models=models, loader=loader,
                           TestTransform=TestTransform,
                           extract_features=extract_features)


def _jax_tree(name="embednet", seed=0, **kw):
    j = _jax()
    model = j.models.create(
        name, net_vlad=j.models.NetVLAD(num_clusters=4), **kw)
    params = j.jax.tree.map(np.asarray,
                            model.init(j.jax.random.PRNGKey(seed)))
    params["vlad"]["centroids"] = params["vlad"]["centroids"] * 0.01
    return model, params


def _port(name, params, **kw):
    model = models.create(name, net_vlad=models.NetVLAD(num_clusters=4),
                          **kw)
    model.load_state_dict(params_from_jax(params))
    return model.to(memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def pair():
    jmodel, params = _jax_tree()
    return jmodel, params, _port("embednet", params)


def _padded(x, size=64):
    out = np.zeros((1, size, size, 3), x.dtype)
    out[0, :x.shape[0], :x.shape[1]] = x
    return torch.from_numpy(out)


@pytest.mark.parametrize("h,w", SHAPES)
def test_masked_equals_per_shape(pair, h, w):
    """Padded + masked == the image at its own shape, also where pooling
    floors odd extents; the max-pool vector is taken over the valid region
    only (the pad's zeros would win over negative maxima)."""
    model = pair[2]
    x = np.random.RandomState(h * w).randn(h, w, 3).astype(np.float32) * 40
    with torch.no_grad():
        pool_w, want = model(torch.from_numpy(x[None]))
        pool_g, got = model.forward_masked(_padded(x), [[h, w]])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-7)
    np.testing.assert_allclose(pool_g.numpy(), pool_w.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_masked_uint8_input(pair):
    """The mean subtraction on the device must not leak into the pad."""
    model = pair[2]
    x = (np.random.RandomState(1).rand(48, 48, 3) * 255).astype(np.uint8)
    with torch.no_grad():
        _, want = model(torch.from_numpy(x[None]))
        _, got = model.forward_masked(_padded(x), [[48, 48]])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-7)


def test_embednetpca_masked():
    _, params = _jax_tree("embednetpca", seed=1, pca_dim=16)
    model = _port("embednetpca", params, pca_dim=16)
    x = np.random.RandomState(2).randn(37, 64, 3).astype(np.float32) * 40
    with torch.no_grad():
        want = model(torch.from_numpy(x[None]))
        got = model.forward_masked(_padded(x), [[37, 64]])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-7)


def test_forward_masked_matches_jax_apply_masked(pair):
    """A batch of two orientations' worth of extents in one padded shape."""
    jmodel, params, model = pair
    rng = np.random.RandomState(3)
    hws = np.array([[37, 64], [64, 33], [48, 48]], np.int32)
    imgs = np.zeros((3, 64, 64, 3), np.float32)
    for j, (h, w) in enumerate(hws):
        imgs[j, :h, :w] = rng.randn(h, w, 3) * 40
    jnp = _jax().jnp
    jpool, jdesc = jmodel.apply_masked(params, jnp.asarray(imgs),
                                       jnp.asarray(hws))
    with torch.no_grad():
        pool, desc = model.forward_masked(torch.from_numpy(imgs), hws)
    np.testing.assert_allclose(desc.numpy(), np.asarray(jdesc), rtol=RTOL,
                               atol=ATOL)
    # raw conv5 maxima: the absolute term scales with the activations, as
    # in tests/test_torch_models.py's backbone parity
    scale = float(np.abs(np.asarray(jpool)).max())
    np.testing.assert_allclose(pool.numpy(), np.asarray(jpool), rtol=RTOL,
                               atol=ATOL * scale)


def test_fused_kernel_rejects_mask(pair):
    model = pair[2]
    with pytest.raises(ValueError, match="masked"):
        models.netvlad_apply(
            {"assign_w": model.net_vlad.assign_w,
             "centroids": model.net_vlad.centroids},
            torch.zeros((1, 2, 2, 512)), fused=True, valid_hw=[[2, 2]])


def test_fused_view_serves_masked_batches_with_the_eager_head(
        pair, monkeypatch):
    """``pipeline.eval_view``'s model on the card has the fused head: its
    masked forward takes the eager head (the kernel has no masked
    variant) and gives the masked result; its plain forward takes the
    fused head."""
    from openibl_tpu_torch.ops import netvlad_kernel

    model = pair[2]
    fused = models.NetVLAD(4, fused=True)
    fused.assign_w, fused.centroids = (model.net_vlad.assign_w,
                                       model.net_vlad.centroids)
    view = models.EmbedNet(base=model.base, net_vlad=fused)
    calls = []
    plain = netvlad_kernel.netvlad_fused

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(netvlad_kernel, "netvlad_fused", spy)
    x = np.random.RandomState(4).randn(37, 64, 3).astype(np.float32) * 40
    with torch.no_grad():
        _, got = view.forward_masked(_padded(x), [[37, 64]])
        _, want = model.forward_masked(_padded(x), [[37, 64]])
        assert calls == []
        view(torch.from_numpy(x[None]))
    assert len(calls) == 1
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# PaddedBatchLoader and masked extraction
# ---------------------------------------------------------------------------

@pytest.fixture
def image_dir(tmp_path):
    """Images with mixed aspect ratios on disk (tests/test_masked_eval.py's
    sizes plus an odd one)."""
    rng = np.random.RandomState(5)
    sizes = [(64, 48), (48, 64), (64, 48), (52, 64), (64, 37), (47, 33)]
    items = []
    for i, (w, h) in enumerate(sizes):
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img{i}.png")
        items.append((f"img{i}.png", i, float(i), 0.0))
    return str(tmp_path), items


@pytest.mark.parametrize("batch_size", [2, 4])
@pytest.mark.parametrize("normalize", [False, True])
def test_padded_loader_matches_jax(image_dir, batch_size, normalize):
    root, items = image_dir
    j = _jax()
    ours = PaddedBatchLoader(
        ImageSource(items, root, TestTransform(32, 48, tokyo=True,
                                               device_normalize=normalize)),
        batch_size=batch_size)
    theirs = j.loader.PaddedBatchLoader(
        j.loader.ImageSource(items, root, j.TestTransform(
            32, 48, tokyo=True, device_normalize=normalize)),
        batch_size=batch_size)
    got, want = list(ours), list(theirs)
    assert len(ours) == len(theirs) == len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b) == 4
        for x, y in zip(a[:3], b[:3]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert a[3] == b[3]


def test_shape_of_matches_a_decode(image_dir):
    root, items = image_dir
    for tf in (TestTransform(32, 48, tokyo=True), TestTransform(32, 48)):
        src = ImageSource(items, root, tf)
        for i in range(len(items)):
            assert src.shape_of(i) == src.load(i).shape
    assert ImageSource(items, root).shape_of(0) is None


def test_padded_loader_without_shape_of_decodes_once(image_dir):
    """A source that cannot predict shapes is decoded once for bucketing;
    the pixels are kept for the batches."""
    root, items = image_dir
    loads = []

    class Source(ImageSource):
        def shape_of(self, index):
            return None

        def load(self, index):
            loads.append(index)
            return super().load(index)

    src = Source(items, root, TestTransform(32, 48, tokyo=True))
    batches = list(PaddedBatchLoader(src, batch_size=4))
    assert sorted(loads) == list(range(len(items)))
    assert sum(b[3] for b in batches) == len(items)


def _per_shape(model, src):
    with torch.no_grad():
        return np.concatenate([
            l2_normalize(model(torch.from_numpy(src.load(i)[None]))[1]).numpy()
            for i in range(len(src))])


def test_masked_extraction_matches_per_shape_and_jax(image_dir, pair):
    jmodel, params, model = pair
    root, items = image_dir
    src = ImageSource(items, root, TestTransform(32, 48, tokyo=True))
    want = _per_shape(model, src)
    for bs in (2, 4):
        got = extract_features(model, PaddedBatchLoader(src, batch_size=bs),
                               masked_apply_fn=model.forward_masked)
        np.testing.assert_allclose(got, want, atol=5e-7)
    loader = PaddedBatchLoader(src, batch_size=4)
    dev = extract_features(model, loader,
                           masked_apply_fn=model.forward_masked,
                           device_output=True)
    np.testing.assert_allclose(dev.numpy(), want, atol=5e-7)
    j = _jax()
    jsrc = j.loader.ImageSource(items, root, j.TestTransform(32, 48,
                                                             tokyo=True))
    theirs = j.extract_features(
        jmodel.apply, params, j.loader.PaddedBatchLoader(jsrc, batch_size=4),
        masked_apply_fn=jmodel.apply_masked)
    np.testing.assert_allclose(got, theirs, rtol=RTOL, atol=ATOL)


def test_plain_loader_with_masked_fn_unaffected(image_dir, pair):
    """3-tuple batches still go through the plain model."""
    model = pair[2]
    root, items = image_dir
    src = ImageSource(items, root, TestTransform(32, 48))
    plain = extract_features(model, BatchLoader(src, batch_size=4))
    both = extract_features(model, BatchLoader(src, batch_size=4),
                            masked_apply_fn=model.forward_masked)
    np.testing.assert_array_equal(plain, both)


def test_masked_batches_need_a_masked_fn(image_dir, pair):
    root, items = image_dir
    src = ImageSource(items, root, TestTransform(32, 48, tokyo=True))
    with pytest.raises(ValueError, match="masked_apply_fn"):
        extract_features(pair[2], PaddedBatchLoader(src, batch_size=4))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest --noconftest -m cuda "
                    "tests/test_torch_masked_eval.py` on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_masked_equals_per_shape(cuda_device):
    """On the card cuDNN picks an algorithm per shape: the padded masked
    descriptors agree with per-shape batch-1 ones at the f32 gate, through
    the fused-head view (masked batches take the eager head)."""
    gen = torch.Generator().manual_seed(0)
    model = models.create(
        "embednet", base=models.VGG16(generator=gen),
        net_vlad=models.NetVLAD(num_clusters=8, generator=gen))
    with torch.no_grad():
        model.net_vlad.centroids.mul_(0.01)
    model = model.to(cuda_device, memory_format=torch.channels_last).eval()
    from openibl_tpu_torch.engine.pipeline import eval_view

    view = eval_view(model)
    assert view.net_vlad.fused
    rng = np.random.RandomState(6)
    hws = [(96, 128), (128, 96), (75, 128), (67, 93)]
    imgs = np.zeros((len(hws), 128, 128, 3), np.uint8)
    want = []
    with torch.no_grad():
        for j, (h, w) in enumerate(hws):
            imgs[j, :h, :w] = rng.randint(0, 256, (h, w, 3))
            x = torch.from_numpy(imgs[j:j + 1, :h, :w].copy()).to(cuda_device)
            want.append(view(x)[1])
        got = view.forward_masked(torch.from_numpy(imgs).to(cuda_device),
                                  torch.tensor(hws))[1]
    torch.testing.assert_close(got, torch.cat(want), rtol=RTOL, atol=ATOL)
