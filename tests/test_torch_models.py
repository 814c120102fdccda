"""Models, weight conversion and checkpoint loading of the PyTorch port
against the JAX package, on the same numpy-made inputs and parameters.

Tolerance for unit-norm descriptors: atol 1e-4. The two stacks sum the 13
convolutions (and the head's products) in different orders in f32, which
moves unit-norm descriptor entries by ~1e-6..1e-5; 1e-4 leaves an order of
magnitude of room while still catching any layout or formula slip, which
moves entries by ~1e-2.
"""

import functools
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openibl_tpu import models as jmodels  # noqa: E402
from openibl_tpu.hub import vgg16_netvlad as jax_hub  # noqa: E402
from openibl_tpu.models.vgg import vgg16_apply  # noqa: E402
from openibl_tpu.utils.checkpoint import save_checkpoint  # noqa: E402
from openibl_tpu_torch import models  # noqa: E402
from openibl_tpu_torch.hub import vgg16_netvlad  # noqa: E402
from openibl_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax, vgg16_state_from_jax,
)
from openibl_tpu_torch.utils.checkpoint import load_npz_tree  # noqa: E402

K, PCA_DIM = 4, 16


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends: the checkpoints
    written here run to hundreds of MB, and pytest would keep them."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_pca_model():
    model = jmodels.create("embednetpca",
                           net_vlad=jmodels.NetVLAD(num_clusters=K),
                           pca_dim=PCA_DIM)
    return model, _np_tree(model.init(jax.random.PRNGKey(0)))


def _port_model(params, name="embednetpca"):
    kw = {"net_vlad": models.NetVLAD(num_clusters=K)}
    if name == "embednetpca":
        kw["pca_dim"] = PCA_DIM
    model = models.create(name, **kw)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.eval()


def _images(seed, dtype=np.uint8, n=2):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (n, 32, 48, 3)).astype(np.uint8)
    return (rng.randn(n, 32, 48, 3) * 40).astype(np.float32)


def test_registry_names():
    # the JAX package's names, and the port's own AnyLoc model
    assert models.names() == ["anyloc_dinov2_vitg14", "embednet",
                              "embednetpca", "embedregionnet", "netvlad",
                              "vgg16"]
    assert [n for n in models.names() if n != "anyloc_dinov2_vitg14"] \
        == jmodels.names()
    with pytest.raises(KeyError):
        models.create("resnet50")


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_vgg16_matches_jax(dtype, jax_pca_model):
    _, params = jax_pca_model
    images = _images(1, dtype)
    jpool, jfmap = vgg16_apply(params["base"], jnp.asarray(images))
    vgg = models.create("vgg16")
    vgg.load_state_dict(vgg16_state_from_jax(params["base"]))
    with torch.no_grad():
        pool, fmap = vgg(torch.from_numpy(images))
    assert fmap.shape == (2, 2, 3, 512) and fmap.is_contiguous()
    scale = float(np.abs(np.asarray(jfmap)).max())
    np.testing.assert_allclose(fmap.numpy(), np.asarray(jfmap),
                               rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(pool.numpy(), np.asarray(jpool),
                               rtol=1e-4, atol=1e-5 * scale)


def test_vgg16_floors_odd_sizes_like_jax(jax_pca_model):
    _, params = jax_pca_model
    images = np.random.RandomState(2).randint(
        0, 256, (1, 35, 50, 3)).astype(np.uint8)
    _, jfmap = vgg16_apply(params["base"], jnp.asarray(images))
    vgg = models.create("vgg16")
    vgg.load_state_dict(vgg16_state_from_jax(params["base"]))
    with torch.no_grad():
        _, fmap = vgg(torch.from_numpy(images))
    assert tuple(fmap.shape) == tuple(jfmap.shape) == (1, 2, 3, 512)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_embednet_matches_jax(dtype, jax_pca_model):
    _, params = jax_pca_model
    jax_model = jmodels.create("embednet",
                               net_vlad=jmodels.NetVLAD(num_clusters=K))
    sub = {"base": params["base"], "vlad": params["vlad"]}
    images = _images(3, dtype)
    jpool, jdesc = jax_model.apply(sub, jnp.asarray(images))
    model = _port_model(sub, "embednet")
    with torch.no_grad():
        pool, desc = model(torch.from_numpy(images))
    assert desc.shape == (2, K * 512)
    np.testing.assert_allclose(desc.numpy(), np.asarray(jdesc), atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(desc.numpy(), axis=1), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_embednetpca_matches_jax(dtype, jax_pca_model):
    jax_model, params = jax_pca_model
    images = _images(4, dtype)
    jdesc = np.asarray(jax_model.apply(params, jnp.asarray(images)))
    model = _port_model(params)
    with torch.no_grad():
        desc = model(torch.from_numpy(images)).numpy()
    assert desc.shape == (2, PCA_DIM)
    np.testing.assert_allclose(desc, jdesc, atol=1e-4)


def test_bf16_compute_tracks_jax_bf16(jax_pca_model):
    """bf16 rounds at other places in the two stacks: compare descriptors
    by cosine, the measure the JAX package's bf16 tests use."""
    import dataclasses

    jax_model, params = jax_pca_model
    jbf = dataclasses.replace(
        jax_model, base=dataclasses.replace(jax_model.base,
                                            compute_dtype=jnp.bfloat16))
    images = _images(5)
    jdesc = np.asarray(jbf.apply(params, jnp.asarray(images)))
    model = _port_model(params)
    model.base.compute_dtype = torch.bfloat16
    with torch.no_grad():
        desc = model(torch.from_numpy(images)).numpy()
    cos = np.sum(desc * jdesc, axis=1)
    assert np.all(cos > 0.99), cos


@pytest.mark.parametrize("pipeline", [False, True])
def test_npz_checkpoint_round_trips_exactly(pipeline, jax_pca_model,
                                            tmp_path):
    _, params = jax_pca_model
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, {"params": params} if pipeline else params,
                    metadata={"epoch": 3})
    tree, meta, is_pipeline = load_npz_tree(path)
    assert is_pipeline == pipeline and meta == {"epoch": 3}
    model = models.create("embednetpca",
                          net_vlad=models.NetVLAD(num_clusters=K),
                          pca_dim=PCA_DIM)
    model.load_state_dict(params_from_jax(tree), strict=True)
    sd = model.state_dict()
    for name, p in params["base"].items():
        np.testing.assert_array_equal(
            sd[f"base.{name}.weight"].numpy().transpose(2, 3, 1, 0), p["w"])
        np.testing.assert_array_equal(sd[f"base.{name}.bias"].numpy(),
                                      p["b"])
    for ours, theirs in (("net_vlad.assign_w", params["vlad"]["assign_w"]),
                         ("net_vlad.centroids", params["vlad"]["centroids"]),
                         ("pca_layer.w", params["pca"]["w"]),
                         ("pca_layer.b", params["pca"]["b"])):
        np.testing.assert_array_equal(sd[ours].numpy(), theirs)


def test_hub_npz_matches_jax_hub(jax_pca_model, tmp_path):
    _, params = jax_pca_model
    path = str(tmp_path / "model.npz")
    save_checkpoint(path, params)
    images = _images(6)
    jm, jp = jax_hub(path, num_clusters=K, pca_dim=PCA_DIM)
    jdesc = np.asarray(jm.apply(jp, jnp.asarray(images)))
    model = vgg16_netvlad(path, num_clusters=K, pca_dim=PCA_DIM,
                          device="cpu")
    assert not model.training and not model.net_vlad.fused
    with torch.no_grad():
        desc = model(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(desc, jdesc, atol=1e-4)


def test_hub_fails_loudly_like_jax(jax_pca_model, tmp_path):
    """A checkpoint of another architecture, and a trainer checkpoint with
    no PCA file, raise in both stacks instead of serving random weights."""
    _, params = jax_pca_model
    wrong = str(tmp_path / "wrong.npz")
    save_checkpoint(wrong, params)
    port_hub = functools.partial(vgg16_netvlad, device="cpu")
    for hub in (jax_hub, port_hub):
        with pytest.raises(ValueError, match="did not provide"):
            hub(wrong, num_clusters=8, pca_dim=PCA_DIM)
    trainer = str(tmp_path / "trainer.npz")
    save_checkpoint(trainer, {"params": {"base": params["base"],
                                         "vlad": params["vlad"]}})
    for hub in (jax_hub, port_hub):
        with pytest.raises(ValueError, match="PCA"):
            hub(trainer, num_clusters=K, pca_dim=PCA_DIM)


def _released_state(rng, k=K, pca_dim=32):
    """State dict in the released checkpoint's key layout."""
    sd = {}
    cfg = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
           (10, 128, 256), (12, 256, 256), (14, 256, 256),
           (17, 256, 512), (19, 512, 512), (21, 512, 512),
           (24, 512, 512), (26, 512, 512), (28, 512, 512)]
    for idx, cin, cout in cfg:
        sd[f"base_model.base.{idx}.weight"] = torch.from_numpy(
            rng.randn(cout, cin, 3, 3).astype(np.float32) * 0.05)
        sd[f"base_model.base.{idx}.bias"] = torch.from_numpy(
            rng.randn(cout).astype(np.float32) * 0.05)
    sd["net_vlad.conv.weight"] = torch.from_numpy(
        rng.randn(k, 512, 1, 1).astype(np.float32))
    sd["net_vlad.centroids"] = torch.from_numpy(
        rng.randn(k, 512).astype(np.float32))
    sd["pca_layer.weight"] = torch.from_numpy(
        rng.randn(pca_dim, k * 512, 1, 1).astype(np.float32) * 0.01)
    sd["pca_layer.bias"] = torch.from_numpy(
        rng.randn(pca_dim).astype(np.float32) * 0.01)
    return sd


@pytest.mark.parametrize("wrapped", [False, True])
def test_reference_pth_gives_same_descriptors_in_both_stacks(wrapped,
                                                             tmp_path):
    rng = np.random.RandomState(7)
    sd = _released_state(rng)
    path = str(tmp_path / "vgg16_netvlad.pth")
    if wrapped:  # reference full training checkpoint, numpy metadata
        sd = {"state_dict": {f"module.{k}": v for k, v in sd.items()},
              "epoch": 3, "best_recall5": np.float64(0.5)}
    torch.save(sd, path)
    images = (rng.randn(2, 32, 48, 3) * 40).astype(np.float32)
    jm, jp = jax_hub(path, num_clusters=K, pca_dim=32)
    jdesc = np.asarray(jm.apply(jp, jnp.asarray(images)))
    model = vgg16_netvlad(path, num_clusters=K, pca_dim=32, device="cpu")
    with torch.no_grad():
        desc = model(torch.from_numpy(images)).numpy()
    assert desc.shape == (2, 32)
    np.testing.assert_allclose(desc, jdesc, atol=1e-4)
