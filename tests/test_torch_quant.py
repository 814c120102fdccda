"""The PyTorch port's int8 backbone (openibl_tpu_torch/ops/quant.py) and
kernel K3's plain version (ops/quant_kernel.py) against the JAX package.

The first half repeats tests/test_quant.py on the port: fidelity to the f32
forward, the masked path, uint8 input, calibration reuse, composition,
refusals. The second half holds the port to the JAX package on the same
numpy-seeded inputs: the quantized tree and each layer's int8 output bit for
bit, the calibration within rtol 1e-5, the whole forward at the descriptor
level. The float prefix's convolutions differ from XLA's by about one ulp,
which flips a few values at the int8 boundary, and the flips spread through
the int8 layers (the conv5_3 map moves by ~2% relative), so the whole map is
not compared bit for bit; from the same boundary activations it is.

The CUDA kernel is compared with its plain version by the tests marked
``cuda``, which run only on a GPU.
"""

import io
import json
import os.path as osp
import re
import shutil
import socket
import subprocess
import sys
import time
import urllib.request
import warnings

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

from openibl_tpu_torch import models as tm  # noqa: E402
from openibl_tpu_torch.models import convert  # noqa: E402
from openibl_tpu_torch.models.vgg import VGG16_LAYERS  # noqa: E402
from openibl_tpu_torch.ops import quant as tq  # noqa: E402
from openibl_tpu_torch.ops import quant_kernel as qk  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
QUANT_LAYERS = [layer for layer in VGG16_LAYERS
                if layer[0] not in ("conv1_1", "conv1_2")]


def _jax():
    """The JAX side, imported per test: a GPU machine need not carry the JAX
    package's dependencies, and runs this file's ``cuda`` tests alone
    (pytest --noconftest -m cuda tests/test_torch_quant.py)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from openibl_tpu import models as jm
    from openibl_tpu.ops import quant as jq

    return jax, jnp, jm, jq


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_quant.py`")
    return torch.device("cuda")


def _port_embednet(params, k):
    """The port's EmbedNet (f32 VGG16, eager head) with the JAX params."""
    model = tm.create("embednet", base=tm.VGG16(),
                      net_vlad=tm.NetVLAD(num_clusters=k))
    model.load_state_dict(convert.params_from_jax(params), strict=False)
    return model.eval()


@pytest.fixture(scope="module")
def setup():
    """tests/test_quant.py's setup in both packages: an EmbedNet (f32 VGG16,
    K=8) from the JAX init, two 64x96 images, the JAX quantized tree, and
    the port's model quantized by the port from the same weights."""
    jax, jnp, jm, jq = _jax()
    jmodel = jm.create("embednet", base=jm.VGG16(compute_dtype=jnp.float32),
                       net_vlad=jm.NetVLAD(num_clusters=8))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    imgs = rng.randn(2, 64, 96, 3).astype(np.float32) * 40
    jqmodel, jqparams = jq.quantize_model_params(jmodel, params,
                                                 jnp.asarray(imgs))
    model = _port_embednet(params, 8)
    qmodel = tq.quantize_model_params(model, imgs)
    return {"jmodel": jmodel, "params": params, "jqmodel": jqmodel,
            "jqbase": jax.tree.map(np.asarray, jqparams["base"]),
            "jqparams": jqparams, "model": model, "qmodel": qmodel,
            "imgs": imgs}


def _cos(a, b):
    return (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))


# ---------------------------------------------------------------------------
# tests/test_quant.py on the port
# ---------------------------------------------------------------------------

def test_weight_quantization_per_channel(setup):
    wq = setup["qmodel"].base.conv3_1.wq
    assert wq.dtype == torch.int8
    assert tuple(wq.shape) == (256, 3, 3, 128)
    # every output channel's max |q| is 127: continuous weights hit the clip
    assert bool((wq.abs().amax(dim=(1, 2, 3)) == 127).all())


def test_fmap_fidelity(setup):
    imgs = torch.from_numpy(setup["imgs"])
    with torch.no_grad():
        f32 = setup["model"].base(imgs)[1].numpy()
        fq = setup["qmodel"].base(imgs)[1].numpy()
    rel = np.linalg.norm(f32 - fq) / np.linalg.norm(f32)
    assert rel < 0.08, rel
    assert _cos(f32, fq) > 0.995


def test_descriptor_fidelity(setup):
    imgs = torch.from_numpy(setup["imgs"])
    with torch.no_grad():
        d32 = setup["model"](imgs)[1].numpy()
        dq = setup["qmodel"](imgs)[1].numpy()
    cos = (d32 * dq).sum(-1)  # both L2-normalized
    assert np.all(cos > 0.999), cos


def test_retrieval_agreement(setup):
    """Nearest-neighbour ranking over a descriptor gallery survives int8."""
    rng = np.random.RandomState(1)
    base = rng.randn(12, 64, 96, 3).astype(np.float32) * 40
    queries = base[:4] + rng.randn(4, 64, 96, 3).astype(np.float32) * 4
    with torch.no_grad():
        out = {name: [m(torch.from_numpy(x))[1].numpy() for x in (base,
                                                                  queries)]
               for name, m in (("f32", setup["model"]),
                               ("int8", setup["qmodel"]))}
    top = {name: np.argmax(q @ g.T, axis=1) for name, (g, q) in out.items()}
    assert np.array_equal(top["f32"], np.arange(4))
    assert np.array_equal(top["int8"], top["f32"])


def test_masked_path_equals_unpadded(setup):
    """Bucket-padded quantized forward == per-image unpadded forward."""
    rng = np.random.RandomState(2)
    shapes = [(48, 64), (64, 96)]
    batch = np.zeros((2, 64, 96, 3), np.float32)
    singles = []
    for i, (h, w) in enumerate(shapes):
        img = rng.randn(h, w, 3).astype(np.float32) * 40
        batch[i, :h, :w] = img
        singles.append(img)
    base = setup["qmodel"].base
    assert base.compute_dtype == torch.float32
    with torch.no_grad():
        _, fq = base(torch.from_numpy(batch), torch.tensor(shapes))
        for i, (h, w) in enumerate(shapes):
            _, ref = base(torch.from_numpy(singles[i][None]))
            np.testing.assert_allclose(fq[i, : h // 16, : w // 16].numpy(),
                                       ref[0].numpy(), rtol=0, atol=1e-5)
            assert bool((fq[i, h // 16:] == 0).all())
            assert bool((fq[i, :, w // 16:] == 0).all())


def test_uint8_input_path(setup):
    """Raw uint8 pixels take the on-device mean subtraction."""
    from openibl_tpu_torch.data.transforms import PIXEL_MEAN

    rng = np.random.RandomState(3)
    pix = rng.randint(0, 256, (1, 64, 96, 3), dtype=np.uint8)
    norm = pix.astype(np.float32) - np.asarray(PIXEL_MEAN, np.float32)
    base = setup["qmodel"].base
    with torch.no_grad():
        a = base(torch.from_numpy(pix))[1].numpy()
        b = base(torch.from_numpy(norm))[1].numpy()
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_calibration_reuse(setup):
    """act_amax from calibrate_vgg16 reproduces quantize_vgg16's scales."""
    base = setup["model"].base
    amax = tq.calibrate_vgg16(base, setup["imgs"])
    again = tq.quantize_vgg16(base, None, act_amax=amax)
    state = setup["qmodel"].base.state()
    assert sorted(again) == sorted(state)
    for key, value in again.items():
        assert torch.equal(value, state[key]), key


def test_embednetpca_composition():
    """QuantVGG16 slots into EmbedNetPCA; NetVLAD and PCA are shared."""
    rng = np.random.RandomState(0)
    imgs = rng.randn(2, 64, 96, 3).astype(np.float32) * 40
    model = tm.create("embednetpca", base=tm.VGG16(),
                      net_vlad=tm.NetVLAD(num_clusters=8), pca_dim=32).eval()
    qmodel = tq.quantize_model_params(model, imgs)
    assert isinstance(qmodel.base, tq.QuantVGG16)
    assert isinstance(model.base, tm.VGG16)  # the f32 model is untouched
    assert qmodel.net_vlad is model.net_vlad
    assert qmodel.pca_layer is model.pca_layer
    with torch.no_grad():
        d32 = model(torch.from_numpy(imgs)).numpy()
        dq = qmodel(torch.from_numpy(imgs)).numpy()
    assert np.all((d32 * dq).sum(-1) > 0.99)


@pytest.mark.parametrize("method", ["init", "freeze", "trainable_mask"])
def test_training_entries_raise(setup, method):
    with pytest.raises(NotImplementedError):
        getattr(setup["qmodel"].base, method)()


def test_quantize_model_params_propagates_backbone_fields():
    base = tm.VGG16(cut_at_pooling=True, compute_dtype=torch.float32)
    model = tm.create("embednet", base=base,
                      net_vlad=tm.NetVLAD(num_clusters=4))
    calib = np.random.RandomState(1).randn(2, 32, 48, 3).astype(
        np.float32) * 40
    qbase = tq.quantize_model_params(model, calib).base
    assert qbase.cut_at_pooling is True
    assert qbase.feature_dim == base.feature_dim
    assert qbase.compute_dtype == torch.float32
    with torch.no_grad():
        fmap = qbase(torch.from_numpy(calib))
    assert tuple(fmap.shape) == (2, 2, 3, 512)


def test_serving_noise_calibration_warns():
    from openibl_tpu_torch.serving import RetrievalService

    rng = np.random.RandomState(0)
    g = rng.randn(8, 4096).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        svc = RetrievalService({"descriptors": g}, height=32, width=48,
                               quant_backbone=True, device="cpu")
    assert any("calib_images" in str(x.message) for x in w)
    assert isinstance(svc._model.base, tq.QuantVGG16)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_calibration_matches_jax(setup):
    _, jnp, _, jq = _jax()
    theirs = jq.calibrate_vgg16(setup["params"]["base"],
                                jnp.asarray(setup["imgs"]))
    ours = tq.calibrate_vgg16(setup["model"].base, setup["imgs"])
    assert sorted(ours) == sorted(theirs)
    for name, value in theirs.items():
        assert ours[name] == pytest.approx(value, rel=1e-5, abs=0), name


@pytest.mark.parametrize("quant_from", ["conv2_1", "conv1_1"])
def test_quantized_tree_is_bit_equal_to_jax(setup, quant_from):
    """From the same f32 weights and act_amax the port's quantized tree is
    the JAX package's, bit for bit (numpy f32 with f32-rounded scales)."""
    _, jnp, _, jq = _jax()
    amax = jq.calibrate_vgg16(setup["params"]["base"],
                              jnp.asarray(setup["imgs"]),
                              quant_from=quant_from)
    theirs = jq.quantize_vgg16(setup["params"]["base"], None,
                               quant_from=quant_from, act_amax=amax)
    ours = convert.quant_state_to_jax(tq.quantize_vgg16(
        setup["model"].base, None, quant_from=quant_from, act_amax=amax))
    assert sorted(ours) == sorted(theirs)
    for name, leaves in theirs.items():
        assert sorted(ours[name]) == sorted(leaves), name
        for leaf, value in leaves.items():
            a, b = np.asarray(value), np.asarray(ours[name][leaf])
            assert a.dtype == b.dtype and a.shape == b.shape, (name, leaf)
            assert np.array_equal(a, b), (name, leaf)


def test_state_round_trips_the_jax_tree(setup):
    state = convert.quant_state_from_jax(setup["jqbase"])
    assert state["conv2_1.wq"].shape == (128, 3, 3, 64)
    assert state["conv1_1.weight"].shape == (64, 3, 3, 3)
    back = convert.quant_state_to_jax(state)
    for name, leaves in setup["jqbase"].items():
        for leaf, value in leaves.items():
            assert np.array_equal(np.asarray(value), back[name][leaf])


def _jax_layer(jnp, lax, xq, p, relu, dtype):
    """One quantized layer as openibl_tpu/ops/quant.py:203-216 writes it."""
    acc = lax.conv_general_dilated(
        jnp.asarray(xq), p["wq"], (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    if "m" in p:
        y = acc.astype(jnp.float32) * p["m"] + p["bq"]
        return np.asarray(jnp.clip(jnp.round(y), 0 if relu else -128,
                                   127).astype(jnp.int8))
    y = (acc.astype(jnp.float32) * p["sxsw"] + p["b"]).astype(dtype)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("layer", QUANT_LAYERS, ids=lambda l: l[0])
def test_each_layer_is_bit_equal_to_jax(setup, layer):
    """Each quantized layer, from the same int8 input, through the JAX
    package's XLA int8 convolution + epilogue and through the port's
    ``int8_conv`` (the plain version on the CPU): the same bits, in f32
    and, for conv5_3's dequantized map, in bf16."""
    jax, jnp, _, _ = _jax()
    name, cin, cout, relu, _ = layer
    rng = np.random.RandomState(cin + cout)
    xq = rng.randint(-128, 128, (2, 6, 10, cin)).astype(np.int8)
    p = setup["jqbase"][name]
    state = convert.quant_state_from_jax({name: p})
    dtypes = ([(jnp.float32, torch.float32)] if "m" in p else
              [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
    for jdt, tdt in dtypes:
        theirs = _jax_layer(jnp, jax.lax, xq, p, relu, jdt)
        if "m" in p:
            ours = qk.int8_conv(torch.from_numpy(xq), state[f"{name}.wq"],
                                state[f"{name}.m"], state[f"{name}.bq"],
                                mode="requant", relu=relu)
        else:
            ours = qk.int8_conv(torch.from_numpy(xq), state[f"{name}.wq"],
                                state[f"{name}.sxsw"], state[f"{name}.b"],
                                mode="dequant", relu=relu, out_dtype=tdt)
            ours = ours.float()
        assert ours.is_contiguous()
        assert np.array_equal(ours.numpy(), theirs), (name, tdt)


def test_int8_tail_from_the_jax_boundary_is_bit_equal(setup):
    """From the JAX package's own boundary activations the port's int8
    layers (K3's plain version and the int8 pools) give the JAX conv5_3 map
    bit for bit. The boundary is computed with the JAX function's own
    eager ops (conv1_1, conv1_2, pool, quantize)."""
    jax, jnp, _, jq = _jax()
    lax, q = jax.lax, setup["jqparams"]["base"]
    x = jnp.asarray(setup["imgs"])
    for name in ("conv1_1", "conv1_2"):
        x = lax.conv_general_dilated(
            x, q[name]["w"].astype(jnp.float32), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + q[name][
                "b"].astype(jnp.float32)
        x = jnp.maximum(x, 0)
    x = lax.reduce_window(x, -jnp.inf, lax.max, (1, 2, 2, 1), (1, 2, 2, 1),
                          "VALID")
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / q["_meta"]["s_in"]),
                  -128, 127).astype(jnp.int8)
    _, theirs = jq.vgg16_apply_int8(q, jnp.asarray(setup["imgs"]),
                                    compute_dtype=jnp.float32)
    state = convert.quant_state_from_jax(setup["jqbase"])
    ours = tq.int8_layers(state, torch.from_numpy(np.array(xq)),
                          compute_dtype=torch.float32)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))


def test_whole_forward_from_the_jax_tree(setup):
    """One quantized tree, carried across by quant_state_from_jax, through
    both packages' EmbedNet: descriptors within 1e-4, cosine > 0.99999.
    (The maps are not bit-equal: see the module docstring.)"""
    jax, jnp, _, _ = _jax()
    _, theirs = jax.jit(setup["jqmodel"].apply)(setup["jqparams"],
                                                jnp.asarray(setup["imgs"]))
    theirs = np.asarray(theirs)
    qbase = tq.QuantVGG16(convert.quant_state_from_jax(setup["jqbase"]),
                          compute_dtype=torch.float32)
    model = tm.create("embednet", base=qbase,
                      net_vlad=setup["model"].net_vlad)
    with torch.no_grad():
        ours = model(torch.from_numpy(setup["imgs"]))[1].numpy()
    assert np.abs(ours - theirs).max() <= 1e-4
    assert np.all((ours * theirs).sum(-1) > 0.99999)


def test_quant_from_conv1_1_is_bit_equal_to_jax(setup):
    """quant_from="conv1_1": the boundary quantizes the images themselves
    (a true f32 division in both packages), so with no float prefix the
    whole conv5_3 map is bit-equal; conv1_1's Cin = 3 runs unpadded here
    and padded to 32 in the kernel (test_channel_padding_is_exact)."""
    jax, jnp, jm, jq = _jax()
    jbase = jq.QuantVGG16(quant_from="conv1_1", compute_dtype=jnp.float32)
    qtree = jbase.quantize(setup["params"]["base"],
                           jnp.asarray(setup["imgs"]))
    _, theirs = jq.vgg16_apply_int8(qtree, jnp.asarray(setup["imgs"]),
                                    quant_from="conv1_1",
                                    compute_dtype=jnp.float32)
    qbase = tq.QuantVGG16(
        tq.quantize_vgg16(setup["model"].base, setup["imgs"],
                          quant_from="conv1_1"),
        quant_from="conv1_1", compute_dtype=torch.float32)
    assert qbase.conv1_1.wq.shape == (64, 3, 3, 3)
    with torch.no_grad():
        _, ours = qbase(torch.from_numpy(setup["imgs"]))
    # calibrated separately (amax within 1e-5), the trees agree except
    # where a scale differs by an ulp; from the JAX tree the bits agree
    from_jax = tq.QuantVGG16(convert.quant_state_from_jax(
        jax.tree.map(np.asarray, qtree)), quant_from="conv1_1",
        compute_dtype=torch.float32)
    with torch.no_grad():
        _, exact = from_jax(torch.from_numpy(setup["imgs"]))
    assert np.array_equal(exact.numpy(), np.asarray(theirs))
    theirs = np.asarray(theirs)
    assert _cos(ours.numpy(), theirs) > 0.999


def test_fidelity_with_a_bootstrapped_netvlad_tracks_jax(setup):
    """tests/test_quant.py's descriptor gate (cosine > 0.999) is taken with
    a random NetVLAD, whose centroids outweigh the map, so every image gets
    nearly one descriptor. With centroids from conv5 clusters (as a trainer
    and chip_smoke.py initialize NetVLAD) the int8 error shows in the
    descriptor: both packages' int8-vs-f32 cosines drop (to ~0.93 here),
    and the port's track the JAX package's image by image within 5e-3."""
    jax, jnp, jm, jq = _jax()
    from openibl_tpu.models.netvlad import netvlad_init_from_clusters
    from openibl_tpu.models.vgg import vgg16_apply
    from PIL import Image

    rng = np.random.RandomState(0)
    imgs = []
    for _ in range(8):  # smooth colour fields plus noise
        gh = rng.randint(2, 12)
        small = rng.randint(0, 256, (gh, gh * 4 // 3, 3)).astype(np.uint8)
        img = np.asarray(Image.fromarray(small).resize((96, 64),
                                                       Image.BILINEAR),
                         np.int16) + rng.randint(-20, 21, (64, 96, 3))
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    imgs = np.stack(imgs)
    params = dict(setup["params"])
    _, f5 = vgg16_apply(params["base"], jnp.asarray(imgs))
    feats = np.array(f5).reshape(-1, 512)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    params["vlad"] = {k: np.asarray(v) for k, v in netvlad_init_from_clusters(
        feats[rng.choice(len(feats), 16, replace=False)], feats).items()}
    jmodel = jm.create("embednet",
                       base=jm.VGG16(compute_dtype=jnp.float32),
                       net_vlad=jm.NetVLAD(num_clusters=16))
    jqmodel, jqparams = jq.quantize_model_params(jmodel, params,
                                                 jnp.asarray(imgs[:4]))
    theirs = (np.asarray(jax.jit(jmodel.apply)(params, imgs)[1])
              * np.asarray(jax.jit(jqmodel.apply)(jqparams, imgs)[1])).sum(-1)
    model = _port_embednet(params, 16)
    qmodel = tq.quantize_model_params(model, imgs[:4])
    with torch.no_grad():
        ours = (model(torch.from_numpy(imgs))[1]
                * qmodel(torch.from_numpy(imgs))[1]).sum(-1).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=5e-3)


def test_channel_padding_is_exact():
    """The kernel's zero channels (Cin 3 → 32) change no sum."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randint(-128, 128, (1, 5, 7, 3)).astype(
        np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (64, 3, 3, 3)).astype(
        np.int8))
    scale = torch.from_numpy(rng.rand(64).astype(np.float32) * 1e-2)
    bias = torch.from_numpy(rng.randn(64).astype(np.float32))
    a = qk.int8_conv_plain(x, wq, scale, bias)
    b = qk.int8_conv_plain(qk._pad_channels(x, 32), qk._pad_channels(wq, 32),
                           scale, bias)
    assert torch.equal(a, b)


def test_plain_version_rounds_ties_to_even_and_clamps():
    """acc * m + bq exactly at .5 rounds half to even (rintf, jnp.round);
    the clamp is [0, 127] with ReLU, [-128, 127] without."""
    x = torch.zeros((1, 3, 3, 32), dtype=torch.int8)
    x[0, 1, 1, 0] = 1  # one tap: acc = the centre weight
    wq = torch.zeros((64, 3, 3, 32), dtype=torch.int8)
    wq[:6, 1, 1, 0] = torch.tensor([1, 3, 5, -1, -3, 100], dtype=torch.int8)
    scale = torch.full((64,), 0.5)
    bias = torch.zeros(64)
    bias[5] = 80.0  # 100 * 0.5 + 80 = 130 → 127
    out = qk.int8_conv_plain(x, wq, scale, bias, relu=False)[0, 1, 1, :6]
    assert out.tolist() == [0, 2, 2, -0, -2, 127]
    out = qk.int8_conv_plain(x, wq, scale, bias, relu=True)[0, 1, 1, :6]
    assert out.tolist() == [0, 2, 2, 0, 0, 127]
    bias[3] = -300.0
    out = qk.int8_conv_plain(x, wq, scale, bias, relu=False)[0, 1, 1, 3]
    assert int(out) == -128


def test_cpu_launches_nothing_and_refusals():
    x = torch.zeros((1, 4, 4, 32), dtype=torch.int8)
    wq = torch.zeros((64, 3, 3, 32), dtype=torch.int8)
    v = torch.zeros(64)
    before = qk.int8_conv.launches
    qk.int8_conv(x, wq, v, v)
    assert qk.int8_conv.launches == before
    with pytest.raises(ValueError, match="mode"):
        qk.int8_conv(x, wq, v, v, mode="fused")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        qk.int8_conv(x, wq, v, v, mode="dequant", out_dtype=torch.float16)
    # the kernel's own checks, refused before any build
    with pytest.raises(ValueError, match="multiple of 64"):
        qk._launch(x, wq[:48], v[:48], v[:48], "requant", True,
                   torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        qk._launch(x.transpose(1, 2), wq, v, v, "requant", True,
                   torch.float32)
    with pytest.raises(ValueError, match="int8"):
        qk._launch(x.float(), wq, v, v, "requant", True, torch.float32)
    # a geometry that does not cover the shape, or whose shared memory is
    # not the one it takes
    geo = qk.conv_geometry(1, 4, 4, 32, 64, 132)
    with pytest.raises(ValueError, match="do not cover"):
        qk._launch(x, wq, v, v, "requant", True, torch.float32,
                   geometry=geo._replace(tiles_y=geo.tiles_y - 1))
    with pytest.raises(ValueError, match="do not cover"):
        qk._launch(x, wq, v, v, "requant", True, torch.float32,
                   geometry=geo._replace(tiles_x=geo.tiles_x + 1))
    with pytest.raises(ValueError, match="smem_bytes"):
        qk._launch(x, wq, v, v, "requant", True, torch.float32,
                   geometry=geo._replace(smem_bytes=geo.smem_bytes + 16))
    with pytest.raises(ValueError, match="blocks"):
        qk._launch(x, wq, v, v, "requant", True, torch.float32,
                   geometry=geo._replace(blocks=geo.blocks + 1))


def _source():
    with open(osp.join(ROOT, "openibl_tpu_torch", "csrc",
                       "quant_conv.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name, value", [
    ("kMinCin", qk.CIN_ALIGN), ("kMaxCin", qk.MAX_CIN),
    ("kMinStages", qk.MIN_STAGES), ("kMaxStages", qk.MAX_STAGES),
    ("kMaxSmem", qk.SMEM_BYTES),
    ("kSmemAlign", qk.SMEM_ALIGN), ("kBarBytes", qk.BARRIER_BYTES),
    ("kScaleBytes", qk.SCALE_BYTES), ("kHaloW", qk.HALO_W),
    ("kHaloSlots", qk.HALO_SLOTS)])
def test_constants_match_the_source(name, value):
    src = _source()
    assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == \
        str(value)
    assert f"cout % {qk.COUT_ALIGN} != 0" in src


@pytest.mark.parametrize("what, line", [
    ("BK", "one_of(bk, {}, {}, {})".format(*sorted(qk.BLOCK_K))),
    ("BN", "one_of(bn, {}, {}, {})".format(*sorted(qk.BLOCK_N))),
    ("stage bytes", "kSmemAlign + halo * kHaloSlots * halo_slot_bytes(th, "
                    "bk) + stages * ((1 - halo) * th * tw + bn) * bk + (1 + "
                    "pp) * (th * tw * bn * out_bytes(mode) + bn * "
                    "kScaleBytes) + (stages + halo * kHaloSlots) * "
                    "kBarBytes"),
    ("pingpong", "(pp && (rows != 128 || bn > 128))"),
    ("halo slot", "(kHaloW * (th + 2) * bk + kSmemAlign - 1) / kSmemAlign * "
                  "kSmemAlign"),
    ("halo mode", "(halo && (tw != 8 || bk != 128))")])
def test_geometry_rules_match_the_source(what, line):
    """The C entry's BK and BN choices, its halo-mode rule and its
    shared-memory formula are the ones conv_geometry / conv_smem_bytes /
    check_geometry use."""
    assert line in " ".join(_source().split()), what


# the fewest padded pixels any tile of qk.TILES leaves on each layer's map
# of a 480x640 and a 32x48 input, counted by hand: 60x80 pads to 64x80
# (8x16 or 16x8), 30x40 to 32x40 (16x8), 8x12 to 8x16, 4x6 and 2x3 to one
# 64-pixel tile; the rest tile exactly
HAND_WASTE = {(480, 640): 0, (240, 320): 0, (120, 160): 0, (60, 80): 320,
              (30, 40): 80, (32, 48): 0, (16, 24): 0, (8, 12): 32,
              (4, 6): 40, (2, 3): 58}


def _layer_maps(h, w):
    """(name, h, w, Cin padded, Cout, output bytes) of every K3 launch of a
    quant_from="conv1_1" forward (conv1_1 and conv2_1..conv5_3)."""
    out = []
    for name, cin, cout, _, pool in VGG16_LAYERS:
        if name != "conv1_2":
            out.append((name, h, w, -(-cin // qk.CIN_ALIGN) * qk.CIN_ALIGN,
                        cout, 4 if name == "conv5_3" else 1))
        if pool:
            h, w = h // 2, w // 2
    return out


@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("hw", [(480, 640), (32, 48)])
def test_conv_geometry_covers_each_layer(hw, n):
    """At every layer's map: the tile covers the map (no empty tile row or
    column), with the least waste any tile could give; the shared memory
    fits 227 KB and is the source's formula; the grid is at most one block
    an SM (the C entry's one block a tile when not persistent); halo mode
    only where it applies; the C entry's checks pass."""
    for name, h, w, cin, cout, nb in _layer_maps(*hw):
        geo = qk.conv_geometry(n, h, w, cin, cout, 132, nb)
        assert geo.tiles_y * geo.th >= h > (geo.tiles_y - 1) * geo.th, name
        assert geo.tiles_x * geo.tw >= w > (geo.tiles_x - 1) * geo.tw, name
        pad = geo.tiles_y * geo.th * geo.tiles_x * geo.tw - h * w
        assert pad == HAND_WASTE[h, w], (name, geo)
        assert geo.smem_bytes <= 227 * 1024
        assert geo.smem_bytes == qk.conv_smem_bytes(
            geo.th, geo.tw, geo.bn, geo.bk, geo.halo, geo.pingpong,
            geo.stages, nb)
        assert geo.bk == min(cin, 128) and cout % geo.bn == 0
        assert not geo.halo or (geo.tw == 8 and geo.bk == 128)
        assert not geo.pingpong or (geo.th * geo.tw == 128
                                    and geo.bn <= 128)
        tiles = n * geo.tiles_y * geo.tiles_x * (cout // geo.bn)
        assert geo.blocks == min(tiles, 132)
        qk.check_geometry(geo, n, h, w, cin, cout, nb)
        one_a_tile = qk.conv_geometry(n, h, w, cin, cout, 132, nb,
                                      persistent=False)
        assert one_a_tile == geo._replace(blocks=tiles)
        qk.check_geometry(one_a_tile, n, h, w, cin, cout, nb)


def test_conv_geometry_fills_a_small_grid():
    """The served query's conv5 map (batch 1, 30x40, Cout 512): more
    blocks than tiles of the widest BN would give, so that more SMs work."""
    one = qk.conv_geometry(1, 30, 40, 512, 512, 132)
    assert one.bn < 256 or one.th * one.tw == 64
    assert one.blocks > 512 // 256 * -(-30 // 16) * -(-40 // 8)


def test_conv_geometry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="cin"):
        qk.conv_geometry(1, 8, 8, 48, 64, 132)
    with pytest.raises(ValueError, match="cout"):
        qk.conv_geometry(1, 8, 8, 32, 96, 132)
    with pytest.raises(ValueError, match="empty"):
        qk.conv_geometry(1, 0, 8, 32, 64, 132)


def test_modules_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import openibl_tpu_torch.ops.quant, openibl_tpu_torch.serving\n"
        "import openibl_tpu_torch.models.convert\n"
        "assert not any(m == 'openibl_tpu' or m.startswith('openibl_tpu.')\n"
        "               for m in sys.modules), 'JAX package imported'\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def service_world(tmp_path_factory):
    """JAX-init weights as a .npz (centroids shrunk as in
    tests/test_torch_serving.py, so images get distinct descriptors), a
    16-row gallery, calibration frames and queries at 32x48."""
    jax, _, _, _ = _jax()
    from openibl_tpu.hub import vgg16_netvlad as jax_hub
    from openibl_tpu.utils.checkpoint import save_checkpoint

    _, params = jax_hub(None)
    params["vlad"]["centroids"] = params["vlad"]["centroids"] * 0.01
    wdir = tmp_path_factory.mktemp("w")
    weights = str(wdir / "model.npz")
    save_checkpoint(weights, params)
    rng = np.random.RandomState(7)
    gallery = rng.randn(16, 4096).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    tmp = tmp_path_factory.mktemp("cli")
    yield {"weights": weights, "gallery": gallery,
           "calib": rng.randint(0, 256, (4, 32, 48, 3)).astype(np.uint8),
           "queries": rng.randint(0, 256, (3, 32, 48, 3)).astype(np.uint8),
           "tmp": tmp}
    for path in (wdir, tmp):  # the full-width .npz is ~0.6 GB
        shutil.rmtree(path, ignore_errors=True)


def test_quant_service_ranks_like_the_jax_quant_service(service_world):
    """RetrievalService(quant_backbone=True) in both packages, same weights
    and calib_images: the same top-5, up to ties. The two descriptors differ
    by the int8 flips of each package's own float prefix and calibration
    (see the module docstring), which at 32x48 (a 2x3 conv5 map) moves the
    sq-dists by up to ~6e-4; rows closer than 1e-3 count as tied."""
    from openibl_tpu.serving import RetrievalService as JaxService
    from openibl_tpu_torch.serving import RetrievalService

    w = service_world
    index = {"descriptors": w["gallery"]}
    kw = dict(weights=w["weights"], height=32, width=48, batch_buckets=(4,),
              quant_backbone=True, calib_images=w["calib"])
    ours = RetrievalService(index, device="cpu", **kw)
    theirs = JaxService(index, **kw)
    assert ours._model.base.conv4_2.wq.dtype == torch.int8
    a = ours.query(list(w["queries"]), topk=5)
    b = theirs.query(list(w["queries"]), topk=5)
    tie = 1e-3
    for ra, rb in zip(a, b):
        da = np.array([m["sq_dist"] for m in ra])
        db = np.array([m["sq_dist"] for m in rb])
        np.testing.assert_allclose(da, db, rtol=0, atol=tie)
        for pos, (ma, mb) in enumerate(zip(ra, rb)):
            if ma["index"] != mb["index"]:  # a swap: must be a tie
                near = [m["index"] for m in rb
                        if abs(m["sq_dist"] - ma["sq_dist"]) < tie]
                assert ma["index"] in near or pos == 4, (ra, rb)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_torch_cli_quant_backbone(service_world):
    """examples/serve_torch.py --quant-backbone on the CPU: it warns about
    the noise calibration, serves /healthz and a query over HTTP."""
    w = service_world
    index = str(w["tmp"] / "index.npz")
    np.savez(index, descriptors=w["gallery"],
             paths=np.array([f"g{i}.jpg" for i in range(16)]))
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, osp.join(ROOT, "examples", "serve_torch.py"), index,
         "--weights", w["weights"], "--height", "32", "--width", "48",
         "--port", str(port), "--quant-backbone", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 240
        while True:
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()[1]
                assert time.time() < deadline, "the server did not start"
                time.sleep(0.5)
        assert health == {"ok": True, "index_size": 16}
        buf = io.BytesIO()
        Image.fromarray(w["queries"][0]).save(buf, format="PNG")
        req = urllib.request.Request(base + "/query?topk=3",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            matches = json.loads(r.read())["matches"]
        assert [m["rank"] for m in matches] == [1, 2, 3]
        assert all(m["path"] == f"g{m['index']}.jpg" for m in matches)
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=60)
    assert "calib_images" in err  # the noise-calibration warning


# ---------------------------------------------------------------------------
# the CUDA kernel (GPU only)
# ---------------------------------------------------------------------------

def _layer_inputs(gen, dev, n, h, w, cin, cout):
    x = torch.randint(-128, 128, (n, h, w, cin), generator=gen, device=dev,
                      dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, 3, 3, cin), generator=gen,
                       device=dev, dtype=torch.int8)
    # acc ~ 1e5: scales that put the requantized values across [-128, 127]
    scale = torch.rand((cout,), generator=gen, device=dev) * 2e-3
    bias = torch.randn((cout,), generator=gen, device=dev) * 20
    return x, wq, scale, bias


_MODE_CASES = [("requant", False, torch.int8),
               ("dequant", False, torch.float32),
               ("dequant", True, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [*QUANT_LAYERS, ("conv1_1", 3, 64, True,
                                                   False)],
                         ids=lambda l: f"{l[0]}-{l[1]}")
@pytest.mark.parametrize("hw", [(12, 20), (7, 13), (30, 40), (60, 80),
                                (17, 129)])
@pytest.mark.parametrize("n", [1, 2])
def test_cuda_kernel_is_bit_equal_to_plain(layer, hw, n, cuda_device):
    name, cin, cout, relu, _ = layer
    g = torch.Generator(device=cuda_device).manual_seed(cin * 7 + cout)
    x, wq, scale, bias = _layer_inputs(g, cuda_device, n, *hw, cin, cout)
    for mode, r, dt in [("requant", relu, torch.int8), *_MODE_CASES]:
        kw = dict(mode=mode, relu=r, out_dtype=dt)
        out = qk.int8_conv(x, wq, scale, bias, **kw)
        again = qk.int8_conv(x, wq, scale, bias, **kw)
        ref = qk.int8_conv_plain(x, wq, scale, bias, **kw)
        torch.cuda.synchronize()
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert torch.equal(out, ref), (name, mode, r, dt)
        assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", qk.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("bn", qk.BLOCK_N)
@pytest.mark.parametrize("bk", qk.BLOCK_K)
def test_cuda_kernel_forced_geometries(tile, bn, bk, cuda_device):
    """Each tile, BN and BK the chooser can return, forced, in tap mode and
    (TW 8, BK 128) halo mode, with and without pingpong (128 pixels, BN
    128 or 64), at a ragged map (Cin 128 takes every BK, Cout 256 every
    BN), one block a tile and a persistent grid of 5 blocks (several tiles
    a block, both pingpong warpgroups), in every output mode: bit for bit.
    A geometry whose shared memory does not fit (BN 256, 128 pixels, f32
    out) is refused."""
    th, tw = tile
    n, h, w, cin, cout = 2, 19, 37, 128, 256
    g = torch.Generator(device=cuda_device).manual_seed(th * 1000 + bn + bk)
    x, wq, scale, bias = _layer_inputs(g, cuda_device, n, h, w, cin, cout)
    ty, tx = -(-h // th), -(-w // tw)
    tiles = n * ty * tx * (cout // bn)
    halos = (0, 1) if tw == 8 and bk == 128 else (0,)
    pps = (0, 1) if th * tw == 128 and bn <= 128 else (0,)
    for mode, r, dt in _MODE_CASES:
        nb = qk.out_bytes(mode, dt)
        ref = qk.int8_conv_plain(x, wq, scale, bias, mode=mode, relu=r,
                                 out_dtype=dt)
        for halo, pp in [(a, b) for a in halos for b in pps]:
            stages = qk.conv_stages(th, tw, bn, bk, halo, pp, nb)
            if stages is None:
                least = qk.MIN_STAGES
                geo = qk.ConvGeometry(th, tw, ty, tx, bn, bk, halo, pp,
                                      least, tiles, qk.conv_smem_bytes(
                                          th, tw, bn, bk, halo, pp, least,
                                          nb))
                with pytest.raises(ValueError, match="smem_bytes"):
                    qk._launch(x, wq, scale, bias, mode, r, dt,
                               geometry=geo)
                continue
            for blocks in (tiles, 5):
                geo = qk.ConvGeometry(th, tw, ty, tx, bn, bk, halo, pp,
                                      stages, blocks, qk.conv_smem_bytes(
                                          th, tw, bn, bk, halo, pp, stages,
                                          nb))
                before = qk.int8_conv.launches
                out = qk._launch(x, wq, scale, bias, mode, r, dt,
                                 geometry=geo)
                torch.cuda.synchronize()
                assert qk.int8_conv.launches == before + 1
                assert torch.equal(out, ref), (geo, mode, dt)


@pytest.mark.cuda
def test_cuda_quantized_model_matches_the_cpu(cuda_device):
    """The quantized EmbedNet on the card (K3, K1) against the same model on
    the CPU (plain versions): descriptors within 1e-4, cosine > 0.99999."""
    rng = np.random.RandomState(0)
    imgs = rng.randn(2, 64, 96, 3).astype(np.float32) * 40
    model = tm.create("embednet", base=tm.VGG16(),
                      net_vlad=tm.NetVLAD(num_clusters=8)).eval()
    cpu = tq.quantize_model_params(model, imgs)
    state = {k: v.clone() for k, v in cpu.base.state().items()}
    qbase = tq.QuantVGG16(state, compute_dtype=torch.float32).to(cuda_device)
    gpu = tm.create("embednet", base=qbase,
                    net_vlad=tm.NetVLAD(num_clusters=8, fused=True))
    gpu.net_vlad.load_state_dict(model.net_vlad.state_dict())
    gpu = gpu.to(cuda_device)
    before = qk.int8_conv.launches
    with torch.no_grad():
        a = cpu(torch.from_numpy(imgs))[1].numpy()
        b = gpu(torch.from_numpy(imgs).to(cuda_device))[1].cpu().numpy()
    assert qk.int8_conv.launches - before == 11  # conv2_1 .. conv5_3
    assert np.abs(a - b).max() <= 1e-4
    assert np.all((a * b).sum(-1) > 0.99999)
