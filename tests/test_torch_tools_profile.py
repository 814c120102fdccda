"""The port's profiling tools against the JAX package on the CPU:
tools/profile_head.py's five pieces against the JAX functions the JAX
script times (N=2, a 6x5 map, C=32, K=8, the same numpy parameters),
tools/profile_backbone.py's MAC table and prefixes against the JAX
script's (a prefix in f32 on parameters converted from the JAX
initializer), and tools/profile_phases.py's JSON line against the JAX
script's keys and the phases the JAX pipeline times.
"""

import ast
import inspect
import os.path as osp
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from openibl_tpu_torch.models.convert import vgg16_state_from_jax  # noqa: E402
from openibl_tpu_torch.models.vgg import VGG16  # noqa: E402
from openibl_tpu_torch.tools import (  # noqa: E402
    profile_backbone, profile_head, profile_phases)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5  # the JAX package's f32 head gate


def _head_inputs(seed=0, n=2, h=6, w=5, c=32, k=8, out=64):
    rng = np.random.RandomState(seed)
    fmap = rng.randn(n, h, w, c).astype(np.float32)
    vp = {"assign_w": (rng.randn(c, k) * 2).astype(np.float32),
          "centroids": rng.randn(k, c).astype(np.float32)}
    pp = {"w": (rng.randn(k * c, out) / np.sqrt(k * c)).astype(np.float32),
          "b": (rng.randn(out) * 0.01).astype(np.float32)}
    desc = rng.randn(n, k * c).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return fmap, vp, pp, desc


def _bf16(a):
    """f32 values rounded to bf16, as f32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _jax_pieces(vp, pp):
    """The JAX script's pieces (scripts/profile_head.py), un-summed; its
    DEFAULT piece on bf16-rounded operands (the TPU's one bf16 pass)."""
    from openibl_tpu.models.netvlad import (
        netvlad_apply, pca_layer_apply, vlad_postprocess)
    from openibl_tpu.ops.netvlad_kernel import netvlad_descriptor_fused

    jvp = {k: jnp.asarray(v) for k, v in vp.items()}
    jpp = {k: jnp.asarray(v) for k, v in pp.items()}

    def pca(d, w, prec):
        y = jnp.dot(jnp.asarray(d), jnp.asarray(w), precision=prec) + jpp["b"]
        return y / jnp.linalg.norm(y, axis=1, keepdims=True)

    return {
        "netvlad_fused": lambda f: netvlad_descriptor_fused(
            jvp, jnp.asarray(f)),
        "netvlad_xla": lambda f: vlad_postprocess(
            netvlad_apply(jvp, jnp.asarray(f))),
        "pca_highest": lambda d: pca_layer_apply(jpp, jnp.asarray(d)),
        "pca_default": lambda d: pca(_bf16(d), _bf16(pp["w"]), "default"),
        "pca_high": lambda d: pca(d, pp["w"], "high"),
    }


@pytest.mark.parametrize("piece", ["netvlad_fused", "netvlad_xla",
                                   "pca_highest", "pca_default", "pca_high"])
def test_head_piece_matches_jax(piece):
    fmap, vp, pp, desc = _head_inputs()
    ours = profile_head.head_pieces(
        {k: torch.from_numpy(v) for k, v in vp.items()},
        {k: torch.from_numpy(v) for k, v in pp.items()})[piece]
    theirs = _jax_pieces(vp, pp)[piece]
    x = fmap if piece.startswith("netvlad") else desc
    with torch.inference_mode():
        got = ours(torch.from_numpy(x)).numpy()
    want = np.asarray(theirs(x)).reshape(got.shape)
    assert got.dtype == np.float32 and got.shape[0] == 2
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_head_pieces_restore_the_matmul_flag():
    _, vp, pp, desc = _head_inputs()
    pieces = profile_head.head_pieces(
        {k: torch.from_numpy(v) for k, v in vp.items()},
        {k: torch.from_numpy(v) for k, v in pp.items()})
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        for setting in (False, True):
            flags.allow_tf32 = setting
            for name in ("pca_highest", "pca_high", "pca_default"):
                pieces[name](torch.from_numpy(desc))
                assert flags.allow_tf32 is setting, name
    finally:
        flags.allow_tf32 = before


def test_head_main_emits_the_jax_keys():
    out = profile_head.main(["--batch", "1", "--iters", "1", "--device",
                             "cpu"])
    assert list(out) == ["batch", "device", "netvlad_fused", "netvlad_xla",
                         "pca_highest", "pca_default", "pca_high"]
    assert out["device"] == "cpu" and out["batch"] == 1
    assert all(out[k] > 0 for k in list(out)[2:])


def _jax_layer_macs(height, width):
    """scripts/profile_backbone.py's per-image MAC loop, over the JAX
    package's layer table."""
    from openibl_tpu.models.vgg import VGG16_LAYERS

    h, w = height, width
    macs = []
    for name, cin, cout, _, pool in VGG16_LAYERS:
        macs.append(h * w * 9 * cin * cout)
        if pool:
            h, w = h // 2, w // 2
    return macs


@pytest.mark.parametrize("hw", [(480, 640), (32, 48), (33, 47)])
def test_mac_table_matches_jax(hw):
    assert profile_backbone.layer_macs(*hw) == _jax_layer_macs(*hw)


def _jax_prefix(params, images, upto):
    """scripts/profile_backbone.py's prefix_apply in f32, without its sum."""
    from jax import lax

    from openibl_tpu.models.vgg import _CONV_DN, VGG16_LAYERS

    x = jnp.asarray(images)
    for name, _, _, relu, pool in VGG16_LAYERS[:upto]:
        p = params[name]
        x = lax.conv_general_dilated(x, p["w"], (1, 1), "SAME",
                                     dimension_numbers=_CONV_DN) + p["b"]
        if relu:
            x = jnp.maximum(x, 0)
        if pool:
            x = lax.reduce_window(x, -jnp.inf, lax.max, (1, 2, 2, 1),
                                  (1, 2, 2, 1), "VALID")
    return np.asarray(x)


@pytest.mark.parametrize("upto", [1, 4, 13])
def test_prefix_matches_jax(upto):
    from openibl_tpu.models.vgg import init_vgg16_params

    params = init_vgg16_params(jax.random.PRNGKey(0))
    base = VGG16()
    base.load_state_dict(vgg16_state_from_jax(params))
    images = (np.random.RandomState(1).randn(2, 32, 48, 3) * 40).astype(
        np.float32)
    with torch.inference_mode():
        got = profile_backbone.vgg16_prefix(base, upto, torch.float32)(
            torch.from_numpy(images)).permute(0, 2, 3, 1).numpy()
        if upto == 13:  # the whole stack is the model's own forward
            _, fmap = base(torch.from_numpy(images))
            np.testing.assert_array_equal(got, fmap.numpy())
    want = _jax_prefix(params, images, upto)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def _json_keys_of(path):
    """The keys of the dict literal the script prints with json.dumps."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no json.dumps dict in {path}")


def test_phases_match_the_jax_script_and_pipeline():
    from openibl_tpu.engine import pipeline as jpipe

    out = profile_phases.main(["--device", "cpu"])
    script = osp.join(ROOT, "scripts", "profile_phases.py")
    assert list(out) == _json_keys_of(script)
    assert out["backend"] == "cpu" and out["image_hw"] == [32, 48]
    assert out["hbm"] is None and out["trace_dir"] is None
    src = inspect.getsource(jpipe.run_baseline_training)
    jax_phases = set(re.findall(r'timer\.phase\("(\w+)"\)', src))
    assert set(out["phases"]) == jax_phases
    assert all(p["seconds"] >= 0 and p["count"] >= 1
               for p in out["phases"].values())
