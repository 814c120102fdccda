"""Kernel K1 (fused NetVLAD head) of the PyTorch port against the JAX package.

On the CPU the port's wrapper takes its plain version; that version is held
to the JAX Pallas kernel (interpret mode) and the JAX XLA head at the JAX
package's own tolerances (tests/test_pallas_kernel.py: forward rtol 1e-4 /
atol 1e-5, gradient rtol 1e-3). The CUDA kernel itself is compared with the
plain version by the test marked ``cuda``, which runs only on a GPU.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch.ops import netvlad_kernel as nk  # noqa: E402


def _jax():
    """The JAX side, imported per test: a GPU machine need not carry the JAX
    package's dependencies, and runs this file's ``cuda`` tests alone
    (pytest --noconftest -m cuda tests/test_torch_netvlad_kernel.py)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from openibl_tpu.models import netvlad
    from openibl_tpu.ops.netvlad_kernel import netvlad_fused

    return jax, jnp, netvlad, netvlad_fused


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_netvlad_kernel.py`")
    return torch.device("cuda")


def _inputs(seed, n=2, h=8, w=16, c=256, k=8):
    rng = np.random.RandomState(seed)
    fmap = rng.randn(n, h, w, c).astype(np.float32)
    assign_w = (rng.randn(c, k) * 2).astype(np.float32)
    centroids = rng.randn(k, c).astype(np.float32)
    return fmap, assign_w, centroids


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("normalize_input", [True, False])
@pytest.mark.parametrize("postprocess", [False, True])
def test_plain_head_matches_jax_fused_and_xla(normalize_input, postprocess):
    fmap, w, cent = _inputs(0)
    if not normalize_input:
        # raw rows of norm ~16 against assign_w ~N(0, 4) give logits of
        # ~±60, where a last-bit difference in a logit moves the softmax
        # by ~1e-5: scale the map so both stacks see a well-conditioned
        # softmax, as unit-norm rows give it
        fmap = fmap * np.float32(0.1)
    _, jnp, jnv, jax_fused = _jax()
    out = nk.netvlad_fused(*_t(fmap, w, cent),
                           normalize_input=normalize_input,
                           postprocess=postprocess).numpy()
    ref_fused = np.asarray(jax_fused(
        jnp.asarray(fmap), jnp.asarray(w), jnp.asarray(cent),
        normalize_input=normalize_input, postprocess=postprocess,
        interpret=True))
    params = {"assign_w": jnp.asarray(w), "centroids": jnp.asarray(cent)}
    ref_xla = jnv.netvlad_apply(params, jnp.asarray(fmap),
                                normalize_input=normalize_input)
    if postprocess:
        ref_xla = jnv.vlad_postprocess(ref_xla).reshape(ref_xla.shape)
    assert out.shape == (2, 8, 256) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref_fused, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(ref_xla), rtol=1e-4, atol=1e-5)


def test_cpu_launches_nothing():
    fmap, w, cent = _inputs(1, n=1)
    before = nk.netvlad_fused.launches
    nk.netvlad_fused(*_t(fmap, w, cent), postprocess=True)
    assert nk.netvlad_fused.launches == before


def _jax_grads(fmap, w, cent):
    jax, jnp, _, jax_fused = _jax()

    def loss(fm, aw):
        return jnp.sum(jax_fused(fm, aw, jnp.asarray(cent),
                                 interpret=True) ** 2)

    gf, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(fmap), jnp.asarray(w))
    return np.asarray(gf), np.asarray(gw)


def test_gradient_matches_jax():
    fmap, w, cent = _inputs(2, n=1, h=8, w=8, k=4)
    tf, tw, tc = _t(fmap, w, cent)
    tf.requires_grad_(True)
    tw.requires_grad_(True)
    torch.sum(nk.netvlad_fused(tf, tw, tc) ** 2).backward()
    gf, gw = _jax_grads(fmap, w, cent)
    np.testing.assert_allclose(tw.grad.numpy(), gw, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(), gf, rtol=1e-3, atol=1e-4)


def test_autograd_function_backward_routes_through_plain(monkeypatch):
    """The Function's backward (used on CUDA) recomputes through the plain
    head; checked here with the launch stood in by the plain forward."""
    monkeypatch.setattr(nk, "_launch", lambda *a: nk.netvlad_plain(*a))
    fmap, w, cent = _inputs(3, n=1, h=8, w=8, k=4)
    tf, tw, tc = _t(fmap, w, cent)
    tf.requires_grad_(True)
    tw.requires_grad_(True)
    out = nk._NetVLADFused.apply(tf, tw, tc, True, False)
    torch.sum(out ** 2).backward()
    assert tc.grad is None
    gf, gw = _jax_grads(fmap, w, cent)
    np.testing.assert_allclose(tw.grad.numpy(), gw, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(), gf, rtol=1e-3, atol=1e-4)


def test_imports_without_nvcc_or_triton(tmp_path):
    """The kernel module imports (and builds nothing) with no nvcc on PATH
    and triton unimportable; the build raises only when a launch asks."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import openibl_tpu_torch.ops.netvlad_kernel as nk\n"
        "from openibl_tpu_torch.ops import _build\n"
        "import os.path as osp\n"
        "assert nk.netvlad_fused.launches == 0\n"
        "try:\n"
        "    _build.find_nvcc()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc not found' in str(e)\n"
        "else:\n"
        "    assert osp.isfile(_build.find_nvcc())\n"
        "print('ok')\n"
    )
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path),
           "PYTHONPATH": ":".join(sys.path)}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype, cuda_device):
    """The CUDA kernel against its plain version on the card, at the main
    path's shape (16 images, 30x40 conv5 map, C=512, K=64)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fmap = torch.randn((16, 30, 40, 512), generator=g, device=cuda_device)
    fmap = fmap.to(getattr(torch, dtype))
    w = torch.randn((512, 64), generator=g, device=cuda_device) * 2
    cent = torch.randn((64, 512), generator=g, device=cuda_device)
    for post in (False, True):
        before = nk.netvlad_fused.launches
        out = nk.netvlad_fused(fmap, w, cent, postprocess=post)
        torch.cuda.synchronize()
        assert nk.netvlad_fused.launches == before + 1
        ref = nk.netvlad_plain(fmap, w, cent, postprocess=post)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    # with gradients asked for, the kernel runs under the autograd Function
    # and the backward goes through the plain head: the same upstream
    # gradient must give the plain head's gradients
    up = torch.randn((16, 64, 512), generator=g, device=cuda_device)
    w.requires_grad_(True)
    torch.sum(nk.netvlad_fused(fmap, w, cent, postprocess=True) * up).backward()
    w_ref = w.detach().clone().requires_grad_(True)
    torch.sum(nk.netvlad_plain(fmap, w_ref, cent, postprocess=True)
              * up).backward()
    torch.testing.assert_close(w.grad, w_ref.grad, rtol=1e-3, atol=1e-4)
