"""Kernel K1 (fused NetVLAD head) of the PyTorch port against the JAX package.

On the CPU the port's wrapper takes its plain version; that version is held
to the JAX Pallas kernel (interpret mode) and the JAX XLA head at the JAX
package's own tolerances (tests/test_pallas_kernel.py: forward rtol 1e-4 /
atol 1e-5, gradient rtol 1e-3). The kernel's split-precision arithmetic,
emulated in plain PyTorch, is held to the plain head, the JAX XLA head and
f64. The CUDA kernel itself is compared with the plain version and with the
emulation by the tests marked ``cuda``, which run only on a GPU.
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


def _gate_ratio(out, ref, rtol=1e-4, atol=1e-5):
    """max |out - ref| / (atol + rtol |ref|): at most 1 passes the gate."""
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())


def _small(dtype, seed=5):
    """The split-precision size: N=2, a 6x5 map, C=32, K=8."""
    fmap, w, cent = _inputs(seed, n=2, h=6, w=5, c=32, k=8)
    return torch.from_numpy(fmap).to(getattr(torch, dtype)), \
        torch.from_numpy(w), torch.from_numpy(cent)


@pytest.mark.parametrize("normalize_input", [True, False])
@pytest.mark.parametrize("postprocess", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_meets_the_gate(dtype, postprocess, normalize_input):
    """The kernel's split-precision arithmetic (3 TF32 products for an f32
    fmap, 3 bf16 ones for bf16) stays within rtol 1e-4 / atol 1e-5 of the
    plain head."""
    fmap, w, cent = _small(dtype)
    if not normalize_input:
        fmap = (fmap.float() * 0.1).to(fmap.dtype)  # see the JAX test above
    out = nk.netvlad_split_emulation(fmap, w, cent, normalize_input,
                                     postprocess)
    ref = nk.netvlad_plain(fmap, w, cent, normalize_input, postprocess)
    assert out.shape == ref.shape == (2, 8, 32)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k", [17, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_holds_at_four_channels(dtype, k):
    """C=4 is the hard case: the sums of a^T x and (sum_p a) * centroids
    nearly cancel, and the plain f32 head itself is far from exact there.
    Over ten seeds and a ragged 30x41 map the split scheme stays within
    the gate."""
    worst = 0.0
    for seed in range(10):
        rng = np.random.RandomState(100 + seed)
        fmap = torch.from_numpy(rng.randn(2, 30, 41, 4).astype(np.float32))
        fmap = fmap.to(getattr(torch, dtype))
        w = torch.from_numpy((rng.randn(4, k) * 2).astype(np.float32))
        cent = torch.from_numpy(rng.rand(k, 4).astype(np.float32))
        ref = nk.netvlad_plain(fmap, w, cent)
        worst = max(worst, _gate_ratio(
            nk.netvlad_split_emulation(fmap, w, cent), ref))
    assert worst < 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_pass_tf32_misses_the_gate(dtype):
    """One TF32 product per product (the operands rounded once) misses the
    gate by far: the reason the kernel splits its f32 operands."""
    fmap, w, cent = _small(dtype)
    ref = nk.netvlad_plain(fmap, w, cent)
    single = nk.netvlad_split_emulation(fmap, w, cent, single_pass=True)
    split = nk.netvlad_split_emulation(fmap, w, cent)
    assert _gate_ratio(single, ref) > 5
    assert _gate_ratio(split, ref) < 0.5


def test_split_parts():
    """TF32 keeps the top 10 mantissa bits: masked (as the core reads an
    operand) or rounded to nearest (the hi part). hi + lo carries ~21 bits
    in TF32; three bf16 parts carry ~24."""
    v = torch.from_numpy(np.random.RandomState(6).randn(4096)
                         .astype(np.float32))
    for fn, bits in ((nk._tf32, 10), (nk._tf32_rna, 11)):
        t = fn(v)
        assert torch.all((t.view(torch.int32) & 8191) == 0)
        assert float(((v - t).abs() / v.abs()).max()) <= 2.0 ** -bits
    for kind, n, bits in (("tf32", 2, 20), ("bf16", 3, 22)):
        parts = nk._split(v, kind)
        assert len(parts) == n
        assert float(((v - sum(parts)).abs() / v.abs()).max()) < 2.0 ** -bits


def test_scratch_fits_eight_megabytes():
    """At the main path's (16, 30x40, 512) with K=64 the kernel's scratch is
    the soft-assignment a, the row norms and per-tile sums: under 8 MB,
    against ~80 MB of per-tile partials before."""
    assert nk.scratch_bytes(16, 1200, 512, 64) == \
        4 * (16 * 1200 * 65 + 16 * 64 * 8)
    assert nk.scratch_bytes(16, 1200, 512, 64) <= 8 * 2 ** 20
    assert nk.scratch_bytes(1, 10, 4, 17) == 4 * (10 * 21 + 17)


@pytest.mark.parametrize("name, value", [("kTileC", nk.TILE_C),
                                         ("kMaxK", nk.MAX_CLUSTERS)])
def test_constants_match_the_source(name, value):
    """The wrapper's copies of csrc/netvlad.cu's constants (the scratch
    layout and the K limit) are the source's."""
    import os.path as osp
    import re

    from openibl_tpu_torch.ops import _build

    with open(osp.join(_build.CSRC, "netvlad.cu")) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    assert found == [str(value)]


def _jax_xla_head(fmap, w, cent, normalize_input=True, postprocess=False):
    """The JAX package's XLA head (f32) on the same values as numpy."""
    _, jnp, jnv, _ = _jax()
    params = {"assign_w": jnp.asarray(w.numpy()),
              "centroids": jnp.asarray(cent.numpy())}
    vlad = jnv.netvlad_apply(params, jnp.asarray(fmap.float().numpy()),
                             normalize_input=normalize_input)
    if postprocess:
        vlad = jnv.vlad_postprocess(vlad).reshape(vlad.shape)
    return torch.from_numpy(np.array(vlad))


def _head_f64(fmap, w, cent):
    """The head (row norm on, no postprocess) in f64 on the same values."""
    x = fmap.double().reshape(fmap.shape[0], -1, fmap.shape[-1])
    x = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    a = torch.softmax(x @ w.double(), dim=-1)
    return a.transpose(1, 2) @ x - a.sum(dim=1)[:, :, None] * cent.double()


@pytest.mark.parametrize("normalize_input", [True, False])
@pytest.mark.parametrize("postprocess", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_matches_jax_xla_head(dtype, postprocess,
                                              normalize_input):
    """The split scheme against the JAX package's XLA head, at the gate."""
    fmap, w, cent = _small(dtype)
    if not normalize_input:
        fmap = (fmap.float() * 0.1).to(fmap.dtype)  # see the JAX test above
    out = nk.netvlad_split_emulation(fmap, w, cent, normalize_input,
                                     postprocess)
    ref = _jax_xla_head(fmap, w, cent, normalize_input, postprocess)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k", [17, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_and_jax_head_at_four_channels(dtype, k):
    """At C=4 (the ten seeds of the test above) both the split scheme and
    the JAX XLA head are held to the head in f64, at the gate, and the
    scheme is no further from it than the JAX head is. The two are not held
    to each other: f32 sums that nearly cancel put each up to ~0.9 of the
    gate from f64, on opposite sides (seed 102, K=17, f32: 1.19 of the gate
    apart, the scheme 0.30 and the JAX head 0.89 from f64)."""
    worst_split = worst_jax = 0.0
    for seed in range(10):
        rng = np.random.RandomState(100 + seed)
        fmap = torch.from_numpy(rng.randn(2, 30, 41, 4).astype(np.float32))
        fmap = fmap.to(getattr(torch, dtype))
        w = torch.from_numpy((rng.randn(4, k) * 2).astype(np.float32))
        cent = torch.from_numpy(rng.rand(k, 4).astype(np.float32))
        ref = _head_f64(fmap, w, cent)
        worst_split = max(worst_split, _gate_ratio(
            nk.netvlad_split_emulation(fmap, w, cent).double(), ref))
        worst_jax = max(worst_jax, _gate_ratio(
            _jax_xla_head(fmap, w, cent).double(), ref))
    assert worst_jax < 1
    assert worst_split <= worst_jax


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 17, 64, 256])
@pytest.mark.parametrize("c", [4, 512])
def test_cuda_kernel_shapes_and_repeatable_bits(c, k, dtype, cuda_device):
    """Ragged P (7x9 and 30x41 maps), K in {1, 17, 64, 256}, C in {4, 512}:
    within the gate of the plain head, and a second run gives the same
    bits (no atomics, fixed reduction orders)."""
    g = torch.Generator(device=cuda_device).manual_seed(k + c)
    w = torch.randn((c, k), generator=g, device=cuda_device) * 2
    cent = torch.rand((k, c), generator=g, device=cuda_device)
    for h, wd in ((7, 9), (30, 41)):
        fmap = torch.randn((2, h, wd, c), generator=g, device=cuda_device)
        fmap = fmap.to(getattr(torch, dtype))
        for post in (False, True):
            out = nk.netvlad_fused(fmap, w, cent, postprocess=post)
            again = nk.netvlad_fused(fmap, w, cent, postprocess=post)
            ref = nk.netvlad_plain(fmap, w, cent, postprocess=post)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
            assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, k, within", [((16, 30, 40, 512), 64, 0.1),
                                              ((2, 30, 41, 4), 17, 0.5)])
def test_cuda_kernel_tracks_the_split_emulation(shape, k, within, dtype,
                                                cuda_device):
    """The kernel against its arithmetic run in plain PyTorch (products
    exact in f64) on the card, well inside the gate: a tenth of it at the
    main path's shape, half at C=4, where the sums cancel and the kernel's
    f32 sums of the products show."""
    g = torch.Generator(device=cuda_device).manual_seed(k)
    fmap = torch.randn(shape, generator=g, device=cuda_device)
    fmap = fmap.to(getattr(torch, dtype))
    w = torch.randn((shape[-1], k), generator=g, device=cuda_device) * 2
    cent = torch.rand((k, shape[-1]), generator=g, device=cuda_device)
    for post in (False, True):
        out = nk.netvlad_fused(fmap, w, cent, postprocess=post)
        emu = nk.netvlad_split_emulation(fmap, w, cent, postprocess=post)
        ratio = _gate_ratio(out, emu)
        assert ratio < within, (post, ratio)


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
