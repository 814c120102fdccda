"""Kernel K5 (openibl_tpu_torch/ops/linear_kernel.py, csrc/linear_f32.cu): the
f32 linear layer x W^T + b in split TF32 with its bias fused, which
models/dinov2.py sends every ViT linear to on the card.

On the CPU: the plain version is today's ``F.linear`` bit for bit (and the
ViT's CPU forward reads the same bits as ``nn.Linear``); the split
arithmetic, emulated in PyTorch, is f32-accurate where plain TF32 is not;
the weights' split is cached per version and rebuilt after an in-place
update or ``load_state_dict``, and dies with its weight; the routing rule
sends only gradient-free f32 CUDA linears; the wrapper and the geometry
refuse what the kernel does not take; the Python copies of the source's
constants match the source; a forward of the published ViT-g/14 on the
``meta`` device routes 125 linears (4 a block x 31 + the facet's value).

Tolerance of the split (``SPLIT_TOL``): as K4's, every output within 2e-6
of the f64 product, relative to that output's sum of |x| * |w| + |b|.

The CUDA kernel is held to the f64 product, and to cuBLAS's f32 GEMM there,
by the tests marked ``cuda``, which run only on a GPU (``pytest
--noconftest -m cuda tests/test_torch_linear_kernel.py``); this file
imports no JAX.
"""

import gc
import os.path as osp
import re

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from openibl_tpu_torch.models import dinov2  # noqa: E402
from openibl_tpu_torch.ops import linear_kernel as lk  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SPLIT_TOL = 2e-6
# (name, K, N) of the ViT-g/14's linears at width 1536, SwiGLU hidden 4096
VIT_LINEARS = (("qkv", 1536, 4608), ("proj", 1536, 1536),
               ("w12", 1536, 8192), ("w3", 4096, 1536),
               ("facet_value", 1536, 1536))


def _inputs(gen, m, k, n, device="cpu"):
    """Activations N(0, 1), a weight N(0, 0.02) (DINOv2's init) and a
    bias N(0, 0.02)."""
    x = torch.randn(m, k, generator=gen)
    w = torch.randn(n, k, generator=gen) * 0.02
    b = torch.randn(n, generator=gen) * 0.02
    return x.to(device), w.to(device), b.to(device)


def _split_error(y, x, w, b):
    """max over outputs of |y - f64 product| / (sum of |x| * |w| + |b|)."""
    ref = F.linear(x.double(), w.double(), b.double())
    scale = F.linear(x.double().abs(), w.double().abs(), b.double().abs())
    return float(((y.double() - ref).abs() / scale).max())


class _OnCard:
    """A CPU tensor that the routing rule sees as a CUDA tensor."""

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return True if name == "is_cuda" else getattr(self.t, name)


# ---------------------------------------------------------------------------
# the plain version and the CPU path
# ---------------------------------------------------------------------------

def test_plain_version_is_todays_linear():
    g = torch.Generator().manual_seed(1)
    x, w, b = _inputs(g, 6, 64, 128)
    x = x.reshape(2, 3, 64)
    before = lk.linear_f32.launches
    got = lk.linear_f32(x, w, b)
    assert torch.equal(got, F.linear(x, w, b)) and got.shape == (2, 3, 128)
    assert torch.equal(lk.linear_plain(x, w, b), got)
    layer = dinov2.Linear(64, 128)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
        assert torch.equal(layer(x), F.linear(x, w, b))
    assert lk.linear_f32.launches == before  # the CPU launches nothing


# ---------------------------------------------------------------------------
# the split arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1536, 4096])
def test_split_emulation_is_f32_accurate_and_tf32_is_not(k):
    g = torch.Generator().manual_seed(k)
    x, w, b = _inputs(g, 8, k, 128)
    split = lk.linear_split_emulation(x, w, b)
    assert split.dtype == torch.float32 and split.shape == (8, 128)
    err = _split_error(split, x, w, b)
    assert err <= SPLIT_TOL
    # plain TF32 reads ~2.4e-5 (K 4096) to ~3.6e-5 (K 1536) on these
    # inputs, the split ~3e-8: three orders of magnitude apart
    tf32 = F.linear(lk.tf32_split(x)[0], lk.tf32_split(w)[0], b)
    tf32_err = _split_error(tf32, x, w, b)
    assert tf32_err > 5 * SPLIT_TOL and tf32_err > 100 * err


# ---------------------------------------------------------------------------
# the weights' split, once per version
# ---------------------------------------------------------------------------

def _expected_parts(weight):
    n, k = weight.shape
    w = weight.detach().reshape(n, k // 32, 32)[..., list(lk.K_ORDER)]
    return lk.tf32_split(w.reshape(n, k))


def test_weight_split_is_cached_and_rebuilt_per_version():
    layer = torch.nn.Linear(64, 128)
    hi, lo = lk.split_weight(layer.weight)
    want = _expected_parts(layer.weight)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    assert hi.shape == lo.shape == (128, 64) and hi.is_contiguous()
    assert lk.split_weight(layer.weight)[0] is hi  # cached
    with torch.no_grad():
        layer.weight.mul_(2.0)  # in place: a new version
    hi2, _ = lk.split_weight(layer.weight)
    assert hi2 is not hi and torch.equal(hi2, 2 * hi)
    other = torch.nn.Linear(64, 128)
    layer.load_state_dict(other.state_dict())
    hi3, lo3 = lk.split_weight(layer.weight)
    want = _expected_parts(other.weight)
    assert torch.equal(hi3, want[0]) and torch.equal(lo3, want[1])
    assert lk.split_weight(layer.weight)[0] is hi3


def test_weight_split_cache_dies_with_its_weight():
    weight = torch.randn(128, 32)
    lk.split_weight(weight)
    key = id(weight)
    assert key in lk._SPLITS
    del weight
    gc.collect()
    assert key not in lk._SPLITS


# ---------------------------------------------------------------------------
# where the kernel engages, and what it refuses
# ---------------------------------------------------------------------------

def test_takes_sends_only_f32_no_grad_cuda_linears():
    x = torch.zeros(2, 5, 64)
    w, b = torch.zeros(128, 64), torch.zeros(128)
    assert lk.takes(_OnCard(x), w, b)
    assert not lk.takes(x, w, b)  # the CPU
    assert not lk.takes(_OnCard(x), w, None)  # no bias
    assert not lk.takes(_OnCard(x.bfloat16()), w.bfloat16(), b.bfloat16())
    assert not lk.takes(_OnCard(x.double()), w.double(), b.double())
    assert not lk.takes(_OnCard(torch.zeros(2, 48)), torch.zeros(128, 48),
                        b)  # K not a multiple of 32
    assert not lk.takes(_OnCard(x), torch.zeros(64, 64),
                        torch.zeros(64))  # N not a multiple of 128
    trained = w.clone().requires_grad_()
    assert not lk.takes(_OnCard(x), trained, b)  # a gradient is needed
    assert not lk.takes(_OnCard(x), w, b.clone().requires_grad_())
    assert not lk.takes(_OnCard(x.clone().requires_grad_()), w, b)
    with torch.no_grad():
        assert lk.takes(_OnCard(x), trained, b)
    with torch.inference_mode():
        assert lk.takes(_OnCard(x), trained, b)


@pytest.mark.parametrize("args, what", [
    ((torch.zeros(4, 64, dtype=torch.float64), torch.zeros(128, 64),
      torch.zeros(128)), "float32"),
    ((torch.zeros(4, 64), torch.zeros(128, 32), torch.zeros(128)),
     "weight must be"),
    ((torch.zeros(4, 64), torch.zeros(128, 64), torch.zeros(64)),
     "bias must be"),
    ((torch.zeros(4, 64), torch.zeros(128, 64), None), "bias must be"),
    ((torch.zeros(4, 48), torch.zeros(128, 48), torch.zeros(128)),
     "multiple of 32"),
    ((torch.zeros(4, 64), torch.zeros(192, 64), torch.zeros(192)),
     "of 128"),
], ids=["dtype", "weight", "bias", "no-bias", "k", "n"])
def test_wrapper_refuses_what_the_kernel_does_not_take(args, what):
    before = lk.linear_f32.launches
    with pytest.raises(ValueError, match=what):
        lk._launch(*args)
    assert lk.linear_f32.launches == before


def test_no_kernel_off_the_cpu_and_cuda():
    x, w, b = (torch.zeros(4, 64, device="meta"),
               torch.zeros(128, 64, device="meta"),
               torch.zeros(128, device="meta"))
    with pytest.raises(ValueError, match="no f32 linear kernel"):
        lk.linear_f32(x, w, b)


def test_linear_blocks_one_an_sm_or_one_a_tile():
    for m in (1, 1530, 1531, 24480, 24496):
        for name, k, n in VIT_LINEARS:
            tiles = -(-m // 128) * (n // 128)
            assert lk.linear_blocks(m, n, 132) == min(tiles, 132)
    assert lk.linear_blocks(24496, 8192, 132) == 132  # 12,288 tiles
    assert lk.linear_blocks(1, 1536, 132) == 12


def test_published_forward_routes_125_linears(monkeypatch):
    """The ViT-g/14 at its published widths, to block 31's value facet, at
    476 x 630 on the ``meta`` device (no memory, no arithmetic), with the
    CPU taken for the card: every linear of a forward goes to the kernel,
    4 a block and the facet's value rows."""
    calls = []

    def launch(x, weight, bias):
        calls.append(tuple(weight.shape))
        return F.linear(x, weight, bias)

    monkeypatch.setattr(dinov2, "takes",
                        lambda x, w, b: lk.takes(_OnCard(x), w, b))
    monkeypatch.setattr(dinov2, "linear_f32", launch)
    with torch.device("meta"):
        model = dinov2.DINOv2Facet()
        images = torch.empty(1, 3, 476, 630)
    with torch.no_grad():
        model.facet(model.tokens(images)[:, 1:])
    assert len(calls) == 4 * 31 + 1 == 125
    assert calls[:4] == [(4608, 1536), (1536, 1536), (8192, 1536),
                         (1536, 4096)]
    assert calls[-1] == (1536, 1536)
    del calls[:]
    # a forward that needs a gradient keeps F.linear
    model.facet.value(torch.empty(1, 3, 1536, device="meta"))
    assert not calls


# ---------------------------------------------------------------------------
# the source
# ---------------------------------------------------------------------------

def _source():
    with open(osp.join(ROOT, "openibl_tpu_torch", "csrc",
                       "linear_f32.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name, value", [
    ("kBK", lk.K_ALIGN), ("kBN", lk.N_ALIGN), ("kBM", lk.TILE_ROWS)])
def test_constants_match_the_source(name, value):
    src = _source()
    assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == \
        str(value)


@pytest.mark.parametrize("what, line", [
    ("shape", "k % kBK != 0 || n < kBN || n % kBN != 0"),
    ("grid", "blocks < 1 || blocks > tiles"),
    ("split", "cvt.rna.tf32.f32"),
    ("wgmma", "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32")])
def test_rules_match_the_source(what, line):
    assert line in " ".join(_source().split()), what


# ---------------------------------------------------------------------------
# the CUDA kernel (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_linear_kernel.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("name, k, n", VIT_LINEARS,
                         ids=[v[0] for v in VIT_LINEARS])
def test_cuda_vit_shapes_against_f64(name, k, n, batch, cuda_device):
    """Each ViT linear at AnyLoc's token rows (1531 an image, the facet's
    1530): K5 within SPLIT_TOL of f64 and no worse there than cuBLAS's f32
    GEMM, the same bits on a second run, and the same bits on a grid of 7
    blocks (each walking many tiles)."""
    from openibl_tpu_torch.utils import f32_precision

    m = batch * (1530 if name == "facet_value" else 1531)
    g = torch.Generator().manual_seed(k + n + batch)
    x, w, b = _inputs(g, m, k, n, cuda_device)
    before = lk.linear_f32.launches
    y = lk.linear_f32(x, w, b)
    again = lk.linear_f32(x, w, b)
    with f32_precision():
        plain = lk.linear_plain(x, w, b)
    torch.cuda.synchronize()
    assert lk.linear_f32.launches == before + 2
    assert y.shape == (m, n) and torch.equal(y, again)
    err, cublas = _split_error(y, x, w, b), _split_error(plain, x, w, b)
    assert err <= SPLIT_TOL, err
    assert err <= cublas, (err, cublas)
    few = lk._launch(x, w, b, blocks=7)
    torch.cuda.synchronize()
    assert torch.equal(few, y)


@pytest.mark.cuda
def test_cuda_ragged_rows_and_leading_dims(cuda_device):
    """Rows past a tile's end are neither read nor written: a (3, 37, K)
    input gives what its rows give one by one, and the kernel writes
    nothing past its output."""
    g = torch.Generator().manual_seed(5)
    x, w, b = _inputs(g, 3 * 37, 256, 384, cuda_device)
    x = x.reshape(3, 37, 256)
    y = lk.linear_f32(x, w, b)
    torch.cuda.synchronize()
    assert y.shape == (3, 37, 384)
    assert _split_error(y.reshape(-1, 384), x.reshape(-1, 256), w, b) <= \
        SPLIT_TOL
    for i in (0, 36):
        one = lk.linear_f32(x[1, i:i + 1].contiguous(), w, b)
        assert torch.allclose(one[0], y[1, i], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_weight_update_rebuilds_the_split(cuda_device):
    g = torch.Generator().manual_seed(6)
    x, w, b = _inputs(g, 200, 128, 256, cuda_device)
    y = lk.linear_f32(x, w, b)
    with torch.no_grad():
        w.mul_(-1.0)
    y2 = lk.linear_f32(x, w, b)
    torch.cuda.synchronize()
    assert torch.allclose(y2 - b, -(y - b), rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_vit_forward_launches_and_matches_plain(cuda_device):
    """A 31-block ViT at width 128 on the card: 125 launches a forward,
    and the facet within the split tolerance of the F.linear forward."""
    from openibl_tpu_torch.utils import f32_precision

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    model = dinov2.build_facet(cuda_device, generator=gen, embed_dim=128,
                               num_heads=2, ffn_hidden=128)
    images = torch.randn(2, 3, 56, 70, generator=gen, device=cuda_device)
    before = lk.linear_f32.launches
    with torch.no_grad(), f32_precision():
        facet = model.facet(model.tokens(images)[:, 1:])
        assert lk.linear_f32.launches == before + 125
        with torch.enable_grad():  # the parameters need a gradient
            plain = model.facet(model.tokens(images)[:, 1:]).detach()
    torch.cuda.synchronize()
    assert lk.linear_f32.launches == before + 125
    assert float((facet - plain).abs().max()) <= 1e-4 * float(
        plain.abs().max())
