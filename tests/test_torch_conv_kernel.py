"""Kernel K4 (openibl_tpu_torch/ops/conv_kernel.py, csrc/conv_f32.cu): the f32
3x3 convolution in split TF32 with its bias and ReLU fused.

On the CPU: the plain version is today's ``F.conv2d`` + bias + ``F.relu``
bit for bit (and the CPU forwards that do not take the kernel read the same
bits as before); the split arithmetic, emulated in PyTorch, is f32-accurate
where plain TF32 is not; the launch geometry covers every layer the kernel
takes and refuses what it does not; the callers' rule sends bf16, CPU and
grad-requiring convolutions to the old path and conv1_1 (Cin 3, padded to
32 with zeros, exactly) to the kernel (launches per forward 13 / 10 / 2);
the weights' split is rebuilt after an in-place update and after
``load_state_dict``; the Python copies of the source's constants match the
source.

Tolerance of the split (``SPLIT_TOL``): every output within 2e-6 of an f64
convolution, relative to that output's sum of |x| * |w| + |b|. An operand
split into two TF32 parts errs at most 2^-22 of itself and the dropped
lo * lo term is below 2^-22 of the product, so a product errs below
~3 * 2^-22 = 7.2e-7 of |x * w|; the emulation and f32 itself read ~2.6e-7
on these shapes. Plain TF32 (one product, 2^-11 an operand) reads ~3e-5 to
1.3e-4: over 15x the tolerance.

The CUDA kernel is held to the f64 convolution and to its plain version by
the tests marked ``cuda``, which run only on a GPU (``pytest --noconftest
-m cuda tests/test_torch_conv_kernel.py``); this file imports no JAX.
"""

import gc
import os.path as osp
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from openibl_tpu_torch.models import vgg as tv  # noqa: E402
from openibl_tpu_torch.models.vgg import VGG16, VGG16_LAYERS  # noqa: E402
from openibl_tpu_torch.ops import conv_kernel as ck  # noqa: E402
from openibl_tpu_torch.ops import quant as tq  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SPLIT_TOL = 2e-6


def _inputs(gen, n, h, w, cin, cout, device="cpu"):
    """A post-ReLU activation map, a Kaiming-scaled weight and a bias."""
    x = torch.relu(torch.randn(n, h, w, cin, generator=gen)) * 2
    wt = torch.randn(cout, cin, 3, 3, generator=gen) * (2 / (9 * cin)) ** 0.5
    b = torch.randn(cout, generator=gen) * 0.1
    return x.to(device), wt.to(device), b.to(device)


def _reference(x, wt, b, relu):
    """(the f64 convolution + bias, ReLU'd if asked; its outputs' sums of
    |x| * |w| + |b|)."""
    def conv(a, k, c):
        return F.conv2d(a.double().permute(0, 3, 1, 2), k.double(),
                        c.double(), padding=1).permute(0, 2, 3, 1)

    ref = conv(x, wt, b)
    return (ref.clamp_min(0) if relu else ref), conv(x.abs(), wt.abs(),
                                                     b.abs())


def _split_error(y, x, wt, b, relu):
    """max over outputs of |y - f64 conv| / (sum of |x| * |w| + |b|)."""
    ref, scale = _reference(x, wt, b, relu)
    return float(((y.double() - ref).abs() / scale).max())


# ---------------------------------------------------------------------------
# the plain version and the CPU path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("relu", [True, False])
def test_plain_version_is_todays_arithmetic(relu):
    g = torch.Generator().manual_seed(1)
    x, wt, b = _inputs(g, 2, 7, 11, 64, 128)
    xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    want = F.conv2d(xc, wt, b, padding=1)
    if relu:
        want = F.relu(want)
    got = ck.conv3x3_plain(x, wt, b, relu=relu)
    assert got.is_contiguous() and got.shape == (2, 7, 11, 128)
    assert torch.equal(got, want.permute(0, 2, 3, 1))
    before = ck.conv3x3_f32.launches
    assert torch.equal(ck.conv3x3_f32(x, wt, b, relu=relu), got)
    assert ck.conv3x3_f32.launches == before  # the CPU launches nothing


def _forward_as_before(model, images):
    """VGG16.forward as it read before the kernel: F.conv2d + F.relu on
    the channels_last NCHW view for every layer."""
    x = images.float().permute(0, 3, 1, 2)
    for name, _, _, relu, pool in VGG16_LAYERS:
        conv = getattr(model, name)
        x = F.conv2d(x, conv.weight, conv.bias, padding=1)
        if relu:
            x = F.relu(x)
        if pool:
            x = F.max_pool2d(x, 2, 2)
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def test_cpu_forward_reads_the_same_bits_as_before():
    model = VGG16().eval()
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(2, 32, 48, 3).astype(np.float32))
    before = ck.conv3x3_f32.launches
    with torch.no_grad():
        _, fmap = model(images)
        want = _forward_as_before(model, images)
    assert torch.equal(fmap, want)
    assert ck.conv3x3_f32.launches == before


# ---------------------------------------------------------------------------
# the split arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 9, 13, 64, 64), (1, 7, 11, 512, 64),
                                   (2, 12, 10, 128, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_split_emulation_is_f32_accurate_and_tf32_is_not(shape):
    g = torch.Generator().manual_seed(sum(shape))
    x, wt, b = _inputs(g, *shape)
    split = ck.conv3x3_split_emulation(x, wt, b, relu=False)
    assert _split_error(split, x, wt, b, False) <= SPLIT_TOL
    relu = ck.conv3x3_split_emulation(x, wt, b, relu=True)
    assert torch.equal(relu, F.relu(split))
    tf32 = F.conv2d(ck.tf32_rna(x).permute(0, 3, 1, 2), ck.tf32_rna(wt), b,
                    padding=1).permute(0, 2, 3, 1)
    assert _split_error(tf32, x, wt, b, False) > 15 * SPLIT_TOL


def test_tf32_split_parts():
    """hi is TF32 (low 13 bits zero) rounded to nearest, ties away from
    zero; lo is TF32; hi + lo is within 2^-22 of v."""
    v = torch.tensor([1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -12,
                      3.14159265, -2.7182818, 1e-30, 0.0])
    hi, lo = ck.tf32_split(v)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 8191).any())
    assert hi[1] == 1 + 2 ** -10 and hi[2] == -(1 + 2 ** -10)  # ties away
    assert hi[3] == 1 + 2 ** -10
    err = ((hi.double() + lo.double()) - v.double()).abs()
    assert bool((err <= v.double().abs() * 2 ** -22).all())


def test_k_order_gives_each_thread_eight_contiguous_channels():
    """Columns q and q + 4 of k8 step kk (thread q of a fragment's row) are
    channels 8q + 2kk and 8q + 2kk + 1, so thread q reads channels 8q ..
    8q + 7 of a chunk over the four steps."""
    assert sorted(ck.K_ORDER) == list(range(32))
    for q in range(4):
        got = sorted(ck.K_ORDER[8 * kk + j] for kk in range(4)
                     for j in (q, q + 4))
        assert got == list(range(8 * q, 8 * q + 8))


# ---------------------------------------------------------------------------
# the weights' split, once per version
# ---------------------------------------------------------------------------

def _expected_parts(weight):
    cout, cin = weight.shape[:2]
    w = weight.detach().permute(0, 2, 3, 1)
    cin = -(-cin // 32) * 32
    w = F.pad(w, (0, cin - w.shape[-1])).reshape(cout, 9, cin // 32, 32)
    w = w[..., list(ck.K_ORDER)].reshape(cout, 9 * cin)
    return ck.tf32_split(w)


def test_weight_split_is_cached_and_rebuilt_per_version():
    conv = torch.nn.Conv2d(64, 128, 3, padding=1)
    hi, lo = ck.split_weight(conv.weight)
    want = _expected_parts(conv.weight)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    assert hi.shape == (128, 9 * 64) and hi.is_contiguous()
    assert ck.split_weight(conv.weight)[0] is hi  # cached
    with torch.no_grad():
        conv.weight.mul_(2.0)  # in place: a new version
    hi2, _ = ck.split_weight(conv.weight)
    assert hi2 is not hi and torch.equal(hi2, 2 * hi)
    other = torch.nn.Conv2d(64, 128, 3, padding=1)
    conv.load_state_dict(other.state_dict())
    hi3, lo3 = ck.split_weight(conv.weight)
    want = _expected_parts(other.weight)
    assert torch.equal(hi3, want[0]) and torch.equal(lo3, want[1])
    assert ck.split_weight(conv.weight)[0] is hi3


def test_weight_split_pads_cin_to_32():
    """conv1_1's (64, 3, 3, 3) weight as (64, 9 * 32): zero channels 3..31
    in each tap, the three real ones where K_ORDER puts them."""
    weight = torch.randn(64, 3, 3, 3)
    hi, lo = ck.split_weight(weight)
    assert hi.shape == lo.shape == (64, 9 * 32)
    want = _expected_parts(weight)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    taps = hi.reshape(64, 9, 32)
    real = [ck.K_ORDER.index(c) for c in range(3)]
    zero = [p for p in range(32) if p not in real]
    assert not bool(taps[..., zero].any()) and bool(taps[..., real].all())


def test_weight_split_cache_dies_with_its_weight():
    weight = torch.randn(64, 32, 3, 3)
    ck.split_weight(weight)
    key = id(weight)
    assert key in ck._SPLITS
    del weight
    gc.collect()
    assert key not in ck._SPLITS


# ---------------------------------------------------------------------------
# the launch geometry
# ---------------------------------------------------------------------------

def _k4_maps(h, w):
    """(name, h, w, Cin padded to 32, Cout) of every layer."""
    out = []
    for name, cin, cout, _, pool in VGG16_LAYERS:
        out.append((name, h, w, -(-cin // 32) * 32, cout))
        if pool:
            h, w = h // 2, w // 2
    return out


@pytest.mark.parametrize("n", [1, 12, 16])
@pytest.mark.parametrize("hw", [(480, 640), (37, 53)])
def test_conv_geometry_covers_each_layer(hw, n):
    maps = _k4_maps(*hw)
    assert [m[0] for m in maps] == [layer[0] for layer in VGG16_LAYERS]
    assert len(maps) == 13
    for name, h, w, cin, cout in maps:
        geo = ck.conv_geometry(n, h, w, cin, cout, 132)
        assert geo.tiles_y * geo.th >= h > (geo.tiles_y - 1) * geo.th, name
        assert geo.tiles_x * geo.tw >= w > (geo.tiles_x - 1) * geo.tw, name
        assert (geo.th, geo.tw, geo.bn) in ck.TILES and cout % geo.bn == 0
        assert geo.smem_bytes <= 227 * 1024
        assert geo.smem_bytes == ck.conv_smem_bytes(geo.th, geo.tw, geo.bn,
                                                     geo.stages)
        assert geo.stages == ck.conv_stages(geo.th, geo.tw, geo.bn)
        tiles = n * geo.tiles_y * geo.tiles_x * (cout // geo.bn)
        assert geo.blocks == min(tiles, 132)
        ck.check_geometry(geo, n, h, w, cin, cout)
        ck.check_geometry(geo._replace(blocks=tiles), n, h, w, cin, cout)


def test_conv_geometry_fills_a_small_grid():
    """The served query's conv5 map (batch 1, 30x40, Cout 512): more tiles
    than 128-pixel tiles at BN 128 would give (40), so that more SMs
    work; at batch 16 and conv1_2 (38,400 tiles of 128 pixels) every SM."""
    one = ck.conv_geometry(1, 30, 40, 512, 512, 132)
    assert one.blocks > 40 and one.blocks == min(
        132, one.tiles_y * one.tiles_x * 512 // one.bn)
    big = ck.conv_geometry(16, 480, 640, 64, 64, 132)
    assert big.th * big.tw == 128 and big.blocks == 132


def test_every_tile_and_bn_fits():
    """Each tile at its BN fits shared memory with at least three stages
    (the cuda tests force each)."""
    for th, tw, bn in ck.TILES:
        stages = ck.conv_stages(th, tw, bn)
        assert stages is not None and stages >= ck.MIN_STAGES
        assert ck.conv_smem_bytes(th, tw, bn, stages) <= ck.SMEM_BYTES


def test_conv_geometry_and_launch_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="cin"):
        ck.conv_geometry(1, 8, 8, 3, 64, 132)
    with pytest.raises(ValueError, match="cin"):
        ck.conv_geometry(1, 8, 8, 48, 64, 132)
    with pytest.raises(ValueError, match="cout"):
        ck.conv_geometry(1, 8, 8, 32, 96, 132)
    with pytest.raises(ValueError, match="empty"):
        ck.conv_geometry(1, 0, 8, 32, 64, 132)
    x = torch.zeros(1, 8, 8, 64)
    wt, b = torch.zeros(64, 64, 3, 3), torch.zeros(64)
    geo = ck.conv_geometry(1, 8, 8, 64, 64, 132)
    with pytest.raises(ValueError, match="float32"):
        ck._launch(x.double(), wt, b, True)
    with pytest.raises(ValueError, match="Cout a multiple"):
        ck._launch(x, torch.zeros(96, 64, 3, 3), torch.zeros(96), True)
    with pytest.raises(ValueError, match="do not cover"):
        ck._launch(x, wt, b, True, geometry=geo._replace(tiles_x=3))
    with pytest.raises(ValueError, match="smem_bytes"):
        ck._launch(x, wt, b, True,
                   geometry=geo._replace(smem_bytes=geo.smem_bytes + 16))
    with pytest.raises(ValueError, match="blocks"):
        ck._launch(x, wt, b, True, geometry=geo._replace(blocks=1000))
    with pytest.raises(ValueError, match="BN"):  # 128 pixels take BN 64
        ck.check_geometry(geo._replace(bn=128), 1, 8, 8, 64, 128)


# ---------------------------------------------------------------------------
# where the kernel engages
# ---------------------------------------------------------------------------

class _OnCard:
    """A CPU tensor that the callers' rule sees as a CUDA tensor."""

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return True if name == "is_cuda" else getattr(self.t, name)


def test_takes_sends_only_f32_no_grad_cuda_convolutions():
    x = torch.zeros(1, 4, 4, 64)
    wt, b = torch.zeros(64, 64, 3, 3), torch.zeros(64)
    assert ck.takes(_OnCard(x), wt, b)
    assert not ck.takes(x, wt, b)  # the CPU
    assert not ck.takes(_OnCard(x.bfloat16()), wt.bfloat16(), b.bfloat16())
    assert ck.takes(_OnCard(torch.zeros(1, 4, 4, 3)),
                    torch.zeros(64, 3, 3, 3), b)  # conv1_1, padded
    assert not ck.takes(_OnCard(x), torch.zeros(96, 64, 3, 3), b)
    assert not ck.takes(_OnCard(x), torch.zeros(64, 64, 1, 1), b)
    trained = wt.clone().requires_grad_()
    assert not ck.takes(_OnCard(x), trained, b)  # a gradient is needed
    assert not ck.takes(_OnCard(x), wt, b.clone().requires_grad_())
    assert not ck.takes(_OnCard(x.clone().requires_grad_()), wt, b)
    with torch.no_grad():
        assert ck.takes(_OnCard(x), trained, b)
    with torch.inference_mode():
        assert ck.takes(_OnCard(x), trained, b)


@pytest.fixture
def on_card_dispatch(monkeypatch):
    """The callers' rule with the CPU taken for the card, and the kernel
    replaced by its plain version: records which layers would launch."""
    calls = []

    def launch(x, weight, bias, *, relu=True):
        calls.append((tuple(x.shape), tuple(weight.shape)))
        return ck.conv3x3_plain(x, weight, bias, relu=relu)

    def takes(x, weight, bias=None):
        return ck.takes(_OnCard(x), weight, bias)

    for mod in (tv, tq):
        monkeypatch.setattr(mod, "takes", takes)
        monkeypatch.setattr(mod, "conv3x3_f32", launch)
    return calls


def test_launches_per_forward(on_card_dispatch):
    """13 for an f32 forward with no gradient (conv1_1..conv5_3), 10 for a
    SARE step that trains conv5 (conv1_1..conv4_3; conv5's convolutions,
    which need a gradient, stay F.conv2d), 2 for the int8 backbone's f32
    prefix (conv1_1, conv1_2); none in bf16."""
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(2, 32, 48, 3).astype(np.float32))
    model = VGG16().eval()
    with torch.no_grad():
        model(images)
    assert len(on_card_dispatch) == 13
    assert [w[1] for _, w in on_card_dispatch] == [
        layer[1] for layer in VGG16_LAYERS]
    del on_card_dispatch[:]

    model.freeze("conv5")
    _, fmap = model(images)
    fmap.square().sum().backward()
    assert len(on_card_dispatch) == 10
    assert all(getattr(model, n).weight.grad is not None
               for n in ("conv5_1", "conv5_2", "conv5_3"))
    del on_card_dispatch[:]

    state = tq.quantize_vgg16(VGG16(), images)  # calibrates through it
    del on_card_dispatch[:]
    qbase = tq.QuantVGG16(state, compute_dtype=torch.float32)
    with torch.no_grad():
        qbase(images)
    assert len(on_card_dispatch) == 2
    del on_card_dispatch[:]

    bf16 = VGG16(compute_dtype=torch.bfloat16).eval()
    with torch.no_grad():
        bf16(images)
    assert not on_card_dispatch


def test_sare_step_conv5_gradient_is_unchanged(on_card_dispatch,
                                               monkeypatch):
    """A step that trains conv5: the frozen layers through the kernel's
    route (here its plain version) give conv5 the same gradient, bit for
    bit, as the forward that never takes the route."""
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.randn(3, 32, 48, 3).astype(np.float32))

    def conv5_grads():
        model = VGG16().freeze("conv5")  # the same seeded weights each time
        _, fmap = model(images)
        fmap.square().sum().backward()
        return [getattr(model, n).weight.grad
                for n in ("conv5_1", "conv5_2", "conv5_3")]

    routed = conv5_grads()
    assert len(on_card_dispatch) == 10
    monkeypatch.setattr(tv, "takes", lambda *a: False)
    old = conv5_grads()
    assert len(on_card_dispatch) == 10
    for a, b in zip(routed, old):
        assert torch.equal(a, b)


def test_flop_formula_counts_what_conv2d_counts():
    """A CUDA call goes through a registered operator whose FLOP formula
    gives FlopCounterMode the count it gives F.conv2d (conv1_1's 3
    channels, not the 32 the kernel pads them to)."""
    from torch.utils.flop_counter import FlopCounterMode, flop_registry

    formula = flop_registry[torch.ops.openibl_tpu_torch.conv3x3_f32]
    for n, h, w, cin, cout in [(2, 7, 11, 3, 64), (1, 5, 6, 64, 128)]:
        x = torch.zeros(n, h, w, cin)
        wt, b = torch.zeros(cout, cin, 3, 3), torch.zeros(cout)
        with FlopCounterMode(display=False) as counter:
            F.conv2d(x.permute(0, 3, 1, 2), wt, b, padding=1)
        got = formula(x, wt, b, True, out_val=torch.zeros(n, h, w, cout))
        assert got == ck.conv3x3_flops(x.shape, wt.shape)
        assert got == counter.get_total_flops() == 2 * n * h * w * cout * \
            cin * 9


# ---------------------------------------------------------------------------
# the source
# ---------------------------------------------------------------------------

def _source():
    with open(osp.join(ROOT, "openibl_tpu_torch", "csrc",
                       "conv_f32.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name, value", [
    ("kBK", ck.CIN_ALIGN), ("kRowBytes", ck.ROW_BYTES),
    ("kMaxCin", ck.MAX_CIN), ("kMinStages", ck.MIN_STAGES),
    ("kMaxStages", ck.MAX_STAGES), ("kMaxSmem", ck.SMEM_BYTES),
    ("kSmemAlign", ck.SMEM_ALIGN), ("kBarBytes", ck.BARRIER_BYTES)])
def test_constants_match_the_source(name, value):
    src = _source()
    assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == \
        str(value)


@pytest.mark.parametrize("what, line", [
    ("BN", "bn != (rows == 64 ? 128 : 64)"),
    ("Cout", "cout % 64 != 0"),
    ("stage bytes", "kSmemAlign + stages * (rows + 2 * bn) * kRowBytes + "
                    "rows * bn * 4 + stages * kBarBytes"),
    ("tile", "(rows != 64 && rows != 128)"),
    ("split", "cvt.rna.tf32.f32"),
    ("wgmma", "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32")])
def test_geometry_rules_match_the_source(what, line):
    assert line in " ".join(_source().split()), what
    assert ck.COUT_ALIGN == 64 and all(
        bn == (128 if th * tw == 64 else 64) for th, tw, bn in ck.TILES)


# ---------------------------------------------------------------------------
# the CUDA kernel (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_conv_kernel.py`")
    return torch.device("cuda")


def _plain_f32(x, wt, b, relu):
    from openibl_tpu_torch.utils import f32_precision

    with f32_precision():
        return ck.conv3x3_plain(x, wt, b, relu=relu)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", ck.TILES,
                         ids=lambda t: f"{t[0]}x{t[1]}_{t[2]}")
@pytest.mark.parametrize("n", [1, 16])
def test_cuda_kernel_forced_geometries(tile, n, cuda_device):
    """Each tile (at its BN) the chooser can return, forced, with its
    stages, one block a tile and a persistent grid of 5 blocks, at an odd map,
    with and without ReLU: within SPLIT_TOL of the f64 convolution, as
    close to the plain version (cuDNN f32) as that is to f64, and the same
    bits on a second run."""
    th, tw, bn = tile
    h, w, cin, cout = 19, 37, 96, 128
    g = torch.Generator().manual_seed(th * 1000 + bn + n)
    x, wt, b = _inputs(g, n, h, w, cin, cout, cuda_device)
    ty, tx = -(-h // th), -(-w // tw)
    tiles = n * ty * tx * (cout // bn)
    stages = ck.conv_stages(th, tw, bn)
    for relu in (True, False):
        plain = _plain_f32(x, wt, b, relu)
        _, scale = _reference(x, wt, b, relu)
        plain_err = _split_error(plain, x, wt, b, relu)
        for blocks in (tiles, 5):
            geo = ck.ConvGeometry(th, tw, ty, tx, bn, stages, blocks,
                                  ck.conv_smem_bytes(th, tw, bn, stages))
            before = ck.conv3x3_f32.launches
            out = ck._launch(x, wt, b, relu, geometry=geo)
            again = ck._launch(x, wt, b, relu, geometry=geo)
            torch.cuda.synchronize()
            assert ck.conv3x3_f32.launches == before + 2
            assert out.shape == (n, h, w, cout) and out.is_contiguous()
            assert torch.equal(out, again)
            err = _split_error(out, x, wt, b, relu)
            assert err <= SPLIT_TOL, (geo, relu, err)
            gap = float(((out - plain).double().abs() / scale).max())
            assert gap <= SPLIT_TOL + plain_err, (geo, relu, gap)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", VGG16_LAYERS, ids=lambda l: l[0])
@pytest.mark.parametrize("hw", [(30, 40), (7, 13)])
@pytest.mark.parametrize("n", [1, 16])
def test_cuda_each_layer_against_f64(layer, hw, n, cuda_device):
    name, cin, cout, relu, _ = layer
    g = torch.Generator().manual_seed(cin + cout + n)
    x, wt, b = _inputs(g, n, *hw, cin, cout, cuda_device)
    out = ck.conv3x3_f32(x, wt, b, relu=relu)
    torch.cuda.synchronize()
    assert _split_error(out, x, wt, b, relu) <= SPLIT_TOL, name


@pytest.mark.cuda
def test_cuda_launches_per_forward(cuda_device):
    """``.launches``: 13 for an f32 forward with no gradient, 10 for a step
    that trains conv5, 2 for the int8 backbone (conv1_x); the f32 map on
    the card against the CPU's."""
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(2, 32, 48, 3).astype(np.float32))
    model = VGG16().eval()
    with torch.no_grad():
        _, cpu_map = model(images)
    card = VGG16().to(cuda_device, memory_format=torch.channels_last)
    card.load_state_dict(model.state_dict())
    card.eval()
    before = ck.conv3x3_f32.launches
    with torch.inference_mode():
        _, fmap = card(images.to(cuda_device))
    torch.cuda.synchronize()
    assert ck.conv3x3_f32.launches - before == 13
    scale = float(cpu_map.abs().max())
    assert float((fmap.cpu() - cpu_map).abs().max()) <= 1e-5 * scale

    card.freeze("conv5")
    before = ck.conv3x3_f32.launches
    _, fmap = card(images.to(cuda_device))
    fmap.square().sum().backward()
    torch.cuda.synchronize()
    assert ck.conv3x3_f32.launches - before == 10
    assert card.conv5_1.weight.grad is not None
    # a FlopCounterMode over the step counts the kernel's convolutions as
    # it counts cuDNN's
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        card(images.to(cuda_device))
    with FlopCounterMode(display=False) as cpu_counter:
        model(images)
    assert counter.get_total_flops() == cpu_counter.get_total_flops() > 0

    state = tq.quantize_vgg16(model, images)
    qbase = tq.QuantVGG16(state, compute_dtype=torch.float32).to(
        cuda_device)
    before = ck.conv3x3_f32.launches
    with torch.no_grad():
        qbase(images.to(cuda_device))
    torch.cuda.synchronize()
    assert ck.conv3x3_f32.launches - before == 2


@pytest.mark.cuda
def test_cuda_masked_forward_equals_unpadded(cuda_device):
    """Bucket-padded images through the masked forward: each image's valid
    conv5_3 map against a forward of that image alone, both through the
    kernel."""
    rng = np.random.RandomState(2)
    model = VGG16().to(cuda_device, memory_format=torch.channels_last)
    model.eval()
    h, w = 48, 64
    extents = [(48, 64), (37, 53), (33, 40)]
    imgs = np.zeros((len(extents), h, w, 3), np.float32)
    for i, (eh, ew) in enumerate(extents):
        imgs[i, :eh, :ew] = rng.randn(eh, ew, 3) * 50
    before = ck.conv3x3_f32.launches
    with torch.inference_mode():
        _, masked = model(torch.from_numpy(imgs).to(cuda_device),
                          valid_hw=np.array(extents))
        for i, (eh, ew) in enumerate(extents):
            _, alone = model(torch.from_numpy(
                imgs[i:i + 1, :eh, :ew].copy()).to(cuda_device))
            vh, vw = alone.shape[1:3]
            got = masked[i, :vh, :vw]
            scale = float(alone.abs().max())
            assert float((got - alone[0]).abs().max()) <= 1e-6 * scale, i
    torch.cuda.synchronize()
    assert ck.conv3x3_f32.launches - before == 13 * (1 + len(extents))
