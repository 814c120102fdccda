"""The port's Mosaic layout probes (openibl_tpu_torch/tools/mosaic_probe.py)
against scripts/mosaic_probe.py, and on a GPU each CUDA probe kernel against
its plain version.

The script's seven Pallas kernels run here in interpret mode: its ``pl`` is
replaced by a namespace whose ``pallas_call`` adds ``interpret=True`` and
records each kernel's output. The port's plain versions, on the port's own
inputs, must give those outputs bit for bit, except the K=3 product (P5),
whose f32 sums may run in another order: atol 1e-5 there. P7's kernel
arithmetic (three bf16 parts of the LUT, one one-hot product per part in
f32, then (hi + mid) + lo) is emulated here in plain PyTorch and held bit
for bit to the plain version and to the Pallas output. The tests marked
``cuda`` run only on a GPU, without the JAX-side conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_mosaic_probe.py``.
"""

import importlib.util
import os.path as osp
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch.tools import mosaic_probe as mp  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_ATOL = 1e-5  # P5 against Pallas: f32 sums of 3 products in another order


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_mosaic_probe.py`")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_rows():
    """{key: (row name, status, recorded output)} of the script's probes,
    its kernels run in interpret mode on the CPU."""
    jax = pytest.importorskip("jax")  # not on the GPU machine: -m cuda only
    spec = importlib.util.spec_from_file_location(
        "jax_mosaic_probe", osp.join(ROOT, "scripts", "mosaic_probe.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    real_pl, outputs = script.pl, []

    def pallas_call(kernel, **kw):
        fn = real_pl.pallas_call(kernel, interpret=True, **kw)

        def run(*args):
            out = fn(*args)
            jax.debug.callback(lambda o: outputs.append(np.asarray(o)), out)
            return out
        return run

    probes = {"P1": lambda: script.probe_concat(3, 9),
              "P2": lambda: script.probe_concat(64, 9),
              "P3": script.probe_sublane_offsets,
              "P4": script.probe_sublane_stride2,
              "P5": script.probe_k3_dot,
              "P6": script.probe_take_lut,
              "P7": script.probe_onehot_dot}
    rows = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(script, "pl",
                      types.SimpleNamespace(pallas_call=pallas_call))
        for key, probe in probes.items():
            name, status = probe()
            jax.effects_barrier()
            rows[key] = (name, status, outputs.pop())
            assert not outputs
    return rows


def test_probes_are_the_scripts_seven_in_order():
    assert [p.key for p in mp.PROBES] == [f"P{i}" for i in range(1, 8)]


@pytest.mark.parametrize("probe", mp.PROBES, ids=lambda p: p.key)
def test_plain_version_gives_the_pallas_output(jax_rows, probe):
    name, status, jax_out = jax_rows[probe.key]
    assert status == "OK"  # the Pallas kernel against the script's numpy
    assert probe.name == name
    out = probe.plain(*probe.tensors("cpu"), **probe.kwargs).numpy()
    assert out.dtype == jax_out.dtype and out.shape == jax_out.shape
    if probe.atol:
        np.testing.assert_allclose(out, jax_out, rtol=0, atol=JAX_ATOL)
    else:
        np.testing.assert_array_equal(out, jax_out)


@pytest.mark.parametrize("probe", mp.PROBES, ids=lambda p: p.key)
def test_site_is_the_scripts_probe_function(probe):
    with open(osp.join(ROOT, "scripts", "mosaic_probe.py")) as f:
        line = f.read().splitlines()[probe.site - 1]
    assert line.startswith("def probe_"), line


@pytest.mark.parametrize("probe", mp.PROBES, ids=lambda p: p.key)
def test_cpu_probe_takes_the_plain_version(probe):
    before = probe.kernel.launches
    name, status, out = probe.run("cpu")
    assert (name, status) == (probe.name, "OK")
    assert probe.kernel.launches == before
    assert out.device.type == "cpu" and out.dtype == torch.float32


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("call, err, match", [
    (lambda: mp.concat(_f32(8, 27).double(), 3), TypeError, "float32"),
    (lambda: mp.concat(_f32(8, 27), 4), ValueError, "blocks of 4"),
    (lambda: mp.concat(_f32(8, 27, 1), 3), ValueError, "2 dims"),
    (lambda: mp.concat(_f32(27, 8).T, 3), ValueError, "contiguous"),
    (lambda: mp.concat(torch.zeros(8, 27, device="meta"), 3), ValueError,
     "no kernel for device meta"),
    (lambda: mp.sublane_offsets(_f32(2, 256)), ValueError, ">= 3 rows"),
    (lambda: mp.sublane_offsets(_f32(256, 18).T), ValueError, "contiguous"),
    (lambda: mp.sublane_stride2(_f32(31, 256)), ValueError, "even"),
    (lambda: mp.sublane_stride2(_f32(32, 256).half()), TypeError, "float32"),
    (lambda: mp.k3_dot(_f32(128, 3), _f32(4, 64)), ValueError, "multiply"),
    (lambda: mp.k3_dot(_f32(128, 3), _f32(64, 3).T), ValueError,
     "contiguous"),
    (lambda: mp.take_lut(_f32(8, 256), _i32(8, 128).long()), TypeError,
     "int32"),
    (lambda: mp.take_lut(_f32(8, 257), _i32(8, 128)), ValueError,
     "1..256 columns"),
    (lambda: mp.take_lut(_f32(8, 256), _i32(4, 128)), ValueError, "idx"),
    (lambda: mp.onehot_dot(_f32(8, 256), _i32(128)), ValueError, "2 dims"),
    (lambda: mp.onehot_dot(_f32(8, 256), _i32(2, 128)), ValueError, "idx"),
    (lambda: mp.onehot_dot(_f32(256, 8).T, _i32(1, 128)), ValueError,
     "contiguous"),
    (lambda: mp.take_lut(_f32(8, 256), _i32(8 * 128)), ValueError, "2 dims"),
    (lambda: mp.take_lut(_f32(8, 0), _i32(8, 128)), ValueError,
     "1..256 columns"),
    (lambda: mp.onehot_dot(_f32(8, 257), _i32(1, 128)), ValueError,
     "1..256 columns"),
    (lambda: mp.onehot_dot(_f32(8, 256), _i32(1, 128).float()), TypeError,
     "int32"),
    (lambda: mp.onehot_dot(_f32(8, 256), _i32(1, 0)), ValueError, "idx"),
])
def test_wrappers_reject_bad_inputs(call, err, match):
    with pytest.raises(err, match=match):
        call()


def bf16_parts(lut):
    """P7's split of an f32 LUT into three bf16 parts (as f32 values): hi =
    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to
    nearest even."""
    hi = lut.to(torch.bfloat16).float()
    mid = (lut - hi).to(torch.bfloat16).float()
    lo = (lut - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def onehot_split_emulation(lut, idx):
    """P7's kernel arithmetic in plain PyTorch: each bf16 part of the LUT
    times the one-hot of the (1, C) indices in f32 (one non-zero term per
    output, so exact), then (hi + mid) + lo. An index outside [0, S)
    matches no slot and gives 0."""
    onehot = (idx[0].long()[:, None] == torch.arange(lut.shape[1])).float()
    hi, mid, lo = (part @ onehot.T for part in bf16_parts(lut))
    return (hi + mid) + lo


def wide_lut(seed, rows, slots):
    """(rows, slots) f32 of magnitudes 1e-30 to 1e30 (log-uniform), both
    signs, with exact zeros and negative zeros."""
    rng = np.random.RandomState(seed)
    lut = (10.0 ** rng.uniform(-30, 30, (rows, slots))
           * rng.choice([-1.0, 1.0], (rows, slots))).astype(np.float32)
    lut[rng.rand(rows, slots) < 0.05] = 0.0
    lut[rng.rand(rows, slots) < 0.02] = -0.0
    return torch.from_numpy(lut)


def _codes(seed, slots, cols):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, slots, (1, cols)).astype(np.int32))


ONEHOT_CASES = {
    "script": lambda: [torch.from_numpy(a) for a in mp._onehot_inputs()],
    "script-wide": lambda: (wide_lut(5, 8, 256), _codes(6, 256, 128)),
    "wide-ragged-R13-S17-C100": lambda: (wide_lut(7, 13, 17),
                                         _codes(8, 17, 100)),
    "wide-ragged-R65-S255-C1003": lambda: (wide_lut(9, 65, 255),
                                           _codes(10, 255, 1003)),
    "randn-R3-S1-C5": lambda: (torch.from_numpy(np.random.RandomState(11)
                                                .randn(3, 1)
                                                .astype(np.float32)),
                               _codes(12, 1, 5)),
}


@pytest.mark.parametrize("case", ONEHOT_CASES)
def test_onehot_split_emulation_is_the_plain_version(case):
    lut, idx = ONEHOT_CASES[case]()
    out = onehot_split_emulation(lut, idx)
    assert torch.equal(out, mp.onehot_dot_plain(lut, idx))
    assert torch.equal(out, mp.onehot_dot(lut, idx))


def test_onehot_split_emulation_gives_the_pallas_output(jax_rows):
    lut, idx = (torch.from_numpy(a) for a in mp._onehot_inputs())
    np.testing.assert_array_equal(onehot_split_emulation(lut, idx).numpy(),
                                  jax_rows["P7"][2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_parts_rebuild_the_lut_exactly(seed):
    """Three bf16 parts hold any f32 of the stated range exactly: (hi +
    mid) + lo gives its bits back, and each part is 0 or a normal bf16."""
    lut = wide_lut(seed, 16, 256)
    hi, mid, lo = bf16_parts(lut)
    assert torch.equal((hi + mid) + lo, lut)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
        nz = part[part != 0].abs()
        assert bool((nz >= 2.0 ** -126).all() and nz.isfinite().all())


def test_onehot_split_emulation_gives_0_out_of_range():
    lut = wide_lut(13, 4, 17)
    idx = torch.tensor([[-1, 17, 300, 16, 0, -2 ** 31]], dtype=torch.int32)
    out = onehot_split_emulation(lut, idx)
    assert torch.equal(out[:, [0, 1, 2, 5]], torch.zeros(4, 4))
    assert torch.equal(out[:, [3, 4]], lut[:, [16, 0]])


GEOMETRY_SHAPES = [(8, 128), (64, 100_000), (65, 100_003), (1, 1),
                   (3, 5), (100_000, 64), (1, 10_000_000)]


@pytest.mark.parametrize("rows, cols", GEOMETRY_SHAPES)
def test_take_lut_geometry_covers_every_column(rows, cols):
    """The C entry refuses blocks that do not cover a row's 4-column units,
    or more than 65535 blocks a row; no block of a row is left empty."""
    per_row, per_block = mp.take_lut_geometry(rows, cols)
    units = -(-cols // 4)
    assert 1 <= per_row <= 65535 and per_block >= 1
    assert per_row * per_block >= units > (per_row - 1) * per_block
    assert rows * per_row <= max(rows, mp.GATHER_BLOCKS + rows)
    if units <= mp.GATHER_THREADS:
        assert per_row == 1  # the script's shape: one block a row


@pytest.mark.parametrize("rows, cols", GEOMETRY_SHAPES)
def test_onehot_dot_geometry_covers_every_code(rows, cols):
    """The C entry refuses runs that do not cover the codes, more than 65535
    blocks, or K groups other than 1 and 4; no block is left empty."""
    per_warp, blocks, k_groups = mp.onehot_dot_geometry(rows, cols)
    tiles, runs = -(-cols // 16), mp.ONEHOT_WARPS // k_groups  # runs a block
    assert per_warp >= 1 and 1 <= blocks <= 65535
    assert k_groups in (1, mp.ONEHOT_WARPS)
    assert blocks * runs * per_warp >= tiles > (blocks - 1) * runs * per_warp
    warps = -(-rows // 8) * tiles * k_groups
    if k_groups > 1:  # few codes: every warp of the card may have a tile
        assert per_warp == 1 and warps <= mp.ONEHOT_WARPS_TOTAL
    elif warps <= mp.ONEHOT_WARPS_TOTAL:
        assert per_warp == 1  # a warp for every (row tile, code tile)


def test_geometries_at_the_script_and_k2_shapes():
    assert mp.take_lut_geometry(8, 128) == (1, 32)
    assert mp.onehot_dot_geometry(8, 128) == (1, 8, 4)  # 32 warps
    per_row, per_block = mp.take_lut_geometry(64, 100_000)
    assert 64 * per_row >= 132 * 8  # every SM gets blocks
    per_warp, blocks, k_groups = mp.onehot_dot_geometry(64, 100_000)
    assert k_groups == 1 and 8 * blocks * mp.ONEHOT_WARPS >= 132 * 11


def _source():
    with open(osp.join(ROOT, "openibl_tpu_torch", "csrc",
                       "mosaic_probe.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name, value", [
    ("kMaxSlots", mp.MAX_SLOTS), ("kGatherThreads", mp.GATHER_THREADS),
    ("kOnehotWarps", mp.ONEHOT_WARPS)])
def test_constants_match_the_source(name, value):
    assert re.findall(rf"constexpr int {name} = (\d+);", _source()) == \
        [str(value)]


def test_onehot_kernel_stores_no_onehot():
    """P7's one-hot lives in mma.sync A fragments, built from each code's
    key: the kernel's shared memory holds only indices and the K groups'
    partial results, 4 floats a lane."""
    src = _source()
    body = src[src.index("onehot_dot_kernel("):src.index("empty_kernel")]
    assert re.findall(r"__shared__[^;]*;", body) == [
        "__shared__ __align__(16) int s_codes[kOnehotWarps][kBatchTiles * 16];",
        "__shared__ float s_part[2][kGroups][4][32];"]
    assert "mma_bf16(acc" in body and "onehot_key(codes[" in body


@pytest.mark.cuda
@pytest.mark.parametrize("probe", mp.PROBES, ids=lambda p: p.key)
def test_cuda_kernel_matches_plain(probe, cuda_device):
    args = probe.tensors(cuda_device)
    before = probe.kernel.launches
    out = probe.kernel(*args, **probe.kwargs)
    torch.cuda.synchronize()
    assert probe.kernel.launches == before + 1
    assert out.device.type == "cuda"
    want = probe.plain(*(a.cpu() for a in args), **probe.kwargs)
    assert probe.agrees(out.cpu(), want)
    assert probe.run(cuda_device)[1] == "OK"


@pytest.mark.cuda
def test_cuda_kernels_at_ragged_sizes(cuda_device):
    """Shapes that fill no tile: the kernels mask their edges."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    cases = [(mp.concat, mp.concat_plain, (rand(5, 21),), {"width": 7}),
             (mp.sublane_offsets, mp.sublane_offsets_plain, (rand(37, 45),),
              {}),
             (mp.sublane_stride2, mp.sublane_stride2_plain, (rand(18, 33),),
              {}),
             (mp.take_lut, mp.take_lut_plain,
              (rand(11, 100), torch.randint(0, 100, (11, 77), generator=g,
                                            device=cuda_device,
                                            dtype=torch.int32)), {}),
             (mp.onehot_dot, mp.onehot_dot_plain,
              (rand(11, 100), torch.randint(0, 100, (1, 77), generator=g,
                                            device=cuda_device,
                                            dtype=torch.int32)), {})]
    for kernel, plain, args, kw in cases:
        out = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), plain(*(a.cpu() for a in args), **kw))
    x, w = rand(77, 5), rand(5, 33)
    torch.testing.assert_close(mp.k3_dot(x, w).cpu(), x.cpu() @ w.cpu(),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_tool_prints_every_row_ok(cuda_device, capsys):
    assert mp.main(["--device", "cuda"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("backend: cuda")
    assert out.count(" OK\n") == len(mp.PROBES)


P67 = {"P6": (mp.take_lut, mp.take_lut_plain),
       "P7": (mp.onehot_dot, mp.onehot_dot_plain)}


def _p67_inputs(key, rows, slots, cols, device, offset=0):
    """A seeded randn LUT and indices on ``device``; ``offset`` > 0 starts
    both that many elements into their storage (no 16-byte alignment)."""
    g = torch.Generator(device=device).manual_seed(rows * 7 + cols)
    lut = torch.randn(rows * slots + offset, generator=g, device=device)
    n = (rows if key == "P6" else 1) * cols
    idx = torch.randint(0, slots, (n + offset,), generator=g, device=device,
                        dtype=torch.int32)
    return (lut[offset:].view(rows, slots),
            idx[offset:].view(-1, cols))


@pytest.mark.cuda
@pytest.mark.parametrize("key, rows, slots, cols, offset", [
    ("P6", 64, 256, 100_000, 0), ("P6", 65, 17, 100_003, 0),
    ("P6", 13, 255, 7, 0), ("P6", 11, 100, 77, 1), ("P6", 5, 256, 4099, 3),
    ("P7", 64, 256, 100_000, 0), ("P7", 65, 17, 100_003, 0),
    ("P7", 9, 1, 33, 0), ("P7", 11, 100, 77, 1), ("P7", 17, 256, 4099, 3)])
def test_cuda_p6_p7_bit_for_bit(key, rows, slots, cols, offset, cuda_device):
    """P6 and P7 at K2's shape (one query's LUT at m=64 against 100k codes),
    at ragged shapes and on inputs that are not 16-byte aligned."""
    kernel, plain = P67[key]
    args = _p67_inputs(key, rows, slots, cols, cuda_device, offset)
    out = kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, plain(*args))


@pytest.mark.cuda
def test_cuda_out_of_range_indices(cuda_device):
    """An index outside [0, S) gives NaN in P6 and 0 in P7, never a read
    outside the table."""
    lut = torch.randn(3, 17, device=cuda_device)
    bad = torch.tensor([-1, 17, 300, -2 ** 31, 16, 0], dtype=torch.int32,
                       device=cuda_device)
    p6 = mp.take_lut(lut, bad.repeat(3, 1)).cpu()
    p7 = mp.onehot_dot(lut, bad[None]).cpu()
    assert bool(p6[:, :4].isnan().all()) and torch.equal(p7[:, :4],
                                                         torch.zeros(3, 4))
    want = lut[:, [16, 0]].cpu()
    assert torch.equal(p6[:, 4:], want) and torch.equal(p7[:, 4:], want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in ONEHOT_CASES if "wide" in c])
def test_cuda_p7_wide_exponent_lut_matches_emulation(case, cuda_device):
    lut, idx = ONEHOT_CASES[case]()
    out = mp.onehot_dot(lut.to(cuda_device), idx.to(cuda_device)).cpu()
    assert torch.equal(out, onehot_split_emulation(lut, idx))
    assert torch.equal(out, mp.onehot_dot_plain(lut, idx))


@pytest.mark.cuda
def test_cuda_empty_kernel_launches(cuda_device):
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert mp._lib().mosaic_empty(stream) == 0
    torch.cuda.synchronize()
