"""Kernel K2 (PQ ADC tile scorer) of the PyTorch port: its wrapper's checks,
and on a GPU the CUDA kernel against its plain version.

The plain version is held to the JAX package in tests/test_torch_pq.py. The
kernel sums the same f32 values in the same subspace order as the plain
version, so they agree to rtol/atol 1e-5 (in practice bit for bit). The
tests marked ``cuda`` run only on a GPU, without the JAX-side conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_pq_kernel.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch.ops import pq_kernel as pk  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_pq_kernel.py`")
    return torch.device("cuda")


def _inputs(m, q, ksub, t, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    lut = torch.rand((m, q, ksub), generator=g, device=device)
    codes = torch.randint(0, ksub, (t, m), generator=g, device=device,
                          dtype=torch.uint8)
    return lut, codes


def test_cpu_takes_the_plain_version_and_launches_nothing():
    lut, codes = _inputs(8, 3, 16, 50)
    before = pk.adc_tile.launches
    out = pk.adc_tile(lut, codes, precise=True)
    assert pk.adc_tile.launches == before
    torch.testing.assert_close(out, pk.adc_tile_plain(lut, codes, True),
                               rtol=0, atol=0)
    want = sum(lut[j][:, codes[:, j].long()] for j in range(8))
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad, err, match", [
    (lambda l, c: (l.double(), c), TypeError, "float32"),
    (lambda l, c: (l, c.to(torch.int32)), TypeError, "uint8"),
    (lambda l, c: (l, c[:, :4]), ValueError, "subspaces"),
    (lambda l, c: (l[0], c), ValueError, r"\(m, Q, ksub\)"),
    (lambda l, c: (l, c.T.contiguous().T), ValueError, "contiguous"),
    (lambda l, c: (torch.rand(8, 3, 300), c), ValueError, "ksub=300"),
])
def test_bad_inputs_raise(bad, err, match):
    lut, codes = bad(*_inputs(8, 3, 16, 40))
    with pytest.raises(err, match=match):
        pk.adc_tile(lut, codes)


def _geo(m, q, precise, t=100_000):
    return pk.adc_geometry(m, q, t, precise, sms=132)


def test_queries_per_block_follows_shared_memory():
    """adc_geometry: at m=64 one query's LUT fits whole (64 KB f32, 32 KB
    bf16); 16 queries take 1 MB / 512 KB, so the subspaces go in chunks;
    past 32 queries the queries go in balanced passes."""
    g = _geo(64, 1, precise=True)
    assert (g.passes, g.query_slots, g.subspaces_per_chunk, g.chunks) == \
        (1, 1, 64, 1) and g.smem_bytes == 64 * 1024
    assert _geo(64, 1, precise=False).smem_bytes == 32 * 1024
    g = _geo(64, 16, precise=False)
    assert (g.query_slots, g.subspaces_per_chunk, g.chunks) == (16, 24, 3)
    g = _geo(64, 16, precise=True)
    assert (g.query_slots, g.subspaces_per_chunk, g.chunks) == (16, 12, 6)
    g = _geo(8, 17, precise=True)
    assert (g.passes, g.queries_per_pass, g.query_slots, g.chunks) == \
        (1, 17, 24, 1)
    g = _geo(8, 33, precise=False)
    assert (g.passes, g.queries_per_pass, g.query_slots) == (2, 17, 24)
    with pytest.raises(ValueError, match="m=1024"):
        _geo(1024, 1, precise=True)


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("q", [1, 3, 16, 17, 64])
@pytest.mark.parametrize("m", [8, 16, 64, 128])
def test_adc_geometry_fits_and_covers_in_order(m, q, precise):
    """Each launch geometry fits a block's 227 KB, its query passes cover
    the queries once, and its chunks cover j = 0..m-1 in order, each a
    multiple of 4 subspaces but the last (4-byte code loads)."""
    g = _geo(m, q, precise)
    assert g.smem_bytes <= pk.SMEM_BYTES == 232_448
    assert g.smem_bytes == (g.subspaces_per_chunk * pk.MAX_KSUB
                            * g.query_slots * (4 if precise else 2))
    assert g.queries_per_pass <= pk.MAX_QUERIES_PER_PASS
    assert g.query_slots in pk.QUERY_SLOTS
    assert g.query_slots >= g.queries_per_pass
    assert (g.passes - 1) * g.queries_per_pass < q <= \
        g.passes * g.queries_per_pass
    # the kernel's loop: for (j0 = 0; j0 < m; j0 += mc)
    mc = g.subspaces_per_chunk
    chunks = [(j0, min(j0 + mc, m)) for j0 in range(0, m, mc)]
    assert len(chunks) == g.chunks
    assert [j for a, b in chunks for j in range(a, b)] == list(range(m))
    if g.chunks > 1:
        assert mc % 4 == 0
    # no more chunks than chunks of as many subspaces as fit (4-aligned)
    fit = pk.SMEM_BYTES // (g.smem_bytes // mc)
    assert g.chunks <= -(-m // (fit - fit % 4)) if fit < m else \
        g.chunks == 1


@pytest.mark.parametrize("t, q, blocks", [
    (1, 1, 1), (777, 1, 2), (100_000, 1, 132), (100_000, 64, 66),
    (1_000_000, 16, 132), (999_983, 33, 66)])
def test_adc_geometry_rows_per_block(t, q, blocks):
    """One block per SM over all passes, no more than one per 512 rows;
    the blocks' contiguous row ranges cover the t rows."""
    g = pk.adc_geometry(64, q, t, False, sms=132)
    assert g.blocks == blocks
    assert g.rows_per_block == -(-t // blocks)
    assert (g.blocks - 1) * g.rows_per_block < t <= \
        g.blocks * g.rows_per_block


@pytest.mark.parametrize("m", [0, 257, 1024])
def test_adc_geometry_rejects_oversize_m(m):
    with pytest.raises(ValueError, match=f"m={m} subspaces"):
        _geo(m, 1, precise=False)


def _source():
    import os.path as osp

    from openibl_tpu_torch.ops import _build

    with open(osp.join(_build.CSRC, "pq_adc.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name, value", [
    ("kThreads", pk.THREADS), ("kSlots", pk.MAX_KSUB),
    ("kMaxQ", pk.MAX_QUERIES_PER_PASS)])
def test_constants_match_the_source(name, value):
    """adc_geometry's copies of csrc/pq_adc.cu's constants are the
    source's: a change on one side fails here, not at the launch."""
    import re

    assert re.findall(rf"constexpr int {name} = (\d+);", _source()) == \
        [str(value)]


def test_query_slots_and_shared_memory_match_the_source():
    """The padded query counts adc_geometry picks are the kernel's
    instances, and its shared-memory ceiling is the kernel's."""
    import re

    src = _source()
    assert tuple(int(v) for v in re.findall(r"^\s*ADC_CASE\((\d+)\)$", src,
                                            re.M)) == pk.QUERY_SLOTS
    assert re.findall(r"constexpr size_t kMaxSmem = (\d+);", src) == \
        [str(pk.SMEM_BYTES)]


@pytest.mark.cuda
@pytest.mark.parametrize("m, ksub", [(8, 16), (64, 256), (64, 16)])
@pytest.mark.parametrize("q", [1, 3, 16, 17, 64])
@pytest.mark.parametrize("t", [1, 777, 100_003])
def test_cuda_kernel_matches_plain(m, ksub, q, t, cuda_device):
    lut, codes = _inputs(m, q, ksub, t, seed=t + q, device=cuda_device)
    for precise in (True, False):
        before = pk.adc_tile.launches
        out = pk.adc_tile(lut, codes, precise=precise)
        torch.cuda.synchronize()
        assert pk.adc_tile.launches == before + 1
        assert out.shape == (q, t) and out.dtype == torch.float32
        ref = pk.adc_tile_plain(lut, codes, precise=precise)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_on_tile_views_and_odd_rows(cuda_device):
    """pq_search hands the kernel row slices of the index: a slice starting
    at an odd row (m=8: 8-byte aligned, the 4-byte load path) and m=6
    (byte loads) still match the plain version."""
    lut, codes = _inputs(8, 5, 256, 5000, device=cuda_device)
    tile = codes[1:4001]
    torch.testing.assert_close(pk.adc_tile(lut, tile),
                               pk.adc_tile_plain(lut, tile),
                               rtol=1e-5, atol=1e-5)
    lut, codes = _inputs(6, 2, 256, 999, device=cuda_device)
    torch.testing.assert_close(pk.adc_tile(lut, codes, precise=True),
                               pk.adc_tile_plain(lut, codes, precise=True),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_rejects_bad_inputs(cuda_device):
    lut, codes = _inputs(8, 3, 16, 40, device=cuda_device)
    with pytest.raises(ValueError, match="lut on"):
        pk.adc_tile(lut.cpu(), codes)
    with pytest.raises(ValueError, match="m=1024 subspaces"):
        pk.adc_tile(torch.rand((1024, 1, 16), device=cuda_device),
                    torch.zeros((4, 1024), dtype=torch.uint8,
                                device=cuda_device))
    before = pk.adc_tile.launches
    empty = pk.adc_tile(lut, codes[:0])
    assert empty.shape == (3, 0) and pk.adc_tile.launches == before


@pytest.mark.cuda
def test_cuda_pq_search_launches_k2_and_matches_cpu(cuda_device):
    """pq_search on CUDA codes runs K2 and returns the CPU path's top-k."""
    from openibl_tpu_torch.ops.pq import pq_search

    rng = np.random.RandomState(0)
    cb = rng.randn(8, 256, 4).astype(np.float32)
    codes = rng.randint(0, 256, (20_000, 8)).astype(np.uint8)
    q = rng.randn(4, 32).astype(np.float32)
    before = pk.adc_tile.launches
    d, i = pq_search(torch.from_numpy(q).to(cuda_device),
                     torch.from_numpy(codes).to(cuda_device), cb, k=10,
                     precise=True)
    assert pk.adc_tile.launches > before
    dc, ic = pq_search(q, torch.from_numpy(codes), cb, k=10, precise=True)
    torch.testing.assert_close(d.cpu(), dc, rtol=1e-5, atol=1e-5)
    assert [set(r) for r in i.cpu().tolist()] == \
        [set(r) for r in ic.tolist()]
