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


def test_queries_per_block_follows_shared_memory():
    # m=64: 64 KB of f32 LUT per query (3 fit), 32 KB in bf16 (7 fit)
    assert pk.queries_per_block(64, 16, precise=True) == 3
    assert pk.queries_per_block(64, 16, precise=False) == 7
    assert pk.queries_per_block(64, 1, precise=True) == 1
    assert pk.queries_per_block(8, 17, precise=True) == pk.MAX_QUERIES_PER_BLOCK
    assert pk.queries_per_block(1024, 1, precise=True) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m, ksub", [(8, 16), (64, 256), (64, 16)])
@pytest.mark.parametrize("q", [1, 3, 16, 17])
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
    with pytest.raises(ValueError, match="shared memory"):
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
