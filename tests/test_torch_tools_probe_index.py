"""The port of scripts/probe_index_paths.py
(openibl_tpu_torch/tools/probe_index_paths.py) on the CPU: the f32
variants against the port's ``topk_nearest``, the int8 arithmetic against
numpy integers bit for bit, the streaming variants against the JAX
package's ``topk_nearest`` on the same storage, and the tool end to end at
a small size. Ties are compared as sets and distances: two rankings may
swap ids only where their distances lie within the tie tolerance of the
k-th. The ``cuda`` test holds ``int8_native`` on the card to its CPU twin
(`python -m pytest --noconftest -m cuda
tests/test_torch_tools_probe_index.py`).
"""

import argparse
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch.ops.distance import (  # noqa: E402
    quantize_index_int8, topk_nearest)
from openibl_tpu_torch.tools import probe_index_paths as probe  # noqa: E402

N, Q, D, K = 3000, 6, 64, 10
VARIANTS = ["f32_full", "f32_norms", "bf16_direct", "f16_stream",
            "int8_stream", "int8_colscale", "int8_native", "ivf_gather_np4"]


@pytest.fixture(scope="module")
def world():
    """Unit-norm gallery and queries (seeded, on the CPU) and the probe's
    variants over them, IVF included (16 cells)."""
    args = argparse.Namespace(n=N, d=D, q=Q, iters=2)
    g, qs = probe.inputs(args, torch.device("cpu"))
    ivf = probe.build_ivf(g, nlist=16, iters=5)
    return {"g": g, "q": qs[0], "fns": probe.variants(g, K, ivf, nprobe=4),
            "ivf": ivf}


def same_up_to_ties(d_a, i_a, d_b, i_b, tie):
    """Each row: the distances within ``tie``; the ids the same set, but for
    ids whose distance lies within ``tie`` of the row's k-th."""
    d_a, d_b = np.asarray(d_a, np.float64), np.asarray(d_b, np.float64)
    i_a, i_b = np.asarray(i_a), np.asarray(i_b)
    np.testing.assert_allclose(d_a, d_b, rtol=0, atol=tie)
    for r in range(len(d_a)):
        kth = max(d_a[r, -1], d_b[r, -1])
        dist = dict(zip(i_a[r], d_a[r])) | dict(zip(i_b[r], d_b[r]))
        for i in set(i_a[r]) ^ set(i_b[r]):
            assert kth - dist[i] <= tie, (r, i, kth, dist[i])


def test_variant_names_are_the_scripts(world):
    assert list(world["fns"]) == VARIANTS


@pytest.mark.parametrize("name", ["f32_full", "f32_norms"])
def test_f32_variants_equal_topk_nearest(world, name):
    d, i = world["fns"][name](world["q"])
    d_ref, i_ref = topk_nearest(world["q"], world["g"], k=K)
    same_up_to_ties(d, i, d_ref, i_ref, tie=1e-5)


def test_int8_quantization_is_the_index_quantization(world):
    """The gallery's codes and scales are ops.distance.quantize_index_int8's
    (numpy), bit for bit."""
    codes, scales = probe.quantize_rows_int8(world["g"])
    codes_np, scales_np = quantize_index_int8(world["g"].numpy())
    assert codes.dtype == torch.int8
    assert np.array_equal(codes.numpy(), codes_np)
    assert np.array_equal(scales.numpy(), scales_np)


def test_int8_native_is_numpy_integer_arithmetic(world):
    """int8_native's query quantization and int32 product equal numpy's
    (int64 sums of the same int8 values) bit for bit, and its ranking is
    the numpy arithmetic's up to ties."""
    q = world["q"].numpy()
    qscale = np.max(np.abs(q), axis=1) / np.float32(127.0)
    qi_np = np.clip(np.rint(q / qscale[:, None]), -127, 127).astype(np.int8)
    qi, qs = probe.quantize_queries_int8(world["q"])
    assert np.array_equal(qi.numpy(), qi_np)
    assert np.array_equal(qs.numpy(), qscale)
    codes, scales = quantize_index_int8(world["g"].numpy())
    prod = probe.int8_product(qi, torch.from_numpy(codes))
    want = qi_np.astype(np.int64) @ codes.astype(np.int64).T
    assert prod.dtype == torch.int32
    assert np.array_equal(prod.numpy().astype(np.int64), want)

    g = world["g"].numpy()
    d_np = (np.sum(q * q, axis=1, keepdims=True)
            + np.sum(g * g, axis=1)[None, :]
            - 2.0 * want.astype(np.float32) * (qscale[:, None]
                                               * scales[None, :]))
    i_np = np.argsort(d_np, axis=1, kind="stable")[:, :K]
    d, i = world["fns"]["int8_native"](world["q"])
    same_up_to_ties(d, i, np.take_along_axis(d_np, i_np, 1), i_np, tie=1e-5)


@pytest.mark.parametrize("name", ["f16_stream", "int8_stream"])
def test_stream_variants_equal_jax_topk_nearest(world, name):
    """The streaming scans against the JAX package's topk_nearest over the
    same f16 rows / int8 codes and scales."""
    jnp = pytest.importorskip("jax.numpy")
    from openibl_tpu.ops import distance as jd

    g = world["g"].numpy()
    if name == "f16_stream":
        kw = {"gallery": jnp.asarray(g.astype(np.float16))}
    else:
        codes, scales = quantize_index_int8(g)
        kw = {"gallery": jnp.asarray(codes),
              "gallery_scale": jnp.asarray(scales)}
    d_j, i_j = jd.topk_nearest(jnp.asarray(world["q"].numpy()), k=K,
                               full_path=False, **kw)
    d, i = world["fns"][name](world["q"])
    same_up_to_ties(d, i, np.asarray(d_j), np.asarray(i_j), tie=1e-5)


def test_ivf_variant_is_ivf_search(world):
    d, i = world["fns"]["ivf_gather_np4"](world["q"])
    d_ref, i_ref = probe.ivf_search(world["q"], world["g"],
                                    world["ivf"]["centroids"],
                                    world["ivf"]["lists"], k=K, nprobe=4)
    assert torch.equal(i, i_ref) and torch.equal(d, d_ref)


def test_main_prints_the_scripts_lines(capsys):
    out = probe.main(["--n", "2048", "--q", "4", "--d", "64", "--iters",
                      "2", "--nlist", "16", "--nprobe", "4",
                      "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"platform": "cpu", "device": "cpu"}
    rows = lines[1:9]
    assert [r["variant"] for r in rows] == VARIANTS
    for r in rows:
        assert "error" not in r, r
        assert r["ms_per_call"] > 0 and (r["q"], r["n"]) == (4, 2048)
    assert sorted(lines[9]["top10_overlap_vs_f32"]) == [
        "bf16_direct", "int8_colscale", "int8_native"]
    assert all(0 <= v <= 1 for v in lines[9]["top10_overlap_vs_f32"].values())
    assert lines[10] == {"summary": {r["variant"]: r["ms_per_call"]
                                     for r in rows}}
    assert out["rows"] == rows and out["summary"] == lines[10]["summary"]


@pytest.mark.cuda
def test_cuda_int8_native_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_tools_probe_index.py`")
    args = argparse.Namespace(n=4096, d=256, q=16, iters=1)
    g, qs = probe.inputs(args, torch.device("cpu"))
    q = qs[0]
    qi, _ = probe.quantize_queries_int8(q)
    codes, _ = probe.quantize_rows_int8(g)
    cpu = probe.int8_product(qi, codes)
    card = probe.int8_product(qi.cuda(), codes.cuda())
    assert torch.equal(card.cpu(), cpu)
    d_c, i_c = probe.variants(g, K)["int8_native"](q)
    d_g, i_g = probe.variants(g.cuda(), K)["int8_native"](q.cuda())
    same_up_to_ties(d_g.cpu(), i_g.cpu(), d_c, i_c, tie=1e-5)
