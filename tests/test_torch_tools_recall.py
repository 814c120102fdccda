"""The port's recall tools (openibl_tpu_torch/tools/ivf_recall.py and
pq_recall.py) against the JAX scripts' functions (scripts/ivf_recall.py,
scripts/pq_recall.py, loaded as tests/test_ivf.py loads them) on one
descriptor array: the port's own ``model_descriptors`` on the CPU at
n_places=32, imgs_per_place=3, 32x48.

Both sides draw the same k-means++ rows from one seed, but on these
descriptors (three near-duplicate views of each place) the two Lloyd runs
part after their first assignment: centroids ~1e-4 apart, 10 of 104 rows in
another cell. So the IVF curves differ at low nprobe by a few hits (2 of
240 at nlist 8, 3 at nlist 16). With the JAX package's IVF tables the
port's curve is within one hit of the JAX curve at every nprobe (equal at
nlist 8; at nlist 16 one query's k-th neighbour ties at nprobe 1), which
shows the rest of the gap is the k-means. The gates of tests/test_ivf.py
and tests/test_pq.py hold for the port's own descriptors and indexes.
"""

import importlib.util
import json
import os.path as osp
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch.tools import ivf_recall, pq_recall  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
N_QUERIES, K = 24, 10
ONE_HIT = 1.0 / (N_QUERIES * K)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_jax", osp.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def desc():
    return ivf_recall.model_descriptors(n_places=32, imgs_per_place=3,
                                        height=32, width=48, device="cpu")


def _jax_build_ivf(g, nlist):
    from openibl_tpu.ops.ivf import build_ivf

    ivf = build_ivf(np.asarray(g), nlist=nlist)
    return {"centroids": np.asarray(ivf["centroids"]),
            "lists": np.asarray(ivf["lists"])}


def test_model_descriptors_are_embednet_k8(desc):
    assert desc.shape == (32 * 4, 8 * 512) and desc.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(desc, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("nlist", [8, 16])
def test_recall_curve_matches_jax(desc, nlist, monkeypatch):
    jax_curve = _script("ivf_recall").recall_curve(desc, n_queries=N_QUERIES,
                                                   nlist=nlist, k=K)
    ours = ivf_recall.recall_curve(desc, N_QUERIES, nlist, k=K,
                                   device="cpu")
    assert list(ours) == list(jax_curve) == ivf_recall.nprobe_sweep(nlist)
    for nprobe in ours:
        assert abs(ours[nprobe] - jax_curve[nprobe]) <= 3 * ONE_HIT + 1e-12, (
            ours, jax_curve)
    # with the JAX package's tables the gap closes to a tie at most
    monkeypatch.setattr(ivf_recall, "build_ivf",
                        lambda g, nlist: _jax_build_ivf(g, nlist))
    same = ivf_recall.recall_curve(desc, N_QUERIES, nlist, k=K, device="cpu")
    assert same == pytest.approx(jax_curve, abs=ONE_HIT + 1e-12)


def test_recall_curve_gate(desc):
    """tests/test_ivf.py:140-144 on the port's descriptors and index."""
    curve = ivf_recall.recall_curve(desc, n_queries=N_QUERIES, nlist=16, k=K,
                                    device="cpu")
    assert curve[16] == 1.0, curve  # full probe == exact (tie-tolerant)
    assert curve[2] >= 0.95, curve  # nlist/8 operating point
    vals = [curve[p] for p in sorted(curve)]
    assert all(a <= b + 1e-9 for a, b in zip(vals, vals[1:])), curve


def test_recall_tables_match_jax_and_gate(desc):
    """tests/test_pq.py:383-388's gates on the port's tables, and the JAX
    script's tables on the same array: PQ equal, IVFADC within the IVF
    k-means gap above."""
    pq_rows, ivfpq_rows, m_ivf, n_g = pq_recall.recall_tables(
        desc, n_queries=N_QUERIES, k=K, ms=[16], nlist=8, opq_iters=0,
        device="cpu")
    j_pq, j_ivfpq, j_m, j_n = _script("pq_recall").recall_tables(
        desc, n_queries=N_QUERIES, k=K, ms=[16], nlist=8, opq_iters=0)
    assert (m_ivf, n_g) == (j_m, j_n) == (16, len(desc) - N_QUERIES)
    assert list(pq_rows) == list(j_pq) and list(ivfpq_rows) == list(j_ivfpq)
    assert list(pq_rows[16]) == list(j_pq[16])
    for key, value in pq_rows[16].items():
        assert value == pytest.approx(j_pq[16][key], abs=1e-9), key
    for nprobe in ivfpq_rows:
        assert abs(ivfpq_rows[nprobe] - j_ivfpq[nprobe]) <= 3 * ONE_HIT \
            + 1e-12, (ivfpq_rows, j_ivfpq)
    assert pq_rows[16]["recall_at_k"] >= 0.95, pq_rows
    assert pq_rows[16]["recall_at_k_in_top_4k"] >= 0.98, pq_rows
    assert ivfpq_rows[8] >= 0.98, ivfpq_rows  # full probe
    vals = [ivfpq_rows[p] for p in sorted(ivfpq_rows)]
    assert all(a <= b + 1e-9 for a, b in zip(vals, vals[1:]))


def test_recall_tables_opq_columns(desc):
    """With OPQ: the opq_ columns beside the PQ ones, the JAX script's
    names, recalls in [0, 1] and a finite reconstruction error. On the
    first 256 dimensions, renormalized: each OPQ alternation is a D x D
    SVD, which at D = 4096 would set the file's time."""
    small = np.ascontiguousarray(desc[:, :256])
    small /= np.linalg.norm(small, axis=1, keepdims=True)
    pq_rows, _, _, _ = pq_recall.recall_tables(
        small, n_queries=N_QUERIES, k=K, ms=[8], nlist=4, opq_iters=1,
        device="cpu")
    row = pq_rows[8]
    assert list(row) == [
        "recall_at_k", "recall_at_k_in_top_4k", "recon_mse",
        "opq_recall_at_k", "opq_recall_at_k_in_top_4k", "opq_recon_mse"]
    assert all(0.0 <= row[k] <= 1.0 for k in row if "recall" in k)
    assert np.isfinite(row["opq_recon_mse"]) and row["opq_recon_mse"] >= 0


def test_main_writes_the_artifacts(tmp_path):
    out_ivf, out_pq = tmp_path / "ivf.json", tmp_path / "pq.json"
    small = ["--n-places", "16", "--imgs-per-place", "2", "--height", "32",
             "--width", "48", "--n-queries", "8", "--device", "cpu"]
    res = ivf_recall.main(small + ["--nlist", "4", "--out", str(out_ivf)])
    on_disk = json.loads(out_ivf.read_text())
    assert on_disk["recall_at_k_vs_exact"] == {
        str(k): v for k, v in res["recall_at_k_vs_exact"].items()}
    assert on_disk["device"] == "cpu" and on_disk["nlist"] == 4
    res = pq_recall.main(small + ["--nlist", "4", "--ms", "8",
                                  "--opq-iters", "0", "--out", str(out_pq)])
    on_disk = json.loads(out_pq.read_text())
    assert set(on_disk) == {"gallery", "n_queries", "k", "descriptor_dim",
                            "pq", "ivfpq", "device"}
    assert on_disk["ivfpq"]["m"] == 8 == res["ivfpq"]["m"]
