"""The port's SFRS rerank timing tool
(openibl_tpu_torch/tools/time_sfrs_rerank.py) against the JAX script
(scripts/time_sfrs_rerank.py) on the CPU at n=400, 50 subset queries,
dim 32: the same artifact keys in the same order, the same sizes, and both
Jaccard engines within the tool's gate. The JAX script writes under its
``ROOT``, which the test points at a temporary directory, so the committed
logs/sfrs_rerank_timing.json stays as it is.
"""

import importlib.util
import json
import os.path as osp
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch.tools import time_sfrs_rerank as tsr  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SMALL = ["--n", "400", "--n-q", "100", "--queries", "50", "--dim", "32"]


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax_result(tmp_path, monkeypatch, argv):
    spec = importlib.util.spec_from_file_location(
        "time_sfrs_rerank_jax",
        osp.join(ROOT, "scripts", "time_sfrs_rerank.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "ROOT", tmp_path)
    monkeypatch.setattr(sys, "argv", ["time_sfrs_rerank.py"] + argv)
    module.main()
    return json.loads((tmp_path / "logs" / "sfrs_rerank_timing.json")
                      .read_text())


@pytest.mark.parametrize("skip_r1", [False, True])
def test_keys_and_sizes_match_jax(tmp_path, monkeypatch, skip_r1):
    argv = SMALL + (["--skip-r1"] if skip_r1 else [])
    theirs = _jax_result(tmp_path, monkeypatch, argv)
    out = tmp_path / "ours.json"
    ours = tsr.main(argv + ["--device", "cpu", "--out", str(out)])
    assert list(ours) == list(theirs)
    assert json.loads(out.read_text()) == ours
    for key in ("n_union", "n_q", "subset_queries", "k1"):
        assert ours[key] == theirs[key]
    assert ours["backend"] == "cpu" and theirs["backend"] == "cpu"
    assert ours["engines_max_abs_diff"] <= 1e-6


def test_engines_agree_within_the_gate():
    result, host, dev = tsr.time_rerank(400, 100, 50, 32, 20, True, "cpu")
    assert host.shape == dev.shape == (50, 400)
    np.testing.assert_allclose(dev, host, rtol=tsr.RTOL, atol=tsr.ATOL)
    assert result["engines_max_abs_diff"] == float(np.abs(dev - host).max())


def test_features_are_the_jax_scripts_draws():
    f = tsr.features(400, 32)
    rng = np.random.RandomState(0)
    centers = rng.randn(64, 32).astype(np.float32)
    want = centers[rng.randint(64, size=400)] + 0.3 * rng.randn(
        400, 32).astype(np.float32)
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_array_equal(f, want)


def test_disagreeing_engines_fail(tmp_path, monkeypatch):
    def off(*args, **kwargs):
        result, host, dev = real(*args, **kwargs)
        return result, host, dev + 1e-3

    real = tsr.time_rerank
    monkeypatch.setattr(tsr, "time_rerank", off)
    with pytest.raises(SystemExit, match="differ beyond"):
        tsr.main(SMALL + ["--skip-r1", "--device", "cpu", "--out",
                          str(tmp_path / "x.json")])
