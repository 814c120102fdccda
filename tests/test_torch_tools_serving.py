"""The port's serving latency tool (openibl_tpu_torch/tools/bench_serving.py)
on the CPU: a 512-row gallery at 32x48, every variant through
``RetrievalService``, rows written per variant, resume per pass, unknown
variants refused, and ``--device-time`` refused off the card (exit 2).
The JAX script's table shape (scripts/bench_serving.py: the header keys,
``bs<bucket>`` rows with ``p50_ms``, ``p50_ms_per_image`` and ``iters``)
is the artifact's. The services' model is cut to a 64-d descriptor.
"""

import json
import math
import shutil

import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch.tools import bench_serving as bs  # noqa: E402

SMALL = ["--device", "cpu", "--gallery-size", "512", "--height", "32",
         "--width", "48", "--iters", "1", "--ivf-nlist", "8",
         "--ivf-nprobe", "2", "--dim", "64"]


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def small_model(monkeypatch):
    """The services' model cut to NetVLAD K=8 and a 64-d PCA (``--dim
    64``): the tool's flow is under test here, and the full 32768 -> 4096
    projection would set the file's time on a loaded CPU."""
    from openibl_tpu_torch import serving

    real = serving.vgg16_netvlad

    def small(weights, pca_params=None, device="cuda"):
        return real(weights, num_clusters=8, pca_dim=64,
                    pca_params=pca_params, device=device)

    monkeypatch.setattr(serving, "vgg16_netvlad", small)


def test_every_variant_written_then_resumed(tmp_path, capsys):
    out = tmp_path / "serving.json"
    summary = bs.main(SMALL + ["--out", str(out)])
    assert summary["measured"] == list(bs.VARIANTS)
    table = json.loads(out.read_text())
    assert list(table) == ["gallery_size", "dim", "iters", "resolution",
                           "platform", "ivf", "variants"]
    assert table["platform"] == "cpu" and table["gallery_size"] == 512
    assert table["dim"] == 64
    assert table["resolution"] == [32, 48]
    assert list(table["variants"]) == list(bs.VARIANTS)
    for name, row in table["variants"].items():
        assert list(row) == ["bs1", "bs4", "bs16"], name
        for bucket, cell in row.items():
            b = int(bucket[2:])
            assert cell["iters"] == 5
            assert math.isfinite(cell["p50_ms"]) and cell["p50_ms"] > 0
            assert cell["p50_ms_per_image"] == pytest.approx(
                cell["p50_ms"] / b, abs=1e-4)
    capsys.readouterr()
    again = bs.main(SMALL + ["--out", str(out)])
    assert again["measured"] == [] and "skipped" in again
    assert json.loads(out.read_text()) == table  # nothing rewritten


def test_resume_is_per_pass(tmp_path):
    """A row holding only the device pass's key does not mark the
    synchronous pass done, and a kept row is merged, not replaced."""
    out = tmp_path / "serving.json"
    out.write_text(json.dumps({"variants": {
        "f16": {"device_ms_per_query": 1.0},
        "f32": {"bs1": {"p50_ms": 1.0}, "device_ms_per_query": 2.0}}}))
    summary = bs.main(SMALL + ["--variants", "f32,f16", "--out", str(out)])
    assert summary["measured"] == ["f16"]
    rows = json.loads(out.read_text())["variants"]
    assert rows["f32"] == {"bs1": {"p50_ms": 1.0}, "device_ms_per_query": 2.0}
    assert rows["f16"]["device_ms_per_query"] == 1.0
    assert {"bs1", "bs4", "bs16"} <= set(rows["f16"])


def test_unknown_variants_refused(tmp_path):
    with pytest.raises(SystemExit, match="unknown variants"):
        bs.main(SMALL + ["--variants", "f32,f64", "--out",
                         str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_device_time_needs_the_card(tmp_path, capsys):
    with pytest.raises(SystemExit) as err:
        bs.main(SMALL + ["--device-time", "--out", str(tmp_path / "x.json")])
    assert err.value.code == 2
    assert "needs --device cuda" in capsys.readouterr().err
    assert not (tmp_path / "x.json").exists()
