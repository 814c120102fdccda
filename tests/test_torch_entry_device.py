"""The port's entry points run on the card unless the caller asks for the
CPU: with no device argument and no usable card, ``hub.vgg16_netvlad``,
``hub.DescriptorExtractor``, ``serving.RetrievalService``, the probe tool,
``pipeline.run_eval``, ``pipeline.run_sfrs_training``, the device path of
``rerank.JaccardEngine`` and the evaluation and SFRS examples raise instead
of running on the CPU; with ``device="cpu"`` each runs.
``torch.cuda.is_available`` is patched to False, so the raising cases hold
on a machine with a card too.
"""

import importlib.util
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

from openibl_tpu_torch.config import EvalConfig, SFRSConfig  # noqa: E402
from openibl_tpu_torch.engine.pipeline import (  # noqa: E402
    run_eval, run_sfrs_training)
from openibl_tpu_torch.ops.rerank import JaccardEngine  # noqa: E402
from openibl_tpu_torch.hub import (  # noqa: E402
    DescriptorExtractor, vgg16_netvlad)
from openibl_tpu_torch.serving import RetrievalService  # noqa: E402
from openibl_tpu_torch.tools import mosaic_probe  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
H, W = 32, 48
NO_CARD = r"torch.cuda.is_available\(\) is False: pass device='cpu'"


def _index():
    g = np.random.RandomState(0).randn(4, 4096).astype(np.float32)
    return {"descriptors": g / np.linalg.norm(g, axis=1, keepdims=True)}


def _example_main(name, *argv):
    """``main(argv)`` of examples/<name>.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        name, osp.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main(list(argv))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: vgg16_netvlad(),
    lambda: DescriptorExtractor(),
    lambda: RetrievalService(_index(), height=H, width=W),
    lambda: mosaic_probe.main([]),
    lambda: run_eval(EvalConfig()),
    lambda: _example_main("test_model_torch", "--checkpoint", "m.npz"),
    lambda: _example_main("test_pitts_best_torch", "--weights", "w.pth"),
    lambda: _example_main("test_tokyo_best_torch", "--weights", "w.pth"),
    lambda: run_sfrs_training(SFRSConfig()),
    lambda: _example_main("train_sfrs_torch"),
    lambda: JaccardEngine(np.zeros(1, np.int32), np.zeros(1, np.int32),
                          np.ones(1, np.float32), 1).query([0],
                                                           prefer="device"),
], ids=["vgg16_netvlad", "DescriptorExtractor", "RetrievalService",
        "mosaic_probe", "run_eval", "test_model_torch",
        "test_pitts_best_torch", "test_tokyo_best_torch",
        "run_sfrs_training", "train_sfrs_torch", "JaccardEngine_device"])
def test_default_device_is_the_card(no_card, entry):
    with pytest.raises(RuntimeError, match=NO_CARD):
        entry()


def test_vgg16_netvlad_runs_on_cpu():
    model = vgg16_netvlad(num_clusters=8, pca_dim=32, device="cpu")
    assert not model.net_vlad.fused
    assert next(model.parameters()).device.type == "cpu"
    with torch.no_grad():
        desc = model(torch.zeros((1, H, W, 3), dtype=torch.uint8))
    assert desc.shape == (1, 32) and bool(desc.isfinite().all())


def test_descriptor_extractor_runs_on_cpu():
    img = Image.fromarray(np.random.RandomState(1).randint(
        0, 256, (60, 80, 3)).astype(np.uint8))
    desc = DescriptorExtractor(height=H, width=W, device="cpu")(img)
    assert desc.shape == (1, 4096)
    np.testing.assert_allclose(np.linalg.norm(desc, axis=1), 1, atol=1e-5)


def test_retrieval_service_runs_on_cpu():
    svc = RetrievalService(_index(), height=H, width=W, batch_buckets=(1,),
                           device="cpu")
    img = np.random.RandomState(2).randint(0, 256, (H, W, 3)).astype(
        np.uint8)
    matches = svc.query([img], topk=3)[0]
    assert [m["rank"] for m in matches] == [1, 2, 3]
    assert svc._gallery.device.type == "cpu"


def _probe_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "openibl_tpu_torch.tools.mosaic_probe", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_probe_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    res = _probe_cli()
    assert res.returncode != 0 and res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr


def test_probe_cli_runs_on_cpu():
    res = _probe_cli("--device", "cpu")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == "backend: cpu"
    assert [ln.split()[-1] for ln in lines[1:]] == ["OK"] * 7
    assert [ln.strip()[:-len(" OK")].strip() for ln in lines[1:]] == \
        [p.name for p in mosaic_probe.PROBES]
