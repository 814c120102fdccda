"""The port's tooling against the JAX package's, on the CPU:
``utils.logging.tee_stdout`` (tests/test_logging.py), ``utils.profiling``'s
``trace`` and ``device_memory_stats`` (tests/test_engine.py's
TestProfiling), examples/extract_torch.py (one image → the descriptor of
``hub.DescriptorExtractor``) and examples/cluster_torch.py (the centroid
cache on the synthetic world, read back by the JAX package's
``bootstrap_centroids``), each at a tiny size with ``--device cpu``.
"""

import glob
import importlib.util
import json
import os.path as osp
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

from openibl_tpu_torch.utils import logging as tlog  # noqa: E402
from openibl_tpu_torch.utils import profiling  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
H, W = 32, 48


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, osp.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tee_stdout_mirrors_and_restores_like_jax(tmp_path, capsys):
    from openibl_tpu.utils.logging import tee_stdout as jtee

    texts = {}
    for name, tee in (("ours", tlog.tee_stdout), ("theirs", jtee)):
        path = str(tmp_path / name / "log.txt")  # directories made on the spot
        before = sys.stdout
        with tee(path) as stream:
            assert sys.stdout is stream and stream is not before
            print("inside", 3)
        assert sys.stdout is before and stream.closed
        print("after")
        texts[name] = open(path).read()
    assert texts["ours"] == texts["theirs"] == "inside 3\n"
    assert capsys.readouterr().out.count("inside 3") == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "traces"
    with profiling.trace(str(logdir)) as prof:
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    assert prof is not None
    (path,) = glob.glob(str(logdir / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_device_memory_stats_like_jax():
    """At least one entry, as the JAX test asks; each None (no stats) or a
    dict under the JAX package's keys."""
    from openibl_tpu.utils.profiling import device_memory_stats as jstats

    ours, theirs = profiling.device_memory_stats(), jstats()
    assert len(ours) >= 1 and len(theirs) >= 1
    keys = {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    for stats in (ours, theirs):
        for v in stats.values():
            assert v is None or set(v) == keys
    if not torch.cuda.is_available():
        assert ours == {"cpu": None}


def test_extract_example_gives_the_extractors_descriptor(tmp_path, capsys):
    from openibl_tpu_torch.hub import DescriptorExtractor

    img = Image.fromarray(np.random.RandomState(4).randint(
        0, 256, (60, 70, 3)).astype(np.uint8))
    path, out = str(tmp_path / "img.png"), str(tmp_path / "desc.npy")
    img.save(path)
    desc = _example("extract_torch").main(
        [path, "--height", str(H), "--width", str(W), "--device", "cpu",
         "--out", out])
    want = DescriptorExtractor(None, height=H, width=W, device="cpu")(
        Image.open(path).convert("RGB"))[0]
    assert desc.shape == (4096,)
    np.testing.assert_array_equal(desc, want)
    np.testing.assert_array_equal(np.load(out), want)
    assert abs(np.linalg.norm(desc) - 1) < 1e-5
    assert "descriptor: shape=(4096,)" in capsys.readouterr().out


def test_extract_example_needs_a_card_without_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = str(tmp_path / "img.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    with pytest.raises(RuntimeError):
        _example("extract_torch").main([path])


def test_cluster_example_writes_a_cache_the_jax_reader_loads(tmp_path,
                                                             capsys):
    """--device cpu on the synthetic world: the loud warning without the
    MatConvNet weights, (K, 512) centroids, and a cache that the JAX
    package's bootstrap_centroids returns as it is; a second run reads the
    cache instead of clustering again."""
    from openibl_tpu.config import DataConfig as JDataConfig
    from openibl_tpu.config import TrainConfig as JTrainConfig
    from openibl_tpu.engine.pipeline import bootstrap_centroids as jboot

    logs = str(tmp_path / "logs")
    argv = ["-d", "synthetic", "--height", str(H), "--width", str(W),
            "--num-clusters", "8", "--data-dir", str(tmp_path / "data"),
            "--logs-dir", logs, "-b", "8", "--device", "cpu"]
    cluster = _example("cluster_torch")
    centroids, descs = cluster.main(argv)
    err = capsys.readouterr().err
    assert "WARNING" in err and "RANDOM backbone" in err
    assert centroids.shape == (8, 512) and descs.shape[1] == 512
    cfg = JTrainConfig(data=JDataConfig(dataset="synthetic"), arch="vgg16",
                       num_clusters=8, init_dir=logs)
    jc, jd = jboot(cfg, None, None, None)
    np.testing.assert_array_equal(jc, centroids)
    np.testing.assert_array_equal(jd, descs)
    again = cluster.main(argv)
    np.testing.assert_array_equal(again[0], centroids)


def test_launchers_name_the_port_examples():
    """Each scripts/*_torch.sh launches a port example (never a JAX one)
    and parses as bash."""
    import subprocess

    names = ("train_baseline", "train_sfrs", "cluster", "test",
             "train_baseline_slurm", "train_sfrs_slurm", "test_multihost")
    for name in names:
        path = osp.join(ROOT, "scripts", f"{name}_torch.sh")
        text = open(path).read()
        assert "_torch.py" in text
        for line in text.splitlines():
            if "examples/" in line and not line.lstrip().startswith("#"):
                assert "_torch.py" in line, (name, line)
        subprocess.run(["bash", "-n", path], check=True)
