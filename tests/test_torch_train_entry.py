"""The port's baseline training run beyond its parity with the JAX pipeline
(tests/test_torch_pipeline.py), on the CPU: a resumed run, the paths it
refuses, the run without a card, the .npz files written where h5py is not
installed, and the entry point examples/train_baseline_torch.py, whose
checkpoint the JAX package's load_checkpoint reads.
"""

import os
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu.utils.checkpoint import load_checkpoint  # noqa: E402
from openibl_tpu_torch.config import DataConfig, TrainConfig  # noqa: E402
from openibl_tpu_torch.engine import pipeline  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
K = 8


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends: the checkpoints
    written here run to hundreds of MB, and pytest would keep them."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(tmp, logs, **kw):
    fields = dict(
        data=DataConfig(dataset="synthetic", scale=None,
                        data_dir=str(tmp / "data"), height=32, width=48,
                        test_batch_size=8),
        num_clusters=K, loss_type="sare_ind", tuple_size=1, neg_num=2,
        neg_pool=1000, cache_size=4, epochs=2, step_size=1, eval_step=1,
        pca_dim=16, augment=False, logs_dir=str(tmp / logs),
        init_dir=str(tmp / "init"), print_freq=100, seed=0,
    )
    fields.update(kw)
    return TrainConfig(**fields)


def test_resume_continues_the_run(tmp_path):
    """A run resumed from its epoch-0 checkpoint (parameters, SGD momentum,
    negative cache, best recall) ends where the uninterrupted run ends."""
    full = _cfg(tmp_path, "full")
    pipeline.run_baseline_training(full, device="cpu", verbose=False)
    resumed = _cfg(tmp_path, "resumed",
                   resume=osp.join(full.logs_dir, "checkpoint0.npz"))
    _, _, history = pipeline.run_baseline_training(resumed, device="cpu",
                                                   verbose=False)
    assert [e for e, _ in history] == [1]
    a = np.load(osp.join(full.logs_dir, "checkpoint1.npz"))
    b = np.load(osp.join(resumed.logs_dir, "checkpoint1.npz"))
    keys = [k for k in a.files if k.startswith("leaf:")]
    assert keys and sorted(keys) == sorted(k for k in b.files
                                           if k.startswith("leaf:"))
    for key in keys:
        np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-6,
                                   err_msg=key)


def test_pipeline_refuses_unported_paths(tmp_path):
    cfg = _cfg(tmp_path, "logs")
    from openibl_tpu_torch.parallel.mesh import Mesh

    # the mesh branch is ported; its rank's device must be of the run's type
    with pytest.raises(ValueError, match="mesh's device"):
        pipeline.run_baseline_training(cfg, device="cpu",
                                       mesh=Mesh(torch.device("meta")))
    assert not osp.exists(cfg.data.data_dir)


def test_no_card_raises_before_any_work(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(tmp_path, "logs")
    with pytest.raises(RuntimeError, match="is_available"):
        pipeline.run_baseline_training(cfg)
    assert not osp.exists(cfg.data.data_dir)


def test_cache_and_pca_files_fall_back_to_npz_without_h5py(tmp_path,
                                                           monkeypatch):
    """Where h5py is not installed, the centroid cache and the PCA fit are
    written as .npz under the same names, and read back from there."""
    import importlib.util

    from openibl_tpu_torch import utils
    from openibl_tpu_torch.ops.pca import load_pca

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py"
                        else real(name, *a))
    assert utils.array_file("x/pca.h5") == "x/pca.npz"
    assert utils.array_file("x/c.hdf5") == "x/c.npz"
    assert utils.array_file("x/c.npz") == "x/c.npz"
    cfg = _cfg(tmp_path, "logs")
    dataset = pipeline.load_dataset(cfg)
    model = pipeline.build_model(cfg, dataset, "cpu")
    cache = osp.join(cfg.init_dir, f"vgg16_synthetic_{K}_desc_cen.npz")
    assert osp.isfile(cache)
    again = pipeline.build_model(cfg, dataset, "cpu")  # reads the cache
    assert torch.equal(again.net_vlad.centroids, model.net_vlad.centroids)
    feats = torch.from_numpy(np.random.RandomState(0).randn(20, 64)
                             .astype(np.float32))
    path = utils.array_file(osp.join(cfg.logs_dir, "pca_params_x.h5"))
    os.makedirs(cfg.logs_dir)
    pca = pipeline._train_pca(feats, 16, True, path, 0)
    assert path.endswith(".npz") and pca.n_components == 16
    np.testing.assert_array_equal(load_pca(path)["lams"].shape, (16,))


@pytest.mark.parametrize("name", ["a.h5", "a.hdf5", "a.npz"])
def test_array_files_round_trip_through_one_writer(tmp_path, name):
    """utils.write_arrays / read_arrays hold the centroid cache and the PCA
    fit in either format, chosen by the suffix; the JAX load_pca reads the
    port's PCA file in both of the formats it knows."""
    from openibl_tpu.ops.pca import load_pca as jax_load_pca
    from openibl_tpu_torch.ops.pca import save_pca
    from openibl_tpu_torch.utils import read_arrays, write_arrays

    rng = np.random.RandomState(0)
    arrays = {"x": rng.randn(5, 3).astype(np.float32),
              "y": np.arange(4, dtype=np.int64)}
    path = str(tmp_path / name)
    write_arrays(path, arrays)
    assert sorted(os.listdir(tmp_path)) == [name]  # no temporary left
    for got, want in zip(read_arrays(path, ("y", "x")),
                         (arrays["y"], arrays["x"])):
        np.testing.assert_array_equal(got, want)
    if name.endswith(".hdf5"):
        return  # the JAX load_pca knows .h5 and .npz only
    params = {"U": rng.randn(6, 2).astype(np.float32),
              "lams": np.array([2.0, 1.0], np.float32),
              "mu": rng.randn(6, 1).astype(np.float32)}
    pca_path = str(tmp_path / ("pca_" + name))
    save_pca(params, pca_path)
    for k, v in jax_load_pca(pca_path).items():
        np.testing.assert_array_equal(v, params[k])


def test_watchdog_warns_while_a_phase_runs_and_stops_after():
    import time

    from openibl_tpu_torch.utils.watchdog import Watchdog

    lines = []
    with Watchdog(warn_after=0.02, log=lines.append).watch("phase x"):
        time.sleep(0.15)
    seen = len(lines)
    time.sleep(0.1)
    assert seen >= 2 and len(lines) == seen
    assert "phase 'phase x'" in lines[0] and "warning #1" in lines[0]


def _example(args, **kw):
    return subprocess.run(
        [sys.executable, osp.join(ROOT, "examples", "train_baseline_torch.py"),
         *args], capture_output=True, text=True, timeout=300, **kw)


def _example_args(tmp_path, logs, init=None):
    return ["-d", "synthetic", "--data-dir", str(tmp_path / "data"),
            "--logs-dir", logs, "--init-dir", init or logs, "--height", "32",
            "--width", "48", "--num-clusters", str(K), "--neg-num", "2",
            "--features", "16", "--epochs", "1", "--test-batch-size", "8",
            "--loss-type", "triplet", "--seed", "0", "--device", "cpu"]


def _printed_recalls(stdout):
    """The recall lines the evaluator printed after the PCA reduction."""
    tail = stdout.split("Testing with PCA reduction:")[1]
    return [line for line in tail.splitlines() if line.strip()
            .startswith("top-")]


def test_example_trains_on_the_cpu_and_jax_reads_its_checkpoint(tmp_path):
    """The example as rank 0 of a one-rank torchrun launch: it joins a
    gloo group and runs the pipeline's mesh branch with real collectives.
    Its checkpoint equals, bit for bit, and its printed test recalls equal
    those of the same config run in this process without a mesh (which
    reads the centroid cache the example wrote); the JAX package reads the
    checkpoint."""
    import contextlib
    import importlib.util
    import io
    import socket

    from openibl_tpu_torch.engine.evaluator import _print_recalls

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("SLURM_NTASKS", "SLURM_PROCID", "LOCAL_RANK")}
    # two threads on both sides (the test workers share the host's cores):
    # the same thread count keeps the two runs' sums in one order
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
               WORLD_SIZE="1", OMP_NUM_THREADS="2")
    logs = str(tmp_path / "logs")
    res = _example(_example_args(tmp_path, logs), cwd=str(tmp_path), env=env)
    assert res.returncode == 0, res.stderr
    assert "mesh: 1 rank(s)" in res.stdout
    assert "Testing with PCA reduction:" in res.stdout

    spec = importlib.util.spec_from_file_location(
        "train_baseline_torch",
        osp.join(ROOT, "examples", "train_baseline_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    _, cfg = example.parse(_example_args(tmp_path, str(tmp_path / "one"),
                                         init=logs))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _, recalls, _ = pipeline.run_baseline_training(cfg, device="cpu",
                                                       verbose=False)
    finally:
        torch.set_num_threads(threads)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _print_recalls(recalls, (1, 5, 10))
    assert _printed_recalls(res.stdout) == _printed_recalls(
        "Testing with PCA reduction:\n" + printed.getvalue())
    a = np.load(osp.join(logs, "model_best.npz"))
    b = np.load(osp.join(cfg.logs_dir, "model_best.npz"))
    keys = [k for k in a.files if k.startswith("leaf:")]
    assert keys and sorted(keys) == sorted(k for k in b.files
                                           if k.startswith("leaf:"))
    for key in keys:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    from openibl_tpu import models as jmodels

    jax = pytest.importorskip("jax")
    jmodel = jmodels.create("embednet",
                            net_vlad=jmodels.NetVLAD(num_clusters=K))
    target = {"params": jax.tree.map(np.asarray,
                                     jmodel.init(jax.random.PRNGKey(0)))}
    loaded, meta = load_checkpoint(osp.join(logs, "model_best.npz"), target,
                                   strict=True)
    assert meta["epoch"] == 0
    assert loaded["params"]["vlad"]["assign_w"].shape == (512, K)
    with open(osp.join(logs, "log.txt")) as f:
        assert "device: cpu" in f.read()


def test_example_without_a_device_needs_the_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _example(["-d", "synthetic", "--data-dir", str(tmp_path / "data"),
                    "--logs-dir", str(tmp_path / "logs")], env=env,
                   cwd=str(tmp_path))
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert not osp.exists(tmp_path / "data")
