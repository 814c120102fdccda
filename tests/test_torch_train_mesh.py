"""The data-parallel train step of the PyTorch port against the JAX package
and against one process, on the CPU: ``shard_tuples`` (bit for bit),
``check_batch_shape`` (the JAX message), the mesh helpers without a group,
``Trainer(mesh=)`` and ``SFRSTrainer(mesh=)`` at world size 1 (the
unsharded step bit for bit), and one 2-process gloo run (a tiny EmbedNet,
K=8): the unjittered SARE-ind step on two 1 + 1 + 2 tuples held to the JAX
``Trainer`` on a 2-device mesh (the conftest's virtual CPU devices), the
jittered baseline step and the jittered SFRS gen-1 step held to the port's
own one-process step on the same two tuples, both ranks bit-equal after
every step, and the helpers' refusals across the ranks.

The step gate is the port's (tests/test_torch_train.py): losses at rtol
1e-5, each trained leaf's update at rtol 1e-3 of its largest entry plus one
ulp of the leaf's largest value, frozen layers bit-equal. gloo sums in its
own order, so two ranks match one process at that gate, not bit for bit.

Marked ``slow``: the full pipelines, run_baseline_training and
run_sfrs_training on 2 gloo ranks against one process (device jitter on,
as the JAX package's multi-process tests), and the training example on 2
ranks. The ranks rendezvous through a ``file://`` store under the test's
temporary directory and never import jax.
"""

import os
import os.path as osp
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch import models  # noqa: E402
from openibl_tpu_torch.data.sampler import shard_tuples  # noqa: E402
from openibl_tpu_torch.engine.sfrs import (SFRSTrainer,  # noqa: E402
                                           make_teacher)
from openibl_tpu_torch.engine.trainer import Trainer  # noqa: E402
from openibl_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax, params_to_jax,
)
from openibl_tpu_torch.parallel import mesh as pmesh  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
K, H, W, SW = 8, 32, 48, 64  # SFRS needs an even conv5 map: 32x64
NEG, POS, TEMPS, LR = 2, 2, (0.07, 0.06), 1e-2
_LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
               "LOCAL_RANK", "SLURM_NTASKS", "SLURM_PROCID",
               "SLURM_NODELIST", "SLURM_LOCALID", "OPENIBL_DIST_INIT_TIMEOUT")


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def two_threads():
    """Two intra-op threads for this test's own steps (tiny shapes; the
    test workers share the host's cores), restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _clean_env(**extra):
    """The environment of a spawned rank: no launcher variables, two
    threads (tiny shapes; the test workers share the host's cores)."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env.update(OMP_NUM_THREADS="2", **extra)
    env["PYTHONPATH"] = ROOT
    return env


def _spawn(tmp, worker, args=(), n=2, timeout=240):
    """``worker`` as ``n`` gloo ranks (argv: store, rank, tmp, *args)."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(tmp / "store"), str(rank),
         str(tmp), *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_clean_env(), cwd=ROOT) for rank in range(n)]
    logs = []
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-3000:]}"
    return logs


def _seeded_state(region=False):
    """Seeded port parameters (centroids spread), made without jax."""
    gen = torch.Generator().manual_seed(0)
    model = models.create("embedregionnet" if region else "embednet",
                          base=models.VGG16(generator=gen),
                          net_vlad=models.NetVLAD(num_clusters=K,
                                                  generator=gen))
    with torch.no_grad():
        model.net_vlad.centroids.mul_(0.1)
    return _state(model)


def _port_model(state, region=False):
    model = models.create("embedregionnet" if region else "embednet",
                          net_vlad=models.NetVLAD(num_clusters=K))
    model.load_state_dict(state)
    model.base.freeze("conv5")
    return model


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _images(seed, t, g, w=W):
    return np.random.RandomState(seed).randint(
        0, 256, (t, g, H, w, 3)).astype(np.uint8)


def _assert_step_close(losses, state, want_losses, want_state, before):
    """The port's step gate: losses at rtol 1e-5, each leaf that moved at
    rtol 1e-3 of its largest update plus one ulp, the others bit-equal."""
    np.testing.assert_allclose(np.asarray(losses, np.float64),
                               np.asarray(want_losses, np.float64),
                               rtol=1e-5)
    assert sorted(state) == sorted(want_state)
    for key, old in before.items():
        old = np.asarray(old)
        got, want = np.asarray(state[key]), np.asarray(want_state[key])
        jup = want - old
        if not np.abs(jup).max():
            np.testing.assert_array_equal(got, old, err_msg=key)
            continue
        ulp = np.spacing(np.abs(old).max())
        np.testing.assert_allclose(got - old, jup, rtol=1e-3,
                                   atol=1e-3 * np.abs(jup).max() + ulp,
                                   err_msg=key)


# --------------------------------------------------------------------------
# shard_tuples, check_batch_shape, the helpers without a group
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,tuple_size,shards", [
    (8, 4, 2), (10, 4, 2), (9, 6, 3), (7, 2, 2), (3, 4, 2), (12, 4, 4),
    (5, 1, 1), (0, 2, 2)])
def test_shard_tuples_matches_jax(n, tuple_size, shards):
    """Bit for bit, a partial last global batch dropped; the shards' rows
    of each step make up the global batch, and every shard takes the same
    number of steps."""
    from openibl_tpu.data.sampler import shard_tuples as jshard

    tuples = [[i, 100 + i, 200 + i] for i in range(n)]
    per = tuple_size // shards
    got = [shard_tuples(tuples, tuple_size, shards, s)
           for s in range(shards)]
    for s, part in enumerate(got):
        assert part == jshard(tuples, tuple_size, shards, s)
        assert len(part) == len(got[0])
    steps = [sum((g[i * per:(i + 1) * per] for g in got), [])
             for i in range(len(got[0]) // max(per, 1))]
    assert sum(steps, []) == tuples[:n - n % tuple_size]


def test_shard_tuples_refuses_what_jax_refuses():
    from openibl_tpu.data.sampler import shard_tuples as jshard

    with pytest.raises(ValueError) as jerr:
        jshard([[0]] * 6, 3, 2, 0)
    with pytest.raises(ValueError) as err:
        shard_tuples([[0]] * 6, 3, 2, 0)
    assert str(err.value) == str(jerr.value)


def test_check_batch_shape_raises_the_jax_message():
    jax, _ = _jax()
    from jax.sharding import Mesh as JMesh

    from openibl_tpu.engine.sfrs import SFRSTrainer as JSFRSTrainer
    from openibl_tpu.engine.trainer import Trainer as JTrainer

    jmesh = JMesh(np.asarray(jax.devices()[:2]), ("data",))
    mesh = pmesh.Mesh(torch.device("cpu"), 0, 2, None)
    net = models.create("embednet", net_vlad=models.NetVLAD(num_clusters=K))
    region = models.create("embedregionnet",
                           net_vlad=models.NetVLAD(num_clusters=K))
    for ours, theirs in ((Trainer(net, mesh=mesh), JTrainer(None, mesh=jmesh)),
                         (SFRSTrainer(region, mesh=mesh),
                          JSFRSTrainer(None, mesh=jmesh))):
        ours.check_batch_shape(4)
        theirs.check_batch_shape(4)
        with pytest.raises(ValueError) as jerr:
            theirs.check_batch_shape(3)
        with pytest.raises(ValueError) as err:
            ours.check_batch_shape(3)
        assert str(err.value) == str(jerr.value)
    Trainer(net).check_batch_shape(3)  # no mesh: any batch


def test_mesh_helpers_without_a_group_do_nothing():
    mesh = pmesh.Mesh(torch.device("cpu"))
    x = torch.arange(6.0).reshape(2, 3)
    for m in (None, mesh):
        pmesh.all_reduce_mean_(m, [x])
        pmesh.broadcast_tensors(m, [x])
        pmesh.barrier(m)
        pmesh.check_same_on_every_rank(m, 3, "x")
        pmesh.check_replicated(m, [x], "x")
        assert pmesh.broadcast_object(m, {"a": 1}) == {"a": 1}
        net = torch.nn.Linear(2, 2)
        assert pmesh.broadcast_module(m, net) is net
    np.testing.assert_array_equal(x.numpy(), np.arange(6.0).reshape(2, 3))


# --------------------------------------------------------------------------
# one step of each trainer, with or without a mesh
# --------------------------------------------------------------------------

def _baseline_step(state, images, mesh, jitter, seed=11):
    model = _port_model(state)
    tr = Trainer(model, loss_type="sare_ind", lr=LR, mesh=mesh,
                 device_jitter=jitter)
    tr.init()
    loss = tr.step(images, torch.Generator().manual_seed(seed)
                   if jitter else None)
    return [float(loss)], _state(model)


def _sfrs_step(state, images, mesh, seed=12):
    model = _port_model(state, region=True)
    teacher = make_teacher(model)
    tr = SFRSTrainer(model, loss_type="sare_ind", lr=LR, neg_num=NEG,
                     temps=TEMPS, mesh=mesh, device_jitter=True)
    tr.init_generation()
    losses = tr.step(teacher, images, 1, torch.Generator().manual_seed(seed))
    return [float(x) for x in losses], _state(model)


# --------------------------------------------------------------------------
# two gloo ranks: the steps against JAX's mesh step and one process
# --------------------------------------------------------------------------

STEP_WORKER = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # the port never imports jax
    import numpy as np, torch, torch.distributed as dist
    from tests.test_torch_train_mesh import _baseline_step, _sfrs_step
    from openibl_tpu_torch.parallel import mesh as pmesh

    store, rank, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    mesh = pmesh.get_mesh(2, device="cpu")
    data = np.load(f"{tmp}/inputs.npz")
    out = {}
    for name, run in (
            ("plain", lambda: _baseline_step(torch.load(f"{tmp}/base.pt"),
                                             data["base"][rank:rank + 1],
                                             mesh, False)),
            ("jitter", lambda: _baseline_step(torch.load(f"{tmp}/base.pt"),
                                              data["base"][rank:rank + 1],
                                              mesh, True)),
            ("sfrs", lambda: _sfrs_step(torch.load(f"{tmp}/sfrs.pt"),
                                        data["sfrs"][rank:rank + 1], mesh))):
        losses, state = run()
        out[f"{name}:losses"] = np.asarray(losses)
        out.update({f"{name}:{k}": v.numpy() for k, v in state.items()})
    # no fallback: the ranks raise where they disagree
    refused = []
    for check in (
            lambda: pmesh.check_same_on_every_rank(mesh, rank, "steps"),
            lambda: pmesh.check_replicated(mesh, [torch.full((3,),
                                                  float(rank))], "x"),
            lambda: pmesh.all_reduce_mean_(pmesh.Mesh(
                mesh.device, rank, 3, mesh.group), [torch.ones(2)])):
        try:
            check()
        except RuntimeError as e:
            refused.append(str(e))
    out["refused"] = np.asarray(refused)
    np.savez(f"{tmp}/out{rank}.npz", **out)
    dist.destroy_process_group()
""")


def test_steps_on_one_and_two_ranks_match_jax_and_one_process(
        tmp_path, monkeypatch, two_threads):
    """World size 1: get_mesh() without a launcher is one rank and no
    group, and the jittered Trainer and SFRSTrainer steps with it are the
    mesh=None steps bit for bit. Two gloo ranks, each one tuple of a
    tuple_size=2 batch: the unjittered SARE-ind step against the JAX
    Trainer on a 2-device mesh (the JAX key stream cannot be drawn in
    torch, so no jitter there); the jittered baseline step and the
    jittered SFRS gen-1 step against the port's one-process step on both
    tuples; both ranks bit-equal; the refusals of a disagreeing step
    count, tensor or world size."""
    jax, jnp = _jax()
    from openibl_tpu import models as jmodels
    from openibl_tpu.engine.trainer import Trainer as JTrainer
    from openibl_tpu.parallel.mesh import get_mesh as jget_mesh

    base = _seeded_state()
    params = params_to_jax(base)
    sfrs = _seeded_state(region=True)
    torch.save(base, tmp_path / "base.pt")
    torch.save(sfrs, tmp_path / "sfrs.pt")
    data = {"base": _images(0, 2, 2 + NEG),
            "sfrs": _images(1, 2, 2 + NEG + POS, SW)}
    np.savez(tmp_path / "inputs.npz", **data)
    _spawn(tmp_path, STEP_WORKER)
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    for key in outs[0]:  # both ranks hold the same bits
        np.testing.assert_array_equal(outs[0][key], outs[1][key], key)
    got = outs[0]
    assert len(got["refused"]) == 3, got["refused"]

    def run(name):
        return (got[f"{name}:losses"],
                {k.split(":", 1)[1]: v for k, v in got.items()
                 if k.startswith(f"{name}:") and k != f"{name}:losses"})

    # the unjittered step against the JAX package's 2-device mesh step
    jtr = JTrainer(jmodels.create("embednet",
                                  net_vlad=jmodels.NetVLAD(num_clusters=K)),
                   loss_type="sare_ind", lr=LR, mesh=jget_mesh(n_devices=2))
    assert jtr.mesh.size == 2
    jp = jax.tree.map(jnp.asarray, params)
    jp, _, jloss = jtr.step(jp, jtr.init(jp), data["base"])
    want = params_from_jax(jax.tree.map(np.asarray, jp))
    before = {k: v.numpy() for k, v in base.items()}
    _assert_step_close(*run("plain"), [float(jloss)],
                       {k: v.numpy() for k, v in want.items()}, before)

    # the jittered steps: one process on both tuples, the same with a
    # world-size-1 mesh (bit for bit), and the two ranks (the step gate)
    for key in _LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    mesh = pmesh.get_mesh(device="cpu")
    assert (mesh.size, mesh.group) == (1, None)
    for name, step, init in (
            ("jitter", lambda m: _baseline_step(base, data["base"], m, True),
             base),
            ("sfrs", lambda m: _sfrs_step(sfrs, data["sfrs"], m), sfrs)):
        one, ws1 = step(None), step(mesh)
        assert ws1[0] == one[0], name
        for key, value in one[1].items():
            assert torch.equal(ws1[1][key], value), (name, key)
        _assert_step_close(*run(name), one[0],
                           {k: v.numpy() for k, v in one[1].items()},
                           {k: v.numpy() for k, v in init.items()})


# --------------------------------------------------------------------------
# slow: the pipelines and the example on 2 gloo ranks against one process
# --------------------------------------------------------------------------

def _pipeline_cfg(kind, data_dir, logs_dir):
    """The JAX package's multi-process configs (tests/test_multihost.py),
    device jitter on; SFRS at 32x64 (the port's even conv5 map)."""
    from openibl_tpu_torch.config import DataConfig, SFRSConfig, TrainConfig

    common = dict(num_clusters=K, loss_type="sare_ind", tuple_size=2,
                  neg_num=2, neg_pool=5, cache_size=16, iters=2, epochs=1,
                  eval_step=1, pca_dim=16, logs_dir=logs_dir,
                  init_dir=logs_dir, print_freq=100, seed=0,
                  device_jitter=True)
    data = DataConfig(dataset="synthetic", scale=None, data_dir=data_dir,
                      height=H, width=W if kind == "baseline" else SW,
                      test_batch_size=8)
    if kind == "baseline":
        return TrainConfig(data=data, **common)
    return SFRSConfig(data=data, generations=2, temperature=TEMPS,
                      pos_num=POS, pos_pool=3, **common)


PIPELINE_WORKER = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # the port never imports jax
    import numpy as np, torch.distributed as dist
    from tests.test_torch_train_mesh import _pipeline_cfg
    from openibl_tpu_torch.engine import pipeline
    from openibl_tpu_torch.parallel.mesh import get_mesh

    store, rank, tmp, kind = sys.argv[1], int(sys.argv[2]), sys.argv[3], \\
        sys.argv[4]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    cfg = _pipeline_cfg(kind, f"{tmp}/data", f"{tmp}/logs_two")
    run = (pipeline.run_baseline_training if kind == "baseline"
           else pipeline.run_sfrs_training)
    out = run(cfg, device="cpu", mesh=get_mesh(2, device="cpu"),
              verbose=rank == 0)
    np.savez(f"{tmp}/out{rank}.npz", __recalls__=np.asarray(out[1]),
             **{k: v.numpy() for k, v in out[0].state_dict().items()})
    dist.destroy_process_group()
""")


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["baseline", "sfrs"])
def test_two_rank_pipeline_matches_one_process(tmp_path, kind):
    """run_baseline_training / run_sfrs_training on 2 gloo ranks (shared
    logs directory, rank 0 writes) against the one-process run of the same
    config: the parameters at rtol 2e-4 / atol 2e-5 and the recalls within
    1e-6, as the JAX package's multi-process tests; both ranks bit-equal."""
    from openibl_tpu_torch import data as datasets
    from openibl_tpu_torch.engine import pipeline

    data_dir = str(tmp_path / "data")
    datasets.create("synthetic", osp.join(data_dir, "synthetic"))
    cfg = _pipeline_cfg(kind, data_dir, str(tmp_path / "logs_one"))
    run = (pipeline.run_baseline_training if kind == "baseline"
           else pipeline.run_sfrs_training)
    out = run(cfg, device="cpu", verbose=False)
    one = {k: v.numpy() for k, v in out[0].state_dict().items()}
    _spawn(tmp_path, PIPELINE_WORKER, args=(kind,), timeout=900)
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    for key in outs[0]:
        np.testing.assert_array_equal(outs[0][key], outs[1][key], key)
    assert sorted(one) == sorted(set(outs[0]) - {"__recalls__"})
    for key, want in one.items():
        np.testing.assert_allclose(outs[0][key], want, rtol=2e-4, atol=2e-5,
                                   err_msg=key)
    np.testing.assert_allclose(outs[0]["__recalls__"], np.asarray(out[1]),
                               atol=1e-6)


@pytest.mark.slow
def test_two_rank_training_example(tmp_path):
    """examples/train_baseline_torch.py as 2 torchrun ranks on the CPU
    (gloo): both finish, rank 0 logs and prints, rank 1 prints nothing, and
    the checkpoint rank 0 wrote holds the trained model."""
    import socket

    from openibl_tpu_torch.utils.checkpoint import read_checkpoint

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    logs = str(tmp_path / "logs")
    args = ["-d", "synthetic", "--data-dir", str(tmp_path / "data"),
            "--logs-dir", logs, "--init-dir", logs, "--height", str(H),
            "--width", str(W), "--num-clusters", str(K), "--neg-num", "2",
            "--features", "16", "--epochs", "1", "--test-batch-size", "8",
            "--tuple-size", "2", "--iters", "2", "--loss-type", "sare_ind",
            "--seed", "0", "--device-jitter", "--n-devices", "2",
            "--device", "cpu"]
    from openibl_tpu_torch import data as datasets

    datasets.create("synthetic", str(tmp_path / "data" / "synthetic"))
    procs = [subprocess.Popen(
        [sys.executable, osp.join(ROOT, "examples", "train_baseline_torch.py"),
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(tmp_path), env=_clean_env(
            MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(r),
            WORLD_SIZE="2", LOCAL_RANK=str(r))) for r in range(2)]
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    assert "mesh: 2 rank(s)" in outs[0][0]
    assert "Testing with PCA reduction:" in outs[0][0]
    assert outs[1][0] == ""
    tree, meta = read_checkpoint(osp.join(logs, "model_best.npz"))
    assert meta["epoch"] == 0 and tree["params"]["vlad"]["assign_w"].shape \
        == (512, K)
