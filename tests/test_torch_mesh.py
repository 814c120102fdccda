"""The process-group mesh of the PyTorch port (openibl_tpu_torch/parallel/
mesh.py) and what runs on it, against the JAX package, on the CPU.

A mesh in the port is a process group with one device per rank; here the
ranks are gloo processes on the CPU. One small 2-process run (a tiny
EmbedNet, K=8, 32x48 images) is held to the JAX package run in this
process on the conftest's virtual CPU devices: ``extract_features_sharded``
over 13 images (not a multiple of 2) at the JAX package's f32 gate (rtol
1e-4 / atol 1e-5), ``topk_nearest_sharded`` on a 2-device mesh (plain,
int8 with row scales, precomputed squared norms; the same top-k sets and
distances up to ties at 1e-5) and ``evaluate_descriptors(mesh=)`` (the
same recalls). The ranks rendezvous through a ``file://`` store under the
test's temporary directory, and never import jax.
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
from openibl_tpu_torch.data.sampler import slice_indices  # noqa: E402
from openibl_tpu_torch.models import convert  # noqa: E402
from openibl_tpu_torch.ops import distance  # noqa: E402
from openibl_tpu_torch.parallel import mesh as pmesh  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
K, H, W, N_IMG, BS = 8, 32, 48, 13, 4
RTOL, ATOL = 1e-4, 1e-5
TIE = 1e-5
_LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
               "LOCAL_RANK", "SLURM_NTASKS", "SLURM_PROCID",
               "SLURM_NODELIST", "SLURM_LOCALID", "OPENIBL_DIST_INIT_TIMEOUT")


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends: the checkpoints
    written here run to hundreds of MB, and pytest would keep them."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env.update(extra)
    env["PYTHONPATH"] = ROOT
    return env


# --------------------------------------------------------------------------
# the helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,shards", [(13, 2), (10, 3), (8, 4), (3, 4),
                                      (1, 2), (0, 2)])
def test_slice_indices_matches_jax(n, shards):
    from openibl_tpu.data.sampler import slice_indices as jslice

    per = -(-n // shards)
    got = [slice_indices(n, shards, s) for s in range(shards)]
    for s, part in enumerate(got):
        np.testing.assert_array_equal(part, jslice(n, shards, s))
        assert len(part) == per
    if n:
        np.testing.assert_array_equal(np.concatenate(got)[:n], np.arange(n))


@pytest.mark.parametrize("n,m", [(13, 2), (12, 4), (0, 3), (1, 8)])
def test_pad_to_multiple_matches_jax(n, m):
    from openibl_tpu.parallel.mesh import pad_to_multiple as jpad

    assert pmesh.pad_to_multiple(n, m) == jpad(n, m)


def test_merge_topk_matches_jax():
    from openibl_tpu.ops.distance import _merge_topk as jmerge

    _, jnp = _jax()
    rng = np.random.RandomState(0)
    da, db = (np.sort(rng.rand(5, 4).astype(np.float32), axis=1)
              for _ in range(2))
    ia, ib = rng.permutation(40)[:20].reshape(5, 4), \
        rng.permutation(40)[20:].reshape(5, 4) + 40
    want = jmerge(*(jnp.asarray(a) for a in (da, ia, db, ib)), 6)
    got = distance._merge_topk(*(torch.from_numpy(a) for a in
                                 (da, ia, db, ib)), 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_get_mesh_without_a_group_is_one_rank(monkeypatch):
    for key in _LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    pmesh.maybe_init_distributed(device="cpu")  # no launcher: nothing
    assert not torch.distributed.is_initialized()
    mesh = pmesh.get_mesh(device="cpu")
    assert mesh == pmesh.Mesh(torch.device("cpu"), 0, 1, None)
    assert pmesh.get_mesh(1, device="cpu") == mesh
    with pytest.raises(ValueError, match="torchrun --nproc-per-node=2"):
        pmesh.get_mesh(2, device="cpu")
    assert pmesh.process_local_mesh(mesh) == mesh
    assert pmesh.process_local_mesh(None) is None
    x = torch.arange(6).reshape(3, 2)
    assert pmesh.all_gather_rows(mesh, x) is x
    assert pmesh.run_device("cpu", mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh's device"):
        pmesh.run_device("cpu", pmesh.Mesh(torch.device("meta")))


@pytest.mark.parametrize("env,launch", [
    (dict(), None),
    (dict(SLURM_NTASKS="1"), None),
    (dict(MASTER_ADDR="h", MASTER_PORT="1", RANK="1", WORLD_SIZE="2",
          LOCAL_RANK="0"), ("torchrun", "h", "1", 1, 2, 0)),
    (dict(SLURM_NTASKS="4", SLURM_PROCID="3", SLURM_LOCALID="1",
          SLURM_NODELIST="n[1-2]", MASTER_ADDR="h", MASTER_PORT="7"),
     ("slurm", "h", "7", 3, 4, 1)),
    (dict(MASTER_ADDR="h"), "MASTER_PORT/RANK/WORLD_SIZE missing"),
    (dict(RANK="0", WORLD_SIZE="2", SLURM_NTASKS="2"),
     "MASTER_ADDR/MASTER_PORT missing"),
    (dict(SLURM_NTASKS="2", SLURM_NODELIST="n1"),
     "without SLURM_PROCID/MASTER_PORT"),
], ids=["none", "slurm-1-task", "torchrun", "slurm", "torchrun-partial",
        "rank-without-master", "slurm-partial"])
def test_launch_environment(monkeypatch, env, launch):
    for key in _LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if isinstance(launch, str):
        with pytest.raises(RuntimeError, match="refusing to degrade"):
            pmesh.maybe_init_distributed(device="cpu")
        with pytest.raises(RuntimeError, match=launch):
            pmesh._launch_env()
    else:
        assert pmesh._launch_env() == launch


def test_maybe_init_distributed_fails_loudly():
    """Rank 1 of 2 whose rank 0 is not there: the rendezvous times out and
    maybe_init_distributed raises; it never returns as one process."""
    code = textwrap.dedent("""
        import sys
        from openibl_tpu_torch.parallel.mesh import maybe_init_distributed
        try:
            maybe_init_distributed(device="cpu")
        except RuntimeError as e:
            assert "refusing to degrade" in str(e), e
            print("raised as expected", flush=True)
            sys.exit(0)
        print("SILENT DEGRADE", flush=True)
        sys.exit(17)
    """)
    env = _clean_env(MASTER_ADDR="localhost", MASTER_PORT="1", RANK="1",
                     WORLD_SIZE="2", LOCAL_RANK="0",
                     OPENIBL_DIST_INIT_TIMEOUT="3")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0 and "raised as expected" in out, out[-3000:]


def test_maybe_init_distributed_joins_a_one_rank_launch(tmp_path):
    """A one-rank torchrun environment (gloo on the CPU): the group exists,
    the mesh is rank 0 of 1 with it, and the all-gather runs through it."""
    code = textwrap.dedent("""
        import socket, os
        with socket.socket() as s:
            s.bind(("localhost", 0))
            os.environ["MASTER_PORT"] = str(s.getsockname()[1])
        import torch
        import torch.distributed as dist
        from openibl_tpu_torch.parallel import mesh as pmesh
        pmesh.maybe_init_distributed(device="cpu")
        mesh = pmesh.get_mesh(1, device="cpu")
        assert dist.get_backend() == "gloo" and mesh.group is not None
        assert (mesh.rank, mesh.size) == (0, 1)
        x = torch.arange(6, dtype=torch.int64).reshape(3, 2)
        y = pmesh.all_gather_rows(mesh, x)
        assert y is not x and torch.equal(y, x), y
        pmesh.maybe_init_distributed(device="cpu")  # already joined
        dist.destroy_process_group()
        print("one rank ok", flush=True)
    """)
    env = _clean_env(MASTER_ADDR="localhost", RANK="0", WORLD_SIZE="1",
                     LOCAL_RANK="0")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --------------------------------------------------------------------------
# the 2-process gloo run against the JAX package
# --------------------------------------------------------------------------

def _images():
    return np.random.RandomState(11).randint(
        0, 256, (N_IMG, H, W, 3)).astype(np.uint8)


def _knn_inputs():
    """Queries and a 24-row gallery of unit vectors, its int8 rows and
    scales, and the squared norms of the dequantized rows."""
    rng = np.random.RandomState(5)
    q = rng.randn(5, 16).astype(np.float32)
    g = rng.randn(24, 16).astype(np.float32)
    g[7] = g[3]  # a tie across the two shards
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    codes, scales = distance.quantize_index_int8(g)
    sqnorm = ((codes * scales[:, None]) ** 2).sum(1).astype(np.float32)
    return q, g, codes, scales, sqnorm


def _eval_inputs():
    """Descriptors for evaluate_descriptors: 6 queries, an 11-row gallery
    (odd: padded to 12 across 2 ranks), ground truth and panorama ids."""
    rng = np.random.RandomState(8)
    g = rng.randn(11, 16).astype(np.float32)
    q = g[[0, 2, 4, 6, 8, 10]] + 0.3 * rng.randn(6, 16).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    gt = [[0, 1], [2], [5], [6, 7], [9], [10]]
    pids = [i // 2 for i in range(11)]
    return q, g, gt, pids


WORKER = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # the ranks never import jax
    import numpy as np
    import torch
    import torch.distributed as dist
    from openibl_tpu_torch import models
    from openibl_tpu_torch.engine.evaluator import evaluate_descriptors
    from openibl_tpu_torch.ops.distance import topk_nearest_sharded
    from openibl_tpu_torch.parallel.extract import extract_features_sharded
    from openibl_tpu_torch.parallel.mesh import get_mesh

    store, rank, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    mesh = get_mesh(2, device="cpu")
    data = np.load(f"{tmp}/inputs.npz")

    class Arrays:
        def __init__(self, images):
            self.images = images
        def __len__(self):
            return len(self.images)
        def load(self, i):
            return self.images[i]

    model = models.create("embednet",
                          net_vlad=models.NetVLAD(num_clusters=%d))
    model.load_state_dict(torch.load(f"{tmp}/weights.pt", weights_only=True))
    model = model.to(memory_format=torch.channels_last).eval()
    out = {"feats": extract_features_sharded(
        model, Arrays(data["images"]), batch_size=%d, mesh=mesh)}
    q, g = data["q"], data["g"]
    for name, kw in (("plain", {}),
                     ("int8", dict(gallery_scale=data["scales"])),
                     ("sqnorm", dict(gallery_sqnorm=data["sqnorm"]))):
        gal = data["codes"] if name == "int8" else g
        d, i = topk_nearest_sharded(q, gal, mesh, k=6, **kw)
        out[f"d_{name}"], out[f"i_{name}"] = d.numpy(), i.numpy()
    for flags in ((False, False), (True, True)):
        out[f"recalls_{flags[0]:d}"] = evaluate_descriptors(
            data["eq"], data["eg"], list(data["egt"]),
            gallery_pids=list(data["pids"]), nms=flags[0], rerank=flags[1],
            rr_topk=4, print_results=False, mesh=mesh)
    np.savez(f"{tmp}/out{rank}.npz", **out)
    dist.destroy_process_group()
""" % (K, BS))


def _spawn(tmp, worker, n=2, timeout=240):
    store = tmp / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(store), str(rank), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_clean_env(), cwd=ROOT) for rank in range(n)]
    logs = []
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-3000:]}"


def _assert_same_topk(d, i, jd, ji, q, g):
    """Same distances; differing indices only where their distances tie."""
    np.testing.assert_allclose(d, jd, rtol=RTOL, atol=ATOL)
    full = ((q[:, None] - g[None]) ** 2).sum(-1)
    for row, (a, b) in enumerate(zip(i, ji)):
        for x, y in zip(a, b):
            if x != y:
                assert abs(full[row, x] - full[row, y]) < TIE, (row, a, b)


def test_two_gloo_ranks_match_jax(tmp_path):
    jax, jnp = _jax()
    from jax.sharding import Mesh as JMesh

    from openibl_tpu import models as jmodels
    from openibl_tpu.engine.evaluator import evaluate_descriptors as jeval
    from openibl_tpu.ops.distance import topk_nearest_sharded as jtopk
    from openibl_tpu.parallel.extract import (
        extract_features_sharded as jextract)

    jmodel = jmodels.create("embednet",
                            net_vlad=jmodels.NetVLAD(num_clusters=K))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    params["vlad"]["centroids"] = params["vlad"]["centroids"] * 0.1
    torch.save(convert.params_from_jax(params), tmp_path / "weights.pt")
    images = _images()
    q, g, codes, scales, sqnorm = _knn_inputs()
    eq, eg, egt, pids = _eval_inputs()
    # ground-truth lists padded to one length with their first entry
    np.savez(tmp_path / "inputs.npz", images=images, q=q, g=g, codes=codes,
             scales=scales, sqnorm=sqnorm, eq=eq, eg=eg,
             egt=np.asarray([x + [x[0]] * (2 - len(x)) for x in egt]),
             pids=np.asarray(pids))
    _spawn(tmp_path, WORKER)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for key in outs[0].files:  # every rank holds the same result
        np.testing.assert_array_equal(outs[0][key], outs[1][key], key)
    got = outs[0]

    class Arrays:
        def __len__(self):
            return len(images)

        def load(self, i):
            return images[i]

    want = jextract(jmodel.apply, params, Arrays(), batch_size=BS)
    assert got["feats"].shape == (N_IMG, K * 512)
    np.testing.assert_allclose(got["feats"], want, rtol=RTOL, atol=ATOL)

    jmesh = JMesh(np.asarray(jax.devices()[:2]), ("data",))
    for name, kw in (("plain", {}), ("int8", dict(gallery_scale=scales)),
                     ("sqnorm", dict(gallery_sqnorm=sqnorm))):
        gal = codes if name == "int8" else g
        jd, ji = jtopk(jnp.asarray(q), jnp.asarray(gal), jmesh, k=6, **kw)
        deq = codes * scales[:, None] if name == "int8" else g
        _assert_same_topk(got[f"d_{name}"], got[f"i_{name}"], np.asarray(jd),
                          np.asarray(ji), q, deq)
    for nms, rerank in ((False, False), (True, True)):
        want = jeval(eq, eg, egt, gallery_pids=pids, nms=nms, rerank=rerank,
                     rr_topk=4, print_results=False, mesh=jmesh)
        np.testing.assert_array_equal(got[f"recalls_{nms:d}"], want)


# --------------------------------------------------------------------------
# slow: a 2-process run_eval against the single-process one
# --------------------------------------------------------------------------

EVAL_WORKER = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None
    import torch.distributed as dist
    from openibl_tpu_torch.config import DataConfig, EvalConfig
    from openibl_tpu_torch.engine.pipeline import run_eval
    from openibl_tpu_torch.parallel.mesh import get_mesh

    store, rank, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    with open(f"{tmp}/cfg.json") as f:
        kw = json.load(f)
    data = DataConfig(**kw.pop("data"))
    recalls = run_eval(EvalConfig(data=data, **kw), device="cpu",
                       mesh=get_mesh(2, device="cpu"), verbose=rank == 0)
    with open(f"{tmp}/recalls{rank}.json", "w") as f:
        json.dump([float(r) for r in recalls], f)
    dist.destroy_process_group()
""")


@pytest.mark.slow
@pytest.mark.parametrize("dataset", ["synthetic", "tokyo"])
def test_two_rank_run_eval_matches_one_rank(tmp_path, dataset):
    """run_eval(mesh=) on 2 gloo ranks: the synthetic world (fixed shapes,
    PCA fitted on demand from a split extraction) and the mini Tokyo root
    (whole queries on every rank, a split gallery, NMS and the rerank),
    each against the single-process run on the same checkpoint."""
    import json

    from openibl_tpu_torch import data as datasets
    from openibl_tpu_torch.config import DataConfig, EvalConfig
    from openibl_tpu_torch.engine import pipeline
    from openibl_tpu_torch.utils.checkpoint import save_checkpoint
    from tests.test_torch_eval_entry import _tokyo_root

    k = 8
    gen = torch.Generator().manual_seed(3)
    model = models.create(
        "embednet", base=models.VGG16(generator=gen),
        net_vlad=models.NetVLAD(num_clusters=k, generator=gen))
    with torch.no_grad():
        model.net_vlad.centroids.mul_(0.01)
    data_dir = str(tmp_path / "data")
    if dataset == "tokyo":
        _tokyo_root(data_dir, np.random.RandomState(0))
        kw = dict(reduction=False, nms=True, rerank=True, rr_topk=4)
    else:
        kw = dict(reduction=True, pca_dim=16)
    # arranged once, before the ranks read it
    datasets.create(dataset, osp.join(data_dir, dataset))
    data = dict(dataset=dataset, scale=None, data_dir=data_dir, height=H,
                width=W, test_batch_size=BS, workers=1)
    recalls = {}
    for run in ("one", "two"):
        ckpt = str(tmp_path / run / "model_best.npz")
        save_checkpoint(ckpt, {"params": convert.params_to_jax(
            model.state_dict())})
        fields = dict(checkpoint=ckpt, num_clusters=k, **kw)
        if run == "one":
            recalls[run] = pipeline.run_eval(
                EvalConfig(data=DataConfig(**data), **fields), device="cpu",
                verbose=False)
            continue
        run_dir = tmp_path / run
        with open(run_dir / "cfg.json", "w") as f:
            json.dump(dict(data=data, **fields), f)
        _spawn(run_dir, EVAL_WORKER, timeout=600)
        got = [json.load(open(run_dir / f"recalls{r}.json")) for r in (0, 1)]
        assert got[0] == got[1]
        recalls[run] = got[0]
    np.testing.assert_array_equal(recalls["two"], recalls["one"])
