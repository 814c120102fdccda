"""Mesh-sharded serving on the PyTorch port against the JAX package, on the
CPU: ``pq_search_sharded`` (ops/pq.py) and ``RetrievalService(mesh=)``
(serving.py) on two gloo ranks, held to the JAX package's mesh functions on
two of the conftest's virtual CPU devices and to the port's own
single-device answers.

The cases are those of tests/test_sharding.py's ``TestPQSearchSharded``
(64 and 61 rows, OPQ, k larger than a shard; indices equal, distances at
rtol/atol 1e-5 with ``precise=True``) and of tests/test_serving.py's mesh
tests (PQ over 29 rows, exact and int8 over 30; the IVFADC and
``pq_rerank`` fall-backs to one device, and IVF over exact rows served
exact, each with the JAX warning). Both services load one .npz of the JAX
model (full width at 32x48, its centroids shrunk so images get distinct
descriptors). Ids must be equal; distances use the JAX tests' tolerances.
The ranks also show that each holds ceil(N/2) rows, that ``close()`` ends
``follow()``, and that a follower idle past its group's timeout (3 s) still
answers the next query. One 2-process spawn runs every rank-side case
while this process runs the JAX side; the ranks never import jax.
Marked ``slow``: examples/serve_torch.py on two ranks under torchrun.
"""

import json
import os
import os.path as osp
import shutil
import signal
import subprocess
import sys
import textwrap
import time
import urllib.request
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch.ops import distance  # noqa: E402
from openibl_tpu_torch.ops.pq import pq_search, pq_search_sharded  # noqa: E402
from openibl_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from openibl_tpu_torch.serving import RetrievalService  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
H, W = 32, 48
KW = dict(height=H, width=W, batch_buckets=(1,))
EXACT_TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_serving.py:488
PQ_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_serving.py:433
IDLE_S, GROUP_TIMEOUT_S = 8, 3
_LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
               "LOCAL_RANK", "SLURM_NTASKS", "SLURM_PROCID",
               "SLURM_NODELIST", "SLURM_LOCALID", "OPENIBL_DIST_INIT_TIMEOUT")

# pq_search_sharded: (rows, opq iterations, k), tests/test_sharding.py:297-360
PQ_CASES = {"divisible": (64, 0, 7), "non_divisible": (61, 0, 7),
            "opq": (64, 3, 6), "k_exceeds_shard": (32, 0, 10)}
# the services' options, tests/test_serving.py:412-509
SERVICE_CASES = {"pq": {}, "exact": {}, "int8": {"quantize_int8": True},
                 "ivfadc": {"ivf_nprobe": 2}, "pq_rerank": {"pq_rerank": 8},
                 "ivf": {"ivf_nprobe": 2}}
FALLBACK_WARNINGS = {"ivfadc": "single-device", "pq_rerank": "single-device",
                     "ivf": "exact sharded search"}


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return env


def _pq_inputs():
    """The sharding tests' queries and JAX-built PQ indexes."""
    from openibl_tpu.ops.pq import build_pq

    out = {}
    for name, (n, opq, k) in PQ_CASES.items():
        rng = np.random.RandomState(0)
        g = rng.randn(n, 32).astype(np.float32)
        q = g[:5] + 0.01 * rng.randn(5, 32).astype(np.float32)
        p = build_pq(g, m=4, ksub=16, iters=6, opq_iters=opq)
        out.update({f"{name}:q": q, f"{name}:k": k,
                    f"{name}:codes": p["pq_codes"],
                    f"{name}:cb": p["pq_codebooks"]})
        if opq:
            out[f"{name}:rot"] = p["pq_rotation"]
    return out


def _service_indexes():
    """The JAX serving tests' indexes, built by the JAX package."""
    from openibl_tpu.ops.ivf import build_ivf
    from openibl_tpu.ops.pq import build_ivfpq, build_pq

    rng = np.random.RandomState(14)
    g29 = rng.randn(29, 4096).astype(np.float32)
    g29 /= np.linalg.norm(g29, axis=1, keepdims=True)
    g30 = np.random.RandomState(7).randn(30, 4096).astype(np.float32)
    g16 = np.random.RandomState(19).randn(16, 4096).astype(np.float32)
    ivf = build_ivf(g30, nlist=4)
    return {
        "pq": dict(build_pq(g29, m=8, ksub=8, iters=4)),
        "exact": {"descriptors": g30},
        "int8": {"descriptors": g30},
        "ivfadc": dict(build_ivfpq(g16, nlist=4, m=8, ksub=8, iters=2)),
        "pq_rerank": {"descriptors": g16,
                      **build_pq(g16, m=8, ksub=8, iters=2)},
        "ivf": {"descriptors": g30, "ivf_centroids": ivf["centroids"],
                "ivf_lists": ivf["lists"]},
    }


WORKER = textwrap.dedent("""
    import datetime, sys, time, warnings
    sys.modules["jax"] = None  # the ranks never import jax
    import numpy as np, torch, torch.distributed as dist
    from openibl_tpu_torch.ops.pq import pq_search_sharded
    from openibl_tpu_torch.parallel.mesh import Mesh, get_mesh
    from openibl_tpu_torch.serving import RetrievalService
    from tests.test_torch_mesh_serving import (
        GROUP_TIMEOUT_S, IDLE_S, KW, PQ_CASES, SERVICE_CASES)

    store, rank, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    mesh = get_mesh(2, device="cpu")
    data = np.load(f"{tmp}/inputs.npz")
    img = data["img"]
    out = {}

    # pq_search_sharded: the whole matrix on every rank, and each rank's
    # resident shard (zero-padded) with the total
    for name in PQ_CASES:
        q, codes, cb = (data[f"{name}:{k}"] for k in ("q", "codes", "cb"))
        rot = data[f"{name}:rot"] if f"{name}:rot" in data.files else None
        k = int(data[f"{name}:k"])
        d, i = pq_search_sharded(q, codes, cb, mesh, k=k, precise=True,
                                 rotation=rot)
        per = -(-len(codes) // 2)
        shard = np.zeros((per, codes.shape[1]), np.uint8)
        mine = codes[rank * per:(rank + 1) * per]
        shard[:len(mine)] = mine
        dr, ir = pq_search_sharded(q, torch.from_numpy(shard), cb, mesh, k=k,
                                   precise=True, rotation=rot,
                                   total=len(codes))
        out.update({f"pq:{name}:d": d.numpy(), f"pq:{name}:i": i.numpy(),
                    f"pq:{name}:d_res": dr.numpy(),
                    f"pq:{name}:i_res": ir.numpy()})

    def service(name, m, **kw):
        index = {k.split(":", 2)[2]: data[k] for k in data.files
                 if k.startswith(f"svc:{name}:")}
        return RetrievalService(index, weights=f"{tmp}/model.npz", mesh=m,
                                device="cpu", **KW, **kw)

    for name, kw in SERVICE_CASES.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            svc = service(name, mesh, **kw)
        out[f"{name}:warnings"] = np.asarray(
            [str(w.message) for w in caught] + [""])
        out[f"{name}:mesh_none"] = svc.mesh is None
        gal = getattr(svc, "_gallery", None)
        out[f"{name}:rows"] = -1 if gal is None else gal.shape[0]
        roles = []
        if rank == 0:
            res = svc.query([img], topk=5)[0]
            out[f"{name}:ids"] = np.asarray([m["index"] for m in res])
            out[f"{name}:d"] = np.asarray([m["sq_dist"] for m in res])
            try:
                svc.follow()
            except RuntimeError as e:
                roles.append(str(e))
            svc.close()
            svc.close()  # idempotent
        else:
            try:
                svc.query([img])
            except RuntimeError as e:
                roles.append(str(e))
            t0 = time.perf_counter()
            svc.follow()  # returns on rank 0's close()
            out[f"{name}:followed_s"] = time.perf_counter() - t0
        out[f"{name}:roles"] = np.asarray(roles + [""])
        del svc

    # a follower idle past its group's timeout still answers: the mesh's
    # group waits GROUP_TIMEOUT_S at most, the lockstep's header a year
    short = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=GROUP_TIMEOUT_S))
    svc = service("exact", Mesh(mesh.device, rank, 2, short))
    if rank == 0:
        svc.warmup(5)
        time.sleep(IDLE_S)
        res = svc.query([img], topk=5)[0]
        out["idle:ids"] = np.asarray([m["index"] for m in res])
        svc.close()
    else:
        t0 = time.perf_counter()
        svc.follow()
        out["idle:followed_s"] = time.perf_counter() - t0
    # ... where a plain wait on that group times out: rank 1 waits for a
    # broadcast rank 0 never sends
    probe = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=GROUP_TIMEOUT_S))
    if rank == 1:
        t0 = time.perf_counter()
        try:
            dist.broadcast(torch.zeros(1), src=0, group=probe)
            out["probe:raised"] = False
        except RuntimeError:
            out["probe:raised"] = True
        out["probe:s"] = time.perf_counter() - t0
    dist.barrier()
    np.savez(f"{tmp}/out{rank}.npz", **out)
""")


def _jax_service(index, jmesh, **kw):
    from openibl_tpu.serving import RetrievalService as JaxService

    return JaxService(index, **KW, mesh=jmesh, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' outputs, the JAX package's answers and the port's
    single-device answers, on the same inputs."""
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh as JMesh

    from openibl_tpu.hub import vgg16_netvlad as jax_hub
    from openibl_tpu.ops.pq import pq_search_sharded as jpq_sharded
    from openibl_tpu.utils.checkpoint import save_checkpoint

    tmp = tmp_path_factory.mktemp("mesh_serving")
    _, params = jax_hub(None)
    params["vlad"]["centroids"] = params["vlad"]["centroids"] * 0.01
    weights = str(tmp / "model.npz")
    save_checkpoint(weights, params)
    del params
    img = np.random.RandomState(3).randint(0, 256, (H, W, 3), np.uint8)
    pq_in = _pq_inputs()
    indexes = _service_indexes()
    np.savez(tmp / "inputs.npz", img=img, **pq_in,
             **{f"svc:{n}:{k}": v for n, idx in indexes.items()
                for k, v in idx.items()})
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tmp / "store"), str(rank),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_clean_env(), cwd=ROOT) for rank in range(2)]
    try:
        # the JAX side and the port's single device, while the ranks run
        jmesh = JMesh(np.asarray(jax.devices()[:2]), ("data",))
        jax_pq = {}
        for name in PQ_CASES:
            rot = pq_in.get(f"{name}:rot")
            d, i = jpq_sharded(pq_in[f"{name}:q"], pq_in[f"{name}:codes"],
                               pq_in[f"{name}:cb"], jmesh,
                               k=pq_in[f"{name}:k"], precise=True,
                               rotation=rot)
            jax_pq[name] = (np.asarray(d), np.asarray(i))
        jax_svc, single, jax_warnings = {}, {}, {}
        for name, kw in SERVICE_CASES.items():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                svc = _jax_service(dict(indexes[name]), jmesh, weights=weights,
                                   **kw)
            jax_warnings[name] = [str(w.message) for w in caught]
            jax_svc[name] = (svc.mesh is None, svc.query([img], topk=5)[0])
            del svc
            if name in ("pq", "exact", "int8"):
                single[name] = RetrievalService(
                    dict(indexes[name]), weights=weights, device="cpu", **KW,
                    **kw).query([img], topk=5)[0]
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-3000:]}"
    outs = [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]
    yield {"outs": outs, "pq_in": pq_in, "jax_pq": jax_pq,
           "jax_svc": jax_svc, "jax_warnings": jax_warnings,
           "single": single, "indexes": indexes}
    shutil.rmtree(tmp, ignore_errors=True)  # a full-width .npz


@pytest.mark.parametrize("name", list(PQ_CASES))
def test_pq_search_sharded_matches_jax_and_one_device(runs, name):
    """Both forms (the whole matrix; each rank's resident shard) on both
    ranks give the JAX mesh function's indices and the port's own
    single-device ``pq_search``'s, distances at rtol/atol 1e-5."""
    pq_in = runs["pq_in"]
    jd, ji = runs["jax_pq"][name]
    sd, si = pq_search(pq_in[f"{name}:q"], pq_in[f"{name}:codes"],
                       pq_in[f"{name}:cb"], k=pq_in[f"{name}:k"],
                       precise=True, rotation=pq_in.get(f"{name}:rot"))
    n = len(pq_in[f"{name}:codes"])
    for out in runs["outs"]:
        for form in ("", "_res"):
            d, i = out[f"pq:{name}:d{form}"], out[f"pq:{name}:i{form}"]
            assert np.all((i >= 0) & (i < n))
            np.testing.assert_array_equal(i, ji)
            np.testing.assert_array_equal(i, si.numpy())
            np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(d, sd.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["pq", "exact", "int8"])
def test_mesh_service_matches_jax_and_one_device(runs, name):
    """The two-rank service's top-5 has the JAX mesh service's ids and the
    port's single-device ids, distances at the JAX tests' tolerances; each
    rank holds ceil(N/2) rows of the index."""
    rank0 = runs["outs"][0]
    ids, d = rank0[f"{name}:ids"].tolist(), rank0[f"{name}:d"]
    tol = PQ_TOL if name == "pq" else EXACT_TOL
    for ref in (runs["jax_svc"][name][1], runs["single"][name]):
        assert ids == [m["index"] for m in ref]
        np.testing.assert_allclose(d, [m["sq_dist"] for m in ref], **tol)
    key = "pq_codes" if name == "pq" else "descriptors"
    per = -(-len(runs["indexes"][name][key]) // 2)
    assert [int(o[f"{name}:rows"]) for o in runs["outs"]] == [per, per]
    assert not any(bool(o[f"{name}:mesh_none"]) for o in runs["outs"])


@pytest.mark.parametrize("name", ["ivfadc", "pq_rerank", "ivf"])
def test_mesh_service_falls_back_like_jax(runs, name):
    """IVFADC and pq_rerank fall back to rank 0 alone (``svc.mesh is
    None``; the follower holds nothing and its follow() returns at once),
    IVF over exact rows serves the exact sharded search: each with the JAX
    service's warning, and the JAX service's answer."""
    outs = runs["outs"]
    want = FALLBACK_WARNINGS[name]
    assert any(want in w for w in runs["jax_warnings"][name])
    for o in outs:
        assert any(want in str(w) for w in o[f"{name}:warnings"])
    none, ref = runs["jax_svc"][name]
    assert [bool(o[f"{name}:mesh_none"]) for o in outs] == [none, none]
    assert none == (name != "ivf")
    if none:
        assert int(outs[1][f"{name}:rows"]) == -1
    else:
        assert [int(o[f"{name}:rows"]) for o in outs] == [15, 15]
    assert outs[0][f"{name}:ids"].tolist() == [m["index"] for m in ref]
    np.testing.assert_allclose(outs[0][f"{name}:d"],
                               [m["sq_dist"] for m in ref],
                               **(PQ_TOL if name == "ivfadc" else EXACT_TOL))


def test_roles_close_and_follow(runs):
    """Rank 0 may not follow and rank 1 may not answer queries (each a
    RuntimeError); close() twice on rank 0 ended rank 1's follow() in every
    case."""
    rank0, rank1 = runs["outs"]
    for name in SERVICE_CASES:
        assert "follow()" in rank0[f"{name}:roles"][0]
        if not bool(rank1[f"{name}:mesh_none"]):
            assert "rank 1 does not answer queries" in \
                rank1[f"{name}:roles"][0]
        assert f"{name}:followed_s" in rank1


def test_idle_follower_outlives_its_group_timeout(runs):
    """A follower idle for IDLE_S (> the mesh group's GROUP_TIMEOUT_S)
    answers the next query, where a plain wait on such a group raises."""
    rank0, rank1 = runs["outs"]
    assert rank0["idle:ids"].tolist() == rank0["exact:ids"].tolist()
    assert float(rank1["idle:followed_s"]) > IDLE_S
    assert bool(rank1["probe:raised"])
    assert float(rank1["probe:s"]) < IDLE_S


def test_world_size_one_without_a_group_is_one_device():
    """A Mesh without a group (rank 0 of 1) goes through the sharded code
    and gives the single-device answer: merge_across_ranks,
    topk_nearest_sharded's resident form and pq_search_sharded."""
    rng = np.random.RandomState(2)
    mesh = Mesh(torch.device("cpu"))
    q = rng.randn(3, 16).astype(np.float32)
    g = rng.randn(21, 16).astype(np.float32)
    want = distance.topk_nearest(q, g, k=4)
    for got in (distance.topk_nearest_sharded(q, g, mesh, k=4),
                distance.topk_nearest_sharded(q, torch.from_numpy(g), mesh,
                                              k=4, resident=True)):
        torch.testing.assert_close(got[0], want[0])
        assert torch.equal(got[1], want[1])
    from openibl_tpu_torch.ops.pq import build_pq

    p = build_pq(g, m=4, ksub=8, iters=3)
    want = pq_search(q, p["pq_codes"], p["pq_codebooks"], k=5)
    for kw in ({}, {"total": 21}):
        got = pq_search_sharded(q, torch.from_numpy(p["pq_codes"]),
                                p["pq_codebooks"], mesh, k=5, **kw)
        torch.testing.assert_close(got[0], want[0])
        assert torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="cannot hold"):
        pq_search_sharded(q, torch.from_numpy(p["pq_codes"][:10]),
                          p["pq_codebooks"], Mesh(torch.device("cpu"), 0, 2),
                          k=5, total=21)


# --------------------------------------------------------------------------
# slow: the HTTP example on two ranks under torchrun
# --------------------------------------------------------------------------

@pytest.mark.slow
def test_serve_example_on_two_ranks_under_torchrun(runs, tmp_path):
    """examples/serve_torch.py --n-devices 2 --pq under torchrun on the CPU
    (gloo): /healthz, a POST /query with the one-device service's matches,
    then SIGTERM to rank 0 and every rank exits 0."""
    import io
    import re
    import socket

    from PIL import Image

    from openibl_tpu.hub import vgg16_netvlad as jax_hub
    from openibl_tpu.utils.checkpoint import save_checkpoint

    _, params = jax_hub(None)
    params["vlad"]["centroids"] = params["vlad"]["centroids"] * 0.01
    weights = str(tmp_path / "model.npz")
    save_checkpoint(weights, params)
    del params
    index = str(tmp_path / "pq.npz")
    np.savez(index, **runs["indexes"]["pq"])
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            ports.append(s.getsockname()[1])
    log = tmp_path / "serve.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node=2", f"--master-port={ports[0]}",
             osp.join(ROOT, "examples", "serve_torch.py"), index,
             "--weights", weights, "--pq", "--n-devices", "2",
             "--height", str(H), "--width", str(W), "--device", "cpu",
             "--port", str(ports[1])],
            stdout=f, stderr=subprocess.STDOUT, env=_clean_env(), cwd=ROOT)
    try:
        base = f"http://127.0.0.1:{ports[1]}"
        health, deadline = None, time.time() + 300
        while health is None and time.time() < deadline \
                and proc.poll() is None:
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    health = json.loads(r.read())
            except OSError:
                time.sleep(0.5)
        assert health == {"ok": True, "index_size": 29}, log.read_text()
        img = np.random.RandomState(3).randint(0, 256, (H, W, 3), np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        req = urllib.request.Request(base + "/query?topk=5",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            matches = json.loads(r.read())["matches"]
        single = RetrievalService(index, weights=weights, device="cpu",
                                  **KW).query([img], topk=5)[0]
        assert [m["index"] for m in matches] == \
            [m["index"] for m in single]
        pid = int(re.search(r"pid (\d+)", log.read_text()).group(1))
        os.kill(pid, signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "stopping" in log.read_text()
