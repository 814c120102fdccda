"""The PyTorch port's RetrievalService and HTTP example against the JAX
service, both full width (VGG16, K=64, PCA 32768→4096: the JAX service takes
no width arguments) at 32x48, built from the same .npz weights and index."""

import importlib.util
import io
import json
import os.path as osp
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openibl_tpu.ops.distance import quantize_index_int8  # noqa: E402
from openibl_tpu.serving import RetrievalService as JaxService  # noqa: E402
from openibl_tpu.utils.checkpoint import save_checkpoint  # noqa: E402
from openibl_tpu_torch.serving import RetrievalService  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
H, W = 32, 48
PLANTED = (3, 7, 11, 14)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Shared .npz weights, an index with planted descriptors, both services."""
    from openibl_tpu.hub import vgg16_netvlad as jax_hub

    rng = np.random.RandomState(0)
    model, params = jax_hub(None)
    # random uniform centroids of norm ~13 outweigh the unit-norm conv5
    # rows, so every image would get nearly the same descriptor (planted
    # rows ~1e-5 apart, a near-tie). Shrunk, the planted rows sit ~6e-3
    # apart with gaps of >= 8e-5, far above the two stacks' ~1e-6 drift.
    params["vlad"]["centroids"] = params["vlad"]["centroids"] * 0.01
    weights = str(tmp_path_factory.mktemp("w") / "model.npz")
    save_checkpoint(weights, params)
    images = rng.randint(0, 256, (len(PLANTED), H, W, 3)).astype(np.uint8)
    gallery = rng.randn(16, 4096).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    gallery[list(PLANTED)] = np.asarray(
        jax.jit(model.apply)(params, jnp.asarray(images)))
    del params
    index = {"descriptors": gallery,
             "paths": np.array([f"img_{i}.jpg" for i in range(16)])}
    kw = dict(weights=weights, height=H, width=W, batch_buckets=(1, 2))
    ours = RetrievalService(index, device="cpu", **kw)
    theirs = JaxService(index, **kw)
    ours.warmup(topk=5)
    return {"ours": ours, "theirs": theirs, "images": images,
            "index": index}


def _ids(matches):
    return [[m["index"] for m in row] for row in matches]


def test_planted_queries_hit_their_rows_in_both(world):
    imgs = list(world["images"])  # 4 images > largest bucket: chunked
    ours = world["ours"].query(imgs, topk=5)
    theirs = world["theirs"].query(imgs, topk=5)
    assert _ids(ours) == _ids(theirs)
    assert [row[0]["index"] for row in ours] == list(PLANTED)
    for a, b in zip(ours, theirs):
        assert [m["rank"] for m in a] == [1, 2, 3, 4, 5]
        assert [m["path"] for m in a] == [m["path"] for m in b]
        np.testing.assert_allclose([m["sq_dist"] for m in a],
                                   [m["sq_dist"] for m in b], atol=1e-4)
    assert ours[0][0]["sq_dist"] < 1e-4


def test_pil_input_is_resized_like_jax(world):
    img = Image.fromarray(np.random.RandomState(1).randint(
        0, 256, (100, 80, 3)).astype(np.uint8))
    ours, theirs = world["ours"], world["theirs"]
    arr = ours._preprocess([img])
    assert arr.shape == (1, H, W, 3) and arr.dtype == np.uint8
    np.testing.assert_array_equal(arr, theirs._preprocess([img]))
    assert _ids(ours.query([img], topk=5)) == \
        _ids(theirs.query([img], topk=5)) == _ids(ours.query(list(arr), topk=5))


@pytest.mark.parametrize("bad, match", [
    (np.zeros((8, 8, 3), np.uint8), "shape"),
    (np.zeros((H, W, 3), np.float32), "uint8"),
])
def test_bad_inputs_fail_the_same_way(world, bad, match):
    for svc in (world["ours"], world["theirs"]):
        with pytest.raises(ValueError, match=match):
            svc.query([bad])
    with pytest.raises(ValueError, match="topk"):
        world["ours"].query([world["images"][0]], topk=0)
    assert world["ours"].query([]) == []


def test_reduced_precision_indexes_rank_like_f32():
    """f16, pre-quantized int8 and quantize-at-load int8 indexes return the
    f32 index's top-3 on a random gallery (seeded random model): its top-3
    distances are >= 1.7e-3 apart, above the int8 rounding (~2e-4)."""
    rng = np.random.RandomState(9)
    g = rng.randn(24, 4096).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    codes, scales = quantize_index_int8(g)
    kw = dict(height=H, width=W, batch_buckets=(1,), device="cpu")
    svcs = [RetrievalService({"descriptors": g}, **kw),
            RetrievalService({"descriptors": g.astype(np.float16)}, **kw),
            RetrievalService({"descriptors": codes, "scales": scales}, **kw),
            RetrievalService({"descriptors": g}, quantize_int8=True, **kw)]
    assert svcs[1]._gallery.dtype == torch.float16
    assert svcs[2]._gallery.dtype == svcs[3]._gallery.dtype == torch.int8
    ids = [_ids(s.query([img], topk=3)) for s in svcs]
    assert ids[1] == ids[2] == ids[3] == ids[0]


@pytest.mark.parametrize("kwargs, item", [
    ({"mesh": object()}, "item 12"),
])
def test_unported_options_raise(kwargs, item):
    index = {"descriptors": np.zeros((2, 4096), np.float32)}
    with pytest.raises(NotImplementedError, match=item):
        RetrievalService(index, height=H, width=W, device="cpu", **kwargs)


def test_quant_backbone_service():
    """quant_backbone=True serves end to end (the counterpart of
    tests/test_serving.py's test_quant_backbone_service): full result rows,
    the same answer twice, and the backbone's weights really int8. Fidelity
    against f32 and the JAX service is held in tests/test_torch_quant.py."""
    rng = np.random.RandomState(21)
    gallery = rng.randn(16, 4096).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    svc = RetrievalService({"descriptors": gallery}, height=H, width=W,
                           batch_buckets=(1,), quant_backbone=True,
                           calib_images=rng.randint(0, 256, (2, H, W, 3),
                                                    np.uint8),
                           device="cpu")
    img = rng.randint(0, 256, (H, W, 3), np.uint8)
    res = svc.query([img], topk=5)
    assert len(res[0]) == 5
    assert all(0 <= m["index"] < 16 for m in res[0])
    again = svc.query([img], topk=5)
    assert [m["index"] for m in res[0]] == [m["index"] for m in again[0]]
    assert svc._model.base.conv4_2.wq.dtype == torch.int8


def test_index_validation():
    with pytest.raises(ValueError, match="paths"):
        RetrievalService({"descriptors": np.zeros((2, 4096), np.float32),
                          "paths": np.array(["a"])}, height=H, width=W,
                         device="cpu")
    with pytest.raises(ValueError, match="scales"):
        RetrievalService({"descriptors": np.zeros((2, 4096), np.int8)},
                         height=H, width=W, device="cpu")


def test_http_handler_answers_healthz_and_query(world):
    spec = importlib.util.spec_from_file_location(
        "serve_torch", osp.join(ROOT, "examples", "serve_torch.py"))
    serve_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_torch)
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 serve_torch.make_handler(world["ours"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"ok": True, "index_size": 16}
        buf = io.BytesIO()
        Image.fromarray(world["images"][1]).save(buf, format="PNG")
        req = urllib.request.Request(base + "/query?topk=3",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            matches = json.loads(r.read())["matches"]
        assert [m["rank"] for m in matches] == [1, 2, 3]
        assert matches[0]["index"] == PLANTED[1]
        assert matches[0]["path"] == f"img_{PLANTED[1]}.jpg"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_slice_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import openibl_tpu_torch.serving, openibl_tpu_torch.hub\n"
        "import openibl_tpu_torch.ops.netvlad_kernel\n"
        "import openibl_tpu_torch.engine.evaluator\n"
        "import openibl_tpu_torch.utils.checkpoint\n"
        "import openibl_tpu_torch.ops.ivf, openibl_tpu_torch.ops.kmeans\n"
        "import openibl_tpu_torch.ops.pq, openibl_tpu_torch.ops.pq_kernel\n"
        "import openibl_tpu_torch.data.loader\n"
        "import openibl_tpu_torch.parallel.extract\n"
        "import openibl_tpu_torch.tools.mosaic_probe\n"
        "assert not any(m == 'openibl_tpu' or m.startswith('openibl_tpu.')\n"
        "               for m in sys.modules), 'JAX package imported'\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
