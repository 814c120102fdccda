"""The index family's serving paths on the PyTorch port against the JAX
package: PQ, IVFADC, the PQ re-rank and IVF through both RetrievalServices,
index files carried across both ways, the constructor's errors, the batch
extraction, and examples/index_and_query_torch.py end to end.

Both services load one .npz of the JAX model (full width: VGG16, K=64, PCA
4096) at 32x48, its NetVLAD centroids shrunk so that images get distinct
descriptors (as tests/test_torch_serving.py does). The gallery holds 32
rows: 4 planted image descriptors and 28 random unit rows. With N <= ksub
every row becomes its own codeword, so PQ and IVFADC codes are lossless and
an index built by either package ranks like the other's; distances still
differ by the bf16 rounding of the LUT (precise=False, the serving
default) and by f32 order, so they are compared at atol 1e-4 and ids up to
near-ties within it (``_assert_same_matches``).
"""

import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openibl_tpu.ops import ivf as jivf  # noqa: E402
from openibl_tpu.ops import pq as jpq  # noqa: E402
from openibl_tpu.serving import RetrievalService as JaxService  # noqa: E402
from openibl_tpu.utils.checkpoint import save_checkpoint  # noqa: E402
from openibl_tpu_torch.ops import ivf as tivf  # noqa: E402
from openibl_tpu_torch.ops import pq as tpq  # noqa: E402
from openibl_tpu_torch.serving import RetrievalService  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
H, W = 32, 48
N, PLANTED = 32, (3, 10, 17, 29)
KW = dict(height=H, width=W, batch_buckets=(1,))
MODES = {
    "pq": dict(use_pq=True),
    "ivfadc": dict(use_pq=True, ivf_nprobe=2),
    "pq_rerank": dict(pq_rerank=8),
    "ivf": dict(ivf_nprobe=2),
}


def _index(pkg, gallery):
    """descriptors + PQ + IVFADC (whose IVF tables serve IVF mode too)."""
    pq, _ = pkg
    return {"descriptors": gallery,
            "paths": np.array([f"img_{i}.jpg" for i in range(N)]),
            **pq.build_pq(gallery, m=64, ksub=32, iters=5),
            **pq.build_ivfpq(gallery, nlist=8, m=64, ksub=32, iters=5)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from openibl_tpu.hub import vgg16_netvlad as jax_hub

    tmp = tmp_path_factory.mktemp("index")
    rng = np.random.RandomState(0)
    model, params = jax_hub(None)
    params["vlad"]["centroids"] = params["vlad"]["centroids"] * 0.01
    weights = str(tmp / "model.npz")
    save_checkpoint(weights, params)
    images = rng.randint(0, 256, (len(PLANTED) + 1, H, W, 3)).astype(
        np.uint8)  # the last one is not in the gallery
    gallery = rng.randn(N, 4096).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    desc = np.asarray(jax.jit(model.apply)(params, jnp.asarray(images)))
    gallery[list(PLANTED)] = desc[:len(PLANTED)]
    del params
    files = {}
    for name, pkg in (("jax", (jpq, jivf)), ("port", (tpq, tivf))):
        files[name] = str(tmp / f"{name}_index.npz")
        np.savez(files[name], **_index(pkg, gallery))
    yield {"weights": weights, "images": images, "gallery": gallery,
           "desc": desc, "files": files, "tmp": tmp}
    shutil.rmtree(tmp, ignore_errors=True)  # a full-width .npz each


def _service(world, cls, builder, mode):
    """A service per call: each holds a full-width model (~0.6 GB), so a
    test keeps only the ones it queries."""
    on_cpu = {"device": "cpu"} if cls is RetrievalService else {}
    return cls(world["files"][builder], weights=world["weights"],
               **MODES[mode], **KW, **on_cpu)


def _assert_same_matches(a, b, tol=1e-4):
    """Per image: same ranks and distances within tol; an id may differ
    only among near-ties (another rank within tol, or the last rank)."""
    for ra, rb in zip(a, b):
        assert [m["rank"] for m in ra] == [m["rank"] for m in rb]
        da = np.array([m["sq_dist"] for m in ra])
        db = np.array([m["sq_dist"] for m in rb])
        np.testing.assert_allclose(da, db, atol=tol)
        ib = [m["index"] for m in rb]
        for p, m in enumerate(ra):
            if m["index"] != ib[p]:
                tied = [i for i, d in zip(ib, db) if abs(d - da[p]) <= tol]
                assert m["index"] in tied or abs(da[p] - db[-1]) <= tol


@pytest.mark.parametrize("mode", list(MODES))
def test_indexes_cross_load_and_rank_alike(world, mode):
    """The JAX service serves the port-built .npz and the port's service the
    JAX-built one; for the same images both give the same top-5, and each
    planted image finds its own row first."""
    theirs = _service(world, JaxService, "port", mode)
    ours = _service(world, RetrievalService, "jax", mode)
    assert ours.use_pq == theirs.use_pq and ours.index_size == N
    if mode in ("pq", "ivfadc"):
        assert ours._gallery.dtype == torch.uint8
    imgs = list(world["images"])
    a = ours.query(imgs, topk=5)
    b = theirs.query(imgs, topk=5)
    _assert_same_matches(a, b)
    assert [r[0]["index"] for r in a[:len(PLANTED)]] == list(PLANTED)
    assert [r[0]["path"] for r in a[:len(PLANTED)]] == \
        [f"img_{i}.jpg" for i in PLANTED]
    assert a[0][0]["sq_dist"] < 1e-3


def test_port_builders_load_into_the_jax_service_like_their_own(world):
    """The same mode on the port-built and the JAX-built index, both in the
    JAX service: lossless codes, so the same top-5."""
    imgs = list(world["images"])
    for mode in ("pq", "ivfadc"):
        a = _service(world, JaxService, "port", mode).query(imgs, topk=5)
        b = _service(world, JaxService, "jax", mode).query(imgs, topk=5)
        _assert_same_matches(a, b)


def test_unfilled_ivf_slots_give_no_phantom_match(world):
    """nprobe=2 of 8 cells holds fewer than 20 rows: the service returns
    only real rows, ranked 1..n, and the JAX service's list."""
    ours = _service(world, RetrievalService, "jax", "ivf")
    theirs = _service(world, JaxService, "port", "ivf")
    lists = np.load(world["files"]["jax"])["ivf_lists"]
    assert 2 * lists.shape[1] < 20
    img = [world["images"][1]]
    out = ours.query(img, topk=20)[0]
    assert 0 < len(out) < 20
    assert [m["rank"] for m in out] == list(range(1, len(out) + 1))
    assert all(0 <= m["index"] < N for m in out)
    assert all(m["path"] == f"img_{m['index']}.jpg" for m in out)
    assert np.isfinite([m["sq_dist"] for m in out]).all()
    _assert_same_matches([out], theirs.query(img, topk=20))


def _misuse(world):
    g = world["gallery"][:8]
    pq = {k: v for k, v in np.load(world["files"]["jax"]).items()
          if k.startswith("pq_")}
    ivfpq = {k: v for k, v in np.load(world["files"]["jax"]).items()
             if k.startswith("ivf")}
    pq8 = {"pq_codes": pq["pq_codes"][:8], "pq_codebooks": pq["pq_codebooks"]}
    return {
        "rerank_codes_only": (dict(pq8), dict(pq_rerank=4)),
        "rerank_without_codes": ({"descriptors": g}, dict(pq_rerank=4)),
        "rerank_with_nprobe": ({"descriptors": g, **pq8},
                               dict(pq_rerank=4, ivf_nprobe=2)),
        "pq_without_codes": ({"descriptors": g}, dict(use_pq=True)),
        "pq_with_int8": (dict(pq8), dict(quantize_int8=True)),
        "ivfadc_without_residuals": (dict(pq8), dict(ivf_nprobe=2)),
        "residuals_without_nprobe": (dict(ivfpq), {}),
        "paths_mismatch": ({"descriptors": g, "paths": np.array(["a"])}, {}),
        "int8_without_scales": ({"descriptors": g.astype(np.int8)}, {}),
        "nprobe_without_tables": ({"descriptors": g}, dict(ivf_nprobe=2)),
        "codebooks_mismatch": ({"pq_codes": pq8["pq_codes"],
                                "pq_codebooks": pq["pq_codebooks"][:4]}, {}),
    }


@pytest.mark.parametrize("case", [
    "rerank_codes_only", "rerank_without_codes", "rerank_with_nprobe",
    "pq_without_codes", "pq_with_int8", "ivfadc_without_residuals",
    "residuals_without_nprobe", "paths_mismatch", "int8_without_scales",
    "nprobe_without_tables", "codebooks_mismatch",
])
def test_misuse_raises_the_jax_error(world, case):
    index, kw = _misuse(world)[case]
    with pytest.raises(ValueError) as theirs:
        JaxService(dict(index), **kw, **KW)
    with pytest.raises(ValueError) as ours:
        RetrievalService(dict(index), **kw, **KW, device="cpu")
    assert str(ours.value) == str(theirs.value)


def _write_pngs(folder, images):
    folder.mkdir()
    for i, img in enumerate(images):
        Image.fromarray(img).save(folder / f"im_{i}.png")


def test_extract_features_matches_the_jax_model(world):
    from openibl_tpu_torch.data.loader import BatchLoader, ImageSource
    from openibl_tpu_torch.data.transforms import TestTransform
    from openibl_tpu_torch.hub import vgg16_netvlad
    from openibl_tpu_torch.parallel.extract import extract_features
    from openibl_tpu_torch.parallel.mesh import Mesh, get_mesh

    folder = world["tmp"] / "extract"
    _write_pngs(folder, world["images"])
    src = ImageSource([(str(folder / f"im_{i}.png"), i, 0.0, 0.0)
                       for i in range(len(world["images"]))],
                      transform=TestTransform(H, W, device_normalize=True))
    model = vgg16_netvlad(world["weights"], device="cpu")
    loader = BatchLoader(src, indices=[4, 0, 3, 1, 2], batch_size=2)
    feats = extract_features(model, loader)
    on_dev = extract_features(model, loader, device_output=True)
    assert isinstance(on_dev, torch.Tensor) and on_dev.shape == (5, 4096)
    np.testing.assert_array_equal(on_dev.numpy(), feats)
    np.testing.assert_allclose(feats, world["desc"], atol=1e-5)
    mesh = get_mesh(device="cpu")  # one rank: the model's own device
    np.testing.assert_array_equal(extract_features(model, loader, mesh=mesh),
                                  feats)
    with pytest.raises(ValueError, match="the mesh's rank"):
        extract_features(model, loader, mesh=Mesh(torch.device("meta")))


def test_index_and_query_torch_cli_builds_an_index_jax_serves(world):
    folder = world["tmp"] / "gallery"
    _write_pngs(folder, world["images"])
    index = str(world["tmp"] / "cli_index.npz")
    script = osp.join(ROOT, "examples", "index_and_query_torch.py")
    common = ["--weights", world["weights"], "--height", str(H),
              "--width", str(W), "--device", "cpu"]
    res = subprocess.run(
        [sys.executable, script, "build", str(folder), index, "--pq-m", "64",
         "--ivf-nlist", "2", "--batch-size", "2", *common],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "IVFADC: 2 cells" in res.stdout
    data = np.load(index)
    assert sorted(data.files) == sorted(
        ["paths", "descriptors", "ivf_centroids", "ivf_lists",
         "ivfpq_codebooks", "ivfpq_codes"])
    np.testing.assert_allclose(data["descriptors"], world["desc"], atol=1e-5)
    svc = JaxService(index, weights=world["weights"], ivf_nprobe=2,
                     use_pq=True, **KW)
    hit = svc.query([world["images"][2]], topk=2)[0][0]
    assert hit["path"].endswith("im_2.png")
    res = subprocess.run(
        [sys.executable, script, "query", index,
         str(folder / "im_3.png"), "--topk", "2", *common],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "1. " + str(folder / "im_3.png") in res.stdout
