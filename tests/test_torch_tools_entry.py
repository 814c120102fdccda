"""The port's measurement tools as entry points: each runs on the card
unless asked for the CPU (``--device cpu``), and raises without one, before
it does any work; none imports jax or the JAX package. The ``cuda`` tests
run two tools on the card (`python -m pytest --noconftest -m cuda
tests/test_torch_tools_entry.py`): K1 in profile_head against the plain
head at batch 16, and bench_serving's device pass over a 4,096-row
gallery.
"""

import importlib
import json
import math
import shutil
import os.path as osp
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOOLS = ("bench_serving", "ivf_recall", "pq_recall", "profile_backbone",
         "profile_head", "profile_phases", "time_sfrs_rerank")
WRITERS = ("bench_serving", "ivf_recall", "pq_recall", "time_sfrs_rerank")


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_tools_entry.py`")
    return torch.device("cuda")


@pytest.mark.parametrize("name", TOOLS)
def test_defaults_to_the_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    tool = importlib.import_module(f"openibl_tpu_torch.tools.{name}")
    argv = ["--out", str(tmp_path / "x.json")] if name in WRITERS else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(argv)
    assert not (tmp_path / "x.json").exists()


def test_tools_import_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        + "".join(f"import openibl_tpu_torch.tools.{n}\n" for n in TOOLS)
        + "assert not any(m == 'openibl_tpu' or m.startswith('openibl_tpu.')"
          " for m in sys.modules), 'JAX package imported'\n"
          "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.cuda
def test_cuda_profile_head_k1_matches_plain(cuda_device):
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.tools import profile_head

    vp, pp, fmap, _ = profile_head.inputs(16, cuda_device)
    pieces = profile_head.head_pieces(vp, pp)
    nk.netvlad_fused.launches = 0
    with torch.inference_mode():
        got = pieces["netvlad_fused"](fmap)
        want = pieces["netvlad_xla"](fmap)
    assert nk.netvlad_fused.launches == 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_bench_serving_device_pass(cuda_device, tmp_path):
    from openibl_tpu_torch.tools import bench_serving

    out = tmp_path / "serving.json"
    argv = ["--gallery-size", "4096", "--ivf-nlist", "16", "--scan-n", "4",
            "--device-time", "--out", str(out)]
    assert bench_serving.main(argv)["measured"] == list(
        bench_serving.VARIANTS)
    rows = json.loads(out.read_text())["variants"]
    for name in bench_serving.VARIANTS:
        assert math.isfinite(rows[name]["device_ms_per_query"]), name
        assert rows[name]["device_scan_n"] == 4
        assert isinstance(rows[name]["host_syncs"], list)
    assert bench_serving.main(argv)["measured"] == []
