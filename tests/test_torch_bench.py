"""The port's bench lane (openibl_tpu_torch/tools/bench.py behind
bench_torch.py, and tools/bench_all.py) against bench.py and
scripts/bench_all.py, on the CPU.

bench.py's seven smoke argv sets (tests/test_bench_smoke.py) run through
both: the port prints one line with bench.py's keys (and ``device``) under
the metric name bench.py prints. ``vgg16_netvlad_flops`` and the reference
rates are bench.py's. The train and SFRS step FLOPs, counted by
``FlopCounterMode`` over one port step at 64x96, are held to XLA's
``cost_analysis()`` of the JAX step. The two count the same convolutions
(the forward of every image, the backward of conv5 alone) but not the same
taps: cuDNN computes every tap of a SAME-padded 3x3 convolution, and
FlopCounterMode counts them all, while XLA's count leaves out the taps that
fall on the padding. At 64x96 that is 12.6% (train) and 11.5% (SFRS) of
XLA's count (measured); less the padding taps, computed from the layer
shapes, the port's count is within 0.2% and 0.5% of XLA's (the rest is
elementwise work XLA counts and FlopCounterMode does not). At 480x640 the
padding taps are 1.7% of a train step's count.

bench_all runs against a stub bench command. The ``cuda`` tests run on a
card (`python -m pytest --noconftest -m cuda tests/test_torch_bench.py`).
"""

import importlib.util
import json
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch.models.vgg import VGG16_LAYERS  # noqa: E402
from openibl_tpu_torch.tools import bench, bench_all  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline"}
# tests/test_bench_smoke.py:57-75
SMOKE_ARGV = [
    ["--batch-size", "2", "--iters", "2", "--height", "64", "--width", "64",
     "--dtype", "float32"],
    ["--metric", "train", "--batch-size", "1", "--iters", "3",
     "--height", "64", "--width", "64", "--dtype", "float32"],
    ["--metric", "query", "--gallery-size", "256", "--iters", "2",
     "--height", "64", "--width", "64", "--dtype", "float32"],
    ["--metric", "query", "--gallery-size", "512", "--iters", "2",
     "--height", "64", "--width", "64", "--dtype", "float32",
     "--ivf-nprobe", "8"],
    ["--metric", "query", "--gallery-size", "256", "--iters", "2",
     "--height", "64", "--width", "64", "--dtype", "float32",
     "--device-time"],
    ["--metric", "sfrs", "--batch-size", "1", "--iters", "3",
     "--height", "64", "--width", "64", "--dtype", "float32"],
    ["--batch-size", "2", "--iters", "2", "--height", "64", "--width", "64",
     "--dtype", "float32", "--int8"],
]
SMOKE_IDS = ["extract", "train", "query", "query_ivf", "query_device",
             "sfrs", "extract_int8"]
CPU = ["--device", "cpu", "--max-seconds", "0"]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bench_py():
    """bench.py as a module (it imports jax inside its run)."""
    pytest.importorskip("jax")
    return _load("bench_jax", osp.join(ROOT, "bench.py"))


def _jax_line(bench_py, argv, capsys, monkeypatch):
    """The last line bench.py prints for ``argv`` (in process, on the CPU;
    --max-seconds 0: no os._exit timer inside pytest)."""
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv, "--max-seconds",
                                      "0"])
    bench_py.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("hw", [(480, 640), (64, 96)])
def test_vgg16_netvlad_flops_is_bench_pys(bench_py, hw):
    assert bench.vgg16_netvlad_flops(*hw) == bench_py.vgg16_netvlad_flops(
        *hw)


def test_reference_rates_are_bench_pys(bench_py):
    for name in ("REFERENCE_GPU_IMG_PER_SEC",
                 "REFERENCE_GPU_TRAIN_TUPLES_PER_SEC",
                 "REFERENCE_GPU_QUERY_MS",
                 "REFERENCE_GPU_SFRS_TUPLES_PER_SEC"):
        assert getattr(bench, name) == getattr(bench_py, name), name


@pytest.mark.parametrize("argv", SMOKE_ARGV, ids=SMOKE_IDS)
def test_metric_name_is_bench_pys(bench_py, argv, capsys, monkeypatch):
    theirs = _jax_line(bench_py, argv, capsys, monkeypatch)
    lines = bench.main(argv + CPU)
    printed = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in printed] == lines and len(lines) == 1
    ours = lines[0]
    assert KEYS <= set(ours) and set(ours) - KEYS <= {"tflops", "mfu",
                                                      "device"}
    assert ours["metric"] == theirs["metric"]
    assert ours["unit"] == theirs["unit"]
    assert ours["value"] > 0 and ours["device"] == "cpu"


def padding_tap_flops(height, width, images_fwd, images_bwd):
    """2 x MACs of the taps of VGG16's 3x3 SAME convolutions that land on
    the zero padding, for ``images_fwd`` forwards and ``images_bwd``
    backwards through conv5 (conv5_3 and conv5_2: input and weight
    gradients; conv5_1: the weight gradient; each a convolution of the
    layer's size with the same share of padding taps). Of an h x w map's
    9hw taps an output row or column at the border loses 3: (3h-2)(3w-2)
    fall inside."""
    h, w, fwd, pad5 = height, width, 0, {}
    for name, cin, cout, _, pool in VGG16_LAYERS:
        pad = 2 * cin * cout * (9 * h * w - (3 * h - 2) * (3 * w - 2))
        fwd += pad
        pad5[name] = pad
        if pool:
            h, w = h // 2, w // 2
    bwd = 2 * pad5["conv5_3"] + 2 * pad5["conv5_2"] + pad5["conv5_1"]
    return images_fwd * fwd + images_bwd * bwd


def _jax_step_flops(bench_py, metric, h, w):
    """XLA's cost_analysis() FLOPs of bench.py's train / SFRS step (ts 1)
    at h x w, f32, through bench.py's own _aot_step."""
    import jax
    import jax.numpy as jnp
    from openibl_tpu import models as jm
    from openibl_tpu.engine.sfrs import SFRSTrainer
    from openibl_tpu.engine.trainer import Trainer

    def normal(key, n):
        return jax.random.normal(jax.random.PRNGKey(key), (1, n, h, w, 3)) * 40

    if metric == "train":
        model = jm.create("embednet",
                          base=jm.VGG16(compute_dtype=jnp.float32),
                          net_vlad=jm.NetVLAD(num_clusters=64))
        params = model.init(jax.random.PRNGKey(0))
        trainer = Trainer(model, loss_type="sare_ind", lr=1e-3, remat=False)
        opt = trainer.init(params)
        _, flops = bench_py._aot_step(trainer._step, params, opt,
                                      normal(1, 12))
        return flops
    model = jm.create("embedregionnet",
                      base=jm.VGG16(compute_dtype=jnp.float32),
                      net_vlad=jm.NetVLAD(num_clusters=64), tuple_size=1)
    params = model.init(jax.random.PRNGKey(0))
    teacher = model.init(jax.random.PRNGKey(1))
    trainer = SFRSTrainer(model, loss_type="sare_ind", neg_num=10, lr=1e-3)
    opt = trainer.init_generation(params)
    _, flops = bench_py._aot_step(trainer.step_fn(1), params, teacher, opt,
                                  normal(2, 12), normal(3, 11))
    return flops


@pytest.mark.parametrize("metric,images,raw_gap", [
    ("train", (12, 12), 0.1265), ("sfrs", (33, 22), 0.1149)])
def test_step_flops_match_xla_cost_analysis(bench_py, metric, images,
                                            raw_gap):
    """One port step's FlopCounterMode count against XLA's count of the JAX
    step at 64x96: the raw gap is the padding taps (12.65% / 11.49% of
    XLA's count, measured); without them the counts are within 3%. SFRS:
    33 image forwards (the 22-image union and the teacher's 11) and 22
    backwards, in both packages."""
    h, w = 64, 96
    args = bench.parse(["--metric", metric, "--height", str(h), "--width",
                        str(w), "--batch-size", "1", "--dtype", "float32",
                        "--device", "cpu"])
    make = bench.sfrs_step if metric == "sfrs" else bench.train_step
    step, t_size = make(args, torch.device("cpu"))
    assert t_size == 1
    _, ours = bench.counted_flops(step)
    theirs = _jax_step_flops(bench_py, metric, h, w)
    assert ours / theirs - 1 == pytest.approx(raw_gap, abs=2e-3)
    assert abs((ours - padding_tap_flops(h, w, *images)) / theirs - 1) < 0.03


def test_mfu_fields_use_the_h100_peaks():
    assert bench.H100_PEAK_BF16_FLOPS == 989e12
    assert bench.H100_PEAK_INT8_OPS == 1979e12
    # 100 tuples/s at 2 TFLOP a 2-tuple step: 100 TFLOP/s
    assert bench._mfu_fields(100.0, 2e12, 2, "bfloat16") == {
        "tflops": 100.0, "mfu": round(100e12 / 989e12, 3)}
    assert bench._mfu_fields(100.0, 2e12, 2, "float32") == {}
    assert bench._mfu_fields(100.0, None, 2, "bfloat16") == {}


def test_int8_flag_is_refused_outside_extract():
    with pytest.raises(SystemExit) as e:
        bench.parse(["--metric", "query", "--int8"])
    assert e.value.code == 2


@pytest.mark.parametrize("fails_at,line", [(16, "_bs8"), (8, None)])
def test_extract_sweep_stops_at_out_of_memory(monkeypatch, capsys,
                                              fails_at, line):
    """A sweep ends at the first batch size that runs out of device memory;
    with no batch size done the exit code is 1 and nothing is printed."""
    def seconds(model, x, iters):
        if x.shape[0] >= fails_at:
            raise torch.OutOfMemoryError("out of memory")
        return 1.0

    monkeypatch.setattr(bench, "_extract_seconds", seconds)
    argv = ["--quick", "--height", "32", "--width", "32", "--dtype",
            "float32", "--iters", "3"] + CPU
    if line is None:
        with pytest.raises(SystemExit) as e:
            bench.main(argv)
        assert e.value.code == 1 and capsys.readouterr().out == ""
        return
    out = bench.main(argv)
    assert [r["metric"][-len(line):] for r in out] == [line]
    assert out[0]["value"] == 8 * 3 / 1.0


def test_extract_failure_other_than_memory_propagates(monkeypatch):
    def seconds(model, x, iters):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(bench, "_extract_seconds", seconds)
    with pytest.raises(RuntimeError, match="kernel failed"):
        bench.main(["--batch-size", "2", "--height", "32", "--width", "32",
                    "--dtype", "float32"] + CPU)


def test_bench_lane_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "import bench_torch\n"
            "import openibl_tpu_torch.tools.bench_all\n"
            "import openibl_tpu_torch.tools.probe_index_paths\n"
            "assert 'bench' not in sys.modules, 'bench.py imported'\n"
            "assert not any(m == 'openibl_tpu' or m.startswith("
            "'openibl_tpu.') for m in sys.modules), 'JAX package imported'\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# -- bench_all ---------------------------------------------------------------

STUB = """
import json, os, sys
args = sys.argv[1:]
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(" ".join(args) + "\\n")
if os.environ.get("STUB_FAIL") and os.environ["STUB_FAIL"] in args:
    sys.exit("stub failure")
value = (300.0 if "--int8" in args else 100.0 if "--no-fused" in args
         else 200.0 if "extract" in args else 10.0)
print("a line that is not JSON")
print(json.dumps({"metric": "m", "value": value, "unit": "u",
                  "vs_baseline": 1.0, "device": "stub"}))
"""


def test_bench_all_suite_is_the_scripts():
    script = _load("bench_all_jax", osp.join(ROOT, "scripts",
                                             "bench_all.py"))
    assert bench_all.SUITE == script.SUITE
    assert bench_all.BENCH[1] == osp.join(ROOT, "bench_torch.py")
    assert str(bench_all.ARTIFACTS) == osp.join(ROOT, "logs", "torch")


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """bench_all against the stub bench command, its artifacts under
    tmp_path; returns the log of the stub's argument lists."""
    path = tmp_path / "stub_bench.py"
    path.write_text(STUB)
    log = tmp_path / "calls.log"
    log.write_text("")
    monkeypatch.setattr(bench_all, "BENCH", [sys.executable, str(path)])
    monkeypatch.setattr(bench_all, "ARTIFACTS", tmp_path / "logs" / "torch")
    monkeypatch.setenv("STUB_LOG", str(log))
    monkeypatch.delenv("STUB_FAIL", raising=False)
    return log


def _calls(log):
    return log.read_text().splitlines()


def test_bench_all_only_resume_force_and_speedups(stub, tmp_path, capsys):
    artifact = tmp_path / "logs" / "torch" / "bench_r03.json"
    out = bench_all.main(["--round", "3", "--only",
                          "extract_fused,extract_nofused"])
    assert sorted(out["entries"]) == ["extract_fused", "extract_nofused"]
    assert out["fused_speedup"] == 2.0 and "int8_speedup" not in out
    assert json.loads(artifact.read_text()) == out
    assert len(_calls(stub)) == 2

    out = bench_all.main(["--round", "3"])  # the other seven
    assert len(_calls(stub)) == 9
    assert sorted(out["entries"]) == sorted(n for n, _ in bench_all.SUITE)
    assert all(e["rc"] == 0 and e["result"]["value"] > 0
               for e in out["entries"].values())
    assert out["int8_speedup"] == 1.5
    assert out["entries"]["query"]["args"] == dict(bench_all.SUITE)["query"]
    assert _calls(stub)[2:] == [" ".join(a) for n, a in bench_all.SUITE
                                if n not in ("extract_fused",
                                             "extract_nofused")]

    again = bench_all.main(["--round", "3"])  # resume: nothing runs
    assert len(_calls(stub)) == 9
    assert again["entries"] == out["entries"]

    bench_all.main(["--round", "3", "--only", "query", "--force"])
    assert _calls(stub)[9:] == [" ".join(dict(bench_all.SUITE)["query"])]
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.rindex('{\n  "round"'):])["round"] == 3


def test_bench_all_failed_entry_is_kept_and_rerun(stub, tmp_path,
                                                  monkeypatch):
    out_path = tmp_path / "elsewhere.json"
    monkeypatch.setenv("STUB_FAIL", "train")
    out = bench_all.main(["--round", "4", "--only", "train", "--out",
                          str(out_path)])
    entry = out["entries"]["train"]
    assert entry["rc"] == 1 and entry["result"] is None
    assert "stub failure" in entry["stderr_tail"]
    assert json.loads(out_path.read_text()) == out
    assert not (tmp_path / "logs").exists()
    monkeypatch.delenv("STUB_FAIL")
    out = bench_all.main(["--round", "4", "--only", "train", "--out",
                          str(out_path)])
    assert out["entries"]["train"]["rc"] == 0
    assert len(_calls(stub)) == 2


def test_bench_all_refuses_unknown_entries(stub):
    with pytest.raises(SystemExit) as e:
        bench_all.main(["--round", "1", "--only", "extract,query"])
    assert e.value.code == 2
    assert _calls(stub) == []


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_bench.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_extract_descriptors_match_the_cpu(cuda_device):
    """The bench's f32 extraction model on the card (K1) against the same
    model on the CPU (plain head), the same seeded pixels: descriptors
    within 1e-4, cosine > 0.99999."""
    from openibl_tpu_torch.ops import netvlad_kernel as nk

    args = bench.parse(["--height", "64", "--width", "96", "--dtype",
                        "float32"])
    x = bench.seeded_images(0, (2, 64, 96, 3))
    before = nk.netvlad_fused.launches
    with torch.inference_mode():
        a = bench.extract_model(args, False, torch.device("cpu"))(x).numpy()
        b = bench.extract_model(args, False, cuda_device)(
            x.to(cuda_device)).cpu().numpy()
    assert nk.netvlad_fused.launches - before == 1
    assert np.abs(a - b).max() <= 1e-4
    assert np.all((a * b).sum(-1) > 0.99999)


@pytest.mark.cuda
def test_cuda_extract_default_runs_bf16_then_int8(cuda_device):
    """On the card the default extract prints a bf16 line, then an _int8
    one; K1 runs in both modes, K3 eleven times a forward of the int8 one
    (a warm forward and --iters timed ones)."""
    from openibl_tpu_torch.ops import netvlad_kernel as nk
    from openibl_tpu_torch.ops import quant_kernel as qk

    nk.netvlad_fused.launches = qk.int8_conv.launches = 0
    lines = bench.main(["--batch-size", "2", "--iters", "2", "--height",
                        "64", "--width", "96", "--max-seconds", "0"])
    assert [ln["metric"] for ln in lines] == [
        "descriptor_images_per_sec_per_chip_64x96_bfloat16_bs2",
        "descriptor_images_per_sec_per_chip_64x96_bfloat16_int8_bs2"]
    assert all(ln["value"] > 0 and "mfu" in ln for ln in lines)
    assert nk.netvlad_fused.launches == 2 * 3
    assert qk.int8_conv.launches == 11 * 3
