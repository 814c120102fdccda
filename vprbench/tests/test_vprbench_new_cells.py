"""The two cells added beside the first four are found by their names
alone (configuration, traffic, driver, limits and per-layer readers), and
what they import is the port's only when they run."""

import os
import subprocess
import sys

from conftest import HERE, ROOT, load_json

CELLS = {"build-anyloc-vitg14-f32": (
    "extract_anyloc", ["device_idle.build", "attn_device_ms.anyloc",
                       "mlp_device_ms.anyloc", "vlad_device_ms.anyloc",
                       "mfu.anyloc"]),
    "train-sare-4chip": ("train_mesh", ["mfu.train", "device_idle.train"])}


def test_the_new_cells_are_found_by_name():
    from vprbench import run as bench_run

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for cell, (driver, metrics) in CELLS.items():
        entry, config, traffic, limits = bench_run.cell_spec(bench, cell)
        assert traffic["driver"] == driver and limits
        assert os.path.exists(os.path.join(HERE, "drivers", f"{driver}.py"))
        listed = [m["name"] for m in bench_run.metrics_of(bench, cell,
                                                          "per_layer")]
        assert listed == metrics
        for name in metrics:
            assert os.path.exists(bench_run.metric_reader(name))
        e2e = [m["name"] for m in bench_run.metrics_of(bench, cell,
                                                       "end_to_end")]
        assert "setup_s" in e2e and len(e2e) == 2
    assert sum(w["chips"] == 4 for w in bench["workloads"]) == 1


def test_the_new_modules_import_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r); "
            "import vprbench.drivers.extract_anyloc, "
            "vprbench.drivers.train_mesh, vprbench.reference.anyloc, "
            "vprbench.anyloc_inputs, vprbench.work_anyloc, "
            "vprbench.span_sums; "
            "from vprbench.run import forbidden_modules; "
            "bad = forbidden_modules(); "
            "port = [m for m in sys.modules if m.split('.')[0] == "
            "'openibl_tpu_torch']; print(bad, port); "
            "sys.exit(1 if bad or port else 0)") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_work_of_an_image():
    from vprbench.work_anyloc import layers

    cfg = load_json(os.path.join(HERE, "configs",
                                 "dinov2-vitg14-anyloc-f32.json"))
    by = {it["layer"]: it["ops"] for it in layers(cfg)}
    t, d = 34 * 45 + 1, 1536
    # one block by hand: qkv, q k^T and a v, proj, w12, w3
    block = 2 * t * d * (3 * d + d + 2 * 4096) + 2 * t * 4096 * d \
        + 2 * 2 * t * t * d
    assert by["attention"] == 31 * 2 * 2 * t * t * d
    assert abs(sum(by[k] for k in ("qkv", "attention", "proj", "w12", "w3"))
               - 31 * block) == 0
    assert 3.14e12 < sum(by.values()) < 3.15e12
