"""The import guard compares whole top-level names, and a checkout that
holds only the benchmark gives no result."""

import os
import shutil
import subprocess
import sys

from conftest import ROOT


def test_guard_compares_whole_top_level_names():
    from vprbench.run import forbidden_modules

    loaded = ["openibl_tpu_torch", "openibl_tpu_torch.ops.quant",
              "openibl_tpu", "openibl_tpu.models", "jax", "jaxlib.xla_client",
              "flax.linen", "benchmark", "jaxtyping", "openibl_tpu_x",
              "bench", "chip_smoke", "__graft_entry__", "torch"]
    assert forbidden_modules(loaded) == sorted(
        ["openibl_tpu", "openibl_tpu.models", "jax", "jaxlib.xla_client",
         "flax.linen", "bench", "chip_smoke", "__graft_entry__"])


def test_the_harness_and_the_reference_import_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r); import vprbench.run, "
            "vprbench.inputs, vprbench.trace, vprbench.work, "
            "vprbench.drivers.serve, vprbench.drivers.extract, "
            "vprbench.drivers.train, vprbench.reference.model, "
            "vprbench.reference.quant, vprbench.reference.train, "
            "vprbench.reference.search; "
            "from vprbench.run import forbidden_modules; "
            "bad = forbidden_modules(); "
            "port = [m for m in sys.modules if m.split('.')[0] == "
            "'openibl_tpu_torch']; print(bad, port); "
            "sys.exit(1 if bad or port else 0)") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_checkout_of_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "vprbench"), tmp_path / "vprbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "vprbench/run.py", "--workload",
         "build-pitts250k-f32", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
