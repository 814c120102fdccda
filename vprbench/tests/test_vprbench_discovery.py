"""A new configuration, traffic mix, per-layer metric, kernel and roofline
are found by their names alone: added as new files and new entries of
BENCHMARK.json in a copy of the benchmark, they run with no existing file
of the benchmark edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, TINY_CONFIG, TINY_TRAFFIC


def digests(folder):
    out = {}
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if "__pycache__" in dirpath:
                continue
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, folder)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_and_entries_are_found(tmp_path):
    shutil.copytree(os.path.join(ROOT, "vprbench"), tmp_path / "vprbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path / "vprbench")
    new = tmp_path / "vprbench"
    with open(new / "configs" / "vgg16-netvlad-f32.json") as f:
        config = json.load(f)
    config.update(TINY_CONFIG, name="tiny-f32")
    (new / "configs" / "tiny-f32.json").write_text(json.dumps(config))
    (new / "traffic" / "extract-b2.json").write_text(json.dumps(
        {"driver": "extract", "batch_size": 2, "check_batches": 1,
         **TINY_TRAFFIC["extract"]}))
    (new / "limits" / "build-tiny.json").write_text(
        json.dumps({"desc_gap": 1e-3}))
    (new / "kernels" / "K9.json").write_text(json.dumps(
        {"names": ["some_kernel"],
         "counter": "openibl_tpu_torch.ops.netvlad_kernel:netvlad_fused"}))
    (new / "rooflines" / "k9.py").write_text(
        'KERNEL = "K9"\n\n\ndef work(cfg, batch):\n'
        '    return {"ops": 2.0 * batch, "bytes": 4.0 * batch,'
        ' "precision": "f32"}\n\n\ndef calls(launches, cfg):\n'
        '    return launches\n')
    (new / "metrics" / "images.build.py").write_text(
        '"""Images the window extracted, and K9\'s bound at batch 2."""\n\n'
        'from vprbench.work import least_time\n\n\ndef read(run):\n'
        '    roof = run.roofline("k9")\n'
        '    assert run.kernels[roof.KERNEL]["names"] == ["some_kernel"]\n'
        '    bound = least_time(roof.work(run.config, 2), run.peaks)\n'
        '    return run.info["images"] + bound\n')
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-f32", "source": "a test",
                             "file": "vprbench/configs/tiny-f32.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "build-tiny", "config": "tiny-f32",
                               "traffic": "extract-b2", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({
        "name": "images.build", "unit": "images", "better": "higher",
        "source": "host_clock", "layer": "whole batch",
        "moves": "extract_images_per_s", "workloads": ["build-tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "extract_images_per_s":
            m["workloads"].append("build-tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = f"""
import sys, time, torch
sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]
import vprbench.run as r
assert r.ROOT == {str(tmp_path)!r}, r.ROOT
import importlib
from vprbench.common import Context
from vprbench.trace import Tracer
from vprbench.work import peaks
bench = r.load_json(r.os.path.join(r.ROOT, "BENCHMARK.json"))
cell, config, traffic, limits = r.cell_spec(bench, "build-tiny")
assert config["name"] == "tiny-f32" and traffic["batch_size"] == 2
per_layer = [m["name"] for m in r.metrics_of(bench, "build-tiny", "per_layer")]
assert "images.build" in per_layer, per_layer
kernels = r.kernel_map()
assert "K9" in kernels
driver = importlib.import_module("vprbench.drivers." + traffic["driver"])
ctx = Context(config=config, traffic=traffic, seed=5,
              seconds=0.5, trace=False, device=torch.device("cpu"),
              t_start=time.perf_counter(), tracer=Tracer(False))
out = driver.run(ctx)
checks, ok = r.judge(out.checks, limits)
assert ok, checks
reading = r.Reading(config, traffic, out, {{}}, peaks(), kernels)
value = r.load_file_module(r.os.path.join(r.HERE, "metrics", "images.build.py"),
                           "m").read(reading)
assert value >= out.info["images"] > 0
print("found", value)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    after = digests(tmp_path / "vprbench")
    assert {k: after[k] for k in before} == before
