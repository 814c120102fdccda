"""The yardstick's counts against figures worked out by hand."""

import json
import os

import pytest

from conftest import HERE


def cfg(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_k1_at_batch_16():
    from vprbench.rooflines import k1
    from vprbench.work import least_time, peaks

    w = k1.work(cfg("vgg16-netvlad-f32"), 16)
    # soft-assignment and aggregation: 2 products of 2 * 1200 * 512 * 64
    assert w["ops"] == 2 * 2 * 16 * 1200 * 512 * 64 == 2_516_582_400
    # the map 16 x 1200 x 512 f32, two 512 x 64 f32 matrices, the
    # 16 x 32768 f32 descriptors
    assert w["bytes"] == 39_321_600 + 262_144 + 2_097_152 == 41_680_896
    bound = least_time(w, peaks())
    assert bound == pytest.approx(41_680_896 / 3.35e12)  # bytes set it
    assert bound * 1e3 == pytest.approx(0.012442, abs=1e-6)


def test_k3_at_batch_16():
    from vprbench.rooflines import k3
    from vprbench.work import least_time, peaks

    c = cfg("vgg16-netvlad-int8")
    w = k3.work(c, 16)
    per_image = (2 * 9 * (240 * 320 * (64 * 128 + 128 * 128)
                          + 120 * 160 * (128 * 256 + 2 * 256 * 256)
                          + 60 * 80 * (256 * 512 + 2 * 512 * 512)
                          + 30 * 40 * 3 * 512 * 512))
    assert w["ops"] == 16 * per_image == 2_627_312_025_600
    bound = least_time(w, peaks())
    assert bound == pytest.approx(w["ops"] / 1979e12)  # operations set it
    assert bound * 1e3 == pytest.approx(1.3276, abs=1e-4)
    assert k3.calls(22, c) == 2  # 11 int8 layers a forward


def test_layer_table_matches_the_analytic_count():
    from vprbench.work import model_work

    # 2 x multiply-adds of an image at 480x640: VGG16's 3x3 convolutions
    # to conv5_3 (each pool halves), NetVLAD's two products over the 30x40
    # map, PCA 32768 -> 4096
    convs = 2 * 9 * (480 * 640 * (3 * 64 + 64 * 64)
                     + 240 * 320 * (64 * 128 + 128 * 128)
                     + 120 * 160 * (128 * 256 + 2 * 256 * 256)
                     + 60 * 80 * (256 * 512 + 2 * 512 * 512)
                     + 30 * 40 * 3 * 512 * 512)
    head = 2 * 2 * 30 * 40 * 512 * 64 + 2 * 32768 * 4096
    items = model_work(cfg("vgg16-netvlad-f32"), 1)
    assert sum(it["ops"] for it in items) == convs + head == 188_343_648_256
    assert {it["precision"] for it in items} == {"f32"}
    int8 = model_work(cfg("vgg16-netvlad-int8"), 1)
    assert [it["layer"] for it in int8 if it["precision"] == "int8"] == [
        "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3", "conv4_1",
        "conv4_2", "conv4_3", "conv5_1", "conv5_2", "conv5_3"]


def test_peaks_hold_f32_work_to_the_tf32_rate():
    from vprbench.work import peaks

    pk = peaks()
    assert pk["ops_per_s"]["f32"] == pk["ops_per_s"]["tf32"] == 495e12
    assert pk["ops_per_s"]["bf16"] == 989e12
    assert pk["ops_per_s"]["int8"] == 1979e12
    assert pk["bytes_per_s"] == 3.35e12


@pytest.mark.parametrize("kernel,metric,launches,calls", [
    ("K1", "k1_roofline.build", 16, 16), ("K3", "k3_roofline.build", 22, 2)])
def test_roofline_readers(kernel, metric, launches, calls):
    from vprbench import run as bench_run
    from vprbench.common import Outcome
    from vprbench.work import least_time, peaks

    class FakeTrace:  # every launch of the kernel took 1 ms on the device
        def kernel_seconds(self, names):
            assert names == bench_run.kernel_map()[kernel]["names"]
            return launches * 1e-3, launches

    c = cfg("vgg16-netvlad-int8")
    outcome = Outcome(attempted=1, failed=0, values={}, checks={},
                      memory_peak_bytes=0, trace=FakeTrace())
    reading = bench_run.Reading(c, {"batch_size": 16}, outcome,
                                {kernel: launches}, peaks(),
                                bench_run.kernel_map())
    value = bench_run.load_file_module(bench_run.metric_reader(metric),
                                       "m").read(reading)
    roof = reading.roofline(kernel.lower())
    bound = least_time(roof.work(c, 16), peaks())
    assert value == pytest.approx(100 * bound / (launches * 1e-3 / calls))
    reading.counts = {}
    assert bench_run.load_file_module(bench_run.metric_reader(metric),
                                      "m").read(reading) is None
