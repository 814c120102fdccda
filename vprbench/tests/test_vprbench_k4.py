"""K4's yardstick (rooflines/k4.py), its reader (metrics/k4_roofline.build.py)
and its launch counter (k4_counter.py), against figures worked out by
hand and on a checkout of the port without K4."""

import json
import os
import sys

import pytest

from conftest import HERE


def cfg(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_k4_at_batch_16():
    from vprbench.rooflines import k4
    from vprbench.work import least_time, peaks

    c = cfg("vgg16-netvlad-f32")
    w = k4.work(c, 16)
    # conv1_1..conv5_3 at 480x640: 2 * 9 * h * w * Cin * Cout an image
    # (conv1_1 at its 3 input channels)
    per_image = 2 * 9 * (480 * 640 * (3 * 64 + 64 * 64)
                         + 240 * 320 * (64 * 128 + 128 * 128)
                         + 120 * 160 * (128 * 256 + 2 * 256 * 256)
                         + 60 * 80 * (256 * 512 + 2 * 512 * 512)
                         + 30 * 40 * 3 * 512 * 512)
    assert w["ops"] == 16 * per_image == 3_006_686_822_400
    assert w["precision"] == "tf32"
    bound = least_time(w, peaks())
    assert bound == pytest.approx(w["ops"] / 495e12)  # operations set it
    assert bound * 1e3 == pytest.approx(6.0741, abs=1e-4)
    assert k4.calls(26, c) == 2  # 13 layers a forward


def test_k4_in_the_int8_model_is_conv1_x():
    from vprbench.rooflines import k4
    from vprbench.work import least_time, peaks

    c = cfg("vgg16-netvlad-int8")
    w = k4.work(c, 16)
    assert w["ops"] == 16 * 2 * 9 * 480 * 640 * (3 * 64 + 64 * 64)
    # their f32 inputs and outputs, weights and biases
    assert w["bytes"] == (16 * 480 * 640 * (3 + 64 + 64 + 64) * 4
                          + 9 * (3 + 64) * 64 * 4 + 2 * 64 * 8)
    bound = least_time(w, peaks())
    assert bound == pytest.approx(w["bytes"] / 3.35e12)  # bytes set it
    assert k4.calls(6, c) == 3  # two layers a forward


def test_k4_reader():
    from vprbench import run as bench_run
    from vprbench.common import Outcome
    from vprbench.work import least_time, peaks

    class FakeTrace:  # every launch of K4 took 1 ms on the device
        def kernel_seconds(self, names):
            assert names == ["conv3x3_f32x3"]
            return 26 * 1e-3, 26

    c = cfg("vgg16-netvlad-f32")
    outcome = Outcome(attempted=1, failed=0, values={}, checks={},
                      memory_peak_bytes=0, trace=FakeTrace())
    reading = bench_run.Reading(c, {"batch_size": 16}, outcome, {"K4": 26},
                                peaks(), bench_run.kernel_map())
    reader = bench_run.load_file_module(
        bench_run.metric_reader("k4_roofline.build"), "m")
    bound = least_time(reading.roofline("k4").work(c, 16), peaks())
    assert reader.read(reading) == pytest.approx(100 * bound / 13e-3)
    reading.counts = {"K4": 0}  # a port without K4: nothing to read
    assert reader.read(reading) is None


def test_k4_counter_reads_the_port_or_nothing(monkeypatch):
    from vprbench import run as bench_run
    from vprbench.k4_counter import conv3x3_f32

    from openibl_tpu_torch.ops import conv_kernel

    read = bench_run.counter_readers(bench_run.kernel_map())["K4"]
    monkeypatch.setattr(conv_kernel.conv3x3_f32, "launches", 7)
    assert read() == conv3x3_f32.launches == 7
    # a checkout whose port has no ops/conv_kernel.py
    monkeypatch.setitem(sys.modules, "openibl_tpu_torch.ops.conv_kernel",
                        None)
    assert read() == 0
