"""K5's yardstick (rooflines/k5.py), its reader (metrics/k5_roofline.anyloc.py)
and its launch counter (k5_counter.py), against figures worked out by hand
and on a checkout of the port without K5."""

import json
import os
import sys

import pytest

from conftest import HERE


def cfg(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_k5_at_batch_16_is_the_five_linears():
    from vprbench.rooflines import k5
    from vprbench.work import least_time, peaks
    from vprbench.work_anyloc import layers

    c = cfg("dinov2-vitg14-anyloc-f32")
    w = k5.work(c, 16)
    by = {it["layer"]: it for it in layers(c, 16)}
    assert w["ops"] == sum(by[n]["ops"] for n in k5.LINEARS)
    # 1531 tokens an image (1530 patches and CLS), width 1536, SwiGLU
    # hidden 4096, 31 blocks; the facet's value rows over the 1530 patches
    t, d, f = 1531, 1536, 4096
    per_image = (31 * 2 * t * d * (3 * d + d + 2 * f + f)
                 + 2 * 1530 * d * d)
    assert w["ops"] == 16 * per_image == 43_113_737_355_264
    assert w["precision"] == "tf32"
    bound = least_time(w, peaks())
    assert bound == pytest.approx(w["ops"] / 495e12)  # operations set it
    assert bound * 1e3 == pytest.approx(87.10, abs=5e-3)
    assert k5.calls(250, c) == 2  # 4 x 31 + 1 linears a forward


def test_k5_reader_reads_nothing_where_k5_did_not_run():
    from vprbench import run as bench_run
    from vprbench.common import Outcome
    from vprbench.work import least_time, peaks

    class FakeTrace:  # every launch of K5 took 2 ms on the device
        def __init__(self, launches):
            self.launches = launches

        def kernel_seconds(self, names):
            assert names == ["linear_f32x3"]
            return self.launches * 2e-3, self.launches

    c = cfg("dinov2-vitg14-anyloc-f32")
    outcome = Outcome(attempted=1, failed=0, values={}, checks={},
                      memory_peak_bytes=0, trace=FakeTrace(250))
    reading = bench_run.Reading(c, {"batch_size": 16}, outcome, {"K5": 250},
                                peaks(), bench_run.kernel_map())
    reader = bench_run.load_file_module(
        bench_run.metric_reader("k5_roofline.anyloc"), "m")
    bound = least_time(reading.roofline("k5").work(c, 16), peaks())
    assert reader.read(reading) == pytest.approx(100 * bound / 0.25)
    reading.counts = {"K5": 0}  # a port without K5: nothing to read
    assert reader.read(reading) is None
    reading.counts = {}  # a harness whose counters lack K5
    assert reader.read(reading) is None
    reading.counts = {"K5": 250}
    reading.trace = FakeTrace(0)  # no K5 kernel in the trace
    assert reader.read(reading) is None


def test_k5_counter_reads_the_port_or_nothing(monkeypatch):
    from vprbench import run as bench_run
    from vprbench.k5_counter import linear_f32

    from openibl_tpu_torch.ops import linear_kernel

    read = bench_run.counter_readers(bench_run.kernel_map())["K5"]
    monkeypatch.setattr(linear_kernel.linear_f32, "launches", 9)
    assert read() == linear_f32.launches == 9
    # a checkout whose port has no ops/linear_kernel.py
    monkeypatch.setitem(sys.modules, "openibl_tpu_torch.ops.linear_kernel",
                        None)
    assert read() == 0
