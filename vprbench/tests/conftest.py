"""Shared pieces of the benchmark's own tests: the cells at a tiny size on
the CPU, and the fixture that decides whether a card is there.

Run from the root of the checkout: ``python -m pytest vprbench/tests -q``
(on the card: ``python -m pytest vprbench/tests -q -m cuda``).
"""

import importlib
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "vprbench")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells at a size the CPU holds: 64x96 frames (a 4x6 conv5 map), every
# width as published, few requests, batches and negatives
TINY_CONFIG = {"height": 64, "width": 96, "cluster_frames": 4,
               "index_rows": 500}
TINY_TRAFFIC = {
    "serve": {"rate_per_s": 20.0, "frames": 8,
              "check_requests": 4, "clients": 4},
    "extract": {"batch_size": 2, "shard_batches": 3},
    "train": {"neg_num": 2, "pool_tuples": 4},
}
SEED = 2**31 + 12345


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cells():
    return [w["name"] for w in load_json(
        os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


def tiny_context(cell, seed=SEED, seconds=1.0):
    """(driver module, Context) of ``cell`` at the tiny size on the CPU."""
    from vprbench import run as bench_run
    from vprbench.common import Context
    from vprbench.trace import Tracer

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, config, traffic, _ = bench_run.cell_spec(bench, cell)
    config = dict(config, **TINY_CONFIG)
    traffic = dict(traffic, **TINY_TRAFFIC[traffic["driver"]])
    ctx = Context(config=config, traffic=traffic, seed=seed,
                  seconds=seconds, trace=False, device=torch.device("cpu"),
                  t_start=time.perf_counter(), tracer=Tracer(False))
    driver = importlib.import_module(f"vprbench.drivers.{traffic['driver']}")
    return driver, ctx


def limits(cell):
    return load_json(os.path.join(HERE, "limits", f"{cell}.json"))


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, at run
    time, never while a module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
