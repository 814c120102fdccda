"""The tiny sizes of the cells whose drivers came after
``vprbench/tests/conftest.py`` was written: its ``TINY_CONFIG`` gains the
AnyLoc widths (keys that the VGG16 configurations do not have, so their
cells run as before) and its ``TINY_TRAFFIC`` the ``extract_anyloc`` and
``train_mesh`` drivers, as soon as pytest registers that conftest. A cell
that asks for more CUDA devices than the machine has skips its run on the
card, decided when the test runs."""

import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS_CONFTEST = os.path.join(HERE, "tests", "conftest.py")

# AnyLoc at width 64: 4 heads, the facet at block 1, SwiGLU by the
# published rule, a 6 x 6 position table, 4 clusters
TINY_ANYLOC = {"embed_dim": 64, "num_heads": 4, "facet_block": 1,
               "ffn_hidden": 176, "pos_grid": 6, "vlad_clusters": 4}
TINY_DRIVERS = {
    "extract_anyloc": {"batch_size": 2, "shard_batches": 3},
    "train_mesh": {"ranks": 2, "neg_num": 2, "pool_tuples": 4,
                   "timed_steps": 2},
}


def pytest_plugin_registered(plugin, manager):
    path = getattr(plugin, "__file__", None)
    if path and os.path.abspath(path) == TESTS_CONFTEST:
        plugin.TINY_CONFIG.update(TINY_ANYLOC)
        plugin.TINY_TRAFFIC.update(TINY_DRIVERS)


def chips(cell):
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        return next(w["chips"] for w in json.load(f)["workloads"]
                    if w["name"] == cell)


def pytest_runtest_setup(item):
    if item.originalname != "test_cell_on_the_card":
        return
    import torch

    need = chips(item.callspec.params["cell"])
    if torch.cuda.is_available() and torch.cuda.device_count() < need:
        pytest.skip(f"the cell asks for {need} CUDA devices, the machine "
                    f"has {torch.cuda.device_count()}")
