"""The four-GPU SARE cell (``train-sare-4chip``) on gloo ranks: at the tiny
size on the CPU (two ranks, ``vprbench/conftest.py``) a fault on rank 0
alone reads not correct; on a card its driver runs at NCCL world size 1
and with four gloo ranks sharing the card, each correct."""

import time

import pytest
import torch

from conftest import ROOT, limits, tiny_context

CELL = "train-sare-4chip"


def judged(ctx, backend=None):
    from vprbench import run as bench_run
    from vprbench.drivers import train_mesh

    outcome = train_mesh.run(ctx, backend=backend)
    checks, correct = bench_run.judge(outcome.checks, limits(CELL))
    return correct and outcome.failed == 0, checks


def test_rank_0_alone_leaving_its_state_unchanged_is_not_correct(
        monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step",
                        lambda self, closure=None: None)
    _, ctx = tiny_context(CELL)
    correct, checks = judged(ctx)
    assert not correct
    assert checks["ranks_unequal"]["value"] > 0
    assert checks["change_gap"]["value"] == 1.0


def test_rank_0_alone_leaving_out_half_its_negatives_is_not_correct(
        monkeypatch):
    from openibl_tpu_torch.engine import trainer
    from openibl_tpu_torch.ops.losses import tuple_loss

    def half(desc, loss_type, margin=None):
        keep = 2 + (desc.shape[1] - 2) // 2
        return tuple_loss(desc[:, :keep], loss_type, margin)

    monkeypatch.setattr(trainer, "tuple_loss", half)
    _, ctx = tiny_context(CELL)
    correct, checks = judged(ctx)
    assert not correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,backend", [(1, "nccl"), (4, "gloo")])
def test_the_driver_on_one_card(card, ranks, backend):
    from vprbench import run as bench_run
    from vprbench.common import Context
    from vprbench.trace import Tracer

    bench = bench_run.load_json(f"{ROOT}/BENCHMARK.json")
    _, config, traffic, _ = bench_run.cell_spec(bench, CELL)
    ctx = Context(config=config, traffic=dict(traffic, ranks=ranks),
                  seed=2147483777, seconds=3.0, trace=False, device=card,
                  t_start=time.perf_counter(), tracer=Tracer(False))
    correct, checks = judged(ctx, backend)
    assert correct, checks
