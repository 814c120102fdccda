"""The AnyLoc build cell (``build-anyloc-vitg14-f32``) at the tiny size on
the CPU, beyond what every cell goes through (``test_vprbench_cells.py``,
``test_vprbench_control.py``): each planted fault reads not correct, so
does a margin that makes every token ambiguous, and a port without the
model fails before it makes anything. The margin rule's reference is
``vprbench/reference/anyloc.py``."""

import math
import sys

import pytest
import torch

from conftest import limits, tiny_context

CELL = "build-anyloc-vitg14-f32"


def judged(ctx=None):
    from vprbench import run as bench_run

    driver, tiny = tiny_context(CELL)
    outcome = driver.run(ctx or tiny)
    checks, correct = bench_run.judge(outcome.checks, limits(CELL))
    return correct and outcome.failed == 0, checks


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_a_fault_in_the_written_rows_is_not_correct(monkeypatch, fault):
    from openibl_tpu_torch.parallel import extract

    make = extract.make_extract_fn

    def broken(*args, **kwargs):
        fwd = make(*args, **kwargs)

        def run(images, *extra):
            if fault == "half_batch":  # the rest copies the first half
                half = fwd(images[: max(1, len(images) // 2)], *extra)
                return half.repeat(2, 1)[: len(images)]
            out = fwd(images, *extra).clone()
            out[-1] = torch.nn.functional.normalize(out[-1] + 0.05, dim=0)
            return out

        return run

    monkeypatch.setattr(extract, "make_extract_fn", broken)
    correct, checks = judged()
    assert not correct, checks


def test_more_ambiguous_tokens_than_the_rule_takes_is_not_correct():
    _, ctx = tiny_context(CELL)
    ctx.traffic["tie_margin"] = 10.0  # every token within it of a tie
    correct, checks = judged(ctx)
    assert not correct
    assert checks["ambiguous_max"]["value"] > 8
    assert checks["desc_gap"]["value"] is None  # inf: not enumerated


def test_the_reference_rule_excuses_only_near_ties():
    from vprbench.reference import anyloc as ref

    g = torch.Generator().manual_seed(7)
    tokens = torch.nn.functional.normalize(
        torch.randn(30, 16, generator=g, dtype=torch.float64), dim=1)
    centers = torch.nn.functional.normalize(
        torch.randn(3, 16, generator=g, dtype=torch.float64), dim=1)
    sims = ref.cosines(tokens, centers)
    top = sims.topk(2, dim=-1)
    margin = top.values[:, 0] - top.values[:, 1]
    near, far = int(margin.argmin()), int(margin.argmax())
    labels = top.indices[:, 0].clone()
    labels[near] = top.indices[near, 1]  # the nearest tie goes the other way
    flipped = ref.vlad(tokens, centers, labels)
    tau = float(margin[near]) * 1.01
    gap, m = ref.nearest(flipped, tokens, centers, tau, 8)
    assert m == 1 and gap < 1e-12
    labels[far] = top.indices[far, 1]  # and a clear token too
    gap, _ = ref.nearest(ref.vlad(tokens, centers, labels), tokens, centers,
                         tau, 8)
    assert gap > 1e-2
    assert ref.nearest(flipped, tokens, centers, 10.0, 8) == (math.inf, 30)


def test_a_port_without_the_model_fails_before_making_anything(monkeypatch):
    driver, ctx = tiny_context(CELL)
    monkeypatch.setitem(sys.modules, "openibl_tpu_torch.models.anyloc", None)
    with pytest.raises(ImportError):
        driver.run(ctx)
    assert not ctx.setup_steps
