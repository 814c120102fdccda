"""The rest of a run, with the timed path broken underneath, reads not
correct: for each fault a cell can have (one chip: no exchange between
chips), at the tiny size on the CPU."""

import pytest
import torch

from conftest import limits, tiny_context


def judged(cell):
    from vprbench import run as bench_run

    driver, ctx = tiny_context(cell)
    outcome = driver.run(ctx)
    _, correct = bench_run.judge(outcome.checks, limits(cell))
    return correct and outcome.failed == 0


def test_serve_answer_altered(monkeypatch):
    from openibl_tpu_torch.serving import RetrievalService

    query = RetrievalService.query

    def altered(self, images, topk=10):
        out = query(self, images, topk)
        out[0][0]["index"] = (out[0][0]["index"] + 1) % self.index_size
        return out

    monkeypatch.setattr(RetrievalService, "query", altered)
    assert not judged("serve-pitts250k-f32")


@pytest.mark.parametrize("cell", ["build-pitts250k-f32",
                                  "build-pitts250k-int8"])
@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_build_fault(monkeypatch, cell, fault):
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
    assert not judged(cell)


def test_train_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None:
                        None)
    assert not judged("train-sare-ts1-f32")


def test_train_half_batch_left_out(monkeypatch):
    from openibl_tpu_torch.engine import trainer
    from openibl_tpu_torch.ops.losses import tuple_loss

    def half(desc, loss_type, margin=None):  # half the negatives, the mean
        keep = 2 + (desc.shape[1] - 2) // 2  # over the rest
        return tuple_loss(desc[:, :keep], loss_type, margin)

    monkeypatch.setattr(trainer, "tuple_loss", half)
    assert not judged("train-sare-ts1-f32")
