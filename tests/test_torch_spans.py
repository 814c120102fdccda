"""``utils.profiling.span`` and the spans of the port's serving, extraction
and train step, on the CPU with tiny stand-in models (each test well
under a second): off, a span is one shared null context and records
nothing; on (under ``torch.profiler``), records nest on their thread,
inherit their root's ids, stay in a bounded buffer and carry no stream
time for CPU work.

The test marked ``cuda`` needs a card and skips here; on a GPU machine
run ``pytest --noconftest -m cuda tests/test_torch_spans.py`` (it imports
no jax).
"""

import collections
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch import serving  # noqa: E402
from openibl_tpu_torch.engine.trainer import Trainer  # noqa: E402
from openibl_tpu_torch.parallel.extract import extract_features  # noqa: E402
from openibl_tpu_torch.utils import l2_normalize, profiling  # noqa: E402

H, W, D = 8, 12, 8
SERVE_STAGES = ("serve.preprocess", "serve.lock_wait", "serve.h2d",
                "serve.forward", "serve.search", "serve.results")


class TinyEmbed(torch.nn.Module):
    """(B, H, W, 3) pixels → (pool, unit descriptors of width D): a
    stand-in for the hub's model with the EmbedNet call convention."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.proj = torch.nn.Linear(3, D)
        self.net_vlad = torch.nn.Module()
        self.net_vlad.fused = False

    def forward(self, images):
        pool = self.proj(images.float().mean(dim=(1, 2)))
        return pool, l2_normalize(pool)


class TinyService(TinyEmbed):
    def forward(self, images):
        return super().forward(images)[1]


@pytest.fixture
def buffer(monkeypatch):
    """A fresh span buffer of the default bound for the test."""
    fresh = collections.deque(maxlen=profiling.SPAN_RECORDS)
    monkeypatch.setattr(profiling, "_records", fresh)
    return fresh


def traced():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def frames(n, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (n, H, W, 3)).astype(np.uint8)


def serve(monkeypatch, clients=4, each=2):
    """``clients`` threads querying one service at once, ``each`` single
    frame requests a thread."""
    monkeypatch.setattr(serving, "vgg16_netvlad",
                        lambda *a, **k: TinyService())
    rows = l2_normalize(torch.randn(16, D)).numpy()
    service = serving.RetrievalService({"descriptors": rows}, height=H,
                                       width=W, device="cpu")
    start = threading.Barrier(clients)
    errors = []

    def client(c):
        try:
            start.wait(timeout=10)
            for i in range(each):
                out = service.query([frames(1, seed=c * each + i)[0]],
                                    topk=3)
                assert [m["rank"] for m in out[0]] == [1, 2, 3]
        except Exception as exc:  # read back in the main thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # the threads interleave more often
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return clients * each


def extract(monkeypatch):
    loader = [(frames(2, seed=b), [2 * b, 2 * b + 1], 2) for b in range(3)]
    out = extract_features(TinyEmbed(), loader)
    assert out.shape == (6, D)
    return len(loader)


def train(monkeypatch, steps=2):
    trainer = Trainer(TinyEmbed(), loss_type="triplet")
    trainer.init()
    for s in range(steps):
        tup = np.random.RandomState(s).rand(1, 4, H, W, 3).astype(np.float32)
        assert torch.isfinite(trainer.step(tup))
    assert trainer.steps == steps
    return steps


PATHS = {"serve": serve, "extract": extract, "train": train}


def by_root(records):
    groups = collections.defaultdict(list)
    for r in records:
        groups[r.root].append(r)
    return groups


def test_off_a_span_is_the_shared_null_context(buffer):
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("serve.h2d", stream="cpu", request=1)
    assert first is profiling.span("other") is profiling._OFF
    with first as rec:
        assert rec is None
    assert not buffer and profiling.recorded() == []


@pytest.mark.parametrize("path", sorted(PATHS))
def test_untraced_port_records_nothing(path, buffer, monkeypatch):
    PATHS[path](monkeypatch)
    assert not buffer


def check_serve(records, n):
    roots = by_root(records)
    assert len(roots) == n
    requests = set()
    for root, recs in roots.items():
        head = next(r for r in recs if r.index == root)
        assert head.name == "serve.query" and head.parent is None
        assert sorted(r.name for r in recs[1:]) == sorted(SERVE_STAGES)
        assert all(r.parent == root for r in recs[1:])
        # one request id a request, all its spans on its own thread
        assert {r.thread for r in recs} == {head.thread}
        assert {r.ids["request"] for r in recs} == {head.ids["request"]}
        requests.add(head.ids["request"])
        assert all(head.t0 <= r.t0 <= r.t1 <= head.t1 for r in recs)
    assert len(requests) == n
    assert len({r.thread for r in records}) > 1


def check_extract(records, n):
    root, = [r for r in records if r.parent is None]
    assert root.name == "extract.features" and root.ids == {}
    kids = [r for r in records if r.parent is not None]
    assert [(r.name, r.ids) for r in kids] == [
        (name, {"batch": b}) for b in range(n)
        for name in ("extract.h2d", "extract.forward")]
    assert all(r.root == root.index for r in kids)


def check_train(records, n):
    roots = by_root(records)
    assert len(roots) == n
    for s, (root, recs) in enumerate(sorted(roots.items())):
        assert [r.name for r in recs] == ["train.step", "train.h2d",
                                          "train.forward", "train.backward"]
        assert all(r.ids == {"step": s} for r in recs)
        assert all(r.parent == root for r in recs[1:])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_traced_port_records_its_stages(path, buffer, monkeypatch):
    with traced():
        n = PATHS[path](monkeypatch)
    records = profiling.recorded()
    assert records and len(records) == len(buffer)
    {"serve": check_serve, "extract": check_extract,
     "train": check_train}[path](records, n)
    # CPU work has no stream time, even where the span asked for one
    assert all(r.stream_ms is None for r in records)


@pytest.mark.parametrize("threads", [1, 3])
def test_spans_nest_per_thread_and_inherit_ids(threads, buffer):
    def work(k):
        with profiling.span("root", request=k):
            with profiling.span("mid", batch=k + 10):
                with profiling.span("leaf", stream="cpu"):
                    time.sleep(0.001)
            with profiling.span("sibling"):
                pass

    t_lo = time.perf_counter()
    with traced():
        pool = [threading.Thread(target=work, args=(k,))
                for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=10)
    records = profiling.recorded(t_lo, time.perf_counter())
    assert len(records) == 4 * threads
    for recs in by_root(records).values():
        root, mid, leaf, sib = sorted(recs, key=lambda r: r.index)
        k = root.ids["request"]
        assert (root.name, mid.name, leaf.name, sib.name) == (
            "root", "mid", "leaf", "sibling")
        assert root.parent is None and root.root == root.index
        assert mid.parent == root.index and sib.parent == root.index
        assert leaf.parent == mid.index and leaf.root == root.index
        assert leaf.ids == {"request": k, "batch": k + 10}
        assert sib.ids == {"request": k}
        assert len({r.thread for r in recs}) == 1
        assert root.t0 <= mid.t0 <= leaf.t0 <= leaf.t1 <= mid.t1 \
            <= sib.t0 <= sib.t1 <= root.t1
        assert leaf.t1 - leaf.t0 >= 0.001 and leaf.stream_ms is None
    # a window that ends before the spans start holds none of them
    assert profiling.recorded(None, t_lo) == []


@pytest.mark.parametrize("bound", [1, 4])
def test_the_buffer_keeps_the_last_spans(bound, monkeypatch):
    monkeypatch.setattr(profiling, "_records",
                        collections.deque(maxlen=bound))
    with traced():
        for k in range(bound + 3):
            with profiling.span("s", request=k):
                pass
    assert [r.ids["request"] for r in profiling.recorded()] == list(
        range(3, bound + 3))


@pytest.mark.cuda
def test_stream_time_of_a_known_kernel(buffer):
    """The stream time of a span around one matrix product lies above 0
    and below the span's host duration plus the product's own time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_spans.py`")
    dev = torch.device("cuda")
    x = torch.randn(4096, 4096, device=dev)
    x @ x
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    x @ x
    end.record()
    end.synchronize()
    kernel_ms = start.elapsed_time(end)
    with traced():
        with profiling.span("matmul", stream=dev) as rec:
            x @ x
    host_ms = 1e3 * (rec.t1 - rec.t0)
    assert 0 < rec.stream_ms < host_ms + kernel_ms
