"""What the measurement tools of this package share: the ``--device`` flag,
the name of the device a number was taken on, per-call timing, and the
artifact directory with its atomic write.

Timing follows one rule. On the card, a run of warm, back-to-back calls is
bracketed by CUDA events recorded on the current stream between the calls,
then one ``synchronize``: each interval is one call's time on the device's
clock, and no host round trip sits between the calls. On the CPU the host
clock times each call (a CPU number is never a device number).
"""

import json
import pathlib
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
# the tools' artifacts; the JAX package's committed ones sit one level up
ARTIFACTS = ROOT / "logs" / "torch"


def add_device_flag(parser):
    """``--device cuda|cpu``; pass its value to ``utils.resolve_device``,
    which raises for ``cuda`` without a card."""
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where to run: the card (default; raises without one) or, "
             "at small sizes, the CPU")


def device_name(device):
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def call_times_ms(fn, device, iters, warmup=1):
    """Per-call times (ms) of ``iters`` back-to-back calls of ``fn`` after
    ``warmup`` calls (see the module docstring)."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(iters + 1)]
        events[0].record()
        for end in events[1:]:
            fn()
            end.record()
        torch.cuda.synchronize(device)
        return [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def write_json(path, obj):
    """Write ``obj`` as JSON through a temporary file renamed into place, so
    an interrupted run never leaves a truncated artifact."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(obj, indent=1))
    tmp.replace(path)
