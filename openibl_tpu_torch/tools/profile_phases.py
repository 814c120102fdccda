"""One training epoch's phase breakdown, with a device trace (port of
scripts/profile_phases.py).

  python -m openibl_tpu_torch.tools.profile_phases
      [--trace-dir logs/torch/traces] [--device cuda|cpu]

Runs one epoch of ``engine/pipeline.run_baseline_training`` on the
hermetic synthetic dataset (SARE-ind, NetVLAD K=8, PCA 16, tuples of one
anchor, one positive and two negatives) with a ``utils/profiling.
PhaseTimer``, and prints ONE JSON line with the wall clock per phase
(mining_extract / mining_refresh / train / eval; on the card each phase
ends in a synchronize, so it holds the device work it queued). The
reference has only per-iteration wall-clock meters
(ibl/trainers.py:28-61). On the card it runs at 480x640 in bf16, writes a
``torch.profiler`` trace of the host and the card (a Chrome trace, for
Perfetto) under ``--trace-dir`` ('' disables it) and reports the card's
memory (``device_memory_stats``); on the CPU at 32x48 in f32, untraced.
In the trace the port's own spans (``utils/profiling.span``) name its
stages on the host's timeline: ``train.step`` with ``train.h2d``,
``train.forward`` and ``train.backward``, and the mining extraction's
``extract.features`` with ``extract.h2d`` and ``extract.forward`` a batch.

A profiler session adds host cost to the launches made after it in the
same process, so run this tool in a process of its own when other timings
follow. ``--max-seconds`` ends the process with exit code 3 past its
deadline instead of letting a stalled run hang.
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time

from openibl_tpu_torch.config import DataConfig, TrainConfig
from openibl_tpu_torch.engine import pipeline
from openibl_tpu_torch.tools._common import (
    ARTIFACTS, add_device_flag, device_name)
from openibl_tpu_torch.utils import profiling, resolve_device


def config(tmp, height, width, on_card):
    """The JAX script's training config, rooted in ``tmp``."""
    return TrainConfig(
        data=DataConfig(dataset="synthetic", scale=None,
                        data_dir=os.path.join(tmp, "data"),
                        height=height, width=width,
                        test_batch_size=16 if on_card else 8),
        num_clusters=8, loss_type="sare_ind", tuple_size=1,
        neg_num=2, neg_pool=5, cache_size=4, epochs=1, eval_step=1,
        pca_dim=16, logs_dir=os.path.join(tmp, "logs"),
        init_dir=os.path.join(tmp, "logs"), print_freq=1000, seed=0,
        compute_dtype="bfloat16" if on_card else "float32",
    )


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trace-dir", default=str(ARTIFACTS / "traces"),
                   help="torch.profiler trace output (on the card only; "
                        "'' disables)")
    p.add_argument("--height", type=int, default=0,
                   help="0 = 480 on the card, 32 on the CPU")
    p.add_argument("--width", type=int, default=0,
                   help="0 = 640 on the card, 48 on the CPU")
    add_device_flag(p)
    p.add_argument("--max-seconds", type=int, default=1100,
                   help="hard cap: exit(3) instead of hanging")
    return p.parse_args(argv)


def _deadline(seconds):
    def expire():
        print("profile_phases exceeded --max-seconds: aborting",
              file=sys.stderr, flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    return timer


def main(argv=None):
    """Run the epoch; print and return the breakdown."""
    args = parse(argv)
    device = resolve_device(args.device)
    deadline = _deadline(args.max_seconds) if args.max_seconds > 0 else None
    on_card = device.type == "cuda"
    h = args.height or (480 if on_card else 32)
    w = args.width or (640 if on_card else 48)
    trace_dir = args.trace_dir if on_card and args.trace_dir else None

    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = config(tmp, h, w, on_card)
            timer = profiling.PhaseTimer(device)
            t0 = time.perf_counter()
            if trace_dir:
                with profiling.trace(trace_dir):
                    pipeline.run_baseline_training(
                        cfg, device=device, verbose=False, timer=timer)
            else:
                pipeline.run_baseline_training(cfg, device=device,
                                               verbose=False, timer=timer)
            wall = time.perf_counter() - t0
    finally:
        if deadline is not None:
            deadline.cancel()

    out = {
        "metric": "phase_breakdown",
        "backend": device_name(device),
        "image_hw": [h, w],
        "wall_seconds": round(wall, 3),
        "phases": {
            name: {"seconds": round(timer.totals[name], 3),
                   "count": timer.counts[name]}
            for name in sorted(timer.totals)
        },
        "hbm": profiling.device_memory_stats() if on_card else None,
        "trace_dir": trace_dir,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
