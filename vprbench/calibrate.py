"""The readings that a cell's limits are set from, on the card: for each
seed, the cell's set-up, a short window at the cell's own load and the
check, printing every compared number; for the control seeds also the
control's numbers (the reference in the next precision below, in the
port's place) and those of the faults the cell can have, planted where
the answer is produced or in the reference put in the port's place. The
benchmark's runs never run this.

  python3 -m vprbench.calibrate --workload <cell> --seeds 1,2,3
      [--control-seeds 1,2,3] [--seconds 3] [--out <file.jsonl>]

Each reading is one JSON line (``seed``, ``side``: "port", "control" or
the fault's name, the numbers) on standard output and, with ``--out``,
in that file.
"""

import argparse
import importlib
import json
import os
import time



def main(argv=None):
    from vprbench import run as bench_run
    from vprbench.common import Context, free
    from vprbench.trace import Tracer

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    bench = bench_run.load_json(
        os.path.join(bench_run.ROOT, "BENCHMARK.json"))
    _, config, traffic, limits = bench_run.cell_spec(bench, args.workload)
    driver = importlib.import_module(f"vprbench.drivers.{traffic['driver']}")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = Context(config=config, traffic=traffic,
                      seed=seed, seconds=args.seconds, trace=False,
                      device=torch.device("cuda", 0),
                      t_start=time.perf_counter(), tracer=Tracer(False))
        outcome = driver.run(ctx)
        lines = [{"seed": seed, "side": "port", **outcome.checks,
                  "failed": outcome.failed, **outcome.values}]
        if seed in controls:
            saved = outcome.info["saved"]
            lines.append({"seed": seed, "side": "control",
                          **driver.control(ctx, saved)})
            for fault, nums in driver.faults(ctx, saved).items():
                lines.append({"seed": seed, "side": fault, **nums})
        del outcome
        free(ctx.device)
        for line in lines:
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    print("limits", json.dumps(limits))


if __name__ == "__main__":
    main()
