"""The benchmark of openibl_tpu_torch: run one cell of BENCHMARK.json.

  python3 vprbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell names a configuration (its file,
``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``); the
mix names its driver (``drivers/<driver>.py``), which makes the inputs from
the seed, sets the port up, measures the window and checks what the port
produced against the plain reference (``reference/``) under the limits of
``limits/<cell>.json``. With ``--trace 0`` the result holds the cell's
end-to-end metrics; with ``--trace 1`` the window runs under the profiler
and the result holds its per-layer metrics, each read by
``metrics/<name>.py`` (or, for ``<quantity>.<kind>`` with no file of its
own, by ``metrics/<quantity>.py``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (``busy_s`` and ``window_s`` when traced), ``breakdown`` when
traced, ``setup_steps`` (the seconds of each step of set-up) and
``checks``, each number compared with its limit; the same numbers are the
last lines of standard error.

The run refuses (exit code 3, no result) without as many CUDA devices as
the cell asks for, or where the port is not the checkout's own; it fails
(exit code 4, no result) if the JAX package, JAX or Flax was loaded.
Every build cache of the port lies inside the checkout: its nvcc
libraries under ``build/kernels`` (the port's own choice), Triton's and
PyTorch's extension caches under ``build/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "vprbench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["USE_FLAX"] = "0"
# run as a script, Python puts this folder first on the path, where its
# modules would shadow the standard library's (trace, inputs, ...)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that no run may load: JAX, Flax, the JAX package
# and the JAX package's own scripts
FORBIDDEN = {"jax", "jaxlib", "flax", "openibl_tpu", "bench",
             "__graft_entry__", "chip_smoke"}


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (before the first dot) is
    forbidden, compared whole: ``openibl_tpu_torch`` is not
    ``openibl_tpu``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FORBIDDEN)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_file_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench, name):
    """(workload entry, configuration, traffic mix, limits) of a cell."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "limits", f"{name}.json"))
    return cell, config, traffic, limits


def metrics_of(bench, cell, kind):
    """The cell's end-to-end (``kind`` "end_to_end") or per-layer
    (``"per_layer"``) metric entries."""
    reported = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def metric_reader(name):
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    or, where there is none, that of the quantity it splits by cell kind
    (``metrics/device_idle.py`` for ``device_idle.build``)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")
    return path


def kernel_map():
    """{kernel: {"names": its kernels' names in the profiler, "counter":
    "module:wrapper" whose ``launches`` counts its calls}}, one file a
    kernel under kernels/."""
    folder = os.path.join(HERE, "kernels")
    return {f[:-5]: load_json(os.path.join(folder, f))
            for f in sorted(os.listdir(folder)) if f.endswith(".json")}


def counter_readers(kernels):
    """{kernel: a function reading its wrapper's launch count}."""
    out = {}
    for k, spec in kernels.items():
        mod, attr = spec["counter"].split(":")
        fn = getattr(importlib.import_module(mod), attr)
        out[k] = lambda fn=fn: fn.launches
    return out


class Reading:
    """What a per-layer metric's reader gets: the cell's configuration and
    mix, what the driver recorded (``info``) and traced (``trace``), the
    kernels' launches over the window, the peaks and the kernel map."""

    def __init__(self, config, traffic, outcome, counts, peaks, kernels):
        self.config, self.traffic = config, traffic
        self.info = outcome.info
        self.trace = outcome.trace
        self.counts = counts
        self.peaks = peaks
        self.kernels = kernels

    def roofline(self, name):
        return load_file_module(os.path.join(HERE, "rooflines",
                                             f"{name}.py"),
                                f"vprbench_roofline_{name}")

    def roofline_share(self, name, batch):
        """The kernel of ``rooflines/<name>.py``: the bound of one call at
        ``batch`` over the device time of its kernels a call in the traced
        window, in % (None where it did not run)."""
        from vprbench.work import least_time

        roof = self.roofline(name)
        seconds, launches = self.trace.kernel_seconds(
            self.kernels[roof.KERNEL]["names"])
        calls = roof.calls(self.counts.get(roof.KERNEL, 0), self.config)
        if not launches or not calls:
            return None
        bound = least_time(roof.work(self.config, batch), self.peaks)
        return 100.0 * bound / (seconds / calls)


def card():
    import torch

    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        limit = "unknown"
    return name, limit


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic, limits = cell_spec(bench, args.workload)
    steps = {}

    def mark(step):
        steps[step] = time.perf_counter() - T_START - sum(steps.values())

    mark("arguments, BENCHMARK.json")
    import torch

    mark("import torch")
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"vprbench: the cell asks for {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import openibl_tpu_torch
    except ImportError as exc:
        print(f"vprbench: the port is not in this checkout: {exc}",
              file=sys.stderr)
        return 3
    if not os.path.abspath(openibl_tpu_torch.__file__).startswith(
            os.path.join(ROOT, "openibl_tpu_torch") + os.sep):
        print(f"vprbench: openibl_tpu_torch comes from "
              f"{openibl_tpu_torch.__file__}, not from {ROOT}",
              file=sys.stderr)
        return 3
    torch.cuda.init()
    torch.empty(0, device="cuda")
    mark("CUDA context")

    from vprbench.common import Context
    from vprbench.trace import Tracer
    from vprbench.work import peaks

    kernels = kernel_map()
    tracer = Tracer(bool(args.trace), counter_readers(kernels))
    mark("import the port and its kernels' modules")
    ctx = Context(config=config, traffic=traffic,
                  seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=torch.device("cuda", 0),
                  t_start=T_START, tracer=tracer, setup_steps=steps)
    driver = importlib.import_module(f"vprbench.drivers.{traffic['driver']}")
    outcome = driver.run(ctx)
    return report(bench, args, cell, config, traffic, limits, outcome,
                  tracer.counts, peaks(), kernels, ctx.setup_steps)


def judge(checks, limits):
    """{name: {"value", "limit"}} and whether every value is within."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = checks.get(name, math.inf)
        within = math.isfinite(value) and value <= limit
        ok = ok and within
        # JSON has no infinity: a number that could not be read is null
        out[name] = {"value": value if math.isfinite(value) else None,
                     "limit": limit}
    return out, ok


def report(bench, args, cell, config, traffic, limits, outcome, counts,
           pk, kernels, setup_steps):
    bad = forbidden_modules()
    if bad:
        print(f"vprbench: forbidden modules were loaded: {bad}",
              file=sys.stderr)
        return 4
    checks, correct = judge(outcome.checks, limits)
    correct = correct and outcome.failed == 0
    name, limit = card()
    device = {"platform": "gpu", "kind": name, "count": cell["chips"],
              "memory_peak_bytes": int(outcome.memory_peak_bytes),
              "power_limit": limit}
    metrics, extra = {}, {}
    if args.trace:
        reading = Reading(config, traffic, outcome, counts, pk, kernels)
        for m in metrics_of(bench, args.workload, "per_layer"):
            value = load_file_module(
                metric_reader(m["name"]),
                "vprbench_metric_" + m["name"].replace(".", "_")
            ).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = outcome.trace
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        extra["breakdown"] = {
            "device_ops": tr.top_ops(10),
            "idle_gaps": tr.idle_gaps(outcome.info.get("spans", []), 10)}
    else:
        for m in metrics_of(bench, args.workload, "end_to_end"):
            value = outcome.values.get(m["name"])
            if value is None or not math.isfinite(value):
                print(f"vprbench: {m['name']} = {value}", file=sys.stderr)
                correct = False
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device,
              **extra, "setup_steps": setup_steps, "checks": checks}
    for k, v in setup_steps.items():
        print(f"setup {k}: {v!r} s", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
