"""Run the bench suite on the card and keep its results in one artifact (port
of scripts/bench_all.py).

  python -m openibl_tpu_torch.tools.bench_all --round 1
      [--only extract_fused,extract_nofused] [--force] [--out PATH]

Runs each entry of ``SUITE`` (scripts/bench_all.py's nine) as ``python
bench_torch.py <args>`` in a process of its own, on the card, and records
the JSON line it printed last, with its arguments, exit code and wall time
(and the end of its standard error when it failed), in
``logs/torch/bench_r{NN}.json`` (``--out`` elsewhere). The file is written
atomically after each entry. Entries already captured there with exit code
0 are skipped (resume) unless ``--force``; ``--only`` runs a subset.
``fused_speedup`` (extract_fused over extract_nofused: K1 against the plain
head) and ``int8_speedup`` (extract_int8 over extract_fused: K3's backbone
against bf16) are computed from the entries present. Prints the whole
artifact; ``main(argv)`` returns it.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

from openibl_tpu_torch.tools._common import ARTIFACTS, ROOT, write_json

# the command each entry runs, its arguments appended
BENCH = [sys.executable, str(ROOT / "bench_torch.py")]

SUITE = [
    # batch 128 pinned: a sweep is bench_torch.py's default, not the suite's
    # explicit --int8: the card's default runs both modes, which would
    # repeat extract_fused's bf16 pass here
    ("extract_int8", ["--metric", "extract", "--batch-size", "128",
                      "--int8"]),
    ("extract_fused", ["--metric", "extract", "--no-int8",
                       "--batch-size", "128"]),
    ("extract_nofused", ["--metric", "extract", "--no-int8", "--no-fused",
                         "--batch-size", "128"]),
    ("query", ["--metric", "query", "--iters", "30"]),
    ("query_device", ["--metric", "query", "--device-time"]),
    ("query_ivf32", ["--metric", "query", "--iters", "30",
                     "--ivf-nprobe", "32"]),
    ("query_ivf32_device", ["--metric", "query", "--device-time",
                            "--ivf-nprobe", "32"]),
    ("train", ["--metric", "train"]),
    ("train_sfrs", ["--metric", "sfrs"]),
]


def run_one(extra, timeout=1200):
    """One entry: ``BENCH + extra`` in the repository's root."""
    t0 = time.time()
    proc = subprocess.run(BENCH + extra, capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)
    line = None
    for ln in proc.stdout.splitlines():
        if ln.strip().startswith("{"):
            try:
                line = json.loads(ln)
            except json.JSONDecodeError:
                continue
    return {"args": extra, "rc": proc.returncode,
            "wall_s": round(time.time() - t0, 1), "result": line,
            "stderr_tail": proc.stderr[-400:] if proc.returncode else ""}


def speedups(out):
    """Set ``fused_speedup`` and ``int8_speedup`` where both entries have a
    result."""
    def value(name):
        return (out["entries"].get(name, {}).get("result") or {}).get(
            "value")

    fused, plain, int8 = (value("extract_fused"), value("extract_nofused"),
                          value("extract_int8"))
    if fused and plain:
        out["fused_speedup"] = round(fused / plain, 3)
    if int8 and fused:
        out["int8_speedup"] = round(int8 / fused, 3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--round", type=int, required=True)
    ap.add_argument("--only", type=str, default="",
                    help="comma-separated subset of suite names")
    ap.add_argument("--force", action="store_true",
                    help="re-run entries already captured with rc=0 "
                         "(default: resume, skip them)")
    ap.add_argument("--out", default=None,
                    help="the artifact (default logs/torch/bench_r{NN}.json)")
    args = ap.parse_args(argv)

    names = [name for name, _ in SUITE]
    only = set(filter(None, args.only.split(",")))
    if only - set(names):
        ap.error(f"unknown suite entries: {sorted(only - set(names))}")
    path = pathlib.Path(args.out or
                        ARTIFACTS / f"bench_r{args.round:02d}.json")
    out = {"round": args.round, "entries": {}}
    if path.exists():  # incremental --only reruns
        out = json.loads(path.read_text())
    out["ts"] = time.strftime("%Y-%m-%d %H:%M:%S")

    for name, extra in SUITE:
        if only and name not in only:
            continue
        prev = out["entries"].get(name)
        if (not args.force and prev and prev.get("rc") == 0
                and prev.get("result")):
            print(f"[bench_all] {name}: already captured (resume); "
                  f"--force to re-run", file=sys.stderr)
            continue
        print(f"[bench_all] {name}: bench_torch.py {' '.join(extra)}",
              file=sys.stderr, flush=True)
        out["entries"][name] = run_one(extra)
        print(f"[bench_all]   -> {out['entries'][name]['result']}",
              file=sys.stderr, flush=True)
        speedups(out)
        write_json(path, out)
    speedups(out)
    write_json(path, out)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
