"""Each cell's traffic end to end at a tiny size on the CPU: set-up, the
window, the check against the reference, and the result's line; and, on
the card, one short run of each cell as the driver makes it."""

import json
import math
import subprocess
import sys

import pytest

from conftest import ROOT, cells, limits, tiny_context


@pytest.mark.parametrize("cell", cells())
def test_cell_runs_and_is_correct_at_tiny_size(cell):
    from vprbench import run as bench_run

    driver, ctx = tiny_context(cell)
    outcome = driver.run(ctx)
    assert outcome.attempted > 0 and outcome.failed == 0
    for name, value in outcome.values.items():
        assert math.isfinite(value) and value > 0, name
    checks, correct = bench_run.judge(outcome.checks, limits(cell))
    assert correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "vprbench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
