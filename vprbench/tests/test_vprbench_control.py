"""The control (the reference put in the port's place, in the next
precision below the configuration's: TF32 for the f32 cells, an int4
backbone for the int8 one) comes out as not correct under each cell's
limits, at the tiny size on the CPU; the port at the same size comes out
correct (test_vprbench_cells.py)."""

import pytest

from conftest import cells, limits, tiny_context


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(cell):
    from vprbench import run as bench_run

    driver, ctx = tiny_context(cell)
    outcome = driver.run(ctx)
    numbers = driver.control(ctx, outcome.info["saved"])
    checks, correct = bench_run.judge(numbers, limits(cell))
    assert not correct, checks
