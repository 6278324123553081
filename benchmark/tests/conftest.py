"""Shared by the benchmark's CPU rehearsals: the repository on sys.path and
a cell shrunk to a size the CPU runs in seconds (the program's plain
physics in place of the CUDA kernel)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Nsample 8, a 4-step horizon, one substep: every stage of a control step,
# at a size where the plain physics takes about a second a step
SMALL = {"planner": {"Nsample": 8, "Hsample": 4, "Hnode": 2}, "env": {"n_substeps": 1}}


@pytest.fixture
def small_run():
    """run(cell, seed, seconds=0.2, trace=False) -> the result of one CPU run
    of `cell` at the small size."""
    from benchmark import run as bench_run
    from benchmark.harness import cells

    def go(cell="go2_stand.realtime", seed=2**31 + 11, seconds=0.2, trace=False):
        found = cells.find_cell(cell)
        return bench_run.run_cell(found, seed, seconds, trace, device="cpu", overrides=SMALL,
                                  log=lambda *a, **k: None)

    return go
