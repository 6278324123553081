"""The comparison's control: the reference in bfloat16, put in the
program's place, fails the cell's limits, while the program passes them,
on three seeds each, at a size the CPU runs (the card's readings at the
cells' own sizes are `benchmark/control.py`'s)."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import cells, correct, loop, program

from conftest import SMALL


@pytest.mark.parametrize("cell", ["go2_stand.realtime"])
def test_the_control_fails_and_the_program_passes(cell):
    found = cells.find_cell(cell)
    config = bench_run._merge(found.config, SMALL)
    limits = {k: v for k, v in config["check"]["limits"].items() if k != "start_gap"}
    prog = program.build(config, "cpu", "auto")
    ref = correct.Reference(config, "cpu")
    low = correct.Reference(config, "cpu", dtype=torch.bfloat16)
    pl = config["planner"]
    for seed in (3, 2**31 + 5, 977):
        noise = loop.Noise(seed, (pl["Ndiffuse"], pl["Nsample"], pl["Hnode"] + 1,
                                  prog.env.action_size), "cpu", torch.float32)
        s0, Y0 = program.reset(prog)
        w = loop.run(prog.step, s0, Y0, noise, 0, found.traffic, "cpu", n=2)
        st, Y = w.outs[0][:2]
        step = dict(inp=program.state_dict(st), Y_in=Y, noise=noise(1),
                    out=program.outputs(w.outs[1]))
        ok, _ = correct.verdict(correct.judge(ref, [step], 10**6), limits)
        assert ok, seed
        control = dict(step, out=correct.reference_step(low, step["inp"], Y, step["noise"]))
        ok, checks = correct.verdict(correct.judge(ref, [control], 10**6), limits)
        assert not ok, (seed, checks)
