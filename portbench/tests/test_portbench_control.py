"""The control on the card: the reference in TF32, put in the program's
place, fails the cell's limits that the program passes (at a few hundred
sentences; the readings at the cells' own sizes come from
``portbench/control.py``)."""

import pytest

from portbench import harness, jobs

CELLS = ("cgcn.train.tacred", "gcn.train.tacred", "cgcn.eval.tacred")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_the_control_fails_the_check(cell, seed, cuda_device):
    import torch

    c = harness.find_cell(cell)
    kind = c.traffic["job"]
    job = jobs.JOBS[kind](c, harness.seeds_of(seed), cuda_device,
                          sentences=400)
    job.setup(torch)
    job.free(torch)
    limits = c.config["limits"][kind]
    program = job.reference(torch)
    control = job.reference(torch, variant="tf32")
    assert all(program[k] <= lim for k, lim in limits.items()), program
    assert any(control[k] > lim for k, lim in limits.items()), control
