"""A whole run of each cell on the CPU at a reduced size with the timed
path broken underneath (``faults.py``): ``correct`` comes out false for
every fault the cell can have."""
import pytest

from portbench import faults
from portbench.test_portbench_reference import CELLS, cpu_verdict, tiny_cell, tiny_run

CASES = [(c, f) for c in CELLS for f in faults.FAULTS
         if not (f in faults.REPLICA_FAULTS and tiny_cell(c)["traffic"]["replicas"] < 2)]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    with faults.plant(fault):
        out = tiny_run(cell)
    assert not cpu_verdict(out["numbers"], cell), out["numbers"]


def test_faults_restore_the_program():
    from repro_torch.serverless.backends import local
    from repro_torch.serverless.runtime import engine, worker

    before = (worker.StageWorker.__init__, worker.StageWorker.apply_update,
              engine._split_batch, local.local_scatter_reduce, worker.softmax_cross_entropy)
    for f in faults.FAULTS:
        with faults.plant(f):
            pass
    assert before == (worker.StageWorker.__init__, worker.StageWorker.apply_update,
                      engine._split_batch, local.local_scatter_reduce,
                      worker.softmax_cross_entropy)
