"""A run whose timed path is broken underneath comes out not correct:
once for each fault a training cell can have -- a step that returns its
state unchanged, half of each node's batch left out (the mean taken
over the rest), the exchange between the nodes left out -- and the l1
prox left out of the update.  (A token or an answer altered where it is
produced is a fault of serving cells.)"""
import pytest

import bench_small
from perfbench import check, readings

N = len(check.NUMBERS)


@pytest.mark.parametrize("fault", readings.FAULTS)
@pytest.mark.parametrize("name", bench_small.CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    result, lines = bench_small.run(name, faults=(fault,))
    assert result["correct"] is False, lines[-N:]
    assert any(ln.endswith("FAIL") for ln in lines[-N:])
