"""The control: the reference with TF32 products, put in the program's
place, against the float32 reference comes out not correct (the size a
test run holds: the CPU, narrow widths, under the limits read at that
size; the readings at the cells' own sizes on the card are
``readings.py``'s)."""
import pytest
import torch

import bench_small
from perfbench import check, harness, traffic


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("name", bench_small.CELLS)
def test_the_tf32_control_is_not_correct(name, seed):
    torch.set_num_threads(1)
    cell = bench_small.small_cell(name)
    dev = torch.device("cpu")
    X0 = traffic.make_weights(cell.leaves, seed, dev)
    bank = traffic.make_bank(cell.cell, cell.cfg, seed, dev)
    ref = harness.reference_readout(cell, seed, X0, bank, dev)
    tf32 = harness.reference_readout(cell, seed, X0, bank, dev,
                                     precision="tf32")
    correct, lines, _ = check.judge(check.gaps(tf32, ref),
                                    cell.cell["limits"])
    assert not correct, lines


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from perfbench.reference.common import round_tf32
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
