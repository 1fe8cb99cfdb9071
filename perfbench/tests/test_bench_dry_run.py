"""A run at a small width on the CPU goes through set-up, the window and
the reference's check and gives a result of the benchmark's shape; the
entry point refuses to run without a CUDA card."""
import json
import subprocess
import sys

import pytest

import bench_small
from perfbench import check, traffic

BENCH = traffic.benchmark()
E2E = [m["name"] for m in BENCH["end_to_end"]]


@pytest.mark.parametrize("name", bench_small.CELLS)
def test_a_small_run_gives_a_result_line_of_the_contracts_shape(name):
    result, lines = bench_small.run(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == set(E2E)
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] == "GiB"
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    json.dumps(result)
    # the numbers compared, each with its limit, are the last lines
    n = len(result["checks"])
    assert [ln.split()[0] for ln in lines[-n:]] == list(check.NUMBERS)
    assert all(" limit " in ln for ln in lines[-n:])


def test_a_traced_run_gives_its_breakdown():
    result, _ = bench_small.run(bench_small.CELLS[0], trace=True)
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert result["metrics"] == {}      # no device metric from the CPU


def test_the_entry_point_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        bench_small.CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=bench_small.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
