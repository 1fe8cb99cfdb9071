"""The traced window's reading: each device operation belongs to the
innermost ``bench/`` range around its launch, the busy share is the
union of operations in the window, and each per-layer reader turns a
trace into its number."""
import pytest

import bench_small  # noqa: F401  (puts the repository on the path)
from perfbench import harness, tracing, traffic

BENCH = traffic.benchmark()


def _ev(name, ts, dur, cat, corr=None, tid=1):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _trace():
    """Two steps of 1000 us: model ops launched inside bench/model, an
    update op inside bench/update, a wire op and a B3 and a B4 launch
    inside bench/wire nested in bench/update."""
    ev = [_ev("bench/window", 0, 2000, "user_annotation")]
    corr = 0
    for s in range(2):
        t = 1000 * s
        ev += [_ev("bench/step", t, 1000, "user_annotation"),
               _ev("bench/model", t, 400, "user_annotation"),
               _ev("bench/update", t + 400, 500, "user_annotation"),
               _ev("bench/wire", t + 500, 300, "user_annotation")]
        for name, launch, start, dur in (
                ("gemm", t + 10, t + 20, 300), ("elementwise", t + 450,
                                                t + 460, 30),
                ("qinf_quantize_pack_vec_kernel", t + 510, t + 520, 40),
                ("qinf_unpack_dequant_mix_vec_kernel", t + 600, t + 610, 60),
                ("uniform", t + 505, t + 506, 10)):
            corr += 1
            ev += [_ev("cudaLaunchKernel", launch, 2, "cuda_runtime", corr),
                   _ev(name, start, dur, "kernel", corr, tid=7)]
    return tracing.Trace(ev, steps=2)


def test_operations_belong_to_the_innermost_range():
    tr = _trace()
    assert tr.part_ms("model") == pytest.approx(0.300)
    assert tr.part_ms("update") == pytest.approx(0.030)
    assert tr.part_ms("wire") == pytest.approx(0.110)
    assert tr.window_s == pytest.approx(0.002)
    assert tr.busy_s == pytest.approx(2 * 440e-6)


def test_idle_gaps_are_named_by_the_host():
    gaps = _trace().idle_gaps()
    assert gaps[0][1] == pytest.approx(350e-6)    # 670 us to 1020 us
    assert len(gaps) <= 10 and all(g[1] > 0 for g in gaps)


def test_each_reader_gives_its_number():
    cell = harness.open_cell("qwen3-1.7b.ring8", BENCH)
    readers = harness.metric_modules(cell, BENCH)
    tr = _trace()
    notes = []
    y = {"b3_bytes": 1e6, "b4_bytes": 2e6, "flops": 1e9}
    ctx = harness.ReadContext(tr, {"qinf_quantize_pack_blocks": 2,
                                   "qinf_unpack_dequant_mix_blocks": 2}, y,
                              notes.append)
    got = {n: m.read(ctx) for n, m in readers.items()}
    assert got["model_ms"] == pytest.approx(0.300)
    assert got["update_ms"] == pytest.approx(0.030)
    assert got["wire_ms"] == pytest.approx(0.110)
    assert got["b3_roofline_pct"] == pytest.approx(
        100 * 2e6 / 3.35e12 / 80e-6)
    assert got["b4_roofline_pct"] == pytest.approx(
        100 * 4e6 / 3.35e12 / 120e-6)
    assert got["mfu_pct"] == pytest.approx(100 * 2e9 / 0.002 / 495e12)
    assert got["device_idle_pct"] == pytest.approx(100 * (1 - 880 / 2000))
    assert notes and "67 TFLOP/s" in notes[0]


def test_a_lost_launch_silences_the_roofline():
    cell = harness.open_cell("qwen3-1.7b.ring8", BENCH)
    readers = harness.metric_modules(cell, BENCH)
    ctx = harness.ReadContext(_trace(), {"qinf_quantize_pack_blocks": 3},
                              {"b3_bytes": 1.0}, print)
    assert readers["b3_roofline_pct"].read(ctx) is None
