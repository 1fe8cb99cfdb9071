"""The frozen FLOP and byte arithmetic, pinned to the figures the
repository's records hold for the qwen3-1.7b slice."""
import math

import pytest

import bench_small  # noqa: F401  (puts the repository on the path)
from perfbench import harness, traffic, yardstick

BENCH = traffic.benchmark()


def _yard(name):
    cell = harness.open_cell(name, BENCH)
    return cell, harness.yard(cell)


def test_qwen3_six_n_d_a_step():
    cell, y = _yard("qwen3-1.7b.ring8")
    assert sum(math.prod(s["shape"])
               for _, s in cell.leaves) == 179_317_248
    assert y["flops"] == 6 * 179_317_248 * 8_192 == 8_813_801_373_696


def test_b3_and_b4_bounds_on_the_ring():
    cell, y = _yard("qwen3-1.7b.ring8")
    groups = yardstick.wire_groups([s["shape"] for _, s in cell.leaves], 2,
                                   256)
    assert [(g["block"], g["rows"]) for g in groups] == [(128, 4),
                                                         (256, 700_456)]
    big = [g for g in groups if g["block"] == 256]
    hbm = yardstick.PEAKS["hbm_bytes_per_s"]
    assert yardstick.b3_bytes(big, 8) / hbm * 1e3 == pytest.approx(
        3.6466, abs=5e-5)
    assert yardstick.b4_bytes(big, 8, 3, 1) / hbm * 1e3 == pytest.approx(
        4.0882, abs=5e-5)


def test_b4_bound_under_the_alternating_schedule():
    cell, y = _yard("qwen3-1.7b.alternating8")
    groups = yardstick.wire_groups([s["shape"] for _, s in cell.leaves], 2,
                                   256)
    big = [g for g in groups if g["block"] == 256]
    hbm = yardstick.PEAKS["hbm_bytes_per_s"]
    assert harness._union_hops(cell.cell) == 5
    assert yardstick.b4_bytes(big, 8, 6, 2) / hbm * 1e3 == pytest.approx(
        6.4634, abs=5e-5)
    assert y["b4_bytes"] == yardstick.b4_bytes(groups, 8, 6, 2)


def test_whisper_counts_the_encoder_at_its_frames():
    cell, y = _yard("whisper-large-v3.ring8")
    enc = sum(math.prod(s["shape"]) for p, s in cell.leaves
              if p.startswith("enc_"))
    rest = sum(math.prod(s["shape"]) for p, s in cell.leaves
               if not p.startswith("enc_"))
    assert y["flops"] == 6 * (enc * 8 * 2 * 1500 + rest * 8 * 2 * 448)


def test_a_roofline_share_is_bytes_over_bandwidth_over_time():
    assert yardstick.roofline_pct(3.35e12, 2.0) == pytest.approx(50.0)
