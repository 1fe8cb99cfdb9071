"""The port's launch CLIs (``repro_torch.launch.{sweep,simulate,train}``)
and its spec gate (``python -m repro_torch.api --check``), on the CPU
(``--device cpu``) at tiny sizes; without that flag they run on the card
and raise without one."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api as tapi
from repro_torch.launch import simulate as lsim
from repro_torch.launch import sweep as lsweep
from repro_torch.launch import train as ltrain
from repro_torch.netsim.metrics import consensus_error

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden_specs"
SWEEP_GOLDEN = GOLDEN / "sweep_lead_seed_x_bits.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- sweep ------------------------------------------------------------------------

def test_sweep_cli_runs_the_golden_sweep(tmp_path, capsys):
    """The golden sweep (12 points, 60 steps) on the CPU: exit 0, and each
    point's final consensus is that of the sweep engine's own run (f64,
    map mode), which is each point's serial run."""
    out = tmp_path / "sweep.json"
    assert lsweep.main(["--spec", str(SWEEP_GOLDEN), "--out", str(out),
                        "--device", "cpu"]) == 0
    rows = json.loads(out.read_text())["points"]
    spec = tapi.SweepSpec.load(SWEEP_GOLDEN)
    assert [r["name"] for r in rows] == [p.name for p in spec.points()]
    runner = tapi.build(spec, device="cpu", dtype=torch.float64)
    _, res = runner.run(metric_fn=lambda st: consensus_error(st.X))
    assert [r["final_consensus"] for r in rows] == list(
        res.metrics["metric"][:, -1])
    assert "12 points" in capsys.readouterr().out


def test_sweep_cli_from_flags_and_axes(tmp_path, capsys):
    args = ["--axis", "seed=0:2", "--axis", "compressor.bits=2,4",
            "--nodes", "4", "--steps", "3", "--compressor", "qinf:2",
            "--device", "cpu"]
    assert lsweep.main(args + ["--print-spec"]) == 0
    spec = tapi.SweepSpec.from_json(capsys.readouterr().out)
    assert spec.n_points == 4 and spec.base.steps == 3
    out = tmp_path / "v.json"
    assert lsweep.main(args + ["--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["report"]["extra"]["points"] == len(got["points"]) == 4
    assert all(np.isfinite(r["final_consensus"]) for r in got["points"])


def test_sweep_cli_netsim_grid(tmp_path):
    out = tmp_path / "n.json"
    assert lsweep.main(["--engine", "netsim", "--schedule", "alternating",
                        "--fault", "linkdrop:0.2", "--nodes", "4",
                        "--steps", "3", "--axis", "fault_seed=0,1",
                        "--out", str(out), "--device", "cpu"]) == 0
    rows = json.loads(out.read_text())["points"]
    assert len(rows) == 2 and all(r["total_mbits_on_wire"] > 0 for r in rows)


# --- simulate -------------------------------------------------------------------

def test_simulate_cli_runs_a_scenario(tmp_path, capsys):
    out = tmp_path / "traj.json"
    assert lsim.main(["--schedule", "random_matching", "--fault",
                      "linkdrop:0.1", "--algo", "prox-lead", "--compressor",
                      "qinf:2", "--steps", "30", "--device", "cpu",
                      "--json-out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "schedule=random_matching" in text and "saving vs f32" in text
    traj = json.loads(out.read_text())
    assert traj["total_bits_on_wire"] > 0
    gap = traj["trajectory"]["objective"]
    assert gap[-1] < gap[0]


def test_simulate_cli_replays_a_golden_spec_and_refuses_others(capsys):
    assert lsim.main(["--spec", str(GOLDEN / "netsim_markov_straggler.json"),
                      "--print-spec", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["name"] == \
        "netsim-markov-straggler"
    assert lsim.main(["--spec",
                      str(GOLDEN / "netsim_matching_linkdrop_noise.json"),
                      "--device", "cpu"]) == 0
    with pytest.raises(SystemExit, match="netsim engine"):
        lsim.main(["--spec", str(GOLDEN / "prox_lead_dense_ring_qinf2.json"),
                   "--device", "cpu"])


# --- train --------------------------------------------------------------------------

def test_train_cli_runs_saves_and_resumes(tmp_path, capsys):
    ck, rep = tmp_path / "ck", tmp_path / "report.json"
    assert ltrain.main(["--nodes", "2", "--steps", "2", "--layers", "1",
                        "--d-model", "64", "--seq-len", "16",
                        "--local-batch", "2", "--log-every", "1",
                        "--ckpt", str(ck), "--report", str(rep),
                        "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "step     0" in text and "checkpoint saved" in text
    report = json.loads(rep.read_text())
    assert report["engine"] == "sharded" and report["steps"] == 2
    assert report["wire"]["bits_per_step"] > 0
    runner, state, step = tapi.load_checkpoint(ck, device="cpu")
    assert step == 2 and state.step == 2
    assert runner.spec.model.n_layers == 1


def test_clis_without_a_card_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lsweep.main(["--spec", str(SWEEP_GOLDEN)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lsim.main(["--steps", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ltrain.main(["--nodes", "2", "--steps", "1", "--layers", "1",
                     "--d-model", "64"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.check_spec_file(GOLDEN / "prox_lead_dense_ring_qinf2.json")


# --- the spec gate ------------------------------------------------------------------

def test_spec_gate_round_trips_nine_and_builds_eight(capsys):
    assert tapi._main(["--check", str(GOLDEN), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[spec-check] OK") == 9
    assert "[spec-check] OK trainer_neighbor_alternating_4x2.json" in out
    assert "9 golden specs round-trip and build" in out
    assert "sweep of 12 points" in out


def test_spec_gate_diff(capsys):
    assert tapi._main(["--diff", str(GOLDEN / "prox_lead_dense_ring_qinf2"
                                     ".json"),
                       str(GOLDEN / "lead_diminishing_harmonic.json")]) == 0
    assert "algorithm.name: 'prox_lead' -> 'lead'" in capsys.readouterr().out


def test_spec_gate_as_a_module():
    """``python -m repro_torch.api --check``: the api module runs as
    __main__, and the sweep engine still takes its SweepSpec."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.api", "--check",
                        str(SWEEP_GOLDEN), "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "1 golden specs round-trip and build" in r.stdout
