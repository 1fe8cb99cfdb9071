"""The port stands alone: no JAX and no ``repro`` import anywhere in
``src/repro_torch``, ``chip_smoke.py`` or ``launch_cost.py``; its entry
point runs on the card unless asked for the CPU, for both of its engines;
its specs read the reference's golden JSON."""
import ast
import dataclasses
import json
import pathlib

import pytest
import torch

from repro_torch import api as tapi

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "launch_cost.py"]
GOLDEN = sorted((ROOT / "tests" / "golden_specs").glob("*.json"))


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, "." * node.level + (node.module or "")
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("src/repro_torch/api.py", "src/repro_torch/convert.py",
                 "src/repro_torch/kernels/quantize.py",
                 "src/repro_torch/netsim/engine.py",
                 "src/repro_torch/netsim/faults.py",
                 "src/repro_torch/netsim/schedule.py",
                 "src/repro_torch/sweep.py",
                 "src/repro_torch/checkpoint/ckpt.py",
                 "src/repro_torch/launch/sweep.py",
                 "src/repro_torch/launch/simulate.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/rwkv6.py",
                 "src/repro_torch/models/rglru.py",
                 "src/repro_torch/configs/shapes.py",
                 "src/repro_torch/obs/roofline.py",
                 "src/repro_torch/obs/roofline_gate.py",
                 "src/repro_torch/obs/record.py",
                 "src/repro_torch/check/__init__.py",
                 "src/repro_torch/check/contracts.py",
                 "src/repro_torch/check/__main__.py", "chip_smoke.py",
                 "launch_cost.py"):
        assert must in names


def _small_spec():
    return tapi.ExperimentSpec(
        name="tiny", n_nodes=4, steps=3,
        compressor=tapi.CompressorSpec("qinf", {"bits": 2, "block": 16}),
        prox=tapi.ProxSpec("l1", {"lam": 0.01}),
        oracle=tapi.OracleSpec(name="saga", problem="logreg",
                               problem_params={"n_features": 6,
                                               "n_classes": 3,
                                               "n_per_node": 6,
                                               "n_batches": 2}))


def test_build_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.build(_small_spec())


def test_build_on_cpu_runs():
    runner = tapi.build(_small_spec(), device="cpu")
    state, _ = runner.run()
    assert state.X.device.type == "cpu" and state.X.dtype == torch.float32
    assert state.k == 4 and bool(torch.isfinite(state.X).all())
    assert runner.last_report.steps == 3
    # 18 parameters -> 2 blocks of 16 (2-bit codes + an f32 scale each),
    # sent to 2 ring neighbours
    assert runner.bits_per_step() == 2 * 2 * (16 * 2 + 32)


def _neighbor_spec():
    return tapi.ExperimentSpec.load(
        ROOT / "tests" / "golden_specs" / "trainer_neighbor_bucketed_8x1.json")


def test_sharded_build_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.build(_neighbor_spec())


def test_sharded_build_on_cpu_runs():
    """The golden neighbor spec (exponential graph of 8, bucketed wire)
    runs 3 steps on the CPU; the plain versions stand in for B3/B4 and no
    kernel is launched."""
    from repro_torch.kernels import quantize as qk
    runner = tapi.build(_neighbor_spec(), device="cpu")
    qk.reset_launch_counts()
    state, logs = runner.run(
        num_steps=3, log_every=1,
        callback=lambda st, m, t: (float(m["loss"]), float(m["consensus"])))
    assert all(v == 0 for v in qk.launch_counts().values())
    assert state.step == 3 and state.plead.k == 4 and len(logs) == 3
    assert all(torch.isfinite(torch.tensor(v)).all() for v in logs)
    rep = runner.last_report
    assert rep.engine == "sharded" and rep.device == "cpu"
    assert rep.extra["meters"]["wire/collectives_per_step"] == 2 * 5
    assert rep.extra["meters"]["wire/exchanges"] == 3


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_specs_read_or_name_their_slice(path):
    """Dense, netsim and sharded specs parse to the same JSON; the sweep
    spec (``sweep_lead_seed_x_bits``) parses as a SweepSpec, round-trips to
    the same JSON and builds on the CPU; a model-sharded mesh
    (``trainer_neighbor_alternating_4x2``) parses and is refused at build,
    naming the multi-card slice."""
    d = json.loads(path.read_text())
    if "base" in d:
        spec = tapi.SweepSpec.from_json(path.read_text())
        assert json.loads(spec.to_json()) == d
        assert tapi.SweepSpec.from_json(spec.to_json()) == spec
        runner = tapi.build(spec, device="cpu")
        assert runner.n_points == spec.n_points == 12
        return
    spec = tapi.ExperimentSpec.from_json(path.read_text())
    assert json.loads(spec.to_json()) == d
    assert tapi.ExperimentSpec.from_json(spec.to_json()) == spec
    mesh = d["execution"]["mesh"]
    if mesh is not None and mesh[1] > 1:
        with pytest.raises(NotImplementedError, match="multi-card slice"):
            tapi.build(spec, device="cpu")


@pytest.mark.parametrize("knob", sorted(tapi.LATER_TRAINER_FIELDS))
def test_later_trainer_knobs_name_their_slice(knob):
    """A reference trainer knob that no ported path reads parses at its
    default and is refused, naming its slice, at any other value."""
    default, _ = tapi.LATER_TRAINER_FIELDS[knob]
    spec = _neighbor_spec()

    def with_knob(value):
        if knob == "allow_biased":
            return dataclasses.replace(spec, algorithm=dataclasses.replace(
                spec.algorithm, params={knob: value}))
        return dataclasses.replace(spec, execution=dataclasses.replace(
            spec.execution, params={knob: value}))

    tcfg = tapi.trainer_config_from_spec(with_knob(default))
    assert not hasattr(tcfg, knob)
    other = (not default if isinstance(default, bool)
             else type(default)(default + 1))
    with pytest.raises(NotImplementedError, match="slice"):
        tapi.trainer_config_from_spec(with_knob(other))


KNOB_CASES = {
    # knob: (value, the spec's topology, the other knobs of both runs)
    "schedule_rounds": (2, {"schedule": "random_matching"}, {}),
    "schedule_drop": (0.3, {"schedule": "markov_drop"}, {}),
    "drop_rate": (0.3, {}, {}),
    "fault_seed": (1, {}, {"drop_rate": 0.3}),
}


@pytest.mark.parametrize("knob", sorted(KNOB_CASES))
def test_netsim_trainer_knobs_reach_the_run(knob):
    """Each netsim knob of the trainer (through ``execution.params``)
    reaches TrainerConfig and changes the run: three steps of the dense
    backend at the knob's value and at its default differ (at 2 rounds the
    third step's random matching is round 1, at 32 it is round 3)."""
    value, topo, others = KNOB_CASES[knob]
    spec = tapi.ExperimentSpec.load(
        ROOT / "tests" / "golden_specs" / "trainer_dense_qinf2.json")
    spec = dataclasses.replace(
        spec, topology=dataclasses.replace(spec.topology, **topo))

    def run(v):
        s = dataclasses.replace(spec, execution=dataclasses.replace(
            spec.execution, params=dict(others, **{knob: v})))
        runner = tapi.build(s, device="cpu")
        assert getattr(runner.trainer.tcfg, knob) == v
        state, _ = runner.run(num_steps=3)
        return runner, torch.cat([x.flatten() for x in
                                  tapi.tree.leaves(state.plead.X)])

    default = getattr(tapi.dec.TrainerConfig(n_nodes=4), knob)
    assert value != default
    runner, x = run(value)
    _, x0 = run(default)
    assert not torch.equal(x, x0)
    if knob == "schedule_rounds":
        assert runner.trainer.mixer.schedule.T_cycle == value
