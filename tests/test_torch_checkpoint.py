"""Checkpoints of the port (``repro_torch.checkpoint.ckpt``) and runs that
resume from them (``Runner.save``, ``api.load_checkpoint``), mirroring
``tests/test_data_checkpoint.py::TestCheckpoint`` and the reference's
``tests/test_api.py::TestCheckpointRoundTrip``; and a dense checkpoint
that the reference wrote, read into the port through ``convert``."""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.core.draws import GeneratorDraws
from tests import test_torch_dense as tdense

GOLDEN = pathlib.Path(__file__).parent / "golden_specs"
TINY = {"n_features": 8, "n_classes": 3, "n_per_node": 8, "n_batches": 2}


def tiny_dict(oracle="saga"):
    return {"name": "ckpt-tiny", "n_nodes": 4, "steps": 4, "seed": 0,
            "algorithm": {"name": "prox_lead", "eta": 0.05, "gamma": 0.5},
            "compressor": {"name": "qinf", "params": {"bits": 2, "block": 3}},
            "prox": {"name": "l1", "params": {"lam": 1e-3}},
            "oracle": {"name": oracle, "problem": "logreg2d",
                       "problem_params": dict(TINY)}}


def trainer_spec(backend="dense"):
    return tapi.ExperimentSpec(
        name="ckpt-trainer", n_nodes=2, steps=2, seed=0,
        algorithm=tapi.AlgorithmSpec("prox_lead", eta=tapi.constant(0.2)),
        compressor=tapi.CompressorSpec("qinf", {"bits": 2}),
        model=tapi.ModelSpec(arch="qwen3-1.7b", n_layers=1, d_model=64,
                             local_batch=2, seq_len=16),
        execution=tapi.ExecutionSpec(engine="sharded", backend=backend))


def leaves(state):
    return [leaf for _, leaf in ckpt.items(state)]


def assert_same(a, b):
    la, lb = leaves(a), leaves(b)
    assert [k for k, _ in ckpt.items(a)] == [k for k, _ in ckpt.items(b)]
    for x, y in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


# --- save_state / load_state ----------------------------------------------------

def test_roundtrip_of_a_tree(tmp_path):
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "b": {"c": 7, "d": torch.ones(4, dtype=torch.float64),
                   "e": None, "f": (torch.zeros(2, dtype=torch.bfloat16)
                                    + 1.5, torch.tensor([3], dtype=torch.int8))}}
    ckpt.save_state(tmp_path, state, step=5, extra={"note": "x"})
    out = ckpt.load_state(tmp_path, state, step=5)
    assert_same(state, out)
    m = ckpt.load_manifest(tmp_path, 5)
    assert m["extra"] == {"note": "x"} and m["step"] == 5
    assert m["keys"] == ["a", "b/c", "b/d", "b/e", "b/f/0", "b/f/1"]
    assert m["dtypes"] == ["float32", "int64", "float64", "int32",
                           "bfloat16", "int8"]
    assert ckpt.latest_step(tmp_path) == 5
    ckpt.save_state(tmp_path, state, step=12)
    assert ckpt.latest_step(tmp_path) == 12
    assert ckpt.latest_step(tmp_path / "none") is None


def test_structure_mismatch_raises(tmp_path):
    ckpt.save_state(tmp_path, {"a": torch.ones(2)}, step=0)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.load_state(tmp_path, {"zzz": torch.ones(2)}, step=0)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_state(tmp_path, {"a": torch.ones(3)}, step=0)
    with pytest.raises(ValueError, match="dtype"):
        ckpt.load_state(tmp_path, {"a": torch.ones(2, dtype=torch.float64)},
                        step=0)
    with pytest.raises(ValueError, match="None"):
        ckpt.load_state(tmp_path, {"a": None}, step=0)


def test_dense_state_keys_are_the_references(tmp_path):
    """A port dense state and a reference dense state of one run write the
    same keys (None as the reference's 0-d int32 placeholder)."""
    for oracle in ("saga", "full"):
        d = tiny_dict(oracle)
        trunner = tapi.build(tapi.ExperimentSpec.from_dict(d), device="cpu",
                             dtype=torch.float64)
        tstate, _ = trunner.run(num_steps=2)
        trunner.save(tmp_path / f"t-{oracle}", tstate, step=2)
        jrunner = japi.build(japi.ExperimentSpec.from_dict(d))
        jstate, _ = jrunner.run(num_steps=2)
        jrunner.save(tmp_path / f"j-{oracle}", jstate, step=2)
        tm = ckpt.load_manifest(tmp_path / f"t-{oracle}", 2)
        jm = ckpt.load_manifest(tmp_path / f"j-{oracle}", 2)
        assert tm["keys"] == jm["keys"] and tm["shapes"] == jm["shapes"]
        assert tm["extra"]["spec"] == jm["extra"]["spec"]


def test_trainer_state_roundtrip(tmp_path):
    runner = tapi.build(trainer_spec(), device="cpu")
    state = runner.init_state()
    ckpt.save_state(tmp_path, state, step=1)
    out = ckpt.load_state(tmp_path, state, step=1)
    assert_same(state, out)


# --- Runner.save and load_checkpoint ------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "neighbor"])
def test_trainer_checkpoint_keeps_the_spec_and_continues(tmp_path, backend):
    spec = trainer_spec(backend)
    runner = tapi.build(spec, device="cpu")
    data = runner.default_data()
    state = runner.init_state()
    for t in range(2):
        state, _ = runner.step(state, data.batch_at(t),
                               GeneratorDraws(t, "cpu"))
    runner.save(tmp_path, state, step=2)
    runner2, state2, step = tapi.load_checkpoint(tmp_path, device="cpu")
    assert step == 2 and runner2.spec == spec
    assert_same(state, state2)
    a, _ = runner.step(state, data.batch_at(2), GeneratorDraws(9, "cpu"))
    b, _ = runner2.step(state2, runner2.default_data().batch_at(2),
                        GeneratorDraws(9, "cpu"))
    assert_same(a, b)


@pytest.mark.parametrize("oracle", ["full", "sgd", "saga"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_checkpoint_continues_bit_for_bit(tmp_path, oracle, dtype):
    spec = tapi.ExperimentSpec.from_dict(tiny_dict(oracle))
    runner = tapi.build(spec, device="cpu", dtype=dtype)
    state, _ = runner.run(num_steps=2)
    runner.save(tmp_path, state, step=2)
    runner2, state2, step = tapi.load_checkpoint(tmp_path, device="cpu")
    assert step == 2 and runner2.spec == spec
    assert runner2.X0.dtype == dtype
    assert_same(state, state2)
    assert_same(runner.step(state, GeneratorDraws(7, "cpu")),
                runner2.step(state2, GeneratorDraws(7, "cpu")))


def test_netsim_checkpoint_restores_the_state(tmp_path):
    spec = tapi.ExperimentSpec.load(GOLDEN
                                    / "netsim_matching_linkdrop_noise.json")
    runner = tapi.build(spec, device="cpu", dtype=torch.float64)
    state, _ = runner.run(num_steps=3)
    runner.save(tmp_path, state, step=3)
    runner2, state2, _ = tapi.load_checkpoint(tmp_path, device="cpu")
    assert runner2.spec == spec
    assert_same(state, state2)


def test_missing_spec_raises(tmp_path):
    ckpt.save_state(tmp_path, {"a": torch.ones(2)}, step=0)
    with pytest.raises(ValueError, match="embeds no ExperimentSpec"):
        tapi.load_checkpoint(tmp_path, step=0, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tapi.load_checkpoint(tmp_path / "empty", device="cpu")


def test_load_checkpoint_without_device_needs_cuda(tmp_path, monkeypatch):
    spec = tapi.ExperimentSpec.from_dict(tiny_dict())
    runner = tapi.build(spec, device="cpu")
    state, _ = runner.run(num_steps=1)
    runner.save(tmp_path, state, step=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.load_checkpoint(tmp_path)


# --- a checkpoint the reference wrote ---------------------------------------------

@pytest.mark.parametrize("oracle", ["full", "saga"])
def test_reference_dense_checkpoint_loads_through_convert(tmp_path, oracle):
    """The reference's ``Runner.save`` of a dense run, read into the port
    (``convert.state_from_checkpoint``): equal to ``convert``'s mapping of
    the reference's state, and it continues there one step within C2's
    bar with the reference's draws replayed."""
    jspec = japi.ExperimentSpec.from_dict(tiny_dict(oracle))
    jrunner, jstates, draws = tdense.reference_run(jspec, 3)
    jrunner.save(tmp_path, jstates[2], step=2)
    got = convert.state_from_checkpoint(tmp_path, 2, device="cpu",
                                        dtype=torch.float64)
    want = convert.state_from_arrays(tdense.as_arrays(jstates[2]),
                                     device="cpu", dtype=torch.float64)
    assert_same(got, want)
    assert json.loads(tapi.ExperimentSpec.from_dict(ckpt.load_manifest(
        tmp_path, 2)["extra"]["spec"]).to_json()) == json.loads(
            jspec.to_json())
    trunner = tapi.build(tapi.ExperimentSpec.from_dict(tiny_dict(oracle)),
                         device="cpu", dtype=torch.float64)
    from repro_torch.core.draws import ReplayDraws
    nxt = trunner.step(got, ReplayDraws(draws[3], "cpu"))
    tdense.assert_states_close(nxt, jstates[3], 1e-10, 1e-12)
    assert jax.config.x64_enabled
    assert np.asarray(jstates[2].X).dtype == np.float64
