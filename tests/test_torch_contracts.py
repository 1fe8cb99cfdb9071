"""The port's contract audit (``repro_torch.check``).

* Each pure audit against an injected violation, as
  ``tests/test_check.py::TestWireAudit`` does for the reference's: a
  non-u8 payload, one ``pp`` call too many, one byte off, an f64 op, a
  ``.item()`` inside a step, an upload inside a step, a host read missing
  from the expected table.
* Every model family's trainer step (reduced widths) holds the contracts.
* ``audit_spec`` on every golden spec on the CPU: every finding a PASS,
  each sharded spec audited at (8, 1) and at (4, 2) (the 4x2 golden on
  its own mesh): a neighbor spec's (4, 2) wire moves M = 2 shard payloads
  a node, its bytes a shard the reference's per-device count.
* The CLI: exit 0 with ``--device cpu`` on the golden specs, nonzero on a
  directory holding a spec whose wire breaks the contract.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import api as tapi
from repro_torch.check import contracts as C
from repro_torch.check.__main__ import main as check_main
from repro_torch.obs.record import Read, RecordingPP, StepRecorder

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden_specs"
STEMS = sorted(p.stem for p in GOLDEN.glob("*.json"))
U8 = torch.uint8


def _failed(findings, word):
    return [c for c, ok, _ in findings if ok is False and word in c]


# --- the pure audits -----------------------------------------------------------

class TestWireCalls:
    def test_clean_wire_passes(self):
        out = C.audit_wire_calls([(U8, 150), (U8, 50)], hops=1,
                                 per_edge_bits=1600)
        assert all(ok for _, ok, _ in out), out

    def test_non_u8_payload_fails(self):
        out = C.audit_wire_calls([(U8, 150), (U8, 50), (torch.float32, 100)],
                                 hops=1, per_edge_bits=1600)
        assert _failed(out, "u8"), out

    def test_one_call_too_many_fails(self):
        out = C.audit_wire_calls([(U8, 100), (U8, 50), (U8, 50)], hops=1,
                                 per_edge_bits=1600)
        assert _failed(out, "2 x hops"), out

    def test_one_byte_off_fails(self):
        out = C.audit_wire_calls([(U8, 150), (U8, 49)], hops=1,
                                 per_edge_bits=1600)
        assert _failed(out, "bytes"), out
        assert len(_failed(out, "")) == 1

    def test_bytes_are_integers_per_model_shard(self):
        ok = C.audit_wire_calls([(U8, 50), (U8, 50)], hops=1,
                                per_edge_bits=1600, model_shards=2)
        assert all(f[1] for f in ok)
        odd = C.audit_wire_calls([(U8, 50), (U8, 50)], hops=1,
                                 per_edge_bits=1604, model_shards=2)
        assert _failed(odd, "bytes")


def test_f64_op_flagged():
    with StepRecorder() as rec:
        torch.ones(3, dtype=torch.float32) * 2
    assert C.audit_no_f64(rec.f64)[0][1]
    with StepRecorder() as rec:
        torch.ones(3, dtype=torch.float32).double()
    out = C.audit_no_f64(rec.f64)
    assert out[0][1] is False and "f64" in out[0][2], out


def test_recorder_names_each_kind_of_host_read():
    x = torch.arange(6.0)
    with StepRecorder() as rec:
        x.sum().item()
        x.nonzero()
        x[x > 2]
        torch.tensor([1.0, 2.0])            # host data: an upload on a card
        x.to(torch.float64)                 # no device change: no transfer
    kinds = [r.kind for r in rec.reads]
    assert kinds == ["scalar", "shape", "shape", "upload"], rec.reads


def _dense_runner():
    return tapi.build(tapi.ExperimentSpec.load(
        GOLDEN / "prox_lead_dense_ring_qinf2.json"), device="cpu")


def test_item_inside_a_step_fails():
    runner = _dense_runner()
    assert C.audit_no_host_sync(C.runner_step_facts(runner).reads)[0][1]
    step = runner.step

    def step_with_item(state, draws):
        new = step(state, draws)
        float(new.X.abs().max())            # a host read inside the step
        return new

    runner.step = step_with_item
    out = C.audit_no_host_sync(C.runner_step_facts(runner).reads,
                               name="dense")
    assert out[0][1] is False and "scalar" in out[0][2], out


def _adam_runner():
    spec = tapi.ExperimentSpec.load(GOLDEN / "trainer_neighbor_bucketed_8x1.json")
    spec = dataclasses.replace(spec, execution=dataclasses.replace(
        spec.execution, params={"precondition": "adam"}))
    return tapi.build_trainer_runner(spec, device="cpu", pp=RecordingPP())


def test_expected_read_passes_and_fails_without_its_entry():
    """Adam's CPU-built bias-correction scalars are the one read of a
    trainer step beside the plain B1's level count (the CPU stand-in for
    the kernel); named in the table they pass, and without the entry they
    fail."""
    runner = _adam_runner()
    facts, state = C.trainer_step_facts(runner)
    assert state is not None
    adam = [r for r in facts.reads
            if r.where.endswith(" _adam_precondition")]
    assert [r.kind for r in adam] == ["upload", "scalar", "scalar"], adam
    assert {r.where.split(" ")[1] for r in facts.reads} == {
        "_adam_precondition", "qinf_quantize_blocks_ref"}, facts.reads
    assert C.audit_no_host_sync(facts.reads)[0][1]
    table = tuple(e for e in C.EXPECTED_READS
                  if e.function != "_adam_precondition")
    out = C.audit_no_host_sync(facts.reads, expected=table)
    assert out[0][1] is False and "_adam_precondition" in out[0][2]


def test_expected_read_matches_its_kind_and_place_only():
    e = C.EXPECTED_READS[-1]
    hit = Read("scalar", "aten._local_scalar_dense.default",
               f"{e.path}:306 {e.function}")
    assert e.matches(hit) and e.matches(hit._replace(kind="upload"))
    assert not e.matches(hit._replace(kind="shape"))
    assert not e.matches(hit._replace(where=f"{e.path}:306 other"))
    assert not e.matches(hit._replace(where=f"core/comm.py:1 {e.function}"))


def test_wire_of_a_recorded_step_breaks_on_an_extra_call():
    """The recording seam sees the bucketed step's 2 x hops u8 calls; one
    more call through the seam fails the count and the bytes."""
    runner = tapi.build_trainer_runner(
        tapi.ExperimentSpec.load(GOLDEN / "trainer_neighbor_bucketed_8x1.json"),
        device="cpu", pp=RecordingPP())
    state = runner.init_state()
    leaves = list(tapi.tree.leaves(state.plead.X))
    facts, _ = C.trainer_step_facts(runner, state=state)
    clean = C.audit_trainer(runner, "8x1", facts, leaves)
    assert all(ok for _, ok, _ in clean), clean
    facts.calls.append(facts.calls[0])
    bad = C.audit_trainer(runner, "8x1", facts, leaves)
    assert _failed(bad, "2 x hops") and _failed(bad, "bytes")


FAMILIES = ("mixtral-8x7b", "deepseek-moe-16b", "rwkv6-7b",
            "recurrentgemma-9b", "llama-3.2-vision-90b", "whisper-large-v3")


def _family_runner(arch):
    """``arch`` at the reference's ``.reduced()`` widths on the golden 8x1
    trainer's exponential graph (neighbor backend, bucketed wire)."""
    spec = tapi.ExperimentSpec.load(GOLDEN / "trainer_neighbor_bucketed_8x1.json")
    spec = dataclasses.replace(spec, model=tapi.ModelSpec(
        arch=arch, full=False, n_layers=2, d_model=64, local_batch=1,
        seq_len=16))
    return tapi.build_trainer_runner(spec, device="cpu", pp=RecordingPP())


def _audit(runner):
    state = runner.init_state()
    leaves = list(tapi.tree.leaves(state.plead.X))
    facts, _ = C.trainer_step_facts(runner, state=state)
    return C.audit_trainer(runner, runner.spec.model.arch, facts, leaves)


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_trainer_step_holds_the_contracts(arch):
    """The other families' steps move nothing from the host after the
    warm-up: whisper's encoder positions are built on the device once
    (``layers.sinusoidal_pos_on``), the MoE one-hot is a scatter
    (``F.one_hot`` range-checks on the host), the RG-LRU's embedding scale
    is made once."""
    findings = _audit(_family_runner(arch))
    assert all(ok for _, ok, _ in findings), findings
    assert sum("pp" in c for c, _, _ in findings) == 3


def test_a_per_step_upload_fails(monkeypatch):
    """Whisper's encoder positions built from numpy at every forward (the
    port's code before the table was cached): an upload inside the step,
    named at its line."""
    from repro_torch.models import layers as L
    monkeypatch.setattr(L, "sinusoidal_pos_on", lambda n, d, device, dtype:
                        L.sinusoidal_pos(n, d).to(device=device, dtype=dtype))
    findings = _audit(_family_runner("whisper-large-v3"))
    bad = [(c, d) for c, ok, d in findings if not ok]
    assert len(bad) == 1 and "upload" in bad[0][1] \
        and "models/layers.py" in bad[0][1] and "sinusoidal_pos" in bad[0][1]


# --- every golden spec -------------------------------------------------------

@pytest.mark.parametrize("stem", STEMS)
def test_audit_spec_on_every_golden_spec(stem):
    spec = C.load_spec(GOLDEN / f"{stem}.json")
    findings = C.audit_spec(spec, "cpu")
    assert findings
    assert all(ok is True for _, ok, _ in findings), findings
    d = json.loads((GOLDEN / f"{stem}.json").read_text())
    sharded = "base" not in d and d["execution"]["engine"] == "sharded"
    if not sharded:
        return
    audited = {c.split(":")[0] for c, ok, _ in findings}
    own = {(8, 1): "@8x1", (4, 2): "@4x2"}
    mesh = tuple(d["execution"]["mesh"] or ())
    names = {shape: spec.name if shape == mesh else spec.name + tag
             for shape, tag in own.items()}
    assert audited == set(names.values())
    if d["execution"]["backend"] == "neighbor":
        assert sum("pp" in c for c, _, _ in findings) == 6
        name = names[(4, 2)]
        detail = [det for c, _, det in findings if c == f"{name}: pp bytes "
                  f"== bucketed payload accounting"]
        assert len(detail) == 1 and "a model shard" in detail[0] \
            and "shards=2" in detail[0], detail


def test_cli_exits_0_on_the_golden_specs(capsys):
    assert check_main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[check] OK:" in out and "FAIL" not in out
    assert "WAIT" not in out
    # the dense and the bucketed 8x1 spec's (4, 2) variants: 2 + 5 checks
    assert out.count("@4x2: ") == 7


def test_cli_fails_on_a_tampered_wire(tmp_path):
    """A spec whose wire ships every leaf on its own (``per_leaf``: 2 x
    hops x leaves ``pp`` calls) breaks the contract: nonzero exit, from a
    fresh process as a user runs it."""
    d = json.loads((GOLDEN / "trainer_neighbor_bucketed_8x1.json").read_text())
    d["execution"]["wire_mode"] = "per_leaf"
    (tmp_path / "tampered.json").write_text(json.dumps(d))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.check", "--device", "cpu",
         "--specs", str(tmp_path), "--json"], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        timeout=300)
    assert r.returncode == 1, r.stderr
    found = json.loads(r.stdout)["contracts"]
    assert any(c.endswith("pp call count == 2 x hops") and ok is False
               for c, ok, _ in found), found
