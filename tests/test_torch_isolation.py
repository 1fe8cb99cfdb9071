"""The port stands alone: no JAX and no ``repro`` import anywhere in
``src/repro_torch`` or ``chip_smoke.py``; its entry point runs on the card
unless asked for the CPU; its specs read the reference's golden JSON."""
import ast
import json
import pathlib

import pytest
import torch

from repro_torch import api as tapi

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
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
                 "src/repro_torch/kernels/quantize.py", "chip_smoke.py"):
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


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_specs_read_or_name_their_slice(path):
    """Dense specs parse to the same JSON; the rest are refused with the
    slice that brings their engine."""
    d = json.loads(path.read_text())
    engine = "sweep" if "base" in d else d["execution"]["engine"]
    if engine != "dense":
        with pytest.raises(ValueError, match="slice"):
            tapi.ExperimentSpec.from_json(path.read_text())
        return
    spec = tapi.ExperimentSpec.from_json(path.read_text())
    assert json.loads(spec.to_json()) == d
    assert tapi.ExperimentSpec.from_json(spec.to_json()) == spec
