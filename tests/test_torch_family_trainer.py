"""The decentralized trainer on the moe, ssm, hybrid, vlm and encdec
families against the JAX package, and their wire layout.

* One teacher-forced step of the reference's dense backend (golden
  ``trainer_dense_qinf2``: 4 nodes on a ring, 2-bit QInf, the model at
  ``.reduced(n_layers=2, d_model=64)``) and the port's, from the
  reference's initial state, with the reference's batch (the vlm's vision
  and the encdec's frames included) and its noise replayed: X, D, H and Hw
  within 1e-5 of each array's largest entry on all but 0.1 % of elements
  (as ``test_torch_trainer``: where a stochastic-rounding argument sits
  within f32 rounding of an integer the 2-bit code flips by one level).
  RWKV-6's gradients agree to ~1e-4 only (``test_torch_models``) and a
  leaf that starts at zero is -eta G after one step, so its step is held at
  ``SSM_TOL`` (measured: 1.0e-4 of the leaf's largest entry, X of
  ``blocks/ln1_b``).  A leaf that is zero up to rounding (whisper's key
  biases: their gradient is 0, since a key bias shifts every score of a
  query alike) is compared at the largest entry of its state's tree.
* The port's neighbor backend (bucketed wire, kernels B3/B4's plain path)
  against its dense backend, one step from one state with the same noise
  cut to the neighbor's block widths: every element within 1e-5 (only the
  mixing sum's order differs) of each array's largest entry -- for D, of
  gamma / (2 eta) times X's: D takes gamma / (2 eta) times a difference of
  two mixes of X-sized values, which cancels where a leaf's replicas are
  nearly equal (RG-LRU's ``lam``, initialised to ones).  The families
  bring quantization-block widths the dense family never had (4 and 32 at
  these sizes; 8, 20 and 64 at the published widths).
* ``bits_per_step`` equals the reference's hops x
  ``bucketed_payload_bits`` as an integer, at the reduced widths and at the
  published widths and depth (from shapes alone, nothing allocated), and
  each bucket group holds the leaves ``default_quant_block`` gives its
  width.
"""
import collections
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import bucket as jbucket
from repro_torch import api as tapi
from repro_torch import convert, tree
from repro_torch.core.draws import GeneratorDraws, RecordingDraws, ReplayDraws
from tests.test_torch_trainer import (BACKEND_TOL, STEP_MAX_OFF, STEP_TOL,
                                      _dense_draws, _jax_bits,
                                      _jax_state_arrays,
                                      _neighbor_noise_from_dense)

GOLDEN = pathlib.Path(__file__).parent / "golden_specs"
NEW_ARCHS = ("mixtral-8x7b", "deepseek-moe-16b", "rwkv6-7b",
             "recurrentgemma-9b", "llama-3.2-vision-90b", "whisper-large-v3")
SSM_TOL = 3e-4
#: leaves per quantization-block width of each family at its published
#: widths and depth (block 256), by ``default_quant_block``: the router's
#: E = 8, the MoE's 64 routed experts, RWKV's 64-wide heads, the vision
#: model's 20 cross layers (its gates) and head dim 128 (its q/k norms)
FULL_WIDTH_BLOCKS = {
    "mixtral-8x7b": {8: 1, 256: 12}, "deepseek-moe-16b": {64: 1, 256: 15},
    "rwkv6-7b": {64: 2, 256: 28}, "recurrentgemma-9b": {256: 27},
    "llama-3.2-vision-90b": {20: 2, 128: 2, 256: 21},
    "whisper-large-v3": {256: 44}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(arch, **execution):
    d = json.loads((GOLDEN / "trainer_dense_qinf2.json").read_text())
    d["name"] = f"trainer-{arch}"
    d["model"].update(arch=arch, n_layers=2)
    d["execution"].update(execution)
    return d


def _worst_off(got, want, tol, floors=None) -> float:
    """The largest per-leaf fraction of elements off by more than tol x
    the leaf's scale: its largest entry, or the tree's where the leaf is
    zero up to rounding, and at least ``floors[i]``."""
    got = [np.asarray(a, np.float64) for a in got]
    want = [np.asarray(b, np.float64) for b in want]
    top = max(float(np.abs(b).max()) for b in want)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        scale = float(np.abs(b).max())
        if scale <= 1e-6 * top:
            scale = top
        if floors is not None:
            scale = max(scale, floors[i])
        worst = max(worst, float((np.abs(a - b) > tol * scale).mean()))
    return worst


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_family_step_matches_reference_dense_backend(arch):
    jspec = japi.ExperimentSpec.from_dict(_spec(arch))
    jrun = japi.build(jspec)
    jtr = jrun.trainer
    trun = tapi.build(tapi.ExperimentSpec.from_json(jspec.to_json()),
                      device="cpu")
    st = jax.jit(jtr.init_state)(jax.random.key(0))
    batch = jax.jit(jrun.default_data().batch_at)(0)
    assert set(batch) >= {"tokens", "labels"} | (
        {"vision"} if arch.startswith("llama") else set()) | (
        {"frames"} if arch.startswith("whisper") else set())
    draws = ReplayDraws(_dense_draws(jtr, st.plead.X)(st.step), "cpu")
    tb = {n: torch.from_numpy(np.array(v)) for n, v in batch.items()}
    got, metrics = trun.step(convert.trainstate_from_arrays(
        _jax_state_arrays(st), device="cpu"), tb, draws)
    assert not draws.pending
    st, jm = jax.jit(jtr.train_step)(st, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    tol = SSM_TOL if trun.trainer.mcfg.family == "ssm" else STEP_TOL
    got, want = convert.trainstate_to_arrays(got), _jax_state_arrays(st)
    for name in ("X", "D", "comm.H", "comm.Hw"):
        assert _worst_off(tree.leaves(got[name]),
                          jax.tree_util.tree_leaves(want[name]),
                          tol) <= STEP_MAX_OFF, name


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_family_neighbor_backend_matches_dense_backend(arch):
    spec = tapi.ExperimentSpec.from_dict(_spec(arch))
    dense = tapi.build(spec, device="cpu")
    neighbor = tapi.build(dataclasses.replace(
        spec, execution=dataclasses.replace(spec.execution,
                                            backend="neighbor")),
        device="cpu")
    st = dense.init_state()
    arrays = convert.trainstate_to_arrays(st)
    batch = dense.default_data().batch_at(0)
    rec = RecordingDraws(GeneratorDraws(5, "cpu"))
    st, _ = dense.step(st, batch, rec)
    nd = ReplayDraws(_neighbor_noise_from_dense(
        rec.record, neighbor.trainer, st.plead.X), "cpu")
    got, _ = neighbor.step(convert.trainstate_from_arrays(arrays,
                                                          device="cpu"),
                           batch, nd)
    assert not nd.pending
    got, want = (convert.trainstate_to_arrays(s) for s in (got, st))
    tc = dense.trainer.tcfg
    d_floor = [tc.gamma / (2 * tc.eta) * float(np.abs(x).max())
               for x in tree.leaves(want["X"])]
    for name in ("X", "D", "comm.H", "comm.Hw"):
        assert _worst_off(tree.leaves(got[name]), tree.leaves(want[name]),
                          BACKEND_TOL, d_floor if name == "D" else None
                          ) == 0.0, name


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "published"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_family_bits_per_step_match_reference(arch, full):
    d = _spec(arch, backend="neighbor")
    d["n_nodes"] = 8
    if full:
        d["model"] = {"arch": arch, "full": True, "local_batch": 2,
                      "seq_len": 64}
    jspec = japi.ExperimentSpec.from_dict(d)
    want = _jax_bits(jspec)
    run = tapi.build(tapi.ExperimentSpec.from_json(jspec.to_json()),
                     device="cpu")
    assert isinstance(want, int) and run.bits_per_step() == want
    jtr = japi.build(jspec).trainer
    shapes = [(1,) + tuple(x.shape[1:]) for x in jax.tree_util.tree_leaves(
        jtr.abstract_state().plead.X)]
    want_leaves = collections.Counter(
        jbucket.default_quant_block(s, 256) for s in shapes)
    layout = run.trainer.wire_layout()
    got_leaves = collections.Counter(
        {g.block: len(g.leaf_indices) for g in layout.groups})
    assert got_leaves == want_leaves
    if full:
        assert dict(got_leaves) == FULL_WIDTH_BLOCKS[arch]
