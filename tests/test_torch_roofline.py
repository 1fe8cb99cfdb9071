"""The port's rooflines (``repro_torch.obs.roofline`` and ``roofline_gate``)
against the JAX package's.

* The analytic model -- ``analytic_flops``, ``analytic_hbm_bytes`` and
  ``model_flops`` -- equals the reference's, ``==`` as floats, for every
  config x every applicable input shape x (n_nodes, n_chips) in (8, 1),
  (8, 8), (16, 256): the same arithmetic in the same order on configs
  held field for field to the reference's.
* ``Roofline``'s terms are its bytes and FLOPs over the H100 constants.
* The wire kernels' byte model: ``kernel_roofline`` / ``step_roofline``
  bytes equal the reference's as integers for the layouts of
  ``tests/test_obs.py::TestKernelRoofline`` and of the golden 8x1
  trainer, and the reference's structure tests hold for the port's.
* ``trainer_wire_layout``: ``wire_bits`` equals ``bucketed_payload_bits``
  in both packages.
* ``RunReport.roofline``: the golden 8x1 trainer's has the reference's
  keys and byte values; the dense backend's is empty.
* ``analyze`` on the golden 8x1 trainer counts FLOPs and ATen bytes, and
  its collective bytes are hops x the per-edge payload.
"""
import pathlib

import jax
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro import obs as jobs
from repro.configs import shapes as jshapes
from repro.core import bucket as jbucket
from repro.netsim import metrics as jmetrics
from repro.obs import roofline as jroof
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import obs as tobs
from repro_torch import tree
from repro_torch.configs import shapes as tshapes
from repro_torch.core import bucket as tbucket
from repro_torch.models import transformer as TTR
from repro_torch.netsim import metrics as tmetrics
from repro_torch.obs import roofline as troof

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden_specs"
NODES_CHIPS = [(8, 1), (8, 8), (16, 256)]
CASES = [(arch, shape) for arch in tconfigs.ARCH_IDS
         for shape in tshapes.SHAPES
         if tshapes.applicable(tconfigs.get(arch),
                               tshapes.SHAPES[shape]) is None]


# --- the analytic model --------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CASES, ids=lambda v: str(v))
def test_analytic_terms_equal_the_reference(arch, shape):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    ts, js = tshapes.SHAPES[shape], jshapes.SHAPES[shape]
    assert jshapes.applicable(jcfg, js) is None
    assert troof.analytic_flops(tcfg, ts) == jroof.analytic_flops(jcfg, js)
    n_active = tcfg.param_count(active_only=True)
    assert n_active == jcfg.param_count(active_only=True)
    assert troof.model_flops(tcfg, ts, n_active) == \
        jroof.model_flops(jcfg, js, n_active)
    for n_nodes, n_chips in NODES_CHIPS:
        for copies in (4.0, 6.0):
            assert troof.analytic_hbm_bytes(tcfg, ts, n_nodes, n_chips,
                                            copies) == \
                jroof.analytic_hbm_bytes(jcfg, js, n_nodes, n_chips, copies)


def test_every_config_and_shape_is_covered():
    assert len({a for a, _ in CASES}) == len(tconfigs.ARCH_IDS) == 10
    assert set(tconfigs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    assert {s for _, s in CASES} == set(tshapes.SHAPES)


def test_roofline_terms_are_over_the_h100_constants():
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (67e12, 3.35e12, 450e9)
    r = troof.Roofline(flops_per_chip=1.34e13, hbm_bytes_per_chip=3.35e11,
                       coll_bytes=9e9, coll_breakdown={"collective-permute":
                                                       9e9},
                       model_flops_per_chip=6.7e12, hlo_flops=1.0,
                       hlo_bytes=2.0)
    assert r.t_compute == 1.34e13 / troof.PEAK_FLOPS     # 0.2 s
    assert r.t_memory == 3.35e11 / troof.HBM_BW          # 0.1 s
    assert r.t_collective == 9e9 / troof.LINK_BW
    assert r.bottleneck == "compute" and r.useful_ratio == 0.5
    d = r.as_dict()
    ref = jroof.Roofline(1.0, 1.0, 1.0, {}, 1.0, 1.0, 1.0).as_dict()
    assert set(d) == set(ref)
    assert d["t_collective_s"] == r.t_collective
    # the report's analytic link time reads the same constant
    from repro_torch.obs import report
    assert report.LINK_BW is troof.LINK_BW


# --- the wire kernels' byte model --------------------------------------------

SHAPES = [(4, 100), (3, 7), (64,), (2, 5, 30)]


def _layouts():
    import jax.numpy as jnp
    return (tbucket.compute_layout(SHAPES, [torch.float32] * len(SHAPES),
                                   bits=2),
            jbucket.compute_layout(SHAPES, [jnp.float32] * len(SHAPES),
                                   bits=2))


def _same_bytes(t, j):
    """Every byte count of two kernel_roofline/step_roofline outputs equal
    as integers; the seconds are the port's bytes over the H100's rates."""
    tk = t.get("kernels", t)
    jk = j.get("kernels", j)
    assert set(tk) == set(jk) == {"quantize_pack", "unpack_dequant_mix",
                                  "wire"}
    for k in ("quantize_pack", "unpack_dequant_mix"):
        assert set(tk[k]) == set(jk[k])
        assert tk[k]["hbm_bytes"] == jk[k]["hbm_bytes"]
        assert tk[k]["hbm_bytes"] == int(tk[k]["hbm_bytes"])
        assert tk[k]["t_s"] == tk[k]["hbm_bytes"] / troof.HBM_BW
    assert tk["wire"]["bytes_per_hop"] == jk["wire"]["bytes_per_hop"]
    assert tk["wire"]["hops"] == jk["wire"]["hops"]
    assert tk["wire"]["t_s"] == \
        tk["wire"]["hops"] * tk["wire"]["bytes_per_hop"] / troof.LINK_BW


@pytest.mark.parametrize("hops,receivers", [(1, 1), (2, 1), (5, 2)])
def test_kernel_roofline_bytes_equal_the_reference(hops, receivers):
    tl, jl = _layouts()
    _same_bytes(tobs.kernel_roofline(tl, hops=hops, receivers=receivers),
                jobs.kernel_roofline(jl, hops=hops, receivers=receivers))
    t = tobs.step_roofline(tl, hops=hops, receivers=receivers,
                           measured_step_s=0.5)
    j = jobs.step_roofline(jl, hops=hops, receivers=receivers,
                           measured_step_s=0.5)
    assert set(t) == set(j)
    assert t["wire_bytes_per_hop"] == j["wire_bytes_per_hop"]
    _same_bytes(t, j)


class TestKernelRooflineStructure:
    """``tests/test_obs.py::TestKernelRoofline`` on the port's module."""

    def test_wire_bytes_equal_bucket_layout(self):
        layout, _ = _layouts()
        k = tobs.kernel_roofline(layout, hops=3)
        assert k["wire"]["bytes_per_hop"] * 8 == layout.wire_bits

    def test_wire_bytes_equal_per_leaf_qinf_accounting(self):
        layout, _ = _layouts()
        per_leaf = sum(
            tmetrics.qinf_wire_bits(s, 2, tbucket.default_quant_block(s))
            for s in SHAPES)
        assert layout.wire_bits == per_leaf
        assert tobs.kernel_roofline(layout)["wire"]["bytes_per_hop"] * 8 \
            == per_leaf

    def test_hbm_model_structure(self):
        layout, _ = _layouts()
        elems = sum(g.rows * g.block for g in layout.groups)
        wire_bytes = layout.codes_bytes + layout.scales_bytes
        k = tobs.kernel_roofline(layout, hops=2, receivers=1)
        assert k["quantize_pack"]["hbm_bytes"] == 8 * elems + wire_bytes
        assert k["unpack_dequant_mix"]["hbm_bytes"] == \
            3 * wire_bytes + 8 * elems
        assert k["quantize_pack"]["t_s"] == pytest.approx(
            k["quantize_pack"]["hbm_bytes"] / troof.HBM_BW)

    def test_step_roofline_utilization(self):
        layout, _ = _layouts()
        sr = tobs.step_roofline(layout, hops=2, measured_step_s=1.0)
        assert sr["predicted_step_s"] == pytest.approx(
            sr["predicted_kernel_s"] + sr["predicted_wire_s"])
        assert sr["utilization"] == pytest.approx(sr["predicted_step_s"])
        assert "measured_step_s" not in tobs.step_roofline(layout, hops=2)

    def test_more_hops_more_wire_time(self):
        layout, _ = _layouts()
        t1 = tobs.step_roofline(layout, hops=1)["predicted_wire_s"]
        t4 = tobs.step_roofline(layout, hops=4)["predicted_wire_s"]
        assert t4 == pytest.approx(4 * t1)


# --- the golden 8x1 trainer --------------------------------------------------

def _golden_8x1():
    return japi.ExperimentSpec.load(GOLDEN
                                    / "trainer_neighbor_bucketed_8x1.json")


@pytest.fixture(scope="module")
def reference_8x1():
    """The reference trainer's (layout, redundancy, hops, per-edge bits)
    from its abstract state (meshless on one device)."""
    with pytest.warns(UserWarning):
        tr = japi.build(_golden_8x1()).trainer
    leaves = jax.tree_util.tree_leaves(tr.abstract_state().plead.X)
    layout, model = jobs.trainer_wire_layout(tr, leaves)
    return (layout, model, len(tr.plan.hops),
            jmetrics.bucketed_payload_bits(tr, leaves))


def _port_8x1():
    return tapi.build(tapi.ExperimentSpec.from_json(_golden_8x1().to_json()),
                      device="cpu")


def _meta_leaves(runner):
    N = runner.trainer.tcfg.n_nodes
    return [torch.empty((N,) + tuple(p.shape), dtype=p.dtype, device="meta")
            for p in tree.leaves(TTR.abstract_params(runner.trainer.mcfg))]


def test_trainer_wire_layout_equals_the_payload_accounting(reference_8x1):
    jlayout, jmodel, hops, jbits = reference_8x1
    run = _port_8x1()
    leaves = _meta_leaves(run)
    layout, model = tobs.trainer_wire_layout(run.trainer, leaves)
    assert model == jmodel == 1
    assert layout.wire_bits == jlayout.wire_bits == jbits == \
        tmetrics.bucketed_payload_bits(run.trainer, leaves)
    assert len(run.trainer.plan.hops) == hops
    _same_bytes(tobs.kernel_roofline(layout, hops=hops),
                jobs.kernel_roofline(jlayout, hops=hops))


def test_run_report_roofline_has_the_reference_keys_and_bytes(reference_8x1):
    jlayout, _, hops, _ = reference_8x1
    run = _port_8x1()
    run.run(num_steps=1)
    got = run.last_report.roofline
    want = jobs.step_roofline(jlayout, hops=hops,
                              measured_step_s=run.last_report.s_per_step)
    assert set(got) == set(want)
    assert got["wire_bytes_per_hop"] == want["wire_bytes_per_hop"]
    assert got["measured_step_s"] == run.last_report.s_per_step
    _same_bytes(got, want)
    assert got["utilization"] == got["predicted_step_s"] / \
        got["measured_step_s"]
    assert run.last_report.to_dict()["roofline"] == got


def test_run_report_roofline_is_empty_for_the_dense_backend():
    run = tapi.build(tapi.ExperimentSpec.load(
        GOLDEN / "trainer_dense_qinf2.json"), device="cpu")
    run.run(num_steps=1)
    assert run.last_report.roofline == {}
    dense = tapi.build(tapi.ExperimentSpec.load(
        GOLDEN / "prox_lead_dense_ring_qinf2.json"), device="cpu")
    dense.run(num_steps=1)
    assert dense.last_report.roofline == {}


def test_analyze_counts_a_step(reference_8x1):
    _, _, hops, per_edge = reference_8x1
    run = _port_8x1()
    spec = run.spec
    cfg = run.trainer.mcfg
    shape = troof.train_shape(spec)
    assert (shape.global_batch, shape.seq_len) == (8 * 2, 16)
    r = troof.analyze(run, cfg, shape, spec.n_nodes)
    assert r.hlo_flops > 0 and r.hlo_bytes > 0
    assert r.coll_bytes == hops * per_edge / 8
    assert r.coll_breakdown == {"collective-permute": r.coll_bytes}
    assert r.flops_per_chip == troof.analytic_flops(cfg, shape)
    assert r.hbm_bytes_per_chip == troof.analytic_hbm_bytes(
        cfg, shape, 8, 1, 4.0)
    assert r.model_flops_per_chip == 6.0 * cfg.param_count(
        active_only=True) * 16 * 16
    # every product of the step is counted: at least the model's 6ND
    assert r.hlo_flops >= r.model_flops_per_chip * 0.5
    assert set(r.as_dict()) >= {"t_compute_s", "t_memory_s",
                                "t_collective_s", "bottleneck"}
