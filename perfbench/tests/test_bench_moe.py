"""The ``deepseek-moe-16b.ring4`` cell at a small size on the CPU: the
program against ``perfbench/reference/moe.py``, a run's result, the
reference's imports, and the per-layer readers of the expert layer on a
small traced run's phases and row counter.

The small size keeps the cell's structure (4 nodes on a ring, a leading
dense layer and 4 expert layers, the router over every expert, the
share held, shared experts, the sequence-wise balance loss) at narrow
widths: 16 router outputs with experts 4-7 held, top 4."""
import ast
import time

import numpy as np
import pytest
import torch

import bench_small
from perfbench import harness, moe_yard, readings, spans, traffic
from perfbench.reference import common as RC

NAME = "deepseek-moe-16b.ring4"
#: published keys at a test's width
CFG = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
       "head_dim": 16, "intermediate_size": 96, "moe_intermediate_size": 32,
       "router_outputs": 16, "n_routed_experts": 4, "first_held_expert": 4,
       "num_experts_per_tok": 4, "vocab_size": 500}
#: the limits at this size, set as the cells' are (``perfbench/check.py``)
#: from readings on the CPU: the widest of 64 sound seeds (1001-1048 and
#: 2**31 + 7 to 2**31 + 22) and the least of the TF32 control and of the
#: faults over 3 seeds (2001-2003), lower^(1/3) upper^(2/3) rounded down;
#: the TF32 control is the upper reading of every number here, and fails
#: each of them
LIMITS = {"loss_gap": 4e-05, "grad_gap": 3e-05, "change_gap": 7e-04,
          "l1_gap": 1e-04, "state_gap": 9e-04, "bits_gap": 0}
READERS = ("route_ms", "dispatch_ms", "expert_ms", "expert_load_max_mean",
           "expert_roofline_pct", "permute_roofline_pct", "moe_mfu_pct")


def small_cell():
    cell = harness.open_cell(NAME, traffic.benchmark())
    cfg = {**cell.cfg, **CFG}
    over = dict(bench_small.CELL, limits=LIMITS)
    return harness.Cell(NAME, cell.entry, {**cell.cell, **over}, cell.conf,
                        cfg, cell.model, cell.model.leaves(cfg))


def run(seed: int = 2 ** 31 + 7, trace: bool = False, faults=()):
    torch.set_num_threads(1)
    lines = []
    result = harness.run(small_cell(), seed, 0.3, trace,
                         t_start=time.perf_counter(), device="cpu",
                         prepare=lambda tr: readings.plant(tr, faults),
                         err=lines.append)
    return result, lines


def test_each_nodes_loss_and_gradient_match_the_program():
    cell = small_cell()
    dev = torch.device("cpu")
    prog = harness.Program(cell, dev)
    X0 = traffic.make_weights(cell.leaves, 5, dev)
    g = torch.Generator().manual_seed(5)
    Xs = [x[None] + 0.01 * torch.randn((4,) + x.shape, generator=g)
          for x in X0]
    batch = traffic.make_bank(cell.cell, cell.cfg, 5, dev)[0]
    ce, G = prog.runner.trainer.loss_and_grad(
        harness.nested(cell.paths, Xs), batch)
    G = prog.tree.leaves(G)
    losses = []
    for n in range(4):
        p = {path: x[n].clone().requires_grad_(True)
             for path, x in zip(cell.paths, Xs)}
        loss = cell.model.node_loss(cell.cfg, RC.Precision(), p,
                                    {k: v[n] for k, v in batch.items()})
        losses.append(float(loss.detach()))
        grads = torch.autograd.grad(loss, list(p.values()))
        top = max(float(gp[n].abs().max()) for gp in G)
        for j, (gr, gp) in enumerate(zip(grads, G)):
            scale = max(float(gp[n].abs().max()), 1e-3 * top)
            assert float((gr - gp[n]).abs().max()) <= 1e-4 * scale, \
                cell.paths[j]
    assert abs(sum(losses) / 4 - float(ce)) <= 1e-5 * float(ce)


def test_the_reference_loss_is_the_cross_entropy_and_its_gradient_has_the_balance_loss():
    cell = small_cell()
    dev = torch.device("cpu")
    X0 = traffic.make_weights(cell.leaves, 6, dev)
    batch = {k: v[0] for k, v in
             traffic.make_bank(cell.cell, cell.cfg, 6, dev)[0].items()}

    def router_grad(alpha):
        cfg = dict(cell.cfg, aux_loss_alpha=alpha)
        p = {path: x.clone().requires_grad_(True)
             for path, x in zip(cell.paths, X0)}
        loss = cell.model.node_loss(cfg, RC.Precision(), p, batch)
        return float(loss), torch.autograd.grad(loss, p["blocks/router"])[0]

    (l0, g0), (l1, g1) = router_grad(0.0), router_grad(0.5)
    assert l0 == l1
    assert float((g1 - g0).abs().max()) > 1e-3 * float(g0.abs().max())


@pytest.mark.parametrize("faults", [(), ("no_prox",)])
def test_a_small_run_is_correct_and_a_fault_is_not(faults):
    result, lines = run(faults=faults)
    assert result["correct"] is (not faults)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == set(harness.check.NUMBERS)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    path = bench_small.ROOT / "perfbench" / "reference" / "moe.py"
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    assert not {m.split(".")[0] for m in mods} & {
        "repro", "repro_torch", "jax", "jaxlib", "flax"}, mods


def test_the_readers_find_the_expert_layers_phases_in_a_traced_run(
        monkeypatch):
    from repro_torch.obs import trace
    trace.RECORDER.clear()
    result, _ = run(trace=True)
    assert result["metrics"] == {}          # no device metric from a CPU run
    records = trace.recorded()
    steps = sorted({r.step for r in records if r.name == spans.STEP})
    assert len(steps) == bench_small.CELL["traced_steps"]
    for r in records:       # the host's clock in place of the device's
        r.device_t0_ms, r.device_t1_ms = r.host_t0_ns / 1e6, \
            r.host_t1_ns / 1e6
    names = {r.name for r in records}
    assert {"moe/route", "moe/dispatch", "moe/experts",
            "moe/combine"} <= names
    monkeypatch.setattr(spans, "program_records", lambda: records)
    window = 1e-3 * (max(r.host_t1_ns for r in records)
                     - min(r.host_t0_ns for r in records)) / 1e6
    tr = type("Trace", (), {"steps": len(steps), "window_s": window,
                            "kernels": lambda self, k: [1e-3]})()
    ctx = harness.ReadContext(tr, {}, harness.yard(small_cell()),
                              lambda line: None)
    bench = traffic.benchmark()
    readers = harness.metric_modules(harness.open_cell(NAME, bench), bench)
    assert set(READERS) <= set(readers)
    for name in READERS:
        v = readers[name].read(ctx)
        assert v is not None and v > 0, name
    calls = moe_yard.layer_calls(spans.window(ctx))
    # 4 expert layers a step, 4 nodes x 4 held experts a call, the widths
    # the program ran
    assert len(calls) == 4 * len(steps) and calls[0].rows.shape == (16,)
    c = small_cell().cell
    assert {(x.nodes, x.tokens, x.k, x.D, x.F) for x in calls} == {
        (4, c["local_batch"] * c["seq_len"], 4, 64, 32)}
    trace.RECORDER.clear()


def test_the_readers_are_silent_without_the_programs_phases(monkeypatch):
    monkeypatch.setattr(spans, "program_records", lambda: [])
    tr = type("Trace", (), {"steps": 2, "window_s": 1.0,
                            "kernels": lambda self, k: []})()
    ctx = harness.ReadContext(tr, {}, {}, lambda line: None)
    bench = traffic.benchmark()
    readers = harness.metric_modules(harness.open_cell(NAME, bench), bench)
    for name in READERS:
        assert readers[name].read(ctx) is None, name


def test_the_yardstick_counts_the_experts_products():
    assert moe_yard.expert_flops(10, 4, 3) == 18 * 10 * 4 * 3
    cell = small_cell()
    dense = sum(int(torch.Size(s["shape"]).numel()) for p, s in cell.leaves
                if not p.startswith("blocks/experts_"))
    tokens = traffic.label_tokens(cell.cell)
    # 4 expert layers of 4 held experts a node, 7 rows each a call
    calls = [moe_yard.Call(np.full(16, 7), 4, tokens // 4, 4, 64, 32)
             for _ in range(4)]
    assert moe_yard.step_flops(harness.yard(cell)["flops"], 1, calls) == \
        6 * dense * tokens + moe_yard.expert_flops(4 * 16 * 7, 64, 32)
