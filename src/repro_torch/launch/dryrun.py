"""Dry run: one step of every (arch x shape x mesh) on the ``meta`` device.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape train_4k --backend neighbor
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --backend neighbor [--multi-pod | --both-meshes]
  ... [--topology exponential] [--bits 4] [--out experiments/dryrun_torch]

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each step on 512 placeholder devices and reads XLA's memory and cost
analyses.  The port has no compiler: it runs the step eagerly on
PyTorch's ``meta`` device -- shapes and dtypes flow through every ATen op,
nothing is allocated or computed --, a train step once to warm up (the
caches a real first step builds) and once more under the counters of
:func:`repro_torch.obs.roofline.count_step` (FLOPs, ATen bytes, the
``pp`` seam's and the metric all-reduces' bytes) and
:class:`repro_torch.obs.record.LiveBytes` (the step's live storage
bytes).  Kernels B1-B4 take the card's route dry: each call makes the
binding's checks and allocates its outputs
(``repro_torch.kernels.quantize``), and is counted.  A host read in the
step (``.item()``, ``float(t)``) raises on ``meta``.

The mesh.  The reference's logical production meshes stay
(:func:`repro_torch.launch.mesh.make_production_mesh`: (data 16, model 16)
for one TPU v5e pod of 256 chips, (pod 2, data 16, model 16) for two), as
do its global batches and node counts (16 and 32), so a record compares
one for one with the reference's.  On the H100 the node axis is realised
over ranks (:class:`~repro_torch.launch.mesh.ProcessMesh`, world N, one
node a rank, N H100s) and the model axis stays inside the rank, as the
port places a node today: one card holds a node's 16 model shards whole
(ROADMAP §A item 3 (c) would spread them over 16 cards;
``state_bytes_per_model_shard`` is what each would hold).  A DGX H100
joins 8 cards by NVLink, so a 16-way model axis would span two boxes.
The dry run takes rank 0's view (``"placement": "ranks"``): its node's
state, its rows of the batch, the ``pp`` bytes it sends to other ranks
(:class:`~repro_torch.optim.wire.DryDistPP`).  The dense backend does not
split over ranks (ROADMAP §A item 3 (d)), so a dense record dry-runs all
N nodes in one process, as the port runs them (``"placement": "one
process"``).

Placement ``"tp"`` (``--placement tp``) spreads each node over M cards
as well: rank (0, 0) of the two-axis
:class:`~repro_torch.launch.mesh.TPProcessMesh`, world N x M (256 H100s
for (16, 16), 512 for (2, 16, 16)), holds ONE model shard of one node:
the model-local slices of its sharded leaves and its replicated leaves
whole (``repro_torch.models.tp.DryDistTP``: a tensor-parallel node whose
collectives allocate their shapes on ``meta``), its node's rows of the
batch.  The record adds the bytes the rank hands the model axis's
collectives over the step (``tp_bytes``, by kind in ``tp_breakdown``:
:class:`repro_torch.obs.record.RecordingTP`), the rank's own state bytes
(``state_bytes_per_rank``, to hold against ``state_bytes_per_model_shard``)
and ``"cards"`` N x M.  Prefill runs the same way (``forward`` at one
model shard, the last position's logits gathered over the ranks); decode
and the ssm and hybrid families are not tensor-parallel yet and are
skipped with the ROADMAP item that names them.  ``"tp one process"``
runs all N x M rank-rows in one process (``StackedTP``), the program a
card runs for a tensor-parallel node.

Serving shapes mirror the reference's ``lower_serve``: prefill runs
``forward(mode="train")`` and keeps the last position's logits, decode one
``decode_step`` at the last position of an ``init_cache(abstract=True)``
cache; the batch is cut over the node axes where it divides, the
parameters are whole on a rank, and ``configs.shapes.applicable`` decides
the skips.

Per combo one JSON in ``--out`` with the reference's keys (``arch`` ...
``status``, ``params``, ``params_active``, ``chips``, ``memory``,
``roofline``, ``gossip``) and the port's: ``memory`` is one rank's step as
:class:`~repro_torch.obs.record.LiveBytes` sees it (``code_bytes`` null:
there is no compiled code; ``fits``: the peak against one H100's memory,
:data:`H100_MEMORY_BYTES`), ``cards`` the H100s the roofline divides the
job over, ``state_bytes_per_model_shard``, ``kernels`` (each kernel's
calls in the step and, for B3/B4, the bytes bound of
:func:`repro_torch.obs.roofline_gate.kernel_roofline` at this layout) and
``placement``.  The roofline's analytic terms are the H100 data-sheet
model of :mod:`repro_torch.obs.roofline`.  Exits 1 if any combo errs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch import api, configs, tree
from repro_torch.configs import shapes as shp
from repro_torch.core.draws import MetaDraws
from repro_torch.kernels import quantize as qk
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import sharding
from repro_torch.models import tp as tp_mod
from repro_torch.models import transformer as TR
from repro_torch.netsim import metrics as nmetrics
from repro_torch.obs import roofline, roofline_gate
from repro_torch.obs.record import (LiveBytes, RecordingAllReduce,
                                    RecordingPP)
from repro_torch.optim.wire import DryDistPP

META = torch.device("meta")
#: one H100's device memory in bytes, ``torch.cuda.get_device_properties(0)
#: .total_memory`` read on an NVIDIA H100 80GB HBM3 at a 700.00 W power
#: limit (``chip_smoke.py`` phase 16 prints it): what ``fits`` holds a
#: rank's peak against
H100_MEMORY_BYTES = 85_017_493_504
PLACEMENTS = ("ranks", "one process")
#: a tensor-parallel node: one model shard a rank, or all in one process
TP_PLACEMENTS = ("tp", "tp one process")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def train_spec(cfg, mesh, *, backend: str = "neighbor", bits: int = 2,
               pack_mode: str = "lastdim", shard_aligned_blocks: bool = False,
               topology: str = "ring") -> api.ExperimentSpec:
    """The reference's dry-run spec: Prox-LEAD at TrainerConfig's step
    sizes, QInf at ``bits``, the sharded engine on ``mesh``'s nodes and
    model axis."""
    params = {"shard_aligned_blocks": True} if shard_aligned_blocks else {}
    return api.ExperimentSpec(
        name=f"dryrun-{backend}-{topology}", n_nodes=mesh_mod.n_nodes(mesh),
        algorithm=api.AlgorithmSpec("prox_lead", eta=api.constant(1e-2),
                                    alpha=api.constant(0.5),
                                    gamma=api.constant(1.0)),
        compressor=api.CompressorSpec("qinf", {"bits": bits}),
        topology=api.TopologySpec(graph=topology),
        execution=api.ExecutionSpec(engine="sharded", backend=backend,
                                    pack_mode=pack_mode, mesh=mesh.shape,
                                    params=params))


def state_bytes_per_model_shard(trainer) -> int:
    """Bytes of one node's state (X, D, H, the Hw slots; Adam's moments)
    on one of its model shards: sum over the leaves of
    ``sharding.model_local_shape`` x itemsize, what a device of the
    reference's mesh holds."""
    M = sharding.model_axis_size(trainer.mesh)
    copies = 3 + (trainer.hw_slots or 1)
    if trainer.tcfg.precondition == "adam":
        copies += 2
    total = 0
    for (_, p), sp in zip(tree.flatten_with_paths(
            TR.abstract_params(trainer.mcfg)), trainer.leaf_specs):
        local = sharding.model_local_shape(tuple(p.shape), sp, M)
        total += math.prod(local) * p.element_size() * copies
    return total


def gossip_block(trainer) -> Optional[dict]:
    """The exact wire accounting of the neighbor backend's plan (the
    reference's ``gossip`` block), or None without a plan."""
    plan = trainer.plan
    if plan is None:
        return None
    leaves = tree.leaves(trainer.abstract_state().plead.X)
    per_edge = nmetrics.sharded_payload_bits(trainer, leaves)
    return {"plan": plan.name, "hops": len(plan.hops),
            "wire_mode": trainer.tcfg.wire_mode,
            "pairs_per_round": plan.pairs_per_round,
            "payload_bits_per_edge": per_edge,
            "bits_per_round": nmetrics.plan_bits_per_round(plan, per_edge)}


def state_bytes_per_rank(trainer) -> int:
    """Bytes of the state (X, D, H, the Hw slots; Adam's moments) this
    trainer's process holds: its nodes' rows, or its rank-rows."""
    st = trainer.abstract_state()
    p = st.plead
    trees = [p.X, p.D, p.comm.H, p.comm.Hw]
    if st.precond is not None:
        trees += list(st.precond)
    return sum(x.numel() * x.element_size() for t in trees
               for x in tree.leaves(t))


def kernel_block(trainer, calls: dict, nodes: int) -> dict:
    """Each kernel's calls in the step and, on the bucketed QInf wire, the
    bytes B3 and B4 must move over all its calls
    (:func:`roofline_gate.kernel_roofline` of the step's layout x the
    ``nodes`` a launch covers, each with its model shards in this process:
    one on a ``DistTP`` rank) and that over HBM_BW."""
    out = {k: {"calls": n} for k, n in calls.items()}
    tr = trainer
    if (tr.plan is None or tr.tcfg.compressor != "qinf"
            or tr.tcfg.wire_mode != "bucketed"):
        return out
    layout, shards = roofline_gate.trainer_wire_layout(
        tr, tree.leaves(tr.abstract_state().plead.X))
    if isinstance(tr.tp, tp_mod.DistTP):
        shards = 1
    k = roofline_gate.kernel_roofline(layout, hops=len(tr.plan.hops),
                                      receivers=tr.plan.T, shards=shards)
    for name, part in (("qinf_quantize_pack_blocks", "quantize_pack"),
                       ("qinf_unpack_dequant_mix_blocks",
                        "unpack_dequant_mix")):
        nbytes = k[part]["hbm_bytes"] * nodes
        out[name].update(bound_bytes=nbytes,
                         bound_s=nbytes / roofline.HBM_BW)
    return out


def _memory(lb: LiveBytes, result) -> dict:
    out = lb.outputs(result)
    return {"argument_bytes": lb.argument_bytes,
            "output_bytes": out["output_bytes"],
            "alias_bytes": out["alias_bytes"],
            "temp_bytes": lb.peak - lb.argument_bytes,
            "code_bytes": None,
            "peak_bytes": lb.peak,
            "fits": lb.peak <= H100_MEMORY_BYTES}


def counted_step(trainer, state, batch, draws=None):
    """One counted train step of ``trainer`` (a ``meta`` one, or a real
    one to compare with; ``draws`` default :class:`MetaDraws`) after one
    warm-up step from ``state`` (the caller's list of one state: popped,
    so the step may free it), the warm-up building the lazy index tensors
    and caches a real step builds once, as
    :func:`repro_torch.obs.roofline.analyze` warms up.  -> (StepCounts,
    memory dict, the kernels' ``meta`` calls, the new state)."""
    draws = draws or MetaDraws()
    st, _ = trainer.train_step(state.pop(), batch, draws)
    held = [st]
    del st
    qk.reset_meta_calls()
    with LiveBytes((held, batch)) as lb:
        counts, result = roofline.count_step(
            trainer, lambda: trainer.train_step(held.pop(), batch, draws))
    return counts, _memory(lb, result), qk.meta_call_counts(), result[0]


def meta_trainer(spec, mesh, cfg, placement: Optional[str] = None):
    """The ``meta`` trainer of ``spec`` (a train spec on ``mesh``) at
    ``placement`` (default: ``"ranks"`` on the neighbor backend, ``"one
    process"`` on the dense one): on ranks, rank 0's node block, its
    ``pp`` a recording :class:`~repro_torch.optim.wire.DryDistPP`; at
    ``"tp"`` rank (0, 0) of the two-axis process mesh, one model shard of
    one node, its ``tp`` a :class:`~repro_torch.models.tp.DryDistTP`; at
    ``"tp one process"`` every rank-row under ``StackedTP``; always a
    recording metric all-reduce that sums nothing.  -> (trainer,
    placement)."""
    placement = placement or ("one process"
                              if spec.execution.backend == "dense"
                              else "ranks")
    if placement not in PLACEMENTS + TP_PLACEMENTS:
        raise ValueError(f"unknown placement {placement!r}; have "
                         f"{PLACEMENTS + TP_PLACEMENTS}")
    pm = pp = tp = None
    M = sharding.model_axis_size(mesh)
    if placement == "ranks":
        pm = mesh_mod.ProcessMesh(mesh, rank=0, world=spec.n_nodes)
        pp = RecordingPP(DryDistPP(pm), process_mesh=pm)
    elif placement == "tp":
        pm = mesh_mod.TPProcessMesh(mesh, rank=0, world=spec.n_nodes * M,
                                    groups=False)
        pp = RecordingPP(DryDistPP(pm.node_mesh), process_mesh=pm.node_mesh)
        tp = tp_mod.DryDistTP(pm)
    elif placement == "tp one process":
        tp = tp_mod.StackedTP(M)
    tr = api.build_trainer_runner(spec, device=META, model_cfg=cfg, pp=pp,
                                  process_mesh=pm, tp=tp).trainer
    tr.all_reduce = RecordingAllReduce()
    return tr, placement


def dry_train(cfg, shape, mesh, *, backend: str = "neighbor", bits: int = 2,
              pack_mode: str = "lastdim", shard_aligned_blocks: bool = False,
              topology: str = "ring", placement: Optional[str] = None,
              spec=None) -> dict:
    """The train record of ``cfg`` at ``shape`` on ``mesh`` (see the
    module docstring; ``placement`` as :func:`meta_trainer`); ``spec``
    replaces the dry-run spec (its mesh and nodes rule)."""
    spec = spec or train_spec(cfg, mesh, backend=backend, bits=bits,
                              pack_mode=pack_mode,
                              shard_aligned_blocks=shard_aligned_blocks,
                              topology=topology)
    N = spec.n_nodes
    tr, placement = meta_trainer(spec, mesh, cfg, placement)
    n_local = tr.n_local
    batch = {k: _meta((n_local,) + tuple(s[1:]), dt) for k, (s, dt) in
             shp.train_input_specs(cfg, shape, N).items()}
    cards = N // n_local
    if isinstance(tr.tp, tp_mod.DistTP):
        cards *= tr.tp.M              # a node's M model shards, M cards
    counts, memory, calls, _ = counted_step(tr, [tr.abstract_state()], batch)
    rec = {"placement": placement, "cards": cards, "nodes_per_card": n_local,
           "memory": memory,
           "state_bytes_per_model_shard": state_bytes_per_model_shard(tr),
           "state_bytes_per_rank": state_bytes_per_rank(tr),
           "roofline": roofline.roofline_of(cfg, shape, N, cards,
                                            counts).as_dict(),
           "tp_bytes": sum(counts.tp.values()), "tp_breakdown": counts.tp,
           "kernels": kernel_block(tr, calls, n_local)}
    if isinstance(tr.tp, tp_mod.DistTP):
        rec["model_shards_per_card"] = 1
    gossip = gossip_block(tr)
    if gossip is not None:
        rec["gossip"] = gossip
    return rec


# ---------------------------------------------------------------------------
# Serve steps (prefill / decode)
# ---------------------------------------------------------------------------

def _serve_batch_rows(B: int, n_nodes: int) -> int:
    """A rank's rows of a serving batch: cut over the node axes where
    they divide it, else whole (the reference's ``bspec``)."""
    return B // n_nodes if B % n_nodes == 0 else B


def dry_serve(cfg, shape, mesh, placement: Optional[str] = None) -> dict:
    """The serve record of ``cfg`` at ``shape``: one prefill or decode
    step of a rank (whole parameters, its rows of the batch); at
    ``placement`` ``"tp"`` a prefill of rank (0, 0): one model shard of
    the parameters, the last position's logits gathered over the model
    ranks."""
    N = mesh_mod.n_nodes(mesh)
    params = tree.tree_map(lambda p: _meta((1,) + tuple(p.shape), p.dtype),
                           TR.abstract_params(cfg))
    M, tp = 1, None
    if placement == "tp":
        M = sharding.model_axis_size(mesh)
        if shape.kind != "prefill":
            raise ValueError("placement 'tp' runs prefill; decode at M > 1 "
                             "is ROADMAP §A item 3 (f)")
        pm = mesh_mod.TPProcessMesh(mesh, rank=0, world=N * M, groups=False)
        tp = tp_mod.DryDistTP(pm)
        leaves, treedef = tree.flatten(params)
        specs_ = tree.leaves(sharding.param_specs(TR.abstract_params(cfg)))
        params = tree.unflatten(treedef, [
            sharding.rank_rows(x, sp, M, 0) for x, sp in zip(leaves, specs_)])
    B = shape.global_batch
    Bl = _serve_batch_rows(B, N)
    specs = shp.serve_input_specs(cfg, shape)
    if shape.kind == "prefill":
        inputs = {k: _meta((1, _serve_batch_rows(s[0], N)) + tuple(s[1:]),
                           dt) for k, (s, dt) in specs.items()}

        def step():
            if tp is not None:
                logits = TR.forward(cfg, params, inputs, mode="train",
                                    tp=tp)[0]
                return tp.gather_last(logits[:, :, -1])
            logits = TR.forward(cfg, params, inputs, mode="train")[0]
            return logits[:, :, -1]
    else:
        cache = TR.init_cache(cfg, Bl, shape.seq_len, abstract=True)
        tokens = _meta((1, Bl, 1), torch.int64)
        inputs = {"cache": cache, "tokens": tokens}

        def step():
            return TR.decode_step(cfg, params, cache, tokens,
                                  shape.seq_len - 1)
    cards = (N if Bl < B else 1) * M
    qk.reset_meta_calls()
    with torch.no_grad(), LiveBytes((params, inputs)) as lb:
        counts, result = roofline.count_step(None, step, tp=tp)
    rec = {"placement": "tp" if tp is not None else (
               "ranks" if cards > 1 else "one process"),
           "cards": cards, "batch_rows_per_card": Bl,
           "memory": _memory(lb, result),
           "roofline": roofline.roofline_of(cfg, shape, N, cards,
                                            counts).as_dict(),
           "kernels": {k: {"calls": n}
                       for k, n in qk.meta_call_counts().items()}}
    if tp is not None:
        rec.update(tp_bytes=sum(counts.tp.values()), tp_breakdown=counts.tp,
                   model_shards_per_card=1)
    return rec


def tp_skip(cfg, shape) -> Optional[str]:
    """Why placement ``"tp"`` does not run ``cfg`` at ``shape``, or None."""
    if cfg.family in ("ssm", "hybrid"):
        return (f"the {cfg.family} family is not tensor-parallel yet "
                f"(ROADMAP §A item 3 (e))")
    if shape.kind == "decode":
        return "decode at M > 1 needs head-sharded caches (ROADMAP §A " \
               "item 3 (f))"
    return None


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            backend: str = "dense", out_dir="experiments/dryrun_torch",
            verbose: bool = True, bits: int = 2, pack_mode: str = "lastdim",
            tag: Optional[str] = None, shard_aligned_blocks: bool = False,
            topology: str = "ring", placement: Optional[str] = None) -> dict:
    """One combo's record, written to ``out_dir`` (None: not written);
    ``placement`` as :func:`meta_trainer` (``"tp"``: serving shapes too)."""
    cfg = dataclasses.replace(configs.get(arch), dtype=torch.bfloat16)
    shape = shp.SHAPES[shape_name]
    skip = shp.applicable(cfg, shape)
    if skip is None and placement == "tp":
        skip = tp_skip(cfg, shape)
    mesh_tag = "2pod" if multi_pod else "1pod"
    variant = tag or (backend if topology == "ring"
                      else f"{backend}-{topology}")
    if placement == "tp" and not tag:
        variant += "-tp"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "backend": backend, "variant": variant, "bits": bits,
           "topology": topology, "pack_mode": pack_mode, "status": None}
    fname = None
    if out_dir is not None:
        out_path = pathlib.Path(out_dir)
        out_path.mkdir(parents=True, exist_ok=True)
        fname = out_path / f"{arch}__{shape_name}__{mesh_tag}__{variant}.json"
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        if fname is not None:
            fname.write_text(json.dumps(rec, indent=1))
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name}: {skip}")
        return rec
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    try:
        if shape.kind == "train":
            body = dry_train(cfg, shape, mesh, backend=backend, bits=bits,
                             pack_mode=pack_mode,
                             shard_aligned_blocks=shard_aligned_blocks,
                             topology=topology, placement=placement)
        else:
            body = dry_serve(cfg, shape, mesh, placement)
        t_dry = time.perf_counter() - t0
        rec.update({"status": "ok", "t_dry_s": round(t_dry, 1),
                    "device": "meta", "chips": mesh_mod.n_chips(mesh),
                    "params": cfg.param_count(),
                    "params_active": cfg.param_count(active_only=True)})
        rec.update(body)
        if verbose:
            rl, mem = rec["roofline"], rec["memory"]
            print(f"[dryrun] OK {arch} x {shape_name} x {mesh_tag} "
                  f"({backend}, {rec['placement']}): {t_dry:.1f}s "
                  f"peak {mem['peak_bytes'] / 2 ** 30:.2f} GiB/card "
                  f"fits={mem['fits']} bottleneck={rl['bottleneck']} "
                  f"t=(c {rl['t_compute_s']:.3g}, m {rl['t_memory_s']:.3g}, "
                  f"x {rl['t_collective_s']:.3g})s "
                  f"useful={rl['useful_ratio']:.2f}", flush=True)
    except Exception as e:  # record the failure -- these are faults to fix
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
        if verbose:
            print(f"[dryrun] FAIL {arch} x {shape_name} x {mesh_tag}: "
                  f"{type(e).__name__}: {str(e)[:300]}", flush=True)
    if fname is not None:
        fname.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--backend", default="dense",
                    choices=["dense", "ring", "neighbor"])
    ap.add_argument("--topology", default="ring",
                    help="gossip graph (neighbor backend): ring | "
                         "exponential | torus2d | star | expander")
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--pack-mode", default="lastdim",
                    choices=["lastdim", "flat"])
    ap.add_argument("--shard-aligned-blocks", action="store_true")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--placement", default=None,
                    choices=list(PLACEMENTS + TP_PLACEMENTS),
                    help="ranks (the neighbor backend's default: a node a "
                         "card) | one process | tp (a node's model shards "
                         "on M cards: rank (0, 0), world N x M) | tp one "
                         "process")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes_ = list(shp.SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    for mp in meshes:
        for a in archs:
            for s in shapes_:
                rec = run_one(a, s, multi_pod=mp, backend=args.backend,
                              bits=args.bits, pack_mode=args.pack_mode,
                              shard_aligned_blocks=args.shard_aligned_blocks,
                              tag=args.tag, out_dir=args.out,
                              topology=args.topology,
                              placement=args.placement)
                n_fail += rec["status"] == "error"
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
