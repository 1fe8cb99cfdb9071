"""Trajectory containers, consensus error and exact bits-on-wire
accounting.

The port of ``repro.netsim.metrics``: the dense engine's payload bits, the
neighbor-gossip backend's u8 wire bits (the model-shard factor is 1: one
card holds every node whole), an exchange plan's bits per round, and the
netsim engine's :class:`Trajectory`, whose bits are fault-exact: payload
bits per directed edge times the directed edges that carried a payload,
read from the masks the engine's mixer drew for the round.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.compression import Compressor, Identity
from repro_torch.tree import leaves


def consensus_error(X, node_axis: int = 0) -> torch.Tensor:
    """sum_leaves || X - mean_node(X) ||_F^2 over the leading node dim; with
    ``node_axis`` 1 (a stacked grid's leaves (P, n, ...)) one error a
    point, (P,)."""
    def err(l):
        sq = (l - l.mean(node_axis, keepdim=True)) ** 2
        return sq.sum() if node_axis == 0 else sq.flatten(node_axis).sum(-1)
    return sum(err(l) for l in leaves(X))


def _payload_bits(compressor: Optional[Compressor], shape) -> int:
    """The compressor's exact payload for one ``shape`` tensor; no
    compressor or Identity is priced as f32, as in the reference."""
    if compressor is None or isinstance(compressor, Identity):
        return int(np.prod(tuple(shape), dtype=np.int64)) * 32
    return int(compressor.payload_bits(tuple(shape)))


def payload_bits_per_node(compressor: Optional[Compressor], X) -> int:
    """Exact wire bits ONE node sends to ONE neighbour per COMM round,
    summed over leaves (leaves carry a leading node dim)."""
    return sum(_payload_bits(compressor, leaf.shape[1:])
               for leaf in leaves(X))


def effective_bits_per_iter(compressor: Optional[Compressor], shape,
                            n_directed_edges: int,
                            faults: Sequence = ()) -> float:
    """Expected bits on the wire per iteration: per-edge payload bits x
    directed edges x the mean edge survival of ``faults`` (objects with
    ``mean_edge_survival()``; the fault models come with netsim)."""
    survival = 1.0
    for f in faults:
        survival *= f.mean_edge_survival()
    return _payload_bits(compressor, shape) * n_directed_edges * survival


def plan_bits_per_round(plan, payload_bits_per_edge: int) -> int:
    """Exact wire bits one gossip round of a compiled ExchangePlan moves:
    every union-support pair carries its payload every round (time-varying
    weights gate the *mixing*, not the send)."""
    return plan.pairs_per_round * payload_bits_per_edge


def plan_active_bits(plan, payload_bits_per_edge: int) -> np.ndarray:
    """(T,) wire bits per round counting only pairs with nonzero mixing
    weight -- the netsim engine's accounting convention, for comparison
    against :func:`plan_bits_per_round`."""
    return plan.active_pairs() * payload_bits_per_edge


def qinf_wire_bits(shape, bits: int, block: int, scale_bits: int = 32) -> int:
    """u8 wire bits for one last-dim-quantized tensor: nibble/byte-packed
    codes -- (b+1)-bit offset codes rounded to 4 or 8 bits, including block
    padding -- plus byte-cast scales.  What the neighbor backend's wire
    buffers physically move (more than ``QInf.payload_bits``, which counts
    ideal b-bit packing)."""
    from repro_torch.kernels.ref import wire_bits_per_element
    shape = tuple(shape) or (1,)
    rows = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
    nb = -(-int(shape[-1]) // block)
    return rows * nb * (block * wire_bits_per_element(bits) + scale_bits)


def _model_local_shapes(trainer, leaves):
    """(model_size, per-shard leaf shapes) as the reference's full-manual
    ``shard_map`` sees them.

    Under the full-manual bucketed wire a node spans model_size shards
    and each shard moves its LOCAL slices: leaves the model axis shards
    quantize (and pad) per slice, every other leaf is moved redundantly by
    all model_size shards -- a node's edge payload is model_size x the
    per-shard bytes.  Otherwise (partial-manual, or no model axis) the
    size is 1 and the shapes are the per-node leaves'.  On a
    tensor-parallel node (``trainer.tp``) the state's rows are already
    model-local: the whole per-node shapes come from the model's
    template."""
    from repro_torch.models.sharding import model_local_shape
    locals_ = [tuple(leaf.shape[1:]) for leaf in leaves]   # per-node
    if trainer.tp.M > 1:
        from repro_torch import tree
        from repro_torch.models import transformer as TR
        locals_ = [tuple(p.shape) for p in
                   tree.leaves(TR.abstract_params(trainer.mcfg))]
    model = trainer.wire_shards
    if model > 1:
        locals_ = [model_local_shape(shape, sp, model)
                   for shape, sp in zip(locals_, trainer.leaf_specs)]
    return model, locals_


def sharded_payload_bits(trainer, leaves) -> int:
    """Exact bits ONE directed edge carries per hop on the neighbor
    backend: packed u8 codes (with block padding) plus byte-cast scales,
    summed over state leaves (raw leaves under identity compression),
    times the model-shard redundancy.  ``leaves`` are node-stacked
    (N, ...) tensors (``meta`` tensors will do) in ``plead.X`` order; the
    per-edge payload is the per-node slice.  Valid for both wire modes:
    the bucketed buffers concatenate exactly the per-leaf payloads
    (:func:`bucketed_payload_bits`)."""
    tcfg = trainer.tcfg
    scale_bits = 16 if tcfg.scales_bf16 else 32
    model, locals_ = _model_local_shapes(trainer, leaves)
    per_shard = 0
    for leaf, local in zip(leaves, locals_):
        if isinstance(trainer.compressor, Identity):
            per_shard += (int(np.prod(local, dtype=np.int64))
                          * leaf.element_size() * 8)
        else:
            blk = trainer._quant_block((1,) + local)
            per_shard += qinf_wire_bits(local, tcfg.bits, blk, scale_bits)
    return model * per_shard


def bucketed_payload_bits(trainer, leaves) -> int:
    """Exact bits ONE directed edge carries per hop with
    ``wire_mode='bucketed'``, from the static BucketLayout of the
    model-local shapes: the flat packed-codes buffer plus the flat
    byte-cast-scales buffer, times the model-shard redundancy.  Equal to
    :func:`sharded_payload_bits`; under identity compression the per-leaf
    path runs, so its count is returned."""
    from repro_torch.core import bucket
    if isinstance(trainer.compressor, Identity):
        return sharded_payload_bits(trainer, leaves)
    tcfg = trainer.tcfg
    model, locals_ = _model_local_shapes(trainer, leaves)
    layout = bucket.compute_layout(
        [(1,) + tuple(s) for s in locals_],
        [leaf.dtype for leaf in leaves], bits=tcfg.bits,
        block_for=trainer._quant_block,
        scale_bytes=2 if tcfg.scales_bf16 else 4)
    return model * layout.wire_bits


@dataclasses.dataclass
class Trajectory:
    """Per-iteration record of a netsim run (numpy, on the host)."""
    consensus: np.ndarray        # (steps,) consensus error after each step
    objective: np.ndarray        # (steps,) objective (0 if no objective)
    bits: np.ndarray             # (steps,) int64 exact bits on wire
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def steps(self) -> int:
        return int(self.consensus.shape[0])

    @property
    def total_bits(self) -> int:
        return int(self.bits.sum())

    def summary(self) -> dict:
        out = {"steps": self.steps,
               "final_consensus": float(self.consensus[-1]),
               "final_objective_gap": float(self.objective[-1]),
               "total_bits_on_wire": self.total_bits,
               "mean_bits_per_iter": float(self.bits.mean())}
        out.update(self.meta)
        return out

    def to_json(self, path: Optional[Any] = None, *,
                full: bool = False) -> str:
        rec = self.summary()
        if full:
            rec["trajectory"] = {
                "consensus": self.consensus.tolist(),
                "objective": self.objective.tolist(),
                "bits": self.bits.tolist(),
            }
        text = json.dumps(rec, indent=1, default=str)
        if path is not None:
            p = pathlib.Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(text)
        return text
