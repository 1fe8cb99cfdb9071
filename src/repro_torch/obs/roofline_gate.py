"""Analytical rooflines of the wire kernels B3/B4, from exact byte counts.

The port of ``repro.obs.roofline_gate``.  :mod:`repro_torch.obs.roofline`
models the whole training step; this module models the *wire path* -- the
fused ``qinf_quantize_pack`` (B3) and ``qinf_unpack_dequant_mix`` (B4)
kernels and the ``pp`` exchanges between them -- from the **exact** byte
layout of :class:`repro_torch.core.bucket.BucketLayout`.  Nothing here is
estimated: the codes/scales byte counts are the integers
``BucketLayout.wire_bits`` pins and the recorded ``pp`` calls move.

Per-node, per-step traffic model (``elems`` = total quantization slots =
sum over groups of ``rows x block``; padding included -- padded lanes move
through HBM even though they never ship):

* quantize_pack -- reads the f32 blocked input and the matching U(0,1)
  noise (``2 x 4 x elems`` bytes), writes the packed codes + byte-cast
  scales (exactly ``codes_bytes + scales_bytes``).
* unpack_dequant_mix -- reads ``1 + hops`` received payload pairs, writes
  the f32 mix for each of ``receivers`` rows plus the f32 qself rows
  (``(receivers + 1) x 4 x elems``).  B4 also reads its (T, S) weight
  table, which this model leaves out (a few bytes a node).
* wire -- ``hops`` serial link transfers of ``codes_bytes + scales_bytes``
  each (the exact bits :func:`repro_torch.netsim.metrics.
  bucketed_payload_bits` counts).

A kernel launch covers every node of the stacked group, so its bound is
these bytes x the nodes it covers; on a model-sharded mesh a node is M
shards, each moving one shard's layout (``shards``).  Hardware constants
come from :mod:`repro_torch.obs.roofline` (one H100 SXM).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.bucket import BucketLayout
from repro_torch.obs.roofline import HBM_BW, LINK_BW


def _elems(layout: BucketLayout) -> int:
    return sum(g.rows * g.block for g in layout.groups)


def kernel_roofline(layout: BucketLayout, *, hops: int = 1,
                    receivers: int = 1, shards: int = 1
                    ) -> Dict[str, Dict[str, float]]:
    """Predicted HBM bytes and roofline seconds per kernel (one node, one
    COMM exchange).  See the module docstring for the traffic model.
    ``layout`` is one model shard's; a node's ``shards`` shards each move
    it."""
    elems = shards * _elems(layout)
    wire_bytes = shards * (layout.codes_bytes + layout.scales_bytes)
    qp_bytes = 2 * 4 * elems + wire_bytes
    um_bytes = (1 + hops) * wire_bytes + (receivers + 1) * 4 * elems
    return {
        "quantize_pack": {"hbm_bytes": float(qp_bytes),
                          "t_s": qp_bytes / HBM_BW},
        "unpack_dequant_mix": {"hbm_bytes": float(um_bytes),
                               "t_s": um_bytes / HBM_BW},
        "wire": {"bytes_per_hop": float(wire_bytes), "hops": float(hops),
                 "t_s": hops * wire_bytes / LINK_BW},
    }


def step_roofline(layout: BucketLayout, *, hops: int, receivers: int = 1,
                  shards: int = 1,
                  measured_step_s: Optional[float] = None) -> Dict:
    """Whole-exchange roofline: kernel + wire seconds, plus
    ``utilization = predicted / measured`` when a measured step time is
    given (1.0 = the exchange alone at its roofline would fill the
    step)."""
    k = kernel_roofline(layout, hops=hops, receivers=receivers,
                        shards=shards)
    wire_s = k["wire"]["t_s"]
    kernel_s = k["quantize_pack"]["t_s"] + k["unpack_dequant_mix"]["t_s"]
    out = {
        "predicted_step_s": kernel_s + wire_s,
        "predicted_kernel_s": kernel_s,
        "predicted_wire_s": wire_s,
        "wire_bytes_per_hop": k["wire"]["bytes_per_hop"],
        "kernels": k,
    }
    if measured_step_s:
        out["measured_step_s"] = float(measured_step_s)
        out["utilization"] = (kernel_s + wire_s) / measured_step_s
    return out


def trainer_wire_layout(trainer, leaves) -> Tuple[BucketLayout, int]:
    """(BucketLayout, model-shard redundancy) for a trainer's wire path:
    the layout of one model shard's local slices
    (:func:`repro_torch.netsim.metrics._model_local_shapes`; the
    trainer's ``_quant_block``, bits and scale width), so ``model x
    layout.wire_bits`` equals ``bucketed_payload_bits``.  ``leaves`` are
    the stacked (N, ...) ``plead.X`` leaves (``meta`` tensors will do).
    The redundancy is the mesh's model axis under the full-manual
    bucketed wire (a node's M shard payloads, all on this card), else
    1."""
    from repro_torch.core import bucket
    from repro_torch.netsim import metrics as netsim_metrics
    tcfg = trainer.tcfg
    model, locals_ = netsim_metrics._model_local_shapes(trainer, leaves)
    layout = bucket.compute_layout(
        [(1,) + tuple(s) for s in locals_],
        [leaf.dtype for leaf in leaves], bits=tcfg.bits,
        block_for=trainer._quant_block,
        scale_bytes=2 if tcfg.scales_bf16 else 4)
    return layout, model
