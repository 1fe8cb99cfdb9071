"""Consensus error and exact bits-on-wire accounting.

The port of the static half of ``repro.netsim.metrics``: the dense
engine's payload bits and the neighbor-gossip backend's u8 wire bits (the
model-shard factor is 1: one card holds every node whole).  The trajectory
containers and fault-exact accounting arrive with the netsim slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.compression import Compressor, Identity
from repro_torch.tree import leaves


def consensus_error(X) -> torch.Tensor:
    """sum_leaves || X - mean_node(X) ||_F^2 over the leading node dim."""
    return sum(((l - l.mean(0, keepdim=True)) ** 2).sum() for l in leaves(X))


def payload_bits_per_node(compressor: Optional[Compressor], X) -> int:
    """Exact wire bits ONE node sends to ONE neighbour per COMM round,
    summed over leaves (leaves carry a leading node dim).  Uncompressed
    leaves are priced as f32, as in the reference."""
    bits = 0
    for leaf in leaves(X):
        shape = tuple(leaf.shape[1:])
        if compressor is None or isinstance(compressor, Identity):
            bits += int(np.prod(shape, dtype=np.int64)) * 32
        else:
            bits += int(compressor.payload_bits(shape))
    return bits


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


def sharded_payload_bits(trainer, leaves) -> int:
    """Exact bits ONE directed edge carries per hop on the neighbor
    backend: packed u8 codes (with block padding) plus byte-cast scales,
    summed over state leaves (raw leaves under identity compression).
    ``leaves`` are node-stacked (N, ...) tensors (``meta`` tensors will do)
    in ``plead.X`` order; the per-edge payload is the per-node slice.
    Valid for both wire modes: the bucketed buffers concatenate exactly the
    per-leaf payloads (:func:`bucketed_payload_bits`)."""
    tcfg = trainer.tcfg
    scale_bits = 16 if tcfg.scales_bf16 else 32
    total = 0
    for leaf in leaves:
        local = tuple(leaf.shape[1:])
        if isinstance(trainer.compressor, Identity):
            total += (int(np.prod(local, dtype=np.int64))
                      * leaf.element_size() * 8)
        else:
            blk = trainer._quant_block((1,) + local)
            total += qinf_wire_bits(local, tcfg.bits, blk, scale_bits)
    return total


def bucketed_payload_bits(trainer, leaves) -> int:
    """Exact bits ONE directed edge carries per hop with
    ``wire_mode='bucketed'``, from the static BucketLayout: the flat
    packed-codes buffer plus the flat byte-cast-scales buffer.  Equal to
    :func:`sharded_payload_bits`; under identity compression the per-leaf
    path runs, so its count is returned."""
    from repro_torch.core import bucket
    if isinstance(trainer.compressor, Identity):
        return sharded_payload_bits(trainer, leaves)
    tcfg = trainer.tcfg
    layout = bucket.compute_layout(
        [(1,) + tuple(leaf.shape[1:]) for leaf in leaves],
        [leaf.dtype for leaf in leaves], bits=tcfg.bits,
        block_for=trainer._quant_block,
        scale_bytes=2 if tcfg.scales_bf16 else 4)
    return layout.wire_bits
