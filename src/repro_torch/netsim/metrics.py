"""Consensus error and exact bits-on-wire accounting for the dense engine.

The port of the static half of ``repro.netsim.metrics``; the trajectory
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
