"""The four input shapes and the input specs per (arch, shape).

The port of ``repro.configs.shapes``.  A spec is a plain ``(shape tuple,
dtype)`` pair per input (the reference's are JAX abstract values).  Decode
shapes run ``decode_step`` (one new token against a pre-allocated cache of
seq_len); ``long_500k`` runs only for the sub-quadratic architectures
(SSM, hybrid, sliding window).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

Spec = Tuple[Tuple[int, ...], torch.dtype]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def applicable(cfg, shape: InputShape) -> Optional[str]:
    """None if the (arch, shape) pair runs; else a skip reason."""
    if shape.name == "long_500k":
        if cfg.family == "encdec":
            return "whisper decoder is bounded by its 448-token grammar"
        if not cfg.sub_quadratic:
            return ("pure full attention: 524k dense KV cache is not "
                    "sub-quadratic serving")
    return None


def train_input_specs(cfg, shape: InputShape, n_nodes: int
                      ) -> Dict[str, Spec]:
    """The node-stacked training batch: leading node dim."""
    if shape.global_batch % n_nodes:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {n_nodes} nodes")
    Bl = shape.global_batch // n_nodes
    T = shape.seq_len
    specs = {"tokens": ((n_nodes, Bl, T), torch.int64),
             "labels": ((n_nodes, Bl, T), torch.int64)}
    if cfg.family == "vlm":
        specs["vision"] = ((n_nodes, Bl, cfg.n_vision_tokens, cfg.d_model),
                           cfg.dtype)
    if cfg.family == "encdec":
        # positions split between encoder frames and decoder tokens
        enc = T // 2
        dec = T - enc
        specs = {"frames": ((n_nodes, Bl, enc, cfg.d_model), cfg.dtype),
                 "tokens": ((n_nodes, Bl, dec), torch.int64),
                 "labels": ((n_nodes, Bl, dec), torch.int64)}
    return specs


def serve_input_specs(cfg, shape: InputShape):
    """Inference specs (no node dim): a prefill batch, or a decode step's
    token, cache (shapes of ``init_cache`` less its node dim) and
    position."""
    from repro_torch import tree
    from repro_torch.models.transformer import init_cache
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "prefill":
        specs = {"tokens": ((B, S), torch.int64)}
        if cfg.family == "vlm":
            specs["vision"] = ((B, cfg.n_vision_tokens, cfg.d_model),
                               cfg.dtype)
        if cfg.family == "encdec":
            enc = min(S, 2 * cfg.max_source_positions)
            specs = {"frames": ((B, enc, cfg.d_model), cfg.dtype),
                     "tokens": ((B, S - enc), torch.int64)}
        return specs
    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    cache = tree.tree_map(lambda t: (tuple(t.shape[1:]), t.dtype),
                          init_cache(cfg, B, S, abstract=True))
    return {"tokens": ((B, 1), torch.int64), "cache": cache,
            "pos": ((), torch.int64)}
