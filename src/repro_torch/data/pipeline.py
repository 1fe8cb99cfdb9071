"""Node-stacked batch iterator for decentralized LM training.

The port of ``repro.data.pipeline.DecentralizedBatches``.  Every node
draws from its OWN deterministic stream, a ``torch.Generator`` seeded by
(seed, node, step), so batches are heterogeneous by construction: with
``heterogeneous`` each node's tokens fall in its own half-vocab window
(the analogue of the paper's label-sorted split).  The vlm family's batches also carry ``vision``
(N, B, n_vision_tokens, d_model) and the encdec family's ``frames`` (N, B,
max(seq_len // 2, 4), d_model): standard normals in the model dtype, from
a generator seeded by (seed, family salt, step), as the reference draws
them from ``key(seed + salt + step)`` (salt 17 and 23).  Torch's generator
never draws JAX's threefry values, so parity tests hand both packages the
same batch arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.transformer import FAMILIES


#: the reference's key salts of the vision and frames draws
EXTRA_SALT = {"vlm": 17, "encdec": 23}


def node_stream_generator(seed: int, node: int, step: int,
                          *extra: int) -> torch.Generator:
    """A CPU generator seeded by (seed, node, step, *extra)."""
    state = np.random.SeedSequence((int(seed), int(node), int(step))
                                   + tuple(int(e) for e in extra))
    g = torch.Generator()
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g


def _bigram_scan(first, noise, use_rule, vocab: int):
    """tokens[t] = (tokens[t-1] * 31 + 7) % vocab where ``use_rule``, else
    ``noise``; over the last axis, from ``first`` (..., 1)."""
    toks = torch.empty(noise.shape, dtype=torch.int64)
    prev = first[..., 0]
    for t in range(noise.shape[-1]):
        prev = torch.where(use_rule[..., t], (prev * 31 + 7) % vocab,
                           noise[..., t])
        toks[..., t] = prev
    return torch.cat([first, toks[..., :-1]], dim=-1), toks


def _draw(generator: torch.Generator, batch: int, seq_len: int, vocab: int,
          structure: float):
    first = torch.randint(0, vocab, (batch, 1), generator=generator)
    noise = torch.randint(0, vocab, (batch, seq_len), generator=generator)
    use_rule = torch.rand((batch, seq_len), generator=generator) < structure
    return first, noise, use_rule


def token_batch(generator: torch.Generator, batch: int, seq_len: int,
                vocab: int, structure: float = 0.7):
    """Structured random tokens: next token = (prev * 31 + 7) % vocab with
    probability ``structure`` (a learnable deterministic bigram), else
    uniform.  Returns (tokens, labels) (batch, seq_len) int64 with labels
    the next-token targets (the reference's rule)."""
    return _bigram_scan(*_draw(generator, batch, seq_len, vocab, structure),
                        vocab)


@dataclasses.dataclass
class DecentralizedBatches:
    """Infinite iterator of node-stacked batches: {"tokens", "labels"},
    each (n_nodes, local_batch, seq_len) int64 on ``device``, and the
    family's extras (``vision`` / ``frames``, ``dtype``)."""
    n_nodes: int
    local_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    heterogeneous: bool = True
    family: str = "dense"
    n_vision_tokens: int = 0
    d_model: int = 0
    dtype: torch.dtype = torch.float32
    device: str = "cpu"

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown model family {self.family!r}; have "
                             f"{FAMILIES}")

    def extras_at(self, step: int):
        """The family's model inputs besides tokens at ``step``."""
        shape = {"vlm": ("vision", self.n_vision_tokens),
                 "encdec": ("frames", max(self.seq_len // 2, 4))}
        if self.family not in shape:
            return {}
        name, n = shape[self.family]
        g = node_stream_generator(self.seed, EXTRA_SALT[self.family], step,
                                  1)
        x = torch.randn((self.n_nodes, self.local_batch, n, self.d_model),
                        generator=g)
        return {name: x.to(device=self.device, dtype=self.dtype)}

    def batch_at(self, step: int):
        draws = [_draw(node_stream_generator(self.seed, node, step),
                       self.local_batch, self.seq_len, self.vocab, 0.7)
                 for node in range(self.n_nodes)]
        tokens, labels = _bigram_scan(*(torch.stack(a) for a in zip(*draws)),
                                      self.vocab)          # one scan, all nodes
        if self.heterogeneous:
            node = torch.arange(self.n_nodes)[:, None, None]
            off = (node * self.vocab) // max(self.n_nodes, 1)
            half = max(self.vocab // 2, 1)
            tokens = (off + tokens % half) % self.vocab
            labels = (off + labels % half) % self.vocab
        return {"tokens": tokens.to(self.device),
                "labels": labels.to(self.device), **self.extras_at(step)}

    def __iter__(self) -> Iterator:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
