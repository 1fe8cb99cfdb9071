"""Batched serving: prefill a prompt batch, then decode greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --batch 4 --prompt-len 16 --gen 32 [--layers 2 --d-model 256] \\
      [--device cpu]

The port of ``repro.launch.serve``: a reduced configuration of any of the
ten architectures (``--layers``, ``--d-model``) with random weights from a
seeded generator, on the card unless ``--device cpu``.  The model code is
the trainer's node-stacked forward run as a stack of one node.
:func:`prefill` and :func:`generate` also run one node split over M
model ranks (a ``tp`` seam, ``repro_torch.models.tp``): rank-row
parameters and caches, each token the argmax of the logits gathered over
the ranks, the same on every rank.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.models import transformer as TR
from repro_torch.models.tp import NO_TP


def _whole(tp, logits: torch.Tensor) -> torch.Tensor:
    """A node's rank-row logits (rows, B, Vp / M) -> its whole (B, Vp)."""
    return tp.first_of_node(tp.gather_last(logits))[0]


@torch.no_grad()
def prefill(cfg: TR.ModelConfig, sparams, prompt_tokens: torch.Tensor,
            S_max: int, extras: Optional[dict] = None, tp=NO_TP):
    """Teacher-forced pass over prompt (B, Tp) that fills a cache of S_max
    positions; ``sparams`` is node-stacked (one node; under a ``tp`` seam
    its rank-rows), ``extras`` have no node dim.  -> (logits of the last
    prompt position (B, Vp), gathered over the model ranks; cache)."""
    B = prompt_tokens.shape[0]
    cache = TR.init_cache(cfg, B, S_max, device=prompt_tokens.device,
                          tp=tp)
    batch = {"tokens": prompt_tokens, **(extras or {})}
    logits, cache, _ = TR.forward(
        cfg, sparams, tp.node_rows({k: v[None] for k, v in batch.items()}),
        mode="prefill", cache=cache, tp=tp)
    return _whole(tp, logits[:, :, -1]), cache


@torch.no_grad()
def generate(cfg: TR.ModelConfig, params, prompt_tokens: torch.Tensor,
             gen_len: int, extras: Optional[dict] = None, *,
             return_logits: bool = False, tp=NO_TP):
    """Greedy decode: prompt (B, Tp) -> (B, Tp + gen_len) tokens.
    ``params`` is one replica (``init_params``' tree, no node dim), or
    under a ``tp`` seam of M > 1 the process's rank-rows of one node
    (``convert.model_params_to_rank_rows``); ``extras`` the family's
    inputs without a node dim (``vision`` (B, n_vision_tokens, D),
    ``frames`` (B, S_enc, D)).  Each token is the argmax of the logits
    gathered over the model ranks.  ``return_logits`` also returns the
    logits each new token was taken from, (gen_len, B, Vp)."""
    B, Tp = prompt_tokens.shape
    sparams = params if tp.M > 1 else TR.stack_nodes(params)
    logits, cache = prefill(cfg, sparams, prompt_tokens, Tp + gen_len,
                            extras, tp)
    seen = [logits]
    next_tok = logits.argmax(-1)
    out = [next_tok]
    for i in range(gen_len - 1):
        logits, cache = TR.decode_step(
            cfg, sparams, cache, tp.node_rows(next_tok[None, :, None]),
            Tp + i, tp=tp)
        logits = _whole(tp, logits)
        seen.append(logits)
        next_tok = logits.argmax(-1)
        out.append(next_tok)
    tokens = torch.cat([prompt_tokens, torch.stack(out, dim=1)], dim=1)
    return (tokens, torch.stack(seen)) if return_logits else tokens


def main(argv=None):
    from repro_torch.api import resolve_device
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-1.7b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="default: the card (fails without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch).reduced(n_layers=args.layers,
                                         d_model=args.d_model)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    params = TR.init_params(cfg, g, device)
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=g, device=device)
    extras = {}
    g.manual_seed(2)
    if cfg.family == "vlm":
        extras["vision"] = torch.randn(
            (args.batch, cfg.n_vision_tokens, cfg.d_model), generator=g,
            device=device, dtype=cfg.dtype)
    if cfg.family == "encdec":
        extras["frames"] = torch.randn((args.batch, 8, cfg.d_model),
                                       generator=g, device=device,
                                       dtype=cfg.dtype)
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, args.gen, extras)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"arch={args.arch} generated {tuple(out.shape)} on {device} in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s)")
    print("sample:", out[0, :24].tolist())
    return out


if __name__ == "__main__":
    main()
