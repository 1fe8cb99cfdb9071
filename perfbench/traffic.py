"""The one generator of the benchmark's inputs: a cell's file and its
configuration's file -> the program's spec, and from ``--seed`` the
weights, the bank of batches and the stochastic-rounding uniforms, made
on the device and handed alike to the program and to the reference.

A cell file (``perfbench/workloads/<cell>.json``) holds:

  config, traffic      the names ``BENCHMARK.json`` gives the cell
  nodes                decentralized nodes, all on the one card
  topology             the program's graph and schedule
  mixing_cycle         the reference's graphs, one a round of the cycle
  algorithm            Prox-LEAD's eta, alpha, gamma
  prox                 the shared regularizer (name, lam)
  compressor           QInf's bits and block
  local_batch          sequences a node a step
  seq_len              labelled tokens a sequence
  frames               encoder frames a sequence (0: none)
  bank                 distinct batches made at set-up, cycled
  checked_steps        the first steps, which the reference follows
  traced_steps         steps under the profiler with ``--trace 1``
  limits               the correctness limits (``perfbench/check.py``)

A configuration file (``perfbench/configs/<config>.json``) holds the
published keys as run, its ``family`` (the reference module of
``perfbench/reference``) and ``program``: the program's architecture id,
which of its model fields each published key sets, and its other
fields.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
from typing import Dict, List

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


class UnknownName(ValueError):
    """A cell, configuration or metric that ``BENCHMARK.json`` lacks."""


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(name: str, bench: dict):
    """(workload entry, cell file, config entry, config file) of cell
    ``name``."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise UnknownName(f"no cell {name!r}; BENCHMARK.json has "
                          f"{[w['name'] for w in bench['workloads']]}")
    cell = json.loads((ROOT / "perfbench" / "workloads"
                       / f"{name}.json").read_text())
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise ValueError(f"cell file {name}.json names {cell['config']}/"
                         f"{cell['traffic']}, BENCHMARK.json "
                         f"{entry['config']}/{entry['traffic']}")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]),
                None)
    if conf is None:
        raise UnknownName(f"cell {name!r} names configuration "
                          f"{entry['config']!r}, which BENCHMARK.json lacks")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    return entry, cell, conf, cfg


def reference_model(cfg: dict):
    """The plain reference module of the configuration's family."""
    import importlib
    return importlib.import_module(f"perfbench.reference.{cfg['family']}")


def sub_seed(seed: int, *tag) -> int:
    """A 63-bit seed from ``seed`` and a tag: one stream per use."""
    text = ":".join(str(t) for t in (seed,) + tag).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


def generator(seed: int, device, *tag) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tag))
    return g


def program_spec(api, cell: dict, cfg: dict):
    """The cell as the program's ``ExperimentSpec``: the model's fields
    from the configuration's published keys (``program.keys``), then
    ``program.params``."""
    prog = cfg["program"]
    params = {field: cfg[key] for key, fields in prog["keys"].items()
              for field in fields}
    params.update(prog["params"])
    model = api.ModelSpec(arch=prog["arch"], full=True,
                          local_batch=cell["local_batch"],
                          seq_len=cell["seq_len"], params=params)
    alg, comp = cell["algorithm"], cell["compressor"]
    return api.ExperimentSpec(
        name=f"{cell['config']}.{cell['traffic']}", n_nodes=cell["nodes"],
        algorithm=api.AlgorithmSpec("prox_lead", eta=api.constant(alg["eta"]),
                                    alpha=api.constant(alg["alpha"]),
                                    gamma=api.constant(alg["gamma"])),
        compressor=api.CompressorSpec("qinf", {"bits": comp["bits"],
                                               "block": comp["block"]}),
        topology=api.TopologySpec(**cell["topology"]),
        prox=api.ProxSpec(cell["prox"]["name"], {"lam": cell["prox"]["lam"]}),
        model=model,
        execution=api.ExecutionSpec(engine="sharded", backend="neighbor",
                                    wire_mode="bucketed"))


def make_weights(leaves, seed: int, device) -> List[torch.Tensor]:
    """One replica's leaves: every normal leaf from ONE draw of standard
    normals on ``device`` (scaled by 1 / sqrt(fan)), ones and zeros
    where the leaf's kind says."""
    n = sum(int(torch.Size(s["shape"]).numel()) for _, s in leaves
            if s["kind"] == "normal")
    flat = torch.randn(n, generator=generator(seed, device, "weights"),
                       device=device)
    out, off = [], 0
    for _, s in leaves:
        shape = s["shape"]
        if s["kind"] == "normal":
            k = int(torch.Size(shape).numel())
            out.append(flat[off:off + k].view(shape).mul_(s["fan"] ** -0.5))
            off += k
        elif s["kind"] == "ones":
            out.append(torch.ones(shape, device=device))
        else:
            out.append(torch.zeros(shape, device=device))
    return out


def make_bank(cell: dict, cfg: dict, seed: int, device) -> List[Dict]:
    """``bank`` distinct batches of every node: ``tokens`` and their
    next-token ``labels`` (nodes, local_batch, seq_len) drawn uniformly
    from the vocabulary, and ``frames`` (nodes, local_batch, frames,
    width) standard normals where the cell has frames."""
    K, N, B, T = cell["bank"], cell["nodes"], cell["local_batch"], \
        cell["seq_len"]
    seq = torch.randint(0, cfg["vocab_size"], (K, N, B, T + 1),
                        generator=generator(seed, device, "tokens"),
                        device=device)
    bank = [{"tokens": seq[k, ..., :-1].contiguous(),
             "labels": seq[k, ..., 1:].contiguous()} for k in range(K)]
    if cell["frames"]:
        g = generator(seed, device, "frames")
        for b in bank:
            b["frames"] = torch.randn(
                (N, B, cell["frames"], cfg["d_model"]), generator=g,
                device=device)
    return bank


def noise(seed: int, call: int, shape, device, out=None) -> torch.Tensor:
    """The ``call``-th uniform draw of a run, U[0, 1) of ``shape`` (into
    ``out`` when given): row n of the leading (node) dim is node n's own
    stream, whatever came before and whatever the memory layout of
    ``out`` -- a draw into a strided view that spans 2 GiB or more is cut
    by ATen into pieces of other numbers, so each node draws its row
    where it stays below that (into a fresh row and copies it where it
    does not)."""
    if out is None:
        out = torch.empty(tuple(shape), device=device)
    for n in range(out.shape[0]):
        row = out[n]
        g = generator(seed, device, "noise", call, n)
        span = sum((d - 1) * st for d, st in zip(row.shape, row.stride()))
        if (span + 1) * row.element_size() < 2 ** 31:
            row.uniform_(0.0, 1.0, generator=g)
        else:
            row.copy_(torch.empty(row.shape, device=device).uniform_(
                0.0, 1.0, generator=g))
    return out


def draws(seed: int, device):
    """The program's draw source: every ``uniform`` the program asks for
    is :func:`noise` of the next call, drawn straight into the buffer it
    hands over."""
    from repro_torch.core.draws import Draws

    class BenchDraws(Draws):
        calls = 0

        def uniform(self, shape, out=None, dtype=torch.float32, low=0.0,
                    high=1.0):
            if dtype != torch.float32 or (low, high) != (0.0, 1.0):
                raise ValueError("the benchmark draws U[0, 1) f32 only")
            call, self.calls = self.calls, self.calls + 1
            return noise(seed, call, shape, device, out)

    return BenchDraws()


def label_tokens(cell: dict) -> int:
    """Labelled tokens a step over every node."""
    return cell["nodes"] * cell["local_batch"] * cell["seq_len"]


def stream_tokens(cell: dict) -> Dict[str, int]:
    return {"labels": label_tokens(cell),
            "frames": cell["nodes"] * cell["local_batch"] * cell["frames"]}

