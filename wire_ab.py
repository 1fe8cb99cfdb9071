#!/usr/bin/env python3
"""B4 at the trainers' shapes and the alternating trainer's step, for one
tree of the PyTorch port, on one NVIDIA card.

    python3 wire_ab.py [--tree DIR] [--label NAME] [--trainer]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and
times it with this checkout's ``chip_smoke.py`` as the one yardstick, so
that a tree and another -- for example the parent commit unpacked with
``git archive`` -- are read alike.  Run each tree in its own process,
alternating (parent, change, change, parent) within one machine: the
host-timed step moves between calls.  It measures:

1. B4 (``qinf_unpack_dequant_mix_blocks``), f32 out, 2 bits, at the ring
   trainer's block-256 group (8 x 3 x 700,456 rows of 256, T = 1, ring
   payloads, weights 1/3), the alternating trainer's (8 x 6 x 700,456,
   T = 2, ``chip_smoke.alternating_payloads``) and mixtral-8x7b's router
   group (8 x 3 x 131,072 rows of 8, T = 1): CUDA-event ms a call
   (``chip_smoke.cuda_ms``), the kernel the call launched (its name in a
   ``torch.profiler`` window: the vector or the row variant), mix and
   qself held to the plain version (``chip_smoke.check_b4``: equal).
2. With ``--trainer``, phase 6b of ``chip_smoke.py``: the qwen3-1.7b
   slice under ``schedule='alternating'`` (``chip_smoke.trainer_path``,
   30 steps and 3 profiled ones, no audit): median and least step ms,
   the peak allocation, bits a step a node, the loss of every step, and
   the wire's device ms a step with its parts (``chip_smoke.
   wire_breakdown`` over the tree's own ``wire/`` phases; a tree older
   than the phases has none, and its trainer part stops at the check
   that the profile saw the wire).

Prints the card's line from ``nvidia-smi`` and one JSON object, also
written to ``chiprun_out/wire_ab_<label>.json``.  Exits non-zero without a
CUDA device.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
B4 = "qinf_unpack_dequant_mix_blocks"
ROUTER_ROWS, ROUTER_BLOCK = 131_072, 8      # mixtral-8x7b's router group


def launched_kernels(torch, fn) -> list:
    """Names of the device kernels one call of ``fn`` launches (the
    profiler's trace, in ``chip_smoke.profiled``'s guarded window)."""
    import tempfile
    import chip_smoke as cs
    with cs.profiled(torch) as prof:
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        trace = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    return sorted({e["name"] for e in events if e.get("cat") == "kernel"})


def b4_case(cs, torch, qk, ref, P, Sc, w, plain_iters: int = 3) -> dict:
    """B4 on (P, Sc, w), f32 out, 2 bits: checked against the plain
    version, timed, its kernel named."""
    errs = {B4: 0.0}
    got = qk.qinf_unpack_dequant_mix_blocks(P, Sc, w, 2)
    cs.check_b4(torch, ref, P, Sc, w, 2, torch.float32, got, errs,
                f"at {list(P.shape)}")
    del got
    names = launched_kernels(
        torch, lambda: qk.qinf_unpack_dequant_mix_blocks(P, Sc, w, 2))
    cs.require(len(names) == 1 and "unpack_dequant_mix" in names[0],
               f"one B4 kernel a call, got {names}")
    ms = cs.cuda_ms(torch, lambda: qk.qinf_unpack_dequant_mix_blocks(
        P, Sc, w, 2))
    plain = cs.cuda_ms(torch, lambda: ref.qinf_unpack_dequant_mix_blocks_ref(
        P, Sc, w, 2), iters=plain_iters, warmup=1)
    torch.cuda.empty_cache()
    return {"rows": list(P.shape), "T": w.shape[1], "kernel": names[0],
            "variant": "vector" if "_vec_" in names[0] else "row",
            "ms": ms, "plain_ms": plain, "max_abs_err": errs[B4]}


def ring_case(cs, torch, qk, ref, block: int, rows: int, n_nodes: int = 8):
    """B4 on the ring payloads (S = 3, T = 1, weights 1/3) of B3's bytes
    of random (n_nodes x rows, block) rows."""
    g = torch.Generator(device="cuda").manual_seed(block)
    x = torch.randn((n_nodes * rows, block), generator=g, device="cuda")
    u = torch.rand(x.shape, generator=g, device="cuda")
    packed, scales = qk.qinf_quantize_pack_blocks(x, u, 2)
    del x, u
    P, Sc = cs.ring_payloads(torch, packed, scales, n_nodes, rows)
    del packed, scales
    w = torch.full((n_nodes, 1, 3), 1.0 / 3.0, device="cuda")
    return b4_case(cs, torch, qk, ref, P, Sc, w)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--trainer", action="store_true")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("wire_ab.py: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import ref
    from repro_torch.core import draws as draws_mod
    cs.require(pathlib.Path(qk.__file__).resolve().is_relative_to(tree),
               f"repro_torch came from {qk.__file__}, not {tree}")
    smi = cs.smi_line()
    t0 = time.perf_counter()
    qk.build()
    out = {"label": args.label, "tree": str(tree), "card": smi,
           "build_s": time.perf_counter() - t0}
    cs.warm_profiler(torch)
    out["ring_t1"] = ring_case(cs, torch, qk, ref, 256, cs.SLICE_GROUP_ROWS)
    P, Po, Sc, w = cs.alternating_payloads(torch, qk)
    del Po
    out["alternating_t2"] = b4_case(cs, torch, qk, ref, P, Sc, w)
    del P, Sc, w
    out["router"] = ring_case(cs, torch, qk, ref, ROUTER_BLOCK, ROUTER_ROWS)
    for k in ("ring_t1", "alternating_t2", "router"):
        v = out[k]
        print(f"[ab {args.label}] B4 @ {v['rows']} T={v['T']}: "
              f"{v['ms']:.4f} ms ({v['variant']}: {v['kernel'][:60]}), "
              f"plain {v['plain_ms']:.4f}, bit-equal | {smi}", flush=True)
    if args.trainer:
        torch.cuda.empty_cache()
        ss = cs.trainer_path(
            torch, api, draws_mod, qk, profile_steps=cs.SLICE_PROFILE_STEPS,
            spec=cs.slice_spec(api, cs.SLICE_STEPS, schedule="alternating"),
            hops=cs.SCHEDULED_HOPS, audit=False,
            trace_name=f"wire_ab_{args.label}_trace.json")
        pf = ss["profile"]
        out["trainer"] = {
            "spec": ss["spec"], "steps": ss["steps"],
            "step_ms_median": ss["step_ms_median"],
            "step_ms_min": ss["step_ms_min"], "peak_mem_gb": ss["peak_mem_gb"],
            "bits_per_step": ss["bits_per_step"], "launches": ss["launches"],
            "loss": [p["loss"] for p in ss["trace"]],
            "device_ms_per_step": pf["device_ms_per_step"],
            "wire_ms_per_step": pf["wire_ms_per_step"],
            "wire": {k: v["ms_per_step"] for k, v in pf["wire"].items()}}
        tr = out["trainer"]
        print(f"[ab {args.label}] {tr['spec']}: step {tr['step_ms_median']:.1f}"
              f" ms median ({tr['step_ms_min']:.1f} min), peak "
              f"{tr['peak_mem_gb']:.2f} GiB, {tr['bits_per_step']:.0f} "
              f"bits/step/node, loss {tr['loss'][0]:.6f} -> "
              f"{tr['loss'][-1]:.6f}; wire {tr['wire_ms_per_step']:.3f} of "
              f"{tr['device_ms_per_step']:.1f} device ms/step "
              f"{ {k: round(v, 3) for k, v in tr['wire'].items()} } | {smi}",
              flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"wire_ab_{args.label}.json").write_text(
        json.dumps(out, indent=1))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
