#!/usr/bin/env python3
"""Cost of a B1/B2 launch at the dense main path's shape, for one tree of
the PyTorch port, on one NVIDIA card.

    python3 launch_cost.py [--tree DIR] [--iters 20 200] [--label NAME]

Imports ``repro_torch.kernels.quantize`` and ``ops`` from ``DIR/src``
(default: this checkout), so that one yardstick -- the functions below
and ``chip_smoke.cuda_ms`` and ``device_us`` of this checkout -- times
this tree and another, for example the parent commit unpacked with ``git
archive``.  Run each tree in its own process, alternating (parent,
change, change, parent) within one machine.  At the main path's (248, 256) f32 rows, 2 bits, and on its
(8, 7840) f32 leaf, it measures:

1. ``cuda_ms``: CUDA-event milliseconds per call over N back-to-back calls
   (each N of ``--iters``) of B1's and B2's wrappers, of
   ``torch.mul(codes, scales)``, which computes B2's function, and of
   ``ops.qinf_quantize_lastdim`` on the leaf, the call the main path makes
   (in a tree that pads on the card: the pad, then B1).  At this size the
   device work is a few microseconds, so this reads how fast the host
   issues the calls; compare two trees only at one N.
2. ``host_us``: host microseconds per call over 10,000 calls
   (``time.perf_counter_ns``, fenced by ``torch.cuda.synchronize``) of the
   same four.
3. ``device_us``: device time a call from ``torch.profiler``
   (``chip_smoke.device_us``: the median over the largest N of
   ``--iters`` calls of the summed durations of the device operations a
   call makes) of B1's wrapper on the rows, of the leaf call, and of
   ``zero_`` on 248 floats, the launch floor.
4. ``profile``: ``torch.profiler`` with Python stacks over 1,000 calls of
   B2's wrapper and of the leaf call, microseconds per call by host event
   (Python function, ATen op, CUDA runtime call), inclusive, the 15
   largest below the call: where its host time goes.  Last, because the
   Python tracer leaves the process slower.

Prints the card's line from ``nvidia-smi`` and one JSON object, also
written to ``chiprun_out/launch_cost_<label>.json``.  Exits non-zero without a CUDA device.  Imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
SHAPE = (8 * 31, 256)      # the dense main path's B1/B2 rows
LEAF = (8, 7840)           # the dense main path's leaf: 8 nodes x 784x10
HOST_CALLS = 10_000
PROFILE_CALLS = 1_000


def host_us(torch, fn, n: int = HOST_CALLS) -> float:
    """Host microseconds per call of ``fn`` over ``n`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t0) / n / 1e3


def profile_us(torch, fn, calls: int = PROFILE_CALLS, top: int = 15):
    """Microseconds per call by host event under ``torch.profiler`` with
    Python stacks, inclusive, the ``top`` largest below ``fn`` (this
    script's frames, the profiler's and the closing synchronize left
    out)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    by_name = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in (
                "python_function", "cpu_op", "cuda_runtime", "cuda_driver")
                and not e["name"].startswith(("launch_cost.py",
                                              "torch/profiler"))
                and "ynchronize" not in e["name"]):
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [{"event": k[:100], "us_per_call": us / calls}
            for k, us in ranked]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=pathlib.Path, default=ROOT,
                    help="checkout whose src/repro_torch is measured")
    ap.add_argument("--iters", type=int, nargs="+", default=[20, 200],
                    help="back-to-back calls per cuda_ms reading")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("launch_cost: FAIL: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import cuda_ms, device_us, smi_line
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qk
    imported = pathlib.Path(qk.__file__).resolve()
    if tree not in imported.parents:
        print(f"launch_cost: FAIL: imported {imported}, not from {tree}",
              file=sys.stderr)
        return 1

    smi = smi_line()
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(SHAPE, generator=g, device="cuda")
    u = torch.rand(SHAPE, generator=g, device="cuda")
    codes, scales = qk.qinf_quantize_blocks(x, u, 2)
    out = qk.qinf_dequantize_blocks(codes, scales)
    if not torch.equal(out, torch.mul(codes, scales)):
        print("launch_cost: FAIL: B2 != torch.mul(codes, scales)",
              file=sys.stderr)
        return 1
    leaf = torch.randn(LEAF, generator=g, device="cuda")
    uleaf = torch.rand(ops.blockwise_shape(LEAF, SHAPE[1]), generator=g,
                       device="cuda")
    floor = torch.empty(SHAPE[0], device="cuda")
    calls = {"B1 wrapper": lambda: qk.qinf_quantize_blocks(x, u, 2),
             "B2 wrapper": lambda: qk.qinf_dequantize_blocks(codes, scales),
             "torch.mul(codes, scales)": lambda: torch.mul(codes, scales),
             "lastdim leaf": lambda: ops.qinf_quantize_lastdim(leaf, uleaf,
                                                               bits=2)}
    res = {"label": args.label, "tree": str(tree), "card": smi,
           "shape": list(SHAPE), "leaf": list(LEAF),
           "cuda_ms": {str(n): {k: cuda_ms(torch, f, iters=n)
                                for k, f in calls.items()}
                       for n in args.iters},
           "host_us": {k: host_us(torch, f) for k, f in calls.items()},
           "device_us": {k: device_us(torch, f, max(args.iters)) for k, f in (
               ("B1 wrapper", calls["B1 wrapper"]),
               ("lastdim leaf", calls["lastdim leaf"]),
               ("zero_ on 248 floats", floor.zero_))}}
    res["profile"] = {k: profile_us(torch, calls[k])
                      for k in ("B2 wrapper", "lastdim leaf")}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"launch_cost_{args.label}.json").write_text(
        json.dumps(res, indent=1))
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
