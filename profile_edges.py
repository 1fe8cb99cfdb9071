#!/usr/bin/env python3
"""Whether a ``torch.profiler`` window loses device events at its edges,
for the PyTorch port on one NVIDIA card.

    python3 profile_edges.py [--windows 60] [--steps 50] [--guard-ms 0 50]

Runs the Fig. 1 LEAD (2bit) row of ``repro_torch.paper`` (the window that
``chip_smoke.py`` requires one B1 launch a step of) under the profiler,
``--windows`` windows of ``--steps`` steps for each guard of
``--guard-ms``, the guards taken in turn.  A guard is an idle stretch (a
host sleep, no device work) inside the window before the first step and
after the last.  For each window, from the exported trace:

- ``b1``: B1 events, against ``steps`` (one launch a step);
- ``launch_calls``/``device_events``: host launch calls (kernel, memcpy,
  memset) and the device events that carry their correlation ids;
- ``missing``: launch calls with no device event, and where each sat in
  the window's run of launch calls (0 the first, 1 the last);
- ``lag_us``: the least and the largest of a device event's start minus
  its launch call's start.  A negative least lag is a device clock read
  behind the host's.

Prints one line a window and, as the last line, a JSON object with the
counts per guard; writes every window to ``chiprun_out/profile_edges.json``.
"""

import argparse
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "profile_edges.json"
LAUNCH_CALLS = ("LaunchKernel", "Memcpy", "Memset")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def window(torch, runner, st, draws, steps: int, guard_s: float, b1_re):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(guard_s)
        for _ in range(steps):
            st = runner.step(st, draws)
        torch.cuda.synchronize()
        time.sleep(guard_s)
    with tempfile.TemporaryDirectory() as tmp:
        trace = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    calls = sorted((e for e in xs if e.get("cat") in ("cuda_runtime",
                                                      "cuda_driver")
                    and any(k in e.get("name", "") for k in LAUNCH_CALLS)),
                   key=lambda e: e["ts"])
    on_device = {e.get("args", {}).get("correlation"): e for e in device}
    lags, missing = [], []
    for i, c in enumerate(calls):
        d = on_device.get(c.get("args", {}).get("correlation"))
        if d is None:
            missing.append(round(i / max(1, len(calls) - 1), 3))
        else:
            lags.append(d["ts"] - c["ts"])
    return st, {"b1": sum(1 for e in device if b1_re.search(e["name"])),
                "launch_calls": len(calls), "device_events": len(device),
                "missing": missing,
                "lag_us": [min(lags), max(lags)] if lags else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=60)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--guard-ms", type=float, nargs="+", default=[0.0, 50.0])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_edges: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch import api
    from repro_torch.core import draws as draws_mod
    from repro_torch.kernels import quantize as qk
    from repro_torch.paper import common as cm
    from repro_torch.paper import fig1_smooth
    qk.build()
    chip_smoke.warm_profiler(torch)
    L = cm.estimate_L(cm.flat_logreg(device="cpu"))
    eta = 1.0 / (2 * L)
    spec = dict(fig1_smooth.cells(20, eta, eta / 3))["LEAD (2bit)"]
    runner = api.build(spec, device="cuda", dtype=torch.float64)
    d = draws_mod.GeneratorDraws(spec.seed, "cuda")
    st = runner.init_state(d)
    for _ in range(5):
        st = runner.step(st, d)
    smi = chip_smoke.smi_line()
    rows = []
    for w in range(args.windows):
        for g in args.guard_ms:
            st, r = window(torch, runner, st, d, args.steps, g / 1e3,
                           chip_smoke.B1_KERNEL)
            r.update(window=w, guard_ms=g)
            rows.append(r)
            print(json.dumps(r), flush=True)
    summary = {}
    for g in args.guard_ms:
        rs = [r for r in rows if r["guard_ms"] == g]
        summary[str(g)] = {
            "windows": len(rs),
            "b1_short": sum(r["b1"] != args.steps for r in rs),
            "windows_missing_events": sum(bool(r["missing"]) for r in rs),
            "events_missing": sum(len(r["missing"]) for r in rs),
            "least_lag_us": min(r["lag_us"][0] for r in rs if r["lag_us"])}
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps({"card": smi, "steps": args.steps,
                               "rows": rows, "summary": summary}, indent=1))
    print(smi)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
