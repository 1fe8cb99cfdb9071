#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. Environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.
2. Build: compiles ``src/repro_torch/kernels/csrc/qinf.cu`` with nvcc for
   sm_90a (kernels B1 quantize and B2 dequantize).
3. Kernels against their plain PyTorch versions on the card, same x and u:
   bits {1,2,3,4,7}, x in f32 and bf16, at the main path's shape
   (8 nodes x 7840 -> (8*31, 256) blocks), ragged last dims (3, 7, 11) and
   (129,), a block of zeros, and (8, 12_582_912) (8 nodes x one 2048x6144
   matrix, ~400 MB per f32 operand).  Codes, scales and dequantized values
   must be exactly equal.  Each kernel, its plain version and, where one
   exists, the single PyTorch call computing the same function are timed
   with CUDA events at the main path's shape and at the large shape.
4. The main path: ``repro_torch.api.build(spec)`` on the card for the
   quickstart spec at MNIST scale (8 nodes x 7500 samples, 784 features,
   10 classes, f32).  First 20 steps, each started from the card's state
   and held against one step of the port's plain CPU path with the same
   draws from a seeded CPU generator: X must agree to 1e-4 x max|X| on all
   but 0.1 % of its elements (an element may differ where a stochastic-
   rounding code sits on an f32 rounding boundary; the products sum in
   another order on the card).  Then a run of STEPS steps with the launch
   counters zeroed just before and read just after (B1 and B2 must each
   launch once per step), an objective f + lam ||x||_1 that must fall, a
   consensus error that must shrink, finite values.
5. Result lines: ``{"kernels": [...]}``, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.  Everything is also written to
   ``chiprun_out/chip_smoke.json``.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

STEPS = 300              # main-path steps with counters on
REPLAY_STEPS = 20        # steps held against the plain CPU path
REPLAY_ELEM_TOL = 1e-4   # an element of X agrees within this x max|X| ...
REPLAY_MAX_OFF = 1e-3    # ... except at most this fraction of X per step
LARGE = (8, 12_582_912)  # 8 nodes x 2048*6144 parameters
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
B1_OPS_PER_ELEMENT = 10     # |x|, max, mul, div, add, floor, min, sign, mul, cvt
B2_OPS_PER_ELEMENT = 2      # cvt, mul
PROFILE_STEPS = 20          # main-path steps under torch.profiler


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    require(r.returncode == 0 and r.stdout.strip(),
            f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: int, ops: int):
    """(least time in ms, "bytes" or "operations") on an H100 SXM."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --- phase 3 -------------------------------------------------------------------

def check_kernels(torch, ops, qk, ref, errs):
    """Kernel vs plain version on every case; records the largest
    difference per kernel in ``errs`` and fails on any."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {"main": (8, 7840), "ragged3d": (3, 7, 11), "ragged1d": (129,),
             "zero_block": (8, 256), "large": LARGE}
    n_checked = 0
    for label, shape in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
            if label == "zero_block":
                x[3] = 0
            u = torch.rand(ops.blockwise_shape(shape, 256), generator=g,
                           device="cuda")
            xb = ops.blockwise_lastdim(x, block=256).reshape(-1, 256)
            for bits in (1, 2, 3, 4, 7):
                ck, sk = ops.qinf_quantize_lastdim(x, u, bits=bits, block=256)
                cp, sp = ref.qinf_quantize_blocks_ref(xb, u.reshape(-1, 256),
                                                      bits)
                ck, sk = ck.reshape(-1, 256), sk.reshape(-1, 1)
                e1 = max(float((ck.int() - cp.int()).abs().max()),
                         float((sk - sp).abs().max()))
                errs["qinf_quantize_blocks"] = max(
                    errs["qinf_quantize_blocks"], e1)
                require(torch.equal(ck, cp) and torch.equal(sk, sp),
                        f"B1 != plain at {label} {dtype} bits={bits} "
                        f"(max diff {e1})")
                for out in {torch.float32, dtype}:
                    dk = qk.qinf_dequantize_blocks(ck, sk, out)
                    dp = ref.qinf_dequantize_blocks_ref(cp, sp, out)
                    e2 = float((dk.float() - dp.float()).abs().max())
                    errs["qinf_dequantize_blocks"] = max(
                        errs["qinf_dequantize_blocks"], e2)
                    require(torch.equal(dk, dp),
                            f"B2 != plain at {label} {dtype}->{out} "
                            f"bits={bits} (max diff {e2})")
                if label == "zero_block":
                    require(float(sk[3].abs().max()) == 0.0
                            and int(ck[3].abs().max()) == 0,
                            "an all-zero block must give scale 0, codes 0")
                n_checked += 1
            del x, u, xb, ck, sk, cp, sp
    torch.cuda.synchronize()
    return n_checked


def time_kernels(torch, qk, ref, shape):
    """Times of B1/B2, their plain versions and the library call, f32 x,
    bits=2, at ``shape`` viewed as (R, 256) rows."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, generator=g, device="cuda").reshape(-1, 256)
    u = torch.rand(x.shape, generator=g, device="cuda")
    codes, scales = qk.qinf_quantize_blocks(x, u, 2)
    out = qk.qinf_dequantize_blocks(codes, scales)
    lib = torch.mul(codes, scales)
    require(lib.dtype == torch.float32 and torch.equal(lib, out),
            "torch.mul(codes, scales) must compute B2's function")
    n = x.numel()
    b1_bound = bound_ms(nbytes(x, u, codes, scales), B1_OPS_PER_ELEMENT * n)
    b2_bound = bound_ms(nbytes(codes, scales, out), B2_OPS_PER_ELEMENT * n)
    res = {
        "qinf_quantize_blocks": {
            "rows": list(x.shape),
            "ms": cuda_ms(torch, lambda: qk.qinf_quantize_blocks(x, u, 2)),
            "plain_ms": cuda_ms(
                torch, lambda: ref.qinf_quantize_blocks_ref(x, u, 2)),
            "bound_ms": b1_bound[0], "bound_by": b1_bound[1],
            "library_ms": None},
        "qinf_dequantize_blocks": {
            "rows": list(x.shape),
            "ms": cuda_ms(torch, lambda: qk.qinf_dequantize_blocks(codes,
                                                                   scales)),
            "plain_ms": cuda_ms(
                torch, lambda: ref.qinf_dequantize_blocks_ref(codes, scales)),
            "bound_ms": b2_bound[0], "bound_by": b2_bound[1],
            "library_ms": cuda_ms(torch, lambda: torch.mul(codes, scales))},
    }
    del x, u, codes, scales, out, lib
    return res


# --- phase 4 -------------------------------------------------------------------

def mnist_spec(api, steps: int):
    """examples/quickstart.py's spec at MNIST scale: 8 x 7500 = 60,000
    samples, 784 features, 10 classes, 15 batches of 500 per node."""
    return api.ExperimentSpec(
        name="quickstart-mnist-scale", n_nodes=8, steps=steps,
        algorithm=api.AlgorithmSpec("prox_lead", eta=api.constant(0.05),
                                    alpha=api.constant(0.5),
                                    gamma=api.constant(1.0)),
        compressor=api.CompressorSpec("qinf", {"bits": 2, "block": 256}),
        topology=api.TopologySpec(graph="ring"),
        prox=api.ProxSpec("l1", {"lam": 0.005}),
        oracle=api.OracleSpec(
            name="saga", problem="logreg",
            problem_params={"n_features": 784, "n_classes": 10,
                            "n_per_node": 7500, "n_batches": 15,
                            "lam2": 0.005}))


def profile_steps(torch, runner, st, draws, steps: int = PROFILE_STEPS):
    """Where a step's time goes: ``torch.profiler`` over ``steps`` steps;
    device time is the sum of the kernel, memcpy and memset spans of the
    exported trace, the busy share that sum over the fenced wall time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            st = runner.step(st, draws)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    OUT_DIR.mkdir(exist_ok=True)
    trace = OUT_DIR / "main_path_trace.json"
    prof.export_chrome_trace(str(trace))
    device = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    require(bool(device), "the profiler saw no device work in the main path")
    by_name = {}
    for e in device:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms / steps,
            "busy_share": busy_ms / wall_ms,
            "device_ops_per_step": len(device) / steps,
            "top": [{"name": k[:80], "ms_per_step": ms / steps,
                     "per_step": n / steps} for k, (ms, n) in top]}


def main_path(torch, api, convert, draws_mod, metrics, qk):
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    spec = mnist_spec(api, STEPS)
    lam = spec.prox.params["lam"]

    # (a) the card against the plain CPU path, same draws.  Teacher-forced:
    # every step starts both from the card's state, so one step's rounding
    # (f32 products summed in another order) cannot compound; an element
    # may still differ where a stochastic-rounding code sits on an f32
    # rounding boundary.  The free-running CPU trajectory is reported too.
    t0 = time.perf_counter()
    cpu = api.build(spec, device="cpu")
    runner = api.build(spec)                       # the default: the card
    require(runner.device.type == "cuda", "build(spec) did not pick cuda")
    data_mb = sum(nbytes(t) for t in runner.problem.data.values()) / 2 ** 20
    gen = draws_mod.GeneratorDraws(spec.seed, "cpu")
    rec = draws_mod.RecordingDraws(gen)
    free = cpu.init_state(rec)
    st = runner.init_state(draws_mod.ReplayDraws(rec.record, "cuda"))
    worst_frac = worst_rel = 0.0
    for _ in range(REPLAY_STEPS):
        rec = draws_mod.RecordingDraws(gen)
        want = cpu.step(convert.state_from_arrays(
            convert.state_to_arrays(st), device="cpu", dtype=torch.float32),
            rec)
        free = cpu.step(free, draws_mod.ReplayDraws(rec.record, "cpu"))
        replay = draws_mod.ReplayDraws(rec.record, "cuda")
        st = runner.step(st, replay)
        require(not replay.pending, "the card drew less than the CPU path")
        got = st.X.cpu()
        off = (got - want.X).abs() > REPLAY_ELEM_TOL * want.X.abs().max()
        worst_frac = max(worst_frac, float(off.float().mean()))
        worst_rel = max(worst_rel, float((got - want.X).norm()
                                         / want.X.norm()))
        require(worst_frac <= REPLAY_MAX_OFF,
                f"card vs CPU step {st.k - 1}: {int(off.sum())} of "
                f"{off.numel()} elements of X differ by more than "
                f"{REPLAY_ELEM_TOL} x max|X|")
    drift = float((st.X.cpu() - free.X).norm() / free.X.norm())
    replay_s = time.perf_counter() - t0

    # (b) the main run, counters zeroed just before and read just after
    problem = runner.problem
    trace = []

    def record(state, t):
        f = float(problem.full_loss(state.X))
        r = float(lam * state.X.abs().sum(dim=1).mean())
        trace.append({"step": t + 1, "objective": f + r,
                      "consensus": float(metrics.consensus_error(state.X))})
        return trace[-1]

    torch.cuda.reset_peak_memory_stats()
    qk.reset_launch_counts()
    state, _ = runner.run(num_steps=STEPS, callback=record, log_every=50)
    launches = qk.launch_counts()
    report = runner.last_report
    record(state, STEPS - 1)
    require(all(v == STEPS for v in launches.values()),
            f"launch counts {launches} != one per step for {STEPS} steps")
    require(all(math.isfinite(p["objective"]) and math.isfinite(
        p["consensus"]) for p in trace), "non-finite objective/consensus")
    require(bool(torch.isfinite(state.X).all()), "non-finite X")
    require(trace[-1]["objective"] < trace[0]["objective"],
            f"objective did not fall: {trace[0]} -> {trace[-1]}")
    require(trace[-1]["consensus"] < trace[0]["consensus"],
            f"consensus did not shrink: {trace[0]} -> {trace[-1]}")

    # (c) steady-state step time, no callbacks
    d = draws_mod.GeneratorDraws(spec.seed + 1, "cuda")
    st = state
    for _ in range(5):
        st = runner.step(st, d)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(100):
        st = runner.step(st, d)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / 100 * 1e3
    profile = profile_steps(torch, runner, st, d)
    return {
        "spec": spec.name, "steps": STEPS, "dtype": "float32",
        "data_mb_on_device": data_mb, "launches": launches,
        "replay": {"steps": REPLAY_STEPS, "elem_tol": REPLAY_ELEM_TOL,
                   "max_off_fraction": REPLAY_MAX_OFF,
                   "worst_off_fraction": worst_frac,
                   "worst_step_rel_fro": worst_rel,
                   "free_running_rel_fro": drift, "seconds": replay_s},
        "trace": trace, "run_report": report.to_dict(),
        "step_ms": step_ms, "profile": profile,
        "bits_per_step": runner.bits_per_step(),
        "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device (this smoke test runs on the "
              "card only)", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: FAIL: no src/repro_torch next to {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import api, convert
    from repro_torch.core import draws as draws_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quantize as qk
    from repro_torch.netsim import metrics

    result = {"phases": {}}
    try:
        # 1. environment
        smi = smi_line()
        name = torch.cuda.get_device_name(0)
        print(f"[env] {smi} | torch {torch.__version__} cuda "
              f"{torch.version.cuda} | {name} x {torch.cuda.device_count()}",
              flush=True)
        result["env"] = {"nvidia_smi": smi, "torch": torch.__version__,
                         "cuda": torch.version.cuda, "device": name}

        # 2. build
        t0 = time.perf_counter()
        lib = qk.build()
        qk._lib()
        build_s = time.perf_counter() - t0
        print(f"[build] {lib.name} in {build_s:.1f} s", flush=True)
        result["phases"]["build_s"] = build_s

        # 3. kernels against their plain versions
        errs = {"qinf_quantize_blocks": 0.0, "qinf_dequantize_blocks": 0.0}
        t0 = time.perf_counter()
        n = check_kernels(torch, ops, qk, ref, errs)
        times = {"main": time_kernels(torch, qk, ref, (8, 31 * 256)),
                 "large": time_kernels(torch, qk, ref, LARGE)}
        print(f"[kernels] {n} cases bit-equal to the plain versions in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for where, tt in times.items():
            for k, v in tt.items():
                print(f"[kernels] {k} @ {where} {v['rows']}: "
                      f"{v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound "
                      f"{v['bound_ms']:.4f}, library {v['library_ms']}) "
                      f"| {smi}", flush=True)

        # 4. the main path
        mp = main_path(torch, api, convert, draws_mod, metrics, qk)
        result["main_path"] = mp
        print(f"[main] {mp['spec']}: {mp['steps']} steps, objective "
              f"{mp['trace'][0]['objective']:.6f} -> "
              f"{mp['trace'][-1]['objective']:.6f}, consensus "
              f"{mp['trace'][0]['consensus']:.3e} -> "
              f"{mp['trace'][-1]['consensus']:.3e}", flush=True)
        print(f"[main] step {mp['step_ms']:.3f} ms, {mp['bits_per_step']:.0f}"
              f" bits/step/node, data {mp['data_mb_on_device']:.0f} MB, peak "
              f"{mp['peak_mem_mb']:.0f} MB, launches {mp['launches']}, "
              f"per-step card vs CPU: worst off fraction "
              f"{mp['replay']['worst_off_fraction']:.2e}, worst rel err "
              f"{mp['replay']['worst_step_rel_fro']:.2e}; free-running drift "
              f"{mp['replay']['free_running_rel_fro']:.2e}", flush=True)
        pf = mp["profile"]
        print(f"[main] profile: {pf['wall_ms_per_step']:.3f} ms/step wall, "
              f"{pf['device_ms_per_step']:.3f} ms/step on the device "
              f"(busy {pf['busy_share']:.1%}), "
              f"{pf['device_ops_per_step']:.0f} device ops/step", flush=True)
        for t in pf["top"]:
            print(f"[main]   {t['ms_per_step'] * 1e3:8.1f} us/step "
                  f"x{t['per_step']:.0f}  {t['name']}", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    src = "src/repro_torch/kernels/csrc/qinf.cu"
    kernels = []
    for name_, replaces in (("qinf_quantize_blocks",
                             "src/repro/kernels/quantize.py:54"),
                            ("qinf_dequantize_blocks",
                             "src/repro/kernels/quantize.py:204")):
        m = times["main"][name_]
        kernels.append({
            "name": name_, "route": "cuda", "source": src,
            "replaces": replaces, "launches": mp["launches"][name_],
            "max_abs_err": errs[name_], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "rows": m["rows"], "large": times["large"][name_]})
    result["kernels"] = kernels
    result["card"] = smi
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
