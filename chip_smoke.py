#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. Environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.
2. Build: compiles ``src/repro_torch/kernels/csrc/qinf.cu`` (kernels B1
   quantize, B2 dequantize) and ``qinf_wire.cu`` (B3 quantize+pack, B4
   unpack+dequantize+mix) with nvcc for sm_90a, one compiler per source,
   both started together.
3. B1/B2 against their plain PyTorch versions on the card, same x and u:
   bits {1,2,3,4,7}, x in f32 and bf16, at the main path's shape
   (8 nodes x 7840 -> (8*31, 256) blocks), ragged last dims (3, 7, 11) and
   (129,), a block of zeros, and (8, 12_582_912) (8 nodes x one 2048x6144
   matrix, ~400 MB per f32 operand).  Codes, scales and dequantized values
   must be exactly equal.  Each kernel, its plain version and, where one
   exists, the single PyTorch call computing the same function are timed
   with CUDA events at the main path's shape and at the large shape.
4. The dense main path: ``repro_torch.api.build(spec)`` on the card for the
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
5. B3/B4 against their plain versions on the card: bits {1,2,3,4,7},
   blocks 128 and 256, S (senders) in {1, 3}, T (rounds) in {1, 3}, f32,
   bf16 and f64 out, 2 nodes, a ragged row count, a block of zeros.
   Packed bytes, scales and qself must be exactly equal; the mix within
   (S + 1) eps_f32 sum_s |w Q_s| (+ one bf16 ulp for bf16 out).  The same
   checks at the shapes the trainer below gives them: its block-256 group
   (8 nodes x 700,456 rows of 256) and its block-128 q_norm/k_norm group
   (8 nodes x 4 rows of 128), 2 bits, ring payloads (S = 3), T = 1; both
   kernels are timed at the block-256 group.
6. The trainer path (slice 2): ``api.build(spec)`` on the card for
   qwen3-1.7b at its published widths (2 of 28 layers, the first eighth of
   the vocabulary), 8 nodes on a ring, the neighbor-gossip backend with
   the bucketed wire (2-bit QInf, block 256), f32, full f32 products
   (``torch.backends.cuda.matmul.allow_tf32 = False``).  SLICE_STEPS steps
   with the launch counters zeroed just before and read just after: B3 and
   B4 must launch once per bucket group per step; the loss must be finite,
   and lower at the end than at the start (mean of the last LOSS_WINDOW
   steps against the first: one step's loss moves with its batch), the
   consensus finite; the loss on two held-out batches is reported;
   ``bits_per_step`` must equal 2 hops x 739,683,712 bits.  Peak memory,
   step time and a short ``torch.profiler`` window (device busy share,
   time by kernel) are reported.
7. Bucketed against per-leaf wire on the card, at the slice's widths, on
   the leaves ``blocks/w_gate`` (whole), ``embed`` and ``blocks/q_norm``:
   the same diffs and noise through both exchanges; codes, scales and
   qself equal, the mix within the bound of phase 5.
8. Card against CPU for the trainer at a small size (qwen3 reduced to 1
   layer, d_model 256, 8 nodes): REPLAY_STEPS_SLICE steps, each started
   from the card's state, the CPU path drawing and the card replaying the
   same noise; X, D, H and Hw within 1e-4 x max of each array on all but
   0.1 % of elements.
9. Result lines: ``{"kernels": [...]}`` (B1-B4), the nvidia-smi line, and
   last ``{"ok": true, "device": {...}}``.  Everything is also written to
   ``chiprun_out/chip_smoke.json``.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
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
B3_OPS_PER_ELEMENT = 11     # B1's ten, the offset add (packing is bitwise)
SLICE_STEPS = 30            # trainer steps with counters on
LOSS_WINDOW = 5             # the loss falls: mean of the last 5 < first 5
SLICE_PROFILE_STEPS = 3     # trainer steps under torch.profiler
SLICE_GROUP_ROWS = 700_456  # block-256 rows per node at the slice's widths
SLICE_SMALL_GROUP_ROWS = 4  # block-128 rows per node (q_norm, k_norm x 2)
SLICE_BITS_PER_STEP = 2 * 739_683_712   # 2 hops x the per-edge payload
REPLAY_STEPS_SLICE = 5      # small trainer steps held against the CPU


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
    require(all(launches[k] == STEPS for k in ("qinf_quantize_blocks",
                                                "qinf_dequantize_blocks")),
            f"launch counts {launches} != one B1 and one B2 per step for "
            f"{STEPS} steps")
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


# --- phase 5 -------------------------------------------------------------------

def b4_ops_per_element(S: int, T: int) -> int:
    """Per output element: per sender decode (shift/mask, offset), cvt,
    scale mul, round-through (2), then a mul and an add per round."""
    return S * (6 + 2 * T)


def mix_bound(torch, w, q_abs, S: int, out_dtype):
    """(S + 1) eps_f32 sum_s |w[t, s] Q_s| (+ one ulp of a bf16 output);
    ``w`` (N, T, S), ``q_abs`` (N, S, R, B) -> (N, T, R, B)."""
    eps = (S + 1) * torch.finfo(torch.float32).eps
    if out_dtype == torch.bfloat16:
        eps += torch.finfo(torch.bfloat16).eps
    return eps * torch.einsum("nts,nsrb->ntrb", w.abs(), q_abs)


def check_b3(torch, ref, x, u, bits, got, errs, what: str) -> None:
    """Kernel B3's (packed, scales) against its plain version on the same
    inputs: both equal; the largest difference goes into ``errs``."""
    pk, sk = got
    pr, sr = ref.qinf_quantize_pack_blocks_ref(x, u, bits)
    e3 = max(float((pk.int() - pr.int()).abs().max()),
             float((sk - sr).abs().max()))
    errs["qinf_quantize_pack_blocks"] = max(
        errs["qinf_quantize_pack_blocks"], e3)
    require(torch.equal(pk, pr) and torch.equal(sk, sr),
            f"B3 != plain {what} (max diff {e3})")


def check_b4(torch, ref, P, Sc, w, bits, out, got, errs, what: str) -> bool:
    """Kernel B4's (mix, qself) against its plain version on the same
    inputs, node by node (so the bound's |Q_s| table is one node's size):
    qself equal, mix within :func:`mix_bound`; the largest mix difference
    goes into ``errs``.  Returns whether the mix was bit-equal."""
    mk, qk_ = got
    N, S = P.shape[:2]
    exact = True
    for n in range(N):
        nd = slice(n, n + 1)
        mr, qr = ref.qinf_unpack_dequant_mix_blocks_ref(P[nd], Sc[nd], w[nd],
                                                        bits, out)
        require(torch.equal(qk_[nd], qr),
                f"B4 qself != plain {what} (node {n})")
        q_abs = torch.stack([ref.qinf_unpack_dequant_mix_blocks_ref(
            P[nd, s:s + 1], Sc[nd, s:s + 1],
            torch.ones((1, 1, 1), device=P.device), bits, out
        )[1].float().abs() for s in range(S)], 1)
        diff = (mk[nd].float() - mr.float()).abs()
        e4 = float(diff.max())
        errs["qinf_unpack_dequant_mix_blocks"] = max(
            errs["qinf_unpack_dequant_mix_blocks"], e4)
        require(bool((diff <= mix_bound(torch, w[nd], q_abs, S, out)).all()),
                f"B4 mix outside its bound {what} (node {n}, max diff {e4})")
        exact &= bool(torch.equal(mk[nd], mr))
        del mr, qr, q_abs, diff
    return exact


def check_wire_kernels(torch, qk, ref, errs, n_nodes=2, rows=8 * 31 + 5,
                       device="cuda"):
    """B3/B4 vs their plain versions on every case; records the largest
    difference per kernel in ``errs``."""
    g = torch.Generator(device=device).manual_seed(2)
    n_checked, n_exact_mix = 0, 0
    for bits in (1, 2, 3, 4, 7):
        for block in (128, 256):
            S_max = 3
            x = torch.randn((n_nodes * S_max * rows, block), generator=g,
                            device=device) * 3
            x[5] = 0
            u = torch.rand(x.shape, generator=g, device=device)
            pk, sk = qk.qinf_quantize_pack_blocks(x, u, bits)
            check_b3(torch, ref, x, u, bits, (pk, sk), errs,
                     f"at bits={bits} block={block}")
            require(float(sk[5]) == 0.0, "an all-zero block needs scale 0")
            P = pk.reshape(n_nodes, S_max, rows, -1)
            Sc = sk.reshape(n_nodes, S_max, rows, 1)
            for S, T in ((1, 1), (3, 1), (1, 3), (3, 3)):
                Ps, Ss = P[:, :S].contiguous(), Sc[:, :S].contiguous()
                w = torch.randn((n_nodes, T, S), generator=g, device=device)
                for out in (torch.float32, torch.bfloat16, torch.float64):
                    got = qk.qinf_unpack_dequant_mix_blocks(Ps, Ss, w, bits,
                                                            out)
                    n_exact_mix += check_b4(
                        torch, ref, Ps, Ss, w, bits, out, got, errs,
                        f"at bits={bits} block={block} S={S} T={T} {out}")
                    n_checked += 1
            del x, u, pk, sk, P, Sc
    return n_checked, n_exact_mix


def ring_payloads(torch, packed, scales, n_nodes: int, group_rows: int):
    """What B4 gets on a ring: each node's own payload (sender 0) and
    those of its two neighbours, node-stacked (N, 3, rows, W) and
    (N, 3, rows, 1)."""
    p = packed.reshape(n_nodes, group_rows, -1)
    s = scales.reshape(n_nodes, group_rows, 1)
    return (torch.stack([p, p.roll(1, 0), p.roll(-1, 0)], 1).contiguous(),
            torch.stack([s, s.roll(1, 0), s.roll(-1, 0)], 1).contiguous())


def wire_kernels_at_slice_shape(torch, qk, ref, errs,
                                group_rows=SLICE_GROUP_ROWS, n_nodes=8,
                                small_rows=SLICE_SMALL_GROUP_ROWS,
                                plain_iters=5, device="cuda"):
    """B3/B4 at the shapes the trainer path gives them, held against their
    plain versions on the same inputs and timed: the block-256 group
    (n_nodes x group_rows rows) and the block-128 q_norm/k_norm group
    (n_nodes x small_rows rows), bits 2, ring payloads (S = 3: self + 2
    hops), T = 1, weights 1/3, f32 out.  B3's bytes and scales and B4's
    qself must be equal, B4's mix within its bound; the largest
    differences go into ``errs``.  Times are of the block-256 group.  No
    single PyTorch call computes either function (library: none)."""
    g = torch.Generator(device=device).manual_seed(3)
    w = torch.full((n_nodes, 1, 3), 1.0 / 3.0, device=device)
    checked = []
    for block, rows_ in ((128, small_rows), (256, group_rows)):
        what = f"at the trainer's block-{block} group ({n_nodes} x {rows_})"
        R = n_nodes * rows_
        x = torch.randn((R, block), generator=g, device=device)
        u = torch.rand((R, block), generator=g, device=device)
        packed, scales = qk.qinf_quantize_pack_blocks(x, u, 2)
        check_b3(torch, ref, x, u, 2, (packed, scales), errs, what)
        if block == 256:
            b3 = {"rows": [R, 256],
                  "ms": cuda_ms(torch, lambda: qk.qinf_quantize_pack_blocks(
                      x, u, 2)),
                  "plain_ms": cuda_ms(
                      torch, lambda: ref.qinf_quantize_pack_blocks_ref(
                          x, u, 2), iters=plain_iters, warmup=1)}
            b3["bound_ms"], b3["bound_by"] = bound_ms(
                nbytes(x, u, packed, scales), B3_OPS_PER_ELEMENT * x.numel())
            b3["library_ms"] = None
        del x, u
        P, Sc = ring_payloads(torch, packed, scales, n_nodes, rows_)
        del packed, scales
        mix, qself = qk.qinf_unpack_dequant_mix_blocks(P, Sc, w, 2)
        exact = check_b4(torch, ref, P, Sc, w, 2, torch.float32,
                         (mix, qself), errs, what)
        checked.append({"block": block, "rows": [n_nodes, 3, rows_, block],
                        "mix_bit_equal": exact})
        if block == 256:
            b4 = {"rows": [n_nodes, 3, rows_, 256],
                  "ms": cuda_ms(torch, lambda: qk.qinf_unpack_dequant_mix_blocks(
                      P, Sc, w, 2)),
                  "plain_ms": cuda_ms(
                      torch, lambda: ref.qinf_unpack_dequant_mix_blocks_ref(
                          P, Sc, w, 2), iters=plain_iters, warmup=1)}
            b4["bound_ms"], b4["bound_by"] = bound_ms(
                nbytes(P, Sc, w, mix, qself),
                b4_ops_per_element(3, 1) * qself.numel())
            b4["library_ms"] = None
        del P, Sc, mix, qself
        if device == "cuda":
            torch.cuda.empty_cache()
    return {"qinf_quantize_pack_blocks": b3,
            "qinf_unpack_dequant_mix_blocks": b4}, checked


# --- phase 6 -------------------------------------------------------------------

def slice_spec(api, steps: int, *, full: bool = True, n_layers: int = 2,
               d_model: int = 2048, seq_len: int = 512):
    """The slice's trainer configuration: qwen3-1.7b (hf:Qwen/Qwen3-8B
    family card) at its published widths, depth cut to 2 of 28 layers and
    the vocabulary to its first eighth (18,992, padded 19,200) so that 8
    replicas fit one card; 8 nodes on a ring, 2-bit QInf in 256-blocks on
    the bucketed neighbor wire, the train.py step sizes.  ``full=False``
    is the reduced (smoke) model for the card-vs-CPU check."""
    model = (api.ModelSpec(arch="qwen3-1.7b", full=True, local_batch=2,
                           seq_len=seq_len,
                           params={"n_layers": n_layers, "vocab": 18992})
             if full else
             api.ModelSpec(arch="qwen3-1.7b", full=False, n_layers=n_layers,
                           d_model=d_model, local_batch=2, seq_len=seq_len))
    return api.ExperimentSpec(
        name="qwen3-1.7b-2L-vocab8-ring8-qinf2" if full else
        "qwen3-smoke-ring8-qinf2", n_nodes=8, steps=steps,
        algorithm=api.AlgorithmSpec("prox_lead", eta=api.constant(0.05),
                                    alpha=api.constant(0.5),
                                    gamma=api.constant(1.0)),
        compressor=api.CompressorSpec("qinf", {"bits": 2, "block": 256}),
        topology=api.TopologySpec(graph="ring"),
        model=model,
        execution=api.ExecutionSpec(engine="sharded", backend="neighbor",
                                    wire_mode="bucketed"))


def profile_trainer(torch, runner, st, data, draws, steps: int):
    """torch.profiler over ``steps`` trainer steps: device busy share and
    device time by kernel (trace in chiprun_out/slice_trace.json)."""
    from torch.profiler import ProfilerActivity, profile
    t_first = int(st.step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(t_first, t_first + steps):
            st, _ = runner.step(st, data.batch_at(t), draws)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    OUT_DIR.mkdir(exist_ok=True)
    trace = OUT_DIR / "slice_trace.json"
    prof.export_chrome_trace(str(trace))
    device = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    require(bool(device), "the profiler saw no device work in the trainer")
    by_name = {}
    for e in device:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return st, {"steps": steps, "wall_ms_per_step": wall_ms / steps,
                "device_ms_per_step": busy_ms / steps,
                "busy_share": busy_ms / wall_ms,
                "device_ops_per_step": len(device) / steps,
                "top": [{"name": k[:90], "ms_per_step": ms / steps,
                         "per_step": n / steps} for k, (ms, n) in top]}


def held_out_loss(torch, runner, X, data, n_batches: int = 2) -> float:
    """Mean node loss of parameters X on batches the run never trains on
    (forward only)."""
    from repro_torch.models import transformer as TR
    cfg, total = runner.trainer.mcfg, 0.0
    with torch.no_grad():
        for i in range(n_batches):
            b = data.batch_at(1_000_000 + i)
            logits = TR.forward(cfg, X, b)[0]
            total += float(TR.loss_fn(cfg, logits, b["labels"]).mean())
            del logits
    return total / n_batches


def trainer_path(torch, api, draws_mod, qk, steps: int = SLICE_STEPS,
                 profile_steps: int = SLICE_PROFILE_STEPS, spec=None,
                 device: str = "cuda"):
    """The slice's trainer on the card through api.build(spec)."""
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    spec = spec or slice_spec(api, steps)
    t0 = time.perf_counter()
    runner = api.build(spec) if device == "cuda" else api.build(
        spec, device=device)
    require(runner.device.type == device, f"build(spec) did not pick "
            f"{device}")
    tr = runner.trainer
    cfg = tr.mcfg
    bits = runner.bits_per_step()
    if spec.model.full:
        require(bits == SLICE_BITS_PER_STEP,
                f"bits_per_step {bits} != 2 hops x 739,683,712")
    layout_groups = len(tr.wire_layout().groups)
    data = runner.default_data()
    draws = draws_mod.GeneratorDraws(spec.seed, runner.device)
    trace = []
    stamps = [time.perf_counter()]

    def record(state, metrics, t):
        trace.append({"step": t + 1, "loss": float(metrics["loss"]),
                      "consensus": float(metrics["consensus"])})
        stamps.append(time.perf_counter())
        return trace[-1]

    init = [runner.init_state()]          # handed over: nothing else holds it
    held_out = [held_out_loss(torch, runner, init[0].plead.X, data)]
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    qk.reset_launch_counts()
    state, _ = runner.run(num_steps=steps, data=data, draws=draws,
                          state=init.pop(), callback=record, log_every=1)
    launches = qk.launch_counts()
    report = runner.last_report
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else 0.0)
    require(launches["qinf_quantize_pack_blocks"] == steps * layout_groups
            and launches["qinf_unpack_dequant_mix_blocks"]
            == steps * layout_groups or device != "cuda",
            f"launch counts {launches} != one B3 and one B4 per bucket group "
            f"({layout_groups}) per step for {steps} steps")
    require(all(math.isfinite(p["loss"]) and math.isfinite(p["consensus"])
                for p in trace), "non-finite loss/consensus")
    # one step's loss moves by a few 1e-2 with its batch, and the first
    # steps add the 2-bit compression error of the whole model (H = 0), so
    # "start" and "end" are means over LOSS_WINDOW steps
    first = sum(p["loss"] for p in trace[:LOSS_WINDOW]) / LOSS_WINDOW
    last = sum(p["loss"] for p in trace[-LOSS_WINDOW:]) / LOSS_WINDOW
    require(last < first, f"loss did not fall: mean of the first "
            f"{LOSS_WINDOW} steps {first} -> of the last {last}")
    held_out.append(held_out_loss(torch, runner, state.plead.X, data))
    step_s = sorted(b - a for a, b in zip(stamps[1:], stamps[2:]))
    profile = None
    if profile_steps and device == "cuda":
        state, profile = profile_trainer(torch, runner, state, data, draws,
                                         profile_steps)
    return {"spec": spec.name, "steps": steps, "dtype": str(cfg.dtype),
            "config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                       "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                       "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                       "padded_vocab": cfg.padded_vocab,
                       "params_per_node": cfg.param_count(),
                       "n_nodes": spec.n_nodes,
                       "local_batch": spec.model.local_batch,
                       "seq_len": spec.model.seq_len},
            "bucket_groups": layout_groups, "launches": launches,
            "trace": trace, "run_report": report.to_dict(),
            "setup_s": setup_s,
            "step_ms_median": 1e3 * step_s[len(step_s) // 2] if step_s
            else None,
            "step_ms_min": 1e3 * step_s[0] if step_s else None,
            "profile": profile, "bits_per_step": bits,
            "loss_first_window": first, "loss_last_window": last,
            "held_out_loss": held_out, "peak_mem_gb": peak}


# --- phase 7 -------------------------------------------------------------------

class RecordingPP:
    """The one-card exchange seam, keeping what each hop-0 call sent."""

    def __init__(self, pp, hops: int):
        self.pp, self.hops, self.sent, self.calls = pp, hops, [], 0

    def __call__(self, x, pairs):
        if (self.calls // 2) % self.hops == 0:
            self.sent.append(x)
        self.calls += 1
        return self.pp(x, pairs)


def bucketed_vs_per_leaf(torch, api, draws_mod, wire, ref, device="cuda",
                         spec=None):
    """The same diffs and noise through the bucketed and the per-leaf wire
    at the slice's widths, on blocks/w_gate (whole), embed and
    blocks/q_norm: codes, scales and qself equal, mix within the bound."""
    spec = spec or slice_spec(api, 1)
    tr = (api.build(spec) if device == "cuda"
          else api.build(spec, device=device)).trainer
    from repro_torch import tree
    from repro_torch.core import bucket
    from repro_torch.models import transformer as TR
    shapes = dict(zip(*_named_leaves(tree, TR.abstract_params(tr.mcfg))))
    names = ["blocks/q_norm", "blocks/w_gate", "embed"]
    g = torch.Generator(device=device).manual_seed(4)
    N = spec.n_nodes
    diffs = [torch.randn((N,) + tuple(shapes[n].shape), generator=g,
                         device=device) * 0.01 for n in names]
    hop_pairs = [list(h.pairs) for h in tr.plan.hops]
    wx = wire.WireExchange(bits=tr.tcfg.bits, block=tr.tcfg.block,
                           block_for=tr._quant_block)
    layout = wx.layout(wx.local_shapes(diffs), [d.dtype for d in diffs])
    rec = draws_mod.RecordingDraws(draws_mod.GeneratorDraws(5, device))
    pp_b = RecordingPP(wire.stacked_pp, len(hop_pairs))
    wq_b, qs_b = wx.bucketed(bucket.RowTables.from_leaves(layout, diffs),
                             rec, tr._wmat, hop_pairs, pp_b)
    pp_p = RecordingPP(wire.stacked_pp, len(hop_pairs))
    wq_p, qs_p = wx.per_leaf(diffs, draws_mod.ReplayDraws(rec.record, device),
                             tr._wmat, hop_pairs, pp_p)
    del rec
    bits = tr.tcfg.bits
    cw, sw = pp_b.sent
    codes_b, scales_b = [], []
    for g_ in layout.groups:
        seg = cw[:, g_.codes_offset: g_.codes_offset
                 + g_.rows * g_.packed_width].reshape(N, g_.rows, -1)
        rows = ref.unpack_codes_halves_ref(seg, bits)
        sc = sw[:, g_.scales_offset: g_.scales_offset + g_.rows * 4
                ].reshape(N, g_.rows, 4).contiguous().view(torch.float32)
        for i in g_.leaf_indices:
            sl = layout.slots[i]
            codes_b.append((i, rows[:, sl.row_offset: sl.row_offset
                                    + sl.rows]))
            scales_b.append((i, sc[:, sl.row_offset: sl.row_offset
                                   + sl.rows]))
    codes_b, scales_b = dict(codes_b), dict(scales_b)
    out = {"leaves": {n: list(d.shape) for n, d in zip(names, diffs)},
           "mix_max_abs_diff": 0.0, "mix_exact": True}
    from repro_torch.kernels import ops
    for i, d in enumerate(diffs):
        packed, s_wire = pp_p.sent[2 * i], pp_p.sent[2 * i + 1]
        blk = layout.slots[i].block
        codes_p = ops.unpack_codes_lastdim(packed, bits=bits).reshape(
            N, -1, blk)
        require(torch.equal(codes_p, codes_b[i]),
                f"bucketed and per-leaf codes differ on {names[i]}")
        require(torch.equal(s_wire.contiguous().view(torch.float32).reshape(
            N, -1, 1), scales_b[i]),
            f"bucketed and per-leaf scales differ on {names[i]}")
        require(torch.equal(qs_b[i], qs_p[i]),
                f"bucketed and per-leaf qself differ on {names[i]}")
        diff = (wq_b[i] - wq_p[i]).abs()
        S = 1 + len(hop_pairs)
        q_abs = qs_p[i].abs().amax()
        bound = (S + 1) * torch.finfo(torch.float32).eps * float(q_abs) * \
            float(tr._wmat.abs().sum(0).max())
        out["mix_max_abs_diff"] = max(out["mix_max_abs_diff"],
                                      float(diff.max()))
        out["mix_exact"] &= bool(torch.equal(wq_b[i], wq_p[i]))
        require(float(diff.max()) <= bound,
                f"bucketed and per-leaf mixes differ on {names[i]} by "
                f"{float(diff.max())} > {bound}")
    out["bytes_per_hop_per_node"] = int(sum(int(x[0].numel())
                                            for x in pp_b.sent))
    require(out["bytes_per_hop_per_node"] == layout.wire_bits // 8,
            "the bucketed wire moved other bytes than its layout")
    return out


def _named_leaves(tree, params):
    """(['blocks/q_norm', ...], leaves) in leaf order."""
    names = []

    def walk(d, prefix):
        for k in sorted(d):
            if isinstance(d[k], dict):
                walk(d[k], prefix + k + "/")
            else:
                names.append(prefix + k)

    walk(params, "")
    return names, tree.leaves(params)


# --- phase 8 -------------------------------------------------------------------

def trainer_card_vs_cpu(torch, api, convert, draws_mod, tree,
                        steps: int = REPLAY_STEPS_SLICE, device="cuda"):
    """The small trainer, one step at a time from the card's state: the
    CPU path draws, the card replays; X, D, H, Hw compared."""
    spec = slice_spec(api, steps, full=False, n_layers=1, d_model=256,
                      seq_len=64)
    cpu = api.build(spec, device="cpu")
    card = api.build(spec) if device == "cuda" else api.build(
        spec, device=device)
    data = cpu.default_data()
    gen = draws_mod.GeneratorDraws(spec.seed, "cpu")
    st = card.init_state()
    worst_frac = worst_rel = 0.0
    for t in range(steps):
        arrays = convert.trainstate_to_arrays(st)
        rec = draws_mod.RecordingDraws(gen)
        want, _ = cpu.step(convert.trainstate_from_arrays(arrays,
                                                          device="cpu"),
                           data.batch_at(t), rec)
        replay = draws_mod.ReplayDraws(rec.record, card.device)
        batch = {k: v.to(card.device) for k, v in data.batch_at(t).items()}
        st, _ = card.step(st, batch, replay)
        require(not replay.pending, "the card drew less than the CPU path")
        got_a, want_a = (convert.trainstate_to_arrays(s) for s in (st, want))
        for name in ("X", "D", "comm.H", "comm.Hw"):
            for a, b in zip(tree.leaves(got_a[name]),
                            tree.leaves(want_a[name])):
                scale = max(float(abs(b).max()), 1e-30)
                off = abs(a - b) > REPLAY_ELEM_TOL * scale
                worst_frac = max(worst_frac, float(off.mean()))
                worst_rel = max(worst_rel, float(abs(a - b).max()) / scale)
        require(worst_frac <= REPLAY_MAX_OFF,
                f"trainer card vs CPU step {t}: {worst_frac:.2e} of a state "
                f"array differs by more than {REPLAY_ELEM_TOL} x its max")
    return {"spec": spec.name, "steps": steps, "elem_tol": REPLAY_ELEM_TOL,
            "max_off_fraction": REPLAY_MAX_OFF,
            "worst_off_fraction": worst_frac, "worst_rel_max": worst_rel}


def main() -> int:
    # the trainer's state arrays are GB-sized and freed in another order
    # than they were allocated: let the allocator grow segments instead of
    # fragmenting fixed ones
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    from repro_torch import api, convert, tree
    from repro_torch.core import draws as draws_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quantize as qk
    from repro_torch.netsim import metrics
    from repro_torch.optim import wire

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
        libs = qk.build()
        qk._libs()
        build_s = time.perf_counter() - t0
        print(f"[build] {', '.join(v.name for v in libs.values())} in "
              f"{build_s:.1f} s", flush=True)
        result["phases"]["build_s"] = build_s

        # 3. kernels against their plain versions
        errs = {k: 0.0 for k in qk.LAUNCHES}
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

        # 5. B3/B4 against their plain versions, timed at the slice's shape
        t0 = time.perf_counter()
        n, n_exact = check_wire_kernels(torch, qk, ref, errs)
        wtimes, at_slice = wire_kernels_at_slice_shape(torch, qk, ref, errs)
        print(f"[wire] {n} B4 cases (and their B3 inputs) against the plain "
              f"versions, B3 bytes/scales and B4 qself equal, B4 mix within "
              f"its bound ({n_exact} of {n} bit-equal); the same checks at "
              f"the trainer's groups {[c['rows'] for c in at_slice]} (mix "
              f"bit-equal: {[c['mix_bit_equal'] for c in at_slice]}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for k, v in wtimes.items():
            print(f"[wire] {k} @ {v['rows']}: {v['ms']:.4f} ms (plain "
                  f"{v['plain_ms']:.4f}, bound {v['bound_ms']:.4f} by "
                  f"{v['bound_by']}, library none) | {smi}", flush=True)
        result["wire_kernels"] = {"cases": n, "mix_bit_equal": n_exact,
                                  "at_slice_shape": at_slice,
                                  "times": wtimes}

        # 6. the trainer path at the slice's configuration
        sp = trainer_path(torch, api, draws_mod, qk)
        result["trainer_path"] = sp
        print(f"[slice] {sp['spec']}: {sp['config']}", flush=True)
        print(f"[slice] {sp['steps']} steps, loss "
              f"{sp['trace'][0]['loss']:.6f} -> {sp['trace'][-1]['loss']:.6f}"
              f" (mean of {LOSS_WINDOW}: {sp['loss_first_window']:.6f} -> "
              f"{sp['loss_last_window']:.6f}; held out "
              f"{sp['held_out_loss'][0]:.6f} -> {sp['held_out_loss'][1]:.6f})"
              f", consensus {sp['trace'][0]['consensus']:.4e} -> "
              f"{sp['trace'][-1]['consensus']:.4e}; launches "
              f"{sp['launches']} ({sp['bucket_groups']} bucket groups)",
              flush=True)
        print(f"[slice] step {sp['step_ms_median']:.1f} ms median "
              f"({sp['step_ms_min']:.1f} min), peak "
              f"{sp['peak_mem_gb']:.2f} GiB allocated, "
              f"{sp['bits_per_step']:.0f} bits/step/node, set-up "
              f"{sp['setup_s']:.1f} s | {smi}", flush=True)
        pf = sp["profile"]
        print(f"[slice] profile: {pf['wall_ms_per_step']:.1f} ms/step wall, "
              f"{pf['device_ms_per_step']:.1f} ms/step on the device (busy "
              f"{pf['busy_share']:.1%}), {pf['device_ops_per_step']:.0f} "
              f"device ops/step", flush=True)
        for t_ in pf["top"]:
            print(f"[slice]   {t_['ms_per_step']:9.3f} ms/step "
                  f"x{t_['per_step']:.0f}  {t_['name']}", flush=True)

        # 7. bucketed against per-leaf wire at the slice's widths
        bp = bucketed_vs_per_leaf(torch, api, draws_mod, wire, ref)
        result["bucketed_vs_per_leaf"] = bp
        print(f"[wire] bucketed vs per-leaf on {bp['leaves']}: codes, "
              f"scales, qself equal; mix max diff {bp['mix_max_abs_diff']:.3e}"
              f" (bit-equal: {bp['mix_exact']}); {bp['bytes_per_hop_per_node']}"
              f" bytes per hop per node", flush=True)

        # 8. the trainer, card against CPU at a small size
        cc = trainer_card_vs_cpu(torch, api, convert, draws_mod, tree)
        result["trainer_card_vs_cpu"] = cc
        print(f"[slice] card vs CPU, {cc['steps']} steps of {cc['spec']}: "
              f"worst off fraction {cc['worst_off_fraction']:.2e}, worst "
              f"|diff|/max {cc['worst_rel_max']:.2e}", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name_, src, replaces in (
            ("qinf_quantize_blocks", "qinf.cu",
             "src/repro/kernels/quantize.py:54"),
            ("qinf_dequantize_blocks", "qinf.cu",
             "src/repro/kernels/quantize.py:204"),
            ("qinf_quantize_pack_blocks", "qinf_wire.cu",
             "src/repro/kernels/quantize.py:137"),
            ("qinf_unpack_dequant_mix_blocks", "qinf_wire.cu",
             "src/repro/kernels/quantize.py:169")):
        if name_ in times["main"]:     # B1/B2: the dense main path
            m, launches = times["main"][name_], mp["launches"][name_]
            extra = {"large": times["large"][name_]}
        else:                          # B3/B4: the trainer path
            m, launches = wtimes[name_], sp["launches"][name_]
            extra = {}
        kernels.append({
            "name": name_, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs[name_], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "rows": m["rows"], **extra})
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
