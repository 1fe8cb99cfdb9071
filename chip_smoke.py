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
   both started together, and prints each kernel's registers, spills and
   resident warps per SM from ``ptxas -v``.
3. B1/B2 against their plain PyTorch versions on the card, same x and u:
   B1 through ``ops.qinf_quantize_lastdim``, which hands it the leaf
   unpadded (the kernel reads the ragged last block in place), against
   the plain version on the zero-padded rows, and B2 on its codes; bits
   {1,2,3,4,7,8} (at 8 the code +128 saturates to +127, as in the
   reference), x in f32, bf16 and f64, on the leaves of B1_CASES: the
   main path's (8 nodes x 7840 -> 8 x 31 blocks of 256), block 128, ragged
   last dims (129,) and (3, 7, 11), a block of zeros, a last block of
   zeros before the pad, rows cut from wider ones, rows off the 16-byte
   alignment (5, 129), a view one element into its buffer, a block of 2048
   (wider than the vector variant holds) and (8, 12_582_912) (8 nodes x one
   2048x6144 matrix, ~400 MB per f32 operand); each leaf must take the B1
   variant it names.  B2's vector and row variants at widths 256, 128, 100
   and 3 and on a view off the 16-byte alignment.  Codes, scales and
   dequantized values must be exactly equal.  Each kernel, its plain
   version and, where one exists, the single PyTorch call computing the
   same function are timed with CUDA events on (R, 256) rows at the main
   path's shape (MAIN_SHAPE_ITERS calls) and at the large shape; B1 also
   as the main path calls it, on the (8, 7840) leaf, and device time a
   call from ``torch.profiler`` (median of MAIN_SHAPE_ITERS calls) of
   that call, of B1 on (248, 256) rows and of ``zero_`` on 248 floats
   (the launch floor).
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
   consensus error that must shrink, finite values.  A ``torch.profiler``
   window of PROFILE_STEPS steps lists every device operation of a step
   by name; B1 must run once a step with no pad kernel (fill, copy) just
   before it.
5. B3/B4 against their plain versions on the card: bits {1,2,3,4,7},
   blocks 128 and 256, S (senders) in {1, 3, 4}, T (rounds) in {1, 3},
   f32, bf16 and f64 out, 2 nodes, a ragged row count, a block of zeros
   (B4's vector variant), and B4's row variant on payload rows that are
   not whole 16-byte chunks, on a payload off the 16-byte alignment and at
   S = 5 and 9.  Packed bytes, scales, qself and the mix must be exactly
   equal (kernel and plain version sum the senders in one order).  The same
   checks at the shapes the trainer below gives them: its block-256 group
   (8 nodes x 700,456 rows of 256) and its block-128 q_norm/k_norm group
   (8 nodes x 4 rows of 128), 2 bits, ring payloads (S = 3), T = 1; both
   kernels are timed at the block-256 group.
6. The trainer path: ``api.build(spec)`` on the card for
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
   qself equal, the mix within (S + 1) eps_f32 max|Q| max_n sum_s |w|.
8. Card against CPU for the trainer at a small size (qwen3 reduced to 1
   layer, d_model 256, 8 nodes): REPLAY_STEPS_SLICE steps, each started
   from the card's state, the CPU path drawing and the card replaying the
   same noise; X, D, H and Hw within 1e-4 x max of each array on all but
   0.1 % of elements.
9. The paper's comparisons on the card (``repro_torch.paper``, the
   registered ``logreg`` problem at its defaults: 8 nodes on a ring,
   784x10 flattened, 150 samples and 15 batches a node, lambda2 = 0.005;
   f64).  (a) The Fig. 1 and Fig. 2 grids, 13 and 11 rows of PAPER_STEPS
   steps, each row through ``api.build(spec)``: the launch counters are
   zeroed just before each row and read just after it; a 2-bit row must
   launch B1 and B2 once a step, an uncompressed row neither; every claim
   of ``validate`` must pass, and each is printed with its value, as is
   each row's final suboptimality, bits and ms a step.  (b) The Table 3
   rows: each measured rate within its theorem envelope (rho_hat <= rho +
   1e-3); a ``torch.profiler`` window of PAPER_PROFILE_STEPS steps of the
   LEAD (2bit) row (device busy share, every device operation by name, B1
   once a step).  (c) DGD, PG-EXTRA, Choco (2 bit) and LessBit (2 bit) at the
   paper's rows: PAPER_REPLAY_STEPS steps, each started from the card's
   state and held against one step of the plain CPU path with the same
   draws, at phase 4's tolerance.  (d) ``empirical_C`` of 2-bit QInf on
   the (8, 7840) leaf with EMPIRICAL_C_TRIALS trials: one B1 and one B2
   launch, equal (to 1e-12 relative: the error sums reduce in another
   order) to the plain version's value from the same noise, at most the
   compressor's analytic C.
10. Result lines: ``{"kernels": [...]}`` (B1-B4), the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.  Everything is also written to
   ``chiprun_out/chip_smoke.json``.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import re
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
MAIN_SHAPE_ITERS = 200   # back-to-back calls timed at the main path's shape
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
PAPER_STEPS = 800           # steps of a Fig. 1 / Fig. 2 row (the paper's)
PAPER_REPLAY_STEPS = 20     # baseline steps held against the CPU path
EMPIRICAL_C_TRIALS = 64
PAPER_PROFILE_STEPS = 50    # LEAD (2bit) steps under torch.profiler
B1, B2 = "qinf_quantize_blocks", "qinf_dequantize_blocks"


# kernel B1 in a profile, and the fill and copy kernels of a pad (F.pad's
# constant_pad_nd) or any device copy
B1_KERNEL = re.compile(r"qinf_quantize_(vec_|row_)?kernel")
PAD_KERNEL = re.compile(r"FillFunctor|copy", re.IGNORECASE)


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


# --- phase 2 -------------------------------------------------------------------

_PTX_TYPES = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16"}


def ptxas_report(text: str):
    """Registers, spill bytes and resident warps per SM (256-thread blocks,
    65,536 registers an SM allocated 256 at a time per warp, at most 64
    warps) of every kernel in one source's ``nvcc -Xptxas=-v`` output."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"(qinf_[a-z_]+_kernel)(I.*)?", m[1])
            args = [_PTX_TYPES.get(a, a[2:-1]) for a in re.findall(
                r"13__nv_bfloat16|Li\d+E|(?<=[IE_])[fd](?=[EL])",
                name[2] or "")]
            cur = {"kernel": name[1] + (f"<{','.join(args)}>" if args
                                        else ""), "spill_bytes": 0}
            rows.append(cur)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            regs = int(m[1])
            warp_regs = -(-regs * 32 // 256) * 256
            blocks = 65536 // (warp_regs * 8)
            cur.update(registers=regs, resident_warps=min(64, blocks * 8))
    return rows


# --- phase 3 -------------------------------------------------------------------

# B1's leaves (label, shape, block, storage offset in elements, row stride
# or None, first zeroed element of the last axis or None, B1 takes its
# vector variant): the main path's leaf, ragged leaves, a block of zeros, an
# 8 x 2048x6144 leaf, and the leaves that pick each variant -- the cases of
# tests/test_torch_kernels.py::test_cuda_lastdim_matches_plain.  Vector:
# every block starts 16-byte aligned and holds at most 1024 elements; row:
# rows that break the alignment, a view off it, a wider block.
B1_CASES = [("main", (8, 7840), 256, 0, None, None, True),
            ("block128", (8, 7840), 128, 0, None, None, True),
            ("ragged1d", (129,), 256, 0, None, None, True),
            ("zero_block", (8, 256), 256, 0, None, None, True),
            ("zero_tail", (4, 320), 256, 0, None, 256, True),
            ("row_stride", (8, 7840), 256, 0, 8000, None, True),
            ("large", LARGE, 256, 0, None, None, True),
            ("ragged3d", (3, 7, 11), 256, 0, None, None, False),
            ("unaligned_rows", (5, 129), 256, 0, None, None, False),
            ("offset_view", (8, 7840), 256, 1, None, None, False),
            ("wide_block", (8, 7840), 2048, 0, None, None, False)]


def b1_leaf(torch, shape, offset, row_stride, zero_from, dtype, g,
            device="cuda"):
    """A leaf of ``shape``: ``offset`` elements into its buffer, rows
    ``row_stride`` apart (a view of wider rows), its last axis zero from
    ``zero_from`` on."""
    lead, D = shape[:-1], shape[-1]
    width = row_stride or D
    buf = torch.randn(offset + math.prod(lead) * width, generator=g,
                      device=device) * 3
    x = buf.to(dtype)[offset:].view(*lead, width)[..., :D]
    if zero_from is not None:
        x[..., zero_from:] = 0
    return x


def check_kernels(torch, ops, qk, ref, errs, cases=B1_CASES, device="cuda"):
    """B1 through ``ops.qinf_quantize_lastdim`` (the leaf unpadded, its
    ragged tail read in place) and B2 on its codes, against the plain
    versions on the zero-padded rows, bits {1,2,3,4,7,8}, x f32/bf16/f64;
    each case must take the B1 variant it names.  Records the largest
    difference per kernel in ``errs`` and fails on any."""
    g = torch.Generator(device=device).manual_seed(0)
    n_checked = n_vector = 0
    for label, shape, block, offset, row_stride, zero_from, vector in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            x = b1_leaf(torch, shape, offset, row_stride, zero_from, dtype, g,
                        device)
            if label == "zero_block":
                x[3] = 0
            u = torch.rand(ops.blockwise_shape(shape, block), generator=g,
                           device=device)
            require(device != "cuda" or qk.uses_vector_variant(
                "qinf_quantize_blocks", x, u) is vector,
                f"B1 at {label} {dtype} must take the "
                f"{'vector' if vector else 'row'} variant")
            xb = ops.blockwise_lastdim(x, block=block).reshape(-1, block)
            for bits in (1, 2, 3, 4, 7, 8):
                ck, sk = ops.qinf_quantize_lastdim(x, u, bits=bits,
                                                   block=block)
                require(ck.shape == u.shape
                        and sk.shape == u.shape[:-1] + (1,),
                        f"B1 at {label}: codes {tuple(ck.shape)}, scales "
                        f"{tuple(sk.shape)} for noise {tuple(u.shape)}")
                cp, sp = ref.qinf_quantize_blocks_ref(
                    xb, u.reshape(-1, block), bits)
                ck, sk = ck.reshape(-1, block), sk.reshape(-1, 1)
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
                    e2 = float((dk.double() - dp.double()).abs().max())
                    errs["qinf_dequantize_blocks"] = max(
                        errs["qinf_dequantize_blocks"], e2)
                    require(torch.equal(dk, dp),
                            f"B2 != plain at {label} {dtype}->{out} "
                            f"bits={bits} (max diff {e2})")
                if label == "zero_block":        # node 3's one block
                    zc, zs = ck[3], sk[3]
                elif label == "zero_tail":       # each row's second block
                    zc, zs = ck.view(-1, 2, block)[:, 1], sk.view(-1, 2)[:, 1]
                if label in ("zero_block", "zero_tail"):
                    require(float(zs.abs().max()) == 0.0
                            and int(zc.abs().max()) == 0,
                            f"an all-zero block must give scale 0, codes 0 "
                            f"({label})")
                n_checked += 1
                n_vector += vector
            del x, u, xb, ck, sk, cp, sp
    n_checked += check_b2_variants(torch, qk, ref, errs, device)
    if device == "cuda":
        torch.cuda.synchronize()
    return n_checked, n_vector


def check_b2_variants(torch, qk, ref, errs, device="cuda"):
    """B2's vector and row variants against the plain version (the cases
    of tests/test_torch_kernels.py::test_cuda_dequantize_variants_match_
    plain): widths 256 and 128 (vector), 100 and 3 (row), and a contiguous
    view one row into its buffer (width 100: off the 16-byte alignment,
    row variant; width 256: still aligned, vector), f32/bf16/f64 out.
    Outputs must be exactly equal, and each case must take the variant
    named."""
    g = torch.Generator(device=device).manual_seed(5)
    R, n = 8 * 31 + 5, 0
    for block, offset_rows, vector in ((256, 0, True), (128, 0, True),
                                       (100, 0, False), (3, 0, False),
                                       (100, 1, False), (256, 1, True)):
        buf = torch.randint(-4, 5, (R + offset_rows, block), generator=g,
                            device=device, dtype=torch.int8)
        codes = buf[offset_rows:]
        scales = torch.rand((R, 1), generator=g, device=device) * 3
        scales[7] = 0
        for out in (torch.float32, torch.bfloat16, torch.float64):
            dk = qk.qinf_dequantize_blocks(codes, scales, out)
            require(device != "cuda" or qk.uses_vector_variant(
                "qinf_dequantize_blocks", codes.data_ptr(), dk.data_ptr(),
                block) is vector, f"B2 at width {block}, offset "
                f"{offset_rows} rows, must take the "
                f"{'vector' if vector else 'row'} variant")
            dp = ref.qinf_dequantize_blocks_ref(codes, scales, out)
            e2 = float((dk.double() - dp.double()).abs().max())
            errs["qinf_dequantize_blocks"] = max(
                errs["qinf_dequantize_blocks"], e2)
            require(torch.equal(dk, dp), f"B2 != plain at width {block}, "
                    f"offset {offset_rows} rows, {out} (max diff {e2})")
            n += 1
    return n


def time_kernels(torch, qk, ref, shape, iters: int = 20):
    """Times of B1/B2, their plain versions and the library call, f32 x,
    bits=2, at ``shape`` viewed as (R, 256) rows, each over ``iters``
    back-to-back calls."""
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
            "ms": cuda_ms(torch, lambda: qk.qinf_quantize_blocks(x, u, 2),
                          iters),
            "plain_ms": cuda_ms(
                torch, lambda: ref.qinf_quantize_blocks_ref(x, u, 2), iters),
            "bound_ms": b1_bound[0], "bound_by": b1_bound[1],
            "library_ms": None},
        "qinf_dequantize_blocks": {
            "rows": list(x.shape),
            "ms": cuda_ms(torch, lambda: qk.qinf_dequantize_blocks(codes,
                                                                   scales),
                          iters),
            "plain_ms": cuda_ms(
                torch, lambda: ref.qinf_dequantize_blocks_ref(codes, scales),
                iters),
            "bound_ms": b2_bound[0], "bound_by": b2_bound[1],
            "library_ms": cuda_ms(torch, lambda: torch.mul(codes, scales),
                                  iters)},
    }
    del x, u, codes, scales, out, lib
    return res


def device_us(torch, fn, calls: int = MAIN_SHAPE_ITERS):
    """Device time of one call of ``fn`` under ``torch.profiler`` over
    ``calls`` back-to-back calls, each launching the same device
    operations: for every operation name, its median duration times its
    launches a call, summed (us); with the operations a call makes and
    their names.  (The profiler may drop an event at the window's edge,
    so calls are not cut from the event stream one by one.)"""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            by_name.setdefault(e["name"], []).append(e["dur"])
    per = {k: round(len(v) / calls) for k, v in by_name.items()}
    require(bool(by_name) and all(per.values()),
            f"device operations in {calls} calls: "
            f"{ {k[:60]: len(v) for k, v in by_name.items()} }")
    us = sum(sorted(v)[len(v) // 2] * per[k] for k, v in by_name.items())
    return {"us": us, "ops_per_call": sum(per.values()),
            "names": [k[:90] for k in by_name]}


def b1_at_main_path(torch, ops, qk, ref, iters: int = MAIN_SHAPE_ITERS):
    """B1 as the dense main path calls it: ``ops.qinf_quantize_lastdim`` on
    the (8, 7840) f32 leaf, 2 bits, timed with CUDA events over ``iters``
    back-to-back calls beside its plain version (pad + plain B1) and its
    bytes bound; and device time per call from ``torch.profiler`` (median
    of ``iters`` calls) of that call, of B1 on (248, 256) rows, and of a
    one-kernel PyTorch op on 248 floats (``zero_``), the launch floor."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((8, 7840), generator=g, device="cuda")
    u = torch.rand(ops.blockwise_shape(x.shape, 256), generator=g,
                   device="cuda")
    codes, scales = ops.qinf_quantize_lastdim(x, u, bits=2)

    def plain():
        return ref.qinf_quantize_blocks_ref(
            ops.blockwise_lastdim(x, block=256).reshape(-1, 256),
            u.reshape(-1, 256), 2)

    cp, sp = plain()
    require(torch.equal(codes.reshape(-1, 256), cp)
            and torch.equal(scales.reshape(-1, 1), sp),
            "B1 on the main path's leaf != plain")
    rows = ops.blockwise_lastdim(x, block=256).reshape(-1, 256)
    urows = u.reshape(-1, 256)
    floor = torch.empty(248, device="cuda")
    res = {"leaf": list(x.shape),
           "ms": cuda_ms(torch, lambda: ops.qinf_quantize_lastdim(x, u,
                                                                  bits=2),
                         iters),
           "plain_ms": cuda_ms(torch, plain, iters)}
    res["bound_ms"], res["bound_by"] = bound_ms(
        nbytes(x, u, codes, scales), B1_OPS_PER_ELEMENT * x.numel())
    res["device_us"] = {
        "lastdim_leaf": device_us(
            torch, lambda: ops.qinf_quantize_lastdim(x, u, bits=2), iters),
        "b1_248x256": device_us(
            torch, lambda: qk.qinf_quantize_blocks(rows, urows, 2), iters),
        "launch_floor_zero_248": device_us(torch, floor.zero_, iters)}
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


def profile_steps(torch, runner, st, draws, steps: int = PROFILE_STEPS,
                  trace_name: str = "main_path_trace.json"):
    """Where a step's time goes: ``torch.profiler`` over ``steps`` steps;
    device time is the sum of the kernel, memcpy and memset spans of the
    exported trace, the busy share that sum over the fenced wall time;
    every device operation by name (time and count a step), B1's launches
    a step and the operations that ran just before them."""
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
    trace = OUT_DIR / trace_name
    prof.export_chrome_trace(str(trace))
    device = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    require(bool(device), "the profiler saw no device work in the main path")
    device.sort(key=lambda e: e["ts"])
    by_name = {}
    for e in device:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    b1 = [i for i, e in enumerate(device) if B1_KERNEL.search(e["name"])]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms / steps,
            "busy_share": busy_ms / wall_ms,
            "device_ops_per_step": len(device) / steps,
            "b1_per_step": len(b1) / steps,
            "before_b1": sorted({device[i - 1]["name"] for i in b1 if i}),
            "names": [{"name": k[:90], "us_per_step": ms * 1e3 / steps,
                       "per_step": n / steps}
                      for k, (ms, n) in sorted(by_name.items(),
                                               key=lambda kv: -kv[1][0])]}


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
    require(profile["b1_per_step"] == 1,
            f"the profile saw {profile['b1_per_step']} B1 launches a step")
    require(not any(PAD_KERNEL.search(n) for n in profile["before_b1"]),
            f"a pad kernel runs just before B1: {profile['before_b1']}")
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


def check_b4(torch, ref, P, Sc, w, bits, out, got, errs, what: str) -> None:
    """Kernel B4's (mix, qself) against its plain version on the same
    inputs, node by node (so the plain version's temporaries are one
    node's size): both exactly equal (kernel and plain version sum the
    senders in one order, one rounding per operation); the largest mix
    difference goes into ``errs``."""
    mk, qk_ = got
    for n in range(P.shape[0]):
        nd = slice(n, n + 1)
        mr, qr = ref.qinf_unpack_dequant_mix_blocks_ref(P[nd], Sc[nd], w[nd],
                                                        bits, out)
        e4 = float((mk[nd].double() - mr.double()).abs().max())
        errs["qinf_unpack_dequant_mix_blocks"] = max(
            errs["qinf_unpack_dequant_mix_blocks"], e4)
        require(torch.equal(qk_[nd], qr),
                f"B4 qself != plain {what} (node {n})")
        require(torch.equal(mk[nd], mr),
                f"B4 mix != plain {what} (node {n}, max diff {e4})")
        del mr, qr


# (bits, block, S, payload offset in bytes, B4 variant is the vector one):
# every bits x block at S = 1, 3, 4 (4: exponential-8's self + 3 hops) on
# the vector variant, then the row variant's shapes -- payload rows that
# are not whole 16-byte chunks, a payload off the 16-byte alignment, more
# senders than the vector variant holds (5, one past its 4, and 9; the
# cases of
# tests/test_torch_wire_kernels.py's cuda tests)
WIRE_CASES = ([(bits, block, S, 0, True) for bits in (1, 2, 3, 4, 7)
               for block in (128, 256) for S in (1, 3, 4)]
              + [(2, 40, 3, 0, False), (4, 24, 3, 0, False),
                 (2, 256, 3, 8, False), (4, 128, 4, 4, False),
                 (2, 256, 5, 0, False), (2, 128, 9, 0, False)])


def check_wire_kernels(torch, qk, ref, errs, n_nodes=2, rows=8 * 31 + 5,
                       device="cuda"):
    """B3/B4 vs their plain versions on every case of :data:`WIRE_CASES`,
    T (rounds) 1 and 3, f32/bf16/f64 out, a ragged row count, a block of
    zeros; records the largest difference per kernel in ``errs``.  Returns
    (B4 cases, of which on the vector variant)."""
    g = torch.Generator(device=device).manual_seed(2)
    n_checked = n_vector = 0
    for bits, block, S, offset, vector in WIRE_CASES:
        what = f"at bits={bits} block={block} S={S} offset={offset}"
        x = torch.randn((n_nodes * S * rows, block), generator=g,
                        device=device) * 3
        x[5] = 0
        u = torch.rand(x.shape, generator=g, device=device)
        pk, sk = qk.qinf_quantize_pack_blocks(x, u, bits)
        check_b3(torch, ref, x, u, bits, (pk, sk), errs, what)
        require(float(sk[5]) == 0.0, "an all-zero block needs scale 0")
        buf = torch.empty(pk.numel() + offset, dtype=torch.uint8,
                          device=device)
        P = buf[offset:].view(n_nodes, S, rows, -1)
        P.copy_(pk.view(n_nodes, S, rows, -1))
        Sc = sk.reshape(n_nodes, S, rows, 1)
        for T in (1, 3):
            w = torch.randn((n_nodes, T, S), generator=g, device=device)
            for out in (torch.float32, torch.bfloat16, torch.float64):
                got = qk.qinf_unpack_dequant_mix_blocks(P, Sc, w, bits, out)
                require(device != "cuda" or qk.uses_vector_variant(
                    "qinf_unpack_dequant_mix_blocks", P.data_ptr(),
                    got[0].data_ptr(), got[1].data_ptr(), P.shape[-1], S)
                        is vector, f"B4 {what} must take the "
                        f"{'vector' if vector else 'row'} variant")
                check_b4(torch, ref, P, Sc, w, bits, out, got, errs,
                         f"{what} T={T} {out}")
                n_checked += 1
                n_vector += vector
        del x, u, pk, sk, buf, P, Sc
    return n_checked, n_vector


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
    qself and mix must be equal; the largest differences go into
    ``errs``.  Times are of the block-256 group.  No
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
        require(device != "cuda" or qk.uses_vector_variant(
            "qinf_unpack_dequant_mix_blocks", P.data_ptr(), mix.data_ptr(),
            qself.data_ptr(), P.shape[-1], 3),
            f"B4 {what} must take the vector variant")
        check_b4(torch, ref, P, Sc, w, 2, torch.float32, (mix, qself), errs,
                 what)
        checked.append({"block": block, "rows": [n_nodes, 3, rows_, block],
                        "mix_bit_equal": True})
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


# --- phase 9 -------------------------------------------------------------------

def paper_grid(torch, qk, cm, fig, steps: int = PAPER_STEPS,
               device="cuda"):
    """One figure's grid on ``device``, row by row, the launch counters
    zeroed around each row; every claim must pass."""
    t0 = time.perf_counter()
    grid, xstar = fig.setup(steps, device=device)
    solve_s = time.perf_counter() - t0
    rows = []
    for label, spec in grid:
        qk.reset_launch_counts()
        [r] = cm.run_cells([(label, spec)], xstar, steps, device=device)
        n = qk.launch_counts()
        want = steps if spec.compressor.name == "qinf" else 0
        require(n[B1] == want and n[B2] == want and sum(n.values()) ==
                2 * want, f"{label}: launches {n}, want {want} of B1 and of "
                f"B2 ({steps} steps)")
        require(all(math.isfinite(v) for v in r.subopt),
                f"{label}: non-finite suboptimality")
        rows.append({**r.row(), "launches": {B1: n[B1], B2: n[B2]}})
    checks = [{"claim": c, "ok": bool(ok), "value": str(v)}
              for c, ok, v in fig.validate(rows)]
    failed = [c["claim"] for c in checks if not c["ok"]]
    require(not failed, f"claims failed: {failed}")
    return {"rows": rows, "checks": checks, "solve_reference_s": solve_s,
            "seconds": time.perf_counter() - t0}


def baseline_card_vs_cpu(torch, api, convert, draws_mod, label, spec,
                         steps: int = PAPER_REPLAY_STEPS, device="cuda"):
    """A baseline, one step at a time from the card's state: the plain CPU
    path draws, the card replays; X compared at phase 4's tolerance."""
    f64 = torch.float64
    cpu = api.build(spec, device="cpu", dtype=f64)
    card = api.build(spec, device=device, dtype=f64)
    gen = draws_mod.GeneratorDraws(spec.seed, "cpu")
    rec = draws_mod.RecordingDraws(gen)
    cpu.init_state(rec)
    st = card.init_state(draws_mod.ReplayDraws(rec.record, device))
    worst_frac = worst_rel = 0.0
    for _ in range(steps):
        rec = draws_mod.RecordingDraws(gen)
        want = cpu.step(convert.simple_state_from_arrays(
            convert.simple_state_to_arrays(st), device="cpu", dtype=f64),
            rec)
        replay = draws_mod.ReplayDraws(rec.record, device)
        st = card.step(st, replay)
        require(not replay.pending, "the card drew less than the CPU path")
        got = st.X.cpu()
        scale = float(want.X.abs().max())
        off = (got - want.X).abs() > REPLAY_ELEM_TOL * scale
        worst_frac = max(worst_frac, float(off.double().mean()))
        worst_rel = max(worst_rel, float((got - want.X).abs().max()) / scale)
        require(worst_frac <= REPLAY_MAX_OFF,
                f"{label} card vs CPU step {st.k}: {int(off.sum())} of "
                f"{off.numel()} elements of X differ by more than "
                f"{REPLAY_ELEM_TOL} x max|X|")
    return {"steps": steps, "worst_off_fraction": worst_frac,
            "worst_rel_max": worst_rel}, st.X


def empirical_C_on_card(torch, qk, compression, draws_mod, x,
                        trials: int = EMPIRICAL_C_TRIALS):
    """2-bit QInf's empirical C on ``x``: one B1 and one B2 launch on the
    card, the plain version's value from the same noise, the analytic C."""
    comp = compression.make_compressor("qinf", bits=2, block=256)
    rec = draws_mod.RecordingDraws(draws_mod.GeneratorDraws(0, x.device))
    qk.reset_launch_counts()
    got = compression.empirical_C(comp, x, rec, trials=trials)
    n = qk.launch_counts()
    require(n[B1] == 1 and n[B2] == 1 and sum(n.values()) == 2,
            f"empirical_C launched {n}, want one B1 and one B2")
    plain = compression.empirical_C(
        comp, x.cpu(), draws_mod.ReplayDraws([u.cpu() for u in rec.record],
                                             "cpu"), trials=trials)
    require(abs(got - plain) <= 1e-12 * abs(plain),
            f"empirical_C {got!r} on the card, {plain!r} plain")
    require(0.0 < got <= comp.C, f"empirical_C {got} outside (0, {comp.C}]")
    return {"trials": trials, "leaf": list(x.shape), "C_card": got,
            "C_plain": plain, "C_analytic": comp.C, "launches": n}


def paper_comparisons(torch, api, convert, draws_mod, qk, device="cuda",
                      steps: int = PAPER_STEPS,
                      replay_steps: int = PAPER_REPLAY_STEPS):
    from repro_torch.core import compression
    from repro_torch.paper import common as cm
    from repro_torch.paper import fig1_smooth, fig2_nonsmooth
    from repro_torch.paper import table3_complexity as table3
    out = {"grids": {}}
    for key, fig in (("fig1", fig1_smooth), ("fig2", fig2_nonsmooth)):
        out["grids"][key] = paper_grid(torch, qk, cm, fig, steps, device)
    L = cm.estimate_L(cm.flat_logreg(device="cpu"))
    eta = 1.0 / (2 * L)
    by = dict(fig1_smooth.cells(replay_steps, eta, eta / 3)
              + fig2_nonsmooth.cells(replay_steps, eta, eta / 3))
    # where a 2-bit row's step goes: LEAD (2bit) of Fig. 1 under the profiler
    spec = by["LEAD (2bit)"]
    runner = api.build(spec, device=device, dtype=torch.float64)
    d = draws_mod.GeneratorDraws(spec.seed, device)
    st = runner.init_state(d)
    for _ in range(5):
        st = runner.step(st, d)
    out["lead2_profile"] = profile_steps(torch, runner, st, d,
                                         PAPER_PROFILE_STEPS,
                                         "paper_lead2bit_trace.json")
    require(out["lead2_profile"]["b1_per_step"] == 1,
            "the LEAD (2bit) profile saw "
            f"{out['lead2_profile']['b1_per_step']} B1 launches a step")
    # (b) Table 3: measured rates within their theorem envelopes
    t0 = time.perf_counter()
    qk.reset_launch_counts()
    rows = table3.run(device=device)
    out["table3"] = {"rows": rows, "launches": qk.launch_counts(),
                     "seconds": time.perf_counter() - t0}
    bad = [r["name"] for r in rows if not r["ok"]]
    require(not bad, f"Table 3 rates outside their envelopes: {bad}")
    # (c) the baselines, card against CPU, at the paper's rows
    out["card_vs_cpu"] = {}
    for label in ("DGD", "PG-EXTRA/P2D2 (32bit)", "Choco (2bit)",
                  "LessBit (2bit)"):
        out["card_vs_cpu"][label], X = baseline_card_vs_cpu(
            torch, api, convert, draws_mod, label, by[label], replay_steps,
            device)
    # (d) empirical_C on the last LessBit iterate
    out["empirical_C"] = empirical_C_on_card(torch, qk, compression,
                                             draws_mod, X)
    return out


T_START = time.perf_counter()


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
        ptxas = {name: ptxas_report(qk.build_log(name).read_text())
                 for name in libs}
        result["ptxas"] = ptxas
        for name, rows in ptxas.items():
            for r in rows:
                print(f"[build] {name}: {r['kernel']}: {r['registers']} "
                      f"registers, {r['spill_bytes']} B spilled, "
                      f"{r['resident_warps']} resident warps/SM", flush=True)

        # 3. kernels against their plain versions
        errs = {k: 0.0 for k in qk.LAUNCHES}
        t0 = time.perf_counter()
        n, n_vector = check_kernels(torch, ops, qk, ref, errs)
        times = {"main": time_kernels(torch, qk, ref, (8, 31 * 256),
                                      iters=MAIN_SHAPE_ITERS),
                 "large": time_kernels(torch, qk, ref, LARGE)}
        b1_main = b1_at_main_path(torch, ops, qk, ref)
        print(f"[kernels] {n} cases bit-equal to the plain versions (B1 "
              f"through the leaf route: {n_vector} on its vector variant, "
              f"the rest on its row variant) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for where, tt in times.items():
            for k, v in tt.items():
                print(f"[kernels] {k} @ {where} {v['rows']}: "
                      f"{v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, bound "
                      f"{v['bound_ms']:.5f}, library {v['library_ms']}) "
                      f"| {smi}", flush=True)
        print(f"[kernels] qinf_quantize_lastdim @ leaf {b1_main['leaf']}: "
              f"{b1_main['ms']:.5f} ms (plain: pad + plain B1 "
              f"{b1_main['plain_ms']:.5f}, bound {b1_main['bound_ms']:.5f}) "
              f"| {smi}", flush=True)
        for k, v in b1_main["device_us"].items():
            print(f"[kernels] device time a call, {k}: {v['us']:.3f} us "
                  f"(median of {MAIN_SHAPE_ITERS}), {v['ops_per_call']} "
                  f"device op(s): {v['names']} | {smi}", flush=True)

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
        for t in pf["names"]:
            print(f"[main]   {t['us_per_step']:8.2f} us/step "
                  f"x{t['per_step']:.0f}  {t['name']}", flush=True)
        print(f"[main] just before B1: {pf['before_b1']}", flush=True)

        # 5. B3/B4 against their plain versions, timed at the slice's shape
        t0 = time.perf_counter()
        n, n_vector = check_wire_kernels(torch, qk, ref, errs)
        wtimes, at_slice = wire_kernels_at_slice_shape(torch, qk, ref, errs)
        print(f"[wire] {n} B4 cases ({n_vector} on the vector variant, "
              f"{n - n_vector} on the row variant) and their B3 inputs "
              f"against the plain versions: B3 bytes/scales, B4 qself and "
              f"mix bit-equal; the same at the trainer's groups "
              f"{[c['rows'] for c in at_slice]}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for k, v in wtimes.items():
            print(f"[wire] {k} @ {v['rows']}: {v['ms']:.4f} ms (plain "
                  f"{v['plain_ms']:.4f}, bound {v['bound_ms']:.4f} by "
                  f"{v['bound_by']}, library none) | {smi}", flush=True)
        result["wire_kernels"] = {"cases": n, "vector_cases": n_vector,
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

        # 9. the paper's comparisons on the card
        t0 = time.perf_counter()
        pc = paper_comparisons(torch, api, convert, draws_mod, qk)
        pc["seconds"] = time.perf_counter() - t0
        result["paper"] = pc
        for key, g in pc["grids"].items():
            print(f"[paper] {key}: {len(g['rows'])} rows x {PAPER_STEPS} "
                  f"steps, f64, in {g['seconds']:.1f} s (X* by "
                  f"solve_reference {g['solve_reference_s']:.1f} s) | {smi}",
                  flush=True)
            for r in g["rows"]:
                print(f"[paper]   {r['name']:24s} final subopt "
                      f"{r['final_subopt']:.4e}  {r['bits_per_iter']:.0f} "
                      f"bits/step  {r['ms_per_step']:.4f} ms/step  B1/B2 "
                      f"launches {r['launches'][B1]}/{r['launches'][B2]}",
                      flush=True)
            for c in g["checks"]:
                print(f"[paper]   [{'PASS' if c['ok'] else 'FAIL'}] "
                      f"{c['claim']}   [{c['value']}]", flush=True)
        pf = pc["lead2_profile"]
        print(f"[paper] profile of LEAD (2bit), {pf['steps']} steps: "
              f"{pf['wall_ms_per_step']:.4f} ms/step wall, "
              f"{pf['device_ms_per_step']:.4f} ms/step on the device (busy "
              f"{pf['busy_share']:.1%}), {pf['device_ops_per_step']:.0f} "
              f"device ops/step | {smi}", flush=True)
        for t_ in pf["names"][:12]:
            print(f"[paper]   {t_['us_per_step']:8.2f} us/step "
                  f"x{t_['per_step']:.0f}  {t_['name']}", flush=True)
        for r in pc["table3"]["rows"]:
            print(f"[paper] table3 {r['name']:18s} rho measured "
                  f"{r['rho_measured']:.6f} <= theory {r['rho_theory']:.6f}"
                  f" + 1e-3: {r['ok']}", flush=True)
        for label, v in pc["card_vs_cpu"].items():
            print(f"[paper] card vs CPU, {v['steps']} steps of {label}: "
                  f"worst off fraction {v['worst_off_fraction']:.2e}, worst "
                  f"|diff|/max {v['worst_rel_max']:.2e}", flush=True)
        ec = pc["empirical_C"]
        print(f"[paper] empirical_C (2-bit QInf, {ec['leaf']}, "
              f"{ec['trials']} trials): {ec['C_card']!r} on the card, "
              f"{ec['C_plain']!r} plain, analytic C {ec['C_analytic']}; "
              f"launches {ec['launches']}; phase {pc['seconds']:.1f} s",
              flush=True)

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
            extra = {"large": times["large"][name_], "paper_launches": {
                r["name"]: r["launches"][name_]
                for g in pc["grids"].values() for r in g["rows"]
                if r["launches"][name_]}}
            if name_ == "qinf_quantize_blocks":
                extra["main_path_leaf"] = b1_main
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
    result["seconds"] = time.perf_counter() - T_START
    print(f"[done] chip_smoke.py ran {result['seconds']:.1f} s, the build "
          f"included | {smi}", flush=True)
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
