#!/usr/bin/env python3
"""B4's vector kernel at other chunk sizes than the ones built, beside the
built kernel, on one NVIDIA card.

    python3 b4_chunks.py

B4's vector variant (``src/repro_torch/kernels/csrc/qinf_wire.cu``)
streams the senders in chunks of ``MixChunk<TOut, kRounds>::kSenders``
and accumulates up to ``kMaxRounds`` rounds at once.  This script builds
the source again with the f32 chunks of each row of :data:`CANDIDATES`
(one-round senders, two-round senders, rounds at most), one ``nvcc`` a
variant, all started together.  Each build's launchers are swapped into
the binding in turn and B4 (f32 out, 2 bits) is run at
the ring trainer's block-256 group (8 x 3 x 700,456 rows of 256, T = 1),
mixtral-8x7b's router group (8 x 3 x 131,072 rows of 8, T = 1) and the
alternating trainer's group (8 x 6 x 700,456 rows, T = 2,
``chip_smoke.alternating_payloads``): mix and qself must equal the plain
version's, and each build is timed twice (CUDA events, 20 calls; every
build in turn, then in reverse order).  Prints each build's registers and
spill bytes a thread (``ptxas -v``) for its f32 vector instances, the
times, the card's line from ``nvidia-smi``, and one JSON object, also
written to ``chiprun_out/b4_chunks.json``.  Exits non-zero without a CUDA
device.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
#: (senders of the one-round chunk, of the two-round chunk, rounds at
#: most) for f32; the first row is what the source builds
CANDIDATES = ((4, 8, 2), (3, 8, 2), (6, 8, 2), (8, 8, 2), (4, 6, 2),
              (4, 4, 2), (4, 8, 1))


def variant_source(src: str, one: int, two: int, rounds: int) -> str:
    """``qinf_wire.cu`` with the f32 chunks set to ``one``/``two`` senders
    and at most ``rounds`` rounds at once (f64 and bf16 as built)."""
    for k, v in ((1, one), (2, two)):
        src, n = re.subn(rf"(struct MixChunk<float, {k}> {{\n  static "
                         rf"constexpr int kSenders = )\d+", rf"\g<1>{v}", src)
        assert n == 1, f"MixChunk<float, {k}> not found"
    src, n = re.subn(r"(template <typename TOut>\nconstexpr int kMaxRounds "
                     r"= )\d+", rf"\g<1>{rounds}", src)
    assert n == 1, "kMaxRounds not found"
    return src


def f32_registers(log: str) -> list:
    """(instance, registers, spill bytes) of every f32 B4 vector instance
    in one build's ``ptxas -v`` output."""
    return [(f"<f32,{m[1]}>", int(m[3]), int(m[2])) for m in re.finditer(
        r"mix_vec_kernelIfLi(\d)EE.*?(\d+) bytes spill stores.*?"
        r"Used (\d+) registers", log, re.S)]


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("b4_chunks.py: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import ref
    libs = qk._libs()
    smi = cs.smi_line()
    work = OUT_DIR / "b4_chunks"
    work.mkdir(parents=True, exist_ok=True)
    src = qk.SOURCES["qinf_wire"].read_text()
    builds = {}
    for cand in CANDIDATES[1:]:
        f = work / ("v_" + "_".join(map(str, cand)) + ".cu")
        f.write_text(variant_source(src, *cand))
        builds[str(cand)] = f
    jobs = {k: subprocess.Popen(
        [qk._nvcc(), *qk.NVCC_FLAGS, "-I", str(qk._CSRC), "-o",
         str(f.with_suffix(".so")), str(f)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, f in builds.items()}
    wires = {str(CANDIDATES[0]): libs["qinf_wire"]}
    registers = {str(CANDIDATES[0]): f32_registers(
        qk.build_log("qinf_wire").read_text())}
    for k, proc in jobs.items():
        log = proc.communicate()[0]
        cs.require(proc.returncode == 0, f"nvcc failed on {k}:\n{log}")
        wires[k] = ctypes.CDLL(str(builds[k].with_suffix(".so")))
        registers[k] = f32_registers(log)
    for k, regs in registers.items():
        print(f"[chunks] {k}: " + ", ".join(
            f"{n} {r} registers, {sp} B spilled" for n, r, sp in regs),
            flush=True)
    q, b = libs["qinf"], libs["binding"]

    def addr(fn) -> int:
        return ctypes.cast(fn, ctypes.c_void_p).value

    def use(w) -> None:
        b.set_launchers(addr(q.qinf_quantize_blocks_launch),
                        addr(q.qinf_dequantize_blocks_launch),
                        addr(w.qinf_quantize_pack_blocks_launch),
                        addr(w.qinf_unpack_dequant_mix_blocks_launch),
                        addr(q.qinf_error_string))

    def shapes():
        g = torch.Generator(device="cuda").manual_seed(256)
        for name, block, rows in (("ring_t1", 256, cs.SLICE_GROUP_ROWS),
                                  ("router", 8, 131_072)):
            x = torch.randn((8 * rows, block), generator=g, device="cuda")
            u = torch.rand(x.shape, generator=g, device="cuda")
            packed, scales = qk.qinf_quantize_pack_blocks(x, u, 2)
            del x, u
            P, Sc = cs.ring_payloads(torch, packed, scales, 8, rows)
            yield name, P, Sc, torch.full((8, 1, 3), 1.0 / 3.0,
                                          device="cuda")
        P, _, Sc, w = cs.alternating_payloads(torch, qk)
        yield "alternating_t2", P, Sc, w

    times = {}
    order = list(wires)
    for name, P, Sc, w in shapes():
        mr, qr = ref.qinf_unpack_dequant_mix_blocks_ref(P, Sc, w, 2)
        times[name] = {k: [] for k in order}
        for k in order + order[::-1]:
            use(wires[k])
            mk, qk_ = qk.qinf_unpack_dequant_mix_blocks(P, Sc, w, 2)
            cs.require(torch.equal(mk, mr) and torch.equal(qk_, qr),
                       f"B4 build {k} != plain at {name}")
            del mk, qk_
            times[name][k].append(cs.cuda_ms(
                torch, lambda: qk.qinf_unpack_dequant_mix_blocks(P, Sc, w,
                                                                 2)))
        for k, v in times[name].items():
            print(f"[chunks] {name} {list(P.shape)} T={w.shape[1]} {k}: "
                  f"{sum(v) / 2:.4f} ms ({v[0]:.4f}, {v[1]:.4f}) | {smi}",
                  flush=True)
        del P, Sc, w, mr, qr
        torch.cuda.empty_cache()
    use(libs["qinf_wire"])
    out = {"card": smi, "registers": registers, "ms": times}
    (OUT_DIR / "b4_chunks.json").write_text(json.dumps(out, indent=1))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
