# Hand-written CUDA kernels for the compression hot spot, and their plain
# PyTorch versions:
#   csrc/qinf.cu      — B1 quantize / B2 dequantize for sm_90a
#   csrc/qinf_wire.cu — B3 quantize+pack / B4 unpack+dequantize+mix
#   csrc/binding.cpp  — the CPython module every launch goes through
#   quantize.py       — build (nvcc, C++), loading, device dispatch, launch counts
#   ops.py            — rank-generic last-dim blocking and the wire ops
#   ref.py            — plain PyTorch versions (the CPU path and the yardstick)
