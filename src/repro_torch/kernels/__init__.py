# Hand-written CUDA kernels for the compression hot spot, and their plain
# PyTorch versions:
#   csrc/qinf.cu — B1 quantize / B2 dequantize for sm_90a
#   quantize.py  — nvcc build, ctypes binding, device dispatch, launch counts
#   ops.py       — rank-generic last-dim blocking on top of B1/B2
#   ref.py       — plain PyTorch versions (the CPU path and the yardstick)
