"""PyTorch port of the Prox-LEAD reproduction (``repro``), for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package redoes its dense
engine in PyTorch and replaces its Pallas TPU kernels with hand-written
CUDA kernels (``repro_torch.kernels``).  It imports neither ``jax`` nor
``repro``.  Entry point: :func:`repro_torch.api.build`, which runs on the
card unless the caller asks for ``device="cpu"``.
"""
