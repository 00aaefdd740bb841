"""PyTorch/CUDA port of the VTA reproduction (the numpy/JAX package ``repro``
is the reference it is held against).

The compiler stays host-side numpy, copied module for module from the
reference so that both emit byte-identical programs; everything that runs
per request (the DRAM stack, staging, the §3.2 codecs, the GEMM and the
TensorAlu epilogue) is torch on an explicit device.  The GEMM is the
hand-written CUDA kernel ``kernels/csrc/vta_gemm.cu``.  This package never
imports ``jax`` or ``repro``.
"""
