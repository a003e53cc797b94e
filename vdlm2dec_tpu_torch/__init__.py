"""vdlm2dec_tpu_torch: the VDL Mode 2 decoder on PyTorch and CUDA.

A port of vdlm2dec_tpu (JAX) beside it.  It imports torch and never jax;
the framework-free modules of vdlm2dec_tpu (constants, golden, host, io,
metrics) are shared.  The sync scan runs as a hand-written CUDA kernel
(csrc/sync_scan.cu) on a card and as plain PyTorch on the CPU.
"""
__version__ = "0.1.0"
