"""vdlm2dec_tpu_torch: the VDL Mode 2 decoder on PyTorch and CUDA.

A port of vdlm2dec_tpu (JAX) beside it.  It imports torch and never jax;
the framework-free modules of vdlm2dec_tpu (constants, golden, host, io,
metrics) are shared.  The sync scan (csrc/sync_scan.cu) and the fused u8
channelizer (csrc/chan_u8.cu) run as hand-written CUDA kernels on a card
and as plain PyTorch on the CPU.
"""
__version__ = "0.1.0"
