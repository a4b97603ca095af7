"""PyTorch and CUDA port of the VAuLT system, for NVIDIA Hopper (H100).

The JAX package ``vault_tpu`` is the reference this package is held
against; this package imports nothing of it and nothing of JAX.  Module
names follow that package's.  The TPU's Pallas kernels on the serving path
are hand-written CUDA kernels here (``csrc/``), built from source at first
use (``ops/_build.py``); each has its plain PyTorch version beside it, which
runs for tensors on the CPU.
"""
