"""bwamem_tpu_torch — the BWA-MEM-class aligner of `bwamem_tpu`, in PyTorch
with hand-written CUDA kernels for an NVIDIA H100.

Same pipeline, same output: the JAX package `bwamem_tpu` is the reference
this package is held against, byte for byte on the SAM it writes.

Layout (each module sits at the same relative path as its JAX twin):
  index/     index toolchain (copied host code) + the device-layout index
  ops/       torch device stages: FM primitives, SMEM seeding, window
             gathers, extension glue; ops/kernels/ holds the kernel
             wrappers, csrc/ their CUDA sources
  pipeline/  host orchestration (copied) + the MemAligner
  models/    the fused device step (seeds to merged coordinates)
  parallel/  data parallel over the GPUs of a process (sharded.py) and
             over hosts (multihost.py, copied but for the Gloo join)
  native/    ctypes loader of the shared C++ core (<repo>/native)
  io/, oracle/, utils/  copied host helpers

This package imports torch and never jax or bwamem_tpu.
"""

__version__ = "0.1.0"
