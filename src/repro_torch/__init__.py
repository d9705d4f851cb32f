"""repro_torch: TurboFFT on PyTorch and CUDA for an NVIDIA H100.

The port of the JAX package ``repro``, slice by slice. Its kernels are CUDA
C++ for ``sm_90a`` under ``kernels/csrc``, built with ``nvcc`` at first use;
on a CPU tensor every kernel wrapper runs its plain torch version instead.
"""

__version__ = "0.1.0"
