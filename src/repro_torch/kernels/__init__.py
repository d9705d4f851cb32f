"""CUDA kernels for the paper's compute hot spots (sm_90a, csrc/).

stockham.py       -- block FFT (csrc/block_fft.cu) + its plain torch version
stockham_abft.py  -- + fused two-sided ABFT (csrc/abft_fft.cu), one
                     thread-block cluster per checksum group
ft_matmul.py      -- fused two-side ABFT GEMM (csrc/ft_matmul.cu) + its
                     plain torch version; the core.gemm plan runs it
ft_matmul_tiles.py -- times the GEMM kernel with each CTA tile on a card
                     (``python -m repro_torch.kernels.ft_matmul_tiles``)
ops.py            -- public entry points (fft / ifft / ft_fft)
ref.py            -- torch.fft / torch.matmul oracles for the tests
_build.py         -- nvcc at first use, ctypes loading
"""
from . import ops, ref
from .ops import fft, ifft, ft_fft, FTFFTResult
from repro_torch.core.fft.api import FFTSpec, FTConfig, plan

__all__ = ["ops", "ref", "fft", "ifft", "ft_fft", "FTFFTResult",
           "FFTSpec", "FTConfig", "plan"]
