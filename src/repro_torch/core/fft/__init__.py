"""TurboFFT core: plans, factor/twiddle tables, Stockham FFT, large-N passes,
and the plan/execute front door."""
from . import factors
from .plan import (Plan, StagePlan, make_plan, block_radices,
                   plan_from_reference)
from .stockham import (fft, ifft, fft_with_plan, block_fft_stages, naive_dft,
                       radix2_fft)
from .large import fft_large
from .api import (FFTSpec, FTConfig, FFTPlan, plan, spec_for,
                  plan_cache_info, plan_cache_clear)

__all__ = [
    "factors", "Plan", "StagePlan", "make_plan", "block_radices",
    "plan_from_reference", "fft", "ifft", "fft_with_plan",
    "block_fft_stages", "naive_dft", "radix2_fft", "fft_large",
    "FFTSpec", "FTConfig", "FFTPlan", "plan", "spec_for", "plan_cache_info",
    "plan_cache_clear",
]
