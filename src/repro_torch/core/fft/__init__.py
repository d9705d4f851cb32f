"""TurboFFT core: plans, factor/twiddle tables, Stockham FFT, large-N passes,
the local extensions (real-input, 2-D/n-D, spectral consumers), the sharded
1-D transform, its grouped ABFT and spectral round trip on
torch.distributed, and the plan/execute front door."""
from . import factors
from .plan import (Plan, StagePlan, make_plan, block_radices,
                   plan_from_reference)
from .stockham import (fft, ifft, fft_with_plan, block_fft_stages, naive_dft,
                       radix2_fft)
from .large import fft_large

__all__ = [
    "factors", "Plan", "StagePlan", "make_plan", "block_radices",
    "plan_from_reference", "fft", "ifft", "fft_with_plan",
    "block_fft_stages", "naive_dft", "radix2_fft", "fft_large",
]
from .extensions import (rfft, irfft, fft2, ifft2, rfft2,  # noqa: E402
                         irfft2, ft_ifft)

__all__ += ["rfft", "irfft", "fft2", "ifft2", "rfft2", "irfft2", "ft_ifft"]

from .spectral import (fft_convolve, correlate, power_spectrum,  # noqa: E402
                       conv_spec)

__all__ += ["fft_convolve", "correlate", "power_spectrum", "conv_spec"]

from .distributed import (DistPlan, make_dist_plan,  # noqa: E402
                          distributed_fft, distributed_ifft,
                          DistFFTResult, ft_distributed_fft,
                          resolve_abft_groups, resolve_chunks,
                          choose_chunks, collective_volume, spectral_volume,
                          FFT_AXIS, DATA_AXIS)

__all__ += ["DistPlan", "make_dist_plan", "distributed_fft",
            "distributed_ifft", "DistFFTResult", "ft_distributed_fft",
            "resolve_abft_groups", "resolve_chunks",
            "choose_chunks", "collective_volume", "spectral_volume",
            "FFT_AXIS", "DATA_AXIS"]

from .multidim import fft_convolve2  # noqa: E402

__all__ += ["fft_convolve2"]

# the plan/execute front door (the single dispatch path every public entry
# point funnels through)
from .api import (FFTSpec, FTConfig, FFTPlan, plan, spec_for,  # noqa: E402
                  plan_cache_info, plan_cache_clear)

__all__ += ["FFTSpec", "FTConfig", "FFTPlan", "plan", "spec_for",
            "plan_cache_info", "plan_cache_clear"]
