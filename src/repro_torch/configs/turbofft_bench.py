"""The paper's own workload: batched FFT service configurations. Port of
``repro.configs.turbofft_bench``.

Not an LM — the 'model' is the FFT plan grid the paper benchmarks
(N = 2^3..2^29, batch 1..1024, FP32/FP64) with FT on/off.
"""
import dataclasses

from repro_torch.core.ft import FTPolicy


@dataclasses.dataclass(frozen=True)
class FFTBenchConfig:
    name: str = "turbofft"
    log_n_range: tuple = (3, 25)
    batches: tuple = (1, 8, 64, 256, 1024)
    dtypes: tuple = ("complex64", "complex128")
    ft: FTPolicy = dataclasses.field(default_factory=FTPolicy)


CONFIG = FFTBenchConfig()
SMOKE = FFTBenchConfig(name="turbofft-smoke", log_n_range=(3, 12),
                       batches=(1, 8), dtypes=("complex64",))
