"""Two-sided ABFT (paper §4): encoding, detect/locate/correct, baselines,
and the GEMM form of the scheme."""
from .encoding import left_encoding, left_encoding_image, EPS
from .twoside import GroupChecksums, Verdict, detect_locate, apply_correction
from .oneside import oneside_fft
from .gemm import ft_matmul, ft_dot_stats, decode_columns

__all__ = [
    "left_encoding", "left_encoding_image", "EPS",
    "GroupChecksums", "Verdict", "detect_locate", "apply_correction",
    "oneside_fft", "ft_matmul", "ft_dot_stats", "decode_columns",
]
