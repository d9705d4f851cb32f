"""Two-sided ABFT (paper §4): encoding, detect/locate/correct."""
from .encoding import left_encoding, left_encoding_image, EPS
from .twoside import GroupChecksums, Verdict, detect_locate, apply_correction

__all__ = [
    "left_encoding", "left_encoding_image", "EPS",
    "GroupChecksums", "Verdict", "detect_locate", "apply_correction",
]
