"""Step factories: serve and prefill (training waits for its slice)."""
from .loop import make_prefill_step, make_serve_step

__all__ = ["make_serve_step", "make_prefill_step"]
