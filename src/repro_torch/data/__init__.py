"""Deterministic synthetic data pipeline."""
from .synthetic import TokenPipeline, make_batch, Prefetcher

__all__ = ["TokenPipeline", "make_batch", "Prefetcher"]
