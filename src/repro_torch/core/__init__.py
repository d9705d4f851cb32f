"""Core: the paper's contribution — FFT library, two-sided ABFT, FT
runtime."""
