"""Checked GEMM plan family: two-side ABFT matmul behind the shared
spec -> cached plan -> bound executor API (``core.plan``)."""
from .api import GEMMSpec, GEMMPlan, spec_for, plan

__all__ = ["GEMMSpec", "GEMMPlan", "spec_for", "plan"]
