"""Optimizer: AdamW + schedules."""
from .adamw import (AdamWState, init_state, apply_updates, cosine_schedule,
                    global_norm)

__all__ = ["AdamWState", "init_state", "apply_updates", "cosine_schedule",
           "global_norm"]
