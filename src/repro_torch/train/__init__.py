"""Step factories: train / eval / serve / prefill."""
from .loop import (make_train_step, make_eval_step, make_serve_step,
                   make_prefill_step, cross_entropy)

__all__ = ["make_train_step", "make_eval_step", "make_serve_step",
           "make_prefill_step", "cross_entropy"]
