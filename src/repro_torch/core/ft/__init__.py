"""Fault-tolerance runtime: SEU model, fault schedules, policy, statistics."""
from .injection import flip_bit, random_flip, FaultSchedule, poisson_schedule
from .policy import FTPolicy, FTStats

__all__ = ["flip_bit", "random_flip", "FaultSchedule", "poisson_schedule",
           "FTPolicy", "FTStats"]
