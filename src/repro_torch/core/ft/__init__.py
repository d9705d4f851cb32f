"""Fault-tolerance runtime: SEU model and fault schedules."""
from .injection import flip_bit, random_flip, FaultSchedule, poisson_schedule

__all__ = ["flip_bit", "random_flip", "FaultSchedule", "poisson_schedule"]
