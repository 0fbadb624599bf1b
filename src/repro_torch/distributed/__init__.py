"""Fault tolerance, straggler instrumentation and the barrier-free async
engine of the port (counterpart of ``repro.distributed``); the
distributed engine itself is ``core.distributed.DistributedGP``."""
from . import async_stats, fault
from .async_stats import AsyncEngine, AsyncStatsAccumulator
from .fault import FailureSimulator, StepTimer, apply_gradient_masking

__all__ = ["AsyncEngine", "AsyncStatsAccumulator", "FailureSimulator",
           "StepTimer", "apply_gradient_masking", "async_stats", "fault"]
