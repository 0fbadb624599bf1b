"""Fault tolerance and straggler instrumentation of the port (counterpart of
``repro.distributed``); the distributed engine itself is
``core.distributed.DistributedGP``."""
from .fault import FailureSimulator, StepTimer, apply_gradient_masking

__all__ = ["FailureSimulator", "StepTimer", "apply_gradient_masking"]
